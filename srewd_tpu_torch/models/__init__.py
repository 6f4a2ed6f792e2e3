"""The port's models; the package exports PhyConv, as the JAX package does."""

from .phy_conv import PhyConv

__all__ = ["PhyConv"]
