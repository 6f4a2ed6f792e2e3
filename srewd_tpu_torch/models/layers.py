"""Convolution and linear layers that compute in their input's dtype, and
the dropout of data parallelism.

Flax's `dtype` casts a layer's float32 params and its input to the compute
dtype on every call; the params stay float32 and their gradients come back
float32. These subclasses of torch's layers do the same: `forward` casts
weight and bias to the input's dtype per call (a no-op when they match),
and the parameters, their names and their dtype never change. A module
that computes in a dtype other than its input's casts the input first, as
the UNet does before its stem and ResSE before its MLP.

bf16 sampling casts the weights once per chain instead, into a shadow copy
of the UNet (models/factory.py), as the JAX package pre-casts its params
outside the scan; then every cast here is a no-op.

`Conv2d` sends the forward of a float32 3x3 convolution of stride 1 and
padding 1 on a card that records no autograd graph (sampling, serving, and
a locked encoder's no_grad forward inside a training step) to K4
(`ops/conv3x3.py` `routes` is the predicate); every other call takes
torch's own convolution.

`Dropout` draws its mask over the global batch (parallel/): W ranks at
batch B drop what one process at batch W B drops, as JAX's mask is drawn
over the global sharded array.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import conv3x3
from ..parallel import draw_rows


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.weight.to(x.dtype), _cast(self.bias, x.dtype)
        if conv3x3.routes(x, weight, bias, self.stride, self.padding, self.dilation,
                          self.groups, self.padding_mode):
            return conv3x3.conv3x3(x, weight, bias)
        return self._conv_forward(x, weight, bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype),
                                  self.stride, self.padding, self.output_padding, self.groups,
                                  self.dilation)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class Dropout(nn.Module):
    """Inverted dropout with rate `p` in training mode. The mask comes from
    float32 uniforms over the global batch's shape, drawn from the device's
    default generator (seeded per step by the trainer), of which this rank
    keeps its rows; an element is kept where its uniform is >= p. The
    uniforms are float32 whatever x's dtype, so a bf16 or float64 copy of
    the model drops the same elements."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        u = draw_rows(torch.rand, x.shape[0], *x.shape[1:], device=x.device)
        return x * (u >= self.p).to(x.dtype) * (1.0 / (1.0 - self.p))

    def extra_repr(self) -> str:
        return f"p={self.p}"
