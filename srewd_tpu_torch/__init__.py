"""srewd_tpu_torch — the PyTorch / CUDA port of srewd_tpu for one NVIDIA H100.

The JAX package `srewd_tpu` stays the reference; this package keeps its
module layout and names, so each port module sits where its counterpart
does. It imports `torch` and never `jax`.

Conventions:
  - the public functions (`DiffusionModel.generate_sr`, the ops, the
    encoders) take and return NHWC tensors, as the JAX package does; inside
    the networks the activations are NCHW tensors in channels_last memory,
    so an NHWC view of them is free;
  - every call names its `device`; randomness comes from explicit
    `torch.Generator`s or is handed in (tests feed the JAX noise);
  - the framework-free host modules of `srewd_tpu` (configs, data, native,
    utils.{logging,seeding}) are the port's own copies: it imports nothing
    of `srewd_tpu`.

Entry points: `python -m srewd_tpu_torch.{sample,train,pretrain}`, and
the benchmarks `python -m srewd_tpu_torch.{bench,bench_train,bench_all}`.
The compute dtype (`build_model(dtype=)`, `cli.build_trainer(dtype=)`)
casts float32 weights per call (models/layers.py), as flax's `dtype`.

Hand-written kernels (CUDA C++, sm_90a, built by ops/_build.py):
  ops/flash_attention.py + csrc/flash_attention.cu, csrc/flash_attention_bwd.cu
  ops/fused_groupnorm.py + csrc/gn_swish.cu (forward and backward)
Each has a plain PyTorch version beside it, used for CPU tensors and for
the comparisons in chip_smoke.py.
"""

__version__ = "0.1.0"
