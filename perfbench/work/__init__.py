"""Operations and bytes of the work a cell does, counted from the plain
reference's own calls on the meta device (nothing runs), so the counts do
not depend on what implements the work.

* whole units: FlopCounterMode over one UNet call (plus the chain's
  conditioning, once) or one training step's forward and backward. It
  counts convolutions and matrix products, the attention's included, and
  no elementwise work.
* kernels, from the shapes of the reference's attention and GroupNorm
  calls in that unit: K1 (attention forward) 4 B N^2 D operations, K2
  (its backward) 10 B N^2 D; q, k, v read and the output written once
  (K2: q, k, v, dO read in the compute dtype, O in float32, the row
  log-sum-exp, dQ, dK, dV written). K3 (GroupNorm + Swish) 10 operations
  an element, x read and y written once, the affine vectors read once;
  its backward 20 an element, x and dy read, dx written, and the four
  affine vectors and gradients.
* peaks, H100 SXM data sheet, dense: bf16 989 TFLOP/s; float32 matrix
  work 495/3 = 165 TFLOP/s (3xTF32, the fastest float32-accurate path);
  elementwise float32 on the CUDA cores 67 TFLOP/s; HBM3 3.35 TB/s.
"""

from __future__ import annotations

import torch

PEAK_MATRIX = {"float32": 495e12 / 3, "bfloat16": 989e12}
PEAK_VECTOR = {"float32": 67e12, "bfloat16": 134e12}
HBM = 3.35e12
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def bound_seconds(flops: float, nbytes: float, peak: float) -> float:
    """The least time of work of `flops` at `peak` moving `nbytes`."""
    return max(flops / peak, nbytes / HBM)


def kernel_work(calls: list, dtype: str, backward: bool) -> dict:
    """{kernel: (flops, bytes)} of the recorded calls (`ops.record_calls`)
    as K1 and K3 in the forward and, with `backward`, K2 and K3's
    backward beside them."""
    isz = ITEMSIZE[dtype]
    out = {"k1": [0.0, 0.0], "k3": [0.0, 0.0]}
    if backward:
        out.update(k2=[0.0, 0.0], k3_bwd=[0.0, 0.0])
    for kind, s in calls:
        if kind == "attention":
            b, n, d = s["b"], s["n"], s["d"]
            out["k1"][0] += 4.0 * b * n * n * d
            out["k1"][1] += 4.0 * b * n * d * isz
            if backward:
                out["k2"][0] += 10.0 * b * n * n * d
                out["k2"][1] += (7.0 * isz + 4.0) * b * n * d + 4.0 * b * n
        elif kind == "group_norm":
            e, c = s["numel"], s["c"]
            out["k3"][0] += 10.0 * e
            out["k3"][1] += 2.0 * e * isz + 2 * c * 4
            if backward:
                out["k3_bwd"][0] += 20.0 * e
                out["k3_bwd"][1] += 3.0 * e * isz + 4 * c * 4
    return {k: tuple(v) for k, v in out.items()}


def kernel_bound_seconds(work: dict, dtype: str) -> dict:
    """{kernel: least seconds} for `kernel_work`'s counts: attention at the
    matrix peak, GroupNorm at the vector peak (it is bound by bytes)."""
    out = {}
    for k, (f, b) in work.items():
        peak = PEAK_MATRIX[dtype] if k in ("k1", "k2") else PEAK_VECTOR[dtype]
        out[k] = bound_seconds(f, b, peak)
    return out


def _meta_model(model_cfg: dict):
    from ..reference import nets

    return nets.build(model_cfg, "meta")


def sample_unit(model_cfg: dict, batch: int) -> dict:
    """One UNet call of a chain at `batch`: {"flops", "calls"}, and the
    chain's conditioning {"cond_flops"} (the bicubic x4, and the encoder's
    forward for srdiff)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..reference import ops

    unet, enc = _meta_model(model_cfg)
    unet.eval()
    h = int(model_cfg["diffusion"]["image_height"])
    w = int(model_cfg["diffusion"]["image_width"])
    meta = torch.device("meta")
    lr = torch.empty(batch, h // 4, w // 4, 1, device=meta)
    x = torch.empty(batch, h, w, 1, device=meta)
    level = torch.empty(batch, device=meta)
    with torch.no_grad(), FlopCounterMode(display=False) as cond_counter:
        cond = ops.bicubic_up4(lr)
        taps = enc(lr)[1] if enc is not None else None
    with torch.no_grad(), ops.record_calls() as calls, FlopCounterMode(display=False) as c:
        if unet.variant == "srdiff":
            unet(x, level, rrdb_feats=taps)
        else:
            unet(torch.cat([cond, x], -1), level, condition=cond)
    return {"flops": float(c.get_total_flops()), "calls": list(calls),
            "cond_flops": float(cond_counter.get_total_flops())}


def train_unit(model_cfg: dict, batch: int, train_encoder: bool) -> dict:
    """One training step's forward and backward at `batch`: {"flops", "calls"}."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..reference import diffusion, ops

    unet, enc = _meta_model(model_cfg)
    unet.train()
    if enc is not None:
        enc.requires_grad_(train_encoder)
    h = int(model_cfg["diffusion"]["image_height"])
    w = int(model_cfg["diffusion"]["image_width"])
    meta = torch.device("meta")
    sched = diffusion.Schedule(model_cfg["beta_schedule"]["train"], meta)
    b = {"HR": torch.empty(batch, h, w, 1, device=meta),
         "LR": torch.empty(batch, h // 4, w // 4, 1, device=meta)}
    t = torch.full((1,), 500, dtype=torch.long, device=meta)
    u = torch.empty(batch, device=meta)
    eps = torch.empty(batch, h, w, 1, device=meta)
    with ops.record_calls() as calls, FlopCounterMode(display=False) as c:
        diffusion.loss(unet, enc, b, sched, t, u, eps, train_encoder).backward()
    return {"flops": float(c.get_total_flops()), "calls": list(calls)}
