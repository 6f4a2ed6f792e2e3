"""Sampler export: one self-contained artifact of a trained SR sampler (twin
of srewd_tpu/serving/export.py).

The JAX package serializes the whole chain (its `lax.scan`) as one
program. Here `torch.export` makes two programs instead, and the loader
walks the chain between them:

* the conditioning program: Kelvin LR and months -> the condition image and
  the chain-constant inputs of the UNet (`DiffusionModel.chain_conditioning`:
  RRDB taps, DWT pyramid, stencil maps, the spliter's maps), with the LR
  scalers baked in;
* the step program: one reverse step, `diffusion.gaussian.chain_step` with
  one UNet call (the chain's UNet in its compute dtype: the bf16 shadow
  where there is one), the plan's table of per-step constants baked in, the
  step index an input; it also returns the step's field in Kelvin (the
  condition added back for the residual archs, the HR scalers baked in).

Unrolling the chain into one program would repeat the UNet's ~1.7k graph
nodes once per step (50 steps, or 1000 for DDPM), and a `while_loop` would
tie the artifact to that higher-order op; the step program is one UNet's
graph whatever the step count. Both programs call K1 and K3 as the custom
ops `srewd::flash_attention` and `srewd::gn_swish` (ops/__init__.py), so an
artifact exported on the card runs the kernels and counts their launches.
The weights are the exported programs' own state.

The batch dimension is exported symbolically (torch.export.Dim) by
default, so one artifact serves any batch size; `symbolic_batch=False`
fixes it, and another size is then refused.

The artifact is one zip file: `header.json` (sampler, steps, each step's
noise index, LR and HR shapes, dtype, device, batch) beside
`condition.pt2` and `step.pt2` (torch.export.save). `load_sampler` needs
torch, numpy and `srewd_tpu_torch.ops` (the custom ops and their kernels):
no model, config, diffusion or checkpoint code.

    fn = load_sampler("phydiff.srexport")
    sr_kelvin = fn(lr_kelvin, months, seed=0)     # [b,lh,lw,C] -> [b,hh,hw,C]

Noise: `fn` draws the initial image and each step's noise from a
generator on the artifact's device seeded with `seed`, in the order
`generate_sr(generator=...)` draws them, so both give the same fields for
the same seed; `init=` and `noises=` hand them in instead (tests feed the
JAX draws). Export on the device you serve on: the artifact's weights and
programs live there.

AOTInductor (a compiled .so instead of eager graph execution) is not used:
it calls custom ops only when they are registered in C++, and the kernels
are bound through ctypes.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

FORMAT = "srewd_tpu_torch.sampler/1"
_HEADER, _CONDITION, _STEP = "header.json", "condition.pt2", "step.pt2"


class ExportedSampler(NamedTuple):
    header: dict
    condition: "torch.export.ExportedProgram"
    step: "torch.export.ExportedProgram"


def _bake_scaler(module: nn.Module, prefix: str, scaler, device) -> bool:
    """MonthlyScalerSet -> `{prefix}_mean` / `{prefix}_std` buffers
    [13, 1, 1, C]; False (no buffers) for none or an identity set."""
    if scaler is None or getattr(scaler, "identity", True):
        return False
    for name, a in (("mean", scaler.mean), ("std", scaler.std)):
        module.register_buffer(f"{prefix}_{name}",
                               torch.as_tensor(np.asarray(a, np.float32), device=device))
    return True


class _ConditionProgram(nn.Module):
    def __init__(self, model, unet, lr_scaler, device):
        super().__init__()
        self.model = model  # the arch's wiring (not a module)
        # the program holds the weights of the modules it registers: the
        # encoder and the UNet's spliter, which the conditioning runs, and
        # not the rest of the UNet, which it only reads settings of
        self.encoder = model.encoder
        self.spliter = getattr(unet, "fd_spliter", None)
        object.__setattr__(self, "unet", unet)
        self.scaled = _bake_scaler(self, "lr", lr_scaler, device)

    def forward(self, lr, months):
        if self.scaled:
            lr = (lr - self.lr_mean[months]) / self.lr_std[months]
        return self.model.chain_conditioning({"LR": lr}, self.unet)


class _StepProgram(nn.Module):
    def __init__(self, model, unet, plan, clip_denoised, hr_scaler, device):
        super().__init__()
        self.model = model
        self.unet = unet
        self.kind = plan.kind
        self.clip_denoised = clip_denoised
        self.register_buffer("coef", plan.coef.clone())
        self.scaled = _bake_scaler(self, "hr", hr_scaler, device)

    def forward(self, x, i, noise, prev_x0, months, cond, consts):
        from ..diffusion.gaussian import chain_step

        def denoise_fn(x_t, noise_level):
            return self.model.chain_eps(self.unet, cond, consts, x_t, noise_level)

        x, x0 = chain_step(self.kind, self.coef, i, x, denoise_fn, noise, prev_x0,
                           self.clip_denoised)
        out = self.model.add_back(x, cond)
        if self.scaled:
            out = self.hr_std[months] * out + self.hr_mean[months]
        return x, x0, out


def export_sampler(
    model,
    params: dict,
    schedule,
    lr_shape: Sequence[int],
    *,
    sampler_kwargs: Optional[dict] = None,
    lr_scaler=None,
    hr_scaler=None,
    symbolic_batch: bool = True,
    batch_size: int = 8,
    device=None,
) -> ExportedSampler:
    """Export a DiffusionModel's sampler with `params` (`model.params()`'s
    form) baked in.

    lr_shape: [lh, lw, C] of one LR field (the HR field is 4x). lr_scaler /
    hr_scaler: MonthlyScalerSets for the Kelvin boundary (None: the artifact
    works in normalized space and ignores `months`). sampler_kwargs: as
    generate_sr takes them; `keep_every` is refused. The programs are made
    on `device` (the model's by default), where the artifact then runs.
    """
    from ..diffusion.gaussian import chain_plan

    kw = dict(sampler_kwargs or {})
    if kw.get("keep_every") is not None:
        raise ValueError("export_sampler does not support keep_every frames")
    lh, lw, c = (int(v) for v in lr_shape)
    if device is None:
        device = next(model.unet.parameters()).device
    device = torch.device(device)
    # a snapshot: the caller may go on training the model it handed in
    model = model.with_params(params, device)
    unet = model._chain_unet()
    plan = chain_plan(schedule, kw.get("sampler", "ddpm"), steps=kw.get("ddim_steps", 50),
                      eta=kw.get("ddim_eta", 0.0), tau_spacing=kw.get("tau_spacing", "linspace"),
                      device=device)
    # an example batch of 2 at least: torch.export specializes a dimension
    # of size 0 or 1
    b_ex = int(batch_size) if not symbolic_batch else max(2, int(batch_size))
    batch = torch.export.Dim("batch", min=1, max=4096) if symbolic_batch else None
    lr = torch.zeros(b_ex, lh, lw, c, device=device)
    months = torch.zeros(b_ex, dtype=torch.int64, device=device)
    cond_prog = _ConditionProgram(model, unet, lr_scaler, device).eval()
    step_prog = _StepProgram(model, unet, plan, bool(kw.get("clip_denoised", True)),
                             hr_scaler, device).eval()

    def dyn(tree):
        return None if batch is None else torch.utils._pytree.tree_map(lambda _: {0: batch}, tree)

    with torch.no_grad():
        condition = torch.export.export(cond_prog, (lr, months), dynamic_shapes=dyn((lr, months)),
                                        strict=False)
        cond, consts = cond_prog(lr, months)
        # x, noise and x0 as three tensors: inputs that alias would be traced as one
        x, noise, prev_x0 = (torch.zeros_like(cond) for _ in range(3))
        i = torch.zeros((), dtype=torch.int64, device=device)
        args = (x, i, noise, prev_x0, months, cond, consts)
        step_dyn = None if batch is None else (
            {0: batch}, None, {0: batch}, {0: batch}, {0: batch}, {0: batch}, dyn(consts))
        step = torch.export.export(step_prog, args, dynamic_shapes=step_dyn, strict=False)
    header = {
        "format": FORMAT, "arch": model.arch, "sampler": plan.kind, "steps": plan.n_steps,
        "noise_ids": list(plan.noise_ids), "lr_shape": [lh, lw, c],
        "hr_shape": list(cond.shape[1:]), "dtype": str(unet.dtype or torch.float32),
        "device": device.type, "batch": "symbolic" if symbolic_batch else b_ex,
        "kelvin": {"lr": cond_prog.scaled, "hr": step_prog.scaled},
    }
    return ExportedSampler(header, condition, step)


def save_sampler(exported: ExportedSampler, path: str) -> None:
    """Write an exported sampler to one file (a zip: header and programs)."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr(_HEADER, json.dumps(exported.header))
        for name, ep in ((_CONDITION, exported.condition), (_STEP, exported.step)):
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            z.writestr(name, buf.getvalue())


def read_sampler(path: str) -> ExportedSampler:
    """The header and the two exported programs of an artifact."""
    from ..ops import flash_attention, fused_groupnorm  # noqa: F401  the custom ops

    with zipfile.ZipFile(path) as z:
        header = json.loads(z.read(_HEADER))
        if header.get("format") != FORMAT:
            raise ValueError(f"{path} is not a {FORMAT} artifact: {header.get('format')}")
        return ExportedSampler(header, torch.export.load(io.BytesIO(z.read(_CONDITION))),
                               torch.export.load(io.BytesIO(z.read(_STEP))))


def load_sampler(path: str):
    """Load an artifact -> fn(lr_kelvin, months=None, seed=0, *, init=None,
    noises=None) -> SR tensor [b, hh, hw, C] on the artifact's device
    (Kelvin where the scalers were baked in); `fn.exported` is the
    ExportedSampler (header and programs).

    Imports torch, numpy and srewd_tpu_torch.ops only: no model, config,
    diffusion or checkpoint code. On a card it turns TF32 off, as the
    port's entry points do (cli.cuda_numerics): a float32 artifact then
    computes in full float32, as the eager sampler does.
    """
    exported = read_sampler(path)
    header = exported.header
    condition, step = exported.condition.module(), exported.step.module()
    device = torch.device(header["device"])
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    noise_ids = header["noise_ids"]
    steps = torch.arange(len(noise_ids), device=device)

    @torch.no_grad()
    def fn(lr_kelvin, months=None, seed: int = 0, *, init=None, noises=None):
        lr = torch.as_tensor(np.asarray(lr_kelvin, np.float32)).to(device)
        b = lr.shape[0]
        months = (torch.zeros(b, dtype=torch.int64) if months is None
                  else torch.as_tensor(np.asarray(months, np.int64))).to(device)
        shape = (b, *header["hr_shape"])
        g = torch.Generator(device=device).manual_seed(int(seed))

        def draw(idx):
            if idx is None:
                return torch.randn(shape, generator=g, device=device)
            return torch.tensor(np.asarray(noises[idx], np.float32), device=device)

        x = draw(None) if init is None else torch.tensor(np.asarray(init, np.float32),
                                                         device=device)
        cond, consts = condition(lr, months)
        zero = torch.zeros_like(x)
        prev_x0, out = zero, None
        for s, nid in enumerate(noise_ids):
            noise = zero if nid is None else draw(nid if noises is not None else None)
            x, prev_x0, out = step(x, steps[s], noise, prev_x0, months, cond, consts)
        return out

    fn.exported = exported
    return fn
