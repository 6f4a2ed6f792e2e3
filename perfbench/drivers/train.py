"""Training throughput: train steps enqueued ahead, as `run_training` does.

The traffic file gives `dtype` (the compute dtype over float32 master
weights), `batch`, `pool` (seeded HR/LR field pairs resident on the card)
and, for a traced run, `traced_share` and `traced_steps`. The optimizer,
its rate and `print_freq` are the configuration's `train` section.

Set-up builds one DiffusionTrainer (the port's train step: the loss
through the encoder and UNet, backward through K2 and K3's backward,
Adam) with the seeded weights, and drives it through its first three
steps with the window's own call and feed: `train_on_batch_async` on
batches gathered on the card from the pool by a seeded permutation per
epoch, so every row of a batch differs. Then the same object runs the
window, reading the pending losses once per `print_freq` steps, as
`run_training` does, and closing with one synchronise.
`train_samples_per_s` is every sample of every step in the window over
its wall time.

The check: from the trainer after step 1, each leaf's first gradient as
Adam received it (its first moment over 1 - beta1); after step 3, each
leaf's change since the seeded start; and the three losses. The plain
reference repeats the three steps from the same weights, batches and
draws (t, u and the noise from the trainer's generator seeded by (seed,
step), Dropout's masks from the default generator seeded by (seed, step,
1), the trainer's documented rule), with its own loss and Adam. Compared:
the worst step's loss gap over the reference's loss, and the first
step's; for each leaf the gap
between the two gradient norms, over the larger of that leaf's reference
norm and the median leaf's, taken at the 99th percentile of leaves; the
same for the change after three steps, over the leaves whose reference
gradient is at least a thousandth of the median leaf's (the others move
by round-off alone). The worst leaf's gaps are printed beside them.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import inputs, work
from ..cell import LayerContext, Outcome
from ..reference import diffusion, numerics
from . import common

SPAN = "perfbench.step"
CHECK_STEPS = 3
_ZERO_GRAD = 1e-3


def step_seed(seed: int, step: int, stream: int = 0) -> int:
    """The trainer's per-step seed of (seed, step, stream)."""
    state = np.random.SeedSequence([int(seed), int(step), int(stream)]).generate_state(
        1, np.uint64)
    return int(state[0]) >> 1


class Feed:
    """Batches of the pool, gathered on its device: epoch e is a seeded
    permutation of the pool, cut into whole batches."""

    def __init__(self, cfg: dict, tr: dict, seed: int, device):
        d = cfg["model"]["diffusion"]
        hw = (int(d["image_height"]) // 4, int(d["image_width"]) // 4)
        self.hr, self.lr = inputs.fields(seed, 1, int(tr["pool"]), hw, device)
        self.b, self.seed, self.device = int(tr["batch"]), seed, device
        self.per_epoch = int(tr["pool"]) // self.b
        self._perm = (None, None)

    def rows(self, step: int) -> torch.Tensor:
        """The pool rows of 0-based step `step`."""
        e, k = divmod(step, self.per_epoch)
        if self._perm[0] != e:
            self._perm = (e, torch.randperm(len(self.hr), generator=inputs.generator(
                self.seed, "order", e, self.device), device=self.device))
        return self._perm[1][k * self.b:(k + 1) * self.b]

    def batch(self, step: int) -> dict:
        idx = self.rows(step)
        return {"HR": self.hr.index_select(0, idx), "LR": self.lr.index_select(0, idx)}


def _norms(tensors: list) -> list:
    return [float(x) for x in torch.stack(torch._foreach_norm(tensors)).cpu()] if tensors else []


def _gaps(prog: dict, ref: dict, keys: list) -> dict:
    """Each leaf's |prog - ref| over max(ref, the median leaf's ref):
    {"med": the median leaf's gap, "q99": the gap of the leaf at the 99th
    percentile, "max": the worst leaf's, "leaf": the worst leaf}."""
    med = float(np.median([ref[k] for k in keys]))
    gaps = sorted((abs(prog[k] - ref[k]) / max(ref[k], med), k) for k in keys)
    gaps = [(g if math.isfinite(g) else math.inf, k) for g, k in gaps]
    q99 = gaps[max(0, math.ceil(0.99 * len(gaps)) - 1)][0]
    return {"med": gaps[(len(gaps) - 1) // 2][0], "q99": q99, "max": gaps[-1][0],
            "leaf": gaps[-1][1]}


def reference_steps(cfg: dict, tr: dict, seed: int, trainer_seed: int, feed: Feed, device,
                    mode: str = "f32", half: bool = False) -> dict:
    """The reference's three steps from the seeded weights: {"losses",
    "grad": {leaf: norm} of step 1, "change": {leaf: norm} after step 3}.
    `half`: the fault of a step that leaves out half of the batch, its
    loss the mean over the first half's rows and draws."""
    m = cfg["model"]
    unet, enc = common.reference_model(m, seed, device)
    train_enc = enc is not None and not bool((m.get("pretrained_model") or {}).get(
        "lock_weights", True))
    named = [("unet." + n, p) for n, p in unet.named_parameters()]
    if enc is not None:
        enc.requires_grad_(train_enc)
        if train_enc:
            named += [("encoder." + n, p) for n, p in enc.named_parameters()]
    start = [p.detach().clone() for _, p in named]
    opt_cfg = cfg["train"]["optimizer"]
    if opt_cfg.get("type", "adam") != "adam":
        raise ValueError("the train driver's reference has Adam only")
    adam = diffusion.Adam([p for _, p in named], lr=float(opt_cfg["lr"]))
    sched = diffusion.Schedule(m["beta_schedule"]["train"], device)
    unet.train()
    losses, grad = [], {}
    hr_shape = tuple(feed.hr.shape[1:])
    with numerics.mode(mode):
        for s in range(CHECK_STEPS):
            g = torch.Generator(device=device).manual_seed(step_seed(trainer_seed, s))
            _seed_default(device, step_seed(trainer_seed, s, 1))
            t, u, eps = diffusion.draws(sched, feed.b, hr_shape, g, device)
            for _, p in named:
                p.grad = None
            batch = feed.batch(s)
            if half:
                h = feed.b // 2
                batch, u, eps = {k: v[:h] for k, v in batch.items()}, u[:h], eps[:h]
            loss = diffusion.loss(unet, enc, batch, sched, t, u, eps, train_enc)
            loss.backward()
            losses.append(float(loss.detach()))
            if s == 0:
                grad = dict(zip([n for n, _ in named],
                                _norms([p.grad if p.grad is not None else torch.zeros_like(p)
                                        for _, p in named])))
            adam.step()
    change = dict(zip([n for n, _ in named],
                      _norms([p.detach() - p0 for (_, p), p0 in zip(named, start)])))
    del unet, enc, adam, start, named
    common.free(device)
    return {"losses": losses, "grad": grad, "change": change}


def _seed_default(device, seed: int) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.default_generators[device.index or 0].manual_seed(seed)
    else:
        torch.default_generator.manual_seed(seed)


def compare(prog: dict, ref: dict) -> dict:
    """The compared numbers: `loss`, the worst step's loss gap over the
    reference's loss, and `loss1`, the first step's (before any update
    has parted the two sides); `grad` and `change`, the leaf gap at the 99th
    percentile of leaves, and `grad_med`, `change_med`, the median leaf's
    (the worst leaf's, which one flipped sign of the L1 loss's or Adam's
    first update can set, is kept beside them). A cell compares those its
    limits file names."""
    steps = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
             for a, b in zip(prog["losses"], ref["losses"])]
    loss, loss1 = max(steps), steps[0]
    keys = sorted(ref["grad"])
    if set(prog["grad"]) != set(keys):
        return {"loss": loss, "loss1": loss1, "grad": math.inf, "change": math.inf,
                "grad_med": math.inf, "change_med": math.inf}
    med = float(np.median([ref["grad"][k] for k in keys]))
    moving = [k for k in keys if ref["grad"][k] >= _ZERO_GRAD * med]
    grad = _gaps(prog["grad"], ref["grad"], keys)
    change = _gaps(prog["change"], ref["change"], moving)
    return {"loss": loss, "loss1": loss1, "grad": grad["q99"], "change": change["q99"],
            "grad_med": grad["med"], "change_med": change["med"],
            "grad_max": grad["max"], "grad_leaf": grad["leaf"], "change_max": change["max"],
            "change_leaf": change["leaf"], "left_out": len(keys) - len(moving)}


def run(cell, *, seed: int, seconds: float, trace: bool, device, plant=None) -> Outcome:
    """`plant(trainer)`: a test's fault, applied to the trainer before its
    first step."""
    from srewd_tpu_torch.cli import cuda_numerics
    from srewd_tpu_torch.diffusion.schedule import Schedule
    from srewd_tpu_torch.training.trainer import DiffusionTrainer

    cfg, tr = cell.config, cell.traffic
    m = cfg["model"]
    cuda_numerics(device, training=True)  # the train CLI's
    model = common.program_model(m, tr["dtype"], seed, device)
    bs = m["beta_schedule"]
    opt_cfg = cfg["train"]["optimizer"]
    trainer_seed = inputs.derive(seed, "trainer")
    trainer = DiffusionTrainer(
        model, Schedule.from_config(bs["train"], device=device),
        Schedule.from_config(bs["val"], device=device), device=device,
        optimizer=opt_cfg.get("type", "adam"), lr=float(opt_cfg["lr"]), seed=trainer_seed)
    if plant is not None:
        plant(trainer)
    feed = Feed(cfg, tr, seed, device)
    names = {id(p): "unet." + n for n, p in model.unet.named_parameters()}
    if model.encoder is not None:
        names.update({id(p): "encoder." + n for n, p in model.encoder.named_parameters()})
    leaves = [(names[id(p)], p) for p in trainer.trainable]
    start = [p.detach().clone() for _, p in leaves]

    # set-up: the first three steps through the window's call and feed
    first = []
    for s in range(CHECK_STEPS):
        first.append(trainer.train_on_batch_async(feed.batch(s)))
        if s == 0:
            beta1 = trainer.optimizer.param_groups[0]["betas"][0]
            moments = [trainer.optimizer.state[p]["exp_avg"] if p in trainer.optimizer.state
                       else torch.zeros_like(p) for _, p in leaves]
            grad = dict(zip([n for n, _ in leaves], [g / (1.0 - beta1) for g in _norms(moments)]))
    change = dict(zip([n for n, _ in leaves],
                      _norms([p.detach() - p0 for (_, p), p0 in zip(leaves, start)])))
    prog = {"losses": [float(x) for x in torch.stack(first).cpu()], "grad": grad,
            "change": change}
    del start, moments

    print_freq = int(cfg["train"].get("print_freq", 100))
    pending, steps = [], 0

    def step():
        nonlocal steps
        with torch.profiler.record_function(SPAN):
            pending.append(trainer.train_on_batch_async(feed.batch(trainer.step)))
        steps += 1
        if steps % print_freq == 0:  # run_training's read of the pending losses
            losses.extend(torch.stack(pending).cpu().tolist())
            pending.clear()

    losses: list = []
    timed = seconds * (float(tr.get("traced_share", 0.5)) if trace else 1.0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timed:
        step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    n_timed = steps
    layer = None
    if trace:
        from .. import trace as tracing

        n = int(tr.get("traced_steps", 3))
        t = tracing.profile(lambda: [step() for _ in range(n)], device)
        train_enc = model.encoder is not None and not model.lock_encoder
        unit = work.train_unit(m, feed.b, train_enc)
        layer = LayerContext(
            trace=t, units=n, timed_units=n_timed, timed_seconds=t1 - t0,
            unit_flops=unit["flops"],
            kernel_work=work.kernel_work(unit["calls"], tr["dtype"], backward=True),
            dtype=tr["dtype"])
    losses.extend(torch.stack(pending).cpu().tolist() if pending else [])
    peak = common.peak_bytes(device)
    failed = sum(1 for x in losses if not math.isfinite(x))
    del trainer, model, leaves, pending
    common.free(device)
    ref = reference_steps(cfg, tr, seed, trainer_seed, feed, device)
    gaps = compare(prog, ref)
    lim = cell.limits["checks"]
    return Outcome(window_start=t0, metrics={"train_samples_per_s": feed.b * n_timed / (t1 - t0)},
                   attempted=steps, failed=failed,
                   checks=[(k, gaps[k], lim[k]) for k in lim],
                   memory_peak_bytes=peak, layer=layer,
                   extra={k: v for k, v in gaps.items() if k not in lim})


def control(cell, *, seed: int, device, mode: str, fault: str = None) -> dict:
    """The comparison numbers of the reference in `mode` put in the
    program's place; with `fault` "half_batch", of the float32 reference
    that leaves out half of each batch."""
    feed = Feed(cell.config, cell.traffic, seed, device)
    ts = inputs.derive(seed, "trainer")
    if fault not in (None, "half_batch"):
        raise ValueError(f"no such fault {fault!r}")
    low = reference_steps(cell.config, cell.traffic, seed, ts, feed, device,
                          mode="f32" if fault else mode, half=fault == "half_batch")
    return compare(low, reference_steps(cell.config, cell.traffic, seed, ts, feed, device))
