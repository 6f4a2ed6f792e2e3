"""Persistent batched SR inference on one device (twin of
srewd_tpu/serving/service.py).

A service holds a snapshot of one model's weights and serves requests of
Kelvin LR fields:

* fixed device batch B: requests of any size are split and packed into
  device batches of exactly B fields, in FIFO order, and the last batch is
  padded with copies of its first field (the padding rows are sliced off
  before futures resolve), so the chain always runs at one shape;
* linger: the dispatcher waits up to `linger_ms` for concurrent submitters
  to fill a batch;
* two threads: the dispatcher enqueues each device batch's chain on the
  service's own CUDA stream (the LR copy in, the chain, the copy of the
  result into pinned host memory) and records an event, without waiting
  for the card; the resolver waits on that event, applies the HR inverse
  and resolves the futures. Every device tensor of a batch is made and
  used on that one stream, so no device memory is shared across streams;
  the card runs batch k while the host packs and enqueues batch k + 1;
* physical units at the boundary: `transform_lr` (Kelvin -> normalized)
  on the way in, `inverse_hr` on the way out (data/scalers.MonthlyScalerSet);
* hot swap: `update_params` checks the new weights against the served ones
  (keys, shapes, dtypes), builds a new snapshot and swaps the reference;
  the dispatcher reads it once per device batch, so a batch already
  enqueued finishes on the old weights (which the resolver keeps alive
  until its event) and the next batch uses the new ones. Nothing is copied
  in place under a queued chain.

Noise: device batch `seq` draws its chain's noise from a `torch.Generator`
on the device seeded with `member_seed(seed, seq)` (utils/seeding.py), as
the JAX service folds `seq` into its key: a fixed seed and request order
reproduce the exact fields, and no two batches share a noise realization.
Tests may pass `noise(seq, shape, n) -> (init, noises)` instead (the port's
noise rule: they feed the JAX draws).

The JAX mesh becomes an explicit `device`; the card ("cuda") is the
default, and the service raises without one. On the CPU (tests) the chain
runs synchronously in the dispatcher.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..utils.seeding import member_seed


class _Pending:
    """One request's result assembly: fields may span device batches."""

    __slots__ = ("future", "buffer", "n_fields", "remaining", "t_submit")

    def __init__(self, n_fields: int):
        self.future: Future = Future()
        self.buffer: Optional[np.ndarray] = None  # allocated on first part
        self.n_fields = n_fields
        self.remaining = n_fields
        self.t_submit = time.monotonic()


class Stack(NamedTuple):
    """What a checkpoint's config and weights give a serving entry point."""

    model: object  # DiffusionModel
    schedule: object  # Schedule (the config's val schedule)
    sampler_kwargs: dict
    lr_scaler: object  # MonthlyScalerSet
    hr_scaler: object
    lr_shape: tuple  # [lh, lw, C] of the config's LR fields
    device: torch.device


def load_stack(config_path: str, model_path: Optional[str] = None, use_ema: bool = False,
               diffusion_overrides: Optional[dict] = None, *,
               device: torch.device | str = "cuda") -> Stack:
    """Config -> data scalers -> weights, as the port's sample.py sets up:
    the config's dataroot fits the scalers (`cli.build_data_handler`), the
    model gets seeded weights, then `model_path` (or path.resume_state;
    `cli.load_model_weights`, its EMA with `use_ema`); the sampler comes
    from model.diffusion (`cli.sampler_kwargs`) after `diffusion_overrides`
    is merged into it (the sampler / ddim_steps / clip_denoised flags)."""
    from ..cli import (Config, build_data_handler, cuda_numerics, init_weights,
                       load_model_weights, resolve_device, sampler_kwargs)
    from ..diffusion.schedule import Schedule
    from ..models.factory import build_model

    device = resolve_device(str(device))
    cuda_numerics(device)
    opt = Config(config_path, phase="val", experiment=False).get_opt()
    if diffusion_overrides:
        opt["model"].setdefault("diffusion", {}).update(diffusion_overrides)
    dh = build_data_handler(opt)
    with torch.device(device):
        model = build_model(opt["model"])
    init_weights(model, opt)
    path = model_path or opt["path"].get("resume_state")
    if path:
        load_model_weights(model, path, use_ema=use_ema)
    bs = opt["model"]["beta_schedule"]
    schedule = Schedule.from_config(bs.get("val", bs["train"]), device=device)
    lr_shape = tuple(next(iter(dh.val_batches()))["LR"].shape[1:])
    return Stack(model, schedule, sampler_kwargs(opt), dh.batch_scalers["lr"],
                 dh.batch_scalers["hr"], lr_shape, device)


def _check_params(served: dict, params: dict) -> None:
    if set(served) != set(params):
        raise ValueError(
            f"param tree mismatch: served {sorted(served)} vs update {sorted(params)}")
    for part, sd in served.items():
        if set(sd) != set(params[part]):
            diff = sorted(set(sd) ^ set(params[part]))
            raise ValueError(f"param tree mismatch in {part}: {diff[:5]} in one side only")
    for part, sd in served.items():
        for name, old in sd.items():
            new = params[part][name]
            if tuple(old.shape) != tuple(new.shape) or old.dtype != new.dtype:
                raise ValueError(
                    f"param leaf mismatch at {part}.{name}: served {tuple(old.shape)}/"
                    f"{old.dtype} vs update {tuple(new.shape)}/{new.dtype}")


class SamplerService:
    """Persistent batched SR inference over one model's reverse chain.

    model: a DiffusionModel, whose structure is served; params: the weights
    to serve, as `model.params()` gives them (the service keeps its own
    copy on `device`); schedule and sampler_kwargs: the chain, as
    generate_sr takes them (`keep_every` is refused).
    """

    def __init__(
        self,
        model,
        params: dict,
        schedule,
        *,
        batch_size: int = 8,
        device: torch.device | str = "cuda",
        sampler_kwargs: Optional[dict] = None,
        transform_lr: Optional[Callable] = None,
        inverse_hr: Optional[Callable] = None,
        linger_ms: float = 2.0,
        seed: int = 0,
        noise: Optional[Callable] = None,
    ):
        from ..cli import resolve_device
        from ..diffusion.gaussian import chain_plan

        self.device = resolve_device(str(device))
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.batch_size = int(batch_size)
        skw = dict(sampler_kwargs or {})
        if skw.get("keep_every") is not None:
            raise ValueError("SamplerService does not serve keep_every frames")
        self.sampler_kwargs = skw
        self.schedule = schedule
        # the chain's constants, made once: building them reads the schedule
        # on the host, which would wait for the card on every batch
        self._plan = chain_plan(schedule, skw.get("sampler", "ddpm"),
                                steps=skw.get("ddim_steps", 50), eta=skw.get("ddim_eta", 0.0),
                                tau_spacing=skw.get("tau_spacing", "linspace"),
                                device=self.device)
        self._clip = bool(skw.get("clip_denoised", True))
        self._transform_lr = transform_lr or (lambda x, m: x)
        self._inverse_hr = inverse_hr or (lambda x, m: x)
        self._linger_s = float(linger_ms) / 1e3
        self._seed = int(seed)
        self._noise = noise
        self._model = model.with_params(params, self.device)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        self._lock = threading.Condition()
        self._slots: list = []  # [(pending, offset, lr_row, month)], FIFO
        self._lr_shape = None  # [lh, lw, C], locked at first submit
        self._closing = False
        self._batch_seq = 0
        self._stats = {"requests": 0, "fields": 0, "device_batches": 0, "padded_fields": 0}
        self._latencies: list = []  # bounded; request wall seconds

        self._resolve_q: "queue.Queue" = queue.Queue(maxsize=4)
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="srewd-serve-dispatch", daemon=True)
        self._resolver = threading.Thread(
            target=self._resolve_loop, name="srewd-serve-resolve", daemon=True)
        self._dispatcher.start()
        self._resolver.start()

    # ------------------------------------------------------------ factories
    @classmethod
    def from_trainer(cls, trainer, data_handler=None, use_ema: bool = False, **kw):
        """Serve a SNAPSHOT of a DiffusionTrainer's weights (its EMA with
        `use_ema`, where it keeps one): later training steps do not reach
        the service; push fresh weights with update_params().

        data_handler supplies the train-time scalers (Kelvin boundary);
        without it the service runs in normalized space.
        """
        model = trainer.model
        ema = use_ema and trainer.ema is not None
        params = {"unet": trainer.ema if ema else model.unet.state_dict()}
        if model.encoder is not None:
            params["encoder"] = (trainer.ema_encoder if ema and trainer.ema_encoder is not None
                                 else model.encoder.state_dict())
        if data_handler is not None:
            sc = data_handler.batch_scalers
            kw.setdefault("transform_lr", sc["lr"].transform)
            kw.setdefault("inverse_hr", sc["hr"].inverse)
        kw.setdefault("sampler_kwargs", trainer.sampler_kwargs)
        kw.setdefault("device", trainer.device)
        return cls(model, params, trainer.schedule_val, **kw)

    @classmethod
    def from_checkpoint(cls, config_path: str, model_path: Optional[str] = None,
                        use_ema: bool = False, diffusion_overrides: Optional[dict] = None,
                        *, device: torch.device | str = "cuda", **kw):
        """Build the stack (config -> data scalers -> weights, `load_stack`)
        and serve it."""
        stack = load_stack(config_path, model_path, use_ema, diffusion_overrides, device=device)
        kw.setdefault("transform_lr", stack.lr_scaler.transform)
        kw.setdefault("inverse_hr", stack.hr_scaler.inverse)
        kw.setdefault("sampler_kwargs", stack.sampler_kwargs)
        return cls(stack.model, stack.model.params(), stack.schedule,
                   device=stack.device, **kw)

    # --------------------------------------------------------------- public
    def submit(self, lr_kelvin: np.ndarray, months: np.ndarray) -> Future:
        """Queue [n, lh, lw, C] LR fields; future resolves to [n, hh, hw, C] SR."""
        lr = np.asarray(lr_kelvin, np.float32)
        months = np.asarray(months, np.int32).reshape(-1)
        if lr.ndim != 4 or lr.shape[0] != months.shape[0] or lr.shape[0] == 0:
            raise ValueError(
                f"expected non-empty lr [n,lh,lw,C] with matching months[n], "
                f"got {lr.shape} / {months.shape}")
        lr = np.asarray(self._transform_lr(lr, months), np.float32)
        pending = _Pending(lr.shape[0])
        with self._lock:
            if self._closing:
                raise RuntimeError("service is closed")
            # one chain shape per service: a mismatched field would kill the
            # dispatcher's np.stack; reject it at the boundary instead
            if self._lr_shape is None:
                self._lr_shape = lr.shape[1:]
            elif lr.shape[1:] != self._lr_shape:
                raise ValueError(
                    f"LR field shape {lr.shape[1:]} does not match the "
                    f"service's compiled shape {self._lr_shape}")
            for i in range(lr.shape[0]):
                self._slots.append((pending, i, lr[i], months[i]))
            self._stats["requests"] += 1
            self._stats["fields"] += lr.shape[0]
            self._lock.notify_all()
        return pending.future

    def super_resolve(self, lr_kelvin, months) -> np.ndarray:
        """Synchronous convenience wrapper around submit()."""
        return self.submit(lr_kelvin, months).result()

    def params(self) -> dict:
        """The served weights ({"unet": ..., "encoder": ...})."""
        with self._lock:
            return self._model.params()

    def update_params(self, params: dict) -> None:
        """Hot-swap the served weights with zero downtime.

        `params` must match the served weights' keys, shapes and dtypes (no
        new chain shape); a mismatch raises before anything changes. Batches
        already enqueued finish on the old weights; the next device batch
        uses the new ones."""
        with self._lock:
            served = self._model
        _check_params(served.params(), params)
        snap = served.with_params(params, self.device)
        with self._lock:
            self._model = snap

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            lat = sorted(self._latencies)
        if lat:
            out["latency_p50_ms"] = round(1e3 * lat[len(lat) // 2], 2)
            out["latency_p95_ms"] = round(1e3 * lat[int(len(lat) * 0.95)], 2)
        out["batch_size"] = self.batch_size
        return out

    def close(self) -> None:
        """Drain queued work, stop threads. Idempotent."""
        with self._lock:
            self._closing = True
            self._lock.notify_all()
        self._dispatcher.join()
        self._resolve_q.put(None)
        self._resolver.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -------------------------------------------------------------- threads
    def _take_batch(self) -> Optional[list]:
        """Block until work (or close); linger briefly to coalesce, then pop
        up to batch_size slots. Returns None only on close-and-drained."""
        with self._lock:
            while not self._slots and not self._closing:
                self._lock.wait()
            if not self._slots:
                return None
            deadline = time.monotonic() + self._linger_s
            while (not self._closing and len(self._slots) < self.batch_size
                   and (remain := deadline - time.monotonic()) > 0):
                self._lock.wait(timeout=remain)
            take = self._slots[: self.batch_size]
            del self._slots[: self.batch_size]
            return take

    def _enqueue(self, model, lr: np.ndarray, seq: int) -> tuple:
        """The chain of one device batch, enqueued on the service's stream:
        (the pinned host tensor the result lands in, the event after it, or
        None on the CPU)."""
        cuda = self.device.type == "cuda"
        x = torch.from_numpy(lr)
        if cuda:
            x = x.pin_memory().to(self.device, non_blocking=True)
        b, lh, lw, c = lr.shape
        kw = {}
        if self._noise is not None:
            init, noises = self._noise(seq, (b, 4 * lh, 4 * lw, c), self._plan.n_steps)
            kw["init"] = torch.tensor(np.asarray(init, np.float32))
            kw["noises"] = [torch.tensor(np.asarray(n, np.float32)) for n in noises]
        else:
            kw["generator"] = torch.Generator(device=self.device).manual_seed(
                member_seed(self._seed, seq))
        out = model.generate_sr({"LR": x}, self.schedule, plan=self._plan,
                                clip_denoised=self._clip, **kw)
        if not cuda:
            return out, None
        host = torch.empty(out.shape, dtype=torch.float32, pin_memory=True)
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record(self._stream)
        return host, event

    def _dispatch_loop(self) -> None:
        stream = (torch.cuda.stream(self._stream) if self._stream is not None
                  else contextlib.nullcontext())
        with stream:
            while True:
                slots = self._take_batch()
                if slots is None:
                    break
                n = len(slots)
                pad = self.batch_size - n
                lr = np.stack([s[2] for s in slots] + [slots[0][2]] * pad)
                months = np.asarray([s[3] for s in slots], np.int32)
                with self._lock:
                    model = self._model  # one snapshot per batch: the hot-swap point
                    seq = self._batch_seq
                    self._batch_seq += 1
                    self._stats["device_batches"] += 1
                    self._stats["padded_fields"] += pad
                try:
                    host, event = self._enqueue(model, lr, seq)
                except Exception as e:  # enqueue error -> fail these slots
                    self._fail_slots(slots, e)
                    continue
                # the model rides along: its weights stay alive until the
                # resolver has seen this batch's event
                self._resolve_q.put((slots, host, event, months, model))

    def _resolve_loop(self) -> None:
        while True:
            item = self._resolve_q.get()
            if item is None:
                break
            slots, host, event, months, _ = item
            try:
                if event is not None:
                    event.synchronize()
                sr = host.numpy()[: len(slots)]
                sr = np.asarray(self._inverse_hr(sr, months), np.float32)
            except Exception as e:
                self._fail_slots(slots, e)
                continue
            for row, (pending, i, _, _) in zip(sr, slots):
                if pending.future.done():
                    # an earlier device batch of this request failed (or the
                    # caller cancelled): set_result on a done future would
                    # raise InvalidStateError and kill this thread
                    continue
                if pending.buffer is None:
                    pending.buffer = np.empty((pending.n_fields,) + row.shape, np.float32)
                pending.buffer[i] = row
                pending.remaining -= 1
                if pending.remaining == 0:
                    with self._lock:
                        self._latencies.append(time.monotonic() - pending.t_submit)
                        del self._latencies[:-512]  # bound memory
                    if not pending.future.done():
                        pending.future.set_result(pending.buffer)

    def _fail_slots(self, slots, exc: Exception) -> None:
        seen = set()
        for pending, _, _, _ in slots:
            if id(pending) not in seen:
                seen.add(id(pending))
                if not pending.future.done():
                    pending.future.set_exception(exc)
