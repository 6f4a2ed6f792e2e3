"""Persistent batched SR inference over one or several devices (twin of
srewd_tpu/serving/service.py).

A service holds a snapshot of one model's weights and serves requests of
Kelvin LR fields:

* fixed device batch B: requests of any size are split and packed into
  device batches of exactly B fields, in FIFO order, and the last batch is
  padded with copies of its first field (the padding rows are sliced off
  before futures resolve), so the chain always runs at one shape;
* linger: a dispatcher waits up to `linger_ms` for concurrent submitters
  to fill a batch;
* replicas: the JAX service spans a mesh of every device and shards each
  batch over it; the port instead keeps one replica per entry of `devices`
  (every visible card by default; one card may be named twice), each a
  whole copy of the weights (its own snapshot, schedule, chain plan and
  CUDA stream) that runs whole device batches. The replicas share one FIFO
  of slots, one batch counter `seq`, one set of stats and one front end; a
  device batch is never split across devices;
* two threads per replica: its dispatcher takes the next device batch from
  the shared FIFO when it has room in flight (`_IN_FLIGHT` batches between
  its take and their resolution), enqueues the chain on the replica's own
  CUDA stream (the LR copy in, the chain, the copy of the result into
  pinned host memory) and records an event, without waiting for the card;
  the replica's resolver waits on that event, applies the HR inverse and
  resolves the futures. So a batch never waits behind another replica's.
  Every device tensor of a batch is made and used on its replica's stream,
  under its device (`torch.cuda.device`), so no device memory is shared
  across streams; the card runs batch k while the host packs and enqueues
  batch k + 1;
* physical units at the boundary: `transform_lr` (Kelvin -> normalized)
  on the way in, `inverse_hr` on the way out (data/scalers.MonthlyScalerSet);
* hot swap: `update_params` checks the new weights against the served ones
  (keys, shapes, dtypes) once, builds one new snapshot per replica and
  swaps them all under the lock; a dispatcher takes a batch's slots, its
  `seq` and its replica's snapshot in one step under that lock, so every
  batch taken after the swap runs on the new weights, on whichever replica,
  and a batch taken before it finishes on the old ones (which its resolver
  keeps alive until its event). Nothing is copied in place under a queued
  chain. Replicas never share a snapshot: a bf16 chain refreshes its
  model's cast shadow (models/factory.py).

Noise: device batch `seq` draws its chain's noise from a `torch.Generator`
on its replica's device seeded with `member_seed(seed, seq)`
(utils/seeding.py), as the JAX service folds `seq` into its key: a fixed
seed and request order reproduce the exact fields, whatever the number of
replicas and whichever replica ran a batch, and no two batches share a
noise realization. Tests may pass `noise(seq, shape, n) -> (init, noises)`
instead (the port's noise rule: they feed the JAX draws).

A failure fails only the requests of the batch it hit; the service keeps
serving. On the CPU (tests; `devices="cpu"` or `["cpu", "cpu"]`) the chain
runs synchronously in the dispatcher. Code for a second card (a replica's
device scope, its schedule copy, K1's and K3's device switches) runs only
where one exists.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
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
    """Config -> data scalers -> weights on one device, as the port's
    sample.py sets up: the config's dataroot fits the scalers
    (`cli.build_data_handler`), the model gets seeded weights, then
    `model_path` or else path.resume_state, strict or, under
    model.finetune_norm, tolerant (`cli.load_sampling_weights`; its EMA
    with `use_ema`); the sampler comes from model.diffusion
    (`cli.sampler_kwargs`) after `diffusion_overrides` is merged into it
    (the sampler / ddim_steps / clip_denoised flags)."""
    from ..cli import (Config, build_data_handler, cuda_numerics, init_weights,
                       load_sampling_weights, resolve_device, sampler_kwargs)
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
    load_sampling_weights(model, opt, model_path, use_ema=use_ema)
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


_IN_FLIGHT = 4  # device batches a replica holds between its take and their resolution


class _Replica:
    """One device's copy of the served chain: its snapshot of the weights
    (swapped under the service's lock), the schedule and chain plan on its
    device, its CUDA stream, the room it has in flight, the queue from its
    dispatcher to its resolver, and the device batches it took."""

    def __init__(self, device: torch.device, model, schedule, plan):
        self.device = device
        self.model = model
        self.schedule = schedule
        self.plan = plan
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.room = threading.Semaphore(_IN_FLIGHT)
        self.resolve_q: "queue.Queue" = queue.Queue()
        self.device_batches = 0

    def scope(self) -> contextlib.ExitStack:
        """The replica's device and stream made current (for the calling
        thread): a bare allocation or current_stream() then lands on them."""
        scope = contextlib.ExitStack()
        if self.stream is not None:
            scope.enter_context(torch.cuda.device(self.device))
            scope.enter_context(torch.cuda.stream(self.stream))
        return scope


def _settle(future: Future, result=None, exc: Optional[BaseException] = None) -> None:
    """Resolve `future`, unless it is done already (an earlier part of its
    request failed, or the caller cancelled it)."""
    try:
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(result)
    except InvalidStateError:
        pass


class SamplerService:
    """Persistent batched SR inference over one model's reverse chain.

    model: a DiffusionModel, whose structure is served; params: the weights
    to serve, as `model.params()` gives them (each replica keeps its own
    copy on its device); schedule and sampler_kwargs: the chain, as
    generate_sr takes them (`keep_every` is refused); devices: one replica
    per entry, a device, a list or a comma-separated string
    (`cli.resolve_devices`; None, the default, is every visible card and
    raises without one).
    """

    def __init__(
        self,
        model,
        params: dict,
        schedule,
        *,
        batch_size: int = 8,
        devices=None,
        sampler_kwargs: Optional[dict] = None,
        transform_lr: Optional[Callable] = None,
        inverse_hr: Optional[Callable] = None,
        linger_ms: float = 2.0,
        seed: int = 0,
        noise: Optional[Callable] = None,
    ):
        from ..cli import resolve_devices
        from ..diffusion.gaussian import chain_plan

        self.devices = resolve_devices(devices)
        self.batch_size = int(batch_size)
        skw = dict(sampler_kwargs or {})
        if skw.get("keep_every") is not None:
            raise ValueError("SamplerService does not serve keep_every frames")
        self.sampler_kwargs = skw
        self._clip = bool(skw.get("clip_denoised", True))
        self._transform_lr = transform_lr or (lambda x, m: x)
        self._inverse_hr = inverse_hr or (lambda x, m: x)
        self._linger_s = float(linger_ms) / 1e3
        self._seed = int(seed)
        self._noise = noise
        self._replicas = []
        for device in self.devices:
            sched = schedule.to(device)
            # the chain's constants, made once per replica: building them
            # reads the schedule on the host, which would wait for the card
            # on every batch
            plan = chain_plan(sched, skw.get("sampler", "ddpm"), steps=skw.get("ddim_steps", 50),
                              eta=skw.get("ddim_eta", 0.0),
                              tau_spacing=skw.get("tau_spacing", "linspace"), device=device)
            self._replicas.append(
                _Replica(device, model.with_params(params, device), sched, plan))

        self._lock = threading.Condition()
        self._slots: list = []  # [(pending, offset, lr_row, month)], FIFO
        self._lr_shape = None  # [lh, lw, C], locked at first submit
        self._closing = False
        self._batch_seq = 0
        self._stats = {"requests": 0, "fields": 0, "device_batches": 0, "padded_fields": 0}
        self._latencies: list = []  # bounded; request wall seconds
        self._assembly = threading.Lock()  # requests' buffers, filled by every resolver

        self._threads = []
        for i, rep in enumerate(self._replicas):
            for name, loop in (("dispatch", self._dispatch_loop), ("resolve", self._resolve_loop)):
                t = threading.Thread(target=loop, args=(rep,), name=f"srewd-serve-{name}-{i}",
                                     daemon=True)
                t.start()
                self._threads.append(t)

    # ------------------------------------------------------------ factories
    @classmethod
    def from_trainer(cls, trainer, data_handler=None, use_ema: bool = False, **kw):
        """Serve a SNAPSHOT of a DiffusionTrainer's weights (its EMA with
        `use_ema`, where it keeps one): later training steps do not reach
        the service; push fresh weights with update_params().

        data_handler supplies the train-time scalers (Kelvin boundary);
        without it the service runs in normalized space. `devices` defaults
        to the trainer's device.
        """
        params = trainer.params(use_ema)  # whole leaves, also under sharding
        if data_handler is not None:
            sc = data_handler.batch_scalers
            kw.setdefault("transform_lr", sc["lr"].transform)
            kw.setdefault("inverse_hr", sc["hr"].inverse)
        kw.setdefault("sampler_kwargs", trainer.sampler_kwargs)
        kw.setdefault("devices", trainer.device)
        return cls(trainer.whole_model, params, trainer.schedule_val, **kw)

    @classmethod
    def from_checkpoint(cls, config_path: str, model_path: Optional[str] = None,
                        use_ema: bool = False, diffusion_overrides: Optional[dict] = None,
                        *, devices=None, **kw):
        """Build the stack (config -> data scalers -> weights, `load_stack`)
        on the first of `devices` and serve it on each; the service keeps
        the stack as `stack`."""
        from ..cli import resolve_devices

        devices = resolve_devices(devices)
        stack = load_stack(config_path, model_path, use_ema, diffusion_overrides,
                           device=devices[0])
        kw.setdefault("transform_lr", stack.lr_scaler.transform)
        kw.setdefault("inverse_hr", stack.hr_scaler.inverse)
        kw.setdefault("sampler_kwargs", stack.sampler_kwargs)
        svc = cls(stack.model, stack.model.params(), stack.schedule, devices=devices, **kw)
        svc.stack = stack
        return svc

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
            # one chain shape per service: a mismatched field would kill a
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
            return self._replicas[0].model.params()

    def update_params(self, params: dict) -> None:
        """Hot-swap the served weights with zero downtime.

        `params` must match the served weights' keys, shapes and dtypes (no
        new chain shape); a mismatch raises before anything changes. Batches
        already taken finish on the old weights; every batch taken after the
        swap, on any replica, uses the new ones."""
        with self._lock:
            served = self._replicas[0].model
        _check_params(served.params(), params)
        snaps = [served.with_params(params, rep.device) for rep in self._replicas]
        with self._lock:
            for rep, snap in zip(self._replicas, snaps):
                rep.model = snap

    def stats(self) -> dict:
        """Requests, fields, device batches and padded fields over every
        replica; the request latencies' p50 / p95; the batch size; the
        replicas' devices and the device batches each took."""
        with self._lock:
            out = dict(self._stats)
            lat = sorted(self._latencies)
            out["device_batches_per_replica"] = [rep.device_batches for rep in self._replicas]
        if lat:
            out["latency_p50_ms"] = round(1e3 * lat[len(lat) // 2], 2)
            out["latency_p95_ms"] = round(1e3 * lat[int(len(lat) * 0.95)], 2)
        out["batch_size"] = self.batch_size
        out["replicas"] = [str(d) for d in self.devices]
        return out

    def close(self) -> None:
        """Drain every replica's queued work, stop the threads. Idempotent."""
        with self._lock:
            self._closing = True
            self._lock.notify_all()
        for t in self._threads:  # a dispatcher ends its resolver after its last batch
            t.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -------------------------------------------------------------- threads
    def _take_batch(self, rep: _Replica) -> Optional[tuple]:
        """Block until work (or close); linger briefly to coalesce, then pop
        up to batch_size slots, with the batch's `seq` and `rep`'s snapshot,
        in one step under the lock: `seq` follows the FIFO, and a hot swap
        falls between two batches. Returns None only on close-and-drained."""
        with self._lock:
            while True:
                while not self._slots and not self._closing:
                    self._lock.wait()
                if not self._slots:
                    return None
                deadline = time.monotonic() + self._linger_s
                while (not self._closing and len(self._slots) < self.batch_size
                       and (remain := deadline - time.monotonic()) > 0):
                    self._lock.wait(timeout=remain)
                if self._slots:  # else another replica took them while this one lingered
                    break
            take = self._slots[: self.batch_size]
            del self._slots[: self.batch_size]
            seq = self._batch_seq
            self._batch_seq += 1
            self._stats["device_batches"] += 1
            self._stats["padded_fields"] += self.batch_size - len(take)
            rep.device_batches += 1
            return take, seq, rep.model

    def _enqueue(self, rep: _Replica, model, lr: np.ndarray, seq: int) -> tuple:
        """The chain of one device batch, enqueued on `rep`'s stream: (the
        pinned host tensor the result lands in, the event after it, or None
        on the CPU)."""
        cuda = rep.device.type == "cuda"
        x = torch.from_numpy(lr)
        if cuda:
            x = x.pin_memory().to(rep.device, non_blocking=True)
        b, lh, lw, c = lr.shape
        kw = {}
        if self._noise is not None:
            init, noises = self._noise(seq, (b, 4 * lh, 4 * lw, c), rep.plan.n_steps)
            kw["init"] = torch.tensor(np.asarray(init, np.float32), device=rep.device)
            kw["noises"] = [torch.tensor(np.asarray(n, np.float32), device=rep.device)
                            for n in noises]
        else:
            kw["generator"] = torch.Generator(device=rep.device).manual_seed(
                member_seed(self._seed, seq))
        out = model.generate_sr({"LR": x}, rep.schedule, plan=rep.plan,
                                clip_denoised=self._clip, **kw)
        if not cuda:
            return out, None
        host = torch.empty(out.shape, dtype=torch.float32, pin_memory=True)
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record(rep.stream)
        return host, event

    def _dispatch_loop(self, rep: _Replica) -> None:
        with rep.scope():
            while True:
                rep.room.acquire()  # released by the resolver, or below on a failure
                taken = self._take_batch(rep)
                if taken is None:
                    break
                slots, seq, model = taken
                pad = self.batch_size - len(slots)
                lr = np.stack([s[2] for s in slots] + [slots[0][2]] * pad)
                months = np.asarray([s[3] for s in slots], np.int32)
                try:
                    host, event = self._enqueue(rep, model, lr, seq)
                except Exception as e:  # enqueue error -> fail these slots
                    self._fail_slots(slots, e)
                    rep.room.release()
                    continue
                # the model rides along: its weights stay alive until the
                # resolver has seen this batch's event
                rep.resolve_q.put((slots, host, event, months, model))
        rep.resolve_q.put(None)

    def _resolve_loop(self, rep: _Replica) -> None:
        while (item := rep.resolve_q.get()) is not None:
            slots, host, event, months, _ = item
            try:
                if event is not None:
                    event.synchronize()
                sr = host.numpy()[: len(slots)]
                sr = np.asarray(self._inverse_hr(sr, months), np.float32)
            except Exception as e:
                self._fail_slots(slots, e)
            else:
                self._fill(slots, sr)
            finally:
                rep.room.release()

    def _fill(self, slots, sr: np.ndarray) -> None:
        """Each field of a resolved batch into its request's buffer; the
        requests it completes resolve (every replica's resolver fills)."""
        done = []
        with self._assembly:
            for row, (pending, i, _, _) in zip(sr, slots):
                if pending.future.done():  # an earlier part failed, or cancelled
                    continue
                if pending.buffer is None:
                    pending.buffer = np.empty((pending.n_fields,) + row.shape, np.float32)
                pending.buffer[i] = row
                pending.remaining -= 1
                if pending.remaining == 0:
                    done.append(pending)
        now = time.monotonic()
        with self._lock:
            self._latencies.extend(now - p.t_submit for p in done)
            del self._latencies[:-512]  # bound memory
        for pending in done:
            _settle(pending.future, pending.buffer)

    def _fail_slots(self, slots, exc: Exception) -> None:
        for pending in {id(p): p for p, _, _, _ in slots}.values():
            _settle(pending.future, exc=exc)
