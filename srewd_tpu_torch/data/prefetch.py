"""Background batch prefetcher: overlap host batch assembly and the copy to
the card with the steps (port of srewd_tpu/data/prefetch.py).

A bounded background thread pulls batches from the source (the native
reads and the normalisation of DataHandler) and puts each on the device
while the current step runs; `depth` batches are staged ahead. An error in
the thread is raised on the consumer's side, and `close()` stops the
thread after a partial consumption.

On the card, `PinnedCopy` is the put: the thread copies the host arrays
into pinned memory and from there to the card with `non_blocking=True` on
a side stream, and records an event after the copy. On the consumer's
thread `take` makes the consuming stream wait for that event and marks the
tensors as used on it (`record_stream`), so the caching allocator does not
hand their memory to the side stream's next batch while a step still reads
them.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

_SENTINEL = object()


class DevicePrefetcher:
    """Wrap a batch iterator; stage `depth` batches put by `put_fn` ahead,
    each passed through `take_fn` (on the consumer's thread) when taken."""

    def __init__(self, batches: Iterable, put_fn: Callable, depth: int = 2,
                 take_fn: Optional[Callable] = None):
        self._src = batches
        self._put = put_fn
        self._take = take_fn
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._err: BaseException | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _enqueue(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self):
        try:
            for b in self._src:
                if not self._enqueue(self._put(b)):
                    return  # the consumer closed early
        except BaseException as e:  # raised on the consumer's side
            self._err = e
        finally:
            self._enqueue(_SENTINEL)

    def close(self) -> None:
        """Stop and join the producer (safe after a partial consumption)."""
        self._stop.set()
        while True:  # drain, so that a blocked put can finish
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5)

    def __iter__(self) -> Iterator:
        try:
            while True:
                item = self._q.get()
                if item is _SENTINEL:
                    if self._err is not None:
                        raise self._err
                    return
                yield item if self._take is None else self._take(item)
        finally:
            self.close()


class PinnedCopy:
    """put / take of host batches onto a CUDA device for DevicePrefetcher:
    `keys` go to the device, other entries (months) pass through."""

    def __init__(self, device, keys=("HR", "LR")):
        self.device = torch.device(device)
        self.keys = tuple(keys)
        self.stream = torch.cuda.Stream(self.device)

    def put(self, batch: dict) -> tuple:
        """Producer thread: (batch with device tensors, the copy's event)."""
        out = dict(batch)
        with torch.cuda.stream(self.stream):
            for k in self.keys:
                host = torch.from_numpy(np.ascontiguousarray(batch[k])).pin_memory()
                out[k] = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return out, ready

    def take(self, item: tuple) -> dict:
        """Consumer thread: the batch, safe to use on the current stream."""
        out, ready = item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(ready)
        for k in self.keys:
            out[k].record_stream(stream)
        return out
