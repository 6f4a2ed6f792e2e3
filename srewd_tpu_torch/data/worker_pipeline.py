"""Worker-process input pipeline: the counterpart of the JAX package's
grain backend (srewd_tpu/data/grain_pipeline.py `grain_batches`).

    from srewd_tpu_torch.data.worker_pipeline import worker_batches
    for batch in worker_batches(dh, split="train", epoch=0, worker_count=4):
        trainer.train_on_batch(batch)

A `torch.utils.data.DataLoader` over a map-style dataset of the handler's
timestamps, each sample read by `DataHandler.assemble`, so the batches are
the in-process pipeline's by construction: {"HR", "LR", "months"} as
numpy NHWC float32 (months int32), normalized, drop_last. Worker
processes start by `spawn`: a process that has started CUDA must not fork
(the child inherits a CUDA context it cannot use, and whatever locks its
threads held), and the handler pickles; a script that asks for workers
needs the `if __name__ == "__main__":` guard, since `spawn` imports the
main module in each worker. Nothing in the port's entry points calls it,
as JAX's train.py does not call grain_batches.
"""

from __future__ import annotations

import multiprocessing as mp
from typing import Iterator

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset

from ..parallel import rank, world_size


class _SampleSource(Dataset):
    """One sample per timestamp of the index, through `handler.assemble`."""

    def __init__(self, handler, timestamps: np.ndarray):
        self._h = handler
        self._ts = timestamps

    def __len__(self) -> int:
        return len(self._ts)

    def __getitem__(self, idx: int) -> dict:
        one = self._h.assemble(self._ts[idx: idx + 1])
        return {k: one[k][0] for k in ("HR", "LR", "months")}


def _stack(samples: list) -> dict:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def sample_order(n: int, shuffle: bool, seed: int, shard: bool) -> list:
    """The indices one process reads, in order: with `shard`, its contiguous
    block of n // world_size() (the remainder dropped, as grain's
    ShardByJaxProcess(drop_remainder=True)), then, with `shuffle`, that block
    in the order of a permutation from a torch.Generator seeded with `seed`."""
    lo, hi = 0, n
    if shard and world_size() > 1:
        per = n // world_size()
        lo, hi = rank() * per, (rank() + 1) * per
    order = torch.arange(lo, hi)
    if shuffle:
        order = order[torch.randperm(hi - lo, generator=torch.Generator().manual_seed(seed))]
    return order.tolist()


def worker_batches(handler, split: str = "train", epoch: int = 0, batch_size: int | None = None,
                   worker_count: int = 0, shard_by_process: bool = True) -> Iterator[dict]:
    """The split's batches: an iterator over a DataLoader with
    `worker_count` worker processes (0: in this process). The workers start,
    and read ahead, when it returns; dropping the iterator stops them.

    On train with `handler.shuffle`, the order is a permutation seeded with
    handler.seed + 7919 * epoch, grain_batches' seed; grain's own permutation
    cannot be reproduced without grain, so the orders differ from the JAX
    package's. With `shard_by_process`, each rank takes its block of the
    index only where the handler did not stride it already
    (`process_count` == 1), as grain_batches does.
    """
    train = split == "train"
    ts = handler.train_timestamps if train else handler.val_timestamps
    bs = batch_size or (handler.train_batch_size if train else handler.val_batch_size)
    order = sample_order(len(ts), train and handler.shuffle, handler.seed + 7919 * epoch,
                         shard_by_process and handler.process_count == 1)
    loader = DataLoader(_SampleSource(handler, ts), batch_size=bs, sampler=order,
                        drop_last=True, num_workers=worker_count, collate_fn=_stack,
                        multiprocessing_context=mp.get_context("spawn") if worker_count else None)
    return iter(loader)
