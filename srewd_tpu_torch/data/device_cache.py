"""A split held in device memory: upload it once, gather each batch on the
device (port of srewd_tpu/data/device_cache.py).

The normalised fields of the split are assembled on the host in chunks and
copied into one device tensor per key, so the host holds one chunk at a
time. Each batch is then an `index_select` on the device: no host read and
no host-to-device copy per step; the epoch's order goes to the device once.

Batches equal DataHandler._batches bit for bit: the same seeded shuffle
(seed + 7919 * epoch), drop_last, month-keyed normalisation (the fields are
cached after it) and `skip` for a resume inside an epoch. A t2m field at
128x256 is 0.13 MB in float32 (HR and LR together ~0.14 MB), so a year of
hourly fields takes ~1.2 GB of the card's 80 GB.

One process only: under several ranks each streams its own stride of the
index (DataHandler's process_index), and `run_training` takes the cache at
world size 1 only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import world_size

__all__ = ["DeviceDataset"]


class DeviceDataset:
    """One split of a DataHandler, resident on `device`.

    chunk: fields assembled on the host per upload (bounds host memory
    during the one-time build).
    """

    def __init__(self, dh, device, split: str = "train", chunk: int = 256):
        if world_size() > 1:
            raise RuntimeError("DeviceDataset holds one process's split; under several "
                               "processes each rank streams its stride of the index")
        ts = dh.train_timestamps if split == "train" else dh.val_timestamps
        self._n = len(ts)
        self._batch_size = dh.train_batch_size if split == "train" else dh.val_batch_size
        self._shuffle = dh.shuffle if split == "train" else False
        self._seed = dh.seed
        self.device = torch.device(device)
        self.HR = self.LR = None
        months = []
        for lo in range(0, self._n, chunk):
            b = dh.assemble(ts[lo:lo + chunk])
            if self.HR is None:
                self.HR, self.LR = (torch.empty((self._n, *b[k].shape[1:]), dtype=torch.float32,
                                                device=self.device) for k in ("HR", "LR"))
            hi = lo + len(b["months"])
            self.HR[lo:hi].copy_(torch.from_numpy(b["HR"]))
            self.LR[lo:hi].copy_(torch.from_numpy(b["LR"]))
            months.append(b["months"])
        self.months = np.concatenate(months) if months else np.zeros(0, np.int32)

    @property
    def nbytes(self) -> int:
        if self.HR is None:
            return 0
        return sum(t.numel() * t.element_size() for t in (self.HR, self.LR))

    def __len__(self) -> int:
        return self._n

    def batches(self, epoch: int = 0, skip: int = 0):
        """The epoch's batches in DataHandler._batches order, from the
        `skip`-th on, as device tensors (`months` stays numpy)."""
        n = (self._n // self._batch_size) * self._batch_size  # drop_last
        if n == 0:
            return
        order = np.arange(self._n)
        if self._shuffle:
            np.random.default_rng(self._seed + 7919 * epoch).shuffle(order)
        order_d = torch.from_numpy(order).to(self.device)
        for lo in range(skip * self._batch_size, n, self._batch_size):
            idx = order_d[lo:lo + self._batch_size]
            yield {"HR": self.HR.index_select(0, idx), "LR": self.LR.index_select(0, idx),
                   "months": self.months[order[lo:lo + self._batch_size]]}
