"""Batch pipeline: host uint8 codes -> device tensors.

Port of ``molvax/data/pipeline.py:28-114`` in torch. The host keeps only
uint8 codes; a batch crosses to the device as (B, T) bytes, and a stack of
K batches for the chunked trainer (``train.loop.make_train_chunk``) as one
(K, B, T) copy. Epoch order is a seeded host-side permutation (numpy's
``default_rng(seed)``, as the reference), so runs are reproducible and a
resumed run replays its batches (``fast_forward``); batches are full
(drop_last), so shapes stay static.

On a card the batch is gathered straight into a pinned host buffer and
copied with ``non_blocking=True`` (``utils.PinnedStaging``: two buffers,
each guarded by a CUDA event, so the host never rewrites a buffer that a
copy is still reading). The codes are checked on the host against the
charset once: a code at or past its size would make ``F.one_hot`` fail on
the card with a device-side assert.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch

from ..utils import PinnedStaging, resolve_device
from .zinc import Dataset


class BatchIterator:
    """Infinite shuffled batch stream of (codes, properties or None) on
    ``device`` (the card unless the caller asks for the CPU): uint8 codes,
    float32 properties where ``with_properties`` and the dataset has them."""

    def __init__(
        self,
        dataset: Dataset,
        batch_size: int,
        seed: int = 0,
        device: Optional[Union[str, torch.device]] = None,
        with_properties: bool = False,
    ):
        if len(dataset) == 0:
            raise ValueError(
                "empty corpus: the dataset has 0 rows (a .smi/.csv whose "
                "lines were all headers/blank/longer than max_len loads "
                "empty) — check data.source / data.max_len"
            )
        if int(dataset.codes.max()) >= dataset.charset.size:
            raise ValueError(f"the dataset holds code {int(dataset.codes.max())}, past its charset of "
                             f"{dataset.charset.size} characters")
        if len(dataset) < batch_size:
            # tile small datasets up to one batch so smoke configs run
            reps = -(-batch_size // len(dataset))
            dataset = Dataset(
                np.tile(dataset.codes, (reps, 1)),
                dataset.charset,
                None
                if dataset.properties is None
                else np.tile(dataset.properties, (reps, 1)),
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.with_properties = with_properties and dataset.properties is not None
        self._rng = np.random.default_rng(seed)
        self._perm = self._rng.permutation(len(dataset))
        self._pos = 0
        self.epoch = 0
        self.steps_per_epoch = len(dataset) // batch_size
        cuda = self.device.type == "cuda"
        self._stage = (PinnedStaging(self.device), PinnedStaging(self.device)) if cuda else None

    def fast_forward(self, n_batches: int) -> None:
        """Advance the (deterministic) shuffle position by n_batches without
        touching data - used on checkpoint resume so the replayed run sees
        exactly the batches an uninterrupted run would have seen."""
        for _ in range(n_batches):
            self._next_indices()

    def _next_indices(self) -> np.ndarray:
        if self._pos + self.batch_size > len(self._perm):
            self._perm = self._rng.permutation(len(self.dataset))
            self._pos = 0
            self.epoch += 1
        idx = self._perm[self._pos : self._pos + self.batch_size]
        self._pos += self.batch_size
        return idx

    def _put(self, idx: np.ndarray) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Rows ``idx`` (any shape) of the codes and properties on the
        device: gathered into pinned memory and copied without blocking on
        a card; gathered into new host arrays on the CPU."""
        props = self.dataset.properties if self.with_properties else None
        if self._stage is None:
            codes = torch.from_numpy(self.dataset.codes[idx])
            return codes, None if props is None else torch.from_numpy(np.asarray(props[idx], np.float32))

        def gather(src):
            return lambda buf: np.take(src, idx, axis=0, out=buf)

        codes = self._stage[0].copy((*idx.shape, self.dataset.max_len), torch.uint8, gather(self.dataset.codes))
        if props is not None:
            props = self._stage[1].copy((*idx.shape, props.shape[1]), torch.float32,
                                        gather(np.asarray(props, np.float32)))
        return codes, props

    def __iter__(self) -> Iterator:
        return self

    def __next__(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return self._put(self._next_indices())

    def next_stack(self, k: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """k batches stacked to (k, B, T) (and (k, B, P)) for the chunked
        trainer: one host-to-device copy per k steps."""
        return self._put(np.stack([self._next_indices() for _ in range(k)]))
