"""The inputs the benchmark makes from ``--seed``: corpora and request seeds.

Every seed gives the same set of sizes in another order: a training
corpus's string lengths are fixed by the mix (evenly spread between its
shortest and longest), only their order and the characters change with the
seed, so two seeds ask the same work of every layer. Rows all differ.
"""

from __future__ import annotations

import numpy as np

_CORPUS_SALT = 0xC0A9
_REQUEST_SALT = 0x5A3D


def train_corpus(seed: int, rows: int, max_len: int, charset_size: int, len_min: int, len_max: int) -> np.ndarray:
    """(rows, max_len) uint8 codes: row i holds a string of one of the
    mix's lengths, its characters uniform over the non-pad codes, then pad
    (code 0). No two rows are equal."""
    rng = np.random.default_rng([seed, _CORPUS_SALT])
    lengths = rng.permutation(np.linspace(len_min, len_max, rows).round().astype(np.int64))
    while True:
        codes = rng.integers(1, charset_size, size=(rows, max_len), dtype=np.uint8)
        codes[np.arange(max_len)[None, :] >= lengths[:, None]] = 0
        if len(np.unique(codes, axis=0)) == rows:
            return codes


def batch_order(seed: int, rows: int, batch: int, count: int) -> np.ndarray:
    """(count, batch) row indices of the first ``count`` batches of a
    shuffled stream over ``rows`` rows: a permutation from numpy's
    ``default_rng(seed)``, walked in full batches, drawn anew when the rest
    is shorter than a batch (the order in which a training run reads its
    corpus)."""
    rng = np.random.default_rng(seed)
    perm, pos, out = rng.permutation(rows), 0, []
    for _ in range(count):
        if pos + batch > rows:
            perm, pos = rng.permutation(rows), 0
        out.append(perm[pos:pos + batch])
        pos += batch
    return np.stack(out)


def request_seed(seed: int, i: int) -> int:
    """The generator seed of request i of a run."""
    return int(np.random.SeedSequence([seed, _REQUEST_SALT, i]).generate_state(2, np.uint32).view(np.uint64)[0] >> 1)
