"""SMILES character vocabulary.

The port's own copy of ``molvax/data/charset.py`` (numpy only): the port
imports nothing of the ``molvax`` package.
``tests/test_torch_support.py`` holds ``DEFAULT_CHARS``, the codec tables
and both constructors to the reference's.

Reference parity: the reference (aclyde11/molecular-VAE, ChemVAE lineage) stores
its charset inside the preprocessed ZINC-250k ``.h5`` file (keys
``data_train``/``data_test``/``charset``) and builds ``char -> index`` maps at
load time (SURVEY.md section 2.1; reference mount was empty at build time, so no
file:line citation is possible - see SURVEY.md provenance header).

TPU-native design: the charset is a frozen, hashable table so it can be closed
over by jit-compiled functions as a static constant. Index 0 is always the pad
character (space), matching the ChemVAE export convention where SMILES are
right-padded with spaces to ``max_len``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

PAD_CHAR = " "

# Canonical character inventory for ZINC-like SMILES corpora (pad first). The
# reference derives this from data; we pin a superset as the default so that
# configs are reproducible without the original .h5. ~35 symbols per
# BASELINE.json:7 ("~35-token charset").
DEFAULT_CHARS = (
    PAD_CHAR,
    "#", "%", "(", ")", "+", "-", "/", "1", "2", "3", "4", "5", "6", "7",
    "8", "9", "=", "@", "B", "C", "F", "H", "I", "N", "O", "P", "S", "[",
    "\\", "]", "c", "l", "n", "o", "r", "s",
)


@dataclasses.dataclass(frozen=True)
class Charset:
    """Immutable char<->index table. Hashable, so usable as a jit static arg."""

    chars: tuple = DEFAULT_CHARS

    def __post_init__(self):
        if len(self.chars) != len(set(self.chars)):
            raise ValueError("duplicate characters in charset")
        if self.chars[0] != PAD_CHAR:
            raise ValueError("charset must start with the pad character ' '")

    @property
    def size(self) -> int:
        return len(self.chars)

    @property
    def pad_index(self) -> int:
        return 0

    def to_index(self) -> dict:
        return {c: i for i, c in enumerate(self.chars)}

    def __contains__(self, ch: str) -> bool:
        return ch in self.chars

    # -- codec tables ------------------------------------------------------
    def encode_table(self) -> np.ndarray:
        """(256,) uint8 lookup: ascii byte -> charset index (pad if unknown)."""
        table = np.zeros(256, dtype=np.uint8)
        for i, c in enumerate(self.chars):
            table[ord(c)] = i
        return table

    def decode_table(self) -> np.ndarray:
        """(size,) uint8 lookup: charset index -> ascii byte."""
        return np.array([ord(c) for c in self.chars], dtype=np.uint8)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_corpus(cls, smiles: Iterable[str]) -> "Charset":
        """Derive a charset from data, mirroring the reference's h5 charset
        derivation (SURVEY.md 2.1). Pad char always present at index 0."""
        seen = set()
        for s in smiles:
            seen.update(s)
        seen.discard(PAD_CHAR)
        return cls(chars=(PAD_CHAR,) + tuple(sorted(seen)))

    @classmethod
    def from_list(cls, chars: Sequence[str]) -> "Charset":
        """Build from an explicit list (e.g. the `charset` key of a chemvae
        h5 export). Reorders so pad is index 0 if present, else prepends."""
        chars = [c.decode() if isinstance(c, bytes) else str(c) for c in chars]
        if PAD_CHAR not in chars:
            chars = [PAD_CHAR] + chars
        elif chars[0] != PAD_CHAR:
            # Order must be preserved exactly (one-hot data encoded against
            # this charset depends on it) - never silently remap indices.
            raise ValueError(
                "charset has pad char at nonzero index; remap your data or "
                "use Charset(chars=...) directly"
            )
        return cls(chars=tuple(chars))


DEFAULT_CHARSET = Charset()
