"""SMILES featurization: string <-> uint8 codes (numpy) <-> one-hot (torch).

Port of ``molvax/data/featurize.py``. Hosts handle (N, T) uint8 code arrays;
the one-hot is built on the device the codes live on. ``F.one_hot`` raises
on the CPU for a code at or past C, and on a card fails with a device-side
assert where the reference's ``jax.nn.one_hot`` gives a zero row: the
training entry points check codes on the host first
(``train.loop.effective_config``, ``data.pipeline.BatchIterator``).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import resolve_device
from .charset import DEFAULT_CHARSET, Charset


def encode_smiles(
    smiles: Union[str, Sequence[str]],
    charset: Charset = DEFAULT_CHARSET,
    max_len: int = 120,
    strict: bool = True,
) -> np.ndarray:
    """Encode SMILES string(s) to (N, max_len) uint8 charset codes.

    Right-pads with the pad code (0); truncation is an error under
    ``strict``."""
    if isinstance(smiles, str):
        smiles = [smiles]
    table = charset.encode_table()
    known = np.zeros(256, dtype=bool)
    for c in charset.chars:
        known[ord(c)] = True

    out = np.zeros((len(smiles), max_len), dtype=np.uint8)
    for i, s in enumerate(smiles):
        if len(s) > max_len:
            if strict:
                raise ValueError(f"SMILES longer than max_len={max_len}: {s!r}")
            s = s[:max_len]
        b = np.frombuffer(s.encode("ascii"), dtype=np.uint8)
        if strict and not known[b].all():
            bad = sorted({chr(x) for x in b[~known[b]]})
            raise ValueError(f"SMILES chars not in charset: {bad} in {s!r}")
        out[i, : len(b)] = table[b]
    return out


def decode_codes(
    codes: Union[np.ndarray, torch.Tensor],
    charset: Charset = DEFAULT_CHARSET,
) -> List[str]:
    """(N, T) integer codes -> SMILES strings, pad characters dropped."""
    if isinstance(codes, torch.Tensor):
        codes = codes.cpu().numpy()
    codes = np.asarray(codes)
    if codes.ndim == 1:
        codes = codes[None]
    dec = charset.decode_table()
    pad = charset.chars[charset.pad_index]
    return [dec[row].tobytes().decode("ascii").replace(pad, "") for row in codes]


def one_hot(
    codes: torch.Tensor, charset_size: int, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """(..., T) integer codes -> (..., T, C) one-hot on the codes' device."""
    return F.one_hot(codes.long(), charset_size).to(dtype)


def argmax_codes(probs_or_logits: torch.Tensor) -> torch.Tensor:
    """(..., T, C) -> (..., T) greedy int32 codes (the inverse of one_hot up
    to ties; the first maximum wins, as ``jnp.argmax``)."""
    return torch.argmax(probs_or_logits, dim=-1).to(torch.int32)


def smiles_to_one_hot(
    smiles: Union[str, Sequence[str]],
    charset: Charset = DEFAULT_CHARSET,
    max_len: int = 120,
    dtype: torch.dtype = torch.float32,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """SMILES -> (N, max_len, C) one-hot on ``device`` (the card unless the
    caller asks for the CPU)."""
    codes = torch.from_numpy(encode_smiles(smiles, charset, max_len))
    return one_hot(codes.to(resolve_device(device)), charset.size, dtype=dtype)


def one_hot_to_smiles(x: torch.Tensor, charset: Charset = DEFAULT_CHARSET) -> List[str]:
    return decode_codes(argmax_codes(x), charset)


def is_valid_smiles(s: str, charset: Charset = DEFAULT_CHARSET) -> bool:
    """Grammar-level validity heuristic (no RDKit offline): charset
    membership, balanced ()/[] and no empty string."""
    if not s or any(c not in charset for c in s):
        return False
    depth = 0
    sq = 0
    for c in s:
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        elif c == "[":
            sq += 1
        elif c == "]":
            sq -= 1
        if depth < 0 or sq < 0 or sq > 1:
            return False
    return depth == 0 and sq == 0


def valid_fraction(smiles: Iterable[str], charset: Charset = DEFAULT_CHARSET) -> float:
    """Fraction of strings passing ``is_valid_smiles``."""
    n = 0
    ok = 0
    for s in smiles:
        n += 1
        if is_valid_smiles(s, charset):
            ok += 1
    return ok / max(n, 1)
