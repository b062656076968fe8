"""SMILES featurization: string <-> uint8 codes (numpy) <-> one-hot (torch).

Port of ``molvax/data/featurize.py``. Hosts handle (N, T) uint8 code arrays;
the one-hot is built on the device the codes live on.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

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
