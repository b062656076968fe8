"""SMILES character vocabulary: the reference's ``molvax/data/charset.py``,
loaded by path without JAX (``_shared.py``). Index 0 is the pad character."""

from __future__ import annotations

from .._shared import load_reference_file

_ref = load_reference_file("data/charset.py", "_shared_charset")

PAD_CHAR = _ref.PAD_CHAR
DEFAULT_CHARS = _ref.DEFAULT_CHARS
Charset = _ref.Charset
DEFAULT_CHARSET = _ref.DEFAULT_CHARSET

__all__ = ["PAD_CHAR", "DEFAULT_CHARS", "Charset", "DEFAULT_CHARSET"]
