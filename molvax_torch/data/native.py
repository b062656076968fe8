"""ctypes bridge to the native tokenizer (``data/_native/tokenizer.cpp``).

The port's own copy of ``molvax/data/native.py`` with its own copy of the
C++ source. It builds lazily with g++ at first use into ``build/tokenizer/``
at the root of the checkout, under a name keyed by a hash of the source,
the flags and the host CPU (``-march=native``: a library built on one
machine may not run on another that finds the same checkout). The build
writes a temporary file and ``os.replace``s it into place under an
exclusive ``flock`` on ``build/tokenizer/build.lock``, so
concurrent first builds (several test workers, several processes) make one
library and no process loads a half-written one (the reference's first
builds race: each process runs g++ into the same file). Every entry point
falls back to the NumPy implementation in ``featurize.py`` where g++ cannot
build or the library cannot load: a host tokenizer, not a device kernel.
``native_available()`` says which of the two runs. The native path matters
at MOSES scale (1.9M SMILES): the multithreaded C++ tokenizes the whole
corpus in well under a second, against minutes of Python char loops.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from .charset import Charset, DEFAULT_CHARSET

SRC = Path(__file__).resolve().parent / "_native" / "tokenizer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tokenizer"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _cpu_signature() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            return "".join(ln for ln in f if ln.startswith(("flags", "model name")))[:4096]
    except OSError:
        return platform.processor() or platform.machine()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SRC.read_bytes() + _cpu_signature().encode())
    return BUILD_DIR / f"libmolvax_tokenizer_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> bool:
    """Compile to a temporary file beside ``path`` and move it into place,
    under an exclusive lock: the first process builds, the others wait and
    find the library there."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                return True
            fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
            os.close(fd)
            try:
                subprocess.run(["g++", *FLAGS, str(SRC), "-o", tmp], check=True, capture_output=True, timeout=120)
                os.replace(tmp, path)
                return True
            except (OSError, subprocess.SubprocessError):
                return False
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        i64, u8p = ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)
        i64p, cp = ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p
        lib.mv_encode_batch.restype = i64
        lib.mv_encode_batch.argtypes = [cp, i64p, i64, u8p, u8p, i64, ctypes.c_uint8, u8p]
        lib.mv_decode_batch.restype = None
        lib.mv_decode_batch.argtypes = [u8p, i64, i64, u8p, ctypes.c_uint8, cp, i64p]
        lib.mv_count_valid.restype = i64
        lib.mv_count_valid.argtypes = [u8p, i64, i64] + [ctypes.c_uint8] * 5
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def encode_smiles_native(
    smiles: Sequence[str],
    charset: Charset = DEFAULT_CHARSET,
    max_len: int = 120,
    strict: bool = True,
) -> np.ndarray:
    """Native-path equivalent of featurize.encode_smiles. Falls back to the
    NumPy implementation when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        from .featurize import encode_smiles

        return encode_smiles(list(smiles), charset, max_len, strict)

    buf = "".join(smiles).encode("ascii")
    offsets = np.zeros(len(smiles) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in smiles], out=offsets[1:])
    table = charset.encode_table()
    known = np.zeros(256, dtype=np.uint8)
    for c in charset.chars:
        known[ord(c)] = 1
    out = np.empty((len(smiles), max_len), dtype=np.uint8)
    clean = lib.mv_encode_batch(
        buf,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(smiles),
        _u8ptr(table),
        _u8ptr(known),
        max_len,
        charset.pad_index,
        _u8ptr(out),
    )
    if strict and clean != len(smiles):
        # Re-run the strict NumPy path to produce the precise error message.
        from .featurize import encode_smiles

        return encode_smiles(list(smiles), charset, max_len, strict=True)
    return out


def decode_codes_native(
    codes: np.ndarray, charset: Charset = DEFAULT_CHARSET
) -> List[str]:
    lib = get_lib()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    if codes.ndim == 1:
        codes = codes[None]
    if lib is None:
        from .featurize import decode_codes

        return decode_codes(codes, charset)
    n, max_len = codes.shape
    out_buf = ctypes.create_string_buffer(n * max_len)
    out_lens = np.empty(n, dtype=np.int64)
    lib.mv_decode_batch(
        _u8ptr(codes),
        n,
        max_len,
        _u8ptr(charset.decode_table()),
        charset.pad_index,
        out_buf,
        out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    raw = out_buf.raw
    return [
        raw[i * max_len : i * max_len + out_lens[i]].decode("ascii")
        for i in range(n)
    ]


def valid_fraction_native(
    codes: np.ndarray, charset: Charset = DEFAULT_CHARSET
) -> float:
    """Grammar-validity fraction computed directly on encoded batches."""
    lib = get_lib()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    if codes.ndim == 1:
        codes = codes[None]
    if lib is None:
        from .featurize import decode_codes, valid_fraction

        return valid_fraction(decode_codes(codes, charset), charset)
    idx = charset.to_index()

    def code_of(ch, fallback=255):
        return idx.get(ch, fallback)

    n, max_len = codes.shape
    good = lib.mv_count_valid(
        _u8ptr(codes),
        n,
        max_len,
        charset.pad_index,
        code_of("("),
        code_of(")"),
        code_of("["),
        code_of("]"),
    )
    return good / max(n, 1)
