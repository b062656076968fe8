"""Build the hand-written CUDA kernels at first use and load them with ctypes.

``csrc/*.cu`` export plain C entry points (no PyTorch headers), so one
``nvcc`` call builds them in seconds into ``build/molvax_torch/`` at the
root of the checkout, under a name keyed by a hash of the sources and the
flags: an edited source builds anew, an unchanged one loads the library
already there. Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "molvax_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    """What ``load()`` did: the library path, whether it compiled, the
    seconds the compile took, and nvcc's output (ptxas register report)."""

    path: Path
    compiled: bool
    seconds: float
    log: str


_lib: Optional[ctypes.CDLL] = None
info: Optional[BuildInfo] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmolvax_torch_{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library."""
    global _lib, info
    if _lib is not None:
        return _lib
    path = library_path()
    compiled, seconds, log = False, 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = [str(s) for s in _sources() if s.suffix == ".cu"]
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
            capture_output=True,
            text=True,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
        compiled = True
    _lib = ctypes.CDLL(str(path))
    info = BuildInfo(path, compiled, seconds, log)
    return _lib
