"""Build the hand-written CUDA kernels at first use and load them with ctypes.

``csrc/*.cu`` export plain C entry points (no PyTorch headers). Each source
compiles in its own ``nvcc`` process, all started together, and one more
call links the objects into a shared library in ``build/molvax_torch/`` at
the root of the checkout, under a name keyed by a hash of the sources and
the flags: an edited source builds anew, an unchanged one loads the library
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    """What ``load()`` did: the library path, whether it compiled, the
    seconds the build took, and nvcc's output (ptxas register report)."""

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
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmolvax_torch_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> str:
    """Compile every ``.cu`` in parallel, link, and move the library to
    ``path`` atomically. Returns nvcc's combined output."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        jobs = []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = Path(tmpdir) / f"{src.stem}.o"
            cmd = [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        lib = Path(tmpdir) / "lib.so"
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib), *(str(o) for _, o, _ in jobs)],
            capture_output=True, text=True,
        )
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
        os.replace(lib, path)  # atomic: a concurrent loader never sees half a file
    return log


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library."""
    global _lib, info
    if _lib is not None:
        return _lib
    path = library_path()
    compiled, seconds, log = False, 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        log = _build(path)
        seconds = time.perf_counter() - t0
        compiled = True
    _lib = ctypes.CDLL(str(path))
    info = BuildInfo(path, compiled, seconds, log)
    return _lib


def function(name: str, argtypes) -> ctypes._CFuncPtr:
    """The library's C entry point ``name``, with its argument types set
    (ctypes otherwise passes a pointer as a 32-bit int) and an int result:
    the launch's ``cudaError_t``."""
    fn = getattr(load(), name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {err}")
