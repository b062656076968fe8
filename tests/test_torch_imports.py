"""molvax_torch runs on a host without JAX: nothing of it imports JAX or the
``molvax`` package, and a request for CUDA where there is none raises."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_support import configs

ROOT = Path(__file__).resolve().parent.parent


def _env_with_repo():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import molvax_torch, molvax_torch.latent.sample, molvax_torch.kernels.generate\n"
        "import molvax_torch.io.convert, molvax_torch.kernels._build\n"
        "import molvax_torch.train, molvax_torch.kernels.gru_stack, molvax_torch.kernels.conv_enc\n"
        "import molvax_torch.kernels.sampler, molvax_torch.kernels.gru\n"
        "bad = [m for m in sys.modules if m in ('jax', 'molvax') "
        "or m.startswith(('jax.', 'molvax.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=_env_with_repo(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_source_imports_jax_or_the_reference_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|molvax)(\.|\s|$)", re.M)
    files = sorted((ROOT / "molvax_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from molvax_torch.nn.vae import MolecularVAE
    from molvax_torch.utils import resolve_device

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MolecularVAE(configs()[1], device="cuda")


def test_chip_smoke_fails_without_cuda_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=_env_with_repo(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
