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
        "import molvax_torch.config, molvax_torch.data.charset, molvax_torch.data.smiles_check\n"
        "import molvax_torch.latent.constrain, molvax_torch.latent.beam, molvax_torch.kernels.automaton\n"
        "import molvax_torch.train.profiling, molvax_torch.kernels.floor, molvax_torch.probes\n"
        "import molvax_torch.probes.gru_experiments, molvax_torch.probes.proto_gi_kernel\n"
        "import molvax_torch.probes.auto_loop_probe, molvax_torch.probes.capture_probe\n"
        "import molvax_torch.data, molvax_torch.data.native, molvax_torch.data.zinc, molvax_torch.data.molgen\n"
        "import molvax_torch.data.properties, molvax_torch.data.pipeline, molvax_torch.data.featurize\n"
        "from molvax_torch.train import make_train_chunk, effective_config, train, reconstruction_metrics\n"
        "import molvax_torch.train.metrics, molvax_torch.train.evaluate, molvax_torch.io.checkpoint\n"
        "import molvax_torch.latent.interpolate, molvax_torch.latent.optimize, molvax_torch.latent.embed\n"
        "bad = [m for m in sys.modules if m in ('jax', 'molvax', 'bench') "
        "or m.startswith(('jax.', 'molvax.', 'bench.'))]\n"
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
    """No import of JAX, ``molvax`` or the reference's probes (``bench``, which
    import JAX), and no loading of a reference file by path
    (``spec_from_file_location``, or ``"molvax"`` joined to a path): the port
    keeps its own copies of what it needs."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|molvax|bench)(\.|\s|$)", re.M)
    by_path = re.compile(
        r"spec_from_file_location|SourceFileLoader|run_path"
        r"|/\s*[\"']molvax[\"']|joinpath\([^)]*[\"']molvax[\"']"
        r"|os\.path\.join\([^)]*[\"']molvax[\"']"
    )
    files = sorted((ROOT / "molvax_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders
    loaders = [str(f) for f in files if by_path.search(f.read_text())]
    assert not loaders, loaders
    assert not (ROOT / "molvax_torch" / "_shared.py").exists()


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from molvax_torch.nn.vae import MolecularVAE
    from molvax_torch.utils import resolve_device

    from molvax_torch.config import get_preset
    from molvax_torch.train import init_state

    for dev in ("cuda", None):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(dev)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MolecularVAE(configs()[1], device=dev)
    # the entry points default to the card: without a device they raise too
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MolecularVAE(configs()[1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_state(get_preset("chemvae_5k"))
    assert resolve_device("cpu") == torch.device("cpu")


def test_automaton_init_state_defaults_to_the_card():
    """``latent.constrain.init_state`` builds on the card unless asked for
    the CPU; without a card the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from molvax_torch.latent.constrain import init_state

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_state(4, 10)
    assert init_state(4, 10, device="cpu").val.device == torch.device("cpu")


def test_chip_smoke_fails_without_cuda_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=_env_with_repo(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
