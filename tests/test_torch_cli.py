"""``python -m molvax_torch.cli`` on the CPU (``MOLVAX_PLATFORM=cpu``): the
reference's ``molvax`` commands, flags and output, held to ``molvax.cli``
and to the reference's latent functions on the same weights (fp32, tiny
widths, atol = rtol = 2e-4).

A module fixture trains two tiny checkpoints through the CLI: a plain
model with EMA weights and ``select_best`` (so ``best/`` exists), and a
property model. Every command then runs against them in this process; one
runs in a child process without JAX (``tests/conftest.py`` imports JAX
into this one)."""

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import molvax.cli as jcli
import molvax.config as jconfig
import molvax.latent as jlatent
from molvax.data.charset import Charset as JCharset
from molvax_torch import cli
from molvax_torch.config import get_preset, to_dict
from molvax_torch.io.convert import jax_from_state_dict
from test_torch_eval_keys import check_report

ROOT = Path(__file__).resolve().parent.parent
TOL = 2e-4
TINY = ["--override", "model.max_len=32", "--override", "data.max_len=32", "--override", "model.latent_dim=12",
        "--override", "model.enc_hidden=16", "--override", "model.gru_hidden=16", "--override", "model.gru_layers=2",
        "--override", "model.compute_dtype='float32'", "--override", "train.batch_size=16",
        "--override", "train.train_chunk_size=1"]
SMILES = ["CCO", "c1ccccc1", "CC(=O)O", "CCN(CC)CC", "OC(=O)c1ccccc1"]


def _with(*pairs):
    out = []
    for p in pairs:
        out += ["--override", p]
    return out


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    monkeypatch.setenv("MOLVAX_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Two tiny trained checkpoint directories: (plain with EMA and best/,
    property model with EMA)."""
    root = tmp_path_factory.mktemp("cli")
    plain, prop = str(root / "plain"), str(root / "prop")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MOLVAX_PLATFORM", "cpu")
        assert cli.main(["train", "--preset", "chemvae_5k", "--steps", "8", "--quiet", "--metrics",
                         str(root / "m.jsonl")] + TINY + _with(
            "data.n_synthetic=64", f"train.checkpoint_dir={plain}", "train.log_every=4", "train.eval_every=4",
            "train.eval_batches=1", "train.eval_roundtrip_n=8", "train.select_best=True",
            "train.checkpoint_every=4", "train.ema_decay=0.9")) == 0
        assert cli.main(["train", "--preset", "property_joint", "--steps", "4", "--quiet"] + TINY + _with(
            "data.n_synthetic=48", f"train.checkpoint_dir={prop}", "train.log_every=2",
            "train.ema_decay=0.9")) == 0
    rows = [json.loads(line) for line in open(root / "m.jsonl")]
    assert rows[-1]["step"] == 8 and any("eval_recon_exact" in r for r in rows)
    assert os.path.isdir(os.path.join(plain, "best"))
    return root, plain, prop


def run(capsys, argv):
    assert cli.main(argv) == 0
    out = capsys.readouterr()
    return out.out.splitlines(), out.err


def reference_weights(ckpt):
    """The served state (best/'s EMA) as the reference's params and config."""
    cfg, state, charset = cli._restore(get_preset("chemvae_5k"), ckpt)
    params = jax.tree.map(jnp.asarray, jax_from_state_dict(state.params.state_dict()))
    return jconfig.from_dict(to_dict(cfg)), params, JCharset(chars=charset.chars)


def test_presets_output_is_the_references(capsys, monkeypatch):
    lines, _ = run(capsys, ["presets"])
    monkeypatch.delenv("MOLVAX_PLATFORM")
    assert jcli.main(["presets"]) == 0
    # the reference's seven, then the port's own gvae_zinc, which the reference does not run
    assert lines[:-1] == capsys.readouterr().out.splitlines() and len(lines) == 8
    assert lines[-1].startswith("gvae_zinc: ")


@pytest.mark.parametrize("pairs", [
    [],
    ["train.batch_size=128", "model.use_pallas=True"],
    ["train.checkpoint_dir=/tmp/x", "data.source=synthetic_chem", "model.conv_kernels=(5, 5, 5)"],
    ["train.lr=1e-3", "name=a=b", "model.property_mean=None", "x.y='quoted'"],
])
def test_parse_overrides_matches_reference(pairs):
    assert cli._parse_overrides(pairs) == jcli._parse_overrides(pairs)


@pytest.mark.parametrize("bad", [["nokey"], ["a=1", "b"]])
def test_bad_override_exits(bad):
    for mod in (cli, jcli):
        with pytest.raises(SystemExit, match="expects key=value"):
            mod._parse_overrides(bad)
    with pytest.raises(SystemExit):
        cli.main(["train", "--override", bad[-1], "--steps", "1"])


@pytest.mark.parametrize("text", [
    "# hdr\nCCO\tZINC-1,batch2\nCCN,plain_csv\nsmiles\nCCC\n",
    "canonical_smiles\nCCO ethanol\nc1ccccc1 benzene,x\n",
    "\n\n  CCO  \n,\n#c1ccccc1\nSMILES,logP\nCC(=O)O,1.2\n",
])
def test_read_smiles_lines_matches_reference(tmp_path, text):
    p = tmp_path / "in.smi"
    p.write_text(text)
    assert cli._read_smiles_lines(str(p)) == jcli._read_smiles_lines(str(p))


def test_sample_commands(ckpts, capsys):
    _, plain, _ = ckpts
    cfg, state, charset = cli._restore(get_preset("chemvae_5k"), plain)
    from molvax_torch.latent import sample_prior

    lines, err = run(capsys, ["sample", "--ckpt", plain, "-n", "3"])
    assert lines == sample_prior(state.params, cfg.model, 3, torch.Generator().manual_seed(0), charset=charset)
    assert "[molvax] restored config from" in err and "[molvax] using best-checkpoint selection dir" in err
    assert "# grammar-valid: " in err and "# chem-valid" not in err
    lines, _ = run(capsys, ["sample", "--ckpt", plain, "-n", "4", "--stochastic", "--temperature", "0.7",
                            "--seed", "3"])
    assert len(lines) == 4
    lines, _ = run(capsys, ["sample", "--ckpt", plain, "-n", "3", "--aggregate"])
    assert len(lines) == 3
    lines, err = run(capsys, ["sample", "--ckpt", plain, "-n", "4", "--constrained", "--stochastic"])
    assert len(lines) == 4 and "# chem-valid: 100.00% (valence-constrained decode)" in err


@pytest.mark.parametrize("beam", [1, 3])
def test_reconstruct_matches_the_reference(ckpts, capsys, beam):
    _, plain, _ = ckpts
    jcfg, params, jcs = reference_weights(plain)
    argv = ["reconstruct", "--ckpt", plain] + (["--beam", str(beam), "--constrained"] if beam > 1 else []) + SMILES
    lines, _ = run(capsys, argv)
    if beam > 1:
        want = jlatent.beam_reconstruct(params, jcfg.model, SMILES, beam=beam, charset=jcs, constrained=True)
    else:
        want = jlatent.reconstruct(params, jcfg.model, SMILES, jax.random.key(0), charset=jcs)
    assert lines == [f"{s}\t{r}" for s, r in zip(SMILES, want)]


@pytest.mark.parametrize("constrained", [False, True])
def test_interpolate_matches_the_reference(ckpts, capsys, constrained):
    _, plain, _ = ckpts
    jcfg, params, jcs = reference_weights(plain)
    lines, _ = run(capsys, ["interpolate", "--ckpt", plain, "CCO", "c1ccccc1", "-n", "5"]
                   + (["--constrained"] if constrained else []))
    want = jlatent.interpolate(params, jcfg.model, "CCO", "c1ccccc1", steps=5, key=jax.random.key(0),
                               charset=jcs, constrained=constrained)
    assert lines == list(want)


def test_encode_and_decode_match_the_reference(ckpts, capsys, tmp_path):
    """encode --in --out writes the reference's .npz (a SMILES past max_len
    skipped with a note); decode of it, greedy and beam, equals the
    reference's decode of the same latents, and greedy equals reconstruct."""
    _, plain, _ = ckpts
    jcfg, params, jcs = reference_weights(plain)
    src = tmp_path / "in.smi"
    src.write_text("smiles\n" + "\n".join(SMILES[:3]) + "\n" + "C" * 40 + " too_long\n")
    out = str(tmp_path / "lat.npz")
    lines, err = run(capsys, ["encode", "--ckpt", plain, "--in", str(src), "--out", out, "--batch", "2"] + SMILES[3:])
    assert lines == [] and "[molvax] skipped 1 SMILES longer than max_len=32" in err
    assert f"wrote {out}: mu/logvar (5, 12)" in err
    with np.load(out, allow_pickle=True) as f:
        assert list(f["smiles"]) == SMILES
        mu = f["mu"]
        ref_mu, ref_lv = jlatent.encode_corpus(params, jcfg.model, SMILES, charset=jcs, batch=2)
        np.testing.assert_allclose(mu, ref_mu, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(f["logvar"], ref_lv, rtol=TOL, atol=TOL)
    rows, _ = run(capsys, ["encode", "--ckpt", plain] + SMILES[:2])
    np.testing.assert_allclose(np.array([[float(v) for v in r.split(",")] for r in rows]), mu[:2], rtol=1e-5,
                               atol=1e-5)
    recon, _ = run(capsys, ["reconstruct", "--ckpt", plain] + SMILES)
    for beam in (1, 3):
        lines, err = run(capsys, ["decode", "--ckpt", plain, "--in", out, "--beam", str(beam)])
        want = jlatent.decode_latents(params, jcfg.model, mu, jax.random.key(0), charset=jcs, beam=beam)
        assert lines == list(want) and "# grammar-valid: " in err
        if beam == 1:
            assert lines == [r.split("\t")[1] for r in recon]
    np.save(tmp_path / "z.npy", mu)
    assert run(capsys, ["decode", "--ckpt", plain, "--in", str(tmp_path / "z.npy")])[0] == [
        r.split("\t")[1] for r in recon]
    np.savez(tmp_path / "bad.npz", w=mu)
    with pytest.raises(SystemExit, match="expected a 'z' or 'mu' array"):
        cli.main(["decode", "--ckpt", plain, "--in", str(tmp_path / "bad.npz")])


def test_evaluate_command(ckpts, capsys):
    _, plain, _ = ckpts
    lines, _ = run(capsys, ["evaluate", "--ckpt", plain, "--holdout", "--beam", "3", "--n-prior", "8",
                            "--override", "data.n_synthetic=64", "--override", "data.test_fraction=0.25"])
    report = json.loads(lines[0])
    assert list(report) == sorted(report) and all(v == round(v, 5) for v in report.values())
    check_report(report, beam=3)


def test_optimize_command(ckpts, capsys):
    _, _, prop = ckpts
    lines, _ = run(capsys, ["optimize", "--ckpt", prop, "--constrained", "--steps", "5"] + SMILES[:3])
    assert len(lines) == 3
    for s, line in zip(SMILES, lines):
        s_in, s_out, lift = line.split("\t")
        assert s_in == s and "->" in lift
        from molvax_torch.data import chem_valid

        assert chem_valid(s_out)
    lines, _ = run(capsys, ["optimize", "--ckpt", prop, "--minimize", "--property", "2", "--steps", "3", "CCO"])
    o0, o1 = (float(v) for v in lines[0].split("\t")[2].split("->"))
    assert o1 < o0


def test_export_data_command(capsys, tmp_path, monkeypatch):
    argv = ["export-data", "--properties"] + _with("data.n_synthetic=40", "data.source=synthetic_chem",
                                                  "data.max_len=32")
    lines, _ = run(capsys, argv + ["--out", str(tmp_path / "port.h5")])
    monkeypatch.delenv("MOLVAX_PLATFORM")
    assert jcli.main(argv + ["--out", str(tmp_path / "ref.h5")]) == 0
    want = capsys.readouterr().out.splitlines()
    assert lines == [w.replace("ref.h5", "port.h5") for w in want]
    assert lines[0].endswith(": 40 molecules, charset 37, properties 3")


def test_restore_serves_the_ema_of_best_and_falls_back(ckpts, tmp_path):
    """best/ when the checkpoint's config selects it, else the top level;
    the top level when best/ holds no checkpoint; the EMA in either case,
    copied into the template's tensors."""
    from molvax_torch.io.checkpoint import CheckpointManager

    _, plain, _ = ckpts

    def served(directory, args=None):
        _, state, _ = cli._restore(get_preset("chemvae_5k"), directory, args)
        assert state.ema_params is None
        return {n: p.detach() for n, p in state.params.named_parameters()}

    def ema_of(directory):
        mgr = CheckpointManager(directory)
        payload = torch.load(os.path.join(directory, str(mgr.latest_step()), "state.pt"), weights_only=True)
        return payload["ema"]

    def same(a, b):
        return set(a) == set(b) and all(torch.equal(a[n], b[n]) for n in a)

    best, top = ema_of(os.path.join(plain, "best")), ema_of(plain)
    assert not same(best, top)  # best/ holds an earlier step's EMA
    assert same(served(plain), best)
    assert same(served(plain, argparse.Namespace(override=["train.select_best=False"])), top)
    copy = str(tmp_path / "copy")
    shutil.copytree(plain, copy)
    shutil.rmtree(os.path.join(copy, "best"))
    os.makedirs(os.path.join(copy, "best"))
    assert same(served(copy), top)


def test_refusals(ckpts, tmp_path):
    _, plain, prop = ckpts
    missing = str(tmp_path / "missing" / "dir")
    with pytest.raises(SystemExit, match="no checkpoint found in"):
        cli.main(["sample", "--ckpt", missing, "-n", "1"])
    assert not os.path.exists(missing)  # a read-side command creates nothing
    with pytest.raises(SystemExit, match="checkpoint has no property head"):
        cli.main(["optimize", "--ckpt", plain, "CCO"])
    legacy = str(tmp_path / "legacy")
    shutil.copytree(prop, legacy)
    os.remove(os.path.join(legacy, "config.json"))
    with pytest.raises(SystemExit, match="config has no property head"):
        cli.main(["optimize", "--ckpt", legacy, "CCO"])
    with pytest.raises(SystemExit, match="no SMILES given"):
        cli.main(["encode", "--ckpt", plain])


def test_platform_selects_the_device(ckpts, monkeypatch):
    """Without MOLVAX_PLATFORM=cpu a command that builds a model runs on the
    card, and raises where there is none; an unknown platform is refused."""
    _, plain, _ = ckpts
    monkeypatch.setenv("MOLVAX_PLATFORM", "tpu")
    with pytest.raises(SystemExit, match="MOLVAX_PLATFORM='tpu'"):
        cli.main(["presets"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for platform in (None, "cuda", "gpu"):
        if platform is None:
            monkeypatch.delenv("MOLVAX_PLATFORM")
        else:
            monkeypatch.setenv("MOLVAX_PLATFORM", platform)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["sample", "--ckpt", plain, "-n", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train", "--steps", "1"] + TINY)
    assert cli.main(["presets"]) == 0  # builds no model


def test_module_entry_point_imports_no_jax(ckpts):
    """``python3 -m molvax_torch.cli sample`` in a child process: 4 SMILES,
    exit 0, and no module of JAX or of the reference among its imports."""
    _, plain, _ = ckpts
    env = dict(os.environ, PYTHONPATH=str(ROOT), MOLVAX_PLATFORM="cpu")
    out = subprocess.run([sys.executable, "-X", "importtime", "-m", "molvax_torch.cli", "sample", "--ckpt", plain,
                          "-n", "4"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert len(out.stdout.splitlines()) == 4
    imported = [line.rsplit("|", 1)[-1].strip() for line in out.stderr.splitlines() if line.startswith("import time:")]
    assert "molvax_torch.config" in imported  # the -m module itself runs as __main__
    bad = [m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "molvax")]
    assert not bad, bad
