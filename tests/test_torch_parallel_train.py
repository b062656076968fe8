"""``train()`` under a data-parallel mesh on the CPU (gloo ranks), the
counterpart of the reference's ``train(mesh=)`` (``molvax/train/loop.py``):
the mesh choice and its warning against the reference's text, a 2-rank run
against the 1-process run, resume after a ``max_steps`` split bit for bit
(with the eval cadence, the round-trip probe, ``select_best`` and the EMA),
the first rank alone writing files, and a stop (SIGTERM on one rank, the
collapse guard) taken by every rank at the same step. JAX is imported only
inside the tests that compare against it: the ranks import this module."""

import contextlib
import dataclasses
import io
import json
import os
import signal

import pytest
import torch

from molvax_torch import config as tconfig
from molvax_torch.data import synthetic_dataset
from molvax_torch.io import checkpoint as ckpt
from molvax_torch.parallel import make_mesh
from molvax_torch.train import PosteriorCollapseError, loop as tloop, train
from test_torch_parallel import assert_payload_close, payload, run_ranks

T = 32
WORLD = 2
SPLIT, TOTAL = 4, 10


def _cfg(directory=None, **train_kw) -> tconfig.Config:
    """A small fp32 config with every part of the loop on: a chunk of 2,
    eval and the round-trip probe every 4 steps, select_best, the EMA,
    word dropout, checkpoints every 4."""
    base = dict(batch_size=8, train_chunk_size=2, log_every=1, learning_rate=1e-2, eval_every=4, eval_batches=1,
                eval_roundtrip_n=6, select_best=True, checkpoint_every=4, ema_decay=0.9, word_dropout=0.1,
                checkpoint_dir=None if directory is None else str(directory))
    base.update(train_kw)
    model = tconfig.ModelConfig(max_len=T, charset_size=37, latent_dim=8, conv_kernels=(5, 5, 5), enc_hidden=16,
                                gru_hidden=12, gru_layers=2, learned_start=True)
    return tconfig.Config(model=model, train=tconfig.TrainConfig(**base),
                          data=tconfig.DataConfig(max_len=T, test_fraction=0.1))


def _data():
    return synthetic_dataset(160, max_len=T, seed=0)


def _strip(rows):
    return [{k: v for k, v in r.items() if k != "wall_s"} for r in rows]


def _mesh_warning(stderr: str) -> list:
    return [line for line in stderr.splitlines() if line.startswith("[molvax] configured mesh")]


def _train_worker(rank: int, world: int, root: str) -> dict:
    out = {"saves": 0}
    real_save = ckpt.CheckpointManager._save

    def counted(self, *a, **kw):
        out["saves"] += 1
        return real_save(self, *a, **kw)

    ckpt.CheckpointManager._save = counted
    mesh = make_mesh(device="cpu")
    ds = _data()

    def run(name, max_steps, **kw):
        cfg = _cfg(os.path.join(root, name), **kw)
        return train(cfg, ds, device="cpu", metrics_path=os.path.join(root, f"{name}_rank{rank}.jsonl"),
                     max_steps=max_steps, verbose=False, mesh=mesh)

    state, out["U"] = run("U", TOTAL)
    out["U_state"] = payload(state)
    run("S", SPLIT)
    state, out["S"] = run("S", TOTAL)
    out["S_state"] = payload(state)

    # SIGTERM on rank 1 alone, during its third step: every rank stops there
    real_step = tloop.make_train_step

    def signalling(cfg, mesh=None):
        step = real_step(cfg, mesh)

        def run_step(*a):
            run_step.calls += 1
            if rank == 1 and run_step.calls == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return step(*a)

        run_step.calls, run_step.grad_mean = 0, step.grad_mean
        return run_step

    tloop.make_train_step = signalling
    state, _ = run("stop", TOTAL, train_chunk_size=1, eval_every=0, select_best=False, eval_roundtrip_n=0)
    tloop.make_train_step = real_step
    out["stop_step"] = state.step
    try:
        run("collapse", TOTAL, collapse_std_floor=1e9, collapse_guard_after=3, eval_every=0, select_best=False,
            eval_roundtrip_n=0)
    except PosteriorCollapseError as e:
        out["collapse"] = str(e)

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        wide = tloop.choose_mesh(dataclasses.replace(_cfg(), mesh=tconfig.MeshConfig(data_axis=8)), device="cpu")
    out["choice"] = (wide.shape, wide.ranks, _mesh_warning(err.getvalue()))
    fits = tloop.choose_mesh(dataclasses.replace(_cfg(), mesh=tconfig.MeshConfig(data_axis=2)), device="cpu")
    out["fits"] = (fits.shape, fits.ranks)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_train")
    return run_ranks(root, WORLD, _train_worker, str(root / "work")), root


def _root(ranks_and_root):
    return ranks_and_root[1] / "work"


def test_two_rank_train_is_the_one_process_train(ranks):
    """The 2-rank run logs the rows of the 1-process run on the same
    global batches: the train, eval and probe metrics within 1e-4."""
    out, _ = ranks
    _, one = train(_cfg(), _data(), device="cpu", max_steps=TOTAL, verbose=False)
    for r in range(WORLD):
        got = _strip(out[r]["U"])
        assert [row["step"] for row in got] == [row["step"] for row in _strip(one)]
        for a, b in zip(got, _strip(one)):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k] == pytest.approx(b[k], rel=1e-4, abs=1e-5), (a["step"], k)
    assert _strip(out[0]["U"]) == _strip(out[1]["U"])


def test_resume_after_a_split_is_bit_for_bit(ranks):
    """Run U straight to 10 steps, run S stopped at max_steps=4 and resumed:
    the final states and checkpoints, the history after the split,
    best/ and probe.json bit for bit."""
    out, _ = ranks
    work = _root(ranks)
    for r in range(WORLD):
        assert_payload_close(out[r]["S_state"], out[r]["U_state"], exact=True)
        assert _strip(out[r]["S"]) == [row for row in _strip(out[r]["U"]) if row["step"] > SPLIT]
    load = lambda d, s: torch.load(d / str(s) / ckpt.STATE_FILE, weights_only=True)  # noqa: E731
    assert_payload_close(load(work / "S", TOTAL), load(work / "U", TOTAL), exact=True)
    best_u = ckpt.CheckpointManager(str(work / "U" / "best")).latest_step()
    assert best_u == ckpt.CheckpointManager(str(work / "S" / "best")).latest_step()
    assert_payload_close(load(work / "S" / "best", best_u), load(work / "U" / "best", best_u), exact=True)
    assert json.loads((work / "S" / "best" / "probe.json").read_text()) == \
        json.loads((work / "U" / "best" / "probe.json").read_text())


def test_rank0_alone_writes(ranks):
    out, _ = ranks
    work = _root(ranks)
    assert out[0]["saves"] > 0 and out[1]["saves"] == 0
    for name in ("U", "S"):
        assert (work / f"{name}_rank0.jsonl").exists() and not (work / f"{name}_rank1.jsonl").exists()
        assert (work / name / "charset.json").exists() and (work / name / "config.json").exists()


def test_a_stop_is_taken_by_every_rank_at_the_same_step(ranks):
    """SIGTERM reaches rank 1 alone, in its third step: both ranks end
    that step, checkpoint it and return. The collapse guard aborts every
    rank at the same logged step, with the checkpoint."""
    out, _ = ranks
    work = _root(ranks)
    assert [o["stop_step"] for o in out] == [3, 3]
    assert ckpt.CheckpointManager(str(work / "stop")).latest_step() == 3
    assert out[0]["collapse"] == out[1]["collapse"]
    assert "posterior collapse detected at step 3" in out[0]["collapse"]
    assert ckpt.CheckpointManager(str(work / "collapse")).latest_step() == 4


def test_mesh_choice_over_the_world(ranks):
    """A configured mesh the world holds is taken; one it cannot hold
    falls back to the largest power of two of ranks dividing the batch,
    with the reference's warning on the first rank only."""
    out, _ = ranks
    for r, o in enumerate(out):
        assert o["fits"] == ({"data": 2, "model": 1}, (0, 1))
        shape, used, lines = o["choice"]
        assert shape == {"data": 2, "model": 1} and used == (0, 1)
        want = ["[molvax] configured mesh 8x1 unusable here (devices=2, batch=8); using an auto 2-device data mesh"]
        assert lines == (want if r == 0 else [])


@pytest.mark.parametrize("devices", [1, 2])
def test_mesh_warning_is_the_references(devices, monkeypatch, capsys):
    """The warning text for text against ``molvax.train.train`` given the
    same number of devices (the reference's jax.devices() cut to it): the
    port's in this process (1), or the text the port prints from 2 ranks
    (above) for 2."""
    import jax

    from molvax import train as jtrain
    from molvax.config import Config as JConfig, DataConfig as JData, MeshConfig as JMesh
    from molvax.config import ModelConfig as JModel, TrainConfig as JTrain
    from molvax.data import synthetic_dataset as j_synthetic_dataset

    every = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a: every[:devices])
    jcfg = JConfig(model=JModel(max_len=T, charset_size=37, latent_dim=8, conv_kernels=(5, 5, 5), enc_hidden=16,
                                gru_hidden=12, gru_layers=2),
                   train=JTrain(batch_size=8), data=JData(max_len=T), mesh=JMesh(data_axis=8))
    jtrain.train(jcfg, j_synthetic_dataset(64, max_len=T, seed=0), max_steps=0, verbose=False)
    want = _mesh_warning(capsys.readouterr().err)
    assert len(want) == 1
    if devices == 1:
        cfg = dataclasses.replace(_cfg(), mesh=tconfig.MeshConfig(data_axis=8))
        train(cfg, _data(), device="cpu", max_steps=0, verbose=False)
        assert _mesh_warning(capsys.readouterr().err) == want
    else:
        assert want == ["[molvax] configured mesh 8x1 unusable here (devices=2, batch=8); using an auto 2-device "
                        "data mesh"]


def test_cli_train_under_torchrun(tmp_path):
    """``MOLVAX_PLATFORM=cpu torchrun --nproc_per_node=2 -m molvax_torch.cli
    train``: two gloo ranks train on the mesh train() picks, the first
    alone logs, prints and writes."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root), MOLVAX_PLATFORM="cpu", OMP_NUM_THREADS="1")
    ck = tmp_path / "ck"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2", "-m",
           "molvax_torch.cli", "train", "--preset", "chemvae_5k", "--override", "data.n_synthetic=200",
           "--override", "train.batch_size=8", "--override", f"train.checkpoint_dir={ck}", "--override",
           "train.log_every=2", "--steps", "4"]
    done = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert done.returncode == 0, done.stderr[-3000:]
    done_lines = [line for line in done.stdout.splitlines() if line.startswith("done:")]
    assert len(done_lines) == 1 and done_lines[0].startswith("done: step 4 ")
    assert len([line for line in done.stderr.splitlines() if line.startswith("[molvax] step 4:")]) == 1
    assert ckpt.CheckpointManager(str(ck)).all_steps() == [4]


@pytest.mark.parametrize("rank", [0, 1])
def test_cli_other_commands_run_on_rank0_only(rank, monkeypatch, capsys):
    from molvax_torch import cli

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", str(rank))
    assert cli.main(["presets"]) == 0
    printed = capsys.readouterr().out
    assert ("zinc250k" in printed) == (rank == 0) and (printed == "") == (rank == 1)
