"""The port's ``train()`` on the CPU: against ``molvax.train.train`` on a
small fp32 config (the one test here that runs JAX), resume bit for bit
after a ``max_steps`` split with ``select_best`` and ``best/``, chunked and
unchunked logging, the posterior-collapse guard, the ADVICE r5 faults of
the reference in their intended behaviour, and the card by default."""

import copy
import dataclasses
import json
import os
import signal

import pytest
import torch

from molvax import train as jtrain
from molvax.config import Config as JConfig
from molvax.config import DataConfig as JData
from molvax.config import KLScheduleConfig as JKL
from molvax.config import ModelConfig as JModel
from molvax.config import TrainConfig as JTrain
from molvax.data import synthetic_dataset as j_synthetic_dataset
from molvax_torch import config as tconfig
from molvax_torch.data import BatchIterator, synthetic_dataset
from molvax_torch.io import checkpoint as ckpt
from molvax_torch.io.convert import state_dict_from_jax
from molvax_torch.train import PosteriorCollapseError, ema_eval_state, make_eval_step, train
from molvax_torch.train import loop as tloop
from test_torch_support import numpy_tree

T = 32
SMALL = dict(max_len=T, charset_size=37, latent_dim=8, conv_kernels=(5, 5, 5), enc_hidden=16, gru_hidden=12,
             gru_layers=2, learned_start=True)
# fp32 on both sides: the tolerances of tests/test_torch_train_chunk.py
LOSS_REL = 2e-4


def _cfg(**train) -> tconfig.Config:
    """A small bf16 config on the kernel route (the plain versions on the
    CPU), with a chunk of 4, a KL cycle and a warm-up."""
    base = dict(batch_size=8, train_chunk_size=4, log_every=2, learning_rate=1e-2,
                kl=tconfig.KLScheduleConfig(kind="cyclical", cycle_steps=6, ratio=0.5))
    base.update(train)
    model = dict(SMALL, compute_dtype="bfloat16", use_pallas=True, use_pallas_generation=True)
    return tconfig.Config(model=tconfig.ModelConfig(**model), train=tconfig.TrainConfig(**base),
                          data=tconfig.DataConfig(max_len=T, test_fraction=0.1))


def _data(n: int = 160):
    return synthetic_dataset(n, max_len=T, seed=0)


def _strip(rows):
    return [{k: v for k, v in r.items() if k != "wall_s"} for r in rows]


def _payload(directory, step):
    return torch.load(os.path.join(directory, str(step), ckpt.STATE_FILE), weights_only=True)


def _assert_payloads_equal(a, b, parts=("params", "adam", "ema"), counters=("step", "base_seed", "count")):
    for k in counters:
        assert a[k] == b[k], k

    def walk(x, y, where):
        if isinstance(x, dict):
            assert isinstance(y, dict) and sorted(x) == sorted(y), where
            for k in x:
                walk(x[k], y[k], f"{where}.{k}")
        elif x is None:
            assert y is None, where
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), where

    for part in parts:
        walk(a[part], b[part], part)


# -- against the reference -------------------------------------------------------


def test_train_tracks_the_reference_train(monkeypatch):
    """The slice as a whole: an fp32 config at eps_scale = 0 (z = mu), no
    scheduled sampling or word dropout, a chunk of 4 and max_steps=10 (a
    tail of 2 single steps), an eval cadence of 4 with the round-trip
    probe; the port starts from the reference's init_state weights
    (``init_state`` patched to load them through io/convert). Every logged
    row (train and eval_) within 2e-4 relative, the final weights within
    1e-2 of their tensor's largest weight."""
    model = dict(SMALL, eps_scale=0.0)
    train_kw = dict(batch_size=8, train_chunk_size=4, log_every=2, eval_every=4, eval_batches=2, eval_roundtrip_n=8,
                    learning_rate=1e-3, seed=3)
    kl = dict(kind="linear", warmup_steps=6, beta_max=1.0)
    jcfg = JConfig(model=JModel(**model), train=JTrain(kl=JKL(**kl), **train_kw), data=JData(max_len=T, test_fraction=0.1))
    tcfg = tconfig.Config(model=tconfig.ModelConfig(**model),
                          train=tconfig.TrainConfig(kl=tconfig.KLScheduleConfig(**kl), **train_kw),
                          data=tconfig.DataConfig(max_len=T, test_fraction=0.1))
    weights = state_dict_from_jax(numpy_tree(jtrain.init_state(jcfg).params))
    real_init = tloop.init_state
    monkeypatch.setattr(tloop, "init_state", lambda cfg, device=None: real_init(cfg, device=device, weights=weights))
    jstate, jhist = jtrain.train(jcfg, j_synthetic_dataset(160, max_len=T, seed=0), max_steps=10, verbose=False)
    tstate, thist = train(tcfg, _data(), device="cpu", max_steps=10, verbose=False)
    assert [r["step"] for r in thist] == [r["step"] for r in jhist] == [2, 4, 4, 6, 8, 8, 10]
    for jr, tr in zip(jhist, thist):
        assert sorted(jr) == sorted(tr)
        for k in jr:
            if k in ("step", "wall_s"):
                continue
            assert abs(tr[k] - jr[k]) <= LOSS_REL * max(abs(jr[k]), 1.0), (tr["step"], k, tr[k], jr[k])
    assert any("eval_recon_char_acc_nonpad" in r for r in thist)
    assert tstate.step == 10
    final = state_dict_from_jax(numpy_tree(jstate.params))
    for name, p in tstate.params.state_dict().items():
        gap = (p - final[name]).abs().max().item()
        assert gap <= 1e-2 * max(final[name].abs().max().item(), 1e-2), (name, gap)


# -- the loop's own behaviour ------------------------------------------------------


def test_resume_after_a_split_is_bit_for_bit(tmp_path):
    """Run U straight to 14 steps (3 chunks of 4 and a tail of 2); run S
    stops at max_steps=8, a chunk boundary, and a fresh train() resumes
    it. (A split inside U's chunk would move S's later chunk boundaries,
    and with them where the cadence actions fire.) S's final checkpoint
    (weights, Adam moments and steps, count, step, base seed, EMA), its
    history after the split, best/'s weights, EMA and step, and
    best/probe.json equal U's; both return the selected iterate."""
    def cfg_in(name):
        return _cfg(steps=14, eval_every=4, eval_batches=2, eval_roundtrip_n=8, select_best=True,
                    checkpoint_every=4, ema_decay=0.9, checkpoint_dir=str(tmp_path / name))

    u_cfg, s_cfg = cfg_in("U"), cfg_in("S")
    u_state, u_hist = train(u_cfg, _data(), device="cpu", verbose=False)
    s1_state, s1_hist = train(s_cfg, _data(), device="cpu", max_steps=8, verbose=False)
    assert s1_state.step <= 8 and _payload(s_cfg.train.checkpoint_dir, 8)["step"] == 8
    s_state, s_hist = train(s_cfg, _data(), device="cpu", verbose=False)
    _assert_payloads_equal(_payload(u_cfg.train.checkpoint_dir, 14), _payload(s_cfg.train.checkpoint_dir, 14))
    assert _strip(s_hist) == _strip([r for r in u_hist if r["step"] > 8])
    assert _strip(s1_hist) == _strip([r for r in u_hist if r["step"] <= 8])
    probes = [json.load(open(os.path.join(c.train.checkpoint_dir, "best", "probe.json"))) for c in (u_cfg, s_cfg)]
    assert probes[0] == probes[1]
    best = probes[0]["step"]
    _assert_payloads_equal(*(_payload(os.path.join(c.train.checkpoint_dir, "best"), best) for c in (u_cfg, s_cfg)),
                           parts=("params", "ema"), counters=("step", "base_seed"))
    assert u_state.step == s_state.step == best
    for (name, p), q in zip(u_state.params.named_parameters(), s_state.params.parameters()):
        assert torch.equal(p, q), name
    for c in (u_cfg, s_cfg):
        d = c.train.checkpoint_dir
        assert json.load(open(os.path.join(d, "charset.json")))[0] == " "
        assert tconfig.from_dict(json.load(open(os.path.join(d, "config.json")))) == c


@pytest.mark.parametrize("log_every", [1, 3])
def test_chunked_and_unchunked_runs_log_the_same_steps(log_every):
    """A chunk of 4 and single steps log the same steps (every log_every-th
    and the last) with the same values, bit for bit (on the CPU the chunk
    is 4 eager steps through the same body); the tail runs single steps."""
    rows = {}
    for k in (1, 4):
        state, hist = train(_cfg(train_chunk_size=k, log_every=log_every, ema_decay=0.5), _data(), device="cpu",
                            max_steps=10, verbose=False)
        assert state.step == 10
        rows[k] = _strip(hist)
    assert [r["step"] for r in rows[4]] == [s for s in range(1, 11) if s % log_every == 0 or s == 10]
    assert rows[1] == rows[4]


@pytest.mark.parametrize("case", ["abort_under_the_chunk", "warn_only", "off_by_default"])
def test_collapse_guard(tmp_path, capsys, case):
    """A floor above any post_std_batch: with collapse_abort the run
    checkpoints at the host step (the chunk's end, not the detection step
    inside it) and raises, with its signal handlers restored; warn-only
    warns once and finishes; the default floor 0 never fires."""
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    guard = dict(collapse_std_floor=1e9, collapse_guard_after=2, log_every=1)
    if case == "abort_under_the_chunk":
        cfg = _cfg(**guard, checkpoint_dir=str(tmp_path))
        with pytest.raises(PosteriorCollapseError, match="at step 2: .* checkpointed at step 4"):
            train(cfg, _data(), device="cpu", max_steps=10, verbose=False)
        assert ckpt.make_manager(str(tmp_path)).all_steps() == [4]
        assert _payload(str(tmp_path), 4)["step"] == 4
        assert {s: signal.getsignal(s) for s in old} == old
    elif case == "warn_only":
        state, hist = train(_cfg(**guard, collapse_abort=False), _data(), device="cpu", max_steps=10, verbose=False)
        assert state.step == 10 and len(hist) == 10
        assert capsys.readouterr().err.count("posterior collapse detected at step 2") == 1
    else:
        assert tconfig.TrainConfig().collapse_std_floor == 0.0
        state, _ = train(_cfg(collapse_guard_after=0, log_every=1), _data(), device="cpu", max_steps=6, verbose=False)
        assert state.step == 6 and "posterior collapse" not in capsys.readouterr().err


@pytest.mark.parametrize("fault", ["eval_reads_the_ema", "roundtrip_without_cadence_warns",
                                   "ema_off_over_an_ema_checkpoint"])
def test_advice_r5_faults_behave_as_intended(tmp_path, capsys, fault):
    """The reference's three ADVICE r5 faults, as the port behaves instead:
    the cadence eval's teacher-forced metrics read the EMA weights, as the
    probe does (one row, one set of weights); eval_roundtrip_n > 0 without
    a working eval cadence warns; a run with EMA off resumes from an EMA
    checkpoint (the reference's restore crashes there)."""
    if fault == "eval_reads_the_ema":
        cfg = _cfg(eval_every=4, eval_batches=2, ema_decay=0.5, train_chunk_size=1)
        state, hist = train(cfg, _data(), device="cpu", max_steps=4, verbose=False)
        row = [r for r in hist if "eval_loss" in r][-1]
        _, held_out = _data().split(cfg.data.test_fraction, cfg.data.seed)
        it = BatchIterator(held_out, cfg.train.batch_size, seed=cfg.train.seed + 1, device="cpu")
        batches = [next(it) for _ in range(2)]
        eval_step = make_eval_step(cfg)

        def mean_loss(st):
            return torch.stack([eval_step(st, c, p)["loss"] for c, p in batches]).mean().item()

        assert row["eval_loss"] == mean_loss(ema_eval_state(state))
        assert row["eval_loss"] != mean_loss(state)
    elif fault == "roundtrip_without_cadence_warns":
        train(_cfg(eval_roundtrip_n=8), _data(), device="cpu", max_steps=2, verbose=False)
        assert "eval_roundtrip_n > 0 needs eval_every > 0" in capsys.readouterr().err
        train(_cfg(eval_roundtrip_n=8, eval_every=2, eval_batches=1), _data(), device="cpu", max_steps=2,
              verbose=False)
        assert "eval_roundtrip_n > 0 needs" not in capsys.readouterr().err
    else:
        d = str(tmp_path)
        train(_cfg(ema_decay=0.9, checkpoint_dir=d), _data(), device="cpu", max_steps=4, verbose=False)
        state, _ = train(_cfg(checkpoint_dir=d), _data(), device="cpu", max_steps=8, verbose=False)
        assert state.step == 8 and state.ema_params is None
        assert _payload(d, 8)["ema"] is None and _payload(d, 4)["ema"] is not None


def test_train_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(_cfg(), _data(), max_steps=1, verbose=False)


def test_cadence_crossed():
    assert tloop._cadence_crossed(4, 0, 4) and tloop._cadence_crossed(4, 3, 4)
    assert not tloop._cadence_crossed(4, 4, 7) and tloop._cadence_crossed(4, 4, 8)
    assert tloop._cadence_crossed(2, 0, 16)  # once per chunk, not per window
    assert not tloop._cadence_crossed(0, 0, 16)


def test_a_standing_best_is_returned_or_skipped_when_incompatible(tmp_path, capsys):
    """A rerun that does not beat best/ returns best/'s weights; a best/ of
    another architecture is reported and the final state returned."""
    d = str(tmp_path)
    cfg = _cfg(eval_every=2, eval_batches=1, eval_roundtrip_n=8, select_best=True, checkpoint_dir=d)
    first, _ = train(cfg, _data(), device="cpu", max_steps=4, verbose=False)
    meta = os.path.join(d, "best", "probe.json")
    with open(meta) as f:
        probe = json.load(f)
    with open(meta, "w") as f:
        json.dump({"step": probe["step"], "metric": 2.0}, f)  # no probe can beat it
    again, _ = train(cfg, _data(), device="cpu", max_steps=6, verbose=False)
    assert "stands; this run did not beat it" in capsys.readouterr().err
    assert again.step == probe["step"]
    for (name, p), q in zip(again.params.named_parameters(), first.params.parameters()):
        assert torch.equal(p, q), name
    wide = copy.deepcopy(cfg)
    wide = dataclasses.replace(wide, model=dataclasses.replace(wide.model, gru_hidden=16),
                               train=dataclasses.replace(wide.train, checkpoint_dir=str(tmp_path / "w")))
    os.makedirs(tmp_path / "w")
    os.symlink(os.path.join(d, "best"), tmp_path / "w" / "best")
    final, _ = train(wide, _data(), device="cpu", max_steps=2, verbose=False)
    assert "standing best/ is incompatible" in capsys.readouterr().err
    assert final.step == 2
