"""The port's checkpoints (``molvax_torch.io.checkpoint``), on the CPU, with
no JAX: a save holds the whole train state and a restore copies it back in
place, tolerant where the reference's is, and where the reference crashes
(an EMA checkpoint restored with EMA off, ADVICE r5)."""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from molvax_torch import config as tconfig
from molvax_torch.io import checkpoint as ckpt
from molvax_torch.train import init_state, make_train_step

SMALL = dict(max_len=32, charset_size=37, latent_dim=8, conv_kernels=(5, 5, 5), enc_hidden=16, gru_hidden=12,
             gru_layers=2)


def _cfg(ema: float = 0.9, **model) -> tconfig.Config:
    return tconfig.Config(model=tconfig.ModelConfig(**{**SMALL, **model}),
                          train=tconfig.TrainConfig(batch_size=8, ema_decay=ema, learning_rate=1e-2))


def _trained(cfg, steps: int = 3, seed: int = 0):
    """A state after ``steps`` steps on seeded batches (moments, counts and
    EMA all away from their fresh values)."""
    state = init_state(cfg, seed=seed, device="cpu")
    step = make_train_step(cfg)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        codes = torch.from_numpy(rng.integers(0, cfg.model.charset_size, (8, cfg.model.max_len)).astype(np.uint8))
        state, _ = step(state, codes)
    return state


def _assert_restored(got, want):
    """Weights, every Adam state tensor (moments and step), EMA, count,
    step and base seed, bit for bit."""
    for (name, p), q in zip(got.params.named_parameters(), want.params.parameters()):
        assert torch.equal(p, q), name
        sa, sb = got.opt_state.adam.state[p], want.opt_state.adam.state[q]
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), (name, k)
    assert (got.ema_params is None) == (want.ema_params is None)
    for name in want.ema_params or {}:
        assert torch.equal(got.ema_params[name], want.ema_params[name]), name
    assert (got.step, got.base_seed, got.opt_state.count) == (want.step, want.base_seed, want.opt_state.count)


def test_round_trip_is_bit_for_bit(tmp_path):
    cfg = _cfg()
    state = _trained(cfg)
    assert state.opt_state.adam.state[next(state.params.parameters())]["step"].item() == 3.0
    mgr = ckpt.make_manager(str(tmp_path), keep=3)
    assert mgr.save(3, state)
    assert mgr.latest_step() == 3 and os.path.isfile(tmp_path / "3" / ckpt.STATE_FILE)
    payload = torch.load(tmp_path / "3" / ckpt.STATE_FILE, weights_only=True)
    assert payload["count"] == 3 and payload["step"] == 3 and payload["base_seed"] == state.base_seed
    assert all(t.device.type == "cpu" for t in payload["params"].values())
    restored = mgr.restore_latest(init_state(cfg, seed=5, device="cpu"))
    _assert_restored(restored, state)
    # a restored state steps exactly as the saved one does
    step = make_train_step(cfg)
    codes = torch.from_numpy(np.random.default_rng(9).integers(0, 37, (8, 32)).astype(np.uint8))
    a, ma = step(copy.deepcopy(state), codes)
    b, mb = step(restored, codes)
    _assert_restored(b, a)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def test_keep_limit_and_empty_directory(tmp_path):
    cfg = _cfg(ema=0.0)
    state = init_state(cfg, seed=0, device="cpu")
    mgr = ckpt.make_manager(str(tmp_path / "ck"), keep=2)
    assert mgr.latest_step() is None and mgr.all_steps() == []
    assert mgr.restore_latest(init_state(cfg, seed=0, device="cpu")) is None
    for s in (1, 2, 3, 4, 5):
        assert mgr.save(s, state._replace(step=s))
    assert mgr.all_steps() == [4, 5]
    assert sorted(os.listdir(tmp_path / "ck")) == ["4", "5"]
    assert not mgr.save(5, state) and not mgr.save(3, state)  # at or below the latest: skipped
    assert mgr.all_steps() == [4, 5]
    with pytest.raises(ValueError, match="keep"):
        ckpt.make_manager(str(tmp_path / "other"), keep=0)


def test_partial_directories_are_ignored(tmp_path):
    cfg = _cfg(ema=0.0)
    state = _trained(cfg, steps=1)
    mgr = ckpt.make_manager(str(tmp_path), keep=3)
    mgr.save(4, state._replace(step=4))
    os.makedirs(tmp_path / "9.tmp")
    (tmp_path / "9.tmp" / ckpt.STATE_FILE).write_bytes(b"half a file")
    os.makedirs(tmp_path / "8")  # a step directory whose file never landed
    os.makedirs(tmp_path / "best")
    assert mgr.latest_step() == 4 and mgr.all_steps() == [4]
    assert mgr.restore_latest(init_state(cfg, seed=1, device="cpu")).step == 4
    mgr.save(9, state._replace(step=9))  # a save over a stale partial one
    assert mgr.all_steps() == [4, 9] and not os.path.exists(tmp_path / "9.tmp")


def test_added_start_token_keeps_its_fresh_init(tmp_path):
    old = _cfg(learned_start=False)
    state = _trained(old)
    mgr = ckpt.make_manager(str(tmp_path))
    mgr.save(3, state)
    new = _cfg(learned_start=True)
    template = init_state(new, seed=7, device="cpu")
    fresh = template.params.start_token.detach().clone()
    restored = mgr.restore_latest(template)
    assert torch.equal(restored.params.start_token, fresh)
    assert restored.opt_state.adam.state[restored.params.start_token]["step"].item() == 0.0
    assert torch.equal(restored.ema_params["start_token"], fresh)
    for name, p in state.params.named_parameters():
        assert torch.equal(dict(restored.params.named_parameters())[name], p), name
        assert torch.equal(restored.ema_params[name], state.ema_params[name]), name
    assert restored.step == 3 and restored.opt_state.count == 3


@pytest.mark.parametrize("kind", ["shape", "dtype"])
def test_mismatched_tensors_raise_before_anything_is_copied(tmp_path, kind):
    cfg = _cfg()
    mgr = ckpt.make_manager(str(tmp_path))
    if kind == "shape":
        mgr.save(3, _trained(_cfg(gru_hidden=16)))
        match = "shape"
    else:
        mgr.save(3, _trained(cfg))
        path = tmp_path / "3" / ckpt.STATE_FILE
        payload = torch.load(path, weights_only=True)
        payload["adam"]["linear_4.weight"]["exp_avg"] = payload["adam"]["linear_4.weight"]["exp_avg"].double()
        torch.save(payload, path)
        match = "dtype"
    template = init_state(cfg, seed=1, device="cpu")
    before = {n: p.detach().clone() for n, p in template.params.named_parameters()}
    with pytest.raises(ValueError, match=match):
        mgr.restore_latest(template)
    for n, p in template.params.named_parameters():
        assert torch.equal(p, before[n]), n
    assert template.opt_state.count == 0


@pytest.mark.parametrize("direction", ["ema_turned_on", "ema_turned_off"])
def test_ema_switched_between_save_and_restore(tmp_path, direction):
    """EMA on over a pre-EMA checkpoint: the EMA is seeded from the restored
    weights (not the template's random init). EMA off over an EMA
    checkpoint: the rest restores and the saved EMA is dropped (the
    reference crashes there, ADVICE r5)."""
    saved_ema, now_ema = (0.0, 0.9) if direction == "ema_turned_on" else (0.9, 0.0)
    state = _trained(_cfg(ema=saved_ema))
    mgr = ckpt.make_manager(str(tmp_path))
    mgr.save(3, state)
    restored = mgr.restore_latest(init_state(_cfg(ema=now_ema), seed=4, device="cpu"))
    for (name, p), q in zip(restored.params.named_parameters(), state.params.parameters()):
        assert torch.equal(p, q), name
    if now_ema:
        assert restored.ema_params is not None
        for name, p in restored.params.named_parameters():
            assert torch.equal(restored.ema_params[name], p), name
    else:
        assert restored.ema_params is None
    assert restored.step == 3 and restored.opt_state.count == 3


def test_restore_keeps_every_tensor_in_place_and_advances_versions(tmp_path):
    """A captured chunk (the addresses) and the persistent decode's packed
    weights (addresses and versions) depend on it: no ``p.data = ...``."""
    cfg = _cfg()
    mgr = ckpt.make_manager(str(tmp_path))
    mgr.save(3, _trained(cfg))
    template = init_state(cfg, seed=2, device="cpu")
    params = list(template.params.parameters())
    tensors = params + [t for p in params for t in template.opt_state.adam.state[p].values()]
    tensors += list(template.ema_params.values())
    ids, ptrs, versions = [id(t) for t in tensors], [t.data_ptr() for t in tensors], [t._version for t in tensors]
    restored = mgr.restore_latest(template)
    assert restored.params is template.params and restored.opt_state is template.opt_state
    after = list(restored.params.parameters())
    after = after + [t for p in after for t in restored.opt_state.adam.state[p].values()]
    after += list(restored.ema_params.values())
    assert [id(t) for t in after] == ids
    assert [t.data_ptr() for t in after] == ptrs
    assert all(t._version > v for t, v in zip(after, versions))


def test_force_overwrites_a_stale_best(tmp_path):
    """A best-iterate save may carry a smaller step than a stale best/ of an
    earlier run: without force it is skipped, with force it replaces the
    directory's checkpoints from that step on."""
    cfg = _cfg(ema=0.0)
    best = ckpt.make_manager(str(tmp_path / "best"), keep=1)
    stale, new = _trained(cfg, steps=2, seed=0), _trained(cfg, steps=2, seed=1)
    best.save(50, stale._replace(step=50))
    assert not best.save(20, new._replace(step=20))
    assert best.latest_step() == 50
    assert best.save(20, new._replace(step=20), force=True)
    assert best.all_steps() == [20] and sorted(os.listdir(tmp_path / "best")) == ["20"]
    restored = best.restore_latest(init_state(cfg, seed=3, device="cpu"))
    _assert_restored(restored, new._replace(step=20))
    assert best.save(20, stale._replace(step=20), force=True)  # the same step, replaced
    _assert_restored(best.restore_latest(init_state(cfg, seed=3, device="cpu")), stale._replace(step=20))


def test_saved_parameters_the_model_no_longer_has_are_dropped(tmp_path, capsys):
    mgr = ckpt.make_manager(str(tmp_path))
    state = _trained(_cfg(learned_start=True))
    mgr.save(3, state)
    restored = mgr.restore_latest(init_state(_cfg(learned_start=False), seed=1, device="cpu"))
    assert restored.params.start_token is None and "start_token" not in restored.ema_params
    assert "dropped ['start_token']" in capsys.readouterr().err
    assert torch.equal(restored.params.linear_4.weight, state.params.linear_4.weight)


def test_restore_state_payload_round_trip_through_dataclass_config(tmp_path):
    """A state built from a preset-shaped config (dataclasses.replace of a
    preset) restores into a template of the same config: the payload's
    names follow the model, not the config object."""
    cfg = dataclasses.replace(tconfig.get_preset("chemvae_5k"), model=dataclasses.replace(
        tconfig.get_preset("chemvae_5k").model, **SMALL))
    state = _trained(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=8)), steps=1)
    payload = ckpt.state_payload(state)
    assert sorted(payload["params"]) == sorted(n for n, _ in state.params.named_parameters())
    got = ckpt.restore_into(init_state(cfg, seed=9, device="cpu"), payload)
    _assert_restored(got, state)
