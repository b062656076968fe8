"""``molvax_torch.train.evaluate`` against ``molvax.train.evaluate`` on the
CPU, on identical weights and data (fp32, tiny widths; atol = rtol = 2e-4,
the repo's parity tolerance).

Deterministic metrics are compared value by value: teacher-forced at
``eps_scale=0``, the greedy and beam round trips, the posterior against the
prior, both variants of the optimization, the novelty reference and the
sample-quality block. The interpolation's pair indices and the aggregate
sampler's eps, which the port draws from its own generators, are handed to
the reference. Gumbel-sampled metrics cannot be handed over: their keys,
ranges and determinism are held in ``tests/test_torch_eval_keys.py``,
whose ``report_keys`` is held here to the reference's reports."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import molvax.config as jconfig
import molvax_torch.config as tconfig
from molvax.data import synthetic_dataset as j_synthetic
from molvax.train import init_state as j_init_state
from molvax_torch.data import synthetic_dataset as t_synthetic
from molvax_torch.io.convert import state_dict_from_jax
from molvax_torch.train import init_state as t_init_state
from test_torch_eval_keys import report_keys, tiny
from test_torch_support import numpy_tree

jev = importlib.import_module("molvax.train.evaluate")  # the package's name is the function's
tev = importlib.import_module("molvax_torch.train.evaluate")
jsample = importlib.import_module("molvax.latent.sample")
tsample = importlib.import_module("molvax_torch.latent.sample")
TOL = 2e-4


def _close(got: dict, want: dict, tol=TOL):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=tol, atol=tol, err_msg=k)


def paired_state(tcfg, seed: int = 0, ema_seed=None):
    """(reference cfg, reference state, port state) with identical weights
    (and identical EMA weights, from ``ema_seed``'s init, where given)."""
    jcfg = jconfig.from_dict(tconfig.to_dict(tcfg))
    jstate = j_init_state(jcfg, jax.random.key(seed))
    tstate = t_init_state(tcfg, device="cpu", weights=state_dict_from_jax(numpy_tree(jstate.params)))
    if ema_seed is not None:
        ema = j_init_state(jcfg, jax.random.key(ema_seed)).params
        jstate = jstate._replace(ema_params=ema)
        tstate = tstate._replace(ema_params=state_dict_from_jax(numpy_tree(ema)))
    return jcfg, jstate, tstate


def with_model(tcfg, **kw):
    return dataclasses.replace(tcfg, model=dataclasses.replace(tcfg.model, **kw))


# one plain and one property config for every test, so that the reference
# compiles each of its programs once in this file (its cfg is a static
# argument); the property config's target stats are the corpus's, which is
# what evaluate() backfills into a cfg without stats
PLAIN = with_model(tiny(), eps_scale=0.0, learned_start=True)
PROP_NO_STATS = with_model(tiny(3), eps_scale=0.0, learned_start=True, property_mean=None, property_std=None)


@pytest.fixture(scope="module")
def data():
    """The same chem corpus with computed targets from both packages."""
    jds = j_synthetic(24, max_len=20, seed=0, chem=True, with_properties=True)
    tds = t_synthetic(24, max_len=20, seed=0, chem=True, with_properties=True)
    np.testing.assert_array_equal(jds.codes, tds.codes)
    np.testing.assert_array_equal(jds.properties, tds.properties)
    return jds, tds


@pytest.fixture(scope="module")
def prop_cfg(data):
    from molvax_torch.train import effective_config

    return effective_config(PROP_NO_STATS, data[1])


@pytest.mark.parametrize("props", [False, True])
def test_teacher_forced_metrics_match_reference(data, prop_cfg, props):
    """At eps_scale=0 (the noise streams differ by design), over 8 batches
    at the reference's offsets, wrapping the 24-row corpus; with the
    property head, prop_mse against the corpus's targets."""
    jds, tds = data
    tcfg = prop_cfg if props else PLAIN
    jcfg, jstate, tstate = paired_state(tcfg, seed=1)
    got = tev.teacher_forced_metrics(tstate, tcfg, tds)
    _close(got, jev.teacher_forced_metrics(jstate, jcfg, jds))
    assert ("prop_mse" in got) is props


def test_deterministic_metrics_match_reference(data):
    """The greedy and beam round trips, the posterior against the prior
    (float64 on the host; with the encoder noise's term at eps_scale 0.3),
    the novelty reference."""
    jds, tds = data
    jcfg, jstate, tstate = paired_state(PLAIN, seed=2)
    jp, model = jstate.params, tstate.params
    _close(tev.reconstruction_metrics(model, PLAIN, tds, None),
           jev.reconstruction_metrics(jp, jcfg, jds, jax.random.key(0)))
    _close(tev.beam_reconstruction_metrics(model, PLAIN, tds, beam=5),
           jev.beam_reconstruction_metrics(jp, jcfg, jds, beam=5))
    for eps in (0.0, 0.3):
        tcfg = with_model(PLAIN, eps_scale=eps)
        jcfg = jconfig.from_dict(tconfig.to_dict(tcfg))
        _close(tev.posterior_prior_metrics(model, tcfg, tds, n=20), jev.posterior_prior_metrics(jp, jcfg, jds, n=20))
    assert tev.novelty_reference(tds) == jev.novelty_reference(jds)
    assert tev.novelty_reference(tds, cap=5) == jev.novelty_reference(jds, cap=5)


def test_optimization_metrics_match_reference(data, prop_cfg):
    """One optimize_z shared by both variants: opt_* greedy, opt_con_*
    under the automaton, the lift re-scored on the decoded strings."""
    jds, tds = data
    jcfg, jstate, tstate = paired_state(prop_cfg, seed=3)
    got = tev.optimization_metrics(tstate.params, prop_cfg, tds, None, variants=(False, True))
    want = jev.optimization_metrics(jstate.params, jcfg, jds, jax.random.key(2), variants=(False, True))
    _close(got, want)
    assert got["opt_con_chem_valid"] == 1.0 and got["opt_con_pairs"] == float(len(tds))
    one = tev.optimization_metrics(tstate.params, prop_cfg, tds, None, constrained=True)
    assert one == {k: v for k, v in got.items() if k.startswith("opt_con_")}


def test_interpolation_metrics_on_the_ports_pairs(data, monkeypatch):
    """The port draws its pairs with torch.randperm; the same indices,
    handed to the reference in place of jax.random.choice, give the same
    metrics."""
    jds, tds = data
    tcfg = PLAIN
    jcfg, jstate, tstate = paired_state(tcfg, seed=4)
    drawn = []
    randperm = torch.randperm

    def recording_randperm(*a, **kw):
        drawn.append(randperm(*a, **kw))
        return drawn[-1]

    monkeypatch.setattr(torch, "randperm", recording_randperm)
    got = tev.interpolation_metrics(tstate.params, tcfg, tds, torch.Generator().manual_seed(7), n_pairs=12)
    idx = drawn[0][:24].numpy()
    assert sorted(idx) == list(range(24))
    monkeypatch.setattr(jax.random, "choice", lambda key, n, shape, replace=True: jnp.asarray(idx))
    for spherical in (True, False):
        want = jev.interpolation_metrics(jstate.params, jcfg, jds, jax.random.key(0), n_pairs=12,
                                         spherical=spherical)
        if spherical:
            _close(got, want)
        else:
            drawn.clear()
            _close(tev.interpolation_metrics(tstate.params, tcfg, tds, torch.Generator().manual_seed(7), n_pairs=12,
                                             spherical=False), want)
    with pytest.raises(ValueError, match="needs >= 2 molecules"):
        tev.interpolation_metrics(tstate.params, tcfg, dataclasses.replace(tds, codes=tds.codes[:1]), None)


def test_aggregate_generation_metrics_on_the_ports_eps(data, monkeypatch):
    """The port's eps, recorded from its torch.randn, handed to the
    reference in place of jax.random.normal, with the same fit and both
    decodes greedy (the Gumbel noise cannot be handed over): the same
    metrics."""
    jds, tds = data
    tcfg = PLAIN
    jcfg, jstate, tstate = paired_state(tcfg, seed=5)
    mean, chol = tsample.fit_aggregate_posterior(tstate.params, tcfg.model, tds.codes)
    j_fit = (jnp.asarray(mean.numpy()), jnp.asarray(chol.numpy()))
    drawn = []
    randn, normal = torch.randn, jax.random.normal
    t_generate, j_generate = tsample.generate, jsample.generate

    def recording_randn(*a, **kw):
        drawn.append(randn(*a, **kw))
        return drawn[-1]

    monkeypatch.setattr(torch, "randn", recording_randn)
    monkeypatch.setattr(tsample, "generate", lambda *a, **kw: t_generate(*a, **{**kw, "greedy": True}))
    monkeypatch.setattr(jsample, "generate", lambda *a, **kw: j_generate(*a, **{**kw, "greedy": True}))
    got = tev.aggregate_generation_metrics(tstate.params, tcfg, torch.Generator().manual_seed(1), tds, n=8,
                                           fit=(mean, chol))
    assert drawn[0].shape == (8, tcfg.model.latent_dim)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(drawn[0].numpy())
                        if tuple(shape) == (8, tcfg.model.latent_dim) else normal(key, shape, dtype))
    want = jev.aggregate_generation_metrics(jstate.params, jcfg, jax.random.key(0), jds, n=8, fit=j_fit)
    _close(got, want)


@pytest.mark.parametrize("smiles,valid,train_set", [
    (["CCO", "CCO", "CCN", "C1CC"], ["CCO", "CCO", "CCN"], None),
    (["CCO", "CCO", "CCN", "C1CC"], ["CCO", "CCO", "CCN"], {"CCO"}),
    (["C1CC", "(("], [], {"CCO"}),
    (["CCO", "c1ccccc1"], ["CCO", "c1ccccc1"], {"CCO", "c1ccccc1"}),
])
def test_sample_quality_block_matches_reference(smiles, valid, train_set):
    assert tev._sample_quality(smiles, valid, train_set) == jev._sample_quality(smiles, valid, train_set)


@pytest.fixture(scope="module")
def reports(data, prop_cfg):
    """The reference's and the port's evaluate() for three flag sets: a
    plain model with EMA weights at the defaults; a property model whose
    cfg has no target stats, with beam=5 and the temperature sweep; the
    property model at the defaults."""
    jds, tds = data
    out = {}
    cases = {
        "default": (PLAIN, dict(), 11),
        "props_beam5_sweep": (PROP_NO_STATS, dict(beam=5, sweep_temperatures=True), None),
        "props": (prop_cfg, dict(), None),
    }
    for name, (tcfg, flags, ema_seed) in cases.items():
        jcfg, jstate, tstate = paired_state(tcfg, seed=6, ema_seed=ema_seed)
        out[name] = (tcfg, flags, tstate, jev.evaluate(jstate, jcfg, jds, n_prior=8, **flags),
                     tev.evaluate(tstate, tcfg, tds, n_prior=8, **flags))
    return out


@pytest.mark.parametrize("case", ["default", "props_beam5_sweep", "props"])
def test_evaluate_keys_match_reference(reports, case):
    tcfg, flags, _, want, got = reports[case]
    keys = report_keys(n_properties=tcfg.model.n_properties, **flags)
    assert set(want) == keys, set(want) ^ keys
    assert set(got) == keys, set(got) ^ keys
    # teacher-forced, greedy round trip and posterior: no draw, the same numbers
    det = [k for k in want if k in ("loss", "elbo", "kl", "recon", "acc", "acc_nonpad", "recon_exact",
                                    "recon_char_acc", "recon_char_acc_nonpad", "recon_beam_exact",
                                    "recon_beam_char_acc_nonpad", "post_mean_norm", "post_std_mean",
                                    "post_prior_w2") or k.startswith("prop_mse")]
    _close({k: got[k] for k in det}, {k: want[k] for k in det})


def test_evaluate_scores_the_ema(reports, data):
    """With EMA weights in the state, the report is the one of a state
    whose weights are the EMA (and the reference's, above)."""
    _, tds = data
    tcfg, _, tstate, _, got = reports["default"]
    ema_only = t_init_state(tcfg, device="cpu", weights=tstate.ema_params)
    assert tev.evaluate(ema_only, tcfg, tds, n_prior=8) == got
    assert tev.teacher_forced_metrics(tstate, tcfg, tds)["loss"] != got["loss"]  # the last iterate


def test_evaluate_backfills_the_property_stats(reports, data, prop_cfg):
    """A cfg without target stats gets them from the split that carries
    properties, the training split preferred, as the reference's does."""
    jds, tds = data
    tcfg, _, tstate, want, got = reports["props_beam5_sweep"]
    assert tcfg.model.property_mean is None and prop_cfg.model.property_mean is not None
    direct = tev.teacher_forced_metrics(tstate, prop_cfg, tds)
    assert direct["prop_mse"] == got["prop_mse"]
    # training split without properties: the stats come from the evaluated split
    no_props = dataclasses.replace(tds, properties=None)
    split = tev.evaluate(tstate, tcfg, tds, n_prior=8, train_dataset=no_props, interpolation=False,
                         aggregate_posterior=False, constrained=False)
    assert split["prop_mse"] == got["prop_mse"]
