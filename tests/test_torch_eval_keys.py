"""The keys of ``evaluate()``'s report, written once, and the port's report
held to them on the CPU for every flag set. No JAX: ``chip_smoke.py``
(phase 25) imports ``report_keys`` and ``is_fraction`` from here, and
``tests/test_torch_evaluate.py`` holds ``report_keys`` to the reference's
own reports."""

import importlib
import math

import pytest
import torch

from molvax_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from molvax_torch.data import synthetic_dataset
from molvax_torch.train import init_state

ev = importlib.import_module("molvax_torch.train.evaluate")  # the package's name is the function's

TEACHER = ("acc", "acc_nonpad", "beta", "elbo", "kl", "loss", "post_std_batch", "recon")
GEN = ("gen_valid", "gen_chem_valid", "gen_unique", "gen_novelty", "gen_mean_len")
CON = ("con_chem_valid", "con_unique", "con_novelty", "con_mean_len")
RECON = ("recon_exact", "recon_char_acc", "recon_char_acc_nonpad")
BEAM = ("recon_beam_exact", "recon_beam_char_acc_nonpad")
POST = ("post_mean_norm", "post_std_mean", "post_prior_w2")
INTERP = ("interp_valid", "interp_chem_valid", "interp_endpoint_exact", "interp_endpoint_char", "interp_distinct")
AGG = ("agg_valid", "agg_chem_valid", "agg_unique", "agg_novelty", "agg_mean_len")
OPT = ("pred_lift", "real_lift", "chem_valid", "pairs")
TEMPERATURES = (0.5, 0.7, 1.0, 1.3)  # temperature_sweep's default


def opt_keys(constrained: bool) -> set:
    return {f"{'opt_con_' if constrained else 'opt_'}{k}" for k in OPT}


def sweep_keys(temperatures=TEMPERATURES) -> set:
    return {f"{k}@{t:g}" for t in temperatures for k in GEN}


def report_keys(n_properties: int = 0, beam: int = 0, sweep_temperatures: bool = False, constrained: bool = True,
                interpolation: bool = True, aggregate_posterior: bool = True) -> set:
    """The keys of ``evaluate(...)`` with these flags, for a dataset of at
    least 4 molecules (the interpolation needs 2 pairs)."""
    keys = set(TEACHER) | set(GEN) | set(RECON) | set(POST)
    if n_properties:
        keys |= {"prop_mse"} | {f"prop_mse_{i}" for i in range(n_properties)} | opt_keys(False)
        if constrained:
            keys |= opt_keys(True)
    if constrained:
        keys |= set(CON)
    if beam > 1:
        keys |= set(BEAM)
    if interpolation:
        keys |= set(INTERP)
    if aggregate_posterior:
        keys |= set(AGG)
    if sweep_temperatures:
        keys |= sweep_keys()
    return keys


def is_fraction(key: str) -> bool:
    """A key whose value is a share of rows, strings or positions, in [0, 1]."""
    base = key.split("@")[0]
    return base.endswith(("_valid", "_unique", "_novelty", "_exact", "_char", "_distinct", "char_acc",
                          "char_acc_nonpad")) or base in ("acc", "acc_nonpad")


def check_report(report: dict, **flags) -> None:
    """The report's keys, finite values, fractions in [0, 1], and the
    constrained decodes chemically valid by construction."""
    assert set(report) == report_keys(**flags), set(report) ^ report_keys(**flags)
    for k, v in report.items():
        assert isinstance(v, float) and math.isfinite(v), (k, v)
        if is_fraction(k):
            assert 0.0 <= v <= 1.0, (k, v)
    for k in ("con_chem_valid", "opt_con_chem_valid"):
        if k in report:
            assert report[k] == 1.0, (k, report[k])


def tiny(n_properties: int = 0) -> Config:
    props = dict(property_mean=(2.5, 0.6, 3.0), property_std=(1.5, 0.2, 0.9)) if n_properties else {}
    return Config(
        model=ModelConfig(max_len=20, charset_size=37, latent_dim=16, conv_kernels=(5, 5, 5), enc_hidden=16,
                          gru_hidden=24, gru_layers=2, n_properties=n_properties, **props),
        train=TrainConfig(batch_size=8),
        data=DataConfig(max_len=20, source="synthetic_chem"),
    )


@pytest.fixture(scope="module")
def corpus():
    return synthetic_dataset(24, max_len=20, seed=0, chem=True, with_properties=True)


FLAG_SETS = [
    dict(),
    dict(beam=3),
    dict(sweep_temperatures=True),
    dict(n_properties=3),
    dict(n_properties=3, constrained=False),
    dict(interpolation=False, aggregate_posterior=False, constrained=False),
]


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: ",".join(f"{k}={v}" for k, v in f.items()) or "default")
def test_report_keys_for_each_flag_set(corpus, flags):
    flags = dict(flags)
    n_props = flags.pop("n_properties", 0)
    cfg = tiny(n_props)
    state = init_state(cfg, device="cpu")
    report = ev.evaluate(state, cfg, corpus, n_prior=8, **flags)
    check_report(report, n_properties=n_props, **flags)


def test_report_is_deterministic_under_a_seed(corpus):
    """Two calls with the same generator seed give the same report bit for
    bit; ``generator=None`` is seed 0; another seed moves the sampled
    metrics."""
    cfg = tiny()
    state = init_state(cfg, device="cpu")
    runs = [ev.evaluate(state, cfg, corpus, generator=None if s is None else torch.Generator().manual_seed(s),
                        n_prior=16) for s in (None, 0, 5)]
    assert runs[0] == runs[1]
    assert any(runs[0][k] != runs[2][k] for k in GEN + AGG + CON)
    for k in TEACHER + RECON + POST:  # no draw in these
        assert runs[0][k] == runs[2][k], k


@pytest.mark.parametrize("fn,keys", [
    ("generation_metrics", GEN),
    ("constrained_generation_metrics", CON),
    ("aggregate_generation_metrics", AGG),
    ("temperature_sweep", None),
])
def test_sampled_metric_keys_ranges_and_determinism(corpus, fn, keys):
    cfg = tiny()
    model = init_state(cfg, device="cpu").params
    call = getattr(ev, fn)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        if fn == "aggregate_generation_metrics":
            return call(model, cfg, g, corpus, n=12)
        return call(model, cfg, g, n=12, train_dataset=corpus)

    m = run(3)
    assert set(m) == (set(keys) if keys else sweep_keys())
    check = {k: v for k, v in m.items() if is_fraction(k)}
    assert all(0.0 <= v <= 1.0 for v in check.values()), check
    assert m == run(3)
    if fn == "constrained_generation_metrics":
        assert m["con_chem_valid"] == 1.0


def test_generation_refuses_a_smaller_charset(corpus):
    from molvax_torch.data.charset import Charset

    cfg = tiny()
    model = init_state(cfg, device="cpu").params
    with pytest.raises(ValueError, match="charset size 3 < model charset_size 37"):
        ev.generation_metrics(model, cfg, None, n=4, charset=Charset(chars=(" ", "C", "O")))
