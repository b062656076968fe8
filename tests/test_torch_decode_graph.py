"""The scan route's decode as one CUDA Graph (``latent/sample.py``), on the CPU.

A card captures the scan route's T steps once per key and replays them per
request; the CPU runs the same steps op by op. What the CPU can hold: the one
loop body (``_scan``) draws the same noise from a 0-d tensor seed as from the
int seed, bit for bit (the replay's seed is a device tensor); the key
changes with everything a capture bakes in and with nothing a request
brings (z, seed); the CPU captures nothing; a key is captured at its third
call, and a model keeps a fixed number of keys, as many as a full
``evaluate()`` decodes. That a replay equals the op-by-op loop on the card is
``chip_smoke.py`` phase 28.
"""

import dataclasses
import gc
import importlib

import pytest
import torch
from test_torch_eval_keys import tiny

from molvax_torch.config import ModelConfig
from molvax_torch.data.charset import DEFAULT_CHARSET, Charset
from molvax_torch.kernels import automaton as kauto
from molvax_torch.latent import sample as ls
from molvax_torch.latent.sample import generate
from molvax_torch.nn.vae import MolecularVAE

T = 24
CFG = ModelConfig(max_len=T, charset_size=37, latent_dim=16, conv_kernels=(5, 5, 5), enc_hidden=16, gru_hidden=24,
                  gru_layers=2, learned_start=True, use_pallas_generation=False)
B = 6


def _model(seed: int = 0) -> MolecularVAE:
    torch.manual_seed(seed)
    model = MolecularVAE(CFG, device="cpu")
    with torch.no_grad():
        model.start_token.normal_()
    return model


def _z(rows: int = B, seed: int = 1) -> torch.Tensor:
    return 2.0 * torch.randn(rows, CFG.latent_dim, generator=torch.Generator().manual_seed(seed))


def _scan(model, z, seed, temperature, constrained: bool, row_base: int):
    codes = torch.empty(z.shape[0], T, dtype=torch.int32)
    logits = torch.empty(z.shape[0], T, CFG.charset_size)
    itab, state = ls._automaton(DEFAULT_CHARSET, z.shape[0], T, "cpu") if constrained else (None, None)
    with torch.no_grad():
        ls._scan(model, CFG, z, seed, temperature, itab, state, row_base, codes, logits)
    return codes, logits


@pytest.mark.parametrize("row_base", [0, 1000])
@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("temperature", [None, 1.0, 0.7], ids=["greedy", "T1.0", "T0.7"])
def test_tensor_seed_decodes_the_int_seed_loop_bit_for_bit(temperature, constrained, row_base):
    """The loop body with a 0-d int64 seed tensor (a replay's) against the
    int seed (the op-by-op loop), and the int-seed body against
    ``generate``'s own decode of the seed it draws."""
    model, z = _model(), _z()
    seed = ls._draw_seed(torch.Generator().manual_seed(7))
    codes_i, logits_i = _scan(model, z, seed, temperature, constrained, row_base)
    codes_t, logits_t = _scan(model, z, torch.full((), seed, dtype=torch.int64), temperature, constrained, row_base)
    assert torch.equal(codes_t, codes_i) and torch.equal(logits_t, logits_i)
    codes_g, logits_g = generate(model, CFG, z, torch.Generator().manual_seed(7), greedy=temperature is None,
                                 temperature=temperature or 1.0, constrained=constrained, row_base=row_base)
    assert torch.equal(codes_g, codes_i) and torch.equal(logits_g, logits_i)
    if temperature is not None:  # the seed reaches the noise
        other, _ = _scan(model, z, torch.full((), seed + 1, dtype=torch.int64), temperature, constrained, row_base)
        assert not torch.equal(other, codes_i)


def _key(model, z=None, greedy=False, temperature=1.0, constrained=True, row_base=0, charset=DEFAULT_CHARSET,
         cfg=CFG):
    return ls._decode_key(model, cfg, _z() if z is None else z, greedy, temperature, constrained, charset, row_base)


def test_decode_key_follows_what_a_capture_bakes_in():
    model = _model()
    base = _key(model)
    # two requests that differ only in z and seed share a key
    assert _key(model, z=_z(seed=99)) == base
    differ = {
        "B": _key(model, z=_z(rows=B + 1)),
        "greedy": _key(model, greedy=True),
        "temperature": _key(model, temperature=0.7),
        "constrained": _key(model, constrained=False),
        "row_base": _key(model, row_base=256),
        "charset": _key(model, charset=Charset(DEFAULT_CHARSET.chars[:-1] + ("!",))),
        "T": _key(model, cfg=dataclasses.replace(CFG, max_len=T + 1)),
        "matmul type": _key(model, cfg=dataclasses.replace(CFG, compute_dtype="bfloat16")),
    }
    # torch's fp32 matmul settings, which pick the cuBLAS kernels
    precision, tf32 = torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32
    try:
        torch.set_float32_matmul_precision("medium" if precision != "medium" else "highest")
        differ["matmul precision"] = _key(model)
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_tf32 = not tf32
        differ["tf32"] = _key(model)
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert _key(model) == base
    # a weight that moved (a new tensor, not an in-place update)
    with torch.no_grad():
        model.linear_4.weight.add_(1.0)
    assert _key(model) == base
    model.linear_4.weight.data = model.linear_4.weight.data.clone()
    differ["weight address"] = _key(model)
    model.linear_4.weight.data = model.linear_4.weight.data.clone()
    # the automaton's step function: the kernel's wrapper or its plain version
    moved = _key(model)
    saved = kauto.auto_step
    kauto.auto_step = kauto.auto_step_plain
    try:
        differ["auto_step"] = _key(model)
    finally:
        kauto.auto_step = saved
    assert _key(model) == moved
    for what, key in differ.items():
        assert key != base, what
    assert differ["auto_step"] != moved


@pytest.mark.parametrize("constrained", [False, True])
def test_cpu_captures_nothing(constrained):
    model = _model()
    before = (ls.graph_captures, ls.graph_replays, len(ls._graphs))
    for seed in (1, 2):
        generate(model, CFG, _z(), torch.Generator().manual_seed(seed), greedy=False, constrained=constrained)
    assert (ls.graph_captures, ls.graph_replays, len(ls._graphs)) == before
    assert model not in ls._graphs


def test_a_key_is_captured_at_its_third_call():
    """``_entry``: a key's first two calls get no entry (they run op by
    op), its third makes one, later calls get that one; each key counts
    alone."""
    assert ls._CAPTURE_AT_CALL == 3
    model = _model()
    made = []

    def make(i):
        made.append(i)
        return f"graph {i}"

    calls = [ls._entry(model, ("key", i), lambda i=i: make(i)) for i in (0, 1, 0, 1, 0, 0, 1, 0)]
    assert calls == [(None, False), (None, False), (None, False), (None, False), ("graph 0", True),
                     ("graph 0", False), ("graph 1", True), ("graph 0", False)]
    assert made == [0, 1]


def test_entries_per_model_stay_at_their_count():
    """``_entry`` keeps ``_KEYS_PER_MODEL`` keys a model, counted or
    captured, the least recently used dropped first (a dropped key starts
    its count again); another model's keys are its own and go with it."""
    model, other = _model(), _model(1)
    n = ls._KEYS_PER_MODEL
    def first(i):
        return ls._entry(model, ("key", i), lambda: pytest.fail("a first call captures nothing"))

    for i in range(n):
        first(i)
    assert ls._entry(model, ("key", 0), lambda: "graph 0") == (None, False)
    assert ls._entry(model, ("key", 0), lambda: "graph 0") == ("graph 0", True)  # now the newest
    for i in range(n, n + 3):
        first(i)
        assert len(ls._graphs[model]) == n
    order = [("key", i) for i in range(1, n)] + [("key", 0)] + [("key", i) for i in range(n, n + 3)]
    assert list(ls._graphs[model]) == order[-n:]
    assert first(1) == (None, False)  # dropped: counted anew
    assert ls._entry(model, ("key", 1), lambda: "graph 1") == (None, False)
    assert ls._entry(model, ("key", 0), lambda: "again") == ("graph 0", False)
    ls._entry(other, ("key", 0), lambda: "other's")
    assert len(ls._graphs[model]) == n and len(ls._graphs[other]) == 1
    models = len(ls._graphs)
    del other
    gc.collect()
    assert len(ls._graphs) == models - 1 and len(ls._graphs[model]) == n


def test_a_model_keeps_the_keys_of_a_full_evaluate(monkeypatch):
    """A full ``evaluate()`` of a kernel-less model (beam, the temperature
    sweep, a property head's optimization with and without the automaton;
    every decode on the scan route) decodes ``_KEYS_PER_MODEL`` keys, so a
    repeated report finds each again, and none of them more than twice, so
    a one-off report captures nothing."""
    from molvax_torch.data import synthetic_dataset
    from molvax_torch.train import init_state

    ev = importlib.import_module("molvax_torch.train.evaluate")
    keys = []
    eager = ls._eager_scan

    def counted(model, cfg, z, seed, greedy, temperature, constrained, charset, row_base):
        keys.append(ls._decode_key(model, cfg, z, greedy, temperature, constrained, charset, row_base))
        return eager(model, cfg, z, seed, greedy, temperature, constrained, charset, row_base)

    monkeypatch.setattr(ls, "_eager_scan", counted)
    cfg = tiny(n_properties=3)
    dataset = synthetic_dataset(300, max_len=cfg.model.max_len, seed=0, chem=True, with_properties=True)
    ev.evaluate(init_state(cfg, device="cpu"), cfg, dataset, beam=3, sweep_temperatures=True)
    assert (len(keys), len(set(keys))) == (13, ls._KEYS_PER_MODEL)
    assert max(keys.count(k) for k in keys) < ls._CAPTURE_AT_CALL
