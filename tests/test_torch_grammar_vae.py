"""The Grammar VAE (``gvae_zinc``) on the CPU against its plain reference.

``perfbench/reference/grammar.py`` is the plain fp32 reference (its own
copy of the 76 rules; it imports nothing of the port). At a small size
(T=40, H=32, latent 8, two GRU layers) on seeded random weights: the
port's grammar tables equal the reference's; parsing then deriving gives
back every string of the chemistry corpus; the encoder, the decoder's
logits, the grammar-masked loss and every gradient match the reference;
the plain walk gives the reference's walk; ``sample_prior``,
``generate``, ``reconstruct``, ``train()`` (its round-trip probe too),
``evaluate()`` and the latent workloads run on a grammar config, and so do
the CLI's ``train`` and ``sample``; ``constrained=True`` and beam search
raise.

Tolerances, each with its reason: the port runs these comparisons in
strict fp32 (``compute_dtype='float32'``), so only the order of its sums
differs from the reference's: 1e-5 on logits and latents (values of order
1, fp32 rounding of sums of at most ~1,000 products), 1e-5 relative on the
loss, 1e-4 relative on a gradient (the sums of a backward run over the
batch and the steps as well). The reference in bf16 in the port's place
misses them: its logits by two orders of magnitude, its loss by a few
times (``test_bf16_control_fails_the_tolerances``).
"""

import json
import os

import numpy as np
import pytest
import torch

from molvax_torch import cli
from molvax_torch.config import apply_overrides, get_preset
from molvax_torch.data.grammar import ZINC_GRAMMAR as G
from molvax_torch.data.alphabet import grammar_dataset
from molvax_torch.data.molgen import random_smiles
from molvax_torch.kernels import grammar_walk as kw
from molvax_torch.latent import (beam_generate, beam_reconstruct, decode_latents, encode_corpus, interpolate,
                                  optimize_from_smiles, sample_prior)
from molvax_torch.latent.sample import generate, reconstruct
from molvax_torch.nn.decoder import decode
from molvax_torch.nn.vae import MolecularVAE, encode, forward
from molvax_torch.train import init_state, train
from molvax_torch.train.evaluate import evaluate, reconstruction_metrics
from molvax_torch.train.loss import vae_loss
from perfbench.reference import grammar as rg
from perfbench.reference import model as pref
from perfbench.reference import noise as pnoise
from perfbench.reference.served import request_inputs

SMALL = {"model.max_len": 40, "model.latent_dim": 8, "model.conv_channels": (3, 3, 4), "model.conv_kernels": (3, 3, 3),
         "model.enc_hidden": 16, "model.gru_hidden": 32, "model.gru_layers": 2, "model.compute_dtype": "float32",
         "train.batch_size": 16, "train.train_chunk_size": 4, "data.max_len": 40, "data.n_synthetic": 400}
ATOL = 1e-5
LOSS_REL = 1e-5
GRAD_REL = 1e-4


def small_cfg(route: str = "kernels"):
    return apply_overrides(get_preset("gvae_zinc"), dict(SMALL, **{"model.use_pallas": route == "kernels"}))


def sizes_of(cfg) -> dict:
    m = cfg.model
    return {"max_len": m.max_len, "charset_size": m.charset_size, "latent_dim": m.latent_dim,
            "conv_channels": list(m.conv_channels), "conv_kernels": list(m.conv_kernels), "enc_hidden": m.enc_hidden,
            "gru_hidden": m.gru_hidden, "gru_layers": m.gru_layers, "eps_scale": m.eps_scale,
            "dense_activation": m.dense_activation}


def model_and_weights(cfg, seed: int = 3):
    p = rg.make_weights(sizes_of(cfg), seed, "cpu")
    model = MolecularVAE(cfg.model, device="cpu")
    model.load_state_dict(p, strict=True)
    return model, p


def corpus_codes(cfg, rows: int = 16, seed: int = 0) -> torch.Tensor:
    ds = grammar_dataset(G, "synthetic_chem", cfg.model.max_len, 400, seed)
    return torch.from_numpy(ds.codes[:rows].astype(np.int64))


# -- the grammar --------------------------------------------------------------


def test_rules_lhs_and_masks_are_the_reference_copy():
    ref = rg.GRAMMAR
    assert len(G.rules) == len(ref.rules) == 76 and G.pad_rule == ref.pad == 75
    assert G.rules[0] == ("smiles", ("chain",)) and G.rules[-1] == ("Nothing", ())
    as_ref = [(lhs, tuple(f"'{x}'" if isinstance(x, str) else ref.nonterminals[x] for x in rhs))
              for (lhs, _), rhs in zip(ref.rules, ref.rhs)]
    assert list(G.rules) == as_ref
    assert G.nonterminals == ref.nonterminals and G.nonterminals[-1] == "class"
    assert np.array_equal(G.lhs, ref.lhs) and np.array_equal(G.masks, ref.masks)
    assert not G.masks[G.nonterminals.index("class")].any()
    assert (G.start, G.nothing) == (ref.start, ref.nothing)
    assert len(G.terminals) == 35 and {"Cl", "Br", "@@"} <= set(G.terminals)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parse_then_derive_gives_back_every_corpus_string(seed):
    smiles = random_smiles(400, seed=seed)
    for s in smiles:
        prods = G.parse(s)
        assert G.derive(prods) == s == rg.GRAMMAR.derive(prods)
        assert G.derive(prods + [G.pad_rule] * 7) == s
    codes, dropped = G.encode(smiles, 277)
    assert dropped == 0 and codes.shape == (400, 277) and codes.dtype == np.uint8


@pytest.mark.parametrize("s", ["[13CH2+]C", "[C@@H](Cl)(Br)F", "C=1CC1", "c1ccccc1-c2ccccc2", "[nH]1cccc1",
                               "[NH3+]CC(=O)[O-]", "F/C=C/F", "C\\C=C\\C", "[123I]", "[Br+2]"])
def test_parse_takes_brackets_charges_rings_and_bonds(s):
    assert G.derive(G.parse(s)) == s


def test_strings_the_grammar_does_not_derive():
    for s in ("C%10", "C9", "C(C)1", "[H]", "C)", "(C)"):
        with pytest.raises(ValueError):
            G.parse(s)
    codes, dropped = G.encode(["CCO", "C%10", "C" * 60], 40, strict=False)
    assert dropped == 2 and codes.shape == (1, 40)
    assert G.derive([G.start]) is None  # a nonterminal left after the rules
    assert G.derive(G.parse("CCO")[:-1]) is None


# -- the model against the reference ------------------------------------------------


@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_encoder_and_logits_match_the_reference(route):
    cfg = small_cfg(route)
    model, p = model_and_weights(cfg)
    codes = corpus_codes(cfg)
    s = sizes_of(cfg)
    with torch.no_grad(), pref.strict_fp32():
        mu, logvar = encode(model, cfg.model, codes)
        rmu, rlv = rg.encode(p, s, codes)
        z = torch.randn(12, cfg.model.latent_dim, generator=torch.Generator().manual_seed(4))
        logits = decode(model, cfg.model, z)
        rlogits = rg.decode(p, s, z)
    assert logits.shape == (12, 40, 76)
    for got, want in ((mu, rmu), (logvar, rlv), (logits, rlogits)):
        assert float((got - want).abs().max()) <= ATOL


def port_loss(model, cfg, codes, seed):
    out = forward(model, cfg.model, seed, codes)
    loss, _ = vae_loss(cfg.model, out.logits, codes, out.mu, out.logvar, 1.0, kl=out.kl)
    return loss


@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_masked_loss_and_every_gradient_match_the_reference(route):
    cfg = small_cfg(route)
    model, p = model_and_weights(cfg)
    codes = corpus_codes(cfg)
    seed = 0x5EED
    with pref.strict_fp32():
        loss = port_loss(model, cfg, codes, seed)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        eps = pnoise.normal(seed, codes.shape[0], cfg.model.latent_dim, "cpu")
        rloss = rg.loss_of(leaves, sizes_of(cfg), codes, eps)
        rgrads = dict(zip(leaves, torch.autograd.grad(rloss, list(leaves.values()))))
    assert abs(float(loss.detach()) - float(rloss.detach())) <= LOSS_REL * abs(float(rloss.detach()))
    for (name, _), g in zip(model.named_parameters(), grads):
        want = rgrads[name]
        assert float((g - want).norm() / want.norm().clamp(min=1e-12)) <= GRAD_REL, name


def test_padding_steps_add_nothing_to_the_loss():
    """A padding step is masked to the padding rule alone: its term is 0
    whatever the logits, so the loss of a row does not depend on them."""
    cfg = small_cfg()
    codes = corpus_codes(cfg, rows=4)
    logits = torch.randn(4, 40, 76, generator=torch.Generator().manual_seed(1))
    mu = logvar = torch.zeros(4, cfg.model.latent_dim)
    base, _ = vae_loss(cfg.model, logits, codes, mu, logvar, 1.0)
    pad = codes == G.pad_rule
    assert bool(pad.any())
    moved = logits + 50.0 * pad[..., None]
    assert float(vae_loss(cfg.model, moved, codes, mu, logvar, 1.0)[0]) == pytest.approx(float(base), rel=1e-6)


@pytest.mark.parametrize("q", ["bf16", "fp8"])
def test_bf16_control_fails_the_tolerances(q):
    """The reference in a lower precision in the port's place misses at
    least one tolerance (here the logits' and the loss's)."""
    cfg = small_cfg()
    model, p = model_and_weights(cfg)
    s = sizes_of(cfg)
    codes = corpus_codes(cfg)
    z = torch.randn(12, cfg.model.latent_dim, generator=torch.Generator().manual_seed(4))
    rq = getattr(pref, q)
    with torch.no_grad(), pref.strict_fp32():
        gap = float((rg.decode(p, s, z, rq) - decode(model, cfg.model, z)).abs().max())
        eps = pnoise.normal(9, codes.shape[0], cfg.model.latent_dim, "cpu")
        lq, lf = float(rg.loss_of(p, s, codes, eps, q=rq)), float(rg.loss_of(p, s, codes, eps))
    assert gap > 10 * ATOL and abs(lq - lf) > LOSS_REL * abs(lf)


# -- the walk ------------------------------------------------------------------------


@pytest.mark.parametrize("greedy,seed,row_base", [(False, 0x9E3779B9, 0), (False, 7, 96), (True, 0, 0)],
                         ids=["sampled", "sampled_row_base", "greedy"])
def test_plain_walk_is_the_reference_walk(greedy, seed, row_base):
    logits = 3.0 * torch.randn(64, 60, 76, generator=torch.Generator().manual_seed(seed & 0xFFFF))
    out = kw.walk(logits, G, seed, greedy, 1.0, row_base)
    assert out.shape == (64, 180) and out.dtype == torch.uint8
    prods, strings = out[:, :60].long(), G.strings(out[:, 60:].numpy())
    want_prods, want_strings = rg.sample_walk(logits, seed, greedy, 1.0, row_base)
    assert torch.equal(prods, want_prods) and strings == want_strings
    assert any(strings) and not all(strings)  # complete and incomplete rows both
    assert strings == [G.derive(r) or "" for r in prods.tolist()]
    assert rg.served_gap(logits, prods, seed, greedy, 1.0, row_base=row_base) == 0.0


def test_a_rule_without_a_nonterminal_of_its_own_ends_the_row():
    """Forcing ``BACH -> class``: the row's derivation ends incomplete, the
    padding rule from that step on, an empty string; the reference agrees."""
    T = 30
    logits = torch.zeros(1, T, 76)
    path = [G._rule("smiles", "chain"), G._rule("chain", "branched_atom"), G._rule("branched_atom", "atom"),
            G._rule("atom", "bracket_atom"), G._rule("bracket_atom", "'['", "BAI", "']'"),
            G._rule("BAI", "symbol", "BAC"), G._rule("symbol", "aliphatic_organic"),
            G._rule("aliphatic_organic", "'C'"), G._rule("BAC", "BAH"), G._rule("BAH", "BACH"),
            G._rule("BACH", "class")]
    for t, r in enumerate(path):
        logits[0, t, r] = 10.0
    out = kw.walk(logits, G, 0, True, 1.0)
    prods = out[0, :T].tolist()
    assert prods[:len(path)] == path and set(prods[len(path):]) == {G.pad_rule}
    assert G.strings(out[:, T:].numpy()) == [""] and not out[0, T:].any()
    want, strings = rg.sample_walk(logits, 0, True, 1.0)
    assert want[0].tolist() == prods and strings == [""]


# -- the program's entry points ------------------------------------------------------


def test_sample_prior_returns_the_reference_strings():
    cfg = small_cfg()
    model, p = model_and_weights(cfg)
    n, req = 48, 2**31 + 5
    strings, codes = sample_prior(model, cfg.model, n, torch.Generator().manual_seed(req), greedy=False,
                                  with_codes=True)
    z, seed = request_inputs(req, n, cfg.model.latent_dim)
    logits = rg.served_logits(p, sizes_of(cfg), z)
    want_prods, want_strings = rg.sample_walk(logits, seed, False, 1.0)
    assert strings == want_strings and torch.equal(codes.long(), want_prods)
    assert rg.served_gap(logits, codes, seed, False, 1.0) <= ATOL
    assert strings == sample_prior(model, cfg.model, n, torch.Generator().manual_seed(req), greedy=False)


def test_generate_and_reconstruct_take_the_grammar_route():
    cfg = small_cfg()
    model, _ = model_and_weights(cfg)
    z = torch.randn(6, cfg.model.latent_dim, generator=torch.Generator().manual_seed(2))
    before = kw.launches
    codes, logits = generate(model, cfg.model, z, greedy=True)
    assert codes.shape == (6, 40) and codes.dtype == torch.int32 and logits.shape == (6, 40, 76)
    want = kw.walk_ref(logits, G, 0, True, 1.0)[:, :40]
    assert torch.equal(codes, want.to(torch.int32)) and kw.launches == before  # the plain walk on the CPU
    out = reconstruct(model, cfg.model, ["CCO", "c1ccccc1", "CC(=O)N"])
    assert len(out) == 3 and all(isinstance(s, str) for s in out)


def test_constrained_and_beam_raise_on_a_grammar_config():
    cfg = small_cfg()
    model, _ = model_and_weights(cfg)
    z = torch.zeros(2, cfg.model.latent_dim)
    with pytest.raises(ValueError, match="zinc_grammar"):
        sample_prior(model, cfg.model, 2, constrained=True)
    with pytest.raises(ValueError, match="zinc_grammar"):
        generate(model, cfg.model, z, constrained=True)
    with pytest.raises(ValueError, match="zinc_grammar"):
        beam_generate(model, cfg.model, z)
    with pytest.raises(ValueError, match="zinc_grammar"):
        beam_reconstruct(model, cfg.model, ["CCO"])


def test_evaluate_reports_on_a_grammar_config():
    """``evaluate()`` decodes through the grammar; the round trip scores the
    rule codes against the padding rule, its strings are the derivations';
    the automaton and beam search raise as ``generate`` does."""
    cfg = small_cfg()
    state = init_state(cfg, device="cpu")
    ds = grammar_dataset(G, "synthetic_chem", cfg.model.max_len, 400, 0)
    report = evaluate(state, cfg, ds, torch.Generator().manual_seed(1), n_prior=32, constrained=False)
    for k in ("gen_valid", "gen_novelty", "recon_exact", "recon_char_acc_nonpad", "post_prior_w2", "interp_valid",
              "interp_endpoint_char", "agg_valid", "agg_unique"):
        assert np.isfinite(report[k]), k
    model = state.params
    m = reconstruction_metrics(model, cfg, ds, n=16)
    codes = ds.codes[:16]
    with torch.no_grad():
        out = generate(model, cfg.model, encode(model, cfg.model, torch.from_numpy(codes))[0])[0].numpy()
    keep = codes != G.pad_rule
    assert m["recon_char_acc_nonpad"] == pytest.approx(float((out == codes)[keep].mean()))
    want = [G.derive(r) or "" for r in out.tolist()]
    assert m["recon_exact"] == pytest.approx(np.mean([a == G.derive(b) for a, b in zip(want, codes.tolist())]))
    with pytest.raises(ValueError, match="zinc_grammar"):
        evaluate(state, cfg, ds, n_prior=8, constrained=True)
    with pytest.raises(ValueError, match="zinc_grammar"):
        evaluate(state, cfg, ds, n_prior=8, constrained=False, beam=3)


def test_train_runs_its_round_trip_probe_on_a_grammar_config():
    cfg = apply_overrides(small_cfg(), {"train.eval_every": 4, "train.eval_batches": 1, "train.eval_roundtrip_n": 8,
                                        "data.test_fraction": 0.25})
    state, history = train(cfg, device="cpu", max_steps=8, verbose=False)
    probes = [h for h in history if "eval_recon_exact" in h]
    assert state.step == 8 and [h["step"] for h in probes] == [4, 8]
    assert all(0.0 <= h["eval_recon_char_acc_nonpad"] <= 1.0 for h in probes)


def test_latent_workloads_run_on_a_grammar_config():
    """``encode_corpus`` encodes derivations, ``decode_latents`` gives the
    walk's strings, ``interpolate``'s ends decode as their molecules do."""
    cfg = small_cfg()
    model, _ = model_and_weights(cfg)
    smiles = ["CCO", "c1ccccc1", "CC(=O)N", "ClC1CC1"]
    mu, _ = encode_corpus(model, cfg.model, smiles, batch=3)
    with torch.no_grad():
        want, _ = encode(model, cfg.model, torch.from_numpy(G.encode(smiles, cfg.model.max_len)[0]))
    assert mu.shape == (4, 8) and np.allclose(mu, want.numpy(), atol=ATOL)
    out = decode_latents(model, cfg.model, want, batch=3)
    assert out == reconstruct(model, cfg.model, smiles) and len(out) == 4
    path = interpolate(model, cfg.model, smiles[0], smiles[1], steps=5, spherical=False)
    assert len(path) == 5 and (path[0], path[-1]) == (out[0], out[1])


def test_optimize_from_smiles_runs_on_a_grammar_config():
    cfg = apply_overrides(small_cfg(), {"model.n_properties": 1})
    model = MolecularVAE(cfg.model, device="cpu")
    out, result = optimize_from_smiles(model, cfg.model, ["CCO", "c1ccccc1"], steps=3)
    assert len(out) == 2 and result.z.shape == (2, 8)
    assert out == decode_latents(model, cfg.model, result.z)


def test_train_runs_on_the_grammar_corpus():
    cfg = small_cfg()
    state, history = train(cfg, device="cpu", max_steps=8, verbose=False)
    assert state.step == 8 and history and np.isfinite(history[-1]["loss"])
    assert 0.0 <= history[-1]["acc_nonpad"] <= 1.0


def test_cli_trains_and_samples_a_grammar_checkpoint(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MOLVAX_PLATFORM", "cpu")
    ckpt = str(tmp_path / "gvae")
    over = []
    for k, v in SMALL.items():
        over += ["--override", f"{k}={v!r}" if isinstance(v, str) else f"{k}={v}"]
    assert cli.main(["train", "--preset", "gvae_zinc", "--steps", "4", "--quiet"] + over
                    + ["--override", f"train.checkpoint_dir={ckpt}", "--override", "data.n_synthetic=64"]) == 0
    assert os.path.exists(os.path.join(ckpt, "grammar.json")) and not os.path.exists(os.path.join(ckpt, "charset.json"))
    assert json.load(open(os.path.join(ckpt, "grammar.json"))) == list(G.chars)
    cfg, state, table = cli._restore(get_preset("gvae_zinc"), ckpt)
    assert table is G and cfg.model.charset_size == 76 and cfg.model.alphabet == "zinc_grammar"
    capsys.readouterr()
    assert cli.main(["sample", "--ckpt", ckpt, "-n", "5", "--stochastic", "--seed", "3"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if not ln.startswith("#")]
    assert len(lines) == 5
