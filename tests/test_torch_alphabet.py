"""The alphabet (``data/alphabet.py``): which table a config decodes in,
SMILES to codes and back in either alphabet, and the table a checkpoint
directory carries from ``train()`` to ``cli._restore``.

No JAX: the grammar's strings are held to the pushdown walk's own terminal
lookup, the characters' to the corpus they came from.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from molvax_torch import cli
from molvax_torch.config import PRESETS, apply_overrides, get_preset
from molvax_torch.data import alphabet as ab
from molvax_torch.data.charset import DEFAULT_CHARSET, Charset
from molvax_torch.data.grammar import ZINC_GRAMMAR as G
from molvax_torch.data.molgen import random_smiles
from molvax_torch.kernels import grammar_walk as kw
from molvax_torch.train import train
from molvax_torch.train.loop import ema_eval_state

SMALL = {"model.latent_dim": 8, "model.enc_hidden": 16, "model.gru_hidden": 16, "model.gru_layers": 2,
         "model.compute_dtype": "float32", "train.batch_size": 16, "train.train_chunk_size": 1, "data.n_synthetic": 64}
SIZES = {"chemvae_5k": {"model.max_len": 32, "data.max_len": 32},
         "gvae_zinc": {"model.max_len": 40, "data.max_len": 40, "model.conv_channels": (3, 3, 4),
                       "model.conv_kernels": (3, 3, 3)}}


def small(preset: str):
    return apply_overrides(get_preset(preset), dict(SMALL, **SIZES[preset]))


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_the_alphabet_of_every_preset(preset):
    model = get_preset(preset).model
    mine = Charset.from_corpus(["CCO", "c1ccccc1"])
    if model.alphabet == "zinc_grammar":
        assert ab.alphabet_of(model) is G and ab.alphabet_of(model, mine) is G
        assert G.size == model.charset_size
    else:
        assert model.alphabet == "charset"
        assert ab.alphabet_of(model) is DEFAULT_CHARSET and ab.alphabet_of(model, mine) is mine
    assert ab.alphabet_of(None, G) is G  # no config: the table the caller holds (a dataset's)


def test_an_unknown_alphabet_raises():
    cfg = types.SimpleNamespace(alphabet="selfies", max_len=20)
    for call in (lambda: ab.alphabet_of(cfg), lambda: ab.encode(["CCO"], cfg),
                 lambda: ab.strings(np.zeros((1, 20)), cfg), lambda: ab.corpus(types.SimpleNamespace(model=cfg))):
        with pytest.raises(ValueError, match="unknown alphabet 'selfies'"):
            call()


@pytest.mark.parametrize("preset", ["zinc250k", "gvae_zinc"])
@pytest.mark.parametrize("seed", [0, 1])
def test_encode_then_strings_gives_back_the_corpus(preset, seed):
    cfg = get_preset(preset).model
    smiles = [s for s in random_smiles(200, seed=seed) if len(s) <= cfg.max_len]
    codes = ab.encode(smiles, cfg)
    assert codes.shape == (len(smiles), cfg.max_len) and codes.dtype == np.uint8
    table = ab.alphabet_of(cfg)
    assert (codes[:, -1] == table.pad_index).all()  # every row padded to T
    assert ab.strings(codes, cfg) == smiles
    assert ab.strings(torch.from_numpy(codes).to(torch.int32), cfg) == smiles
    assert ab.strings(codes, charset=table) == smiles
    assert ab.strings(codes[0], cfg) == smiles[:1]


@pytest.mark.parametrize("T,greedy,seed", [(60, False, 11), (24, False, 12), (24, True, 13), (90, False, 14)])
def test_grammar_strings_of_the_walk_rules_are_its_terminal_strings(T, greedy, seed):
    """``strings`` of the walk's rule codes (a derivation each) equals the
    walk's own lookup of its terminal codes, rows that the walk ends at T
    and rows that pop ``class`` included."""
    cfg = types.SimpleNamespace(alphabet="zinc_grammar", max_len=T)
    logits = 3.0 * torch.randn(256, T, G.size, generator=torch.Generator().manual_seed(seed))
    out = kw.walk(logits, G, seed, greedy, 1.0)
    rules, terms = out[:, :T], out[:, T:]
    got, want = ab.strings(rules, cfg), G.strings(terms.numpy())
    assert got == want
    ended_at_t = [s == "" and int(r[-1]) != G.pad_rule for s, r in zip(want, rules)]
    assert any(want) and any(ended_at_t)


@pytest.mark.parametrize("preset,table", [("chemvae_5k", "charset.json"), ("gvae_zinc", "grammar.json")])
def test_a_checkpoint_written_by_train_restores_through_the_cli(tmp_path, monkeypatch, preset, table):
    monkeypatch.setenv("MOLVAX_PLATFORM", "cpu")
    ckpt = str(tmp_path / preset)
    cfg = apply_overrides(small(preset), {"train.checkpoint_dir": ckpt})
    state, _ = train(cfg, device="cpu", max_steps=2, verbose=False)
    other = {"charset.json", "grammar.json"} - {table}
    assert os.path.exists(os.path.join(ckpt, table)) and not os.path.exists(os.path.join(ckpt, other.pop()))
    written = tuple(json.load(open(os.path.join(ckpt, table))))
    got_cfg, restored, alphabet = cli._restore(get_preset(preset), ckpt)
    assert alphabet.chars == written and alphabet.size == got_cfg.model.charset_size
    assert alphabet == ab.corpus(cfg).charset
    for (name, a), b in zip(ema_eval_state(state).params.named_parameters(), restored.params.parameters()):
        assert torch.equal(a, b), name
    if table == "grammar.json":
        assert alphabet is G
        json.dump(list(G.chars[:-1]) + ["Nothing -> nothing"], open(os.path.join(ckpt, table), "w"))
        with pytest.raises(SystemExit, match="rules are not those of zinc_grammar"):
            cli._restore(get_preset(preset), ckpt)
