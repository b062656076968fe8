"""The sampling noise of a decode as one table (``kernels.generate.gumbel_table``), on the CPU.

A sampled scan-route decode and a sampled 'repeat_z' decode make the Gumbel
noise of all T steps once, before their steps, as one (T, B, C) table; a
card makes it in one launch of ``csrc/noise.cu``, the CPU with the plain
version. What the CPU can hold, bit for bit: the plain table is the stack
of the per-step ``gumbel_noise`` (whatever form the seed takes, at any
``row_base``); the decodes that read it give the codes and logits of a loop
that draws the per-step noise, as they did before the table; greedy decodes
make no table; the CPU counts no launch. That the kernel's table is its
plain version, and that replays equal the per-step loop, is
``chip_smoke.py`` phase 28. No JAX.
"""

import dataclasses

import pytest
import torch

from molvax_torch.config import ModelConfig
from molvax_torch.data.charset import DEFAULT_CHARSET
from molvax_torch.data.featurize import one_hot
from molvax_torch.kernels import automaton as kauto
from molvax_torch.kernels import generate as kg
from molvax_torch.latent import sample as ls
from molvax_torch.nn.decoder import decode, latent_embed
from molvax_torch.nn.encoder import linear
from molvax_torch.nn.gru import gru_stack_step
from molvax_torch.nn.vae import MolecularVAE

SEED = 0x9E3779B9  # past 2**31: its int32 bit pattern is negative
T = 20
CFG = ModelConfig(max_len=T, charset_size=37, latent_dim=16, conv_kernels=(5, 5, 5), enc_hidden=16, gru_hidden=24,
                  gru_layers=2, learned_start=True, use_pallas_generation=False)
B = 6

SEED_FORMS = {
    "int": lambda s: s,
    "int64_tensor": lambda s: torch.full((), s, dtype=torch.int64),
    "int32_bits": lambda s: torch.full((), s - (1 << 32) if s >= 1 << 31 else s, dtype=torch.int32),
}


@pytest.mark.parametrize("steps", [1, 120])
@pytest.mark.parametrize("classes", [37, 76])
@pytest.mark.parametrize("rows", [6, 256])
@pytest.mark.parametrize("row_base", [0, 1000])
@pytest.mark.parametrize("form", list(SEED_FORMS))
def test_plain_table_is_the_stacked_per_step_noise(form, row_base, rows, classes, steps):
    table = kg.gumbel_table_ref(SEED_FORMS[form](SEED), steps, rows, classes, "cpu", row_base)
    want = torch.stack([kg.gumbel_noise(SEED, t, rows, classes, "cpu", row_base) for t in range(steps)])
    assert table.shape == (steps, rows, classes) and table.dtype == torch.float32 and table.is_contiguous()
    assert torch.equal(table, want)


def test_table_rows_are_global_and_the_seed_reaches_every_step():
    """A rank's table at ``row_base`` k is rows k.. of the full table, and
    another seed changes every step."""
    full = kg.gumbel_table_ref(SEED, 8, 64, 37, "cpu")
    assert torch.equal(kg.gumbel_table_ref(SEED, 8, 16, 37, "cpu", row_base=40), full[:, 40:56])
    other = kg.gumbel_table_ref(SEED + 1, 8, 64, 37, "cpu")
    assert all(not torch.equal(other[t], full[t]) for t in range(8))


def test_table_on_the_cpu_is_the_plain_version_and_counts_no_launch():
    before = kg.noise_table_launches
    table = kg.gumbel_table(SEED, 12, B, 37, "cpu", row_base=3)
    assert torch.equal(table, kg.gumbel_table_ref(SEED, 12, B, 37, "cpu", row_base=3))
    assert kg.noise_table_launches == before


def _model(cfg=CFG, seed: int = 0) -> MolecularVAE:
    torch.manual_seed(seed)
    model = MolecularVAE(cfg, device="cpu")
    if model.start_token is not None:
        with torch.no_grad():
            model.start_token.normal_()
    return model


def _z(rows: int = B, seed: int = 1) -> torch.Tensor:
    return 2.0 * torch.randn(rows, CFG.latent_dim, generator=torch.Generator().manual_seed(seed))


def _per_step_loop(model, cfg, z, seed: int, temperature: float, constrained: bool, row_base: int):
    """The scan route's decode as it was before the table: the per-step
    ``gumbel_noise`` drawn inside each step. (codes, logits)."""
    rows, C = z.shape[0], cfg.charset_size
    itab, state = ls._automaton(DEFAULT_CHARSET, rows, T, "cpu") if constrained else (None, None)
    codes = torch.empty(rows, T, dtype=torch.int32)
    logits = torch.empty(rows, T, C)
    with torch.no_grad():
        z_emb = latent_embed(model, cfg, z)
        hs = torch.zeros(model.gru.num_layers, rows, cfg.gru_hidden)
        prev = model.start_token.float()[None, :].expand(rows, C)
        for t in range(T):
            hs, out = gru_stack_step(model.gru, hs, torch.cat([z_emb, prev], dim=-1))
            logits_t = linear(out, model.linear_4.weight, model.linear_4.bias)
            scores = logits_t / temperature + kg.gumbel_noise(seed, t, rows, C, "cpu", row_base)
            if itab is not None:
                code_t = kauto.auto_step(itab, state, scores.contiguous(), T - 1 - t)[:, 0]
            else:
                code_t = torch.argmax(scores, dim=-1)
            codes[:, t] = code_t.to(torch.int32)
            logits[:, t] = logits_t
            prev = one_hot(code_t, C)
    return codes, logits


@pytest.mark.parametrize("row_base", [0, 1000])
@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("constrained", [False, True], ids=["free", "constrained"])
def test_eager_scan_decodes_the_per_step_noise_loop(constrained, temperature, row_base):
    model, z = _model(), _z()
    seed = ls._draw_seed(torch.Generator().manual_seed(7))
    with torch.no_grad():
        codes, logits = ls._eager_scan(model, CFG, z, seed, False, temperature, constrained, DEFAULT_CHARSET,
                                       row_base)
    codes_l, logits_l = _per_step_loop(model, CFG, z, seed, temperature, constrained, row_base)
    assert torch.equal(codes, codes_l) and torch.equal(logits, logits_l)


@pytest.mark.parametrize("row_base", [0, 1000])
@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("constrained", [False, True], ids=["free", "constrained"])
def test_repeat_z_sampled_codes_are_the_per_step_scores(constrained, temperature, row_base):
    """The 'repeat_z' branch adds the table to all T steps' logits at once:
    the codes of the per-step scores stack (logits[:, t] / temperature +
    ``gumbel_noise`` of step t)."""
    cfg = dataclasses.replace(CFG, decoder_conditioning="repeat_z", learned_start=False)
    model, z = _model(cfg), _z()
    codes, logits = ls.generate(model, cfg, z, torch.Generator().manual_seed(9), greedy=False,
                                temperature=temperature, constrained=constrained, row_base=row_base)
    seed = ls._draw_seed(torch.Generator().manual_seed(9))
    with torch.no_grad():
        want_logits = decode(model, cfg, z)
    scores = torch.stack([want_logits[:, t] / temperature + kg.gumbel_noise(seed, t, B, cfg.charset_size, "cpu",
                                                                           row_base) for t in range(T)], dim=1)
    if constrained:
        itab, state = ls._automaton(DEFAULT_CHARSET, B, T, "cpu")
        want = kauto.auto_step(itab, state, scores.contiguous(), T - 1)
    else:
        want = torch.argmax(scores, dim=-1).to(torch.int32)
    assert torch.equal(logits, want_logits) and torch.equal(codes, want)


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
@pytest.mark.parametrize("cond", ["teacher_forced", "repeat_z"])
@pytest.mark.parametrize("constrained", [False, True], ids=["free", "constrained"])
def test_a_sampled_decode_makes_one_table_and_a_greedy_one_none(constrained, cond, greedy, monkeypatch):
    """``gumbel_table`` called once a sampled decode with the decode's whole
    shape, never in a greedy one; the CPU's launch counter stays at 0."""
    cfg = dataclasses.replace(CFG, decoder_conditioning=cond, learned_start=cond == "teacher_forced")
    model, z = _model(cfg), _z()
    calls = []
    table = kg.gumbel_table

    def counted(seed, steps, rows, classes, device, row_base=0):
        calls.append((steps, rows, classes, row_base))
        return table(seed, steps, rows, classes, device, row_base)

    monkeypatch.setattr(kg, "gumbel_table", counted)
    before = kg.noise_table_launches
    ls.generate(model, cfg, z, torch.Generator().manual_seed(3), greedy=greedy, constrained=constrained,
                row_base=5)
    assert calls == ([] if greedy else [(T, B, cfg.charset_size, 5)])
    assert kg.noise_table_launches == before == 0
