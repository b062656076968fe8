"""Constrained decoding in the port against molvax, on the CPU:
``generate(constrained=True)`` and ``sample_prior(constrained=True)``
(molvax/latent/sample.py:74-191, 246-271), both conditionings, on identical
weights and latents, fp32.

Greedy decodes are deterministic on both sides: codes equal, logits within
the repo's parity tolerance. Sampled decodes draw the port's counter-hash
noise, not ``jax.random``'s: they are checked for seeded determinism,
validity, and by replaying the port's own scores through the reference's
``select_advance``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molvax.data.charset import DEFAULT_CHARSET as J_CS
from molvax.kernels import automaton as jauto
from molvax.latent import constrain as jc
from molvax.latent.sample import generate as j_generate
from molvax_torch.data.featurize import decode_codes
from molvax_torch.data.smiles_check import chem_valid
from molvax_torch.kernels.generate import gumbel_noise
from molvax_torch.latent.sample import _draw_seed, generate, sample_prior
from test_torch_support import normal, paired

FP32_TOL = 2e-4  # tests/parity/test_torch_parity.py:30
T = 32


def _model(**kw):
    return paired(max_len=T, **kw)


def _z(rows, seed):
    return 2.0 * normal((rows, 16), seed=seed)


@pytest.mark.parametrize("cond", ["teacher_forced", "repeat_z"])
@pytest.mark.parametrize("learned_start", [False, True])
def test_constrained_greedy_matches_reference(cond, learned_start):
    jcfg, tcfg, params, model = _model(decoder_conditioning=cond, learned_start=learned_start)
    z = _z(6, seed=3)
    codes_j, logits_j = j_generate(params, jcfg, jnp.asarray(z), jax.random.key(0), greedy=True, constrained=True)
    codes_t, logits_t = generate(model, tcfg, torch.from_numpy(z), greedy=True, constrained=True)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=FP32_TOL, rtol=FP32_TOL)
    assert all(chem_valid(s) for s in decode_codes(codes_t))


@pytest.mark.parametrize("cond", ["teacher_forced", "repeat_z"])
def test_constrained_sampling_is_seeded_valid_and_replays_through_reference(cond):
    _, tcfg, _, model = _model(decoder_conditioning=cond, learned_start=True)
    z = torch.from_numpy(_z(8, seed=4))
    temp = 1.5
    a, logits = generate(model, tcfg, z, torch.Generator().manual_seed(5), greedy=False, temperature=temp,
                         constrained=True)
    b, _ = generate(model, tcfg, z, torch.Generator().manual_seed(5), greedy=False, temperature=temp,
                    constrained=True)
    c, _ = generate(model, tcfg, z, torch.Generator().manual_seed(6), greedy=False, temperature=temp,
                    constrained=True)
    assert torch.equal(a, b) and not torch.equal(a, c)
    for s in decode_codes(a) + decode_codes(c):
        assert s == "" or chem_valid(s), s
    # the port's scores, replayed through the reference's automaton step
    seed = _draw_seed(torch.Generator().manual_seed(5))
    B, C = z.shape[0], tcfg.charset_size
    jtb = jc.build_tables(J_CS)
    st = jc.init_state(B, T)
    step = jax.jit(lambda s, sc, r: jauto.select_advance(jtb, s, sc, r))
    for t in range(T):
        scores = logits[:, t] / temp + gumbel_noise(seed, t, B, C, "cpu")
        st, code = step(st, jnp.asarray(scores.numpy()), jnp.int32(T - 1 - t))
        np.testing.assert_array_equal(a[:, t].numpy(), np.asarray(code), err_msg=f"step {t}")


def test_use_pallas_automaton_changes_nothing():
    """The flag chose between two implementations of the same codes on the
    TPU; the port has one per device, and the flag is accepted and ignored."""
    _, tcfg, _, model = _model(learned_start=True)
    z = torch.from_numpy(_z(4, seed=8))
    on = dataclasses.replace(tcfg, use_pallas_automaton=True)
    for greedy in (True, False):
        a, _ = generate(model, tcfg, z, torch.Generator().manual_seed(1), greedy=greedy, constrained=True)
        b, _ = generate(model, on, z, torch.Generator().manual_seed(1), greedy=greedy, constrained=True)
        assert torch.equal(a, b)
    strings = sample_prior(model, on, 6, torch.Generator().manual_seed(2), constrained=True)
    assert len(strings) == 6 and all(chem_valid(s) for s in strings)
