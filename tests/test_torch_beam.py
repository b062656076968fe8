"""Beam search in the port against molvax, on the CPU: ``beam_generate``
and ``beam_reconstruct`` (molvax/latent/beam.py:45-214), unconstrained and
constrained, both conditionings, on identical weights and latents, fp32:
codes equal, best-beam logprobs within 1e-4; beam 1 is greedy decoding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molvax.latent.beam import beam_generate as j_beam_generate, beam_reconstruct as j_beam_reconstruct
from molvax_torch.data.smiles_check import chem_valid
from molvax_torch.latent.beam import beam_generate, beam_reconstruct
from molvax_torch.latent.sample import generate
from test_torch_support import normal, paired

LOGPROB_TOL = 1e-4
T = 32
SMILES = ["CCO", "c1ccccc1", "CC(=O)O", "C1CCNCC1", "CN(C)C=O", "Clc1ccccc1", "OCCO", "CC#N"]


def _model(**kw):
    return paired(max_len=T, **kw)


def _z(rows, seed):
    return 2.0 * normal((rows, 16), seed=seed)


@pytest.mark.parametrize("beam", [1, 3])
@pytest.mark.parametrize("constrained", [False, True])
def test_beam_generate_matches_reference(beam, constrained):
    jcfg, tcfg, params, model = _model(learned_start=True)
    z = _z(5, seed=6)
    codes_j, lp_j = j_beam_generate(params, jcfg, jnp.asarray(z), beam=beam, constrained=constrained)
    codes_t, lp_t = beam_generate(model, tcfg, torch.from_numpy(z), beam=beam, constrained=constrained)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=LOGPROB_TOL, rtol=LOGPROB_TOL)
    if beam == 1:  # beam 1 is greedy decoding
        greedy, _ = generate(model, tcfg, torch.from_numpy(z), constrained=constrained)
        np.testing.assert_array_equal(codes_t.numpy(), greedy.numpy())


@pytest.mark.parametrize("constrained", [False, True])
def test_repeat_z_beam_matches_reference(constrained):
    jcfg, tcfg, params, model = _model(decoder_conditioning="repeat_z")
    z = _z(5, seed=7)
    codes_j, lp_j = j_beam_generate(params, jcfg, jnp.asarray(z), beam=3, constrained=constrained)
    codes_t, lp_t = beam_generate(model, tcfg, torch.from_numpy(z), beam=3, constrained=constrained)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=LOGPROB_TOL, rtol=LOGPROB_TOL)


def test_beam_reconstruct_strings_match_reference():
    jcfg, tcfg, params, model = _model(learned_start=True)
    ref = j_beam_reconstruct(params, jcfg, SMILES, beam=3, constrained=True)
    got = beam_reconstruct(model, tcfg, SMILES, beam=3, constrained=True)
    assert got == ref and all(chem_valid(s) for s in got)
