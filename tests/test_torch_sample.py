"""The serving slice as a whole: sample_prior and reconstruct in the port
against molvax, on identical weights and inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molvax.data import synthetic_smiles
from molvax.kernels.generate import fused_generate as j_fused_generate
from molvax.latent.sample import reconstruct as j_reconstruct, sample_prior as j_sample_prior
from molvax.nn import vae as jvae
from molvax.nn.decoder import latent_embed as j_latent_embed
from molvax_torch.data.featurize import decode_codes, encode_smiles
from molvax_torch.kernels import generate as kg
from molvax_torch.latent.sample import generate, reconstruct, sample_prior
from molvax_torch.nn.decoder import latent_embed
from molvax_torch.nn.vae import encode, reparameterize
from test_torch_support import paired

SMILES = synthetic_smiles(8, seed=11, max_len=18)


@pytest.mark.parametrize("learned_start", [False, True])
def test_sample_prior_strings_match_reference(learned_start):
    """The reference's prior draw, reproduced from its key, decodes to the
    same strings through the port's fp32 scan."""
    jcfg, tcfg, params, model = paired(learned_start=learned_start)
    key = jax.random.key(4)
    ref = j_sample_prior(params, jcfg, 6, key)
    k_z, _ = jax.random.split(key)
    z = np.array(jax.random.normal(k_z, (6, jcfg.latent_dim), jnp.float32))
    codes, _ = generate(model, tcfg, torch.from_numpy(z))
    assert decode_codes(codes) == ref


def test_sample_prior_is_seeded_by_its_generator():
    _, tcfg, _, model = paired(learned_start=True)
    a = sample_prior(model, tcfg, 5, torch.Generator().manual_seed(1), greedy=False)
    b = sample_prior(model, tcfg, 5, torch.Generator().manual_seed(1), greedy=False)
    c = sample_prior(model, tcfg, 5, torch.Generator().manual_seed(2), greedy=False)
    assert a == b and a != c
    assert len(a) == 5 and all(isinstance(s, str) and len(s) <= tcfg.max_len for s in a)


@pytest.mark.parametrize("orientation", ["seq", "charset"])
def test_reconstruct_matches_reference_fp32(orientation):
    jcfg, tcfg, params, model = paired(learned_start=True, conv_orientation=orientation)
    ref = j_reconstruct(params, jcfg, SMILES, jax.random.key(0))
    assert reconstruct(model, tcfg, SMILES) == ref


def test_stochastic_reconstruct_draws_around_mu():
    _, tcfg, _, model = paired(learned_start=True, eps_scale=0.5)
    codes = torch.from_numpy(encode_smiles(SMILES, max_len=tcfg.max_len))
    mu, logvar = encode(model, tcfg, codes)
    eps = torch.cat([
        (reparameterize(mu, logvar, 0.5, torch.Generator().manual_seed(s)) - mu)
        / (0.5 * torch.exp(0.5 * logvar))
        for s in range(200)
    ])
    assert abs(eps.mean().item()) < 0.02 and abs(eps.std().item() - 1.0) < 0.02
    out = reconstruct(model, tcfg, SMILES, torch.Generator().manual_seed(0), stochastic=True)
    assert len(out) == len(SMILES)


def test_kernel_route_reconstruct_agrees_with_reference_kernel():
    """bf16 serving path, encoder to codes: the port's plain kernel version
    against the reference's Pallas kernel (interpret mode), at the reference
    kernel's own agreement gate (tests/kernels/test_generate_kernel.py:34)."""
    jcfg, tcfg, params, model = paired(
        learned_start=True, compute_dtype="bfloat16", use_pallas_generation=True
    )
    codes = encode_smiles(SMILES, max_len=tcfg.max_len)
    mu_j, _ = jvae.encode(params, jcfg, jnp.asarray(codes))
    z_emb_j = j_latent_embed(params["decoder"], jcfg, mu_j)
    ref = np.asarray(j_fused_generate(params["decoder"], jcfg, z_emb_j, jax.random.key(0), True, 1.0))
    with torch.no_grad():
        mu, _ = encode(model, tcfg, torch.from_numpy(codes))
        got = kg.fused_generate_ref(model, model.cfg, latent_embed(model, tcfg, mu)).numpy()
    agree = float(np.mean(got == ref))
    assert agree >= 0.97, agree
