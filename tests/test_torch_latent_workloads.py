"""The latent workloads in the port against ``molvax.latent`` on identical
weights and inputs, on the CPU (fp32 on both sides): lerp / slerp and
interpolate, optimize_z and optimize_from_smiles on the property head, the
chunked encode and decode of a corpus (greedy, constrained, beam), the
aggregate posterior's fit, and the ``.npz`` layout. Where the streams
differ by design (the aggregate sampler's draw), the port's noise is
handed to the reference and its statistics are checked."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molvax.data import synthetic_smiles
from molvax.latent import embed as jembed
from molvax.latent import optimize as jopt
from molvax.latent import sample as jsample
from molvax_torch.data.featurize import decode_codes, encode_smiles
from molvax_torch.latent import (decode_latents, embed, encode_corpus, fit_aggregate_posterior, interpolate, lerp,
                                 optimize_from_smiles, optimize_z, sample_aggregate, slerp)
from molvax_torch.latent.optimize import default_objective
from test_torch_support import normal, paired

jinterp = importlib.import_module("molvax.latent.interpolate")  # the package's name is the function's
TOL = 2e-4  # the repo's fp32 parity tolerance
SMILES = synthetic_smiles(10, seed=11, max_len=18)
PROPS = dict(n_properties=3, property_mean=(2.5, 0.6, 3.0), property_std=(1.5, 0.2, 0.9))


def _close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def test_lerp_and_slerp_match_reference():
    z0, z1 = normal((1, 16), 0), normal((1, 16), 1)
    t = np.linspace(0.0, 1.0, 7, dtype=np.float32)[:, None]
    for port, ref in ((lerp, jinterp.lerp), (slerp, jinterp.slerp)):
        _close(port(torch.from_numpy(z0), torch.from_numpy(z1), torch.from_numpy(t)),
               ref(jnp.asarray(z0), jnp.asarray(z1), jnp.asarray(t)), 1e-5)
    # the endpoints, and a norm that moves linearly
    got = slerp(torch.from_numpy(z0), torch.from_numpy(z1), torch.from_numpy(t))
    _close(got[0], z0[0], 1e-5)
    _close(got[-1], z1[0], 1e-5)


@pytest.mark.parametrize("spherical,constrained", [(True, False), (False, False), (True, True)])
def test_interpolate_matches_reference(spherical, constrained):
    jcfg, tcfg, params, model = paired(seed=2, learned_start=True)
    ref = jinterp.interpolate(params, jcfg, SMILES[0], SMILES[1], steps=6, key=jax.random.key(0),
                              spherical=spherical, constrained=constrained)
    got = interpolate(model, tcfg, SMILES[0], SMILES[1], steps=6, spherical=spherical, constrained=constrained)
    assert got == ref and len(got) == 6


def test_optimize_z_matches_reference():
    """Gradient ascent of the de-normalized property 1 (and descent of 2)
    through the head, with the prior penalty: z, the final objective, the
    trajectory after each step and the objective at z0."""
    jcfg, tcfg, params, model = paired(seed=3, **PROPS)
    z0 = normal((5, jcfg.latent_dim), 4)
    for index, sign in ((1, 1.0), (2, -1.0)):
        ref = jopt.optimize_z(params, jcfg, jnp.asarray(z0), objective=jopt.default_objective(jcfg, index, sign),
                              steps=12, lr=0.05)
        got = optimize_z(model, tcfg, torch.from_numpy(z0), objective=default_objective(tcfg, index, sign), steps=12,
                         lr=0.05)
        for g, r in zip(got, ref):
            _close(g, r)
        assert got.trajectory.shape == (12, 5)
        assert (got.objective > got.objective_start).all()
    empty = optimize_z(model, tcfg, torch.from_numpy(z0), steps=0)
    assert empty.trajectory.shape == (0, 5) and torch.equal(empty.objective, empty.objective_start)
    assert all(p.grad is None for p in model.parameters())  # the model is not updated


@pytest.mark.parametrize("constrained", [False, True])
def test_optimize_from_smiles_matches_reference(constrained):
    jcfg, tcfg, params, model = paired(seed=5, learned_start=True, **PROPS)
    ref_strings, ref = jopt.optimize_from_smiles(params, jcfg, SMILES[:4], jax.random.key(0), steps=8,
                                                 constrained=constrained)
    got_strings, got = optimize_from_smiles(model, tcfg, SMILES[:4], steps=8, constrained=constrained)
    assert got_strings == ref_strings
    for g, r in zip(got, ref):
        _close(g, r)


def test_chunked_encode_matches_reference():
    """A tail chunk (10 rows in chunks of 4), the encode of a corpus, and
    empty input as (0, L) arrays."""
    jcfg, tcfg, params, model = paired(seed=6)
    codes = encode_smiles(SMILES, max_len=tcfg.max_len)
    mu, logvar = embed.encode_codes_chunked(model, tcfg, codes, batch=4)
    ref_mu, ref_lv = jembed.encode_codes_chunked(params, jcfg, codes, batch=4)
    assert mu.dtype == np.float32 and mu.shape == (10, tcfg.latent_dim)
    _close(mu, ref_mu)
    _close(logvar, ref_lv)
    c_mu, c_lv = encode_corpus(model, tcfg, SMILES, batch=3)
    _close(c_mu, ref_mu)
    _close(c_lv, ref_lv)
    e_mu, e_lv = embed.encode_codes_chunked(model, tcfg, codes[:0])
    assert e_mu.shape == e_lv.shape == (0, tcfg.latent_dim)


@pytest.mark.parametrize("mode", ["greedy", "constrained", "beam3", "beam3_constrained"])
def test_decode_latents_matches_reference(mode):
    jcfg, tcfg, params, model = paired(seed=7, learned_start=True)
    z = normal((6, jcfg.latent_dim), 8)
    kw = dict(constrained="constrained" in mode, beam=3 if "beam" in mode else 1)
    ref = jembed.decode_latents(params, jcfg, z, jax.random.key(0), batch=4, **kw)
    got = decode_latents(model, tcfg, z, batch=4, **kw)
    assert got == ref and len(got) == 6
    assert decode_latents(model, tcfg, torch.from_numpy(z), batch=4, **kw) == got
    with pytest.raises(ValueError, match="latents must be"):
        decode_latents(model, tcfg, z[:, :3])


def test_fit_aggregate_posterior_matches_reference():
    jcfg, tcfg, params, model = paired(seed=9, eps_scale=0.3)
    codes = encode_smiles(synthetic_smiles(40, seed=3, max_len=18), max_len=tcfg.max_len)
    mean, chol = fit_aggregate_posterior(model, tcfg, codes, batch=16, max_n=30)
    ref_mean, ref_chol = jsample.fit_aggregate_posterior(params, jcfg, codes, batch=16, max_n=30)
    assert mean.dtype == chol.dtype == torch.float32 and chol.shape == (16, 16)
    assert torch.equal(chol, torch.tril(chol))
    _close(mean, ref_mean)
    _close(chol, ref_chol, 1e-3)


def test_sample_aggregate_decodes_its_draw_as_the_reference_would():
    """The reference draws eps from jax.random, the port from its
    generator: the port's draw, recomputed from the same seed, is handed to
    the reference's decoder and gives the port's strings; and 20,000
    draws of z = mean + chol @ eps have mean ~ mean and covariance ~
    chol @ chol.T."""
    jcfg, tcfg, params, model = paired(seed=10, learned_start=True)
    codes = encode_smiles(synthetic_smiles(40, seed=3, max_len=18), max_len=tcfg.max_len)
    mean, chol = fit_aggregate_posterior(model, tcfg, codes, batch=16)
    got = sample_aggregate(model, tcfg, 6, torch.Generator().manual_seed(3), mean, chol)
    eps = torch.randn(6, tcfg.latent_dim, generator=torch.Generator().manual_seed(3))
    z = (mean[None, :] + eps @ chol.T).numpy()
    ref_codes, _ = jsample.generate(params, jcfg, jnp.asarray(z), jax.random.key(0), greedy=True)
    assert got == decode_codes(np.asarray(ref_codes))
    draws = mean[None, :] + torch.randn(20_000, tcfg.latent_dim, generator=torch.Generator().manual_seed(4)) @ chol.T
    cov = (chol @ chol.T).double()
    scale = cov.diagonal().sqrt()
    assert ((draws.double().mean(0) - mean.double()).abs() / scale).max() < 0.05
    assert ((torch.cov(draws.double().T) - cov).abs() / (scale[:, None] * scale[None, :])).max() < 0.05


def test_latents_npz_layout(tmp_path):
    """``molvax encode --out`` writes mu, logvar and smiles; ``molvax
    decode`` reads z, else mu, or a bare .npy array."""
    mu, logvar = normal((3, 4), 0), normal((3, 4), 1)
    path = str(tmp_path / "lat.npz")
    embed.save_latents(path, mu, logvar, ["CCO", "c1ccccc1", "N"])
    with np.load(path, allow_pickle=True) as f:
        assert sorted(f.files) == ["logvar", "mu", "smiles"]
        assert list(f["smiles"]) == ["CCO", "c1ccccc1", "N"]
    np.testing.assert_array_equal(embed.load_latents(path), mu)
    z = normal((3, 4), 2)
    np.savez(tmp_path / "z.npz", z=z, mu=mu)
    np.testing.assert_array_equal(embed.load_latents(str(tmp_path / "z.npz")), z)
    np.save(tmp_path / "z.npy", z)
    np.testing.assert_array_equal(embed.load_latents(str(tmp_path / "z.npy")), z)
    np.savez(tmp_path / "bad.npz", w=z)
    with pytest.raises(ValueError, match="expected a 'z' or 'mu'"):
        embed.load_latents(str(tmp_path / "bad.npz"))
