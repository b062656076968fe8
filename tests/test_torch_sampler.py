"""The fused sampler's plain version and backward against molvax.

The CUDA kernel runs only on a card (``chip_smoke.py`` holds it against the
plain version there). Its noise is a counter hash shared with the kernel,
not ``jax.random``'s stream, so eps is checked by its statistics; the KL
and the closed-form backward are checked against the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from molvax.kernels.sampler import _fs_bwd
from molvax.train.loss import gaussian_kl
from molvax_torch.kernels import sampler
from test_torch_support import normal

# fp32 on both sides: the repo's parity tolerance
FP32_TOL = 2e-4


def test_eps_is_standard_normal():
    """KS test of 2 x 256 x 292 draws against N(0, 1), and the moments."""
    eps = torch.cat([sampler.sample_eps(s, 256, 292, "cpu").reshape(-1) for s in (3, 4)]).double()
    assert torch.isfinite(eps).all()
    assert abs(eps.mean().item()) < 0.01 and abs(eps.std().item() - 1.0) < 0.01
    assert stats.kstest(eps.numpy()[::7], "norm").pvalue > 1e-4


def test_deterministic_per_seed_and_eps_scale():
    mu = torch.from_numpy(normal((8, 16), seed=0))
    lv = 0.3 * torch.from_numpy(normal((8, 16), seed=1))
    z1, kl1 = sampler.fused_sample_kl(5, mu, lv, 1.0)
    z2, _ = sampler.fused_sample_kl(5, mu, lv, 1.0)
    z3, _ = sampler.fused_sample_kl(6, mu, lv, 1.0)
    z_small, kl_small = sampler.fused_sample_kl(5, mu, lv, 1e-2)
    torch.testing.assert_close(z1, z2, atol=0, rtol=0)
    assert float((z1 == z3).float().mean()) < 0.01
    torch.testing.assert_close(z_small - mu, 1e-2 * (z1 - mu), atol=1e-7, rtol=1e-5)
    torch.testing.assert_close(kl_small, kl1, atol=0, rtol=0)
    assert torch.equal(sampler.fused_sample_kl(5, mu, lv, 0.0)[0], mu)


def test_wrapper_takes_plain_version_on_cpu():
    mu = torch.from_numpy(normal((4, 12), seed=2))
    lv = torch.from_numpy(normal((4, 12), seed=3))
    before = sampler.launches
    got = sampler.fused_sample_kl(9, mu, lv, 0.5)
    want = sampler.fused_sample_kl_ref(9, mu, lv, 0.5)
    assert sampler.launches == before
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_kl_matches_reference():
    mu = normal((16, 24), seed=4)
    lv = 0.5 * normal((16, 24), seed=5)
    _, kl = sampler.fused_sample_kl(1, torch.from_numpy(mu), torch.from_numpy(lv))
    ref = np.asarray(gaussian_kl(jnp.asarray(mu), jnp.asarray(lv)))
    np.testing.assert_allclose(kl.numpy(), ref, atol=FP32_TOL, rtol=FP32_TOL)


def test_backward_matches_reference_closed_form():
    """The autograd.Function's backward against the reference's _fs_bwd on
    the same (z, mu, logvar) and cotangents."""
    mu = torch.from_numpy(normal((8, 10), seed=6)).requires_grad_(True)
    lv = (0.3 * torch.from_numpy(normal((8, 10), seed=7))).requires_grad_(True)
    g_z, g_kl = normal((8, 10), seed=8), normal((8,), seed=9)
    z, kl = sampler.fused_sample_kl(2, mu, lv, 0.7)
    d_mu, d_lv = torch.autograd.grad((z, kl), (mu, lv), (torch.from_numpy(g_z), torch.from_numpy(g_kl)))
    _, r_mu, r_lv = _fs_bwd(
        0.7, (jnp.asarray(z.detach().numpy()), jnp.asarray(mu.detach().numpy()), jnp.asarray(lv.detach().numpy())),
        (jnp.asarray(g_z), jnp.asarray(g_kl)),
    )
    np.testing.assert_allclose(d_mu.numpy(), np.asarray(r_mu), atol=FP32_TOL, rtol=FP32_TOL)
    np.testing.assert_allclose(d_lv.numpy(), np.asarray(r_lv), atol=FP32_TOL, rtol=FP32_TOL)
    # autograd of the plain version gives the same closed form
    p_mu, p_lv = torch.autograd.grad(
        sampler.fused_sample_kl_ref(2, mu, lv, 0.7), (mu, lv), (torch.from_numpy(g_z), torch.from_numpy(g_kl))
    )
    torch.testing.assert_close(p_mu, d_mu, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(p_lv, d_lv, atol=1e-6, rtol=1e-5)


def test_kernel_wrapper_never_falls_back_off_the_cpu():
    mu = torch.empty(2, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sampler.fused_sample_kl(0, mu, mu)
