"""The fused encoder's plain version against molvax's Pallas kernel.

The CUDA kernel runs only on a card (``chip_smoke.py`` holds it against the
plain version there). Here the wrapper takes the plain version, because
the codes lie on the CPU; it is checked against the reference's
``fused_encode`` in interpret mode, forward and gradient, and the strict
fp32 conv is checked to run with TF32 off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molvax.data import DEFAULT_CHARSET, encode_smiles, synthetic_smiles
from molvax.kernels.conv_enc import fused_encode as j_fused_encode
from molvax_torch.kernels import conv_enc
from molvax_torch.nn import encoder as tenc
from molvax_torch.nn.encoder import encoder_params
from test_torch_support import normal, paired

# bf16 operands on both sides, exact products, fp32 sums in another order:
# a sum next to a bf16 rounding boundary can round the other way between
# stages, moving that activation by one bf16 step (2**-8 relative)
BF16_TOL = 2e-3
# relative (norm, and elementwise against the largest element) for the
# conv-weight gradients; see test_gradient_matches_reference_vjp
CONV_GRAD_TOL = 2e-2


def _codes(cfg, n=6, seed=0):
    return encode_smiles(
        synthetic_smiles(n, seed=seed, max_len=cfg.max_len - 2), DEFAULT_CHARSET, cfg.max_len
    )


@pytest.mark.parametrize("orientation", ["seq", "charset"])
def test_plain_version_matches_pallas_kernel(orientation):
    jcfg, tcfg, params, model = paired(conv_orientation=orientation, compute_dtype="bfloat16")
    codes = _codes(jcfg)
    mu_j, lv_j = j_fused_encode(params["encoder"], jcfg, jnp.asarray(codes))
    before = conv_enc.launches
    with torch.no_grad():
        mu_t, lv_t = conv_enc.fused_encode(model, tcfg, torch.from_numpy(codes))
        mu_r, lv_r = conv_enc.fused_encode_ref(model, tcfg, torch.from_numpy(codes))
    assert conv_enc.launches == before
    torch.testing.assert_close(mu_t, mu_r, atol=0, rtol=0)
    torch.testing.assert_close(lv_t, lv_r, atol=0, rtol=0)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=BF16_TOL, rtol=BF16_TOL)
    np.testing.assert_allclose(lv_t.numpy(), np.asarray(lv_j), atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("orientation", ["seq", "charset"])
def test_gradient_matches_reference_vjp(orientation):
    """The autograd.Function's backward (autograd of the plain encoder)
    against jax.vjp of the reference kernel (the VJP of its plain encoder).
    Both round the cotangent to bf16 where the forward rounds to bf16."""
    jcfg, tcfg, params, model = paired(conv_orientation=orientation, compute_dtype="bfloat16")
    codes = _codes(jcfg, seed=2)
    g_mu = normal((codes.shape[0], jcfg.latent_dim), seed=3)
    g_lv = normal((codes.shape[0], jcfg.latent_dim), seed=4)
    _, vjp = jax.vjp(lambda p: j_fused_encode(p, jcfg, jnp.asarray(codes)), params["encoder"])
    (g_j,) = vjp((jnp.asarray(g_mu), jnp.asarray(g_lv)))
    mu, lv = conv_enc.fused_encode(model, tcfg, torch.from_numpy(codes))
    grads = torch.autograd.grad((mu, lv), encoder_params(model), (torch.from_numpy(g_mu), torch.from_numpy(g_lv)))
    want = []
    for c in g_j["convs"]:
        want += [np.asarray(c["w"]), np.asarray(c["b"])]
    for key in ("linear_0", "linear_mu", "linear_logvar"):
        want += [np.asarray(g_j[key]["w"]).T, np.asarray(g_j[key]["b"])]
    assert len(grads) == len(want)
    n_conv = len(jcfg.conv_channels)
    for i, (got, ref) in enumerate(zip(grads, want)):
        got = got.numpy()
        rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        scale = float(np.abs(ref).max())
        if i < 2 * n_conv:
            # the conv cotangents pass through bf16 casts in both packages,
            # and JAX also sums each conv's patch cotangents (K shifted
            # windows) in bf16, one rounding per add: a few bf16 steps
            # (2**-8 each), compounded over three stages
            assert rel <= CONV_GRAD_TOL, (i, rel)
            np.testing.assert_allclose(got, ref, atol=CONV_GRAD_TOL * scale, rtol=0, err_msg=str(i))
        else:
            # dense and heads: the same bf16-rounded cotangents, fp32 sums
            assert rel <= 1e-5, (i, rel)


def test_kernel_wrapper_never_falls_back_off_the_cpu():
    _, tcfg, _, model = paired(compute_dtype="bfloat16")
    codes = torch.zeros(2, tcfg.max_len, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv_enc._encode_kernel(tcfg, codes, encoder_params(model))


@pytest.mark.parametrize("dtype,tf32_at_conv", [("float32", False), ("bfloat16", True)])
def test_fp32_conv_turns_tf32_off_for_the_call(monkeypatch, dtype, tf32_at_conv):
    """A strict-fp32 conv runs with cuDNN's TF32 switched off, for that call
    only; a bf16 conv (exact in TF32) leaves the global flag alone."""
    seen = []
    real = tenc.F.conv1d

    def spy(*args, **kw):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled))
        return real(*args, **kw)

    monkeypatch.setattr(tenc.F, "conv1d", spy)
    _, tcfg, _, model = paired(compute_dtype=dtype)
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled)
    with torch.no_grad():
        model.encode(torch.from_numpy(_codes(tcfg, n=2)))
    assert seen and all(s == (tf32_at_conv, True) for s in seen)
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled) == before
