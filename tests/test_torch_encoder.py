"""The port's encoder, latent embedding and featurizer against molvax's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molvax.data import DEFAULT_CHARSET, encode_smiles as j_encode_smiles, synthetic_smiles
from molvax.data.featurize import decode_codes as j_decode_codes, one_hot as j_one_hot
from molvax.nn import vae as jvae
from molvax.nn.decoder import latent_embed as j_latent_embed
from molvax_torch.data.featurize import decode_codes, encode_smiles, one_hot
from molvax_torch.nn import encoder as tenc
from molvax_torch.nn.decoder import latent_embed
from molvax_torch.nn.vae import encode
from test_torch_support import configs, normal, paired

# fp32 on both sides: the repo's parity tolerance
# (tests/parity/test_torch_parity.py:30), sums taken in another order
FP32_TOL = 2e-4
# bf16 operands on both sides, exact products, fp32 sums in another order:
# a sum that lands next to a bf16 rounding boundary can round the other way
# in one package, moving that activation by one bf16 step (2**-8 relative)
BF16_TOL = 2e-3


def _codes(cfg, n=6, seed=0):
    return j_encode_smiles(
        synthetic_smiles(n, seed=seed, max_len=cfg.max_len - 2), DEFAULT_CHARSET, cfg.max_len
    )


@pytest.mark.parametrize("orientation", ["seq", "charset"])
def test_encode_fp32_matches_reference(orientation):
    jcfg, tcfg, params, model = paired(conv_orientation=orientation)
    codes = _codes(jcfg)
    mu_j, lv_j = jvae.encode(params, jcfg, jnp.asarray(codes))
    with torch.no_grad():
        mu_t, lv_t = encode(model, tcfg, torch.from_numpy(codes))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=FP32_TOL, rtol=FP32_TOL)
    np.testing.assert_allclose(lv_t.numpy(), np.asarray(lv_j), atol=FP32_TOL, rtol=FP32_TOL)


@pytest.mark.parametrize("orientation", ["seq", "charset"])
def test_encode_bf16_matches_reference(orientation):
    jcfg, tcfg, params, model = paired(conv_orientation=orientation, compute_dtype="bfloat16")
    codes = _codes(jcfg, seed=1)
    mu_j, lv_j = jvae.encode(params, jcfg, jnp.asarray(codes))
    with torch.no_grad():
        mu_t, lv_t = model.encode(torch.from_numpy(codes))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=BF16_TOL, rtol=BF16_TOL)
    np.testing.assert_allclose(lv_t.numpy(), np.asarray(lv_j), atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("dtype,tol", [("float32", FP32_TOL), ("bfloat16", BF16_TOL)])
def test_latent_embed_matches_reference(dtype, tol):
    jcfg, tcfg, params, model = paired(compute_dtype=dtype)
    z = normal((5, jcfg.latent_dim), seed=3)
    ref = j_latent_embed(params["decoder"], jcfg, jnp.asarray(z))
    with torch.no_grad():
        got = latent_embed(model, tcfg, torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol, rtol=tol)


def test_auto_dtype_is_bf16_on_cuda_only():
    from molvax_torch.utils import matmul_dtype

    _, tcfg = configs(compute_dtype="auto")
    assert matmul_dtype(tcfg, "cpu") == torch.float32
    assert matmul_dtype(tcfg, "cuda") == torch.bfloat16


def test_conv_shapes_and_overconsumed_axis():
    jcfg, tcfg = configs()
    from molvax.nn.encoder import conv_spatial_len, flat_conv_dim

    assert tenc.conv_spatial_len(tcfg) == conv_spatial_len(jcfg)
    assert tenc.flat_conv_dim(tcfg) == flat_conv_dim(jcfg)
    _, short = configs(max_len=12)
    with pytest.raises(ValueError, match="consumes the whole axis"):
        tenc.conv_spatial_len(short)


def test_featurizer_matches_reference():
    smiles = synthetic_smiles(8, seed=4, max_len=30) + ["CC(=O)Nc1ccc(O)cc1", ""]
    codes = encode_smiles(smiles, max_len=32)
    np.testing.assert_array_equal(codes, j_encode_smiles(smiles, DEFAULT_CHARSET, 32))
    assert decode_codes(torch.from_numpy(codes)) == j_decode_codes(codes) == smiles
    oh = one_hot(torch.from_numpy(codes), DEFAULT_CHARSET.size)
    np.testing.assert_array_equal(oh.numpy(), np.asarray(j_one_hot(jnp.asarray(codes), 37)))
    with pytest.raises(ValueError, match="not in charset"):
        encode_smiles(["CCx"])
    with pytest.raises(ValueError, match="longer than max_len"):
        encode_smiles(["C" * 10], max_len=4)
