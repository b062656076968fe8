"""The training forward in the port against molvax, on the CPU: teacher
inputs, decode and vae.forward over the lineage flags, the scheduled-
sampling and word-dropout masks where they are deterministic, and the
property head."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molvax.data import DEFAULT_CHARSET, encode_smiles, synthetic_smiles
from molvax.nn import property_head as jph
from molvax.nn import vae as jvae
from molvax.nn.decoder import teacher_inputs as j_teacher_inputs
from molvax_torch.nn import property_head as tph
from molvax_torch.nn import vae as tvae
from molvax_torch.nn.decoder import teacher_inputs
from test_torch_support import normal, paired

# fp32 on both sides: the repo's parity tolerance
# (tests/parity/test_torch_parity.py:30), sums taken in another order
FP32_TOL = 2e-4

GRID = [
    (o, c, s)
    for o in ("seq", "charset")
    for c in ("teacher_forced", "repeat_z")
    for s in (False, True)
]


def _codes(cfg, n=5, seed=0):
    return encode_smiles(
        synthetic_smiles(n, seed=seed, max_len=cfg.max_len - 2), DEFAULT_CHARSET, cfg.max_len
    )


def _close(got, want, tol=FP32_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("with_start", [False, True])
def test_teacher_inputs_match_reference(with_start):
    jcfg, tcfg, _, _ = paired()
    z_emb = normal((3, jcfg.latent_dim), seed=1)
    x = np.eye(jcfg.charset_size, dtype=np.float32)[_codes(jcfg, n=3).astype(np.int64)]
    start = normal((jcfg.charset_size,), seed=2) if with_start else None
    want = j_teacher_inputs(jcfg, jnp.asarray(z_emb), jnp.asarray(x), None if start is None else jnp.asarray(start))
    got = teacher_inputs(
        tcfg, torch.from_numpy(z_emb), torch.from_numpy(x), None if start is None else torch.from_numpy(start)
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("orientation,conditioning,learned_start", GRID)
def test_decode_matches_reference(orientation, conditioning, learned_start):
    jcfg, tcfg, params, model = paired(
        conv_orientation=orientation, decoder_conditioning=conditioning, learned_start=learned_start
    )
    z = normal((4, jcfg.latent_dim), seed=3)
    codes = _codes(jcfg, n=4, seed=4)
    teacher = codes if conditioning == "teacher_forced" else None
    want = jvae.decode(params, jcfg, jnp.asarray(z), None if teacher is None else jnp.asarray(teacher))
    with torch.no_grad():
        got = tvae.decode(model, tcfg, torch.from_numpy(z), None if teacher is None else torch.from_numpy(teacher))
    assert got.shape == (4, jcfg.max_len, jcfg.charset_size)
    _close(got, want)


@pytest.mark.parametrize("orientation,conditioning,learned_start", GRID)
def test_forward_matches_reference(orientation, conditioning, learned_start):
    jcfg, tcfg, params, model = paired(
        conv_orientation=orientation, decoder_conditioning=conditioning,
        learned_start=learned_start, eps_scale=0.0,
    )
    codes = _codes(jcfg, seed=5)
    want = jvae.forward(params, jcfg, jax.random.key(0), jnp.asarray(codes))
    with torch.no_grad():
        got = tvae.forward(model, tcfg, 7, torch.from_numpy(codes))
    for name in ("logits", "mu", "logvar", "z"):
        _close(getattr(got, name), getattr(want, name))
    assert got.kl is None and got.properties is None


def test_forward_with_property_head_matches_reference():
    jcfg, tcfg, params, model = paired(n_properties=3, eps_scale=0.0, learned_start=True)
    codes = _codes(jcfg, seed=6)
    want = jvae.forward(params, jcfg, jax.random.key(0), jnp.asarray(codes))
    with torch.no_grad():
        got = tvae.forward(model, tcfg, 0, torch.from_numpy(codes))
    _close(got.properties, want.properties)
    _close(got.logits, want.logits)


@pytest.mark.parametrize("kind", ["ss", "wd"])
@pytest.mark.parametrize("p", [0.0, 1.0])
def test_masks_at_zero_and_one_match_reference(kind, p):
    """At p = 0 and p = 1 the Bernoulli masks are deterministic in both
    packages, whatever their random streams."""
    jcfg, tcfg, params, model = paired(learned_start=True, eps_scale=0.0)
    codes = _codes(jcfg, seed=8)
    kw = {"ss_prob": p} if kind == "ss" else {"wd_prob": p}
    want = jvae.forward(
        params, jcfg, jax.random.key(1), jnp.asarray(codes), **{k: jnp.float32(v) for k, v in kw.items()}
    )
    with torch.no_grad():
        got = tvae.forward(model, tcfg, 3, torch.from_numpy(codes), **kw)
        plain = tvae.forward(model, tcfg, 3, torch.from_numpy(codes))
    _close(got.logits, want.logits)
    if p == 0.0:  # the mask keeps every teacher input
        torch.testing.assert_close(got.logits, plain.logits, atol=0, rtol=0)


def test_bernoulli_mask_rate_and_determinism():
    m = tvae.bernoulli_mask(11, 0x5C4ED, 0.25, (64, 120), "cpu")
    assert m.dtype == torch.bool and m.shape == (64, 120)
    assert abs(m.float().mean().item() - 0.25) < 0.02
    assert torch.equal(m, tvae.bernoulli_mask(11, 0x5C4ED, 0.25, (64, 120), "cpu"))
    assert not torch.equal(m, tvae.bernoulli_mask(12, 0x5C4ED, 0.25, (64, 120), "cpu"))
    assert tvae.bernoulli_mask(11, 1, 1.0, (4, 5), "cpu").all()
    assert not tvae.bernoulli_mask(11, 1, 0.0, (4, 5), "cpu").any()


def test_property_head_matches_reference():
    jcfg, tcfg, params, model = paired(n_properties=3)
    z = normal((6, jcfg.latent_dim), seed=9)
    want = jph.predict_properties(params["property_head"], jcfg, jnp.asarray(z))
    with torch.no_grad():
        got = tph.predict_properties(model, tcfg, torch.from_numpy(z))
    _close(got, want)
    stats = dict(property_mean=(1.0, -2.0, 0.5), property_std=(2.0, 0.5, 4.0))
    jc, tc = dataclasses.replace(jcfg, **stats), dataclasses.replace(tcfg, **stats)
    y = normal((6, 3), seed=10)
    _close(tph.normalize_targets(tc, torch.from_numpy(y)), jph.normalize_targets(jc, jnp.asarray(y)))
    _close(tph.denormalize_properties(tc, torch.from_numpy(y)), jph.denormalize_properties(jc, jnp.asarray(y)))
    # without stats both are the identity
    assert tph.normalize_targets(tcfg, torch.from_numpy(y)).numpy().tolist() == y.tolist()
    assert tph.denormalize_properties(tcfg, torch.from_numpy(y)).numpy().tolist() == y.tolist()


def test_teacher_forced_decode_needs_teacher():
    _, tcfg, _, model = paired()
    with pytest.raises(ValueError, match="teacher_onehot"):
        tvae.decode(model, tcfg, torch.zeros(2, tcfg.latent_dim))
