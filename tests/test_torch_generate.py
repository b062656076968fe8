"""Free-running generation in the port against molvax, on the CPU.

The CUDA kernel itself runs only on a card (``chip_smoke.py`` holds it
against ``fused_generate_ref`` there). Here: the kernel's plain version
against the reference's Pallas kernel in interpret mode, the fp32 scan path
against the reference scan, the sampling noise by its statistics, and the
routing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from molvax.kernels.generate import fused_generate as j_fused_generate
from molvax.latent.sample import generate as j_generate
from molvax.nn.decoder import latent_embed as j_latent_embed
from molvax_torch.kernels import generate as kg
from molvax_torch.latent.sample import generate
from molvax_torch.nn.decoder import latent_embed
from test_torch_support import configs, normal, paired

# a code the plain version chose differently from the reference must still
# score within this of the maximum: bf16 operands are rounded from h values
# that differ by fp32 summation order, and a near-tie flips
MARGIN = 1e-3
# fp32 scan on both sides: the repo's parity tolerance
FP32_TOL = 2e-4


def _first_diff_within_margin(model, z_emb, ref_codes, got_codes):
    """Where the codes differ, at each row's first differing step the
    reference's choice scores within MARGIN of the plain maximum (after the
    shared prefix, both decoders saw identical histories)."""
    _, scores = kg.fused_generate_ref(
        model, model.cfg, z_emb, force_codes=torch.from_numpy(ref_codes), return_scores=True
    )
    for b in range(ref_codes.shape[0]):
        diff = np.nonzero(ref_codes[b] != got_codes[b])[0]
        if diff.size:
            t = diff[0]
            s = scores[b, t].numpy()
            assert s.max() - s[ref_codes[b, t]] <= MARGIN, (b, t, s.max() - s[ref_codes[b, t]])


@pytest.mark.parametrize("learned_start", [False, True])
def test_plain_kernel_version_matches_pallas_kernel(learned_start):
    """fused_generate_ref (bf16 operands, fp32 sums) against the reference's
    fused_generate, run in interpret mode on the CPU as its own tests do."""
    jcfg, tcfg, params, model = paired(learned_start=learned_start, compute_dtype="bfloat16")
    z = normal((8, jcfg.latent_dim), seed=1)
    z_emb = np.array(j_latent_embed(params["decoder"], jcfg, jnp.asarray(z)))
    ref = np.array(
        j_fused_generate(params["decoder"], jcfg, jnp.asarray(z_emb), jax.random.key(0), True, 1.0)
    )
    got = kg.fused_generate_ref(model, model.cfg, torch.from_numpy(z_emb)).numpy()
    assert got.shape == ref.shape == (8, jcfg.max_len)
    agree = float(np.mean(got == ref))
    assert agree >= 0.97, agree
    _first_diff_within_margin(model, torch.from_numpy(z_emb), ref, got)


@pytest.mark.parametrize("learned_start", [False, True])
def test_scan_path_matches_reference_scan(learned_start):
    jcfg, tcfg, params, model = paired(learned_start=learned_start)
    z = normal((6, jcfg.latent_dim), seed=2)
    codes_j, logits_j = j_generate(params, jcfg, jnp.asarray(z), jax.random.key(0), greedy=True)
    codes_t, logits_t = generate(model, tcfg, torch.from_numpy(z), greedy=True)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=FP32_TOL, rtol=FP32_TOL)


# -- sampling noise ------------------------------------------------------------


def _mix32_py(x):
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    return x ^ (x >> 16)


def _bits_py(seed, t, row, cls):
    h = _mix32_py(seed & 0xFFFFFFFF)
    h = _mix32_py((h + row) & 0xFFFFFFFF)
    h = _mix32_py((h + t) & 0xFFFFFFFF)
    return _mix32_py((h + cls) & 0xFFFFFFFF)


def test_noise_bits_match_python_integers():
    """The torch emulation of 32-bit multiplies (16-bit halves in int64)
    against Python's unbounded integers, seeds up to 2**32 - 1."""
    rows = torch.arange(0, 300, 37, dtype=torch.int64)[:, None]
    cls = torch.arange(37, dtype=torch.int64)[None, :]
    for seed, t in ((0, 0), (1, 119), (0xFFFFFFFF, 7), (123456789, 64)):
        got = kg.noise_bits(seed, t, rows, cls).numpy()
        want = np.array([[_bits_py(seed, t, int(r), int(c)) for c in cls[0]] for r in rows[:, 0]])
        np.testing.assert_array_equal(got, want)


def test_noise_is_deterministic_per_seed_and_differs_across_seeds():
    a = kg.gumbel_noise(5, 3, 64, 37, "cpu")
    np.testing.assert_array_equal(a.numpy(), kg.gumbel_noise(5, 3, 64, 37, "cpu").numpy())
    for other in (kg.gumbel_noise(6, 3, 64, 37, "cpu"), kg.gumbel_noise(5, 4, 64, 37, "cpu")):
        assert float((a == other).float().mean()) < 0.01


def test_gumbel_moments():
    """Gumbel(0, 1): mean = Euler's gamma, variance = pi**2 / 6. 4096 x 64
    draws put the standard error of the mean near 2e-3."""
    g = torch.cat([kg.gumbel_noise(s, 0, 4096, 64, "cpu").reshape(-1) for s in range(2)]).double()
    assert torch.isfinite(g).all()
    assert abs(g.mean().item() - np.euler_gamma) < 0.01
    assert abs(g.var().item() - np.pi**2 / 6) < 0.03
    u = torch.exp(-torch.exp(-g))  # the Gumbel CDF maps the draws back to U(0, 1)
    assert stats.kstest(u.numpy()[:20000], "uniform").pvalue > 1e-4


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_step0_frequencies_follow_softmax(temperature):
    """Step-0 codes of rows that share one z follow softmax(logits_0 / T),
    with logits_0 from the reference's scan: chi-square over classes with an
    expected count of at least 5 (the rest pooled), p > 1e-4."""
    jcfg, tcfg, params, model = paired(learned_start=True)
    # a sharper output head than the init's, so softmax is far from uniform
    out = params["decoder"]["linear_out"]
    params["decoder"]["linear_out"] = {"w": out["w"] * 20, "b": out["b"] * 20}
    with torch.no_grad():
        model.linear_4.weight.mul_(20)
        model.linear_4.bias.mul_(20)
    z = normal((1, jcfg.latent_dim), seed=7)
    _, logits_j = j_generate(params, jcfg, jnp.asarray(z), jax.random.key(0), greedy=True)
    p = np.asarray(jax.nn.softmax(np.asarray(logits_j)[0, 0] / temperature)).astype(np.float64)
    n = 6000
    zz = torch.from_numpy(np.repeat(z, n // 3, axis=0))
    counts = np.zeros(jcfg.charset_size)
    for seed in range(3):
        codes, _ = generate(
            model, dataclasses.replace(tcfg, max_len=1), zz,
            torch.Generator().manual_seed(seed), greedy=False, temperature=temperature,
        )
        counts += np.bincount(codes[:, 0].numpy(), minlength=jcfg.charset_size)
    expected = n * p / p.sum()
    # classes expected fewer than 5 times are pooled into the smallest
    # class that is expected at least 5 times
    order = np.argsort(expected)[::-1]
    keep = order[expected[order] >= 5]
    rest = np.setdiff1d(np.arange(jcfg.charset_size), keep)
    obs, exp = counts[keep].copy(), expected[keep].copy()
    obs[-1] += counts[rest].sum()
    exp[-1] += expected[rest].sum()
    assert stats.chisquare(obs, exp).pvalue > 1e-4


def test_small_temperature_reproduces_greedy():
    jcfg, tcfg, params, model = paired(learned_start=True, compute_dtype="bfloat16")
    z = torch.from_numpy(normal((6, jcfg.latent_dim), seed=8))
    greedy, _ = generate(model, tcfg, z, greedy=True)
    sampled, _ = generate(model, tcfg, z, greedy=False, temperature=1e-7)
    np.testing.assert_array_equal(sampled.numpy(), greedy.numpy())
    z_emb = latent_embed(model, tcfg, z)
    np.testing.assert_array_equal(
        kg.fused_generate_ref(model, model.cfg, z_emb, 9, greedy=False, temperature=1e-7).numpy(),
        kg.fused_generate_ref(model, model.cfg, z_emb).numpy(),
    )


# -- routing -------------------------------------------------------------------


def test_wrapper_takes_plain_version_on_cpu():
    _, tcfg, _, model = paired(learned_start=True, compute_dtype="bfloat16")
    z_emb = latent_embed(model, tcfg, torch.from_numpy(normal((4, tcfg.latent_dim), seed=5)))
    before = kg.launches
    for greedy in (True, False):
        got = kg.fused_generate(model, model.cfg, z_emb, 3, greedy=greedy, temperature=0.8)
        want = kg.fused_generate_ref(model, model.cfg, z_emb, 3, greedy=greedy, temperature=0.8)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        assert got.dtype == torch.int32 and got.shape == (4, tcfg.max_len)
    assert kg.launches == before


def test_wrapper_never_falls_back_off_the_cpu():
    _, tcfg, _, model = paired()
    with pytest.raises(ValueError, match="unsupported device"):
        kg.fused_generate(model, model.cfg, torch.empty(2, tcfg.latent_dim, device="meta"))


def test_generate_on_cpu_takes_the_scan():
    _, tcfg, _, model = paired(compute_dtype="bfloat16", use_pallas_generation=True)
    before = kg.launches
    codes, logits = generate(model, tcfg, torch.from_numpy(normal((3, tcfg.latent_dim), seed=6)))
    assert logits is not None and logits.shape == (3, tcfg.max_len, tcfg.charset_size)
    assert kg.launches == before


def test_kernel_route_conditions():
    from molvax_torch.config import get_preset

    bf16 = configs(compute_dtype="bfloat16")[1]
    assert kg.generation_kernel_supported(bf16, "cuda")
    assert not kg.generation_kernel_supported(bf16, "cpu")
    assert not kg.generation_kernel_supported(dataclasses.replace(bf16, compute_dtype="float32"), "cuda")
    assert not kg.generation_kernel_supported(
        dataclasses.replace(bf16, decoder_conditioning="repeat_z"), "cuda"
    )
    # no TPU batch or VMEM limits: the scaled preset takes the kernel on a card
    assert kg.generation_kernel_supported(get_preset("moses_scaled").model, "cuda")
    assert kg.generation_kernel_supported(get_preset("zinc250k").model, "cuda")


def test_unported_options_raise():
    """Constrained decoding is not ported: it raises for both conditionings
    ('repeat_z' decoders themselves now decode, see below)."""
    _, tcfg, _, model = paired()
    z = torch.zeros(2, tcfg.latent_dim)
    with pytest.raises(NotImplementedError, match="Constrained decoding"):
        generate(model, tcfg, z, constrained=True)
    rz = dataclasses.replace(tcfg, decoder_conditioning="repeat_z")
    with pytest.raises(NotImplementedError, match="Constrained decoding"):
        generate(model, rz, z, constrained=True)


def test_repeat_z_greedy_matches_reference():
    """A 'repeat_z' decoder decodes in one non-autoregressive pass: greedy
    codes and logits against the reference's generate, fp32."""
    jcfg, tcfg, params, model = paired(decoder_conditioning="repeat_z")
    z = normal((5, jcfg.latent_dim), seed=13)
    codes_j, logits_j = j_generate(params, jcfg, jnp.asarray(z), jax.random.key(0), greedy=True)
    codes_t, logits_t = generate(model, tcfg, torch.from_numpy(z), greedy=True)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=FP32_TOL, rtol=FP32_TOL)
    # sampled: Gumbel-max over the same logits, seeded by the generator
    a, _ = generate(model, tcfg, torch.from_numpy(z), torch.Generator().manual_seed(3), greedy=False)
    b, _ = generate(model, tcfg, torch.from_numpy(z), torch.Generator().manual_seed(3), greedy=False)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert a.dtype == torch.int32 and a.shape == codes_t.shape
