"""The port's design probes against the reference's, on the CPU.

The reference's probes under ``bench/`` hold four functions that reach
``pl.pallas_call``: ``gru_experiments.run_variant`` (``_kernel_variant``, two
modes) and ``run_fused3`` (``_fused3_kernel``), ``proto_gi_kernel.fwd_gi``
and ``auto_loop_probe.floor_loop``. Their CUDA counterparts run only on a
card (``chip_smoke.py`` phase 19 holds them against their plain versions
there). Here the plain versions against the Pallas kernel bodies, run in
interpret mode as the reference's own tests run its kernels on the CPU. The
tests build the ``pallas_call`` as ``run_variant`` / ``run_fused3`` do,
at a small size; the module globals the bodies read (``Hp``, ``L``) are set
with ``monkeypatch``, never by editing ``bench/``.

Tolerance: the bf16 gate of the reference's kernels (err_max 3.91e-3). Both
sides round where the kernels round (bf16 h operand, fp32 sums, bf16 hseq),
so only the fp32 summation order differs, and a sum next to a rounding
boundary rounds one bf16 ulp the other way. Measured at these sizes: 1.5e-5
(matmul_only), 2.4e-4 (gates_nostore) and 9.8e-4 (fused3, 3 layers), each
at under 0.03% of the elements; ``fwd_gi`` exact (0.0); ``floor_loop`` is
integer and exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import bench.auto_loop_probe as jprobe_auto
import bench.gru_experiments as jprobe_gru
import bench.proto_gi_kernel as jprobe_gi
from molvax_torch.kernels import floor as kfloor
from molvax_torch.kernels import gru as kgru
from molvax_torch.kernels import gru_stack as ks
from molvax_torch.probes import auto_loop_probe as al
from molvax_torch.probes import gru_experiments as ge
from molvax_torch.probes import proto_gi_kernel as pg
from test_torch_support import normal

BF16_TOL = 3.91e-3  # the reference's on-chip gate for its GRU kernels
# run_variant's grid at a small size: Hp = H (no padding), two batch
# blocks, two time blocks
HP, B, B_BLK, T, K = 128, 16, 8, 16, 8


def _uniform(shape, seed, scale):
    return np.random.default_rng(seed).uniform(-scale, scale, shape).astype(np.float32)


def _variant_inputs():
    """gi (T, B, 3H) bf16 values, JAX-layout W (H, 3H), b (3H), h0 (B, H):
    nonzero bias and h0 (with zeros matmul_only is identically 0)."""
    gi = (0.5 * normal((T, B, 3 * HP), seed=11)).astype(jnp.bfloat16).astype(np.float32)
    w = _uniform((HP, 3 * HP), 12, 1 / np.sqrt(HP))
    b = _uniform((3 * HP,), 13, 1 / np.sqrt(HP))
    h0 = 0.5 * normal((B, HP), seed=14)
    return gi, w, b, h0


def _run_variant(mode, gi, w, b, h0):
    """``run_variant``'s pallas_call, interpret mode, at the module's sizes."""
    Gp = 3 * HP
    call = pl.pallas_call(
        functools.partial(jprobe_gru._kernel_variant, mode=mode),
        grid=(B // B_BLK, T // K),
        in_specs=[
            pl.BlockSpec((K, B_BLK, Gp), lambda bb, t: (t, bb, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((HP, Gp), lambda bb, t: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, Gp), lambda bb, t: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((B_BLK, HP), lambda bb, t: (bb, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((K, B_BLK, HP), lambda bb, t: (t, bb, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((T, B, HP), jnp.bfloat16),
        scratch_shapes=[pltpu.VMEM((B_BLK, HP), jnp.float32)],
        interpret=True,
    )
    out = call(jnp.asarray(gi, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), jnp.asarray(b)[None, :],
               jnp.asarray(h0))
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("mode", ["matmul_only", "gates_nostore"])
def test_probe_scan_matches_run_variant(monkeypatch, mode):
    monkeypatch.setattr(jprobe_gru, "Hp", HP)
    gi, w, b, h0 = _variant_inputs()
    want = _run_variant(mode, gi, w, b, h0)
    got = kgru.gru_probe_scan_ref(*map(torch.from_numpy, (gi, w.T.copy(), b, h0)), mode)
    assert got.dtype == torch.bfloat16 and got.shape == (T, B, HP)
    assert np.abs(want).max() > 0.1  # nonzero h0 and bias: the probe is not all zeros
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL, rtol=0)


def test_gates_nostore_is_the_production_forward():
    """'gates_nostore' stores exactly the h of gru_layer_scan's forward."""
    gi, w, b, h0 = map(torch.from_numpy, _variant_inputs())
    probe = kgru.gru_probe_scan_ref(gi, w.T, b, h0, "gates_nostore")
    assert torch.equal(probe, kgru.scan_forward_ref(gi, w.T, b, h0)[0])


def _run_fused3(L, gi0, wih, bih, whh, bhh, h0):
    """``run_fused3``'s pallas_call, interpret mode; returns (hseq, htop)."""
    Gp = 3 * HP
    call = pl.pallas_call(
        jprobe_gru._fused3_kernel,
        grid=(B // B_BLK, T // K),
        in_specs=[
            pl.BlockSpec((K, B_BLK, Gp), lambda bb, t: (t, bb, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((L - 1, HP, Gp), lambda bb, t: (0, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((L - 1, 1, Gp), lambda bb, t: (0, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((L, HP, Gp), lambda bb, t: (0, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((L, 1, Gp), lambda bb, t: (0, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((L, B_BLK, HP), lambda bb, t: (0, bb, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=[
            pl.BlockSpec((L, K, B_BLK, HP), lambda bb, t: (0, t, bb, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((K, B_BLK, HP), lambda bb, t: (t, bb, 0), memory_space=pltpu.VMEM),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((L, T, B, HP), jnp.bfloat16),
            jax.ShapeDtypeStruct((T, B, HP), jnp.bfloat16),
        ],
        scratch_shapes=[
            pltpu.VMEM((L, B_BLK, HP), jnp.float32),
            pltpu.VMEM((L - 1, K, B_BLK, HP), jnp.bfloat16),
        ],
        interpret=True,
    )
    bf = jnp.bfloat16
    hseq, htop = call(jnp.asarray(gi0, bf), jnp.asarray(wih, bf), jnp.asarray(bih)[:, None, :],
                      jnp.asarray(whh, bf), jnp.asarray(bhh)[:, None, :], jnp.asarray(h0))
    return np.asarray(hseq.astype(jnp.float32)), np.asarray(htop.astype(jnp.float32))


def test_fused3_matches_run_fused3(monkeypatch):
    L = 3
    monkeypatch.setattr(jprobe_gru, "Hp", HP)
    monkeypatch.setattr(jprobe_gru, "L", L)
    s = 1 / np.sqrt(HP)
    gi0 = (0.5 * normal((T, B, 3 * HP), seed=21)).astype(jnp.bfloat16).astype(np.float32)
    wih = _uniform((L - 1, HP, 3 * HP), 22, s)
    bih = _uniform((L - 1, 3 * HP), 23, s)
    whh = _uniform((L, HP, 3 * HP), 24, s)
    bhh = _uniform((L, 3 * HP), 25, s)
    h0 = 0.5 * normal((L, B, HP), seed=26)
    hseq_j, htop_j = _run_fused3(L, gi0, wih, bih, whh, bhh, h0)
    # torch layout: (L-1, 3H, H) and (L, 3H, H)
    t_args = map(torch.from_numpy, (gi0, wih.transpose(0, 2, 1).copy(), bih,
                                    whh.transpose(0, 2, 1).copy(), bhh, h0))
    got = ks.gru_fused3_scan_ref(*t_args)
    assert got.dtype == torch.bfloat16 and got.shape == (L, T, B, HP)
    np.testing.assert_allclose(got.float().numpy(), hseq_j, atol=BF16_TOL, rtol=0)
    # the TPU's htop is a copy of the top layer's hseq
    np.testing.assert_array_equal(htop_j, hseq_j[L - 1])


def test_fused3_layer0_is_the_hoisted_gate_forward():
    """Layer 0 of fused3 is gru_layer_scan's forward on the same gates, and
    layer l > 0 that of the stack's upper layers."""
    L, H, Bs, Ts = 2, 12, 5, 6
    s = 1 / np.sqrt(H)
    gi0 = torch.from_numpy(normal((Ts, Bs, 3 * H), seed=31))
    wih = torch.from_numpy(_uniform((L - 1, 3 * H, H), 32, s))
    bih = torch.from_numpy(_uniform((L - 1, 3 * H), 33, s))
    whh = torch.from_numpy(_uniform((L, 3 * H, H), 34, s))
    bhh = torch.from_numpy(_uniform((L, 3 * H), 35, s))
    h0 = torch.from_numpy(0.5 * normal((L, Bs, H), seed=36))
    hseq = ks.gru_fused3_scan_ref(gi0, wih, bih, whh, bhh, h0)
    assert torch.equal(hseq[0], kgru.scan_forward_ref(gi0, whh[0], bhh[0], h0[0])[0])
    gi1 = hseq[0].float() @ wih[0].to(torch.bfloat16).float().T + bih[0]
    want1 = kgru._recurrence_ref(gi1, whh[1], bhh[1], h0[1], torch.bfloat16)[0]
    assert torch.equal(hseq[1], want1)


@pytest.mark.parametrize("shape,T_,k_ops,chains", [
    ((16, 8), 12, 10, 4),
    ((8, 16), 7, 3, 4),
    ((4, 32), 5, 9, 2),
    ((3, 5), 6, 13, 8),
])
def test_floor_loop_matches_pallas_kernel(shape, T_, k_ops, chains):
    """Exact, including a k_ops that chains does not divide and x near the
    int32 limits (the adds wrap)."""
    rng = np.random.default_rng(41)
    x = rng.integers(-8, 8, size=shape, dtype=np.int32)
    x.flat[0], x.flat[1] = np.iinfo(np.int32).max, np.iinfo(np.int32).min
    want = np.asarray(jprobe_auto.floor_loop(jnp.asarray(x), T_, k_ops, chains))
    got = kfloor.floor_loop_ref(torch.from_numpy(x), T_, k_ops, chains)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_fwd_gi_is_gru_layer_scan_x():
    """``fwd_gi`` (in-kernel x @ W_ih, stores hseq, r|z|n, gh_n) computes
    gru_layer_scan_x's bf16 forward; its port is csrc/gru_layer.cu's
    x-forward, so no new kernel: held against the plain version here."""
    Ts, Bs, I, H = 12, 16, 40, 24
    s = 1 / np.sqrt(H)
    x = normal((Ts, Bs, I), seed=51)
    w_ih, w_hh = _uniform((I, 3 * H), 52, s), _uniform((H, 3 * H), 53, s)
    b_ih, b_hh = _uniform((3 * H,), 54, s), _uniform((3 * H,), 55, s)
    h0 = 0.5 * normal((Bs, H), seed=56)
    want = np.asarray(jprobe_gi.fwd_gi(*map(jnp.asarray, (x, w_ih, b_ih, w_hh, b_hh, h0))))
    want = want[..., :H].astype(np.float32)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (x, w_ih.T, b_ih, w_hh.T, b_hh, h0)]
    got = kgru.gru_layer_scan_x_ref(*t, matmul_dtype="bfloat16")
    np.testing.assert_allclose(got.detach().numpy(), want, atol=BF16_TOL, rtol=0)


def test_probe_modules_run_on_the_cpu_at_a_small_size():
    """The probe modules' inputs and one probe run, through the plain versions:
    shapes, fused3's top layer against the stack route (they differ only by
    layer 0's gates rounded to bf16), the in-kernel and hoisted versions of
    proto_gi_kernel, and the automaton walk and floor of auto_loop_probe."""
    g = ge.make_inputs(B=5, T=6, H=16, L=3, I0=10, device="cpu")
    out = ge.probe(g)
    assert {k: tuple(v.shape) for k, v in out.items()} == {
        "matmul_only": (6, 5, 16), "gates_nostore": (6, 5, 16), "full": (6, 5, 16),
        "per_layer_3": (5, 6, 16), "stack_3": (5, 6, 16), "fused3": (3, 6, 5, 16)}
    assert torch.equal(out["gates_nostore"], out["full"])
    assert torch.equal(out["per_layer_3"], out["stack_3"])
    assert (out["fused3"][-1].float() - out["stack_3"].transpose(0, 1)).abs().max() <= BF16_TOL
    assert set(ge.bounds(g)) == set(out)
    p = pg.make_inputs(B=5, T=6, I=10, H=16, L=3, device="cpu")
    o = pg.probe(p)
    assert (o["in_kernel_L"] - o["hoisted_L"]).abs().max() <= BF16_TOL
    assert set(pg.bounds(p)) == {"1", "L"}
    a = al.make_inputs(B=4, T=10, device="cpu")
    o = al.probe(a)
    assert o["codes"].shape == (4, 10) and o["floor"].shape == al.FLOOR_SHAPES[-1]
    assert al.floor_bound((256, 32), 120, 64)[1] == "operations"


def test_probe_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors each wrapper returns its plain version's result and
    launches nothing; bad arguments raise before any launch."""
    saved = (kgru.probe_matmul_only_launches, kgru.probe_gates_nostore_launches,
             kgru.fused3_launches, kfloor.launches, kgru.layer_fwd_launches)
    H, Bs, Ts, L = 8, 3, 4, 2
    gi = torch.from_numpy(normal((Ts, Bs, 3 * H), seed=61))
    w = torch.from_numpy(_uniform((3 * H, H), 62, 0.3))
    b = torch.from_numpy(_uniform((3 * H,), 63, 0.3))
    h0 = torch.from_numpy(normal((Bs, H), seed=64))
    for mode in kgru.PROBE_MODES:
        assert torch.equal(kgru.gru_probe_scan(gi, w, b, h0, mode), kgru.gru_probe_scan_ref(gi, w, b, h0, mode))
    with pytest.raises(ValueError, match="probe mode"):
        kgru.gru_probe_scan(gi, w, b, h0, "full")
    stack = (gi, w[None].repeat(L - 1, 1, 1), b[None].repeat(L - 1, 1), w[None].repeat(L, 1, 1),
             b[None].repeat(L, 1), h0[None].repeat(L, 1, 1))
    assert torch.equal(kgru.gru_fused3_scan(*stack), ks.gru_fused3_scan_ref(*stack))
    x = torch.arange(-6, 6, dtype=torch.int32).view(3, 4)
    assert torch.equal(kfloor.floor_loop(x, 5, 7, 3), kfloor.floor_loop_ref(x, 5, 7, 3))
    for bad in (dict(chains=0), dict(chains=kfloor.MAX_CHAINS + 1), dict(k_ops=-1)):
        args = {"T": 2, "k_ops": 3, "chains": 2, **bad}
        with pytest.raises(ValueError):
            kfloor.floor_loop(x, **args)
    with pytest.raises(ValueError, match="int32"):
        kfloor.floor_loop(x.float(), 2, 3)
    after = (kgru.probe_matmul_only_launches, kgru.probe_gates_nostore_launches,
             kgru.fused3_launches, kfloor.launches, kgru.layer_fwd_launches)
    assert after == saved
