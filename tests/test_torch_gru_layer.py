"""The port's per-layer GRU kernels and the router against molvax, on the CPU.

The CUDA kernels of ``csrc/gru_layer.cu`` run only on a card
(``chip_smoke.py`` holds them against their plain versions there). Here the
plain versions, through the autograd wrappers, against the reference's
Pallas kernels run as its own tests run them on the CPU, in interpret mode:
``gru_layer_scan_x`` in bf16 and in strict fp32, ``gru_layer_scan``, and
the router's per-layer routes against ``gru_forward_pallas(kernel=
'per_layer')``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molvax.kernels.gru import gru_forward_pallas as j_gru_forward_pallas
from molvax.kernels.gru import gru_layer_scan as j_layer_scan
from molvax.kernels.gru import gru_layer_scan_x as j_layer_scan_x
from molvax_torch.kernels import gru as kgru
from molvax_torch.kernels import gru_stack as ks
from molvax_torch.nn.gru import gru_forward
from test_torch_gru_stack import _jax_layers, _layers_np, _per_layer, _torch_layers
from test_torch_support import normal

# bf16: the plain versions round where the kernels round, so only fp32
# summation order differs. Values: the reference's own on-chip gate
# (ROADMAP B, err_max 0.00391); gradients: the slice tolerance of
# test_torch_train.py (a sum next to a bf16 rounding boundary can round one
# step the other way). Measured: values <= 4.9e-4, gradients <= 8.2e-4.
BF16_TOL = 3.91e-3
BF16_GRAD_REL = 2e-3
# strict fp32: the reference's strict-mode tolerances
# (tests/kernels/test_gru_kernel.py); a bf16 cast anywhere would show as
# ~1e-2. Measured: values <= 1.2e-7, gradients <= 3.1e-5 abs.
FP32_TOL, FP32_GRAD_TOL = 1e-5, 1e-4

GRAD_NAMES = ["dx", "dw_ih", "db_ih", "dw_hh", "db_hh", "dh0"]


def _layer_np(I, H, seed):
    """One layer's JAX-layout weights, uniform +-1/sqrt(H)."""
    return _layers_np(I, H, 1, seed)[0]


def _to_torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True) for a in arrays]


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _layer_x_case(I, H, md):
    """h_seq and the six gradients of sum(sin(h_seq)), reference and port."""
    T, B = 12, 16
    p = _layer_np(I, H, seed=I + H)
    x = normal((T, B, I), seed=1)
    h0 = 0.1 * normal((B, H), seed=2)
    args = (x, p["w_ih"], p["b_ih"], p["w_hh"], p["b_hh"], h0)
    j_args = tuple(map(jnp.asarray, args))

    def j_loss(*a):
        return jnp.sum(jnp.sin(j_layer_scan_x(*a, matmul_dtype=md)))

    h_j = np.asarray(j_layer_scan_x(*j_args, matmul_dtype=md))
    g_j = [np.asarray(g) for g in jax.grad(j_loss, argnums=tuple(range(6)))(*j_args)]
    # torch layout: the weights transposed, their gradients transposed back
    t_args = _to_torch(x, p["w_ih"].T, p["b_ih"], p["w_hh"].T, p["b_hh"], h0)
    h_t = kgru.gru_layer_scan_x(*t_args, matmul_dtype=md)
    g_t = torch.autograd.grad(torch.sin(h_t).sum(), t_args)
    g_t = [g.numpy().T if name in ("dw_ih", "dw_hh") else g.numpy() for name, g in zip(GRAD_NAMES, g_t)]
    return h_t.detach().numpy(), h_j, g_t, g_j


@pytest.mark.parametrize("I,H", [(9, 130), (12, 12)])
def test_layer_scan_x_bf16_matches_pallas_kernel(I, H):
    h_t, h_j, g_t, g_j = _layer_x_case(I, H, "bfloat16")
    np.testing.assert_allclose(h_t, h_j, atol=BF16_TOL, rtol=0)
    for name, got, want in zip(GRAD_NAMES, g_t, g_j):
        assert _rel(got, want) <= BF16_GRAD_REL, (name, _rel(got, want))


@pytest.mark.parametrize("I,H", [(12, 12), (9, 130)])
def test_layer_scan_x_strict_fp32_matches_pallas_kernel(I, H):
    h_t, h_j, g_t, g_j = _layer_x_case(I, H, "float32")
    np.testing.assert_allclose(h_t, h_j, atol=FP32_TOL, rtol=FP32_TOL)
    for name, got, want in zip(GRAD_NAMES, g_t, g_j):
        np.testing.assert_allclose(got, want, atol=FP32_GRAD_TOL, rtol=FP32_GRAD_TOL, err_msg=name)


def test_layer_scan_matches_pallas_kernel():
    """The hoisted-gi recurrence: h_seq and the gi, w_hh, b_hh, h0
    gradients, bf16 gates."""
    T, B, H = 12, 16, 130
    p = _layer_np(H, H, seed=5)
    gi = normal((T, B, 3 * H), seed=3)
    h0 = 0.1 * normal((B, H), seed=4)
    args = (gi, p["w_hh"], p["b_hh"], h0)
    j_args = tuple(map(jnp.asarray, args))
    h_j = np.asarray(j_layer_scan(*j_args))
    g_j = jax.grad(lambda *a: jnp.sum(jnp.sin(j_layer_scan(*a))), argnums=(0, 1, 2, 3))(*j_args)
    t_args = _to_torch(gi, p["w_hh"].T, p["b_hh"], h0)
    h_t = kgru.gru_layer_scan(*t_args)
    g_t = torch.autograd.grad(torch.sin(h_t).sum(), t_args)
    np.testing.assert_allclose(h_t.detach().numpy(), h_j, atol=BF16_TOL, rtol=0)
    for name, got, want in zip(["dgi", "dw_hh", "db_hh", "dh0"], g_t, g_j):
        got = got.numpy().T if name == "dw_hh" else got.numpy()
        assert _rel(got, np.asarray(want)) <= BF16_GRAD_REL, (name, _rel(got, np.asarray(want)))


def test_backward_rounds_like_the_kernel():
    """dx leaves the bf16 backward rounded to bf16 (gru.py:636-638) and the
    fp32 backward unrounded; dgi of gru_layer_scan is the fp32 of bf16."""
    T, B, I, H = 4, 3, 5, 8
    p = _layer_np(I, H, seed=6)
    x = torch.from_numpy(normal((T, B, I), seed=7))
    h0 = torch.zeros(B, H)
    dY = torch.from_numpy(normal((T, B, H), seed=8))
    w_ih, w_hh = torch.from_numpy(p["w_ih"].T.copy()), torch.from_numpy(p["w_hh"].T.copy())
    b_ih, b_hh = torch.from_numpy(p["b_ih"]), torch.from_numpy(p["b_hh"])
    for md, rounded in ((torch.bfloat16, True), (torch.float32, False)):
        res = kgru.layer_forward_ref(x, w_ih, b_ih, w_hh, b_hh, h0, md)
        assert all(r.dtype == md for r in res)
        grads = kgru.layer_backward_ref((*res, x, h0, w_ih, w_hh), dY)
        dx = grads[0]
        assert torch.equal(dx, dx.to(torch.bfloat16).float()) == rounded
        assert all(torch.isfinite(g).all() and g.dtype == torch.float32 for g in grads)
    gi = torch.from_numpy(normal((T, B, 3 * H), seed=9))
    res = kgru.scan_forward_ref(gi, w_hh, b_hh, h0)
    dgi = kgru.scan_backward_ref((*res, h0, w_hh), dY)[0]
    assert torch.equal(dgi, dgi.to(torch.bfloat16).float())


# -- the router ----------------------------------------------------------------


def _stack_launches():
    return ks.gemm_gi_launches, ks.rec_launches, ks.sweep_launches, ks.gemm_dx_launches, ks.dw_launches


def _route_case(md_j, seed):
    """Values and every gradient (weights, x, h0) of a 3-layer per-layer
    route, reference and port, for the loss sum(sin(out)) + sum(cos(h_final))."""
    B, T, I, H, L = 16, 12, 9, 130, 3
    layers = _layers_np(I, H, L, seed=seed)
    x = normal((B, T, I), seed=seed + 1)
    h0 = 0.1 * normal((L, B, H), seed=seed + 2)

    def j_loss(ls, x, h0):
        out, hf = j_gru_forward_pallas(ls, x, h0, compute_dtype=md_j, kernel="per_layer")
        return jnp.sum(jnp.sin(out)) + jnp.sum(jnp.cos(hf)), (out, hf)

    (_, (out_j, hf_j)), g_j = jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True)(
        _jax_layers(layers), jnp.asarray(x), jnp.asarray(h0))
    want = {f"{li}.{k}": np.asarray(v) for li, layer in enumerate(g_j[0]) for k, v in layer.items()}
    want.update(x=np.asarray(g_j[1]), h0=np.asarray(g_j[2]))

    def port(route):
        tl = _torch_layers(layers)
        names = [f"{li}.{k}" for li, layer in enumerate(tl) for k in layer]
        params = [p.requires_grad_(True) for layer in tl for p in layer.values()]
        xt, ht = _to_torch(x, h0)
        out, hf = route(tl, xt, ht)
        grads = torch.autograd.grad(torch.sin(out).sum() + torch.cos(hf).sum(), params + [xt, ht])
        got = {n: (g.numpy().T if g.ndim == 2 and n[0].isdigit() else g.numpy())
               for n, g in zip(names + ["x", "h0"], grads)}
        return out.detach().numpy(), hf.detach().numpy(), got

    return (np.asarray(out_j), np.asarray(hf_j), want), port


def test_per_layer_bf16_route_matches_reference_and_repairs_the_old_route():
    """The repair: the router's CPU route for gru_kernel='per_layer' in bf16
    is the per-layer kernels' plain version, which rounds where
    gru_layer_scan_x rounds (bf16 h between layers, bf16 residuals, dx
    rounded to bf16). The old route, nn.gru.gru_forward, kept h in fp32
    between layers and took autograd's exact gradient: measured 8.9e-4 in
    h_final and up to 4.4e-3 relative in the gradients, which fails the
    gradient tolerance; the repaired route is within 1e-6 and 8.2e-4."""
    (out_j, hf_j, want), port = _route_case(jnp.bfloat16, seed=21)
    before = _stack_launches()
    out, hf, got = port(lambda ls, x, h0: kgru.gru_forward_pallas(
        ls, x, h0, compute_dtype=torch.bfloat16, kernel="per_layer"))
    assert _stack_launches() == before
    np.testing.assert_allclose(out, out_j, atol=BF16_TOL, rtol=0)
    np.testing.assert_allclose(hf, hf_j, atol=BF16_TOL, rtol=0)
    report = {n: _rel(got[n], want[n]) for n in want}
    assert max(report.values()) <= BF16_GRAD_REL, report
    # the old route computes another function: the tolerance tells them apart
    _, _, old = port(lambda ls, x, h0: gru_forward(ls, x, h0, compute_dtype=torch.bfloat16))
    assert max(_rel(old[n], want[n]) for n in want) > BF16_GRAD_REL


def test_strict_fp32_route_matches_reference():
    (out_j, hf_j, want), port = _route_case(jnp.float32, seed=31)
    before = _stack_launches()
    out, hf, got = port(lambda ls, x, h0: kgru.gru_forward_pallas(ls, x, h0, compute_dtype=torch.float32))
    assert _stack_launches() == before
    np.testing.assert_allclose(out, out_j, atol=FP32_TOL, rtol=FP32_TOL)
    np.testing.assert_allclose(hf, hf_j, atol=FP32_TOL, rtol=FP32_TOL)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=FP32_GRAD_TOL, rtol=FP32_GRAD_TOL, err_msg=n)


def test_pinned_fused_stack_under_fp32_takes_per_layer_and_notes_once(capsys, monkeypatch):
    monkeypatch.setattr(kgru, "_warned_fp32", False)
    layers = _torch_layers(_layers_np(6, 10, 3, seed=41))
    x = torch.from_numpy(normal((3, 5, 6), seed=42))
    before = _stack_launches()
    for _ in range(2):
        got = kgru.gru_forward_pallas(layers, x, compute_dtype=torch.float32, kernel="fused_stack")
    want = _per_layer(layers, x, torch.float32)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert _stack_launches() == before
    err = capsys.readouterr().err
    assert err.count("fused-stack kernel is bf16-only") == 1, err


@pytest.mark.parametrize("kernel", ["auto", "fused_stack"])
def test_single_layer_bf16_takes_per_layer(kernel, capsys):
    layers = _torch_layers(_layers_np(6, 10, 1, seed=43))
    x = torch.from_numpy(normal((3, 5, 6), seed=44))
    before = _stack_launches()
    got = kgru.gru_forward_pallas(layers, x, compute_dtype=torch.bfloat16, kernel=kernel)
    want = _per_layer(layers, x, torch.bfloat16)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert _stack_launches() == before
    assert "bf16-only" not in capsys.readouterr().err


def test_shared_memory_check():
    """The kernels keep the h carry, its operand copy, x and the gate
    cotangents of 4 rows in shared memory: moses_scaled's 1024 wide layers
    fit in both modes; a shape that does not fit raises before a launch."""
    for md in (torch.bfloat16, torch.float32):
        assert kgru.smem_bytes(1024, 1024, md) <= kgru._MAX_SMEM
        kgru._check_fits("gru_layer_scan_x", 1024, 1024, md)
    assert kgru.smem_bytes(1024, 1024, torch.float32) == 4 * 1024 * 4 + 6 * 1024 * 4 * 4
    with pytest.raises(ValueError, match="shared memory"):
        kgru._check_fits("gru_layer_scan_x", 512, 4096, torch.float32)


def test_backward_checks_the_residuals_it_reads():
    """The sweep reads the forward's residuals through raw pointers: a
    misshapen, non-contiguous or wrongly typed one raises first."""
    T, B, H = 3, 2, 5
    bf = torch.bfloat16
    good = dict(hseq=torch.zeros(T, B, H, dtype=bf), rzn=torch.zeros(T, B, 3 * H, dtype=bf),
                ghn=torch.zeros(T, B, H, dtype=bf), dY=torch.zeros(T, B, H))
    kgru._check_residuals("sweep", (T, B, H), bf, **good)
    bad_cases = [
        dict(rzn=torch.zeros(T, B, H, dtype=bf)),
        dict(ghn=torch.zeros(T, B, H)),
        dict(hseq=torch.zeros(T, H, B, dtype=bf).transpose(1, 2)),
        dict(dY=torch.zeros(T, B + 1, H)),
    ]
    for bad in bad_cases:
        with pytest.raises(ValueError, match="sweep"):
            kgru._check_residuals("sweep", (T, B, H), bf, **{**good, **bad})
    with pytest.raises(ValueError, match="stored in torch.float16"):
        kgru._check_residuals("sweep", (T, B, H), torch.float16, **good)


def test_kernel_wrappers_never_fall_back_off_the_cpu():
    T, B, I, H = 3, 2, 4, 6
    meta = functools.partial(torch.empty, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kgru.gru_layer_scan_x(meta(T, B, I), meta(3 * H, I), meta(3 * H), meta(3 * H, H), meta(3 * H), meta(B, H))
    with pytest.raises(ValueError, match="unsupported device"):
        kgru.gru_layer_scan_x(meta(T, B, I), meta(3 * H, I), meta(3 * H), meta(3 * H, H), meta(3 * H), meta(B, H),
                              "float32")
    with pytest.raises(ValueError, match="unsupported device"):
        kgru.gru_layer_scan(meta(T, B, 3 * H), meta(3 * H, H), meta(3 * H), meta(B, H))
    # the bf16 persistent route's wrappers, and the in-kernel instance by name
    cpu = [torch.zeros(s) for s in ((T, B, I), (3 * H, I), (3 * H,), (3 * H, H), (3 * H,), (B, H))]
    assert kgru.layer_route(B, H) == "persistent"
    counts = (kgru.layer_gi_launches, kgru.layer_rec_launches, kgru.layer_sweep_launches,
              kgru.layer_dx_launches, kgru.layer_gemm_dw_launches, kgru.layer_fwd_launches)
    with pytest.raises(ValueError, match="unsupported device cpu"):
        kgru.layer_forward(*cpu, torch.bfloat16)
    res = (*kgru.layer_forward_ref(*cpu, torch.bfloat16), cpu[0], cpu[5], cpu[1], cpu[3])
    with pytest.raises(ValueError, match="unsupported device cpu"):
        kgru.layer_backward(res, torch.zeros(T, B, H))
    with pytest.raises(ValueError, match="unsupported device"):
        kgru.gru_layer_scan_x_in_kernel(meta(T, B, I), meta(3 * H, I), meta(3 * H), meta(3 * H, H), meta(3 * H),
                                        meta(B, H))
    assert counts == (kgru.layer_gi_launches, kgru.layer_rec_launches, kgru.layer_sweep_launches,
                      kgru.layer_dx_launches, kgru.layer_gemm_dw_launches, kgru.layer_fwd_launches)
    with pytest.raises(ValueError, match="matmul_dtype"):
        kgru.gru_layer_scan_x(*(torch.zeros(1) for _ in range(6)), "float16")
