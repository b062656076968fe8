"""The bf16 per-layer GRU route on the stack's pieces, on the CPU.

Since the per-layer redesign, bf16 ``gru_layer_scan_x`` runs, wherever
``layer_route`` finds a layout, the kernels of the stack for one layer: the
input-gate GEMM and the persistent recurrence forward; the persistent sweep,
a dx GEMM and one dW GEMM backward. Those run only on a card
(``chip_smoke.py`` holds them against their plain versions there). Here: the
stack's plain pieces composed by hand against the per-layer plain versions,
bit for bit; the per-layer router against the reference's per-layer Pallas
kernels in interpret mode, and its gradients against the stack route's,
which differ by the cotangent the per-layer route rounds to bf16 at every
layer; the route decision; the residual check of the persistent sweep; and
the wrappers' refusal of CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molvax.kernels.gru import gru_forward_pallas as j_gru_forward_pallas
from molvax_torch.config import get_preset
from molvax_torch.kernels import gru as kgru
from molvax_torch.kernels import gru_stack as ks
from molvax_torch.utils import round_to
from test_torch_gru_layer import BF16_GRAD_REL, BF16_TOL
from test_torch_gru_stack import _jax_layers, _layers_np, _torch_layers
from test_torch_support import normal

BF = torch.bfloat16
SHAPES = [(5, 3, 10, 24), (4, 6, 9, 130)]  # (T, B, I, H)


def _uniform(shape, seed, k):
    return torch.from_numpy(np.random.default_rng(seed).uniform(-k, k, shape).astype(np.float32))


def _layer_args(T, B, I, H, seed):
    """x (T, B, I), w_ih (3H, I), b_ih, w_hh (3H, H), b_hh, h0 (B, H)."""
    k = 1.0 / np.sqrt(H)
    return (torch.from_numpy(normal((T, B, I), seed=seed)), _uniform((3 * H, I), seed + 1, k),
            _uniform((3 * H,), seed + 2, k), _uniform((3 * H, H), seed + 3, k), _uniform((3 * H,), seed + 4, k),
            0.1 * torch.from_numpy(normal((B, H), seed=seed + 5)))


# -- the plain pieces ------------------------------------------------------------


@pytest.mark.parametrize("T,B,I,H", SHAPES)
def test_plain_pieces_compose_to_the_layer_forward_bit_for_bit(T, B, I, H):
    """The persistent route's forward, the gi GEMM then the recurrence, is
    layer_forward_ref in bf16."""
    x, w_ih, b_ih, w_hh, b_hh, h0 = _layer_args(T, B, I, H, seed=H)
    by_hand = ks.layer_recurrence_ref(ks.gemm_ref("gi", x, w_ih, b_ih), w_hh, b_hh, h0)
    for got, want in zip(by_hand, kgru.layer_forward_ref(x, w_ih, b_ih, w_hh, b_hh, h0, BF)):
        assert got.dtype == BF and torch.equal(got, want)


@pytest.mark.parametrize("T,B,I,H", SHAPES)
def test_plain_pieces_compose_to_the_layer_backward_bit_for_bit(T, B, I, H):
    """The persistent route's backward: the sweep with ext = dY and no
    h_final cotangent, the dx GEMM rounded to bf16 at the layer, and the two
    dW jobs (x; h one step behind with bf16(h0) first) are
    layer_backward_ref. Without the rounding, dx is another function."""
    x, w_ih, b_ih, w_hh, b_hh, h0 = _layer_args(T, B, I, H, seed=H + 1)
    hseq, rzn, ghn = kgru.layer_forward_ref(x, w_ih, b_ih, w_hh, b_hh, h0, BF)
    dY = torch.from_numpy(normal((T, B, H), seed=3))
    dgi, dgh, dh0 = ks.layer_sweep_ref(hseq, h0, rzn, ghn, w_hh, dY, torch.zeros(B, H))
    dx = ks.gemm_ref("dx", dgi, w_ih)
    by_hand = (round_to(dx, BF), *ks.gemm_ref("dw", dgi, x), *ks.gemm_ref("dw", dgh, hseq[:-1], first=h0), dh0)
    want = kgru.layer_backward_ref((hseq, rzn, ghn, x, h0, w_ih, w_hh), dY)
    for name, got, ref in zip(["dx", "dw_ih", "db_ih", "dw_hh", "db_hh", "dh0"], by_hand, want):
        assert got.dtype == torch.float32 and torch.equal(got, ref), name
    assert torch.equal(want[0], want[0].to(BF).float()) and not torch.equal(dx, want[0])


# -- the router ------------------------------------------------------------------


def _grads(route, layers_np, x, h0):
    """out, h_final and every gradient (per layer's weights, x, h0) of
    sum(sin(out)) + sum(cos(h_final)) through ``route``, torch layout."""
    tl = _torch_layers(layers_np)
    names = [f"{li}.{k}" for li, layer in enumerate(tl) for k in layer]
    params = [p.requires_grad_(True) for layer in tl for p in layer.values()]
    xt, ht = (torch.from_numpy(a).requires_grad_(True) for a in (x, h0))
    out, hf = route(tl, xt, ht)
    grads = torch.autograd.grad(torch.sin(out).sum() + torch.cos(hf).sum(), params + [xt, ht])
    return out.detach().numpy(), hf.detach().numpy(), dict(zip(names + ["x", "h0"], grads))


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_per_layer_route_matches_reference_and_keeps_its_own_cotangent_rounding():
    """A 3-layer bf16 gru_forward_pallas(kernel='per_layer') against the
    reference's per-layer Pallas kernels (interpret mode), at
    test_torch_gru_layer.py's tolerances. The stack route on the same inputs
    computes the same forward bit for bit, but passes an fp32 cotangent down
    where the per-layer route rounds it to bf16 at every layer: the top
    layer's gradients agree (measured: bit for bit), the lower layers' and
    x's do not (measured: 1.3e-3 relative for layer 0's W_hh, 3.2e-3 for its
    W_ih, 3.1e-3 for x)."""
    B, T, I, H, L = 6, 5, 9, 24, 3
    layers = _layers_np(I, H, L, seed=71)
    x = normal((B, T, I), seed=72)
    h0 = 0.1 * normal((L, B, H), seed=73)

    def j_loss(ls, x, h0):
        out, hf = j_gru_forward_pallas(ls, x, h0, compute_dtype=jnp.bfloat16, kernel="per_layer")
        return jnp.sum(jnp.sin(out)) + jnp.sum(jnp.cos(hf)), (out, hf)

    (_, (out_j, hf_j)), g_j = jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True)(
        _jax_layers(layers), jnp.asarray(x), jnp.asarray(h0))
    want = {f"{li}.{k}": np.asarray(v) for li, layer in enumerate(g_j[0]) for k, v in layer.items()}
    want.update(x=np.asarray(g_j[1]), h0=np.asarray(g_j[2]))

    out, hf, got = _grads(lambda ls, x, h0: kgru.gru_forward_pallas(ls, x, h0, kernel="per_layer"), layers, x, h0)
    np.testing.assert_allclose(out, np.asarray(out_j), atol=BF16_TOL, rtol=0)
    np.testing.assert_allclose(hf, np.asarray(hf_j), atol=BF16_TOL, rtol=0)
    for n, g in got.items():
        g = g.numpy().T if g.ndim == 2 and n[0].isdigit() else g.numpy()
        assert float(np.linalg.norm(g - want[n]) / np.linalg.norm(want[n])) <= BF16_GRAD_REL, n

    assert ks.stack_plan_ok(_torch_layers(layers))
    s_out, s_hf, stack = _grads(lambda ls, x, h0: kgru.gru_forward_pallas(ls, x, h0), layers, x, h0)
    assert np.array_equal(out, s_out) and np.array_equal(hf, s_hf)
    top = [n for n in got if n.startswith(f"{L - 1}.")]
    assert max(_rel(got[n], stack[n]) for n in top) <= 1e-6
    for n in ("0.w_ih", "0.w_hh", "x"):
        assert _rel(got[n], stack[n]) > 2e-4, n


# -- the route ---------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["zinc250k", "moses_scaled"])
@pytest.mark.parametrize("B", [6, 256])
def test_layer_route_is_persistent_at_the_presets_widths(preset, B):
    H = get_preset(preset).model.gru_hidden
    assert kgru.layer_route(B, H) == "persistent"
    assert kgru._persistent(BF, B, H) and not kgru._persistent(torch.float32, B, H)


@pytest.mark.parametrize("B,H", [(256, 2144), (16, 2304), (256, 3072)])
def test_layer_route_takes_the_in_kernel_instance_where_no_layout_fits(B, H):
    """stack_plan lays out every H up to 2,112 at B=256 and raises beyond;
    there the bf16 in-kernel instance's shared memory still takes the
    layer (4 rows of h, its bf16 copies and x)."""
    with pytest.raises(ValueError, match="no layout fits"):
        ks.stack_plan(B, H)
    assert kgru.layer_route(B, H) == "in_kernel"
    kgru._check_fits("gru_layer_scan_x", 329, H, BF)
    assert kgru.layer_route(256, 2112) == "persistent"


def test_persistent_sweep_reads_a_padded_hseq_in_place():
    """The recurrence writes hseq into rows padded to a multiple of 8 and
    returns a view; the persistent sweep's check takes that view, the
    in-kernel sweep's does not."""
    T, B, H = 3, 2, 5
    hseq = torch.zeros(T, B, 8, dtype=BF)[..., :H]
    res = dict(hseq=hseq, rzn=torch.zeros(T, B, 3 * H, dtype=BF), ghn=torch.zeros(T, B, H, dtype=BF),
               dY=torch.zeros(T, B, H))
    kgru._check_residuals("sweep", (T, B, H), BF, **res, padded=True)
    with pytest.raises(ValueError, match="residual hseq"):
        kgru._check_residuals("sweep", (T, B, H), BF, **res)
    for bad in (dict(hseq=torch.zeros(T, B, 7, dtype=BF)[..., :H]), dict(rzn=torch.zeros(T, B, 16, dtype=BF)[..., :3 * H]),
                dict(hseq=torch.zeros(T, B, 8)[..., :H])):
        with pytest.raises(ValueError, match="sweep"):
            kgru._check_residuals("sweep", (T, B, H), BF, **{**res, **bad}, padded=True)


# -- the wrappers ------------------------------------------------------------------


def _counts():
    return (kgru.layer_gi_launches, kgru.layer_rec_launches, kgru.layer_sweep_launches, kgru.layer_dx_launches,
            kgru.layer_gemm_dw_launches, kgru.layer_dw_sum_launches, kgru.layer_fwd_launches, kgru.layer_bwd_launches, kgru.layer_dw_launches,
            ks.gemm_gi_launches, ks.rec_launches, ks.sweep_launches, ks.gemm_dx_launches, ks.dw_launches)


@pytest.mark.parametrize("md", [BF, torch.float32])
@pytest.mark.parametrize("wrapper", ["layer_forward", "layer_backward", "layer_forward_in_kernel",
                                     "layer_backward_in_kernel"])
def test_layer_wrappers_raise_on_cpu_tensors_and_never_fall_back(wrapper, md):
    T, B, I, H = 3, 2, 5, 8
    args = _layer_args(T, B, I, H, seed=80)
    x, w_ih, _, w_hh, _, h0 = args
    res = (*kgru.layer_forward_ref(*args, md), x, h0, w_ih, w_hh)
    before = _counts()
    call = {"layer_forward": lambda: kgru.layer_forward(*args, md),
            "layer_backward": lambda: kgru.layer_backward(res, torch.zeros(T, B, H)),
            "layer_forward_in_kernel": lambda: kgru.layer_forward_in_kernel(*args, md),
            "layer_backward_in_kernel": lambda: kgru.layer_backward_in_kernel(res, torch.zeros(T, B, H))}
    with pytest.raises(ValueError, match="unsupported device cpu"):
        call[wrapper]()
    assert _counts() == before


def test_in_kernel_wrapper_takes_the_plain_versions_on_the_cpu():
    """gru_layer_scan_x_in_kernel on CPU tensors is the plain version, value
    and gradients, bit for bit, and launches nothing."""
    args = _layer_args(4, 3, 6, 16, seed=90)
    before = _counts()
    outs = []
    for fn in (kgru.gru_layer_scan_x_in_kernel, kgru.gru_layer_scan_x_ref, kgru.gru_layer_scan_x):
        leaves = [a.clone().requires_grad_(True) for a in args]
        h = fn(*leaves)
        outs.append((h, torch.autograd.grad(torch.sin(h).sum(), leaves)))
    for h, grads in outs[1:]:
        assert torch.equal(h, outs[0][0]) and all(torch.equal(a, b) for a, b in zip(grads, outs[0][1]))
    assert _counts() == before


def _plain_launches(monkeypatch):
    """Run the persistent route's wrappers on the CPU with each launch
    replaced by its plain version on the tensors the wrapper hands it: the
    jobs carry tensors instead of pointers, and every stand-in counts as
    the launch would. The route launches through the stack's wrappers
    (``gru_stack.gemm``, ``layer_recurrence``, ``layer_sweep``) and its own
    dx, dW and sum launches, so both modules' launch helpers are replaced."""
    for mod in (ks, kgru):
        monkeypatch.setattr(mod, "_check_cuda", lambda what, *tensors: None)
    monkeypatch.setattr(ks, "_gi_job", lambda x, w, b, out: ("gi", out, (x, w, b), {}))
    monkeypatch.setattr(kgru, "_dx_job", lambda d, w, out: ("dx", out, (d, w), {}))
    monkeypatch.setattr(kgru, "_dw_job", lambda d, x, dw, db, first=None: (
        "dw", (dw, db), (d, x[: d.shape[0] - (first is not None)]), {"first": first}))

    def gemm(kind, jobs, dev_tensor, count):
        for job_kind, out, args, kw in jobs:
            assert job_kind == kind
            got = ks.gemm_ref(kind, *args, **kw)
            for o, g in zip(out if kind == "dw" else (out,), got if kind == "dw" else (got,)):
                o.copy_(g)
        count()

    def recurrence(gi, whh, bhh, h0, h0b, hseq, rzn, ghn, plan, count):
        for o, g in zip((hseq, rzn, ghn), ks.layer_recurrence_ref(gi, whh, bhh, h0)):
            o.copy_(g)
        for _ in range(plan.slices):
            count()

    def sweep(hseq, h0b, rzn, ghn, ext, dhf, whhT, dgi, dgh, dh0, plan, count):
        for o, g in zip((dgi, dgh, dh0), ks.layer_sweep_ref(hseq, h0b, rzn, ghn, whhT.t().contiguous(), ext, dhf)):
            o.copy_(g)
        for _ in range(plan.slices):
            count()

    def sum_parts(parts, out):
        out.copy_(parts[0])
        for part in parts[1:]:
            out += part
        kgru._COUNT["dw_sum"]()

    for mod in (ks, kgru):
        monkeypatch.setattr(mod, "_gemm", gemm)
    monkeypatch.setattr(kgru, "_sum_parts", sum_parts)
    monkeypatch.setattr(ks, "_recurrence", recurrence)
    monkeypatch.setattr(ks, "_sweep", sweep)


@pytest.mark.parametrize("T,B,I,H", SHAPES)
def test_persistent_route_hands_each_launch_the_right_operands(T, B, I, H, monkeypatch):
    """layer_forward / layer_backward on the persistent route, their launches
    replaced by the plain pieces on the operands they are given, equal the
    per-layer plain versions, with hseq read in place as the padded view the
    recurrence writes and x as the padded bf16 copy the autograd wrapper
    keeps: bit for bit, but for dW and db, which the split GEMM sums over
    spans of steps and then over the spans (fp32, another order: measured
    <= 2.7e-8 relative); each launch counted once on the route's own
    counters, none on the stack's or the in-kernel instance's."""
    _plain_launches(monkeypatch)
    args = _layer_args(T, B, I, H, seed=H + 2)
    x, w_ih, _, w_hh, _, h0 = args
    dY = torch.from_numpy(normal((T, B, H), seed=5))
    before = _counts()
    res = kgru.layer_forward(*args, BF)
    want = kgru.layer_forward_ref(*args, BF)
    assert all(torch.equal(a, b) for a, b in zip(res, want))
    assert res[0].stride(-2) == -(-H // 8) * 8  # hseq: a view of rows padded to a multiple of 8
    xp = ks._padded(x)
    grads = kgru.layer_backward((*res, xp, h0, w_ih, w_hh), dY)
    for name, a, b in zip(["dx", "dw_ih", "db_ih", "dw_hh", "db_hh", "dh0"], grads,
                          kgru.layer_backward_ref((*want, x, h0, w_ih, w_hh), dY)):
        assert torch.equal(a, b) if name in ("dx", "dh0") else _rel(a, b) <= 1e-6, name
    n = ks.stack_plan(B, H).slices
    added = tuple(a - b for a, b in zip(_counts(), before))
    assert added == (1, n, n, 1, 1, 1) + (0,) * 8


@pytest.mark.parametrize("T,I,H,parts", [(120, 329, 501, 3), (120, 501, 501, 4), (120, 549, 1024, 3), (2, 10, 24, 2)])
def test_dw_gemm_parts_fill_the_card(T, I, H, parts):
    """zinc250k's layer 0: 84 output tiles on 132 SMs, one wave with 48 idle;
    in 3 parts, 252 tiles in two waves of a third of the rows each."""
    assert kgru.dw_parts(T, I, H) == parts
