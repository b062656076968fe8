"""The port's GRU recurrence against molvax, on the CPU.

The CUDA stack kernels run only on a card (``chip_smoke.py`` holds them
against their plain versions there). Here: the plain forward against the
reference twin that rounds at the same points, the plain forward and
backward against the reference's Pallas stack kernel in interpret mode,
the fp32 sweep against the reference sweep, and the router (its
per-layer routes against the reference in ``test_torch_gru_layer.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molvax.kernels.gru_stack import gru_forward_faithful as j_faithful
from molvax.kernels.gru_stack import gru_stack_scan as j_stack_scan
from molvax.nn.gru import gru_forward as j_gru_forward
from molvax_torch.kernels import gru as kgru
from molvax_torch.kernels import gru_stack as ks
from molvax_torch.nn.gru import gru_forward
from test_torch_support import normal

# the reference's on-chip gate for the stack kernel against its twin
# (ROADMAP B; BENCH_r05.json err_max 0.00391): the plain forward rounds
# where the twin rounds, so only fp32 summation order differs
FWD_TOL = 3.91e-3
# fp32 on both sides: the repo's parity tolerance
FP32_TOL = 2e-4
# tests/kernels/test_gru_stack.py: ATOL for values, rtol 0.1 for gradients
REF_ATOL, REF_GRAD_RTOL = 5e-2, 0.1


def _layers_np(I, H, L, seed):
    """JAX-layout layer dicts of numpy fp32, uniform +-1/sqrt(H)."""
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(H)
    out = []
    for li in range(L):
        n_in = I if li == 0 else H
        out.append({
            "w_ih": rng.uniform(-k, k, (n_in, 3 * H)).astype(np.float32),
            "w_hh": rng.uniform(-k, k, (H, 3 * H)).astype(np.float32),
            "b_ih": rng.uniform(-k, k, 3 * H).astype(np.float32),
            "b_hh": rng.uniform(-k, k, 3 * H).astype(np.float32),
        })
    return out


def _jax_layers(layers):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in layers]


def _torch_layers(layers):
    """The same weights in torch layout: (3H, in) and (3H, H)."""
    return [
        {k: torch.from_numpy(v.T.copy() if v.ndim == 2 else v.copy()) for k, v in layer.items()}
        for layer in layers
    ]


@pytest.mark.parametrize(
    "B,T,I,H,L",
    [(4, 6, 10, 24, 2), (3, 5, 9, 130, 3), (2, 4, 12, 501, 3)],
)
def test_plain_forward_matches_faithful_twin(B, T, I, H, L):
    layers = _layers_np(I, H, L, seed=B + H)
    x = normal((B, T, I), seed=1)
    h0 = 0.1 * normal((L, B, H), seed=2)
    out_j, hf_j = j_faithful(_jax_layers(layers), jnp.asarray(x), jnp.asarray(h0))
    out_t, hf_t = ks.gru_forward_faithful(_torch_layers(layers), torch.from_numpy(x), torch.from_numpy(h0))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(hf_t.numpy(), np.asarray(hf_j), atol=FWD_TOL, rtol=0)


def test_plain_forward_and_backward_match_pallas_kernel():
    """All 8 cotangents of the plain versions, through the autograd.Function,
    against jax.vjp of the reference kernel in interpret mode."""
    B, T, I, H, L = 16, 12, 10, 130, 3
    layers = _layers_np(I, H, L, seed=0)
    x0 = normal((T, B, I), seed=1)
    h0 = 0.1 * normal((L, B, H), seed=2)
    dY = normal((T, B, H), seed=3)
    dhf = normal((L, B, H), seed=4)
    j_args = (
        x0, layers[0]["w_ih"], layers[0]["b_ih"],
        np.stack([l["w_ih"] for l in layers[1:]]), np.stack([l["b_ih"] for l in layers[1:]]),
        np.stack([l["w_hh"] for l in layers]), np.stack([l["b_hh"] for l in layers]), h0,
    )
    (out_j, hf_j), vjp = jax.vjp(j_stack_scan, *map(jnp.asarray, j_args))
    grads_j = vjp((jnp.asarray(dY), jnp.asarray(dhf)))

    # torch layout: every weight transposed, gradients transposed back
    t_args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        x0, j_args[1].T, j_args[2], j_args[3].transpose(0, 2, 1), j_args[4],
        j_args[5].transpose(0, 2, 1), j_args[6], h0,
    )]
    for a in t_args:
        a.requires_grad_(True)
    out_t, hf_t = ks.gru_stack_scan(*t_args)
    grads_t = torch.autograd.grad((out_t, hf_t), t_args, (torch.from_numpy(dY), torch.from_numpy(dhf)))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=REF_ATOL, rtol=REF_ATOL)
    np.testing.assert_allclose(hf_t.detach().numpy(), np.asarray(hf_j), atol=REF_ATOL, rtol=REF_ATOL)
    names = ["dx0", "dwih0", "dbih0", "dwih", "dbih", "dwhh", "dbhh", "dh0"]
    to_jax_layout = {"dwih0": lambda g: g.T, "dwih": lambda g: g.transpose(0, 2, 1),
                     "dwhh": lambda g: g.transpose(0, 2, 1)}
    for name, g_t, g_j in zip(names, grads_t, grads_j):
        got = to_jax_layout.get(name, lambda g: g)(g_t.numpy())
        np.testing.assert_allclose(got, np.asarray(g_j), atol=REF_ATOL, rtol=REF_GRAD_RTOL, err_msg=name)
        # the same rounding points: only fp32 summation order differs
        # (measured <= 1.1e-4 relative on this input)
        rel = np.linalg.norm(got - np.asarray(g_j)) / np.linalg.norm(np.asarray(g_j))
        assert rel <= 1e-3, (name, rel)


def test_backward_rounds_cotangents_like_the_kernel():
    """dx0 leaves the backward rounded to bf16, as the kernel stores it, and
    the bias gradients are fp32 sums of bf16 cotangents."""
    B, T, I, H, L = 3, 4, 5, 8, 2
    layers = _torch_layers(_layers_np(I, H, L, seed=5))
    x0 = torch.from_numpy(normal((T, B, I), seed=6))
    h0 = torch.zeros(L, B, H)
    wih0, bih0, wih, bih, whh, bhh = ks._stacked(layers)
    res = (*ks.stack_forward_ref(x0, wih0, bih0, wih, bih, whh, bhh, h0), x0, h0, wih0, wih, whh)
    dY = torch.from_numpy(normal((T, B, H), seed=7))
    grads = ks.stack_backward_ref(res, dY, torch.zeros(L, B, H))
    dx0 = grads[0]
    assert torch.equal(dx0, dx0.to(torch.bfloat16).float())
    assert all(torch.isfinite(g).all() for g in grads)


def test_fp32_gru_forward_matches_reference():
    B, T, I, H, L = 4, 7, 11, 20, 2
    layers = _layers_np(I, H, L, seed=8)
    x = normal((B, T, I), seed=9)
    h0 = 0.3 * normal((L, B, H), seed=10)
    out_j, hf_j = j_gru_forward(_jax_layers(layers), jnp.asarray(x), jnp.asarray(h0))
    out_t, hf_t = gru_forward(_torch_layers(layers), torch.from_numpy(x), torch.from_numpy(h0))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=FP32_TOL, rtol=FP32_TOL)
    np.testing.assert_allclose(hf_t.numpy(), np.asarray(hf_j), atol=FP32_TOL, rtol=FP32_TOL)


# -- routing -------------------------------------------------------------------


def _launches():
    return ks.fwd_launches, ks.bwd_launches, ks.dw_launches


def _per_layer(layers, x, dtype):
    """The router's per-layer route written out: one gru_layer_scan_x per
    layer in the matmul dtype, h_final the stored last step of each."""
    inp, finals = x.transpose(0, 1), []
    h0 = torch.zeros(len(layers), x.shape[0], layers[0]["w_hh"].shape[1])
    md = "bfloat16" if dtype == torch.bfloat16 else "float32"
    for li, layer in enumerate(layers):
        inp = kgru.gru_layer_scan_x(inp, layer["w_ih"], layer["b_ih"], layer["w_hh"], layer["b_hh"], h0[li], md)
        finals.append(inp[-1])
    return inp.transpose(0, 1), torch.stack(finals)


@pytest.mark.parametrize("L,dtype", [(1, torch.bfloat16), (2, torch.float32), (1, torch.float32)])
def test_router_takes_plain_sweep_on_cpu(L, dtype):
    """Off the stack (one layer, or strict fp32) the router takes the
    per-layer kernels, whose plain versions run on the CPU."""
    layers = _torch_layers(_layers_np(6, 10, L, seed=11))
    x = torch.from_numpy(normal((3, 5, 6), seed=12))
    before = _launches()
    got = kgru.gru_forward_pallas(layers, x, compute_dtype=dtype)
    want = _per_layer(layers, x, dtype)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert _launches() == before
    if dtype == torch.float32:  # strict fp32: the plain fp32 sweep to fp32 tolerance
        for a, b in zip(got, gru_forward(layers, x, compute_dtype=dtype)):
            torch.testing.assert_close(a, b, atol=FP32_TOL, rtol=FP32_TOL)


def test_router_takes_stack_for_bf16():
    layers = _torch_layers(_layers_np(6, 10, 3, seed=13))
    x = torch.from_numpy(normal((3, 5, 6), seed=14))
    got = kgru.gru_forward_pallas(layers, x, compute_dtype=torch.bfloat16)
    want = ks.gru_forward_faithful(layers, x)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    # a config pinned to the per-layer kernel takes it, never the stack
    before = _launches()
    pinned = kgru.gru_forward_pallas(layers, x, compute_dtype=torch.bfloat16, kernel="per_layer")
    for a, b in zip(pinned, _per_layer(layers, x, torch.bfloat16)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert _launches() == before


def test_router_raises_on_cuda_off_the_stack(monkeypatch):
    """Off the stack the router goes to the per-layer kernel wrapper, which
    on a tensor that is not on the CPU launches the kernel or raises: it
    never runs the plain sweep instead. (Here the wrapper is made to treat
    CPU tensors as off the CPU, and the launch raises on the device.)"""
    monkeypatch.setattr(kgru, "_plain_here", lambda x: False)
    x = torch.from_numpy(normal((2, 4, 6), seed=15))
    for L, dtype, kernel in ((3, torch.float32, "auto"), (1, torch.bfloat16, "auto"),
                             (3, torch.bfloat16, "per_layer")):
        layers = _torch_layers(_layers_np(6, 10, L, seed=16))
        with pytest.raises(ValueError, match="gru_layer_scan_x forward: unsupported device"):
            kgru.gru_forward_pallas(layers, x, compute_dtype=dtype, kernel=kernel)


def test_stack_plan_ok_shape_checks():
    assert ks.stack_plan_ok(_torch_layers(_layers_np(329, 501, 3, seed=0)))
    assert not ks.stack_plan_ok(_torch_layers(_layers_np(8, 16, 1, seed=0)))
    assert not ks.stack_plan_ok(_torch_layers(_layers_np(8, 16, 9, seed=0)))
    mixed = _torch_layers(_layers_np(8, 16, 2, seed=0)) + _torch_layers(_layers_np(16, 12, 1, seed=1))
    assert not ks.stack_plan_ok(mixed)


def test_kernel_wrappers_never_fall_back_off_the_cpu():
    L, T, B, I, H = 2, 3, 2, 4, 6
    meta = functools.partial(torch.empty, device="meta")
    args = (meta(T, B, I), meta(3 * H, I), meta(3 * H), meta(L - 1, 3 * H, H), meta(L - 1, 3 * H),
            meta(L, 3 * H, H), meta(L, 3 * H), meta(L, B, H))
    with pytest.raises(ValueError, match="unsupported device"):
        ks.gru_stack_scan(*args)
