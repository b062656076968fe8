"""Fused stacked-GRU recurrence for training: wrappers and plain versions.

Port of ``molvax/kernels/gru_stack.py:551-774``. ``gru_stack_scan`` runs
every layer of a GRU stack in one launch of the hand-written forward kernel
(``csrc/gru_stack.cu``), storing bf16 residuals (h sequences, r|z|n, gh_n);
its backward is a reverse-sweep kernel that writes the bf16 gate cotangents
dgi / dgh and dx0, then a contraction kernel that sums them into the weight
and bias gradients. ``stack_forward_ref`` / ``stack_backward_ref`` are the
same math in plain torch ops, rounding where the kernels round. For CUDA
tensors the wrappers launch the kernels or raise; the plain versions run
only for tensors on the CPU (and when called by name). ``gru_fused3_scan``
runs the forward kernel as the design probe
``bench/gru_experiments.py::run_fused3`` (layer 0's input gates given, no
residuals; plain version ``gru_fused3_scan_ref``).

The backward is not autograd of the forward: like the TPU kernel it reads
bf16 residuals and rounds dgi / dgh to bf16 (``gru_stack.py:400-401``), so
it is the TPU kernel's gradient, not the exact one.

Weights are in torch layout: ``wih0`` (3H, I0), ``wih`` (L-1, 3H, H),
``whh`` (L, 3H, H), the transposes of the JAX arguments. The TPU's VMEM
planner (``_plan_blocks``, ``_bwd_bytes``) and its per-gate padding of H to
a multiple of 128 have no counterpart: the kernels take any B and H.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from ..utils import round_to
from . import _build

# kernel launches made by the wrappers (not by the plain versions)
fwd_launches = 0
bwd_launches = 0
dw_launches = 0
fused3_launches = 0  # gru_fused3_scan

_MAX_LAYERS = 8  # the dW kernel's job table holds two matrices per layer

Residuals = Tuple[torch.Tensor, ...]


def stack_plan_ok(layers: Sequence[dict]) -> bool:
    """True if the fused stack kernels take this stack: at least 2 layers
    (at most 8), and every layer but the first maps H to H."""
    L = len(layers)
    if not 2 <= L <= _MAX_LAYERS:
        return False
    H = layers[0]["w_hh"].shape[1]
    if tuple(layers[0]["w_hh"].shape) != (3 * H, H):
        return False
    return all(
        tuple(layer["w_ih"].shape) == (3 * H, H) and tuple(layer["w_hh"].shape) == (3 * H, H)
        for layer in layers[1:]
    )


# -- plain versions ------------------------------------------------------------


def _stack_ref(gi_first, wih, bih, whh, bhh, h0) -> Residuals:
    """Layer 0's recurrence over its fp32 input gates gi_first (T, B, 3H),
    bias included; layer l > 0 computes its gates from the bf16 h sequence
    of the layer below. Residuals as ``stack_forward_ref``'s."""
    bf = torch.bfloat16
    T, B, _ = gi_first.shape
    L, _, H = h0.shape
    dev = gi_first.device
    hseq = torch.empty(L, T, B, H, dtype=bf, device=dev)
    rzn = torch.empty(L, T, B, 3 * H, dtype=bf, device=dev)
    ghn = torch.empty(L, T, B, H, dtype=bf, device=dev)
    for l in range(L):
        if l == 0:
            gi_seq = gi_first
        else:
            gi_seq = hseq[l - 1].float() @ round_to(wih[l - 1], bf).T + bih[l - 1]
        w_hh, b_hh = round_to(whh[l], bf).T, bhh[l]
        h = h0[l].float()
        for t in range(T):
            gi = gi_seq[t]
            gh = round_to(h, bf) @ w_hh + b_hh
            r = torch.sigmoid(gi[:, :H] + gh[:, :H])
            z = torch.sigmoid(gi[:, H : 2 * H] + gh[:, H : 2 * H])
            gn = gh[:, 2 * H :]
            n = torch.tanh(gi[:, 2 * H :] + r * gn)
            h = (1.0 - z) * n + z * h
            hseq[l, t] = h
            rzn[l, t] = torch.cat([r, z, n], dim=-1)
            ghn[l, t] = gn
    return hseq, rzn, ghn


def stack_forward_ref(x0, wih0, bih0, wih, bih, whh, bhh, h0) -> Residuals:
    """The forward kernel's math: x0 (T, B, I0) -> residuals (hseq (L, T, B,
    H), rzn (L, T, B, 3H), ghn (L, T, B, H)), all bf16. x0 and the weights
    are rounded to bf16, products accumulate in fp32, gates and the h carry
    are fp32; layer l > 0 reads the bf16 h sequence of the layer below."""
    bf = torch.bfloat16
    return _stack_ref(round_to(x0, bf) @ round_to(wih0, bf).T + bih0, wih, bih, whh, bhh, h0)


def gru_fused3_scan_ref(gi0, wih, bih, whh, bhh, h0) -> torch.Tensor:
    """``gru_fused3_scan``'s plain version, the body of ``run_fused3``
    (``bench/gru_experiments.py:111-152``): layer 0's gates are gi0
    (T, B, 3H) rounded to bf16, bias included -> hseq (L, T, B, H) bf16."""
    return _stack_ref(round_to(gi0, torch.bfloat16), wih, bih, whh, bhh, h0)[0]


def _hprev(hseq: torch.Tensor, h0: torch.Tensor, l: int) -> torch.Tensor:
    """Layer l's h at step t-1 for every t, bf16: (T, B, H)."""
    return torch.cat([h0[l].to(torch.bfloat16)[None], hseq[l, :-1]], dim=0)


def _contract(d: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum over (t, b) of d^T x: (T, B, M) x (T, B, N) -> (M, N), fp32."""
    return d.reshape(-1, d.shape[-1]).float().T @ x.reshape(-1, x.shape[-1]).float()


def stack_backward_ref(res: Residuals, dY: torch.Tensor, dhf: torch.Tensor):
    """The backward kernels' math, an explicit reverse sweep over the stored
    residuals. res = (hseq, rzn, ghn, x0, h0, wih0, wih, whh); dY (T, B, H)
    is the cotangent of the top layer's outputs, dhf (L, B, H) of h_final.
    Returns (dx0, dwih0, dbih0, dwih, dbih, dwhh, dbhh, dh0), fp32; dx0 is
    rounded to bf16 as the kernel stores it."""
    hseq, rzn, ghn, x0, h0, wih0, wih, whh = res
    bf = torch.bfloat16
    L, T, B, H = hseq.shape
    dgi = torch.empty(L, T, B, 3 * H, dtype=bf, device=hseq.device)
    dgh = torch.empty_like(dgi)
    dh0 = torch.empty(L, B, H, device=hseq.device)
    ext = dY.float()  # cotangent from above, per step, for the current layer
    for l in reversed(range(L)):
        w_hh = round_to(whh[l], bf)
        dh = dhf[l].float()
        for t in reversed(range(T)):
            r, z, n = rzn[l, t].float().split(H, dim=-1)
            gn = ghn[l, t].float()
            hp = (hseq[l, t - 1] if t > 0 else h0[l].to(bf)).float()
            dout = dh + ext[t]
            dz = dout * (hp - n) * z * (1.0 - z)
            dn = dout * (1.0 - z) * (1.0 - n * n)
            dghn = dn * r
            dr = dn * gn * r * (1.0 - r)
            dgi[l, t] = torch.cat([dr, dz, dn], dim=-1)
            dgh[l, t] = torch.cat([dr, dz, dghn], dim=-1)
            dh = dout * z + dgh[l, t].float() @ w_hh
        dh0[l] = dh
        w_in = wih0 if l == 0 else wih[l - 1]
        ext = dgi[l].float() @ round_to(w_in, bf)  # (T, B, in): the layer below's
    dx0 = round_to(ext, bf)
    x0b = x0.to(bf)
    dwih0, dbih0 = _contract(dgi[0], x0b), dgi[0].float().sum((0, 1))
    dwih = torch.stack([_contract(dgi[l], hseq[l - 1]) for l in range(1, L)])
    dbih = torch.stack([dgi[l].float().sum((0, 1)) for l in range(1, L)])
    dwhh = torch.stack([_contract(dgh[l], _hprev(hseq, h0, l)) for l in range(L)])
    dbhh = dgh.float().sum((1, 2))
    return dx0, dwih0, dbih0, dwih, dbih, dwhh, dbhh, dh0


# -- the kernels ---------------------------------------------------------------


def _check_cuda(what: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: tensors are on different devices")


def _check_shape(what: str, name: str, t: torch.Tensor, want: Tuple[int, ...]) -> None:
    if tuple(t.shape) != want:
        raise ValueError(f"{what}: {name} is {tuple(t.shape)}, expected {want}")


def _check_layers(what: str, first: torch.Tensor, wih, whh, h0) -> Tuple[int, int]:
    """The checks every stack kernel's wrapper shares: 2 to _MAX_LAYERS
    layers, h0 (L, B, H) with B the batch of layer 0's input ``first``
    (T, B, ·), wih (L-1, 3H, H) and whh (L, 3H, H). Returns (L, H)."""
    L, B_h, H = h0.shape
    if not 2 <= L <= _MAX_LAYERS or B_h != first.shape[1]:
        raise ValueError(f"{what}: {L} layers, h0 {tuple(h0.shape)}, layer 0's input {tuple(first.shape)}")
    _check_shape(what, "wih", wih, (L - 1, 3 * H, H))
    _check_shape(what, "whh", whh, (L, 3 * H, H))
    return L, H


def _check_shapes(x0, wih0, wih, whh, h0) -> Tuple[int, int, int, int, int]:
    T, B, I0 = x0.shape
    L, H = _check_layers("gru_stack", x0, wih, whh, h0)
    _check_shape("gru_stack", "wih0", wih0, (3 * H, I0))
    return T, B, I0, H, L


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def stack_forward(x0, wih0, bih0, wih, bih, whh, bhh, h0) -> Residuals:
    """``stack_forward_ref`` on the card: one launch of the forward kernel."""
    global fwd_launches
    _check_cuda("gru_stack forward", x0, wih0, bih0, wih, bih, whh, bhh, h0)
    T, B, I0, H, L = _check_shapes(x0, wih0, wih, whh, h0)
    bf, dev = torch.bfloat16, x0.device
    with torch.no_grad():
        x0b = x0.to(bf).contiguous()
        # (in, 3H) copies: a warp reads 32 neighbouring gate columns
        wih0_t = wih0.t().to(bf).contiguous()
        wih_t = wih.transpose(1, 2).to(bf).contiguous()
        whh_t = whh.transpose(1, 2).to(bf).contiguous()
        bih0_, bih_, bhh_ = (b.float().contiguous() for b in (bih0, bih, bhh))
        h0_ = h0.float().contiguous()
    hseq = torch.empty(L, T, B, H, dtype=bf, device=dev)
    rzn = torch.empty(L, T, B, 3 * H, dtype=bf, device=dev)
    ghn = torch.empty(L, T, B, H, dtype=bf, device=dev)
    fn = _build.function("molvax_gru_stack_fwd", [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    err = fn(
        *(t.data_ptr() for t in (x0b, wih0_t, bih0_, wih_t, bih_, whh_t, bhh_, h0_, hseq, rzn, ghn)),
        T, B, I0, H, L, _stream(x0),
    )
    _build.check(err, "gru_stack forward")
    fwd_launches += 1
    return hseq, rzn, ghn


def stack_backward(res: Residuals, dY: torch.Tensor, dhf: torch.Tensor):
    """``stack_backward_ref`` on the card: the reverse-sweep kernel, then the
    dW / db contraction kernel."""
    global bwd_launches, dw_launches
    hseq, rzn, ghn, x0, h0, wih0, wih, whh = res
    _check_cuda("gru_stack backward", hseq, rzn, ghn, x0, h0, wih0, wih, whh, dY, dhf)
    T, B, I0, H, L = _check_shapes(x0, wih0, wih, whh, h0)
    bf, dev, G = torch.bfloat16, x0.device, 3 * H
    with torch.no_grad():
        x0b = x0.to(bf).contiguous()
        h0b = h0.to(bf).contiguous()
        # torch's (3H, in) layout is the transposed copy the sweep reads
        wih0_b, wih_b, whh_b = (w.to(bf).contiguous() for w in (wih0, wih, whh))
        dY_, dhf_ = dY.float().contiguous(), dhf.float().contiguous()
    dx0 = torch.empty(T, B, I0, dtype=bf, device=dev)
    dh0 = torch.empty(L, B, H, device=dev)
    dgi = torch.empty(L, T, B, G, dtype=bf, device=dev)
    dgh = torch.empty_like(dgi)
    sweep = _build.function("molvax_gru_stack_bwd", [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    err = sweep(
        *(t.data_ptr() for t in (hseq, h0b, rzn, ghn, dY_, dhf_, wih0_b, wih_b, whh_b, dx0, dh0, dgi, dgh)),
        T, B, I0, H, L, _stream(x0),
    )
    _build.check(err, "gru_stack backward sweep")
    bwd_launches += 1
    dwih0 = torch.empty(G, I0, device=dev)
    dbih0 = torch.empty(G, device=dev)
    dwih = torch.empty(L - 1, G, H, device=dev)
    dbih = torch.empty(L - 1, G, device=dev)
    dwhh = torch.empty(L, G, H, device=dev)
    dbhh = torch.empty(L, G, device=dev)
    contract = _build.function("molvax_gru_stack_dw", [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    err = contract(
        *(t.data_ptr() for t in (x0b, h0b, hseq, dgi, dgh, dwih0, dbih0, dwih, dbih, dwhh, dbhh)),
        T, B, I0, H, L, _stream(x0),
    )
    _build.check(err, "gru_stack dW")
    dw_launches += 1
    return dx0.float(), dwih0, dbih0, dwih, dbih, dwhh, dbhh, dh0


def gru_fused3_scan(gi0, wih, bih, whh, bhh, h0) -> torch.Tensor:
    """The stack forward kernel as ``run_fused3``'s probe: gi0 (T, B, 3H)
    layer 0's input gates (bias included), wih (L-1, 3H, H), bih (L-1, 3H),
    whh (L, 3H, H), bhh (L, 3H), h0 (L, B, H) -> hseq (L, T, B, H) bf16,
    forward only, no residuals. The TPU probe also wrote a copy of the top
    layer (``htop``) to have it contiguous; ``hseq[L-1]`` already is. One
    launch for CUDA tensors, ``gru_fused3_scan_ref`` for CPU tensors."""
    global fused3_launches
    if gi0.device.type == "cpu":
        return gru_fused3_scan_ref(gi0, wih, bih, whh, bhh, h0)
    what = "gru_fused3_scan"
    _check_cuda(what, gi0, wih, bih, whh, bhh, h0)
    T, B = gi0.shape[:2]
    L, H = _check_layers(what, gi0, wih, whh, h0)
    G = 3 * H
    for name, t, want in (("gi0", gi0, (T, B, G)), ("bih", bih, (L - 1, G)), ("bhh", bhh, (L, G))):
        _check_shape(what, name, t, want)
    bf = torch.bfloat16
    with torch.no_grad():
        gi0_ = gi0.to(bf).contiguous()
        # (in, 3H) copies, as stack_forward's
        wih_t = wih.transpose(1, 2).to(bf).contiguous()
        whh_t = whh.transpose(1, 2).to(bf).contiguous()
        bih_, bhh_, h0_ = (t.float().contiguous() for t in (bih, bhh, h0))
    zeros = torch.zeros(G, device=gi0.device)  # b_ih0: gi0 holds layer 0's bias
    hseq = torch.empty(L, T, B, H, dtype=bf, device=gi0.device)
    fn = _build.function("molvax_gru_fused3_fwd", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(*(t.data_ptr() for t in (gi0_, zeros, wih_t, bih_, whh_t, bhh_, h0_, hseq)), T, B, H, L,
             _stream(gi0))
    _build.check(err, what)
    fused3_launches += 1
    return hseq


class _GRUStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plain, x0, wih0, bih0, wih, bih, whh, bhh, h0):
        ctx.plain = plain or x0.device.type == "cpu"
        fwd = stack_forward_ref if ctx.plain else stack_forward
        hseq, rzn, ghn = fwd(x0, wih0, bih0, wih, bih, whh, bhh, h0)
        ctx.save_for_backward(hseq, rzn, ghn, x0, h0, wih0, wih, whh)
        # h_final is the bf16-stored last step, not the fp32 carry
        return hseq[-1].float(), hseq[:, -1].float()

    @staticmethod
    def backward(ctx, dY, dhf):
        bwd = stack_backward_ref if ctx.plain else stack_backward
        return (None, *bwd(ctx.saved_tensors, dY, dhf))


def gru_stack_scan(x0, wih0, bih0, wih, bih, whh, bhh, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole stack, differentiable: x0 (T, B, I0) -> (out (T, B, H) fp32,
    the top layer's bf16 outputs; h_final (L, B, H)). Kernels for CUDA
    tensors, the plain versions for CPU tensors. The caller has checked
    ``stack_plan_ok``."""
    return _GRUStack.apply(False, x0, wih0, bih0, wih, bih, whh, bhh, h0)


def gru_stack_scan_ref(x0, wih0, bih0, wih, bih, whh, bhh, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``gru_stack_scan`` through the plain versions on any device."""
    return _GRUStack.apply(True, x0, wih0, bih0, wih, bih, whh, bhh, h0)


def _stacked(layers: List[dict]):
    return (
        layers[0]["w_ih"],
        layers[0]["b_ih"],
        torch.stack([layer["w_ih"] for layer in layers[1:]]),
        torch.stack([layer["b_ih"] for layer in layers[1:]]),
        torch.stack([layer["w_hh"] for layer in layers]),
        torch.stack([layer["b_hh"] for layer in layers]),
    )


def gru_forward_wavefront(
    layers: List[dict], x_seq: torch.Tensor, h0: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``nn.gru.gru_forward`` through the stack kernels:
    x_seq (B, T, I0) -> (out (B, T, H), h_final (L, B, H)). (The name is the
    reference's.)"""
    B = x_seq.shape[0]
    H = layers[0]["w_hh"].shape[1]
    if h0 is None:
        h0 = torch.zeros(len(layers), B, H, device=x_seq.device)
    wih0, bih0, wih, bih, whh, bhh = _stacked(layers)
    out, h_final = gru_stack_scan(x_seq.transpose(0, 1), wih0, bih0, wih, bih, whh, bhh, h0)
    return out.transpose(0, 1), h_final


def gru_forward_faithful(
    layers: List[dict], x_seq: torch.Tensor, h0: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward with the reference twin's interface
    (``gru_forward_faithful(round_gi='none')``): x_seq (B, T, I0) ->
    (out (B, T, H), h_final (L, B, H)), rounding where the kernel rounds."""
    B = x_seq.shape[0]
    H = layers[0]["w_hh"].shape[1]
    if h0 is None:
        h0 = torch.zeros(len(layers), B, H, device=x_seq.device)
    wih0, bih0, wih, bih, whh, bhh = _stacked(layers)
    with torch.no_grad():
        hseq, _, _ = stack_forward_ref(x_seq.transpose(0, 1), wih0, bih0, wih, bih, whh, bhh, h0)
    return hseq[-1].float().transpose(0, 1), hseq[:, -1].float()
