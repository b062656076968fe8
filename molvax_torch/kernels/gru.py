"""The GRU kernel router of the training decode, and the per-layer kernels.

Port of ``molvax/kernels/gru.py``. The router (``gru_forward_pallas``,
``:856-938``) sends bf16 stacks that ``stack_plan_ok`` accepts to the fused
stack kernels (``kernels/gru_stack.py``), unless the config pins
``gru_kernel='per_layer'``. Everything else, strict fp32, single-layer and
non-uniform stacks, and pinned configs, runs one per-layer kernel per layer:

- ``gru_layer_scan_x`` (``:748``): one layer, input gates ``x @ W_ih``
  included, bf16 operands (``matmul_dtype='bfloat16'``) or strict fp32
  (``'float32'``: every operand, residual and cotangent fp32, no TF32).
  In bf16, wherever ``layer_route`` finds a layout (``stack_plan``), it runs
  the stack's pieces for one layer: forward, one tensor-core GEMM of the
  input gates over all T B rows (``csrc/gemm.cuh``), then the persistent
  recurrence with W_hh resident in shared memory (``csrc/gru_stack.cu``);
  backward, the persistent reverse sweep, one GEMM of dx (bf16 out) and one
  GEMM launch of dW_ih / db_ih and dW_hh / db_hh. Unlike the stack, every
  layer rounds the cotangent it passes down to bf16 (``gru.py:636-638``).
  Strict fp32, and bf16 shapes the plan cannot lay out, run the in-kernel
  instance of ``csrc/gru_layer.cu``: ``x[t] @ W_ih`` inside the recurrence
  on the FMA pipes, weights re-read from L2 each step; its backward is a
  reverse-sweep kernel that writes dx and the gate cotangents, then a dW
  contraction kernel. ``gru_layer_scan_x_in_kernel`` names that instance
  (the ``fwd_gi`` probe's kernel).
- ``gru_layer_scan`` (``:390``): the same recurrence with precomputed input
  gates, rounded to bf16 at the boundary; its backward returns dgi
  (``csrc/gru_layer.cu``).

``layer_forward_ref`` / ``layer_backward_ref`` and ``scan_forward_ref`` /
``scan_backward_ref`` are the same math in plain torch ops, rounding where
the kernels round; the bf16 persistent route also composes to them from
the stack's plain pieces (``gemm_ref``, ``layer_recurrence_ref``,
``layer_sweep_ref``), bit for bit. ``gru_probe_scan`` runs
``gru_layer_scan``'s forward kernel in the two modes of the design probe
``bench/gru_experiments.py::run_variant`` (forward only, no autograd; plain
version ``gru_probe_scan_ref``). For CUDA tensors the wrappers launch the
kernels or raise; the plain versions run only for tensors on the CPU (and
when called by name). Like the TPU kernels' custom VJPs, the backward reads
the stored residuals and rounds dgi / dgh and dx to the storage type, so it
is the kernels' gradient, not autograd's exact one.

Weights are in torch layout: ``w_ih`` (3H, I), ``w_hh`` (3H, H), the
transposes of the JAX arguments; sequences are (T, B, ·) as in the
reference. The TPU's batch and time blocking, its per-gate padding of H to
a multiple of 128 and its batch-size fallback (``pallas_batch_ok``) have no
counterpart: the kernels take any B and I, and any H that a layout or the
in-kernel instance's shared memory takes.
"""

from __future__ import annotations

import ctypes
import sys
from typing import List, Optional, Tuple

import torch

from ..utils import round_to
from . import _build, gru_stack
from .gru_stack import _check_cuda, _contract, _dw_job, _dx_job, _gemm, _is_padded, _padded, _stream, counter

# kernel launches made by the wrappers (not by the plain versions)
layer_gi_launches = 0  # bf16 gru_layer_scan_x forward: the input-gate GEMM
layer_rec_launches = 0  # ... and the persistent recurrence (per batch slice)
layer_sweep_launches = 0  # bf16 backward: the persistent reverse sweep (per slice)
layer_dx_launches = 0  # ... the GEMM of dx
layer_gemm_dw_launches = 0  # ... the GEMM of dW_ih, db_ih, dW_hh and db_hh (two jobs per part)
layer_dw_sum_launches = 0  # ... the sum of its parts
layer_fwd_launches = 0  # gru_layer_scan_x's in-kernel instance: forward
layer_bwd_launches = 0  # ... reverse sweep
scan_fwd_launches = 0  # gru_layer_scan forward
scan_bwd_launches = 0  # gru_layer_scan reverse sweep
layer_dw_launches = 0  # the dW contraction of either in-kernel backward
probe_matmul_only_launches = 0  # gru_probe_scan(mode='matmul_only')
probe_gates_nostore_launches = 0  # gru_probe_scan(mode='gates_nostore')

_RB = 4  # batch rows per block (csrc/common.cuh)
_MAX_SMEM = 232448  # an H100 block's dynamic shared memory, bytes
_MATMUL_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
PROBE_MODES = {"gates_nostore": 1, "matmul_only": 2}  # csrc/gru_layer.cu FwdMode
_warned_fp32 = False  # one-time note: the fused stack is bf16-only

Residuals = Tuple[torch.Tensor, ...]


def _plain_here(x: torch.Tensor) -> bool:
    """The wrappers run the plain versions for CPU tensors only."""
    return x.device.type == "cpu"


# -- plain versions ------------------------------------------------------------


def _recurrence_ref(gi_seq, w_hh, b_hh, h0, md) -> Residuals:
    """gi_seq (T, B, 3H) fp32 input gates, bias included -> residuals
    (hseq (T, B, H), rzn (T, B, 3H), ghn (T, B, H)) stored in ``md``; the
    h carry and the gates are fp32, h enters its product rounded to md."""
    T, B, G = gi_seq.shape
    H = G // 3
    dev = gi_seq.device
    hseq = torch.empty(T, B, H, dtype=md, device=dev)
    rzn = torch.empty(T, B, G, dtype=md, device=dev)
    ghn = torch.empty(T, B, H, dtype=md, device=dev)
    w = round_to(w_hh, md).T
    h = h0.float()
    for t in range(T):
        gi = gi_seq[t]
        gh = round_to(h, md) @ w + b_hh
        r = torch.sigmoid(gi[:, :H] + gh[:, :H])
        z = torch.sigmoid(gi[:, H : 2 * H] + gh[:, H : 2 * H])
        gn = gh[:, 2 * H :]
        n = torch.tanh(gi[:, 2 * H :] + r * gn)
        h = (1.0 - z) * n + z * h
        hseq[t] = h
        rzn[t] = torch.cat([r, z, n], dim=-1)
        ghn[t] = gn
    return hseq, rzn, ghn


def layer_forward_ref(x, w_ih, b_ih, w_hh, b_hh, h0, md: torch.dtype) -> Residuals:
    """``gru_layer_scan_x``'s forward kernel: x (T, B, I) -> residuals in
    ``md`` (bf16 or fp32). x and the weights are rounded to md; the input
    gates are an fp32 sum, never stored."""
    gi = round_to(x, md) @ round_to(w_ih, md).T + b_ih
    return _recurrence_ref(gi, w_hh, b_hh, h0, md)


def scan_forward_ref(gi, w_hh, b_hh, h0) -> Residuals:
    """``gru_layer_scan``'s forward kernel: gi (T, B, 3H) rounded to bf16
    at the boundary (``gru.py:409``) -> bf16 residuals."""
    bf = torch.bfloat16
    return _recurrence_ref(round_to(gi, bf), w_hh, b_hh, h0, bf)


def _probe_mode(mode: str) -> int:
    if mode not in PROBE_MODES:
        raise ValueError(f"probe mode must be one of {sorted(PROBE_MODES)}, got {mode!r}")
    return PROBE_MODES[mode]


def gru_probe_scan_ref(gi, w_hh, b_hh, h0, mode: str) -> torch.Tensor:
    """``gru_probe_scan``'s plain version: ``run_variant``'s kernel body
    (``bench/gru_experiments.py:61-83``) on gi (T, B, 3H), w_hh (3H, H),
    b_hh (3H), h0 (B, H) -> hseq (T, B, H) bf16. 'gates_nostore' is
    ``scan_forward_ref``'s h; 'matmul_only' carries h = (bf16(h) @ W_hh +
    b_hh)[:, :H] and reads no gi. bf16 h operand, fp32 sums, bf16 hseq."""
    if _probe_mode(mode) == PROBE_MODES["gates_nostore"]:
        return scan_forward_ref(gi, w_hh, b_hh, h0)[0]
    bf = torch.bfloat16
    T, B, G = gi.shape
    H = G // 3
    hseq = torch.empty(T, B, H, dtype=bf, device=gi.device)
    w = round_to(w_hh, bf).T
    h = h0.float()
    for t in range(T):
        h = (round_to(h, bf) @ w + b_hh)[:, :H]
        hseq[t] = h
    return hseq


def _sweep_ref(hseq, rzn, ghn, h0, w_hh, dY):
    """The reverse sweep over stored residuals (storage type md =
    hseq.dtype): dY (T, B, H) is the cotangent of hseq. Returns the gate
    cotangents dgi, dgh (T, B, 3H) in md, dh0 (B, H) fp32, and hprev
    (T, B, H) in md."""
    md = hseq.dtype
    T, B, H = hseq.shape
    hprev = torch.cat([h0.to(md)[None], hseq[:-1]], dim=0)
    w = round_to(w_hh, md)  # (3H, H)
    dgi = torch.empty(T, B, 3 * H, dtype=md, device=hseq.device)
    dgh = torch.empty_like(dgi)
    dh = torch.zeros(B, H, device=hseq.device)
    for t in reversed(range(T)):
        r, z, n = rzn[t].float().split(H, dim=-1)
        gn = ghn[t].float()
        hp = hprev[t].float()
        dout = dh + dY[t].float()
        dz = dout * (hp - n) * z * (1.0 - z)
        dn = dout * (1.0 - z) * (1.0 - n * n)
        dghn = dn * r
        dr = dn * gn * r * (1.0 - r)
        dgi[t] = torch.cat([dr, dz, dn], dim=-1)
        dgh[t] = torch.cat([dr, dz, dghn], dim=-1)
        dh = dout * z + dgh[t].float() @ w
    return dgi, dgh, dh, hprev


def layer_backward_ref(res: Residuals, dY: torch.Tensor):
    """``gru_layer_scan_x``'s backward kernels: res = (hseq, rzn, ghn, x,
    h0, w_ih, w_hh). Returns (dx, dW_ih, db_ih, dW_hh, db_hh, dh0), fp32;
    dx is rounded to the storage type (``gru.py:636-638``), the weight and
    bias gradients are fp32 sums of the rounded cotangents."""
    hseq, rzn, ghn, x, h0, w_ih, w_hh = res
    md = hseq.dtype
    dgi, dgh, dh0, hprev = _sweep_ref(hseq, rzn, ghn, h0, w_hh, dY)
    dx = round_to(dgi.float() @ round_to(w_ih, md), md)
    return (
        dx,
        _contract(dgi, x.to(md)),
        dgi.float().sum((0, 1)),
        _contract(dgh, hprev),
        dgh.float().sum((0, 1)),
        dh0,
    )


def scan_backward_ref(res: Residuals, dY: torch.Tensor):
    """``gru_layer_scan``'s backward: res = (hseq, rzn, ghn, h0, w_hh).
    Returns (dgi, dW_hh, db_hh, dh0), fp32; dgi is the fp32 of the bf16
    cotangent, and the dW_hh product takes bf16 operands (``gru.py:438-443``)."""
    hseq, rzn, ghn, h0, w_hh = res
    dgi, dgh, dh0, hprev = _sweep_ref(hseq, rzn, ghn, h0, w_hh, dY)
    return dgi.float(), _contract(dgh, hprev), dgh.float().sum((0, 1)), dh0


# -- the kernels ---------------------------------------------------------------


def smem_bytes(I: int, H: int, md: torch.dtype) -> int:
    """The larger shared-memory need of the per-layer forward (x staged,
    I wide; I = 0 for ``gru_layer_scan``) and reverse-sweep kernels."""
    s = torch.finfo(md).bits // 8
    carry = _RB * H * 4
    return max(carry + 2 * H * _RB * s + I * _RB * s, carry + 6 * H * _RB * s)


def _check_fits(what: str, I: int, H: int, md: torch.dtype) -> None:
    need = smem_bytes(I, H, md)
    if need > _MAX_SMEM:
        raise ValueError(f"{what}: I={I}, H={H} in {md} needs {need} bytes of shared memory per block, "
                         f"more than the {_MAX_SMEM} an H100 block has")


def _layer_dims(what, x, w_ih, w_hh, h0) -> Tuple[int, int, int, int]:
    T, B, I = x.shape
    B_h, H = h0.shape
    if B_h != B or tuple(w_ih.shape) != (3 * H, I) or tuple(w_hh.shape) != (3 * H, H):
        raise ValueError(f"{what}: x {tuple(x.shape)}, w_ih {tuple(w_ih.shape)}, "
                         f"w_hh {tuple(w_hh.shape)}, h0 {tuple(h0.shape)}")
    return T, B, I, H


def _check_layer(what, x, w_ih, w_hh, h0, md) -> Tuple[int, int, int, int]:
    T, B, I, H = _layer_dims(what, x, w_ih, w_hh, h0)
    _check_fits(what, I, H, md)
    return T, B, I, H


def _check_residuals(what, shape, md, hseq, rzn, ghn, dY, padded: bool = False) -> None:
    """The sweep reads the forward's residuals in place: in the storage type
    md, hseq and ghn of ``shape`` (T, B, H), rzn (T, B, 3H), contiguous; with
    ``padded`` (the persistent sweep's), hseq may also have its rows padded
    to a multiple of 8, as the persistent recurrence writes it. dY (T, B, H)."""
    T, B, H = shape
    if md not in _MATMUL_DTYPES.values():
        raise ValueError(f"{what}: residuals stored in {md}")
    for name, t, want in (("hseq", hseq, shape), ("rzn", rzn, (T, B, 3 * H)), ("ghn", ghn, shape)):
        in_place = t.is_contiguous() or (padded and name == "hseq" and _is_padded(t, md))
        if tuple(t.shape) != want or t.dtype != md or not in_place:
            raise ValueError(f"{what}: residual {name} {tuple(t.shape)} {t.dtype}, "
                             f"expected a contiguous {want} {md}")
    if tuple(dY.shape) != shape:
        raise ValueError(f"{what}: dY {tuple(dY.shape)}, expected {shape}")


def layer_route(B: int, H: int) -> str:
    """Which kernels run bf16 ``gru_layer_scan_x`` at batch B and width H,
    decided by shape before any launch: 'persistent' (the input-gate GEMM,
    the persistent recurrence and sweep, the dx and dW GEMMs) wherever
    ``stack_plan`` lays the persistent kernels out on the card, else
    'in_kernel' (``csrc/gru_layer.cu``'s bf16 instance)."""
    try:
        gru_stack.stack_plan(B, H)
    except ValueError:
        return "in_kernel"
    return "persistent"


def _persistent(md: torch.dtype, B: int, H: int) -> bool:
    return md == torch.bfloat16 and layer_route(B, H) == "persistent"


def _ptrs(*tensors):
    return [None if t is None else t.data_ptr() for t in tensors]


def _contract_kernel(x, h0s, hseq, dgi, dgh, T, B, I, H, md, with_ih: bool):
    """The dW contraction kernel: (dW_ih, db_ih) if with_ih, and (dW_hh,
    db_hh), fp32, torch layout."""
    global layer_dw_launches
    dev, G = hseq.device, 3 * H
    dwih = torch.empty(G, I, device=dev) if with_ih else None
    dbih = torch.empty(G, device=dev) if with_ih else None
    dwhh = torch.empty(G, H, device=dev)
    dbhh = torch.empty(G, device=dev)
    fn = _build.function("molvax_gru_layer_dw", [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    err = fn(*_ptrs(x, h0s, hseq, dgi, dgh, dwih, dbih, dwhh, dbhh),
             T, B, I, H, int(md == torch.float32), int(with_ih), _stream(hseq))
    _build.check(err, "gru_layer dW")
    layer_dw_launches += 1
    return dwih, dbih, dwhh, dbhh


_COUNT = {name: counter(globals(), f"layer_{name}_launches")
          for name in ("gi", "rec", "sweep", "dx", "gemm_dw", "dw_sum")}


def dw_parts(T: int, I: int, H: int) -> int:
    """The parts (of whole time steps) that the dW GEMM of one layer splits
    its T B rows into: its 128 x 128 output tiles of dW_ih | db_ih and
    dW_hh | db_hh, times the parts, take the fewest waves of the card's
    ``gru_stack.SMS`` SMs per part (ties to fewer parts; at most 4, at most
    T). At zinc250k width 84 tiles leave 48 of 132 SMs idle; in 3 parts 252
    tiles of a third of the rows fill two waves."""
    tiles = -(-3 * H // 128) * (-(-(I + 1) // 128) + -(-(H + 1) // 128))
    return min(range(1, min(4, T) + 1), key=lambda k: -(-tiles * k // gru_stack.SMS) / k)


def _sum_parts(parts: torch.Tensor, out: torch.Tensor) -> None:
    """out (n) = parts[0] + parts[1] + ... of parts (k, n), fp32, in that
    order: the second pass of the split dW GEMM, one launch."""
    fn = _build.function("molvax_sum_parts", [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                                              ctypes.c_void_p])
    _build.check(fn(parts.data_ptr(), parts.shape[0], parts.shape[1], out.data_ptr(), _stream(out)),
                 "gru_layer_scan_x dW parts")
    _COUNT["dw_sum"]()


def layer_forward(x, w_ih, b_ih, w_hh, b_hh, h0, md: torch.dtype) -> Residuals:
    """``layer_forward_ref`` on the card. bf16 on the persistent route
    (``layer_route``): the stack's input-gate GEMM over all T B rows, fp32
    gi with b_ih, then its persistent recurrence (one launch per batch
    slice of ``stack_plan``), counted on this module's counters; hseq comes
    back as a view of a buffer whose rows are padded to a multiple of 8. A
    bf16 x already so laid out (``_padded``) is read in place. Else
    ``layer_forward_in_kernel``."""
    what = "gru_layer_scan_x forward"
    _check_cuda(what, x, w_ih, b_ih, w_hh, b_hh, h0)
    T, B, I, H = _layer_dims(what, x, w_ih, w_hh, h0)
    if not _persistent(md, B, H):
        return layer_forward_in_kernel(x, w_ih, b_ih, w_hh, b_hh, h0, md)
    gi = gru_stack.gemm("gi", x, w_ih, b_ih, count=_COUNT["gi"])
    return gru_stack.layer_recurrence(gi, w_hh, b_hh, h0, count=_COUNT["rec"])


def layer_backward(res: Residuals, dY: torch.Tensor):
    """``layer_backward_ref`` on the card. bf16 on the persistent route: the
    stack's persistent reverse sweep (ext = dY, no h_final cotangent: on the
    per-layer route it arrives inside dY[-1]), one GEMM of dx stored in
    bf16, one GEMM launch of dW_ih / db_ih over x and dW_hh / db_hh over h
    one step behind (bf16(h0) first), two jobs for each of ``dw_parts``
    spans of time steps, and one launch that sums the parts. It reads hseq
    in place, padded or not, and x in place where it is laid out as
    ``_padded`` leaves it (the autograd wrapper saves the forward's copy).
    Deterministic: every output is summed in a fixed order. Else
    ``layer_backward_in_kernel``."""
    hseq, rzn, ghn, x, h0, w_ih, w_hh = res
    what = "gru_layer_scan_x backward"
    _check_cuda(what, hseq, rzn, ghn, x, h0, w_ih, w_hh, dY)
    T, B, I, H = _layer_dims(what, x, w_ih, w_hh, h0)
    if not _persistent(hseq.dtype, B, H):
        return layer_backward_in_kernel(res, dY)
    _check_residuals(what, (T, B, H), hseq.dtype, hseq, rzn, ghn, dY, padded=True)
    bf, dev, G = torch.bfloat16, x.device, 3 * H
    dgi, dgh, dh0 = gru_stack.layer_sweep(hseq, h0, rzn, ghn, w_hh, dY, torch.zeros(B, H, device=dev),
                                          count=_COUNT["sweep"])
    with torch.no_grad():
        hs, xp, h0b, wihp = (_padded(t) for t in (hseq, x, h0, w_ih))
    dx = torch.empty(T, B, I, dtype=bf, device=dev)
    _gemm("dx", [_dx_job(dgi, wihp, dx)], x, _COUNT["dx"])
    # each part: dW_ih | db_ih, then dW_hh | db_hh, of its span of steps
    k, n_ih, n_hh = dw_parts(T, I, H), G * I + G, G * H + G
    parts = torch.empty(k, n_ih + n_hh, device=dev)
    jobs = []
    for p in range(k):
        t0, t1 = p * T // k, (p + 1) * T // k
        ih, hh = parts[p, :n_ih], parts[p, n_ih:]
        jobs.append(_dw_job(dgi[t0:t1], xp[t0:t1], ih[: G * I].view(G, I), ih[G * I :]))
        first = dict(first=h0b) if t0 == 0 else {}  # h one step behind: bf16(h0), then hseq
        jobs.append(_dw_job(dgh[t0:t1], hs[max(t0 - 1, 0) : t1], hh[: G * H].view(G, H), hh[G * H :], **first))
    _gemm("dw", jobs, x, _COUNT["gemm_dw"])
    out = torch.empty(n_ih + n_hh, device=dev)
    _sum_parts(parts, out)
    dwih, dbih = out[: G * I].view(G, I), out[G * I : n_ih]
    dwhh, dbhh = out[n_ih : n_ih + G * H].view(G, H), out[n_ih + G * H :]
    return dx.float(), dwih, dbih, dwhh, dbhh, dh0


def layer_forward_in_kernel(x, w_ih, b_ih, w_hh, b_hh, h0, md: torch.dtype) -> Residuals:
    """``layer_forward_ref`` on the card through ``csrc/gru_layer.cu``: one
    launch of the forward kernel that computes ``x[t] @ W_ih`` inside the
    recurrence. Strict fp32, bf16 where ``layer_route`` says 'in_kernel',
    and the ``fwd_gi`` probe."""
    global layer_fwd_launches
    what = "gru_layer_scan_x forward"
    _check_cuda(what, x, w_ih, b_ih, w_hh, b_hh, h0)
    T, B, I, H = _check_layer(what, x, w_ih, w_hh, h0, md)
    dev = x.device
    with torch.no_grad():
        x_ = x.to(md).contiguous()
        # (in, 3H) copies: a warp reads 32 neighbouring gate columns
        wih_t = w_ih.t().to(md).contiguous()
        whh_t = w_hh.t().to(md).contiguous()
        bih_, bhh_, h0_ = (t.float().contiguous() for t in (b_ih, b_hh, h0))
    hseq = torch.empty(T, B, H, dtype=md, device=dev)
    rzn = torch.empty(T, B, 3 * H, dtype=md, device=dev)
    ghn = torch.empty(T, B, H, dtype=md, device=dev)
    fn = _build.function("molvax_gru_layer_x_fwd", [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    err = fn(*_ptrs(x_, wih_t, bih_, whh_t, bhh_, h0_, hseq, rzn, ghn),
             T, B, I, H, int(md == torch.float32), _stream(x))
    _build.check(err, what)
    layer_fwd_launches += 1
    return hseq, rzn, ghn


def layer_backward_in_kernel(res: Residuals, dY: torch.Tensor):
    """``layer_backward_ref`` on the card through ``csrc/gru_layer.cu``: the
    reverse-sweep kernel (dx inside it), then the dW / db contraction
    kernel. Contiguous residuals only."""
    global layer_bwd_launches
    hseq, rzn, ghn, x, h0, w_ih, w_hh = res
    what = "gru_layer_scan_x backward"
    _check_cuda(what, hseq, rzn, ghn, x, h0, w_ih, w_hh, dY)
    md = hseq.dtype
    T, B, I, H = _check_layer(what, x, w_ih, w_hh, h0, md)
    _check_residuals(what, (T, B, H), md, hseq, rzn, ghn, dY)
    dev = x.device
    with torch.no_grad():
        x_ = x.to(md).contiguous()
        h0s = h0.to(md).contiguous()
        # torch's (3H, in) layout is the transposed copy the sweep reads
        wih_, whh_ = w_ih.to(md).contiguous(), w_hh.to(md).contiguous()
        dY_ = dY.float().contiguous()
    dx = torch.empty(T, B, I, dtype=md, device=dev)
    dh0 = torch.empty(B, H, device=dev)
    dgi = torch.empty(T, B, 3 * H, dtype=md, device=dev)
    dgh = torch.empty_like(dgi)
    sweep = _build.function("molvax_gru_layer_x_bwd", [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    err = sweep(*_ptrs(hseq, h0s, rzn, ghn, dY_, wih_, whh_, dx, dh0, dgi, dgh),
                T, B, I, H, int(md == torch.float32), _stream(x))
    _build.check(err, what + " sweep")
    layer_bwd_launches += 1
    dwih, dbih, dwhh, dbhh = _contract_kernel(x_, h0s, hseq, dgi, dgh, T, B, I, H, md, True)
    return dx.float(), dwih, dbih, dwhh, dbhh, dh0


def _scan_operands(what, gi, w_hh, b_hh, h0):
    """The hoisted-gi forward's checks and operands: (T, B, H, gi bf16,
    W_hh (H, 3H) bf16, b_hh fp32, h0 fp32), contiguous."""
    bf = torch.bfloat16
    _check_cuda(what, gi, w_hh, b_hh, h0)
    T, B, G = gi.shape
    H = G // 3
    if tuple(w_hh.shape) != (G, H) or tuple(h0.shape) != (B, H):
        raise ValueError(f"{what}: gi {tuple(gi.shape)}, w_hh {tuple(w_hh.shape)}, h0 {tuple(h0.shape)}")
    _check_fits(what, 0, H, bf)
    with torch.no_grad():
        gi_ = gi.to(bf).contiguous()  # rounded at the boundary, as gru.py:409
        whh_t = w_hh.t().to(bf).contiguous()
        bhh_, h0_ = b_hh.float().contiguous(), h0.float().contiguous()
    return T, B, H, gi_, whh_t, bhh_, h0_


def scan_forward(gi, w_hh, b_hh, h0) -> Residuals:
    """``scan_forward_ref`` on the card: one launch of the forward kernel
    with the input gates read from device memory."""
    global scan_fwd_launches
    what = "gru_layer_scan forward"
    bf = torch.bfloat16
    T, B, H, gi_, whh_t, bhh_, h0_ = _scan_operands(what, gi, w_hh, b_hh, h0)
    dev = gi.device
    hseq = torch.empty(T, B, H, dtype=bf, device=dev)
    rzn = torch.empty(T, B, 3 * H, dtype=bf, device=dev)
    ghn = torch.empty(T, B, H, dtype=bf, device=dev)
    fn = _build.function("molvax_gru_layer_scan_fwd", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    err = fn(*_ptrs(gi_, whh_t, bhh_, h0_, hseq, rzn, ghn), T, B, H, _stream(gi))
    _build.check(err, what)
    scan_fwd_launches += 1
    return hseq, rzn, ghn


def gru_probe_scan(gi, w_hh, b_hh, h0, mode: str) -> torch.Tensor:
    """``gru_layer_scan``'s forward kernel as ``run_variant``'s probe:
    gi (T, B, 3H), w_hh (3H, H), b_hh (3H), h0 (B, H) -> hseq (T, B, H)
    bf16, forward only. ``mode`` 'gates_nostore' (the production kernel
    without its r|z|n and gh_n stores) or 'matmul_only' (the serial h @ W_hh
    chain and the carry; all 3H columns of the product are computed). One
    launch for CUDA tensors, ``gru_probe_scan_ref`` for CPU tensors."""
    global probe_matmul_only_launches, probe_gates_nostore_launches
    code = _probe_mode(mode)
    if _plain_here(gi):
        return gru_probe_scan_ref(gi, w_hh, b_hh, h0, mode)
    what = f"gru_probe_scan {mode}"
    T, B, H, gi_, whh_t, bhh_, h0_ = _scan_operands(what, gi, w_hh, b_hh, h0)
    hseq = torch.empty(T, B, H, dtype=torch.bfloat16, device=gi.device)
    fn = _build.function("molvax_gru_probe_scan_fwd",
                         [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    # the sink stays null: it only keeps matmul_only's z and n products live
    err = fn(code, *_ptrs(gi_, whh_t, bhh_, h0_, hseq, None), T, B, H, _stream(gi))
    _build.check(err, what)
    if code == PROBE_MODES["matmul_only"]:
        probe_matmul_only_launches += 1
    else:
        probe_gates_nostore_launches += 1
    return hseq


def scan_backward(res: Residuals, dY: torch.Tensor):
    """``scan_backward_ref`` on the card: the reverse-sweep kernel without
    the dx product, then the contraction kernel for dW_hh / db_hh."""
    global scan_bwd_launches
    hseq, rzn, ghn, h0, w_hh = res
    what = "gru_layer_scan backward"
    bf = torch.bfloat16
    _check_cuda(what, hseq, rzn, ghn, h0, w_hh, dY)
    T, B, H = hseq.shape
    if tuple(w_hh.shape) != (3 * H, H) or tuple(h0.shape) != (B, H):
        raise ValueError(f"{what}: hseq {tuple(hseq.shape)}, w_hh {tuple(w_hh.shape)}, h0 {tuple(h0.shape)}")
    _check_residuals(what, (T, B, H), bf, hseq, rzn, ghn, dY)
    _check_fits(what, 0, H, bf)
    dev = hseq.device
    with torch.no_grad():
        h0s = h0.to(bf).contiguous()
        whh_ = w_hh.to(bf).contiguous()
        dY_ = dY.float().contiguous()
    dh0 = torch.empty(B, H, device=dev)
    dgi = torch.empty(T, B, 3 * H, dtype=bf, device=dev)
    dgh = torch.empty_like(dgi)
    sweep = _build.function("molvax_gru_layer_scan_bwd", [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    err = sweep(*_ptrs(hseq, h0s, rzn, ghn, dY_, whh_, dh0, dgi, dgh), T, B, H, _stream(hseq))
    _build.check(err, what + " sweep")
    scan_bwd_launches += 1
    _, _, dwhh, dbhh = _contract_kernel(None, h0s, hseq, None, dgh, T, B, 0, H, bf, False)
    return dgi.float(), dwhh, dbhh, dh0


class _GRULayerX(torch.autograd.Function):
    """route: 'kernel' (``layer_forward`` / ``layer_backward``), 'in_kernel'
    (the ``csrc/gru_layer.cu`` instance) or 'plain'; tensors on the CPU
    always take the plain versions."""

    @staticmethod
    def forward(ctx, route, md, x, w_ih, b_ih, w_hh, b_hh, h0):
        ctx.route = "plain" if _plain_here(x) else route
        if ctx.route == "kernel" and x.is_cuda and _persistent(md, x.shape[1], h0.shape[-1]):
            x = _padded(x)  # the bf16 operand of the gi GEMM, kept for the dW GEMM
        fwd = {"plain": layer_forward_ref, "kernel": layer_forward, "in_kernel": layer_forward_in_kernel}
        hseq, rzn, ghn = fwd[ctx.route](x, w_ih, b_ih, w_hh, b_hh, h0, md)
        ctx.save_for_backward(hseq, rzn, ghn, x, h0, w_ih, w_hh)
        return hseq.float()

    @staticmethod
    def backward(ctx, dY):
        bwd = {"plain": layer_backward_ref, "kernel": layer_backward, "in_kernel": layer_backward_in_kernel}
        return (None, None, *bwd[ctx.route](ctx.saved_tensors, dY))


class _GRULayerScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plain, gi, w_hh, b_hh, h0):
        ctx.plain = plain or _plain_here(gi)
        fwd = scan_forward_ref if ctx.plain else scan_forward
        hseq, rzn, ghn = fwd(gi, w_hh, b_hh, h0)
        ctx.save_for_backward(hseq, rzn, ghn, h0, w_hh)
        return hseq.float()

    @staticmethod
    def backward(ctx, dY):
        bwd = scan_backward_ref if ctx.plain else scan_backward
        return (None, *bwd(ctx.saved_tensors, dY))


def _matmul_dtype(name: str) -> torch.dtype:
    if name not in _MATMUL_DTYPES:
        raise ValueError(f"matmul_dtype must be one of {sorted(_MATMUL_DTYPES)}, got {name!r}")
    return _MATMUL_DTYPES[name]


def gru_layer_scan_x(x, w_ih, b_ih, w_hh, b_hh, h0, matmul_dtype: str = "bfloat16") -> torch.Tensor:
    """One GRU layer, differentiable, input gates included: x (T, B, I),
    w_ih (3H, I), w_hh (3H, H), h0 (B, H) -> h_seq (T, B, H) fp32, the values
    of the stored h. ``matmul_dtype`` 'bfloat16' or 'float32' (strict mode),
    as the reference's. Kernels for CUDA tensors (bf16 on the route
    ``layer_route`` picks), the plain versions for CPU tensors."""
    return _GRULayerX.apply("kernel", _matmul_dtype(matmul_dtype), x, w_ih, b_ih, w_hh, b_hh, h0)


def gru_layer_scan_x_in_kernel(x, w_ih, b_ih, w_hh, b_hh, h0, matmul_dtype: str = "bfloat16") -> torch.Tensor:
    """``gru_layer_scan_x`` through the in-kernel instance of
    ``csrc/gru_layer.cu`` (``x[t] @ W_ih`` inside the recurrence) for CUDA
    tensors at any shape it fits: the kernel the ``fwd_gi`` probe times. The
    plain versions for CPU tensors."""
    return _GRULayerX.apply("in_kernel", _matmul_dtype(matmul_dtype), x, w_ih, b_ih, w_hh, b_hh, h0)


def gru_layer_scan_x_ref(x, w_ih, b_ih, w_hh, b_hh, h0, matmul_dtype: str = "bfloat16") -> torch.Tensor:
    """``gru_layer_scan_x`` through the plain versions on any device."""
    return _GRULayerX.apply("plain", _matmul_dtype(matmul_dtype), x, w_ih, b_ih, w_hh, b_hh, h0)


def gru_layer_scan(gi, w_hh, b_hh, h0) -> torch.Tensor:
    """The recurrent half of one GRU layer, differentiable: gi (T, B, 3H)
    precomputed input gates (x @ W_ih^T + b_ih), w_hh (3H, H), h0 (B, H)
    -> h_seq (T, B, H) fp32. bf16 only, as the reference's. Kernels for
    CUDA tensors, the plain versions for CPU tensors."""
    return _GRULayerScan.apply(False, gi, w_hh, b_hh, h0)


def gru_layer_scan_ref(gi, w_hh, b_hh, h0) -> torch.Tensor:
    """``gru_layer_scan`` through the plain versions on any device."""
    return _GRULayerScan.apply(True, gi, w_hh, b_hh, h0)


# -- the router ----------------------------------------------------------------


def _note_fused_stack_fp32() -> None:
    global _warned_fp32
    if not _warned_fp32:
        _warned_fp32 = True
        print(
            "[molvax_torch] note: the fused-stack kernel is bf16-only; "
            "compute_dtype='float32' routes the strict-fp32 per-layer kernels instead",
            file=sys.stderr,
        )


def gru_forward_pallas(
    layers: List[dict],
    x_seq: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    kernel: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``nn.gru.gru_forward`` through the hand-written kernels:
    x_seq (B, T, in) -> (out (B, T, H), h_final (L, B, H)).

    ``kernel`` is ``ModelConfig.gru_kernel``: 'auto' and 'fused_stack' take
    the stack kernels where they apply, 'per_layer' never does. Strict fp32
    always takes the per-layer kernels in fp32 mode (a pinned 'fused_stack'
    gets a one-time note). h_final is each layer's stored last step."""
    strict_fp32 = compute_dtype != torch.bfloat16
    if strict_fp32 and kernel == "fused_stack":
        _note_fused_stack_fp32()
    if not strict_fp32 and kernel != "per_layer" and gru_stack.stack_plan_ok(layers):
        return gru_stack.gru_forward_wavefront(layers, x_seq, h0)
    md = "float32" if strict_fp32 else "bfloat16"
    B = x_seq.shape[0]
    H = layers[0]["w_hh"].shape[1]
    if h0 is None:
        h0 = torch.zeros(len(layers), B, H, device=x_seq.device)
    inp = x_seq.transpose(0, 1)  # (T, B, in)
    finals = []
    for li, layer in enumerate(layers):
        # module-level lookup, so that a swap of the wrapper takes effect
        inp = gru_layer_scan_x(inp, layer["w_ih"], layer["b_ih"], layer["w_hh"], layer["b_hh"], h0[li], md)
        finals.append(inp[-1])
    return inp.transpose(0, 1), torch.stack(finals)
