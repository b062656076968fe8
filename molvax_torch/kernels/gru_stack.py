"""Stacked-GRU recurrence for training: wrappers, planner and plain versions.

Port of ``molvax/kernels/gru_stack.py:551-774``. ``gru_stack_scan`` runs the
stack one layer after the other (batch rows are independent, so this is the
TPU kernels' math in another order). Forward, per layer: the input gates
of every step in one bf16 tensor-core GEMM (``csrc/gemm.cuh``), then one
persistent launch of the recurrence (``csrc/gru_stack.cu``), which stores
the bf16 residuals (h sequence, r|z|n, gh_n). Backward, per layer from the
top: one persistent launch of the reverse sweep, which writes the bf16 gate
cotangents dgi / dgh, then the GEMM that passes the cotangent to the layer
below (dx0, rounded to bf16, for layer 0); then one GEMM launch contracts
every dW and db of the stack. ``stack_plan`` lays the persistent kernels
out on the card's SMs. The bf16 per-layer route (``kernels/gru.py``) runs
``gemm``, ``layer_recurrence`` and ``layer_sweep`` for one layer, counted
on its own counters; its strict-fp32 instance runs the same pieces with
fp32 operands and residuals (``md=torch.float32``: fp32, or 3xTF32 split
products of fp32 accuracy, ``csrc/gemm.cuh``), planned with 4-byte
elements.

Every kernel has its plain version here, the same math in plain torch ops,
rounding where the kernel rounds: ``gemm_ref`` (each of the GEMM's three
epilogues), ``layer_recurrence_ref`` and ``layer_sweep_ref``.
``stack_forward_ref`` / ``stack_backward_ref`` are their compositions. For
CUDA tensors the wrappers launch the kernels or raise; the plain versions
run only for tensors on the CPU (and when called by name).
``gru_fused3_scan`` runs the previous design's stack forward kernel as the
design probe ``bench/gru_experiments.py::run_fused3`` (layer 0's input
gates given, no residuals; plain version ``gru_fused3_scan_ref``).

The backward is not autograd of the forward: like the TPU kernel it reads
bf16 residuals and rounds dgi / dgh to bf16 (``gru_stack.py:400-401``), so
it is the TPU kernel's gradient, not the exact one.

Weights are in torch layout: ``wih0`` (3H, I0), ``wih`` (L-1, 3H, H),
``whh`` (L, 3H, H), the transposes of the JAX arguments. The TPU's VMEM
planner (``_plan_blocks``, ``_bwd_bytes``) and its per-gate padding of H to
a multiple of 128 have no counterpart; the kernels' operands have rows a
multiple of 16 bytes apart (8 bf16, 4 fp32), so the wrappers copy an
operand into a padded buffer where it is not so already (``_padded``), and
the forward returns the h sequence as a view of such a buffer.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..utils import round_to
from . import _build

# kernel launches made by the wrappers (not by the plain versions)
gemm_gi_launches = 0  # input gates (forward), one per layer
rec_launches = 0  # forward recurrence, one per layer (and batch slice)
sweep_launches = 0  # reverse sweep, one per layer (and batch slice)
gemm_dx_launches = 0  # cotangent for the layer below, one per layer
dw_launches = 0  # dW / db of the whole stack, one per backward
fused3_launches = 0  # gru_fused3_scan


def counter(space: dict, name: str) -> Callable[[], None]:
    """A function that adds one to the launch counter ``name`` of the module
    whose globals are ``space``: the launch helpers below count into the
    stack's counters, or into the caller's (``kernels/gru.py``'s bf16
    per-layer route runs the same kernels)."""

    def count() -> None:
        space[name] += 1

    return count


_MAX_LAYERS = 8  # the dW launch holds two products per layer (csrc/gemm.cuh)

# an H100 SXM: SMs, and the dynamic shared memory of one block. The
# wrappers plan from the card's own (``card_limits``); these are the plan
# where nothing is launched (planning on the CPU).
SMS, SMEM = 132, 232448
_MAX_UNITS = 64  # hidden units per block: one warp per 8, at most 8 warps
_MAX_ROWS = 64  # batch rows per group: 1 to 4 m16 tiles (kernel instances)
_PAD_BYTES = 16  # padding per shared-memory row (csrc/gru_stack.cu SPAD)

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


# -- the planner ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _card_limits(index: int) -> Tuple[int, int]:
    fn = _build.function("molvax_card_limits", [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    sms, smem = ctypes.c_int(), ctypes.c_int()
    _build.check(fn(index, ctypes.byref(sms), ctypes.byref(smem)), "molvax_card_limits (attribute query)")
    return sms.value, smem.value


def card_limits(device) -> Tuple[int, int]:
    """(SMs, shared memory a block may opt in to) of the CUDA card
    ``device``, from the CUDA runtime: what the cooperative kernels (the
    stack's recurrence and sweep, the persistent decode of
    ``kernels/generate.py``) are laid out by, so that a launch fits the card
    it runs on (an H100 PCIe's 114 SMs, a MIG slice) and not only an H100
    SXM's 132."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"card_limits: {device} is not a CUDA device")
    return _card_limits(torch.cuda.current_device() if device.index is None else device.index)


def plan_limits(device) -> Tuple[int, int]:
    """The (SMs, shared memory) to plan tensors on ``device`` by: the
    card's own on a CUDA device (``card_limits``), an H100 SXM's (``SMS``,
    ``SMEM``) on any other, where nothing is launched."""
    device = torch.device(device)
    return card_limits(device) if device.type == "cuda" else (SMS, SMEM)


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class StackPlan:
    """How the persistent recurrence and sweep lie on the card: ``g`` row
    groups of ``rows`` batch rows, each of ``q`` blocks that own ``units``
    hidden units (all three gate columns of each) with their W_hh slice
    resident in shared memory; ``slices`` launches per layer cover B rows.
    Each step's h (dgh backward) row block streams through shared memory
    in chunks of ``*_chunk`` columns (one buffer if a chunk is all of it,
    else two); ``*_smem`` are the blocks' shared-memory bytes."""

    g: int
    q: int
    units: int
    rows: int
    slices: int
    fwd_chunk: int
    bwd_chunk: int
    fwd_smem: int
    bwd_smem: int

    @property
    def blocks(self) -> int:
        return self.g * self.q


def _ring(rows: int, chunk: int, K: int, esize: int = 2) -> int:
    return (1 if chunk >= K else 2) * rows * (chunk * esize + _PAD_BYTES)


def _chunk(resident: int, rows: int, K: int, smem: int, esize: int = 2) -> Optional[int]:
    """The widest chunk of K (a multiple of 16) whose ring of ``esize``-byte
    elements fits beside the resident weights, or None."""
    if resident + _ring(rows, K, K, esize) <= smem:
        return K
    chunk = ((smem - resident) // (2 * rows) - _PAD_BYTES) // esize // 16 * 16
    return min(chunk, K) if chunk >= 16 else None


@functools.lru_cache(maxsize=64)
def stack_plan(B: int, H: int, sms: int = SMS, smem: int = SMEM, esize: int = 2) -> StackPlan:
    """Lay out the recurrence and the sweep for batch B and width H on a
    card of ``sms`` SMs with ``smem`` bytes of shared memory per block, one
    block per SM, for operands of ``esize`` bytes (2: bf16, 4: strict
    fp32). Each candidate slice width (units, a multiple of 8) gives
    q = ceil(H / units) blocks per group and as many row groups as the SMs
    hold (g q <= sms, rows >= 16); it fits if both kernels' resident W_hh
    slices (3 units x H forward, units x 3H backward) leave room for
    their rings. Among those that fit, the plan takes the fewest launches
    per layer, then the least estimated step time: a warp's serial
    product (m16 tiles x k16 steps, forward and backward) plus a
    synchronisation per chunk."""
    if B < 1 or H < 1 or esize not in (2, 4):
        raise ValueError(f"stack_plan: B={B}, H={H}, esize={esize}")
    Kf, Kb = _up(H, 16), _up(3 * H, 16)
    best = None
    for units in range(min(_MAX_UNITS, _up(H, 8)), 7, -8):
        q = -(-H // units)
        if q > sms:
            break
        g = max(1, min(sms // q, -(-B // 16)))
        rows = min(_MAX_ROWS, _up(-(-B // g), 16))
        slices = -(-B // (g * rows))
        if slices == 1:
            g = -(-B // rows)
        wf, wb = 3 * units * (Kf * esize + _PAD_BYTES), units * (Kb * esize + _PAD_BYTES)
        cf, cb = _chunk(wf, rows, Kf, smem, esize), _chunk(wb, rows, Kb, smem, esize)
        if cf is None or cb is None:
            continue
        plan = StackPlan(g, q, units, rows, slices, cf, cb, wf + _ring(rows, cf, Kf, esize),
                         wb + _ring(rows, cb, Kb, esize))
        steps = rows // 16 * (Kf + Kb) // 16 * 10 + (-(-Kf // cf) + -(-Kb // cb)) * 200
        key = (slices, steps, -units)
        if best is None or key < best[0]:
            best = (key, plan)
    if best is None:
        raise ValueError(f"stack_plan: no layout fits H={H} ({esize}-byte elements) in {smem} bytes of "
                         "shared memory")
    return best[1]


# -- plain versions ------------------------------------------------------------


def _contract(d: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum over (t, b) of d^T x: (T, B, M) x (T, B, N) -> (M, N), fp32."""
    return d.reshape(-1, d.shape[-1]).float().T @ x.reshape(-1, x.shape[-1]).float()


def gemm_ref(kind: str, a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor] = None,
             first: Optional[torch.Tensor] = None, md: torch.dtype = torch.bfloat16):
    """The GEMM kernel's three epilogues; operands rounded to the storage
    type ``md`` (bf16, or fp32 in strict mode), products summed in fp32:

    - ``'gi'``: a (..., K) @ b (N, K)^T + bias (N) -> fp32 (..., N), the
      input gates of every step;
    - ``'dx'``: a (..., K) @ b (K, N) -> fp32 (..., N), the cotangent passed
      to the layer below (the caller rounds dx0 to bf16);
    - ``'dw'``: a (T, B, M), b (T, B, N) -> (sum over (t, b) of a^T b (M, N),
      sum of a (M)), fp32. With ``first`` (B, N), b is (T-1, B, N) and
      ``first`` is its step 0: the h one step behind."""
    if kind == "gi":
        return round_to(a, md) @ round_to(b, md).T + bias
    if kind == "dx":
        return round_to(a, md) @ round_to(b, md)
    if kind == "dw":
        x = b if first is None else torch.cat([first.to(md)[None], b.to(md)], dim=0)
        ab = round_to(a, md)
        return _contract(ab, round_to(x, md)), ab.sum(tuple(range(a.dim() - 1)))
    raise ValueError(f"gemm_ref: unknown epilogue {kind!r}")


def layer_recurrence_ref(gi, w_hh, b_hh, h0, md: torch.dtype = torch.bfloat16) -> Residuals:
    """The recurrence kernel's math, one layer: the fp32 input gates gi
    (T, B, 3H), bias included, w_hh (3H, H), b_hh (3H), h0 (B, H) ->
    (hseq (T, B, H), rzn (T, B, 3H), ghn (T, B, H)) in the storage type
    ``md``. h is rounded to md as the product's operand; gates and the
    carry are fp32."""
    T, B, G = gi.shape
    H = G // 3
    dev = gi.device
    hseq = torch.empty(T, B, H, dtype=md, device=dev)
    rzn = torch.empty(T, B, G, dtype=md, device=dev)
    ghn = torch.empty(T, B, H, dtype=md, device=dev)
    w = round_to(w_hh, md).T
    h = h0.float()
    for t in range(T):
        g_in = gi[t]
        gh = round_to(h, md) @ w + b_hh
        r = torch.sigmoid(g_in[:, :H] + gh[:, :H])
        z = torch.sigmoid(g_in[:, H : 2 * H] + gh[:, H : 2 * H])
        gn = gh[:, 2 * H :]
        n = torch.tanh(g_in[:, 2 * H :] + r * gn)
        h = (1.0 - z) * n + z * h
        hseq[t] = h
        rzn[t] = torch.cat([r, z, n], dim=-1)
        ghn[t] = gn
    return hseq, rzn, ghn


def _stack_ref(gi_first, wih, bih, whh, bhh, h0) -> Residuals:
    """Layer 0's recurrence over its fp32 input gates gi_first (T, B, 3H),
    bias included; layer l > 0 takes its gates from the GEMM over the bf16
    h sequence of the layer below. Residuals as ``stack_forward_ref``'s."""
    outs = []
    for l in range(h0.shape[0]):
        gi = gi_first if l == 0 else gemm_ref("gi", outs[-1][0], wih[l - 1], bih[l - 1])
        outs.append(layer_recurrence_ref(gi, whh[l], bhh[l], h0[l]))
    return tuple(torch.stack(r) for r in zip(*outs))


def stack_forward_ref(x0, wih0, bih0, wih, bih, whh, bhh, h0) -> Residuals:
    """The forward kernels' math: x0 (T, B, I0) -> residuals (hseq (L, T, B,
    H), rzn (L, T, B, 3H), ghn (L, T, B, H)), all bf16. x0 and the weights
    are rounded to bf16, products accumulate in fp32, gates and the h carry
    are fp32; layer l > 0 reads the bf16 h sequence of the layer below."""
    return _stack_ref(gemm_ref("gi", x0, wih0, bih0), wih, bih, whh, bhh, h0)


def gru_fused3_scan_ref(gi0, wih, bih, whh, bhh, h0) -> torch.Tensor:
    """``gru_fused3_scan``'s plain version, the body of ``run_fused3``
    (``bench/gru_experiments.py:111-152``): layer 0's gates are gi0
    (T, B, 3H) rounded to bf16, bias included -> hseq (L, T, B, H) bf16."""
    return _stack_ref(round_to(gi0, torch.bfloat16), wih, bih, whh, bhh, h0)[0]


def layer_sweep_ref(hseq, h0, rzn, ghn, w_hh, ext, dhf, md: torch.dtype = torch.bfloat16):
    """The reverse-sweep kernel's math, one layer: its residuals hseq
    (T, B, H), rzn, ghn, its h0 (B, H), w_hh (3H, H), ext (T, B, H) the fp32
    cotangent of its outputs (dY, or the layer above's), dhf (B, H) that of
    its h_final -> (dgi, dgh (T, B, 3H) in the storage type ``md``, dh0
    (B, H) fp32)."""
    T, B, H = hseq.shape
    dgi = torch.empty(T, B, 3 * H, dtype=md, device=hseq.device)
    dgh = torch.empty_like(dgi)
    w = round_to(w_hh, md)
    dh = dhf.float()
    for t in reversed(range(T)):
        r, z, n = rzn[t].float().split(H, dim=-1)
        gn = ghn[t].float()
        hp = (hseq[t - 1] if t > 0 else h0.to(md)).float()
        dout = dh + ext[t]
        dz = dout * (hp - n) * z * (1.0 - z)
        dn = dout * (1.0 - z) * (1.0 - n * n)
        dghn = dn * r
        dr = dn * gn * r * (1.0 - r)
        dgi[t] = torch.cat([dr, dz, dn], dim=-1)
        dgh[t] = torch.cat([dr, dz, dghn], dim=-1)
        dh = dout * z + dgh[t].float() @ w
    return dgi, dgh, dh


def stack_backward_ref(res: Residuals, dY: torch.Tensor, dhf: torch.Tensor):
    """The backward kernels' math, composed: per layer from the top the
    sweep, then the cotangent for the layer below; then dW and db.
    res = (hseq, rzn, ghn, x0, h0, wih0, wih, whh); dY (T, B, H) is the
    cotangent of the top layer's outputs, dhf (L, B, H) of h_final. Returns
    (dx0, dwih0, dbih0, dwih, dbih, dwhh, dbhh, dh0), fp32; dx0 is rounded
    to bf16 as the kernel stores it."""
    hseq, rzn, ghn, x0, h0, wih0, wih, whh = res
    L = hseq.shape[0]
    dgi, dgh, dh0 = [None] * L, [None] * L, [None] * L
    ext = dY.float()  # cotangent from above, per step, for the current layer
    for l in reversed(range(L)):
        dgi[l], dgh[l], dh0[l] = layer_sweep_ref(hseq[l], h0[l], rzn[l], ghn[l], whh[l], ext, dhf[l].float())
        ext = gemm_ref("dx", dgi[l], wih0 if l == 0 else wih[l - 1])
    dx0 = round_to(ext, torch.bfloat16)
    dwih0, dbih0 = gemm_ref("dw", dgi[0], x0)
    ih = [gemm_ref("dw", dgi[l], hseq[l - 1]) for l in range(1, L)]
    hh = [gemm_ref("dw", dgh[l], hseq[l, :-1], first=h0[l]) for l in range(L)]
    dwih, dbih = (torch.stack(v) for v in zip(*ih))
    dwhh, dbhh = (torch.stack(v) for v in zip(*hh))
    return dx0, dwih0, dbih0, dwih, dbih, dwhh, dbhh, torch.stack(dh0)


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


def _row_align(dtype: torch.dtype) -> int:
    """Elements of ``dtype`` in 16 bytes: 8 bf16, 4 fp32."""
    return 16 // dtype.itemsize


def _is_padded(t: torch.Tensor, dtype=torch.bfloat16) -> bool:
    """True if t is ``dtype`` with its last dimension contiguous and its
    rows a multiple of 16 bytes apart (8 bf16, 4 fp32) from a 16-byte
    aligned start, as the kernels' cp.async copies need."""
    n, a = t.shape[-1], _row_align(dtype)
    ld = t.stride(-2) if t.dim() > 1 else _up(n, a)
    dense = t.dim() < 2 or all(t.stride(i) == t.stride(i + 1) * t.shape[i + 1] for i in range(t.dim() - 2))
    return (t.dtype == dtype and t.stride(-1) == 1 and ld % a == 0 and ld >= n and dense
            and t.data_ptr() % 16 == 0)


def _padded(t: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """t as ``dtype`` with the same shape, laid out as ``_is_padded``
    demands: t itself where it is so already, else a view of a padded copy."""
    if _is_padded(t, dtype):
        return t
    n = t.shape[-1]
    buf = torch.empty(*t.shape[:-1], _up(n, _row_align(dtype)), dtype=dtype, device=t.device)
    out = buf[..., :n]
    with torch.no_grad():
        out.copy_(t)
    return out


def _ld(t: torch.Tensor) -> int:
    return t.stride(-2)


class _Job(ctypes.Structure):
    """``GemmJob`` of csrc/gemm.cuh."""

    _fields_ = [("a", ctypes.c_void_p), ("b", ctypes.c_void_p), ("b_first", ctypes.c_void_p),
                ("c", ctypes.c_void_p), ("bias", ctypes.c_void_p),
                *((name, ctypes.c_int) for name in ("M", "N", "K", "lda", "ldb", "ldc", "b_nfirst", "out_bf16"))]


_GEMM_KINDS = {"gi": 0, "dx": 1, "dw": 2}  # + 3: the strict-fp32 instances
Count = Optional[Callable[[], None]]
# the stack's counters: what each launch helper counts into unless its
# caller passes its own ``count``
_COUNTS = {"gi": counter(globals(), "gemm_gi_launches"), "dx": counter(globals(), "gemm_dx_launches"),
           "dw": counter(globals(), "dw_launches"), "rec": counter(globals(), "rec_launches"),
           "sweep": counter(globals(), "sweep_launches")}


def _gemm(kind: str, jobs: List[_Job], dev_tensor: torch.Tensor, count: Count = None,
          md: torch.dtype = torch.bfloat16) -> None:
    """One launch of the GEMM kernel over ``jobs`` of ``md`` operands,
    counted by ``count`` (the stack's counter of the kind by default)."""
    table = (_Job * len(jobs))(*jobs)
    fn = _build.function("molvax_gemm", [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    code = _GEMM_KINDS[kind] + (3 if md == torch.float32 else 0)
    _build.check(fn(code, ctypes.addressof(table), len(jobs), _stream(dev_tensor)), f"gru_stack GEMM ({kind}, {md})")
    (count or _COUNTS[kind])()


def _gi_job(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> _Job:
    """out (R, N) fp32 = x (R, K) @ w (N, K)^T + b, on padded operands."""
    R, K, N = x.numel() // x.shape[-1], x.shape[-1], w.shape[0]
    return _Job(x.data_ptr(), w.data_ptr(), None, out.data_ptr(), b.data_ptr(), R, N, K, _ld(x), _ld(w), N, 0, 0)


def _dx_job(d: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> _Job:
    """out (R, N) = d (R, K) @ w (K, N): fp32, or bf16 for a bf16 out."""
    R, K, N = d.numel() // d.shape[-1], d.shape[-1], w.shape[-1]
    return _Job(d.data_ptr(), w.data_ptr(), None, out.data_ptr(), None, R, N, K, _ld(d), _ld(w), N, 0,
                int(out.dtype == torch.bfloat16))


def _dw_job(d, x, dw, db, first=None) -> _Job:
    """dw (M, N) = sum over rows of d^T x, db (M) = sum of d; d (R, M) and
    x (R', N) padded, with ``first`` (R - R', N) the rows before x."""
    M, N = d.shape[-1], x.shape[-1]
    R = d.numel() // M
    nfirst = 0 if first is None else first.numel() // N
    fptr = x.data_ptr() if first is None else first.data_ptr()
    if first is not None and _ld(first) != _ld(x):
        raise ValueError("gru_stack dW: x and its first rows need the same row stride")
    return _Job(d.data_ptr(), x.data_ptr(), fptr, dw.data_ptr(), db.data_ptr(), M, N, R, _ld(d), _ld(x), N,
                nfirst, 0)


def _recurrence(gi, whh, bhh, h0, h0b, hseq, rzn, ghn, plan: StackPlan, count: Count = None) -> None:
    """The persistent recurrence of one layer, one launch per batch slice,
    each counted by ``count`` (the stack's counter by default): gi
    (T, B, 3H) fp32, whh (3H, H) and h0b (B, H) padded in the storage type
    (bf16, or fp32: the _f32 entry), bhh (3H), h0 (B, H) fp32 -> hseq
    (T, B, H) padded, rzn, ghn."""
    T, B, H = hseq.shape
    name = "molvax_gru_rec_f32" if whh.dtype == torch.float32 else "molvax_gru_rec"
    fn = _build.function(name, [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    span = plan.g * plan.rows
    for base in range(0, B, span):
        flags = torch.zeros(plan.g, dtype=torch.int32, device=gi.device)
        err = fn(*(t.data_ptr() for t in (gi, whh, bhh, h0, h0b, hseq, rzn, ghn, flags)),
                 T, B, H, _ld(whh), _ld(hseq), plan.units, plan.rows, plan.q, plan.g, plan.fwd_chunk,
                 base, min(B, base + span), _stream(gi))
        _build.check(err, "gru_stack recurrence")
        (count or _COUNTS["rec"])()


def _sweep(hseq, h0b, rzn, ghn, ext, dhf, whhT, dgi, dgh, dh0, plan: StackPlan, count: Count = None) -> None:
    """The persistent reverse sweep of one layer, one launch per batch
    slice, each counted by ``count`` (the stack's counter by default): hseq
    (T, B, H), h0b (B, H), whhT (H, 3H), dgi / dgh (T, B, 3H) padded in the
    storage type (bf16, or fp32: the _f32 entry); rzn, ghn contiguous in it;
    ext (T, B, H), dhf (B, H) contiguous fp32 -> dgi, dgh, dh0 (B, H) fp32."""
    T, B, H = hseq.shape
    name = "molvax_gru_sweep_f32" if whhT.dtype == torch.float32 else "molvax_gru_sweep"
    fn = _build.function(name, [ctypes.c_void_p] * 11 + [ctypes.c_int] * 13 + [ctypes.c_void_p])
    span = plan.g * plan.rows
    for base in range(0, B, span):
        flags = torch.zeros(plan.g, dtype=torch.int32, device=hseq.device)
        err = fn(*(t.data_ptr() for t in (hseq, h0b, rzn, ghn, ext, dhf, whhT, dgi, dgh, dh0, flags)),
                 T, B, H, _ld(hseq), _ld(whhT), _ld(dgi), plan.units, plan.rows, plan.q, plan.g,
                 plan.bwd_chunk, base, min(B, base + span), _stream(hseq))
        _build.check(err, "gru_stack reverse sweep")
        (count or _COUNTS["sweep"])()


def gemm(kind: str, a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor] = None,
         first: Optional[torch.Tensor] = None, count: Count = None, md: torch.dtype = torch.bfloat16):
    """``gemm_ref`` on the card: one launch of the GEMM kernel with the
    epilogue ``kind`` ('gi', 'dx', 'dw'; 'dx' returns fp32) on operands in
    ``md``, counted by ``count`` (the stack's counter by default). CUDA
    tensors only."""
    _check_cuda(f"gru_stack GEMM ({kind})", a, b, *(t for t in (bias, first) if t is not None))
    dev = a.device
    with torch.no_grad():
        ap, bp = _padded(a, md), _padded(b, md)
        if kind == "gi":
            out = torch.empty(*a.shape[:-1], b.shape[0], device=dev)
            job = _gi_job(ap, bp, bias.float().contiguous(), out)
        elif kind == "dx":
            out = torch.empty(*a.shape[:-1], b.shape[-1], device=dev)
            job = _dx_job(ap, bp, out)
        elif kind == "dw":
            M, N = a.shape[-1], b.shape[-1]
            out = (torch.empty(M, N, device=dev), torch.empty(M, device=dev))
            if first is not None:  # one buffer, so that both have one row stride
                both = _padded(torch.cat([first.to(md)[None], b.to(md)]), md)
                fp, bp = both[0], both[1:]
            job = _dw_job(ap, bp, *out, first=None if first is None else fp)
        else:
            raise ValueError(f"gemm: unknown epilogue {kind!r}")
    _gemm(kind, [job], a, count, md)
    return out


def layer_recurrence(gi, w_hh, b_hh, h0, plan: Optional[StackPlan] = None, count: Count = None,
                     md: torch.dtype = torch.bfloat16) -> Residuals:
    """``layer_recurrence_ref`` on the card, storage type ``md``: one
    persistent launch (per batch slice of the plan), each counted by
    ``count``. hseq comes back as a view of a buffer whose rows are padded
    to a multiple of 16 bytes. CUDA tensors only."""
    _check_cuda("gru_stack recurrence", gi, w_hh, b_hh, h0)
    T, B, G = gi.shape
    H = G // 3
    plan = plan or stack_plan(B, H, *plan_limits(gi.device), esize=md.itemsize)
    dev = gi.device
    with torch.no_grad():
        args = (gi.float().contiguous(), _padded(w_hh, md), b_hh.float().contiguous(), h0.float().contiguous(),
                _padded(h0, md))
    hseq = torch.empty(T, B, _up(H, _row_align(md)), dtype=md, device=dev)[..., :H]
    rzn = torch.empty(T, B, G, dtype=md, device=dev)
    ghn = torch.empty(T, B, H, dtype=md, device=dev)
    _recurrence(*args, hseq, rzn, ghn, plan, count)
    return hseq, rzn, ghn


def layer_sweep(hseq, h0, rzn, ghn, w_hh, ext, dhf, plan: Optional[StackPlan] = None, count: Count = None,
                md: torch.dtype = torch.bfloat16):
    """``layer_sweep_ref`` on the card, storage type ``md``: one persistent
    launch (per batch slice of the plan), each counted by ``count``; hseq is
    read in place where it is padded as the recurrence leaves it. dgi and
    dgh come back as views of padded buffers. CUDA tensors only."""
    _check_cuda("gru_stack reverse sweep", hseq, h0, rzn, ghn, w_hh, ext, dhf)
    T, B, H = hseq.shape
    plan = plan or stack_plan(B, H, *plan_limits(hseq.device), esize=md.itemsize)
    dev = hseq.device
    with torch.no_grad():
        args = (_padded(hseq, md), _padded(h0, md), rzn.to(md).contiguous(), ghn.to(md).contiguous(),
                ext.float().contiguous(), dhf.float().contiguous(), _padded(w_hh.t(), md))
    G = _up(3 * H, _row_align(md))
    dgi = torch.empty(T, B, G, dtype=md, device=dev)[..., : 3 * H]
    dgh = torch.empty(T, B, G, dtype=md, device=dev)[..., : 3 * H]
    dh0 = torch.empty(B, H, device=dev)
    _sweep(*args, dgi, dgh, dh0, plan, count)
    return dgi, dgh, dh0


def stack_forward(x0, wih0, bih0, wih, bih, whh, bhh, h0) -> Residuals:
    """``stack_forward_ref`` on the card: per layer, the input-gate GEMM and
    the persistent recurrence. hseq comes back as a view of a buffer whose
    rows are padded to a multiple of 8."""
    _check_cuda("gru_stack forward", x0, wih0, bih0, wih, bih, whh, bhh, h0)
    T, B, I0, H, L = _check_shapes(x0, wih0, wih, whh, h0)
    plan = stack_plan(B, H, *plan_limits(x0.device))
    bf, dev, G = torch.bfloat16, x0.device, 3 * H
    with torch.no_grad():
        x0p, wih0p, wihp, whhp, h0b = (_padded(t) for t in (x0, wih0, wih, whh, h0))
        bih0_, bih_, bhh_, h0_ = (t.float().contiguous() for t in (bih0, bih, bhh, h0))
    hseq = torch.empty(L, T, B, _up(H, 8), dtype=bf, device=dev)[..., :H]
    rzn = torch.empty(L, T, B, G, dtype=bf, device=dev)
    ghn = torch.empty(L, T, B, H, dtype=bf, device=dev)
    gi = torch.empty(T, B, G, device=dev)
    for l in range(L):
        if l == 0:
            job = _gi_job(x0p, wih0p, bih0_, gi)
        else:
            job = _gi_job(hseq[l - 1], wihp[l - 1], bih_[l - 1], gi)
        _gemm("gi", [job], x0)
        _recurrence(gi, whhp[l], bhh_[l], h0_[l], h0b[l], hseq[l], rzn[l], ghn[l], plan)
    return hseq, rzn, ghn


def stack_backward(res: Residuals, dY: torch.Tensor, dhf: torch.Tensor):
    """``stack_backward_ref`` on the card: per layer from the top, the
    persistent reverse sweep and the GEMM of the cotangent passed down; then
    one GEMM launch for every dW and db."""
    hseq, rzn, ghn, x0, h0, wih0, wih, whh = res
    _check_cuda("gru_stack backward", hseq, rzn, ghn, x0, h0, wih0, wih, whh, dY, dhf)
    T, B, I0, H, L = _check_shapes(x0, wih0, wih, whh, h0)
    plan = stack_plan(B, H, *plan_limits(x0.device))
    bf, dev, G = torch.bfloat16, x0.device, 3 * H
    with torch.no_grad():
        hs, h0b, x0p, wih0p, wihp = (_padded(t) for t in (hseq, h0, x0, wih0, wih))
        whhT = _padded(whh.transpose(1, 2))
        rzn_, ghn_ = rzn.to(bf).contiguous(), ghn.to(bf).contiguous()
        dY_, dhf_ = dY.float().contiguous(), dhf.float().contiguous()
    dgi = torch.empty(L, T, B, _up(G, 8), dtype=bf, device=dev)[..., :G]
    dgh = torch.empty(L, T, B, _up(G, 8), dtype=bf, device=dev)[..., :G]
    dh0 = torch.empty(L, B, H, device=dev)
    dx0 = torch.empty(T, B, I0, dtype=bf, device=dev)
    ext, below = dY_, torch.empty(T, B, H, device=dev)
    for l in reversed(range(L)):
        _sweep(hs[l], h0b[l], rzn_[l], ghn_[l], ext, dhf_[l], whhT[l], dgi[l], dgh[l], dh0[l], plan)
        if l > 0:
            _gemm("dx", [_dx_job(dgi[l], wihp[l - 1], below)], x0)
            ext = below
        else:
            _gemm("dx", [_dx_job(dgi[0], wih0p, dx0)], x0)
    dwih0, dbih0 = torch.empty(G, I0, device=dev), torch.empty(G, device=dev)
    dwih, dbih = torch.empty(L - 1, G, H, device=dev), torch.empty(L - 1, G, device=dev)
    dwhh, dbhh = torch.empty(L, G, H, device=dev), torch.empty(L, G, device=dev)
    jobs = [_dw_job(dgi[0], x0p, dwih0, dbih0)]
    jobs += [_dw_job(dgi[l], hs[l - 1], dwih[l - 1], dbih[l - 1]) for l in range(1, L)]
    # W_hh: h one step behind, bf16(h0) as its first B rows
    jobs += [_dw_job(dgh[l], hs[l], dwhh[l], dbhh[l], first=h0b[l]) for l in range(L)]
    _gemm("dw", jobs, x0)
    return dx0.float(), dwih0, dbih0, dwih, dbih, dwhh, dbhh, dh0


def gru_fused3_scan(gi0, wih, bih, whh, bhh, h0) -> torch.Tensor:
    """The previous design's stack forward kernel as ``run_fused3``'s probe:
    gi0 (T, B, 3H) layer 0's input gates (bias included), wih (L-1, 3H, H),
    bih (L-1, 3H), whh (L, 3H, H), bhh (L, 3H), h0 (L, B, H) -> hseq (L, T,
    B, H) bf16, forward only, no residuals. The TPU probe also wrote a copy
    of the top layer (``htop``) to have it contiguous; ``hseq[L-1]`` already
    is. One launch for CUDA tensors, ``gru_fused3_scan_ref`` for CPU
    tensors."""
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
        # (in, 3H) copies: a warp reads 32 neighbouring gate columns
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
