"""The GRU kernel router of the training decode, and the per-layer kernels.

Port of ``molvax/kernels/gru.py``. The router (``gru_forward_pallas``,
``:856-938``) sends bf16 stacks that ``stack_plan_ok`` accepts to the fused
stack kernels (``kernels/gru_stack.py``), unless the config pins
``gru_kernel='per_layer'``. Everything else, strict fp32, single-layer and
non-uniform stacks, and pinned configs, runs one per-layer kernel per layer:

- ``gru_layer_scan_x`` (``:748``): one layer, input gates ``x @ W_ih``
  included, bf16 operands (``matmul_dtype='bfloat16'``) or strict fp32
  (``'float32'``: every operand, residual and cotangent fp32, no single-pass
  TF32 or bf16 product: fp32, or 3xTF32 split products of fp32 accuracy).
  Wherever ``layer_route`` finds a layout (``stack_plan`` for the storage
  type's element size), it runs the stack's pieces for one layer in that
  type: forward, one tensor-core GEMM of the input gates over all T B rows
  (``csrc/gemm.cuh``), then the persistent recurrence with W_hh resident in
  shared memory (``csrc/gru_stack.cu``); backward, the persistent reverse
  sweep, one GEMM of dx (stored in the storage type) and one GEMM launch of
  dW_ih / db_ih and dW_hh / db_hh. Unlike the stack, every bf16 layer rounds
  the cotangent it passes down to bf16 (``gru.py:636-638``). Shapes the plan
  cannot lay out (bf16 H > 2,112, fp32 H > 1,152 at B=256) run the
  in-kernel instance of ``csrc/gru_layer.cu``, laid out by ``layer_plan``:
  one persistent cooperative launch (per batch slice) of a forward that
  computes ``x[t+1] @ W_ih`` on the tensor cores while the row group meets
  at the step's barrier, its W_hh and W_ih slices resident in shared memory
  where they fit and streamed from L2 or device memory each step where they
  do not; its backward, one persistent launch of the reverse sweep, then
  the dx GEMM and the dW GEMM of the persistent route. ``gru_layer_scan_x_in_kernel`` names that instance (the ``fwd_gi``
  probe's kernel).
- ``gru_layer_scan`` (``:390``): the same recurrence with precomputed input
  gates, rounded to bf16 at the boundary (``csrc/gru_layer.cu``'s hoisted
  forward, gi[t+1] loaded while the group meets at the barrier); its
  backward returns dgi (the sweep, then the dW GEMM).

``layer_forward_ref`` / ``layer_backward_ref`` and ``scan_forward_ref`` /
``scan_backward_ref`` are the same math in plain torch ops, rounding where
the kernels round; the persistent route also composes to them from the
stack's plain pieces (``gemm_ref``, ``layer_recurrence_ref``,
``layer_sweep_ref``, in either storage type), bit for bit. ``gru_probe_scan`` runs
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
counterpart: the kernels take any B and I, and any H that ``stack_plan``
or ``layer_plan`` lays out (bf16 H up to 8,448: 64 units on each of 132
SMs).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import sys
from typing import Callable, List, Optional, Tuple

import torch

from ..utils import round_to
from . import _build, gru_stack
from .gru_stack import (_check_cuda, _contract, _dw_job, _dx_job, _gemm, _is_padded, _ld, _padded, _row_align,
                        _stream, _up, counter)

# kernel launches made by the wrappers (not by the plain versions)
layer_gi_launches = 0  # gru_layer_scan_x forward, bf16 or fp32: the input-gate GEMM
layer_rec_launches = 0  # ... and the persistent recurrence (per batch slice)
layer_sweep_launches = 0  # backward: the persistent reverse sweep (per slice)
layer_dx_launches = 0  # ... the GEMM of dx
layer_gemm_dw_launches = 0  # ... the GEMM of dW_ih, db_ih, dW_hh and db_hh (two jobs per part)
layer_dw_sum_launches = 0  # ... the sum of its parts
layer_fwd_launches = 0  # gru_layer_scan_x's in-kernel instance: forward (per batch slice)
layer_bwd_launches = 0  # ... reverse sweep (per slice); its dx and dW GEMMs count as the route's above
scan_fwd_launches = 0  # gru_layer_scan forward (per slice)
scan_bwd_launches = 0  # gru_layer_scan reverse sweep (per slice); its dW GEMM and sum count above
probe_matmul_only_launches = 0  # gru_probe_scan(mode='matmul_only')
probe_gates_nostore_launches = 0  # gru_probe_scan(mode='gates_nostore')

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


# -- the in-kernel instance's plan --------------------------------------------


_TPAD = 8  # elements of padding per row of the sweep's [k][unit] tiles (csrc/gru_layer.cu TPAD)
_MTS = {2: (1, 2, 4), 4: (1, 2)}  # m16 row tiles a warp: the kernels' instances, bf16 and fp32
_MAX_THREADS = 256  # the kernels' __launch_bounds__


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """How ``csrc/gru_layer.cu``'s forward and reverse sweep lie on the card:
    ``g`` row groups of ``rows`` batch rows, each of ``q`` blocks that own
    ``units`` hidden units (all three gate columns of each); a block's
    ``units / 8 * rt`` warps each hold 8 units for ``mt`` m16 row tiles;
    ``slices`` launches per pass cover B rows. ``res_hh`` / ``res_ih``: the
    forward's W_hh / W_ih slices stay resident in shared memory, else they
    stream from an E copy, chunk by chunk, each step; ``bwd_res_hh`` the
    sweep's W_hh[:, units]. ``chunk`` / ``bwd_chunk``: the columns a ring
    buffer holds, ``stages`` / ``bwd_stages`` its buffers (1: each
    product's K whole; 2: the next chunk copied while one is multiplied);
    ``*_smem``: the blocks' shared-memory bytes."""

    g: int
    q: int
    units: int
    rows: int
    rt: int
    slices: int
    chunk: int
    bwd_chunk: int
    stages: int
    bwd_stages: int
    res_hh: bool
    res_ih: bool
    bwd_res_hh: bool
    fwd_smem: int
    bwd_smem: int

    @property
    def blocks(self) -> int:
        return self.g * self.q

    @property
    def threads(self) -> int:
        return self.units // 8 * self.rt * 32

    @property
    def mt(self) -> int:
        return self.rows // 16 // self.rt


def fwd_smem(I: int, H: int, units: int, rows: int, chunk: int, stages: int, in_x: bool, res_ih: bool,
             res_hh: bool, esize: int) -> int:
    """Shared-memory bytes of a forward block (``csrc/gru_layer.cu``
    fwd_smem): the resident slices (3 units x K, rows padded by 16 bytes),
    then ``stages`` ring buffers of the row block's chunk and any streamed
    slice's. ``in_x``: the in-kernel instance (x and W_ih, I wide); else
    the hoisted one."""
    pad = 16 // esize
    Kh, Kx = _up(H, 16), _up(I, 16) if in_x else 0
    streams = not res_hh or (in_x and not res_ih)
    return ((3 * units * (Kh + pad) if res_hh else 0) + (3 * units * (Kx + pad) if in_x and res_ih else 0)
            + stages * (rows + (3 * units if streams else 0)) * (chunk + pad)) * esize


def sweep_smem(H: int, units: int, rows: int, chunk: int, stages: int, res_hh: bool, esize: int) -> int:
    """Shared-memory bytes of a reverse-sweep block (``sweep_smem``): W_hh[:,
    units] (3H x units) resident, rows padded by 8 elements, then ``stages``
    ring buffers of the dgh row block's chunk and a streamed W_hh chunk."""
    pad, Kb = 16 // esize, _up(3 * H, 16)
    return ((Kb * (units + _TPAD) if res_hh else 0)
            + stages * (rows * (chunk + pad) + (0 if res_hh else chunk * (units + _TPAD)))) * esize


def _ring(fits: Callable[[int, int], bool], K: int, streamed: bool) -> Optional[Tuple[int, int]]:
    """(chunk, buffers) of a ring that ``fits(chunk, buffers)``: one buffer
    of all of K where nothing streams, else the widest chunk (a multiple of
    16) with two buffers; None where none fits."""
    if not streamed and fits(K, 1):
        return K, 1
    lo, hi = 0, K // 16  # chunks of 16: lo fits (or is 0)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(16 * mid, 2) else (lo, mid - 1)
    return (16 * lo, 2) if lo else None


def _fwd_layout(I, H, units, rows, esize, smem, in_x):
    """(res_hh, res_ih, chunk, buffers, bytes) of the forward: the most
    resident bytes of the two slices that fit beside a ring."""
    pad = 16 // esize
    Kh, Kx = _up(H, 16), _up(I, 16) if in_x else 0
    opts = [(hh, ih) for hh in (True, False) for ih in ((True, False) if in_x else (False,))]
    opts.sort(key=lambda o: -(o[0] * 3 * units * (Kh + pad) + o[1] * 3 * units * (Kx + pad)))
    for hh, ih in opts:
        ring = _ring(lambda c, n: fwd_smem(I, H, units, rows, c, n, in_x, ih, hh, esize) <= smem, max(Kh, Kx),
                     not hh or (in_x and not ih))
        if ring:
            return hh, ih, *ring, fwd_smem(I, H, units, rows, *ring, in_x, ih, hh, esize)
    return None


def _bwd_layout(H, units, rows, esize, smem):
    """(res_hh, chunk, buffers, bytes) of the sweep: W_hh[:, units] resident
    where it fits beside a ring, else streamed."""
    Kb = _up(3 * H, 16)
    for hh in (True, False):
        ring = _ring(lambda c, n: sweep_smem(H, units, rows, c, n, hh, esize) <= smem, Kb, not hh)
        if ring:
            return hh, *ring, sweep_smem(H, units, rows, *ring, hh, esize)
    return None


@functools.lru_cache(maxsize=256)
def layer_plan(B: int, I: int, H: int, sms: int = gru_stack.SMS, smem: int = gru_stack.SMEM, esize: int = 2,
               hoisted: bool = False) -> LayerPlan:
    """Lay out ``csrc/gru_layer.cu``'s forward and sweep for batch B, input
    width I (``hoisted``: none, the input gates are given) and width H on a
    card of ``sms`` SMs with ``smem`` bytes of shared memory a block, one
    block per SM, for elements of ``esize`` bytes (2: bf16, 4: strict
    fp32). Each slice width (units, a multiple of 8) gives q = ceil(H /
    units) blocks a group and as many row groups as the SMs hold, warps
    splitting the group's rows where the units leave room; its slices must
    fit the shared memory: each resident where it fits beside the ring
    (most resident bytes first), else streamed each step. Among the layouts
    that fit, the fewest launches per pass, then the least estimated step
    time (a warp's products, the bytes a block streams, a synchronisation
    per chunk).

    Registers need no count here: a block has at most 256 threads, the
    kernels' ``__launch_bounds__(256)``, under which ptxas keeps a thread
    within 255 registers, and 256 x 255 fit an SM's 65,536, so one block of
    any plan is resident by its registers (what ptxas spills to fit is in
    ``PERF.md``). The cooperative launch fails, and the wrapper raises,
    where any block of the plan is not resident.

    Where no layout keeps the weights resident they come from the L2 cache
    or device memory every step. At bf16 H = 2,304 (I = 329, B = 256) the
    whole W_hh is 31.8 MB: more than the 132 SMs' shared memory (30.7 MB),
    less than the H100's 50 MB L2, so each step streams it from L2. At bf16
    H = 4,096 it is 100 MB and every step reads it from device memory. Raises
    where no layout fits: more than sms x 64 units, or slices too large for
    the shared memory even streamed."""
    if B < 1 or H < 1 or (I < 1 and not hoisted) or esize not in (2, 4):
        raise ValueError(f"layer_plan: B={B}, I={I}, H={H}, esize={esize}")
    in_x = not hoisted
    Kh, Kx, Kb = _up(H, 16), _up(I, 16) if in_x else 0, _up(3 * H, 16)
    best = None
    for units in range(min(gru_stack._MAX_UNITS, _up(H, 8)), 7, -8):
        q = -(-H // units)
        if q > sms:
            break
        g = max(1, min(sms // q, -(-B // 16)))
        n16 = -(-(-(-B // g)) // 16)  # m16 row tiles of a group's rows
        rt = min(_MAX_THREADS // 32 // (units // 8), n16)
        mt = next((m for m in _MTS[esize] if m * rt >= n16), _MTS[esize][-1])
        rows = 16 * mt * rt
        slices = -(-B // (g * rows))
        if slices == 1:
            g = -(-B // rows)
        fwd = _fwd_layout(I, H, units, rows, esize, smem, in_x)
        bwd = _bwd_layout(H, units, rows, esize, smem)
        if fwd is None or bwd is None:
            continue
        plan = LayerPlan(g, q, units, rows, rt, slices, fwd[2], bwd[1], fwd[3], bwd[2], fwd[0], fwd[1], bwd[0],
                         fwd[4], bwd[3])
        # a tensor-core pass a k16 step: bf16 one product, 3xTF32 three of k8, twice
        passes = 1 if esize == 2 else 6
        work = mt * (3 * (Kh + Kx) + Kb) // 16 * passes * 10
        streamed = ((0 if plan.res_hh else 3 * units * Kh) + (0 if plan.res_ih or not in_x else 3 * units * Kx)
                    + (0 if plan.bwd_res_hh else Kb * units)) * esize // 16
        syncs = (-(-Kh // plan.chunk) + -(-Kx // plan.chunk) + -(-Kb // plan.bwd_chunk)) * 200
        key = (slices, work + streamed + syncs, -units)
        if best is None or key < best[0]:
            best = (key, plan)
    if best is None:
        raise ValueError(f"layer_plan: no layout of the per-layer kernels fits I={I}, H={H} ({esize}-byte "
                         f"elements) on {sms} SMs with {smem} bytes of shared memory a block")
    return best[1]


# -- the kernels ---------------------------------------------------------------


def _layer_dims(what, x, w_ih, w_hh, h0) -> Tuple[int, int, int, int]:
    T, B, I = x.shape
    B_h, H = h0.shape
    if B_h != B or tuple(w_ih.shape) != (3 * H, I) or tuple(w_hh.shape) != (3 * H, H):
        raise ValueError(f"{what}: x {tuple(x.shape)}, w_ih {tuple(w_ih.shape)}, "
                         f"w_hh {tuple(w_hh.shape)}, h0 {tuple(h0.shape)}")
    return T, B, I, H


def _check_residuals(what, shape, md, hseq, rzn, ghn, dY, padded: bool = False) -> None:
    """The sweep reads the forward's residuals in place: in the storage type
    md, hseq and ghn of ``shape`` (T, B, H), rzn (T, B, 3H), contiguous; with
    ``padded`` (the persistent sweeps'), hseq may also have its rows padded
    to a multiple of 16 bytes, as the forwards write it. dY (T, B, H)."""
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


def layer_route(B: int, H: int, md: torch.dtype = torch.bfloat16,
                limits: Tuple[int, int] = (gru_stack.SMS, gru_stack.SMEM)) -> str:
    """Which kernels run ``gru_layer_scan_x`` in storage type ``md`` at batch
    B and width H, decided by shape before any launch: 'persistent' (the
    input-gate GEMM, the persistent recurrence and sweep, the dx and dW
    GEMMs) wherever ``stack_plan`` lays the persistent kernels out with md's
    elements on a card of ``limits`` (SMs, shared memory of a block: the
    wrappers pass the card's, ``gru_stack.plan_limits``; the default is an
    H100 SXM's), else 'in_kernel' (``csrc/gru_layer.cu``, planned by
    ``layer_plan``)."""
    try:
        gru_stack.stack_plan(B, H, *limits, esize=md.itemsize)
    except ValueError:
        return "in_kernel"
    return "persistent"


def _persistent(md: torch.dtype, B: int, H: int,
                limits: Tuple[int, int] = (gru_stack.SMS, gru_stack.SMEM)) -> bool:
    return layer_route(B, H, md, limits) == "persistent"


def _ptrs(*tensors):
    return [None if t is None else t.data_ptr() for t in tensors]


_COUNT = {**{name: counter(globals(), f"layer_{name}_launches")
             for name in ("gi", "rec", "sweep", "dx", "gemm_dw", "dw_sum", "fwd", "bwd")},
          **{name: counter(globals(), f"{name}_launches")
             for name in ("scan_fwd", "scan_bwd", "probe_matmul_only", "probe_gates_nostore")}}


def dw_parts(T: int, I: int, H: int, sms: int = gru_stack.SMS) -> int:
    """The parts (of whole time steps) that the dW GEMM of one layer splits
    its T B rows into: its 128 x 128 output tiles of dW_ih | db_ih and
    dW_hh | db_hh, times the parts, take the fewest waves of the card's
    ``sms`` SMs per part (ties to fewer parts; at most 4, at most T; the
    wrapper passes the card's, the default is an H100 SXM's 132). At
    zinc250k width 84 tiles leave 48 of 132 SMs idle; in 3 parts 252 tiles
    of a third of the rows fill two waves. The strict-fp32 GEMM has the
    same 128 x 128 output tile, so its parts are the same."""
    tiles = -(-3 * H // 128) * (-(-(I + 1) // 128) + -(-(H + 1) // 128))
    return min(range(1, min(4, T) + 1), key=lambda k: -(-tiles * k // sms) / k)


def _sum_parts(parts: torch.Tensor, out: torch.Tensor) -> None:
    """out (n) = parts[0] + parts[1] + ... of parts (k, n), fp32, in that
    order: the second pass of the split dW GEMM, one launch."""
    fn = _build.function("molvax_sum_parts", [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                                              ctypes.c_void_p])
    _build.check(fn(parts.data_ptr(), parts.shape[0], parts.shape[1], out.data_ptr(), _stream(out)),
                 "gru_layer dW parts")
    _COUNT["dw_sum"]()


def _layer_dw(dgi, xp, dgh, hs, h0b, sms: int, md: torch.dtype):
    """One layer's weight gradients from the gate cotangents a sweep wrote:
    one GEMM launch of dW_ih / db_ih over x (where dgi is given) and dW_hh /
    db_hh over h one step behind (h0 in md first), two jobs for each of
    ``dw_parts`` spans of time steps, and one launch that sums the parts in
    order. All operands padded in md. Returns (dW_ih, db_ih, dW_hh, db_hh),
    fp32, torch layout (None for the first two without dgi)."""
    T, B, G = dgh.shape
    H, I = G // 3, 0 if dgi is None else xp.shape[-1]
    k = dw_parts(T, I, H, sms)
    n_ih, n_hh = (0 if dgi is None else G * I + G), G * H + G
    parts = torch.empty(k, n_ih + n_hh, device=dgh.device)
    jobs = []
    for p in range(k):
        t0, t1 = p * T // k, (p + 1) * T // k
        ih, hh = parts[p, :n_ih], parts[p, n_ih:]
        if dgi is not None:
            jobs.append(_dw_job(dgi[t0:t1], xp[t0:t1], ih[: G * I].view(G, I), ih[G * I :]))
        first = dict(first=h0b) if t0 == 0 else {}  # h one step behind: h0 in md, then hseq
        jobs.append(_dw_job(dgh[t0:t1], hs[max(t0 - 1, 0) : t1], hh[: G * H].view(G, H), hh[G * H :], **first))
    _gemm("dw", jobs, dgh, _COUNT["gemm_dw"], md)
    out = torch.empty(n_ih + n_hh, device=dgh.device)
    _sum_parts(parts, out)
    ih = (out[: G * I].view(G, I), out[G * I : n_ih]) if dgi is not None else (None, None)
    return (*ih, out[n_ih : n_ih + G * H].view(G, H), out[n_ih + G * H :])


def layer_forward(x, w_ih, b_ih, w_hh, b_hh, h0, md: torch.dtype) -> Residuals:
    """``layer_forward_ref`` on the card. On the persistent route
    (``layer_route``), in the storage type md: the stack's input-gate GEMM
    over all T B rows, fp32 gi with b_ih, then its persistent recurrence
    (one launch per batch slice of ``stack_plan``), counted on this module's
    counters; hseq comes back as a view of a buffer whose rows are padded to
    a multiple of 16 bytes. An x already so laid out in md (``_padded``) is
    read in place. Else ``layer_forward_in_kernel``."""
    what = "gru_layer_scan_x forward"
    _check_cuda(what, x, w_ih, b_ih, w_hh, b_hh, h0)
    T, B, I, H = _layer_dims(what, x, w_ih, w_hh, h0)
    if not _persistent(md, B, H, gru_stack.plan_limits(x.device)):
        return layer_forward_in_kernel(x, w_ih, b_ih, w_hh, b_hh, h0, md)
    gi = gru_stack.gemm("gi", x, w_ih, b_ih, count=_COUNT["gi"], md=md)
    return gru_stack.layer_recurrence(gi, w_hh, b_hh, h0, count=_COUNT["rec"], md=md)


def layer_backward(res: Residuals, dY: torch.Tensor):
    """``layer_backward_ref`` on the card. On the persistent route, in the
    residuals' storage type md: the stack's persistent reverse sweep (ext =
    dY, no h_final cotangent: on the per-layer route it arrives inside
    dY[-1]), one GEMM of dx stored in md, and ``_layer_dw``. It reads hseq
    in place, padded or not, and x in place where it is laid out as
    ``_padded`` leaves it (the autograd wrapper saves the forward's copy).
    Deterministic: every output is summed in a fixed order. Else
    ``layer_backward_in_kernel``."""
    hseq, rzn, ghn, x, h0, w_ih, w_hh = res
    what = "gru_layer_scan_x backward"
    _check_cuda(what, hseq, rzn, ghn, x, h0, w_ih, w_hh, dY)
    T, B, I, H = _layer_dims(what, x, w_ih, w_hh, h0)
    md = hseq.dtype
    limits = gru_stack.plan_limits(x.device)
    if not _persistent(md, B, H, limits):
        return layer_backward_in_kernel(res, dY)
    _check_residuals(what, (T, B, H), md, hseq, rzn, ghn, dY, padded=True)
    dev = x.device
    dgi, dgh, dh0 = gru_stack.layer_sweep(hseq, h0, rzn, ghn, w_hh, dY, torch.zeros(B, H, device=dev),
                                          count=_COUNT["sweep"], md=md)
    with torch.no_grad():
        hs, xp, h0b, wihp = (_padded(t, md) for t in (hseq, x, h0, w_ih))
    dx = torch.empty(T, B, I, dtype=md, device=dev)
    _gemm("dx", [_dx_job(dgi, wihp, dx)], x, _COUNT["dx"], md)
    return (dx.float(), *_layer_dw(dgi, xp, dgh, hs, h0b, limits[0], md), dh0)


def _weight(w: torch.Tensor, md: torch.dtype, resident: bool):
    """A weight (3H, ·) as a layer kernel reads it: (tensor, 1 if its
    elements are fp32, row stride). A resident slice is read once from the
    tensor as torch stores it (fp32 or md, rows contiguous) and rounded to
    md in the kernel; a streamed one is copied by cp.async each step, so it
    comes from an md tensor with 16-byte rows (``_padded``: the tensor itself
    where it is one, else a copy a call)."""
    if not resident:
        w = _padded(w, md)
        return w, 0, _ld(w)
    if w.dtype not in (torch.float32, md) or w.stride(-1) != 1:
        w = w.float().contiguous()
    return w, int(w.dtype == torch.float32), w.stride(0)


def _forward(what, plan: LayerPlan, md, x, gi, w_ih, b_ih, w_hh, b_hh, h0, mode: int, count) -> Residuals:
    """``csrc/gru_layer.cu``'s forward, one launch per batch slice of the
    plan, each counted by ``count``: in-kernel input gates from x (padded in
    md), or hoisted from gi (bf16, contiguous; x None) in ``mode`` (0 the
    production kernel, else a probe mode, which stores hseq only). Returns
    (hseq as a view of rows padded to 16 bytes, rzn, ghn: None in a probe
    mode)."""
    T, B = (gi if x is None else x).shape[:2]
    H, I = h0.shape[-1], 0 if x is None else x.shape[-1]
    dev = h0.device
    with torch.no_grad():
        wih, wih_f32, ldwi = _weight(w_ih, md, plan.res_ih) if x is not None else (None, 0, 0)
        whh, whh_f32, ldwh = _weight(w_hh, md, plan.res_hh)
        bih = None if x is None else b_ih.float().contiguous()
        bhh, h0f, h0b = b_hh.float().contiguous(), h0.float().contiguous(), _padded(h0, md)
    hseq = torch.empty(T, B, _up(H, _row_align(md)), dtype=md, device=dev)[..., :H]
    full = mode == 0
    rzn = torch.empty(T, B, 3 * H, dtype=md, device=dev) if full else None
    ghn = torch.empty(T, B, H, dtype=md, device=dev) if full else None
    fn = _build.function("molvax_layer_fwd", [ctypes.c_void_p] * 13 + [ctypes.c_int] * 23 + [ctypes.c_void_p])
    span = plan.g * plan.rows
    for base in range(0, B, span):
        flags = torch.zeros(plan.g, dtype=torch.int32, device=dev)
        err = fn(*_ptrs(x, gi, wih, bih, whh, bhh, h0f, h0b, hseq, rzn, ghn, None, flags), T, B, I, H,
                 0 if x is None else _ld(x), ldwi, ldwh, _ld(hseq), wih_f32, whh_f32, plan.units, plan.rows,
                 plan.rt, plan.q, plan.g, plan.chunk, plan.stages, int(plan.res_ih), int(plan.res_hh), base,
                 min(B, base + span), int(md == torch.float32), mode, _stream(h0))
        _build.check(err, what)
        count()
    return hseq, rzn, ghn


def _sweep(what, plan: LayerPlan, hseq, h0, rzn, ghn, dY, w_hh, count):
    """``csrc/gru_layer.cu``'s reverse sweep in the residuals' storage type,
    one launch per batch slice of the plan, each counted by ``count``.
    Returns (dgi, dgh as views of padded buffers, dh0 fp32)."""
    T, B, H = hseq.shape
    md, dev = hseq.dtype, hseq.device
    with torch.no_grad():
        hs, h0b, dY_ = _padded(hseq, md), _padded(h0, md), dY.float().contiguous()
        whh, whh_f32, ldwh = _weight(w_hh, md, plan.bwd_res_hh)
    G = _up(3 * H, _row_align(md))
    dgi = torch.empty(T, B, G, dtype=md, device=dev)[..., : 3 * H]
    dgh = torch.empty(T, B, G, dtype=md, device=dev)[..., : 3 * H]
    dh0 = torch.empty(B, H, device=dev)
    fn = _build.function("molvax_layer_sweep", [ctypes.c_void_p] * 10 + [ctypes.c_int] * 18 + [ctypes.c_void_p])
    span = plan.g * plan.rows
    for base in range(0, B, span):
        flags = torch.zeros(plan.g, dtype=torch.int32, device=dev)
        err = fn(*_ptrs(hs, h0b, rzn, ghn, dY_, whh, dh0, dgi, dgh, flags), T, B, H, _ld(hs), ldwh, _ld(dgi),
                 whh_f32, plan.units, plan.rows, plan.rt, plan.q, plan.g, plan.bwd_chunk, plan.bwd_stages,
                 int(plan.bwd_res_hh), base, min(B, base + span), int(md == torch.float32), _stream(hseq))
        _build.check(err, what)
        count()
    return dgi, dgh, dh0


def layer_forward_in_kernel(x, w_ih, b_ih, w_hh, b_hh, h0, md: torch.dtype) -> Residuals:
    """``layer_forward_ref`` on the card through ``csrc/gru_layer.cu``: the
    forward that computes ``x[t] @ W_ih`` inside the recurrence, one
    persistent launch per batch slice of ``layer_plan``. bf16 or strict fp32
    where ``layer_route`` says 'in_kernel', and the ``fwd_gi`` probe. The
    weights and biases are read as torch stores them, x from its padded
    copy in md (``_padded``: x itself where it is one); hseq comes back as a
    view of rows padded to 16 bytes. Raises where no plan fits the card."""
    what = "gru_layer_scan_x forward"
    _check_cuda(what, x, w_ih, b_ih, w_hh, b_hh, h0)
    T, B, I, H = _layer_dims(what, x, w_ih, w_hh, h0)
    plan = layer_plan(B, I, H, *gru_stack.plan_limits(x.device), esize=md.itemsize)
    with torch.no_grad():
        xp = _padded(x, md)
    return _forward(what, plan, md, xp, None, w_ih, b_ih, w_hh, b_hh, h0, 0, _COUNT["fwd"])


def layer_backward_in_kernel(res: Residuals, dY: torch.Tensor):
    """``layer_backward_ref`` on the card through ``csrc/gru_layer.cu``: the
    persistent reverse sweep (one launch per batch slice of ``layer_plan``),
    then one GEMM of dx, then ``_layer_dw``. Deterministic: every output is
    summed in a fixed order."""
    hseq, rzn, ghn, x, h0, w_ih, w_hh = res
    what = "gru_layer_scan_x backward"
    _check_cuda(what, hseq, rzn, ghn, x, h0, w_ih, w_hh, dY)
    T, B, I, H = _layer_dims(what, x, w_ih, w_hh, h0)
    md = hseq.dtype
    _check_residuals(what, (T, B, H), md, hseq, rzn, ghn, dY, padded=True)
    limits = gru_stack.plan_limits(x.device)
    plan = layer_plan(B, I, H, *limits, esize=md.itemsize)
    dgi, dgh, dh0 = _sweep(what + " sweep", plan, hseq, h0, rzn, ghn, dY, w_hh, _COUNT["bwd"])
    with torch.no_grad():
        hs, xp, h0b = (_padded(t, md) for t in (hseq, x, h0))
        dx = torch.empty(T, B, I, dtype=md, device=x.device)
        _gemm("dx", [_dx_job(dgi, _padded(w_ih, md), dx)], x, _COUNT["dx"], md)
    return (dx.float(), *_layer_dw(dgi, xp, dgh, hs, h0b, limits[0], md), dh0)


def _scan_plan(what, gi, w_hh, h0) -> LayerPlan:
    """The hoisted-gi forward's checks and plan (bf16)."""
    _check_cuda(what, gi, w_hh, h0)
    T, B, G = gi.shape
    H = G // 3
    if tuple(w_hh.shape) != (G, H) or tuple(h0.shape) != (B, H):
        raise ValueError(f"{what}: gi {tuple(gi.shape)}, w_hh {tuple(w_hh.shape)}, h0 {tuple(h0.shape)}")
    return layer_plan(B, 0, H, *gru_stack.plan_limits(gi.device), hoisted=True)


def scan_forward(gi, w_hh, b_hh, h0) -> Residuals:
    """``scan_forward_ref`` on the card: the persistent forward with the
    input gates read from device memory, rounded to bf16 at the boundary
    (``gru.py:409``), one launch per batch slice of ``layer_plan``."""
    what = "gru_layer_scan forward"
    _check_cuda(what, gi, w_hh, b_hh, h0)
    plan = _scan_plan(what, gi, w_hh, h0)
    with torch.no_grad():
        gi_ = gi.to(torch.bfloat16).contiguous()
    return _forward(what, plan, torch.bfloat16, None, gi_, None, None, w_hh, b_hh, h0, 0, _COUNT["scan_fwd"])


def gru_probe_scan(gi, w_hh, b_hh, h0, mode: str) -> torch.Tensor:
    """``gru_layer_scan``'s forward kernel as ``run_variant``'s probe:
    gi (T, B, 3H), w_hh (3H, H), b_hh (3H), h0 (B, H) -> hseq (T, B, H)
    bf16, forward only. ``mode`` 'gates_nostore' (the production kernel
    without its r|z|n and gh_n stores) or 'matmul_only' (the serial h @ W_hh
    chain and the carry; all 3H columns of the product are computed). One
    launch per batch slice for CUDA tensors, ``gru_probe_scan_ref`` for CPU
    tensors."""
    code = _probe_mode(mode)
    if _plain_here(gi):
        return gru_probe_scan_ref(gi, w_hh, b_hh, h0, mode)
    what = f"gru_probe_scan {mode}"
    _check_cuda(what, gi, w_hh, b_hh, h0)
    plan = _scan_plan(what, gi, w_hh, h0)
    with torch.no_grad():
        gi_ = gi.to(torch.bfloat16).contiguous()
    # the sink stays null: it only keeps matmul_only's z and n products live
    return _forward(what, plan, torch.bfloat16, None, gi_, None, None, w_hh, b_hh, h0, code,
                    _COUNT[f"probe_{mode}"])[0]


def scan_backward(res: Residuals, dY: torch.Tensor):
    """``scan_backward_ref`` on the card: the persistent reverse sweep
    without dx, then ``_layer_dw``'s GEMM and sum of dW_hh / db_hh."""
    hseq, rzn, ghn, h0, w_hh = res
    what = "gru_layer_scan backward"
    bf = torch.bfloat16
    _check_cuda(what, hseq, rzn, ghn, h0, w_hh, dY)
    T, B, H = hseq.shape
    if tuple(w_hh.shape) != (3 * H, H) or tuple(h0.shape) != (B, H):
        raise ValueError(f"{what}: hseq {tuple(hseq.shape)}, w_hh {tuple(w_hh.shape)}, h0 {tuple(h0.shape)}")
    _check_residuals(what, (T, B, H), bf, hseq, rzn, ghn, dY, padded=True)
    limits = gru_stack.plan_limits(hseq.device)
    plan = layer_plan(B, 0, H, *limits, hoisted=True)
    dgi, dgh, dh0 = _sweep(what + " sweep", plan, hseq, h0, rzn, ghn, dY, w_hh, _COUNT["scan_bwd"])
    with torch.no_grad():
        hs, h0b = _padded(hseq, bf), _padded(h0, bf)
    _, _, dwhh, dbhh = _layer_dw(None, None, dgh, hs, h0b, limits[0], bf)
    return dgi.float(), dwhh, dbhh, dh0


class _GRULayerX(torch.autograd.Function):
    """route: 'kernel' (``layer_forward`` / ``layer_backward``), 'in_kernel'
    (the ``csrc/gru_layer.cu`` instance) or 'plain'; tensors on the CPU
    always take the plain versions."""

    @staticmethod
    def forward(ctx, route, md, x, w_ih, b_ih, w_hh, b_hh, h0):
        ctx.route = "plain" if _plain_here(x) else route
        if ctx.route != "plain":
            x = _padded(x, md)  # the forward's operand, kept for the dW GEMM
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
    as the reference's. Kernels for CUDA tensors (on the route
    ``layer_route`` picks for the shape and dtype), the plain versions for
    CPU tensors."""
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
