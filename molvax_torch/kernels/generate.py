"""Fused free-running generation: wrapper, planner, plain versions, shared noise.

Port of ``molvax/kernels/generate.py:60-77,169-254``. ``fused_generate``
runs the whole T-step decode of a teacher-forced model in one launch of the
hand-written kernel ``csrc/generate.cu``; ``fused_generate_ref`` is the same
math in plain torch ops. For a CUDA tensor the wrapper launches the kernel
or raises; it takes the plain version only for tensors on the CPU.

Two instances of the kernel. Wherever ``generate_plan`` lays the decode out
(every decoder weight resident in the shared memory of one block per SM,
as the TPU kernel kept them in VMEM), the persistent decode runs: one
cooperative launch per slice of the batch (one at B=256, ``zinc250k``
width). Where no layout fits (``moses_scaled``'s 4 x GRU-1024), the
row-block decode runs, which re-reads the weights from L2 every step. The
route is decided by the plan before any launch. ``pack_blocks`` lays the
weights out per block; the kernel's plain pieces (``start_gi1_ref``,
``gather_gi1_ref``, ``phase_ref``, ``gate_ref``, ``head_ref``) are its
phases in plain torch ops.

The TPU-only eligibility checks of the reference (B % 128 and the VMEM
weight budget) do not apply: both instances take any batch, and the
row-block decode any width.

Sampling draws Gumbel-max noise from a counter-based 32-bit hash of
(seed, step, batch row, class) (``noise_bits``): the kernel and the plain
version draw identical noise, so the two can be compared exactly. The row
is the global one, ``row_base`` plus the row of the call: a data-parallel
rank decoding its rows of a global batch (``row_base`` the global index of
its first row) draws the noise the one-process decode draws for them. Like the
TPU kernel's on-chip PRNG, the stream is seed-deterministic but differs
from the reference's ``jax.random`` stream. ``gumbel_table`` draws the noise
of all T steps of a scan-route decode (``latent.sample``) at once, in one
launch of ``csrc/noise.cu``, bit for bit the stack of the per-step
``gumbel_noise``.

``FusedStep`` is the scan route's fp32 decoder on a card (its last section):
``csrc/decode_step.cu``'s packing and latent-gate launches once a decode,
then one fused GRU-cell launch a layer and one head launch a step; its
plain versions are ``pack_step_ref``, ``latent_gates_ref``,
``code_gates_ref``, ``gate_ref`` and ``decode_step_ref``, and its launches
count in ``decode_step_launches``.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import weakref
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..utils import matmul_dtype, round_to
from . import _build
from .gru_stack import SMS, SMEM, _PAD_BYTES, _stream, _up, card_limits

# kernel launches made by fused_generate (not by the plain version): all of
# them, and by instance
launches = 0
persistent_launches = 0  # the persistent decode (csrc/generate.cu gen_persistent_kernel)
row_block_launches = 0  # the row-block decode, for widths no plan takes (fused_generate_kernel)
# launches of gumbel_table's kernel (csrc/noise.cu): one a sampled scan-route decode
noise_table_launches = 0

_MASK32 = 0xFFFFFFFF


def generation_kernel_supported(cfg, device) -> bool:
    """Whether ``latent.sample.generate`` routes to ``fused_generate``: a
    teacher-forced decoder, bf16 matmuls, tensors on CUDA. (The caller adds
    ``cfg.use_pallas_generation`` and ``constrained=False``.)"""
    return (
        torch.device(device).type == "cuda"
        and cfg.decoder_conditioning == "teacher_forced"
        and matmul_dtype(cfg, device) == torch.bfloat16
    )


# -- noise -------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) held in int64, without int64
    overflow: split x into 16-bit halves (x_hi * c_hi * 2**32 vanishes)."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * (c & 0xFFFF)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 (as ``mix32`` in csrc/common.cuh)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def seed_word(seed: Union[int, torch.Tensor], device) -> torch.Tensor:
    """A 32-bit seed as a 0-d int64 tensor on ``device``: a Python int is
    made there (a fill, no copy from the host); a one-element integer tensor
    on that device (int32 bit patterns included) is read as its low 32 bits,
    with no host read."""
    if isinstance(seed, torch.Tensor):
        return seed.reshape(()).to(torch.int64) & _MASK32
    return torch.full((), seed & _MASK32, dtype=torch.int64, device=device)


def noise_bits(seed: Union[int, torch.Tensor], t: Union[int, torch.Tensor], rows: torch.Tensor,
               classes: torch.Tensor) -> torch.Tensor:
    """uint32 bits (in int64) for every (row, class) pair of step t, as the
    kernel's ``noise_bits``. ``rows`` (B, 1) and ``classes`` (1, C) broadcast
    (and an int64 tensor of steps ``t`` with them). ``seed`` is a Python int
    or a one-element integer tensor on the rows' device (``seed_word``)."""
    h = _mix32(seed_word(seed, rows.device))
    h = _mix32((h + rows) & _MASK32)
    h = _mix32((h + t) & _MASK32)
    return _mix32((h + classes) & _MASK32)


def fold_in(seed: int, data: int) -> int:
    """A new 32-bit seed from (seed, data), mix32(mix32(seed) + data): the
    counterpart of ``jax.random.fold_in`` for the port's counter hash."""
    return int(fold_in_range(seed, data, 1)[0])


def fold_in_range(seed: int, start: int, count: int) -> np.ndarray:
    """(count,) uint32: ``fold_in(seed, start + i)`` for i < count, in one
    pass of the counter hash over a host vector."""
    h = _mix32(torch.full((), seed & _MASK32, dtype=torch.int64))
    data = torch.arange(start, start + count, dtype=torch.int64) & _MASK32
    return _mix32((h + data) & _MASK32).numpy().astype(np.uint32)


def gumbel_noise(seed: int, t: int, batch: int, classes: int, device, row_base: int = 0) -> torch.Tensor:
    """(batch, classes) fp32 Gumbel(0, 1) noise of step t for the global
    rows ``row_base`` .. ``row_base + batch - 1``:
    u = (top24(bits) + 1) / 2**24 in (0, 1], g = -log(-log(u))."""
    return _gumbel(seed, t, torch.arange(row_base, row_base + batch, dtype=torch.int64, device=device), classes)


def _gumbel(seed: int, t: int, rows: torch.Tensor, classes: int) -> torch.Tensor:
    """``gumbel_noise`` of the batch rows ``rows`` (R,) int64: (R, classes)."""
    cls = torch.arange(classes, dtype=torch.int64, device=rows.device)[None, :]
    return _gumbel_of(noise_bits(seed, t, rows[:, None], cls))


def _gumbel_of(bits: torch.Tensor) -> torch.Tensor:
    """Gumbel(0, 1) noise from hash bits (int64 uint32 values), elementwise."""
    u = ((bits >> 8).to(torch.float32) + 1.0) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def gumbel_table_ref(seed: Union[int, torch.Tensor], steps: int, batch: int, classes: int, device,
                     row_base: int = 0) -> torch.Tensor:
    """(steps, batch, classes) fp32: ``gumbel_noise`` of steps 0 .. steps - 1
    in one pass of torch ops, bit for bit their stack (t enters the hash as
    one added word, so the hash of (seed, row) is shared by every step)."""
    ar = functools.partial(torch.arange, dtype=torch.int64, device=device)
    return _gumbel_of(noise_bits(seed, ar(steps)[:, None, None], ar(row_base, row_base + batch)[None, :, None],
                                 ar(classes)[None, None, :]))


def gumbel_table(seed: Union[int, torch.Tensor], steps: int, batch: int, classes: int, device,
                 row_base: int = 0) -> torch.Tensor:
    """The sampling noise of a decode's first ``steps`` steps, (steps, batch,
    classes) fp32 contiguous, ``gumbel_table_ref``'s bits: on CUDA one launch
    of ``csrc/noise.cu``, which reads the seed from device memory (a Python
    int is first put there by a fill, no copy from the host; a one-element
    int32 or int64 tensor on the device is read as its low 32 bits, so a
    CUDA Graph replays with the seed written into it); elsewhere the plain
    version."""
    global noise_table_launches
    device = torch.device(device)
    if device.type != "cuda":
        return gumbel_table_ref(seed, steps, batch, classes, device, row_base)
    table = torch.empty(steps, batch, classes, device=device)
    if not isinstance(seed, torch.Tensor):
        seed = seed_word(seed, table.device)
    if seed.numel() != 1 or seed.device != table.device or seed.dtype not in (torch.int32, torch.int64):
        raise ValueError("gumbel_table: the seed must be a Python int or a one-element int32 or int64 tensor on "
                         f"{table.device}")
    fn = _build.function("molvax_gumbel_table", [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p])
    err = fn(table.data_ptr(), steps, batch, classes, seed.data_ptr(), row_base & _MASK32, _stream(table))
    _build.check(err, "gumbel_table")
    noise_table_launches += 1
    return table


# -- shared set-up -----------------------------------------------------------


def _layer_weights(model):
    """The decoder's weights in (in, 3H) layout, fp32, and the z part of the
    layer-1 input weight split off: (w_z, b_ih1, w_c, layers, w_out, b_out),
    layers = [(w_ih or None, b_ih or None, w_hh, b_hh)] per layer."""
    gru = model.gru
    C = model.linear_4.out_features
    w_ih1 = gru.weight_ih_l0  # (3H, Lz + C)
    Lz = w_ih1.shape[1] - C
    layers = []
    for li in range(gru.num_layers):
        w_ih = getattr(gru, f"weight_ih_l{li}")
        b_ih = getattr(gru, f"bias_ih_l{li}")
        layers.append(
            (
                None if li == 0 else w_ih.T,
                None if li == 0 else b_ih,
                getattr(gru, f"weight_hh_l{li}").T,
                getattr(gru, f"bias_hh_l{li}"),
            )
        )
    return (
        w_ih1[:, :Lz],
        gru.bias_ih_l0,
        w_ih1[:, Lz:].T,
        layers,
        model.linear_4.weight.T,
        model.linear_4.bias,
    )


def latent_gates_ref(model, z_emb: torch.Tensor) -> torch.Tensor:
    """The constant z part of layer 1's input gates, one fp32 GEMM outside
    the decode loop, as in the reference wrapper: (B, 3H), b_ih included
    (the fused step's latent-gate launch computes it too)."""
    w_z, b_ih1 = _layer_weights(model)[:2]
    return z_emb.float() @ w_z.T + b_ih1


def _start(model, C: int, device) -> torch.Tensor:
    if model.start_token is None:
        return torch.zeros(C, dtype=torch.float32, device=device)
    return model.start_token.detach().float()


# -- plain version -----------------------------------------------------------


def fused_generate_ref(
    model,
    cfg,
    z_emb: torch.Tensor,
    seed: int = 0,
    greedy: bool = True,
    temperature: float = 1.0,
    force_codes: Optional[torch.Tensor] = None,
    return_scores: bool = False,
    row_base: int = 0,
):
    """The kernel's math in plain torch ops: z_emb (B, Lz) -> codes (B, T)
    int32. Operands are rounded to bf16 and multiplied in fp32, so products
    are exact and sums accumulate in fp32, as in the kernel. ``row_base``:
    the global index of z_emb's first row (the sampling noise's row).

    ``force_codes`` (B, T) feeds those codes back instead of the chosen
    ones, and ``return_scores`` also returns the per-step scores (B, T, C)
    that the argmax saw (logits, or logits/temperature + noise), so a
    kernel's choices can be replayed and checked against the plain
    maximum."""
    bf = torch.bfloat16
    T = cfg.max_len
    with torch.no_grad():
        _, _, w_c, layers, w_out, b_out = _layer_weights(model)
        B, C = z_emb.shape[0], w_c.shape[0]
        dev = z_emb.device
        giz1 = latent_gates_ref(model, z_emb)
        w_c = round_to(w_c, bf)
        layers = [
            (None if w_ih is None else round_to(w_ih, bf), b_ih, round_to(w_hh, bf), b_hh)
            for w_ih, b_ih, w_hh, b_hh in layers
        ]
        w_out = round_to(w_out, bf)
        H = layers[0][2].shape[0]
        hs = [torch.zeros(B, H, device=dev) for _ in layers]
        prev = _start(model, C, dev)[None, :].expand(B, C)
        codes = torch.empty(B, T, dtype=torch.int32, device=dev)
        scores = torch.empty(B, T, C, device=dev) if return_scores else None
        for t in range(T):
            x = None
            for li, (w_ih, b_ih, w_hh, b_hh) in enumerate(layers):
                if li == 0:
                    gi = giz1 + round_to(prev, bf) @ w_c
                else:
                    gi = round_to(x, bf) @ w_ih + b_ih
                gh = round_to(hs[li], bf) @ w_hh + b_hh
                r = torch.sigmoid(gi[:, :H] + gh[:, :H])
                z = torch.sigmoid(gi[:, H : 2 * H] + gh[:, H : 2 * H])
                n = torch.tanh(gi[:, 2 * H :] + r * gh[:, 2 * H :])
                hs[li] = n + z * (hs[li] - n)
                x = hs[li]
            s = round_to(x, bf) @ w_out + b_out
            if not greedy:
                s = s / temperature + gumbel_noise(seed, t, B, C, dev, row_base)
            if scores is not None:
                scores[:, t] = s
            code = torch.argmax(s, dim=-1)
            codes[:, t] = code.to(torch.int32)
            if force_codes is not None:
                code = force_codes[:, t].long()
            prev = torch.nn.functional.one_hot(code, C).float()
    return (codes, scores) if return_scores else codes


# -- the persistent decode's planner, packing and plain pieces ---------------

_UNITS = 8  # hidden units a block owns in every layer: one n8 tile a gate (csrc/generate.cu GEN_UNITS)
_MAX_LAYERS = 4  # the kernel's instances
_NOUT = 40  # the head's columns: the classes padded to 5 n8 tiles
_MAX_ROWS = 128  # batch rows a group: one m16 tile a warp, at most 8 warps
_KPAD = _PAD_BYTES // 2  # bf16 padding of a shared-memory weight row
_BF = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class GeneratePlan:
    """How the persistent decode lies on the card: ``g`` row groups of
    ``rows`` batch rows, each of ``q`` blocks that own 8 (``_UNITS``) hidden
    units of every layer and hold their weight slices (and all of W_out) in
    ``smem`` bytes of shared memory for the whole decode; ``slices``
    launches cover B rows. ``K`` is H rounded up to 32, the length of a
    packed weight row (before its padding)."""

    g: int
    q: int
    rows: int
    slices: int
    K: int
    smem: int

    @property
    def blocks(self) -> int:
        return self.g * self.q


def _block_elems(C: int, K: int, L: int) -> int:
    """bf16 elements of a block's packed weights (csrc/generate.cu
    gen_block_elems): W_hh of L layers and W_ih of L - 1, 3 x units rows
    each, and W_out's _NOUT rows, all of K + _KPAD; W_c's 3 x units rows of
    C rounded up to 8."""
    return ((2 * L - 1) * 3 * _UNITS + _NOUT) * (K + _KPAD) + 3 * _UNITS * _up(C, 8)


@functools.lru_cache(maxsize=64)
def generate_plan(B: int, C: int, H: int, L: int, sms: int = SMS, smem: int = SMEM) -> Optional[GeneratePlan]:
    """Lay the persistent decode out for batch B, C classes and L GRU layers
    of width H on a card of ``sms`` SMs with ``smem`` bytes of shared memory
    per block, one block per SM. The wrapper passes the card's own
    (``card_limits``); the defaults are an H100 SXM's (``gru_stack``'s). A
    block owns 8 units of every layer: the narrowest slice, so that the
    most weight fits; q = ceil(H / 8) blocks make a group, and as many
    groups as the SMs hold (g q <= sms, rows a multiple of 16, at most 128:
    one m16 tile a warp); ``slices`` launches cover the rest of B, their
    rows evened out. Returns None where no layout fits: more than 4 layers
    or 40 classes (the kernel's instances), more than ``sms`` blocks a
    group, or a block's weights beyond ``smem``. The wrapper then takes the
    row-block decode: a route planned before the launch."""
    if B < 1 or C < 1 or H < 1 or L < 1:
        raise ValueError(f"generate_plan: B={B}, C={C}, H={H}, L={L}")
    if L > _MAX_LAYERS or C > _NOUT:
        return None
    q, K = -(-H // _UNITS), _up(H, 32)
    need = 2 * _block_elems(C, K, L)
    if q > sms or need > smem:
        return None
    g = max(1, min(sms // q, -(-B // 16)))
    slices = -(-B // (g * _MAX_ROWS))
    rows = _up(-(-B // (g * slices)), 16)
    if slices == 1:
        g = -(-B // rows)
    return GeneratePlan(g, q, rows, slices, K, need)


def k_order(K: int) -> torch.Tensor:
    """The packed order of K columns (K a multiple of 32): position p of a
    packed weight row holds column ``k_order(K)[p]``. In each block of 32
    columns a thread's 16-byte load of an h row, columns 8 tq .. 8 tq + 7,
    gives the A fragment's k-pairs (2 tq, 2 tq + 8) of the block's first
    k16 step, then of its second (csrc/generate.cu warp_product), so
    position 16 s + 8 hi + 2 tq + j holds column 8 tq + 4 s + 2 hi + j."""
    p = torch.arange(K)
    r = p % 32
    s, hi, tq, j = r // 16, r // 8 % 2, r // 2 % 4, r % 2
    return p - r + 8 * tq + 4 * s + 2 * hi + j


def pack_blocks(w_c: torch.Tensor, layers, w_out: torch.Tensor, plan: GeneratePlan) -> torch.Tensor:
    """The persistent decode's weights, (q, block elements) bf16, block j's
    row the shared-memory image it copies (csrc/generate.cu
    gen_block_elems): per layer l the columns gate * H + 8 j + u of W_hh_l
    (H, 3H) as rows gate * 8 + u, then those of W_ih_l for l >= 1, then
    W_out (H, C) transposed (one row per class, _NOUT rows), each row's K
    in ``k_order`` and zero past H, padded by _KPAD; then W_c (C, 3H) as
    rows gate * 8 + u of C columns (rounded up to 8). Units past H are zero
    rows. ``layers`` as ``_layer_weights``'."""
    C, G = w_c.shape
    H = G // 3
    K, KS, q, dev = plan.K, plan.K + _KPAD, plan.q, w_c.device
    order = k_order(K).to(dev)

    def product_rows(w: torch.Tensor) -> torch.Tensor:  # (H, 3H) -> (q, 3 units, KS)
        d = torch.zeros(K, 3, q * _UNITS, dtype=_BF, device=dev)
        d[:H, :, :H] = w.detach().to(_BF).reshape(H, 3, H)
        d = d[order].reshape(K, 3, q, _UNITS).permute(2, 1, 3, 0).reshape(q, 3 * _UNITS, K)
        return torch.nn.functional.pad(d, (0, _KPAD))

    slots = [product_rows(w_hh) for _, _, w_hh, _ in layers]
    slots += [product_rows(w_ih) for w_ih, _, _, _ in layers[1:]]
    out = torch.zeros(K, _NOUT, dtype=_BF, device=dev)
    out[:H, :C] = w_out.detach().to(_BF)
    out = torch.nn.functional.pad(out[order].T, (0, _KPAD))
    wc = torch.zeros(_up(C, 8), 3, q * _UNITS, dtype=_BF, device=dev)
    wc[:C, :, :H] = w_c.detach().to(_BF).reshape(C, 3, H)
    wc = wc.reshape(-1, 3, q, _UNITS).permute(2, 1, 3, 0)
    parts = [t.reshape(q, -1) for t in slots] + [out.reshape(1, -1).expand(q, -1), wc.reshape(q, -1)]
    return torch.cat(parts, dim=1).contiguous()


def _biases(layers, b_out: torch.Tensor) -> torch.Tensor:
    """fp32 [b_hh_l (3H) for every layer | b_ih_l (3H) for l >= 1 | b_out
    (C)]: the persistent decode's bias buffer (b_ih of layer 1 is in giz1)."""
    parts = [b_hh for _, _, _, b_hh in layers] + [b_ih for _, b_ih, _, _ in layers[1:]] + [b_out]
    return torch.cat([v.detach().float().reshape(-1) for v in parts]).contiguous()


def start_gi1_ref(giz1: torch.Tensor, w_c: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Layer 1's input gates at t = 0: giz1 (B, 3H) + bf16(start) @ bf16(W_c),
    the start token's product (the same for every row); W_c (C, 3H)."""
    return giz1 + round_to(start, _BF)[None, :].expand(giz1.shape[0], -1) @ round_to(w_c, _BF)


def gather_gi1_ref(giz1: torch.Tensor, w_c: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """Layer 1's input gates at t >= 1: prev is one-hot, so bf16(prev) @ W_c
    is row ``code`` (B,) of bf16 W_c, exactly: giz1 + bf16(W_c)[code]."""
    return giz1 + round_to(w_c, _BF)[code.long()]


def phase_ref(x: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor, w_hh: torch.Tensor,
              b_hh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase l >= 2 of step t: the one operand bf16(h_{l-1}(t)) (B, H) times
    W_ih_l and W_hh_{l-1} (H, 3H) -> (gi_l(t), gh_{l-1}(t+1)), fp32, biases
    added."""
    xb = round_to(x, _BF)
    return xb @ round_to(w_ih, _BF) + b_ih, xb @ round_to(w_hh, _BF) + b_hh


def gate_ref(gi: torch.Tensor, gh: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The GRU gate on fp32 gi, gh (B, 3H), r|z|n, and the carry h (B, H)."""
    H = h.shape[-1]
    r = torch.sigmoid(gi[:, :H] + gh[:, :H])
    z = torch.sigmoid(gi[:, H : 2 * H] + gh[:, H : 2 * H])
    n = torch.tanh(gi[:, 2 * H :] + r * gh[:, 2 * H :])
    return n + z * (h - n)


def head_ref(h: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, w_out: torch.Tensor, b_out: torch.Tensor,
             t: int, rows: torch.Tensor, seed: int = 0, greedy: bool = True,
             temperature: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The head of step t on bf16(h_L(t)) (B, H): (gh_L(t+1) (B, 3H), the
    codes (B,) int64), the first maximum of the logits (with the noise of
    the batch rows ``rows`` (B,) int64 when sampled)."""
    xb = round_to(h, _BF)
    s = xb @ round_to(w_out, _BF) + b_out
    if not greedy:
        s = s / temperature + _gumbel(seed, t, rows, s.shape[-1])
    return xb @ round_to(w_hh, _BF) + b_hh, torch.argmax(s, dim=-1)


# -- the kernels ---------------------------------------------------------------


def _pack(model, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row-block decode's weight buffers: bf16 [W_c | W_hh_0 | (W_ih_l,
    W_hh_l) | W_out] and fp32 [b_hh_0 | (b_ih_l, b_hh_l) | b_out], each
    matrix in (in, out) row-major layout (csrc/generate.cu)."""
    _, _, w_c, layers, w_out, b_out = _layer_weights(model)
    ws = [w_c]
    bs = []
    for w_ih, b_ih, w_hh, b_hh in layers:
        if w_ih is not None:
            ws.append(w_ih)
            bs.append(b_ih)
        ws.append(w_hh)
        bs.append(b_hh)
    ws.append(w_out)
    bs.append(b_out)
    w = torch.cat([m.detach().to(torch.bfloat16).reshape(-1) for m in ws])
    b = torch.cat([v.detach().float().reshape(-1) for v in bs])
    return w.to(device).contiguous(), b.to(device).contiguous()


def _count(instance: str) -> None:
    """One launch of ``instance`` ('persistent' or 'row_block')."""
    global launches, persistent_launches, row_block_launches
    launches += 1
    if instance == "persistent":
        persistent_launches += 1
    else:
        row_block_launches += 1


def _launch_row_block(giz1, start, w, b, codes, C: int, H: int, L: int, greedy: bool, seed: int,
                      temperature: float, row_base: int) -> None:
    """One launch of the row-block decode over all B rows, the first of
    them global row ``row_base`` (the noise's)."""
    B, T = codes.shape
    if w.numel() != C * 3 * H + H * 3 * H + (L - 1) * 2 * H * 3 * H + H * C or b.numel() != 3 * H + (L - 1) * 6 * H + C:
        raise ValueError("fused_generate: packed weights do not match the decoder's sizes")
    fn = _build.function(
        "molvax_fused_generate",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_uint32, ctypes.c_float, ctypes.c_uint32,
                                                       ctypes.c_void_p],
    )
    err = fn(giz1.data_ptr(), start.data_ptr(), w.data_ptr(), b.data_ptr(), codes.data_ptr(),
             B, T, C, H, L, int(bool(greedy)), seed & _MASK32, float(temperature), row_base & _MASK32,
             _stream(codes))
    _build.check(err, "fused_generate (row-block)")
    _count("row_block")


def _launch_persistent(giz1, start, w, b, hbuf, codes, plan: GeneratePlan, base: int, end: int, C: int, H: int,
                       L: int, greedy: bool, seed: int, temperature: float, row_base: int) -> None:
    """One cooperative launch of the persistent decode over batch rows
    [base, end): hbuf (L, 2, Bp, K) bf16 zeros, shared by the slices.
    Batch row r draws the noise of global row ``row_base + r``."""
    B, T = codes.shape
    if w.shape != (plan.q, _block_elems(C, plan.K, L)) or b.numel() != (2 * L - 1) * 3 * H + C:
        raise ValueError("fused_generate: packed weights do not match the plan")
    fn = _build.function("molvax_generate_persistent",
                         [ctypes.c_void_p] * 7 + [ctypes.c_int] * 13 + [ctypes.c_uint32, ctypes.c_float,
                                                                        ctypes.c_uint32, ctypes.c_void_p])
    flags = torch.zeros(plan.g, dtype=torch.int32, device=codes.device)
    err = fn(giz1.data_ptr(), start.data_ptr(), w.data_ptr(), b.data_ptr(), hbuf.data_ptr(), flags.data_ptr(),
             codes.data_ptr(), B, T, C, H, L, plan.K, hbuf.shape[2], plan.q, plan.g, plan.rows, base, end,
             int(bool(greedy)), seed & _MASK32, float(temperature), row_base & _MASK32, _stream(codes))
    _build.check(err, "fused_generate (persistent)")
    _count("persistent")


# model -> (weight version, packed weights, biases) of the persistent decode
_packed: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _packed_blocks(model, plan: GeneratePlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pack_blocks`` and ``_biases`` of the model's decoder, built once per
    weight version: the key holds each decoder parameter's storage and its
    in-place version counter (``_version``), so an optimizer step or a
    ``load_state_dict`` that updates the weights in place repacks them.
    (The packing is ~1.2 ms of torch ops on an H100, a fifth of a decode.)"""
    params = [*model.gru.parameters(), *model.linear_4.parameters()]
    key = (plan.K, plan.q, tuple((p.data_ptr(), p._version) for p in params))
    hit = _packed.get(model)
    if hit is None or hit[0] != key:
        _, _, w_c, layers, w_out, b_out = _layer_weights(model)
        hit = (key, pack_blocks(w_c, layers, w_out, plan), _biases(layers, b_out))
        _packed[model] = hit
    return hit[1], hit[2]


def _setup(model, z_emb: torch.Tensor, plan: Optional[GeneratePlan]):
    """What the decode needs before its launches: giz1 (B, 3H), one fp32
    GEMM; the start token (C); the weights and biases, packed for the
    persistent decode of ``plan`` (``_packed_blocks``) or, for None, for
    the row-block decode (``_pack``)."""
    C = model.linear_4.out_features
    giz1 = latent_gates_ref(model, z_emb).contiguous()
    start = _start(model, C, z_emb.device).contiguous()
    if plan is None:
        return (giz1, start, *_pack(model, z_emb.device))
    return (giz1, start, *_packed_blocks(model, plan))


def _decode(model, cfg, z_emb: torch.Tensor, seed: int, greedy: bool, temperature: float,
            row_block: bool = False, row_base: int = 0) -> torch.Tensor:
    """The decode on the instance that ``generate_plan`` picks for the card
    of ``z_emb`` (the row-block decode where it returns None, or where
    ``row_block``): the set-up, then the launches (one per slice of the
    plan). ``row_base``: the global index of z_emb's first row."""
    B, T = z_emb.shape[0], cfg.max_len
    # sizes from the weights themselves: the kernels read by these
    C, H, L = model.linear_4.out_features, model.gru.hidden_size, model.gru.num_layers
    dev = z_emb.device
    plan = None if row_block else generate_plan(B, C, H, L, *card_limits(dev))
    with torch.no_grad():
        giz1, start, w, b = _setup(model, z_emb, plan)
        if giz1.shape != (B, 3 * H) or giz1.dtype != torch.float32:
            raise ValueError(f"fused_generate: giz1 {tuple(giz1.shape)} {giz1.dtype} != ({B}, {3 * H}) fp32")
        codes = torch.empty(B, T, dtype=torch.int32, device=dev)
        if plan is None:
            _launch_row_block(giz1, start, w, b, codes, C, H, L, greedy, seed, temperature, row_base)
            return codes
        span = plan.g * plan.rows
        hbuf = torch.zeros(L, 2, plan.slices * span, plan.K, dtype=_BF, device=dev)
        for base in range(0, B, span):
            _launch_persistent(giz1, start, w, b, hbuf, codes, plan, base, min(B, base + span), C, H, L, greedy,
                               seed, temperature, row_base)
    return codes


def fused_generate(
    model,
    cfg,
    z_emb: torch.Tensor,
    seed: int = 0,
    greedy: bool = True,
    temperature: float = 1.0,
    row_base: int = 0,
) -> torch.Tensor:
    """z_emb (B, Lz) [already selu(linear_3(z))] -> codes (B, T) int32.

    On CUDA this launches ``csrc/generate.cu`` on the current stream: the
    persistent decode once per slice of ``generate_plan`` (once at B=256,
    ``zinc250k`` width), or the row-block decode once where no plan fits.
    On the CPU it runs ``fused_generate_ref``. ``temperature`` is a runtime
    argument: changing it rebuilds nothing. ``row_base``: the global index
    of z_emb's first row, whose sampling noise row 0 draws (a data-parallel
    rank's share of a global batch)."""
    if z_emb.device.type == "cpu":
        return fused_generate_ref(model, cfg, z_emb, seed, greedy, temperature, row_base=row_base)
    if z_emb.device.type != "cuda":
        raise ValueError(f"fused_generate: unsupported device {z_emb.device}")
    if z_emb.dim() != 2 or z_emb.shape[0] == 0:
        raise ValueError(f"fused_generate: z_emb must be (B>0, Lz), got {tuple(z_emb.shape)}")
    if model.linear_4.weight.device != z_emb.device:
        raise ValueError("fused_generate: model and z_emb are on different devices")
    if not greedy and not temperature > 0:
        raise ValueError(f"fused_generate: temperature must be > 0, got {temperature}")
    return _decode(model, cfg, z_emb, seed, greedy, temperature, row_base=row_base)


# -- the scan route's fp32 decoder step (csrc/decode_step.cu) ------------------
#
# The scan route (latent.sample's _scan: the constrained decode, the Gumbel
# or greedy scan, evaluate()'s logit decodes) and beam search decode through
# ``nn.decoder.decoder_step`` on the CPU. On a card one ``FusedStep`` a
# decode runs the same fp32 math as hand-written kernels: a packing launch
# and a latent-gate launch once a decode, then a step's L cell launches and
# one head launch. Each kernel has a plain version here (``pack_step_ref``,
# ``latent_gates_ref``, ``code_gates_ref``, ``gate_ref``, ``decode_step_ref``).

# launches of csrc/decode_step.cu: a FusedStep's packing and latent gates (2),
# then L + 1 a step; a CUDA Graph's replay counts what its capture recorded
decode_step_launches = 0

_SK = 32  # k a stage of the cell kernel: Hp and the padded latent width are multiples of it
_SROW = _SK + 4  # words a staged row
_SSTAGES = 3
_CELL_ROWS, _CELL_UNITS = 128, 32  # the cell kernel's tile (CELL_BM, CELL_UN): Hp is a multiple of its units
# shared-memory bytes of a cell block (CELL_SMEM): its 3-stage ring, or the cluster's sums where larger
CELL_SMEM = 4 * max(_SSTAGES * (_CELL_ROWS + 3 * _CELL_UNITS) * _SROW, _CELL_ROWS * (4 * _CELL_UNITS + 8))
_MAX_SLICES = 8  # blocks a cluster (the portable limit)
# clusters of 1 .. 8 cell blocks an H100 80GB HBM3 holds at once (cudaOccupancyMaxActiveClusters,
# one block an SM, 132 SMs in GPCs of unequal sizes): the planner's default; FusedStep plans from
# the card's own (``card_clusters``)
H100_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15)
# a wave's fixed cost (its first loads after the launch before it, the cluster's meeting, the gate
# math) in k-tiles of a block's main loop: ~7 us against ~1.9 us a k-tile on an H100 at B=256
_WAVE_KTILES = 3.6
_CELL_GATES, _CELL_FIRST, _CELL_NEXT = 0, 1, 2


def cell_tiles(B: int, Hp: int) -> int:
    """The cell launch's tiles of 128 rows x 32 units (all three gate
    columns of each unit) for B rows and Hp units."""
    return (Hp // _CELL_UNITS) * -(-B // _CELL_ROWS)


def plan_cost(slices: int, B: int, Hp: int, k_tiles: int, clusters: Tuple[int, ...]) -> float:
    """A launch's time in k-tiles of a block's main loop with clusters of
    ``slices`` blocks a tile, each a contiguous share of the k-tiles (the x
    half, then the h half): its waves (tiles over the clusters the card
    holds at once) times a wave's fixed cost and a block's k-tiles."""
    return -(-cell_tiles(B, Hp) // clusters[slices - 1]) * (_WAVE_KTILES + -(-k_tiles // slices))


@functools.lru_cache(maxsize=256)
def cell_plan(B: int, Hp: int, k_tiles: int, clusters: Tuple[int, ...] = H100_CLUSTERS) -> int:
    """The blocks a cluster of the cell launch for B rows, Hp (a multiple of
    32) units and ``k_tiles`` k-tiles of 32 (x and h halves together) on a
    card that holds ``clusters[s - 1]`` clusters of s blocks at once: of the
    sizes s <= min(8, k_tiles), the least ``plan_cost``, then the smallest."""
    if B < 1 or Hp < 1 or Hp % _SK or k_tiles < 1 or len(clusters) < _MAX_SLICES:
        raise ValueError(f"cell_plan: B={B}, Hp={Hp}, k_tiles={k_tiles}, clusters={clusters}")
    sizes = [s for s in range(1, min(_MAX_SLICES, k_tiles) + 1) if clusters[s - 1] >= 1]
    return min(sizes, key=lambda s: (plan_cost(s, B, Hp, k_tiles, clusters), s))


@functools.lru_cache(maxsize=8)
def card_clusters(index: int) -> Tuple[int, ...]:
    """Clusters of 1 .. 8 cell blocks card ``index`` holds at once
    (cudaOccupancyMaxActiveClusters)."""
    fn = _build.function("molvax_step_cell_clusters", [ctypes.c_int, ctypes.c_void_p])
    out = []
    with torch.cuda.device(index):
        for s in range(1, _MAX_SLICES + 1):
            n = ctypes.c_int(0)
            _build.check(fn(s, ctypes.byref(n)), "decode step (cluster occupancy)")
            out.append(n.value)
    return tuple(out)


class StepWeights(NamedTuple):
    """The step kernels' operands, fp32, zero-padded (csrc/decode_step.cu's
    layout): per layer W_hh (3 Hp, Hp) and b_hh, b_ih (3 Hp), and W_ih for
    l >= 1, rows gate * Hp + unit (None at layer 0); W_iz, layer 0's z
    columns (3 Hp, Kz); wc, its one-hot columns transposed (C, 3 Hp); W_out
    (Cp, Hp) and b_out (Cp); z's embedding (B, Kz)."""

    whh: List[torch.Tensor]
    wih: List[Optional[torch.Tensor]]
    bhh: List[torch.Tensor]
    bih: List[torch.Tensor]
    wz: torch.Tensor
    wc: torch.Tensor
    w4: torch.Tensor
    b4: torch.Tensor
    z: torch.Tensor


def step_sizes(model, z_emb: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """(B, L, H, C, Lz) of a decode: the rows of z's embedding and the
    decoder's sizes, from its weights."""
    C, gru = model.linear_4.out_features, model.gru
    return z_emb.shape[0], gru.num_layers, gru.hidden_size, C, gru.weight_ih_l0.shape[1] - C


def _pad_jobs(model, z_emb: torch.Tensor):
    """Each packed operand's source, its padded shape and its map (``PackJob``
    of csrc/decode_step.cu): [(name, layer, src, (rg, R, Rp, qg, Q, Qp),
    (sr, sq, off))]. Destination (rg Rp, qg Qp) dense; element (gr Rp + r,
    gq Qp + q) is src[off + (gr R + r) sr + (gq Q + q) sq] for r < R, q < Q,
    else 0."""
    B, L, H, C, Lz = step_sizes(model, z_emb)
    Hp, Kz, Cp = _up(H, _SK), _up(Lz, _SK), _up(C, 8)
    gru = model.gru
    jobs = []

    def mat(name, li, w, K, Kp, off=0):  # (3H, .) columns off .. off + K -> (3 Hp, Kp)
        jobs.append((name, li, w, (3, H, Hp, 1, K, Kp), (w.stride(0), w.stride(1), off)))

    def vec(name, li, b, n, npad, groups=3):  # (groups n) -> (groups npad)
        jobs.append((name, li, b, (1, 1, 1, groups, n, npad), (0, b.stride(0), 0)))

    for li in range(L):
        mat("whh", li, getattr(gru, f"weight_hh_l{li}"), H, Hp)
        if li:
            mat("wih", li, getattr(gru, f"weight_ih_l{li}"), H, Hp)
        vec("bhh", li, getattr(gru, f"bias_hh_l{li}"), H, Hp)
        vec("bih", li, getattr(gru, f"bias_ih_l{li}"), H, Hp)
    w0 = gru.weight_ih_l0
    mat("wz", 0, w0, Lz, Kz)
    jobs.append(("wc", 0, w0, (1, C, C, 3, H, Hp), (w0.stride(1), w0.stride(0), Lz * w0.stride(1))))
    w4 = model.linear_4.weight
    jobs.append(("w4", 0, w4, (1, C, Cp, 1, H, Hp), (w4.stride(0), w4.stride(1), 0)))
    vec("b4", 0, model.linear_4.bias, C, Cp, groups=1)
    jobs.append(("z", 0, z_emb, (1, B, B, 1, Lz, Kz), (z_emb.stride(0), z_emb.stride(1), 0)))
    return jobs


def _gather_padded(src: torch.Tensor, shape, strides) -> torch.Tensor:
    """A ``PackJob`` in torch ops: the padded dense matrix."""
    rg, R, Rp, qg, Q, Qp = shape
    sr, sq, off = strides
    r, q = torch.arange(rg * Rp, device=src.device), torch.arange(qg * Qp, device=src.device)
    gr, ri, gq, qi = r // Rp, r % Rp, q // Qp, q % Qp
    ok = (ri < R)[:, None] & (qi < Q)[None, :]
    idx = torch.where(ok, off + ((gr * R + ri) * sr)[:, None] + ((gq * Q + qi) * sq)[None, :], 0)
    flat = torch.as_strided(src.detach(), (int(idx.max()) + 1,), (1,))  # the elements from src's first
    return torch.where(ok, flat.float()[idx], 0.0)


def _assemble(parts) -> StepWeights:
    """[(name, layer, tensor)] -> StepWeights."""
    by = collections.defaultdict(dict)
    for name, li, t in parts:
        by[name][li] = t
    L = len(by["whh"])
    return StepWeights([by["whh"][i] for i in range(L)], [by["wih"].get(i) for i in range(L)],
                       [by["bhh"][i] for i in range(L)], [by["bih"][i] for i in range(L)], by["wz"][0],
                       by["wc"][0], by["w4"][0], by["b4"][0][0], by["z"][0])


def pack_step_ref(model, z_emb: torch.Tensor) -> StepWeights:
    """The packing launch's output in torch ops (biases as (3 Hp,) and (Cp,))."""
    parts = []
    for name, li, src, shape, strides in _pad_jobs(model, z_emb):
        t = _gather_padded(src, shape, strides)
        parts.append((name, li, t.reshape(-1) if name in ("bhh", "bih") else t))
    return _assemble(parts)


def code_gates_ref(model, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Layer 0's one-hot half of its input gates: the one-hot of ``prev``
    (B,) times W_ic^T is row prev of W_ic^T, a gather, (B, 3H); at t = 0
    (``prev`` None) the start vector's product, (1, 3H) (zeros without a
    learned start)."""
    w_c = _layer_weights(model)[2].float()  # (C, 3H)
    if prev is not None:
        return w_c[prev.long()]
    return _start(model, w_c.shape[0], w_c.device)[None, :] @ w_c


def decode_step_ref(model, hs: torch.Tensor, gz: torch.Tensor,
                    prev: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused step in plain torch ops: the hidden states (L, B, H), z's
    gates (``latent_gates_ref``) and the last codes (B,) (None at t = 0: the
    start vector) -> (hidden states, logits (B, C)); ``nn.decoder.decoder_step``'s
    function with the one-hot product a gather and the z half hoisted."""
    gru = model.gru
    x, out = None, []
    for li in range(gru.num_layers):
        if li == 0:
            gi = gz + code_gates_ref(model, prev)
        else:
            gi = x @ getattr(gru, f"weight_ih_l{li}").float().T + getattr(gru, f"bias_ih_l{li}").float()
        h = hs[li]
        x = gate_ref(gi, h @ getattr(gru, f"weight_hh_l{li}").float().T + getattr(gru, f"bias_hh_l{li}").float(), h)
        out.append(x)
    return torch.stack(out), x @ model.linear_4.weight.float().T + model.linear_4.bias.float()


class _PackJob(ctypes.Structure):
    """``PackJob`` of csrc/decode_step.cu."""

    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p), ("sr", ctypes.c_longlong),
                ("sq", ctypes.c_longlong), ("off", ctypes.c_longlong),
                *((name, ctypes.c_int) for name in ("rg", "R", "Rp", "qg", "Q", "Qp"))]


class _CellArgs(ctypes.Structure):
    """``CellArgs`` of csrc/decode_step.cu."""

    _fields_ = [*((name, ctypes.c_void_p) for name in ("x", "h", "wx", "wh", "bx", "bh", "gz", "wc", "code",
                                                       "start", "out")),
                *((name, ctypes.c_int) for name in ("B", "H", "Hp", "ldx", "C", "code_ld"))]


class _HeadArgs(ctypes.Structure):
    """``HeadArgs`` of csrc/decode_step.cu."""

    _fields_ = [*((name, ctypes.c_void_p) for name in ("h", "w", "b", "logits", "scores", "noise", "code")),
                ("inv_temp", ctypes.c_float),
                *((name, ctypes.c_int) for name in ("B", "C", "Hp", "logits_ld", "code_ld"))]


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launched() -> None:
    global decode_step_launches
    decode_step_launches += 1


class FusedStep:
    """One decode's fp32 decoder on a card (csrc/decode_step.cu): made by two
    launches, the packing of the weights and z's embedding (``StepWeights``)
    and z's gates (B, 3 Hp); then ``step`` a step, L cell launches and one
    head launch. The hidden states are (L, B, Hp) fp32 with zero padding
    columns (``state``); a step reads one set and writes another (other
    blocks still read h_t while h_{t+1} is written). The launches go to the
    current stream; a CUDA Graph captures them as they are."""

    def __init__(self, model, z_emb: torch.Tensor):
        dev = z_emb.device
        if dev.type != "cuda":
            raise ValueError(f"FusedStep: z_emb on {dev}; the plain route is nn.decoder.decoder_step")
        weights = [*model.gru.parameters(), *model.linear_4.parameters()]
        if any(p.device != dev or p.dtype != torch.float32 for p in weights):
            raise ValueError(f"FusedStep: the decoder's weights must be fp32 on {dev}")
        if z_emb.dim() != 2 or z_emb.dtype != torch.float32 or z_emb.shape[0] == 0:
            raise ValueError(f"FusedStep: z_emb must be (B>0, Lz) fp32, got {tuple(z_emb.shape)} {z_emb.dtype}")
        self.B, self.L, self.H, self.C, self.Lz = step_sizes(model, z_emb)
        if z_emb.shape[1] != self.Lz:
            raise ValueError(f"FusedStep: z_emb has {z_emb.shape[1]} columns, the decoder takes {self.Lz}")
        self.Hp, self.Kz = _up(self.H, _SK), _up(self.Lz, _SK)
        held = card_clusters(torch.cuda.current_device() if dev.index is None else dev.index)
        self.plans = {_CELL_GATES: cell_plan(self.B, self.Hp, self.Kz // _SK, held),
                      _CELL_FIRST: cell_plan(self.B, self.Hp, self.Hp // _SK, held),
                      _CELL_NEXT: cell_plan(self.B, self.Hp, 2 * self.Hp // _SK, held)}
        start = model.start_token
        self.start = None if start is None else start.detach().float().contiguous()
        self.w = self._pack(model, z_emb)
        self.gz = torch.empty(self.B, 3 * self.Hp, device=dev)
        self._cell(_CELL_GATES, x=self.w.z, wx=self.w.wz, bx=self.w.bih[0], out=self.gz, ldx=self.Kz)

    def _pack(self, model, z_emb: torch.Tensor) -> StepWeights:
        jobs, parts, most = [], [], 0
        for name, li, src, shape, strides in _pad_jobs(model, z_emb):
            rg, _, Rp, qg, _, Qp = shape
            dst = torch.empty(rg * Rp, qg * Qp, device=z_emb.device)
            jobs.append(_PackJob(src.data_ptr(), dst.data_ptr(), *strides, *shape))
            parts.append((name, li, dst.reshape(-1) if name in ("bhh", "bih") else dst))
            most = max(most, dst.numel())
        table = (_PackJob * len(jobs))(*jobs)
        fn = _build.function("molvax_step_pack", [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        _build.check(fn(ctypes.addressof(table), len(jobs), most, _stream(z_emb)), "decode step (pack)")
        _launched()
        return _assemble(parts)

    def _cell(self, mode: int, x=None, h=None, wx=None, wh=None, bx=None, bh=None, out=None, ldx: int = 0,
              code: Optional[torch.Tensor] = None) -> None:
        code_ld = 0
        if code is not None:
            if code.dtype != torch.int32 or code.shape != (self.B,) or code.device != out.device:
                raise ValueError(f"FusedStep: the last codes must be ({self.B},) int32 on {out.device}")
            code_ld = code.stride(0)
        first = mode == _CELL_FIRST
        args = _CellArgs(_ptr(x), _ptr(h), _ptr(wx), _ptr(wh), _ptr(bx), _ptr(bh), _ptr(self.gz) if first else None,
                         _ptr(self.w.wc) if first else None, _ptr(code), _ptr(self.start) if first else None,
                         out.data_ptr(), self.B, self.H, self.Hp, ldx, self.C, code_ld)
        fn = _build.function("molvax_step_cell", [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        _build.check(fn(ctypes.addressof(args), mode, self.plans[mode], _stream(out)), "decode step (cell)")
        _launched()

    def state(self, *lead: int) -> torch.Tensor:
        """Zero hidden states, (*lead, L, B, Hp) fp32: the decode's first."""
        return torch.zeros(*lead, self.L, self.B, self.Hp, device=self.gz.device)

    def step(self, h: torch.Tensor, h_out: torch.Tensor, prev: Optional[torch.Tensor], logits: torch.Tensor,
             scores: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None, temperature: float = 1.0,
             codes: Optional[torch.Tensor] = None) -> None:
        """One step: the hidden states ``h`` (L, B, Hp) -> ``h_out`` (another
        buffer), the logits into ``logits`` (B, C), a view whose rows may lie
        apart (``logits[:, t]`` of the decode's (B, T, C)). ``prev`` (B,)
        int32, a view too: the last codes, None at t = 0 (the start vector).
        The scores are the logits, or with ``noise`` (B, C) the logits
        times (1 / ``temperature``) plus the noise; ``scores`` (B, C)
        receives them, and ``codes`` (B,) int32 their first maximum."""
        shape = (self.L, self.B, self.Hp)
        for name, t in (("h", h), ("h_out", h_out)):
            if t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous() or t.device != self.gz.device:
                raise ValueError(f"FusedStep.step: {name} must be contiguous {shape} fp32 on {self.gz.device}")
        if logits.shape != (self.B, self.C) or logits.stride(1) != 1 or logits.dtype != torch.float32:
            raise ValueError(f"FusedStep.step: logits must be ({self.B}, {self.C}) fp32, rows contiguous")
        for name, t in (("scores", scores), ("noise", noise)):
            if t is not None and (t.shape != (self.B, self.C) or not t.is_contiguous() or t.dtype != torch.float32):
                raise ValueError(f"FusedStep.step: {name} must be contiguous ({self.B}, {self.C}) fp32")
        if codes is not None and (codes.shape != (self.B,) or codes.dtype != torch.int32):
            raise ValueError(f"FusedStep.step: codes must be ({self.B},) int32")
        w = self.w
        for li in range(self.L):
            if li == 0:
                self._cell(_CELL_FIRST, h=h[0], wh=w.whh[0], bh=w.bhh[0], out=h_out[0], code=prev)
            else:
                self._cell(_CELL_NEXT, x=h_out[li - 1], h=h[li], wx=w.wih[li], wh=w.whh[li], bx=w.bih[li],
                           bh=w.bhh[li], out=h_out[li], ldx=self.Hp)
        inv = float(np.float32(1.0) / np.float32(temperature)) if noise is not None else 1.0
        args = _HeadArgs(h_out[self.L - 1].data_ptr(), w.w4.data_ptr(), w.b4.data_ptr(), logits.data_ptr(),
                         _ptr(scores), _ptr(noise), _ptr(codes), inv, self.B, self.C, self.Hp, logits.stride(0),
                         0 if codes is None else codes.stride(0))
        fn = _build.function("molvax_step_head", [ctypes.c_void_p, ctypes.c_void_p])
        _build.check(fn(ctypes.addressof(args), _stream(logits)), "decode step (head)")
        _launched()
