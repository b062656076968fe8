"""Fused free-running generation: wrapper, plain version, shared noise.

Port of ``molvax/kernels/generate.py:60-77,169-254``. ``fused_generate``
runs the whole T-step decode of a teacher-forced model in one launch of the
hand-written kernel ``csrc/generate.cu``; ``fused_generate_ref`` is the same
math in plain torch ops. For a CUDA tensor the wrapper launches the kernel
or raises; it takes the plain version only for tensors on the CPU.

The TPU-only eligibility checks of the reference (B % 128 and the VMEM
weight budget) do not apply: the kernel takes any batch, and the decoder
weights are read from L2 / device memory, not held in on-chip memory. So
``moses_scaled`` (4 x GRU-1024) takes the kernel on the card where the TPU
fell back to the scan.

Sampling draws Gumbel-max noise from a counter-based 32-bit hash of
(seed, step, batch row, class) (``noise_bits``): the kernel and the plain
version draw identical noise, so the two can be compared exactly. Like the
TPU kernel's on-chip PRNG, the stream is seed-deterministic but differs
from the reference's ``jax.random`` stream.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utils import matmul_dtype, round_to
from . import _build

# kernel launches made by fused_generate (not by the plain version)
launches = 0

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


def noise_bits(seed: int, t: int, rows: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """uint32 bits (in int64) for every (row, class) pair of step t, as the
    kernel's ``noise_bits``. ``rows`` (B, 1) and ``classes`` (1, C) broadcast."""
    h = _mix32(torch.full((), seed & _MASK32, dtype=torch.int64, device=rows.device))
    h = _mix32((h + rows) & _MASK32)
    h = _mix32((h + t) & _MASK32)
    return _mix32((h + classes) & _MASK32)


def fold_in(seed: int, data: int) -> int:
    """A new 32-bit seed from (seed, data), mix32(mix32(seed) + data): the
    counterpart of ``jax.random.fold_in`` for the port's counter hash."""
    h = _mix32(torch.tensor(seed & _MASK32, dtype=torch.int64))
    return int(_mix32((h + (data & _MASK32)) & _MASK32))


def gumbel_noise(seed: int, t: int, batch: int, classes: int, device) -> torch.Tensor:
    """(batch, classes) fp32 Gumbel(0, 1) noise of step t:
    u = (top24(bits) + 1) / 2**24 in (0, 1], g = -log(-log(u))."""
    rows = torch.arange(batch, dtype=torch.int64, device=device)[:, None]
    cls = torch.arange(classes, dtype=torch.int64, device=device)[None, :]
    bits = noise_bits(seed, t, rows, cls)
    u = ((bits >> 8).to(torch.float32) + 1.0) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


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


def _giz1(model, z_emb: torch.Tensor) -> torch.Tensor:
    """The constant z part of layer 1's input gates, one fp32 GEMM outside
    the decode loop, as in the reference wrapper: (B, 3H)."""
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
):
    """The kernel's math in plain torch ops: z_emb (B, Lz) -> codes (B, T)
    int32. Operands are rounded to bf16 and multiplied in fp32, so products
    are exact and sums accumulate in fp32, as in the kernel.

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
        giz1 = _giz1(model, z_emb)
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
                s = s / temperature + gumbel_noise(seed, t, B, C, dev)
            if scores is not None:
                scores[:, t] = s
            code = torch.argmax(s, dim=-1)
            codes[:, t] = code.to(torch.int32)
            if force_codes is not None:
                code = force_codes[:, t].long()
            prev = torch.nn.functional.one_hot(code, C).float()
    return (codes, scores) if return_scores else codes


# -- the kernel --------------------------------------------------------------


def _pack(model, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's weight buffers: bf16 [W_c | W_hh_0 | (W_ih_l, W_hh_l) |
    W_out] and fp32 [b_hh_0 | (b_ih_l, b_hh_l) | b_out], each matrix in
    (in, out) row-major layout (csrc/generate.cu)."""
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


def _bind():
    return _build.function(
        "molvax_fused_generate",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p],
    )


def fused_generate(
    model,
    cfg,
    z_emb: torch.Tensor,
    seed: int = 0,
    greedy: bool = True,
    temperature: float = 1.0,
) -> torch.Tensor:
    """z_emb (B, Lz) [already selu(linear_3(z))] -> codes (B, T) int32.

    On CUDA this launches ``csrc/generate.cu`` once for the whole decode,
    on the current stream; on the CPU it runs ``fused_generate_ref``.
    ``temperature`` is a runtime argument: changing it rebuilds nothing."""
    global launches
    if z_emb.device.type == "cpu":
        return fused_generate_ref(model, cfg, z_emb, seed, greedy, temperature)
    if z_emb.device.type != "cuda":
        raise ValueError(f"fused_generate: unsupported device {z_emb.device}")
    if z_emb.dim() != 2 or z_emb.shape[0] == 0:
        raise ValueError(f"fused_generate: z_emb must be (B>0, Lz), got {tuple(z_emb.shape)}")
    if model.linear_4.weight.device != z_emb.device:
        raise ValueError("fused_generate: model and z_emb are on different devices")
    if not greedy and not temperature > 0:
        raise ValueError(f"fused_generate: temperature must be > 0, got {temperature}")
    # sizes from the weights themselves: the kernel reads by these
    B, T = z_emb.shape[0], cfg.max_len
    C, H, L = model.linear_4.out_features, model.gru.hidden_size, model.gru.num_layers
    with torch.no_grad():
        giz1 = _giz1(model, z_emb).contiguous()
        start = _start(model, C, z_emb.device).contiguous()
        w, b = _pack(model, z_emb.device)
    if giz1.shape != (B, 3 * H) or giz1.dtype != torch.float32:
        raise ValueError(f"fused_generate: giz1 {tuple(giz1.shape)} {giz1.dtype} != ({B}, {3 * H}) fp32")
    expect_w = C * 3 * H + H * 3 * H + (L - 1) * 2 * H * 3 * H + H * C
    if w.numel() != expect_w or b.numel() != 3 * H + (L - 1) * 6 * H + C:
        raise ValueError("fused_generate: packed weights do not match the decoder's sizes")
    fn = _bind()
    codes = torch.empty(B, T, dtype=torch.int32, device=z_emb.device)
    err = fn(
        giz1.data_ptr(), start.data_ptr(), w.data_ptr(), b.data_ptr(), codes.data_ptr(),
        B, T, C, H, L, int(bool(greedy)), seed & _MASK32, float(temperature),
        torch.cuda.current_stream(z_emb.device).cuda_stream,
    )
    _build.check(err, "fused_generate")
    launches += 1
    return codes
