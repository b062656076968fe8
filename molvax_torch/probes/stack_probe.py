"""Where the GRU stack's time goes on the card, and the GRU kernels of one
checkout against another's.

Run by path from the root of a checkout, on a CUDA card:

    python3 molvax_torch/probes/stack_probe.py             # times at zinc250k width
    python3 molvax_torch/probes/stack_probe.py --steps     # a recurrence step decomposed
    python3 molvax_torch/probes/stack_probe.py [--root DIR] --layers  # the per-layer kernels
    python3 molvax_torch/probes/stack_probe.py --layer-steps  # the in-kernel forward's step decomposed
    python3 molvax_torch/probes/stack_probe.py --fused3-steps  # the fused3 wavefront's tick decomposed
    python3 molvax_torch/probes/stack_probe.py --root DIR  # the times of the checkout at DIR
    python3 molvax_torch/probes/stack_probe.py --sass DIR  # the bf16 kernels' SASS against DIR's
    python3 molvax_torch/probes/stack_probe.py [--root DIR] --decodes  # the automaton and the decodes
    python3 molvax_torch/probes/stack_probe.py [--root DIR] --encode   # the encoder and the sampler
    python3 molvax_torch/probes/stack_probe.py [--root DIR] --train    # those and the three trainers' steps
    python3 molvax_torch/probes/stack_probe.py --encode-split [A,B,..] # their parts, by variant

Every mode prints one JSON line per run, with the card's name and power
limit. Times are CUDA events, median of 5 after 2 warm-ups, at B=256,
T=120, I0=329, H=501, L=3, seeded weights (uniform +-1/sqrt(H)):

- default and ``--root``: the stack's forward and backward
  (``kernels.gru_stack.stack_forward`` / ``stack_backward``), and the GRU
  kernels beside it: ``gru_layer_scan_x`` forward and backward at layer 0,
  bf16 and strict fp32, ``gru_layer_scan`` forward and backward,
  ``gru_probe_scan`` (``matmul_only``), ``gru_fused3_scan`` and
  ``floor_loop`` (events, and device time queued behind a sleep); one
  greedy ``fused_generate`` decode at ``zinc250k`` width (B=256, seeded
  weights: ``make_decoder``), whichever instance the checkout takes; and
  the automaton kernel (``automaton_times``: ``auto_step`` per step at
  B=256, n=1 and n=120, ``auto_mask`` / ``auto_advance`` at 1,280 rows);
  the encoder and the sampler (``encode_times``) and the three trainers'
  steps (``train_times``: ``zinc250k``, ``zinc250k_quality``, strict-fp32
  ``zinc250k``, wall and device-busy ms). With
  ``--root`` the package is imported from DIR, so a parent commit unpacked
  there (``git archive``) and this checkout can be timed in turns on one
  card (parent, change, change, parent). The default mode adds the
  redesigned stack's own pieces (one layer's recurrence and sweep, the
  layer-0 input-gate GEMM) and the host time to enqueue a forward and a
  backward.
- ``--steps``: the recurrence and the sweep of one layer, bf16 and strict
  fp32, rebuilt with parts of their step taken out (results wrong, times
  only): the group barrier (``nobarrier``), the per-step product with its
  h / dgh copy (``noproduct``), both, and then the per-step loads or stores
  as well. Differences between the variants' times are the parts' costs. A
  variant may let the compiler drop more than was taken out (without
  stores, the forward's gate math has no use), which the reading must allow
  for. Two variants take apart the strict-fp32 product and its ring copy
  (the bf16 columns of those rows are the base kernels'). Then the
  strict-fp32 pieces (recurrence, sweep and the input-gate, dx and dW
  GEMMs) in each product form of ``csrc/gemm.cuh`` (``FORMS``: 3xTF32
  split products, split on the integer pipe or by ``cvt.rna.tf32.f32``,
  the GEMM's k-tiles summed apart or all in one tensor-core accumulator;
  or FFMA), each with its GEMMs' errors against a float64 product.
- ``--layers`` (with ``--root DIR`` or without): ``layer_times``, the
  in-kernel instance of ``gru_layer_scan_x`` (``csrc/gru_layer.cu``)
  forward and backward at fwd_gi's width (bf16, I=330), strict fp32 at
  I=329, and the widths no layout of the persistent route takes (bf16
  H=2304, fp32 H=1536; I=329), each beside cuDNN's one-layer GRU, and
  ``gru_layer_scan`` and its probe modes: parent, change, change, parent
  in one call is the A/B of the layer kernels.
- ``--layer-steps``: the in-kernel forward at those widths rebuilt with
  parts of its step taken out (``LAYER_VARIANTS``: the group barrier, the
  input product computed in the barrier's shadow, the hidden product, or
  all), times only.
- ``--fused3-steps``: ``gru_fused3_scan`` at H=501 and 512 in each variant
  of ``FUSED3_VARIANTS``: the wavefront as kept (x[t+1] @ W_ih computed in
  the shadow of step t's barrier, a layer two ticks behind its input), at
  skew 1 (x[t] @ W_ih at the start of step t, after the wait on the layer
  below), and with the input product, the hidden product, both, a team's
  own barrier wait or the wait on the layer below taken out; and one upper
  team's forward run alone on its layout.
- ``--decodes`` (with ``--root DIR`` or without): the automaton kernel's
  times (``automaton_times``) and the constrained greedy and beam-5
  decodes' (``decode_times``), events and device-busy time.
- ``--encode`` (with ``--root DIR`` or without): ``encode_times`` alone;
  ``--train``: ``encode_times`` and ``train_times``.
- ``--encode-split``: ``encode_times`` of the encoder and the sampler
  rebuilt in each variant of ``ENC_VARIANTS`` (a phase, a part of the conv
  stage, the loads of a phase or the grid barriers taken out; the
  sampler's rows a block and unrolling).
- ``--sass DIR``: every kernel of the library built from DIR's sources
  (the parent, unpacked as above) has a kernel of this checkout's library
  with the same SASS (``cuobjdump -sass``, addresses and encodings set
  aside; names differ where a template gained a parameter).
"""

from __future__ import annotations

import inspect
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

B, T, I0, H, L = 256, 120, 329, 501, 3

# (variant, [(text in csrc/gru_stack.cu, its replacement)])
_NOBARRIER = [("group_barrier(a.flags + grp, a.q * s);", "__syncthreads();"),
              ("if (t + 1 < a.T) group_barrier(a.flags + grp, a.q * (t + 1));", "__syncthreads();")]
_NOPRODUCT = [("struct RecArgs {", "#define stream_rows(...) __syncthreads()\nstruct RecArgs {")]
_NOLOADS = [("gi[mt][e][gte] = ok[mt][e] ? p[gte * H] : 0.0f;", "gi[mt][e][gte] = 0.0f;"),
            ("  load_in(a.T - 1);\n", "\n"), ("    if (t > 0) load_in(t - 1);\n", "\n"),
            ("float in[MT][4][6];", "float in[MT][4][6] = {};")]
_NOSTORES = [("        if (ok[mt][e]) {\n          const size_t o = (size_t)t * a.B + rowof[mt][e];",
              "        if (ok[mt][e] && t < 0) {\n          const size_t o = (size_t)t * a.B + rowof[mt][e];")] + [
    (f"        {p}[{i}] = ", f"        if (t < 0) {p}[{i}] = ") for p in ("pi", "ph") for i in ("0", "H", "2 * H")]
# strict fp32 only: the product without its ring copy, the copy without
# the product
_FP32_NOMATH = [("      fp32_k8(acc, corr,", "      if (kk < 0) fp32_k8(acc, corr,"),
                ("      fp32_k8(reinterpret_cast<Tile>(c)", "      if (kk < 0) fp32_k8(reinterpret_cast<Tile>(c)"),
                ("      fp32_k8(kacc, kcorr,", "      if (kk < 0) fp32_k8(kacc, kcorr,")]
_FP32_NOCOPY = [("      cp_async16(buf + row * stride + kc,", "      if (sizeof(E) == 2) cp_async16(buf + row * stride + kc,")]
# csrc/gemm.cuh's product forms of strict fp32, as (text, replacement):
# the one it holds (3xTF32, split on the integer pipe, the GEMM's k-tiles
# summed apart), the split by cvt.rna.tf32.f32, the GEMM summing every
# k-tile into one tensor-core accumulator, and FFMA
_SPLIT_INT = """  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));"""
_SPLIT_CVT = """  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));"""
_NOFLUSH = [("      float part[4][4][4] = {};\n", ""), ("fp32_k8(part, part,", "fp32_k8(acc, acc,"),
            ("#pragma unroll\n      for (int i = 0; i < 64; ++i) (&acc[0][0][0])[i] += (&part[0][0][0])[i];\n", "")]
_TF32_BODY = """  uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split_tf32(b(t, 8 * j + g), bh[j][0], bl[j][0]);
    split_tf32(b(t + 4, 8 * j + g), bh[j][1], bl[j][1]);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) split_tf32(a(16 * i + g + 8 * (r & 1), t + 4 * (r >> 1)), ah[r], al[r]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mma_tf32(corr[i][j], al, bh[j]);
      mma_tf32(corr[i][j], ah, bl[j]);
      mma_tf32(acc[i][j], ah, bh[j]);
    }
  }
"""
_FFMA_BODY = """#pragma unroll
  for (int k = 0; k < 8; ++k) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float a0 = a(16 * i + g, k), a1 = a(16 * i + g + 8, k);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float b0 = b(k, 8 * j + 2 * t), b1 = b(k, 8 * j + 2 * t + 1);
        acc[i][j][0] = fmaf(a0, b0, acc[i][j][0]);
        acc[i][j][1] = fmaf(a0, b1, acc[i][j][1]);
        acc[i][j][2] = fmaf(a1, b0, acc[i][j][2]);
        acc[i][j][3] = fmaf(a1, b1, acc[i][j][3]);
      }
    }
  }
"""
KEPT = "split_tf32"
FORMS = {KEPT: [], "split_tf32_cvt": [(_SPLIT_INT, _SPLIT_CVT)], "split_tf32_noflush": _NOFLUSH,
         "ffma": [(_TF32_BODY, _FFMA_BODY)]}
VARIANTS = {
    "base": [],
    "nobarrier": _NOBARRIER,
    "noproduct": _NOPRODUCT,
    "neither": _NOBARRIER + _NOPRODUCT,
    "neither_noloads": _NOBARRIER + _NOPRODUCT + _NOLOADS,
    "neither_nostores": _NOBARRIER + _NOPRODUCT + _NOSTORES,
    "empty": _NOBARRIER + _NOPRODUCT + _NOLOADS + _NOSTORES,
    "fp32_copy_only": _FP32_NOMATH,
    "fp32_product_only": _FP32_NOCOPY,
}


def variant_source(text: str, name: str, table: dict = VARIANTS) -> str:
    """csrc/gru_stack.cu's text with variant ``name``'s parts taken out (or,
    with table=FORMS, csrc/gemm.cuh's in product form ``name``)."""
    for old, new in table[name]:
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    return text


def build_variant(csrc: Path) -> None:
    """Build the kernels' library from the sources in ``csrc`` (a variant's
    copy of csrc/) into ``csrc``'s sibling ``lib/``, and load it in place of
    the checkout's for the rest of the process."""
    from molvax_torch.kernels import _build

    _build.CSRC, _build.BUILD_DIR, _build._lib = csrc, csrc.parent / "lib", None
    _build.load()


def make_inputs(device: str = "cuda:0", seed: int = 0) -> dict:
    g = torch.Generator(device=device).manual_seed(seed)
    k = 1.0 / H ** 0.5

    def u(*shape):
        return (2.0 * torch.rand(*shape, generator=g, device=device) - 1.0) * k

    args = (torch.randn(T, B, I0, generator=g, device=device), u(3 * H, I0), u(3 * H), u(L - 1, 3 * H, H),
            u(L - 1, 3 * H), u(L, 3 * H, H), u(L, 3 * H), torch.zeros(L, B, H, device=device))
    return {"args": args, "dY": 1e-2 * torch.randn(T, B, H, generator=g, device=device),
            "dhf": 1e-2 * torch.randn(L, B, H, generator=g, device=device)}


def make_decoder(device: str = "cuda:0", seed: int = 0):
    """(model, cfg, z_emb): ``zinc250k`` weights from torch's seeded
    default init, a random start token, B rows of z."""
    from molvax_torch.config import get_preset
    from molvax_torch.nn.decoder import latent_embed
    from molvax_torch.nn.vae import MolecularVAE

    cfg = get_preset("zinc250k").model
    torch.manual_seed(seed)
    model = MolecularVAE(cfg, device=device)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    with torch.no_grad():
        if model.start_token is not None:
            model.start_token.copy_(torch.randn(cfg.charset_size, generator=g, device=device))
        z_emb = latent_embed(model, cfg, torch.randn(B, cfg.latent_dim, generator=g, device=device))
    model.eval()
    return model, cfg, z_emb


def queued_ms(fn, reps: int = 3, sleep_cycles: int = 40_000_000) -> float:
    """Device ms of what one call of fn enqueues, run back to back (median
    of ``reps``): fn is enqueued behind a sleep kernel that outlasts the
    host's enqueueing (checked; the sleep doubles until it does), so the
    events after the sleep time the device alone, the gaps between
    launches included, the host's cost per launch not."""
    times = []
    while len(times) < reps:
        torch.cuda.synchronize()
        e0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        torch.cuda._sleep(sleep_cycles)
        a.record()
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        torch.cuda.synchronize()
        if host_ms < e0.elapsed_time(a):
            times.append(a.elapsed_time(b))
        else:
            sleep_cycles *= 2
    return sorted(times)[len(times) // 2]


def device_ms(fn, match: str, attempts: int = 3) -> tuple:
    """(device ms, kernel count) of the kernels whose name holds ``match``
    in one call of fn, from torch.profiler (its own count of the kernels
    it recorded); (0.0, 0) where it recorded none in ``attempts`` sessions.
    The profiler at times records no device activity in a session, or in
    any session of a process (seen with an H100 80GB HBM3), so such a session
    is run again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ms, n = 0.0, 0
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA and match in ev.key:
                ms += getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
                n += ev.count
        if n:
            return ms, n
    return 0.0, 0


def device_kernels(fn) -> dict:
    """{name: count} of every device activity (kernels, copies, memsets)
    that torch.profiler records in one session of fn; empty where it
    recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {ev.key: ev.count for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA}


def automaton_times(device: str = "cuda:0", seed: int = 0) -> dict:
    """The automaton kernel's times, ms, with the package on sys.path:
    ``auto_step`` per step as 120 launches of n=1 and as one n=120 launch at
    B=256, and ``auto_mask`` / ``auto_advance`` at the beam's 1,280 rows on
    the state of a 40-step walk; seeded scores tilted toward branches,
    rings and brackets (chip_smoke.py's walk). Each in-place call on its
    own copy of the state, made before the timing. CUDA events around
    each call (``*_per_step``, ``*_1280``: what a caller waits, the
    wrapper's host cost included), and the device time per launch
    (``device_*``: ``queued_ms`` of 120 n=1 launches, 3 n=120 launches, 20
    of each of the others)."""
    from molvax_torch.data.charset import DEFAULT_CHARSET
    from molvax_torch.kernels import automaton as ka
    from molvax_torch.latent.constrain import build_tables
    from molvax_torch.train.profiling import event_ms

    itab = ka.pack_tables(build_tables(DEFAULT_CHARSET)).to(device)
    C = itab.shape[1]
    g = torch.Generator(device=device).manual_seed(seed)
    tilt = torch.zeros(C, device=device)
    tilt[DEFAULT_CHARSET.chars.index(" ")] = -4.0
    for ch in "()123[]=#+-@H":
        tilt[DEFAULT_CHARSET.chars.index(ch)] = 1.0

    def scores(rows, steps):
        return (2.0 * torch.randn(rows, steps, C, generator=g, device=device) + tilt).contiguous()

    def on_copies(fn, state):
        pool = [state.clone() for _ in range(7)]
        return event_ms(lambda: fn(pool.pop()))

    sc = scores(B, T)
    per_step = [sc[:, k].contiguous() for k in range(T)]

    def walk(s):
        for k in range(T):
            ka.auto_step(itab, s, per_step[k], T - 1 - k)

    s0 = ka.new_state(B, T, device)
    out = {"auto_step_n1_per_step": on_copies(walk, s0) / T,
           "auto_step_n120_per_step": on_copies(lambda s: ka.auto_step(itab, s, sc, T - 1), s0) / T}
    rows = 5 * B
    sb = ka.new_state(rows, T, device)
    ka.auto_step(itab, sb, scores(rows, 40), T - 1)
    tok = ka.auto_mask(itab, sb, T - 41).to(torch.float32).argmax(1).to(torch.int32)
    out["auto_mask_1280"] = event_ms(lambda: ka.auto_mask(itab, sb, T - 41))
    out["auto_advance_1280"] = on_copies(lambda s: ka.auto_advance(itab, s, tok), sb)

    # copies for queued_ms's runs, one taken by each (a run it rejects takes one too)
    n1 = [s0.clone() for _ in range(8)]
    n120 = [[s0.clone() for _ in range(3)] for _ in range(8)]
    adv = [sb.clone() for _ in range(8)]
    out["device_auto_step_n1"] = queued_ms(lambda: walk(n1.pop())) / T
    out["device_auto_step_n120_per_step"] = queued_ms(
        lambda: [ka.auto_step(itab, s, sc, T - 1) for s in n120.pop()]) / 3 / T
    out["device_auto_mask_1280"] = queued_ms(lambda: [ka.auto_mask(itab, sb, T - 41) for _ in range(20)]) / 20
    out["device_auto_advance_1280"] = queued_ms(lambda: [ka.auto_advance(itab, s, tok)
                                                          for s in [adv.pop()] for _ in range(20)]) / 20
    return out


def decode_times(device: str = "cuda:0") -> dict:
    """The constrained decodes' times, with the package on sys.path: the
    greedy constrained decode (``generate(constrained=True)``, one
    ``auto_step`` a step) and beam 5 (``beam_generate``, one ``auto_mask``
    and one ``auto_advance`` a step) of B=256 latents at
    ``zinc250k_quality``'s width, ``make_decoder``'s weights: CUDA events
    (ms, what a caller waits) and one decode's device-busy ms from the
    profiler (every kernel and copy it recorded; 0 where it recorded none)."""
    from molvax_torch.config import get_preset
    from molvax_torch.latent.beam import beam_generate
    from molvax_torch.latent.sample import generate
    from molvax_torch.train.profiling import event_ms

    model, _, _ = make_decoder(device)
    qcfg = get_preset("zinc250k_quality").model
    g = torch.Generator(device=device).manual_seed(7)
    z = torch.randn(B, qcfg.latent_dim, generator=g, device=device)
    out = {}
    with torch.no_grad():
        for name, fn in (("constrained_greedy", lambda: generate(model, qcfg, z, constrained=True)),
                         ("beam5", lambda: beam_generate(model, qcfg, z, beam=5, constrained=True))):
            out[f"{name}_ms"] = event_ms(fn)
            out[f"{name}_device_busy_ms"] = device_ms(fn, "")[0]
    return out


# (variant, [(file in csrc/, text, its replacement)]): parts of the
# encoder's phases taken out (results wrong, times only; every bulk copy
# issued is still waited for, or the launch fails), and the sampler's rows a
# block and unrolling
ENC_VARIANTS = {
    "base": [],
    "no_rows": [("conv_enc.cu", "row < d.B; row += gridDim.x * L.teams)", "row < 0 * d.B; row += gridDim.x * L.teams)")],
    "no_first_conv": [("conv_enc.cuh", "  conv_first(d, reinterpret_cast", "  if (d.n < 0) conv_first(d, reinterpret_cast")],
    "no_conv_mma": [("conv_enc.cuh", "    conv_mma(d, s, reinterpret_cast", "    if (s < 0) conv_mma(d, s, reinterpret_cast")],
    "no_flush": [("conv_enc.cuh", "  FOR_TEAM(w, wit, ts) flush_row(", "  FOR_TEAM(w, wit, ts) if (d.n < 0) flush_row(")],
    "no_dense_mma": [("conv_enc.cu", "for (int s = c0 / 16 + warp; s < s_end; s += WARPS)",
                      "for (int s = c0 / 16 + warp; s < 0 * s_end; s += WARPS)")],
    "no_head_mma": [("conv_enc.cu", "for (int s = warp; s < E8 / 8; s += WARPS)", "for (int s = warp; s < 0 * E8; s += WARPS)")],
    "no_grid_sync": [("conv_enc.cu", "  grid.sync();  // h3 complete", "  __syncthreads();"),
                     ("conv_enc.cu", "  grid.sync();  // h2 complete", "  __syncthreads();")],
    # the conv stages' mma.sync replaced by a sum of their operands (loads and
    # the dependent chain kept, the tensor cores not used)
    "conv_fake_mma": [("conv_enc.cuh", '  asm volatile(\n      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "',
                       '  d.v.v[0] += __uint_as_float(a.v.r[0] ^ a.v.r[1] ^ a.v.r[2] ^ a.v.r[3] ^ b.v.r[0] ^ b.v.r[1]);\n'
                       '  if (d.v.v[0] == 1.2345f) asm volatile(\n      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "')],
    # (--encode-timeline only) a dependent chain of 200 shared-memory loads
    # (pointer chasing over the teams' zeroed buffers) timed by the
    # calibration stamps (24, 25) in place of the FMA chain
    "smem_chase": [("conv_enc.cu", "  __syncthreads();\n  unsigned char* mine = smem + L.warp_off + team * L.warp_bytes;",
                    "  __syncthreads();\n  if (threadIdx.x == 0 && blockIdx.x == 0) {\n"
                    "    volatile int* q = reinterpret_cast<volatile int*>(smem + L.warp_off); int j = 0; STAMP(24);\n"
                    "    for (int i = 0; i < 200; ++i) j = q[j];\n    STAMP(25); if (j == 77) a.mu[1] = 1.f; }\n"
                    "  unsigned char* mine = smem + L.warp_off + team * L.warp_bytes;"),
                   ("conv_enc.cu", "  STAMP(0);\n  { float x", "  STAMP(0);\n  if (0) { float x")],
    "sampler_rows8": [("sampler.cu", "constexpr int SAMPLER_ROWS = 4;", "constexpr int SAMPLER_ROWS = 8;")],
    "sampler_rows1": [("sampler.cu", "constexpr int SAMPLER_ROWS = 4;", "constexpr int SAMPLER_ROWS = 1;")],
    "sampler_no_unroll": [("sampler.cu", "#pragma unroll 4  // four of the lane's dims", "// four of the lane's dims")],
}
ENC_SOURCES = ("conv_enc.cu", "conv_enc.cuh", "gemm.cuh", "common.cuh", "sampler.cu")


# clock64 stamps of block 0's thread 0 (its first row's team) at the phase
# and stage boundaries of the encoder, written over mu's first row at the end
_STAMP = ("__device__ long long enc_stamps[32];\n"
          "#define STAMP(i) do { if (blockIdx.x == 0 && threadIdx.x == 0) enc_stamps[i] = clock64(); } while (0)\n")
TIMELINE = [
    ("conv_enc.cu", '#include "gemm.cuh"\n', _STAMP + '#include "gemm.cuh"\n'),
    ("conv_enc.cu", "  bars.wait(BAR_CONV);\n", "  STAMP(1);\n  bars.wait(BAR_CONV);\n  STAMP(2);\n"),
    ("conv_enc.cu", "  __syncthreads();\n  // the teams' buffers", "  __syncthreads();\n  STAMP(3);\n  // the teams' buffers"),
    ("conv_enc.cu", "  for (int i = threadIdx.x; i < nz; i += THREADS)", "  STAMP(4);\n  for (int i = threadIdx.x; i < nz; i += THREADS)"),
    ("conv_enc.cuh", "  team_sync(team, ts);\n  FOR_TEAM(w, wit, ts)\n  conv_first(",
     "  team_sync(team, ts);\n  STAMP(5);\n  FOR_TEAM(w, wit, ts)\n  conv_first("),
    ("conv_enc.cuh", "  team_sync(team, ts);\n  uint16_t* cur = buf0;", "  team_sync(team, ts);\n  STAMP(6);\n  uint16_t* cur = buf0;"),
    ("conv_enc.cuh", "    team_sync(team, ts);\n    uint16_t* tmp = cur;", "    team_sync(team, ts);\n    STAMP(6 + s);\n    uint16_t* tmp = cur;"),
    ("conv_enc.cuh", "  team_sync(team, ts);  // the buffers are the next row's",
     "  team_sync(team, ts);  // the buffers are the next row's\n  STAMP(10);"),
    ("conv_enc.cu", "      bars.wait(BAR_DW);\n", "      bars.wait(BAR_DW);\n      STAMP(13);\n"),
    ("conv_enc.cu", "    if (tid == 0 && tile + (int)gridDim.x >= L.tiles_dense",
     "    STAMP(14);\n    if (tid == 0 && tile + (int)gridDim.x >= L.tiles_dense"),
    ("conv_enc.cu", "    bars.wait(BAR_H2);\n    bars.wait(BAR_HW);\n", "    bars.wait(BAR_H2);\n    bars.wait(BAR_HW);\n    STAMP(17);\n"),
    ("conv_enc.cu", "#pragma unroll\n    for (int i = 0; i < 2; ++i)\n#pragma unroll\n      for (int j = 0; j < NT; ++j)",
     "    STAMP(18);\n#pragma unroll\n    for (int i = 0; i < 2; ++i)\n#pragma unroll\n      for (int j = 0; j < NT; ++j)"),
    ("conv_enc.cu", "  __syncthreads();\n  phase_conv(a, smem, bars);\n  grid.sync();  // h3 complete\n"
                    "  phase_dense(a, smem, bars);\n  grid.sync();  // h2 complete\n  phase_heads(a, smem, bars);\n",
     "  __syncthreads();\n  STAMP(0);\n  phase_conv(a, smem, bars);\n  STAMP(11);\n  grid.sync();  // h3 complete\n  STAMP(12);\n"
     "  phase_dense(a, smem, bars);\n  STAMP(15);\n  grid.sync();  // h2 complete\n  STAMP(16);\n  phase_heads(a, smem, bars);\n"
     "  STAMP(19);\n  grid.sync();  // every block's mu written\n  if (blockIdx.x == 0 && threadIdx.x == 0)\n"
     "    for (int i = 0; i < 32; ++i) reinterpret_cast<long long*>(a.mu)[i] = enc_stamps[i];\n"),
]
# extra marks inside the weights' layout and a calibration chain of 1,000
# dependent FMAs (4 cycles each on an H100)
TIMELINE += [
    ("conv_enc.cuh", "        [&](int pr, const float* v) { st32(w1 + 2 * pr, pack2(v[0], v[1])); });\n  }\n",
     "        [&](int pr, const float* v) { st32(w1 + 2 * pr, pack2(v[0], v[1])); });\n  }\n  STAMP(20);\n"),
    ("conv_enc.cuh", "        [&](int pr, const float* v) { st32(ws + 2 * pr, pack2(v[0], v[1])); });\n",
     "        [&](int pr, const float* v) { st32(ws + 2 * pr, pack2(v[0], v[1])); });\n    STAMP(20 + s);\n"),
    ("conv_enc.cu", "  STAMP(0);\n", "  STAMP(0);\n  { float x = threadIdx.x * 1e-9f; STAMP(24);\n"
                                    "    for (int i = 0; i < 1000; ++i) x = fmaf(x, 0.999f, 1e-7f);\n"
                                    "    STAMP(25); if (x == 12345.f) a.mu[0] = x; }\n"),
]
# marks inside the conv stages on the tensor cores (conv 2: 26-28, conv 3:
# 29-31): entry, the first unit's K loop done, its stores done
TIMELINE += [
    ("conv_enc.cuh", "  for (int u = w; u < units; u += ts) {\n",
     "  if (w == 0) STAMP(23 + 3 * s);\n  for (int u = w; u < units; u += ts) {\n"),
    ("conv_enc.cuh", "        warp_mma(acc[1][1], a1, b1);\n      }\n    }\n",
     "        warp_mma(acc[1][1], a1, b1);\n      }\n    }\n    if (u == 0) STAMP(24 + 3 * s);\n"),
    ("conv_enc.cuh", "                                                      relu_bias(acc[i][j][l].v[2 * h + 1], bias, o + 1, cout)));\n          }\n        }\n      }\n    }\n",
     "                                                      relu_bias(acc[i][j][l].v[2 * h + 1], bias, o + 1, cout)));\n          }\n        }\n      }\n    }\n    if (u == 0) STAMP(25 + 3 * s);\n"),
]
TIMELINE_MARKS = ["start", "copies issued", "copies landed", "weights laid out", "synced", "codes", "first conv",
                  "conv 2", "conv 3", "", "flushed", "phase A done", "barrier 1", "dense loads", "dense products",
                  "dense done", "barrier 2", "head loads", "head products", "end", "conv 1 table", "conv 2 table",
                  "conv 3 table", "", "calibration start", "calibration end (+4000 cycles?)", "conv 2 entry",
                  "conv 2 first unit's K loop", "conv 2 first unit stored", "conv 3 entry", "conv 3 first unit's K loop",
                  "conv 3 first unit stored"]


# the first row's conv stack run twice (the stamps of the second, warm run)
TIMELINE_WARM = [("conv_enc.cu", "    conv_row(d, L, smem, [&](int s)", "    for (int rep = 0; rep < 2; ++rep) conv_row(d, L, smem, [&](int s)")]


def encode_timeline(root: Path, reps: int = 5, warm: bool = False, variant: str = "base") -> dict:
    """The encoder rebuilt with clock64 stamps (TIMELINE) at zinc250k width,
    B=256: block 0's cycles from the kernel's start to each mark, median of
    ``reps`` launches."""
    from molvax_torch.kernels import conv_enc, gru_stack
    from molvax_torch.nn.encoder import encoder_params

    src = Path(gru_stack.__file__).resolve().parent / "csrc"
    gru_stack.plan_limits(torch.device("cuda", 0))
    d = root / "build" / "stack_probe" / "enc_timeline" / "csrc"
    shutil.rmtree(d.parent, ignore_errors=True)
    d.mkdir(parents=True)
    for f in ENC_SOURCES:
        text = (src / f).read_text()
        for file, old, new in TIMELINE + ENC_VARIANTS[variant] + (TIMELINE_WARM if warm else []):
            if file == f:
                if old not in text:
                    raise ValueError(f"timeline: {old!r} is not in {f}")
                text = text.replace(old, new)
        (d / f).write_text(text)
    build_variant(d)
    model, cfg, _ = make_decoder()
    g = torch.Generator(device="cuda:0").manual_seed(2)
    codes = torch.randint(0, cfg.charset_size, (B, cfg.max_len), generator=g, device="cuda:0")
    runs = []
    with torch.no_grad():
        for _ in range(reps + 1):
            mu, _ = conv_enc._encode_kernel(cfg, codes, encoder_params(model))
            stamps = mu.reshape(-1)[:64].view(torch.int64).tolist()
            runs.append([x - stamps[0] for x in stamps])
    runs = runs[1:]
    return {name: sorted(r[i] for r in runs)[len(runs) // 2] for i, name in enumerate(TIMELINE_MARKS) if name}


def encode_split(root: Path, names=None):
    """``encode_times`` with the encoder and the sampler rebuilt in each
    variant of ENC_VARIANTS (or those named; the two sources and their
    headers alone, under build/stack_probe/enc_<variant>/); differences
    between the variants' device times are the parts' costs. Yields a row
    a variant, as it is measured."""
    from molvax_torch.kernels import gru_stack

    src = Path(gru_stack.__file__).resolve().parent / "csrc"
    gru_stack.plan_limits(torch.device("cuda", 0))  # the card's limits, cached before the library is swapped
    for name in names or [v for v in ENC_VARIANTS if v != "smem_chase"]:
        subs = ENC_VARIANTS[name]
        d = root / "build" / "stack_probe" / f"enc_{name}" / "csrc"
        shutil.rmtree(d.parent, ignore_errors=True)
        d.mkdir(parents=True)
        for f in ENC_SOURCES:
            text = (src / f).read_text()
            for file, old, new in subs:
                if file == f:
                    if old not in text:
                        raise ValueError(f"variant {name}: {old!r} is not in {f}")
                    text = text.replace(old, new)
            (d / f).write_text(text)
        build_variant(d)
        from molvax_torch.kernels import _build

        ptxas = [" ".join(x.split()) for x in _build.info.log.splitlines()
                 if "Used" in x or "stack frame" in x]
        yield {"variant": name, **encode_times(), "ptxas": ptxas[:8]}


def _sampler_seed(sampler, seed: int, device):
    """The seed in the form the checkout's sampler kernel takes: a
    one-element tensor on the card where the kernel reads it from device
    memory, the int itself where the kernel takes it by value (older
    checkouts timed with ``--root``)."""
    if "seed.data_ptr()" not in inspect.getsource(sampler._sample_kernel):
        return seed
    return torch.full((), seed, dtype=torch.int32, device=device)


def encode_times(device: str = "cuda:0", seed: int = 0) -> dict:
    """``fused_encode`` and ``fused_sample_kl`` at ``zinc250k`` width, B=256,
    with the package on sys.path: ``make_decoder``'s weights, seeded codes
    (int64) and the plain encoder's mu and logvar. For each wrapper call:
    the device ms of what it enqueues (``queued_ms`` of 20 calls, the
    wrapper's own torch ops included), the event ms (what a caller waits,
    the host cost included), and the largest error against its plain
    version (the sampler's relative to the largest plain value)."""
    from molvax_torch.kernels import conv_enc, sampler
    from molvax_torch.nn.encoder import encoder_params
    from molvax_torch.train.profiling import event_ms

    model, cfg, _ = make_decoder(device, seed)
    g = torch.Generator(device=device).manual_seed(seed + 2)
    codes = torch.randint(0, cfg.charset_size, (B, cfg.max_len), generator=g, device=device)
    params = encoder_params(model)
    out = {}
    with torch.no_grad():
        mu, lv = conv_enc.fused_encode_ref(model, cfg, codes)

        def enc():
            return conv_enc._encode_kernel(cfg, codes, params)

        seed = _sampler_seed(sampler, 7, device)

        def smp():
            return sampler._sample_kernel(seed, mu, lv, 1.0)

        got = enc()
        out["fused_encode_max_abs_err"] = max(float((a - b).abs().max()) for a, b in zip(got, (mu, lv)))
        z, kl = smp()
        z_r, kl_r = sampler.fused_sample_kl_ref(seed, mu, lv, 1.0)
        out["fused_sample_kl_rel_err"] = max(float((a - b).abs().max() / b.abs().max()) for a, b in ((z, z_r), (kl, kl_r)))
        for name, fn in (("fused_encode", enc), ("fused_sample_kl", smp)):
            out[f"{name}_device_us"] = queued_ms(lambda: [fn() for _ in range(20)]) / 20 * 1e3
            out[f"{name}_event_ms"] = event_ms(fn)
    return out


def train_times(device: str = "cuda:0", seed: int = 0) -> dict:
    """One train step of ``zinc250k``, ``zinc250k_quality`` and strict-fp32
    ``zinc250k`` at B=256, with the package on sys.path: torch's seeded
    default init, seeded codes; the step's event ms (median of 5 after 2
    warm-ups: the host's enqueueing included, as a caller waits) and one
    step's device-busy ms (every kernel and copy the profiler records; 0
    where it records none), and the idle share they give."""
    import dataclasses

    from molvax_torch.config import get_preset
    from molvax_torch.train import init_state, make_train_step
    from molvax_torch.train.profiling import event_ms

    out = {}
    zinc = get_preset("zinc250k")
    fp32 = dataclasses.replace(zinc, name="zinc250k_fp32", model=dataclasses.replace(zinc.model, compute_dtype="float32"))
    for full in (zinc, get_preset("zinc250k_quality"), fp32):
        g = torch.Generator(device=device).manual_seed(seed + 3)
        codes = torch.randint(0, full.model.charset_size, (B, full.model.max_len), generator=g, device=device)
        step = make_train_step(full)
        state = [init_state(full, seed=seed, device=device)]

        def one():
            state[0], _ = step(state[0], codes, None)

        with torch.enable_grad():  # the caller may time kernels under no_grad
            ms = event_ms(one)
            busy = device_ms(one, "")[0]
        out[f"{full.name}_step_ms"] = ms
        out[f"{full.name}_step_device_busy_ms"] = busy
        out[f"{full.name}_step_idle_share"] = 1.0 - busy / ms if busy else None
    return out


def kernel_times(inp: dict, own: bool) -> dict:
    """The GRU kernels' times, ms, with the package on sys.path; ``own``
    adds the redesigned stack's pieces and the host's enqueue times."""
    from molvax_torch.kernels import floor as kfloor
    from molvax_torch.kernels import generate as kg
    from molvax_torch.kernels import gru as kgru
    from molvax_torch.kernels import gru_stack as ks
    from molvax_torch.train.profiling import event_ms

    args, dY, dhf = inp["args"], inp["dY"], inp["dhf"]
    x0, wih0, bih0, wih, bih, whh, bhh, h0 = args
    bf = torch.bfloat16
    out = {}
    with torch.no_grad():
        res = (*ks.stack_forward(*args), x0, h0, wih0, wih, whh)
        out["stack_fwd"] = event_ms(lambda: ks.stack_forward(*args))
        out["stack_bwd"] = event_ms(lambda: ks.stack_backward(res, dY, dhf))
        layer = (x0, wih0, bih0, whh[0], bhh[0], h0[0])
        for md, name in ((bf, "bf16"), (torch.float32, "fp32")):
            lres = (*kgru.layer_forward(*layer, md), x0, h0[0], wih0, whh[0])
            out[f"layer_x_fwd_{name}"] = event_ms(lambda: kgru.layer_forward(*layer, md))
            out[f"layer_x_bwd_{name}"] = event_ms(lambda: kgru.layer_backward(lres, dY))
        gi = x0 @ wih0.T + bih0
        sres = (*kgru.scan_forward(gi, whh[0], bhh[0], h0[0]), h0[0], whh[0])
        out["scan_fwd"] = event_ms(lambda: kgru.scan_forward(gi, whh[0], bhh[0], h0[0]))
        out["scan_bwd"] = event_ms(lambda: kgru.scan_backward(sres, dY))
        out["matmul_only"] = event_ms(lambda: kgru.gru_probe_scan(gi, whh[0], bhh[0], h0[0], "matmul_only"))
        # a parent checkout from before the wavefront has the wrapper in gru_stack
        fused3 = getattr(kgru, "gru_fused3_scan", None) or ks.gru_fused3_scan
        out["fused3"] = event_ms(lambda: fused3(gi.to(bf), wih, bih, whh, bhh, h0))
        fx = torch.ones(256, 32, dtype=torch.int32, device="cuda:0")
        out["floor_loop"] = event_ms(lambda: kfloor.floor_loop(fx, T, 64, 4), reps=9)
        out["floor_loop_device"] = queued_ms(lambda: kfloor.floor_loop(fx, T, 64, 4))
        model, cfg, z_emb = make_decoder()
        out["fused_generate_greedy"] = event_ms(lambda: kg.fused_generate(model, cfg, z_emb, 0))
        out.update(automaton_times())
        out.update(encode_times())
        out.update(train_times())
        if own:
            top = res[0][L - 1], h0[L - 1], res[1][L - 1], res[2][L - 1], whh[L - 1], dY, dhf[L - 1]
            out["recurrence_layer"] = event_ms(lambda: ks.layer_recurrence(gi, whh[0], bhh[0], h0[0]))
            out["sweep_layer"] = event_ms(lambda: ks.layer_sweep(*top))
            out["gemm_gi_layer0"] = event_ms(lambda: ks.gemm("gi", x0, wih0, bih0))
            for name, fn in (("fwd", lambda: ks.stack_forward(*args)), ("bwd", lambda: ks.stack_backward(res, dY, dhf))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(10):
                    fn()
                out[f"host_enqueue_{name}"] = (time.perf_counter() - t0) * 1e2  # ms per call
                torch.cuda.synchronize()
    return out


# (I, H, dtype, B) of the per-layer kernels' times (``layer_times``): fwd_gi's
# width, strict fp32 at zinc250k's layer 0, and the widths no layout of the
# persistent route takes
LAYER_WIDTHS = [(330, 501, torch.bfloat16, B), (329, 501, torch.float32, B), (329, 2304, torch.bfloat16, B),
                (329, 1536, torch.float32, B)]


def _layer_inputs(I: int, H: int, Bx: int, seed: int = 0):
    g = torch.Generator(device="cuda:0").manual_seed(seed)
    k = 1.0 / H ** 0.5

    def u(*shape):
        return (2.0 * torch.rand(*shape, generator=g, device="cuda:0") - 1.0) * k

    args = (torch.randn(T, Bx, I, generator=g, device="cuda:0"), u(3 * H, I), u(3 * H), u(3 * H, H), u(3 * H),
            0.1 * torch.randn(Bx, H, generator=g, device="cuda:0"))
    return args, 1e-2 * torch.randn(T, Bx, H, generator=g, device="cuda:0")


def layer_times() -> dict:
    """The per-layer kernels' times, ms, with the package on sys.path: the
    in-kernel instance (``layer_forward_in_kernel``, ``layer_backward_in_kernel``)
    at each of LAYER_WIDTHS, T=120, and cuDNN's one-layer GRU of the same
    sizes and dtype (forward); ``gru_layer_scan`` forward and backward and
    ``gru_probe_scan``'s two modes at zinc250k width."""
    from molvax_torch.kernels import gru as kgru
    from molvax_torch.train.profiling import event_ms

    out = {}
    with torch.no_grad():
        for I, H_, md, Bx in LAYER_WIDTHS:
            args, dY = _layer_inputs(I, H_, Bx)
            tag = f"{str(md).split('.')[-1]}_I{I}_H{H_}"
            res = (*kgru.layer_forward_in_kernel(*args, md), args[0], args[5], args[1], args[3])
            out[f"in_kernel_fwd_{tag}"] = event_ms(lambda: kgru.layer_forward_in_kernel(*args, md))
            out[f"in_kernel_bwd_{tag}"] = event_ms(lambda: kgru.layer_backward_in_kernel(res, dY))
            gru = torch.nn.GRU(I, H_, 1, device="cuda:0", dtype=md)
            x = args[0].to(md)
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                out[f"cudnn_fwd_{tag}"] = event_ms(lambda: gru(x))
        args, dY = _layer_inputs(I0, H, B)
        x0, w_ih, b_ih, w_hh, b_hh, h0 = args
        gi = x0 @ w_ih.T + b_ih
        sres = (*kgru.scan_forward(gi, w_hh, b_hh, h0), h0, w_hh)
        out["scan_fwd"] = event_ms(lambda: kgru.scan_forward(gi, w_hh, b_hh, h0))
        out["scan_bwd"] = event_ms(lambda: kgru.scan_backward(sres, dY))
        for mode in ("matmul_only", "gates_nostore"):
            out[mode] = event_ms(lambda: kgru.gru_probe_scan(gi, w_hh, b_hh, h0, mode))
    return out


# (variant, [(text in csrc/gru_layer.cu, its replacement)]): the in-kernel
# forward's step with parts taken out (results wrong, times only)
_L_NOBARRIER = [("      group_arrive(a.flags + grp);\n", "      __syncthreads();\n"),
                ("      group_wait(a.flags + grp, a.q * (t + 1));\n", "      __syncthreads();\n")]
_L_NOINPUT = [("      product(ga, gc, a.x + (size_t)t * a.B * a.ldx,", "      if (t < 0) product(ga, gc, a.x + (size_t)t * a.B * a.ldx,")]
_L_NOHIDDEN = [("    product(acc, corr, t == 0 ? a.h0b", "    if (t < 0) product(acc, corr, t == 0 ? a.h0b")]
LAYER_VARIANTS = {"base": [], "nobarrier": _L_NOBARRIER, "noinput": _L_NOINPUT, "nohidden": _L_NOHIDDEN,
                  "noproducts": _L_NOINPUT + _L_NOHIDDEN, "empty": _L_NOBARRIER + _L_NOINPUT + _L_NOHIDDEN}


def layer_step_times(root: Path) -> list:
    """The in-kernel forward at each of LAYER_WIDTHS, T=120, rebuilt from
    csrc/gru_layer.cu in each variant of LAYER_VARIANTS (the barrier, the
    input product x[t+1] @ W_ih, the hidden product h @ W_hh, or all taken
    out), each build from a copy of csrc/ under build/stack_probe/: ms a
    forward and µs a step."""
    from molvax_torch.kernels import gru as kgru
    from molvax_torch.train.profiling import event_ms

    src = Path(kgru.__file__).resolve().parent / "csrc"
    rows = []
    for name in LAYER_VARIANTS:
        d = root / "build" / "stack_probe" / f"layer_{name}" / "csrc"
        shutil.rmtree(d.parent, ignore_errors=True)
        shutil.copytree(src, d)
        (d / "gru_layer.cu").write_text(variant_source((src / "gru_layer.cu").read_text(), name, LAYER_VARIANTS))
        build_variant(d)
        row = {"variant": name}
        with torch.no_grad():
            for I, H_, md, Bx in LAYER_WIDTHS:
                args, _ = _layer_inputs(I, H_, Bx)
                ms = event_ms(lambda: kgru.layer_forward_in_kernel(*args, md))
                slices = kgru.layer_plan(Bx, I, H_, *kgru.gru_stack.plan_limits(args[0].device),
                                         esize=md.itemsize).slices
                tag = f"{str(md).split('.')[-1]}_I{I}_H{H_}"
                row.update({f"fwd_{tag}_ms": ms, f"fwd_{tag}_us_per_step": ms * 1e3 / T / slices})
        rows.append(row)
    return rows


# (variant, [(text in csrc/gru_layer.cu, its replacement)]): the fused3
# wavefront's step with a part moved or taken out. skew1 computes the upper
# layers' x[t] @ W_ih at the start of step t, after the wait on the layer
# below, not in the shadow of step t-1's barrier (results right); the others
# take out the input product, the hidden product, both, the wait of a
# team's own barrier or the wait on the layer below (results wrong, times
# only; every arrive stays, so no wait is left without its count); unroll1
# and unroll4 unroll the forward's bf16 product loop (k16 steps) 1 or 4
# times, where the kept kernel unrolls it twice. The forward kernels share
# the step, so a variant changes them too.
FUSED3_VARIANTS = {
    "base": [],
    "skew1": [("  input_gates(0);\n\n  for (int t = 0; t < a.T; ++t) {\n",
               "  for (int t = 0; t < a.T; ++t) {\n    input_gates(t);\n"),
              ("      input_gates(t + 1);  // needs no other block's h: runs in the barrier's shadow\n", "")],
    "noinput": _L_NOINPUT,
    "nohidden": _L_NOHIDDEN,
    "noproducts": _L_NOINPUT + _L_NOHIDDEN,
    "nowait": [("      group_wait(a.flags + grp, a.q * (t + 1));\n", "      __syncthreads();\n")],
    "nowave": [("      if constexpr (WAVE) group_wait(below + grp, qb * (t + 1));\n", "")],
    **{f"unroll{n}": [("#pragma unroll 2\n        for (int kk = 0; kk < klen; kk += 16) {",
                       f"#pragma unroll {n}\n        for (int kk = 0; kk < klen; kk += 16) {{")] for n in (1, 4)},
}


def fused3_step_times(root: Path) -> list:
    """``gru_fused3_scan`` at B=256, T=120, L=3, H=501 and 512
    (``gru_experiments.make_inputs``), rebuilt from csrc/gru_layer.cu in each
    variant of FUSED3_VARIANTS under build/stack_probe/: ms a forward, µs a
    tick (T + 2 (L-1) ticks), and (base, skew1) the largest difference from
    the plain version; and, in the base build, one team alone: the
    in-kernel forward of one upper layer (I = H) on the team's layout
    (``layer_plan`` on sms // L SMs), its µs a step."""
    from molvax_torch.kernels import gru as kgru
    from molvax_torch.kernels import gru_stack as ks
    from molvax_torch.probes import gru_experiments as ge
    from molvax_torch.train.profiling import event_ms

    src = Path(kgru.__file__).resolve().parent / "csrc"
    rows = []
    for name in FUSED3_VARIANTS:
        d = root / "build" / "stack_probe" / f"fused3_{name}" / "csrc"
        shutil.rmtree(d.parent, ignore_errors=True)
        shutil.copytree(src, d)
        (d / "gru_layer.cu").write_text(variant_source((src / "gru_layer.cu").read_text(), name, FUSED3_VARIANTS))
        build_variant(d)
        row = {"variant": name}
        with torch.no_grad():
            for h in (501, 512):
                g = ge.make_inputs(H=h, device="cuda:0")
                args = (g["gi"], *g["stack"], g["h0"])
                ms = event_ms(lambda: kgru.gru_fused3_scan(*args))
                row.update({f"H{h}_ms": ms, f"H{h}_us_per_tick": ms * 1e3 / (g["T"] + 2 * (g["L"] - 1))})
                if name in ("base", "skew1", "unroll1", "unroll4"):
                    err = (kgru.gru_fused3_scan(*args).float() - ks.gru_fused3_scan_ref(*args).float()).abs().max()
                    row[f"H{h}_max_abs_err"] = err.item()
                if name == "base":
                    sms, smem = ks.plan_limits(g["gi"].device)
                    plan = kgru.layer_plan(g["B"], h, h, sms // g["L"], smem)
                    layer = g["layers"][1]
                    x = kgru._padded(torch.randn(g["T"], g["B"], h, device="cuda:0"), torch.bfloat16)
                    one = (plan, torch.bfloat16, x, None, layer["w_ih"], layer["b_ih"], layer["w_hh"],
                           layer["b_hh"], g["h0"][1], 0, lambda: None)
                    ms = event_ms(lambda: kgru._forward("team alone", *one))
                    row.update({f"H{h}_team_alone_plan": [plan.g, plan.q, plan.units, plan.rows, plan.slices],
                                f"H{h}_team_alone_us_per_step": ms * 1e3 / g["T"] / plan.slices})
        rows.append(row)
    return rows


def step_times(inp: dict, root: Path) -> list:
    """One layer's recurrence and sweep, bf16 and strict fp32, in every
    variant of VARIANTS; then the strict-fp32 pieces in the other product
    forms of FORMS. Each build from a copy of csrc/ under
    build/stack_probe/. Each form's row also holds its fp32 GEMMs' errors,
    max abs over the largest magnitude of a float64 product."""
    from molvax_torch.kernels import gru_stack as ks
    from molvax_torch.train.profiling import event_ms

    x0, wih0, bih0, _, _, whh, bhh, h0 = inp["args"]
    f32 = torch.float32
    with torch.no_grad():
        gi = x0 @ wih0.T + bih0
        res = {md: ks.layer_recurrence_ref(gi, whh[0], bhh[0], h0[0], md) for md in (torch.bfloat16, f32)}
        dgi, dgh, _ = ks.layer_sweep_ref(*res[f32][:1], h0[0], *res[f32][1:], whh[0], inp["dY"], h0[0], f32)
        f64 = torch.float64
        hprev = torch.cat([h0[0][None], res[f32][0][:-1]]).to(f64)
        exact = {"gi": x0.to(f64) @ wih0.to(f64).T + bih0.to(f64), "dx": dgi.to(f64) @ wih0.to(f64),
                 "dw": torch.einsum("tbm,tbn->mn", dgh.to(f64), hprev), "db": dgh.to(f64).sum((0, 1))}
    src = Path(ks.__file__).resolve().parent / "csrc"
    rows = []
    for name, form in [(v, KEPT) for v in VARIANTS] + [("base", f) for f in FORMS if f != KEPT]:
        d = root / "build" / "stack_probe" / f"{name}_{form}" / "csrc"
        shutil.rmtree(d.parent, ignore_errors=True)
        shutil.copytree(src, d)
        (d / "gru_stack.cu").write_text(variant_source((src / "gru_stack.cu").read_text(), name))
        (d / "gemm.cuh").write_text(variant_source((src / "gemm.cuh").read_text(), form, FORMS))
        build_variant(d)
        row = {"variant": name, "fp32_form": form}
        with torch.no_grad():
            for md, tag in ((torch.bfloat16, ""), (f32, "_fp32")):
                hseq, rzn, ghn = res[md]
                rec = event_ms(lambda: ks.layer_recurrence(gi, whh[0], bhh[0], h0[0], md=md))
                sweep = event_ms(lambda: ks.layer_sweep(hseq, h0[0], rzn, ghn, whh[0], inp["dY"], h0[0], md=md))
                row.update({f"recurrence{tag}_ms": rec, f"recurrence{tag}_us_per_step": rec * 1e3 / T,
                            f"sweep{tag}_ms": sweep, f"sweep{tag}_us_per_step": sweep * 1e3 / T})
            if name == "base":  # the strict-fp32 GEMMs of one layer, the dW one job
                row["gemm_gi_fp32_ms"] = event_ms(lambda: ks.gemm("gi", x0, wih0, bih0, md=f32))
                row["gemm_dx_fp32_ms"] = event_ms(lambda: ks.gemm("dx", dgi, wih0, md=f32))
                row["gemm_dw_hh_fp32_ms"] = event_ms(lambda: ks.gemm("dw", dgh, res[f32][0][:-1], first=h0[0], md=f32))
                got = {"gi": ks.gemm("gi", x0, wih0, bih0, md=f32), "dx": ks.gemm("dx", dgi, wih0, md=f32)}
                got["dw"], got["db"] = ks.gemm("dw", dgh, res[f32][0][:-1], first=h0[0], md=f32)
                for k, v in exact.items():
                    row[f"gemm_{k}_fp32_rel_err"] = float((got[k] - v).abs().max() / v.abs().max())
        rows.append(row)
    return rows


def _sass(lib: Path) -> dict:
    """{kernel name: its SASS instructions}, addresses and encodings set aside."""
    nvcc = Path(shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc")
    text = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            funcs[name].append(" ".join(re.sub(r"^\s*/\*[0-9a-f]+\*/", "", line).split(";")[0].split()))
    return funcs


def sass_check(parent: Path) -> dict:
    """Every kernel of the library built from ``parent``'s csrc/ against
    this checkout's: kernels of the parent with no kernel of the same SASS
    here, by name."""
    from molvax_torch.kernels import _build

    _build.load()
    here = _build.library_path()
    code = "import sys; sys.path.insert(0, sys.argv[1]); from molvax_torch.kernels import _build; " \
           "_build.load(); print(_build.library_path())"
    there = Path(subprocess.run([sys.executable, "-c", code, str(parent)], capture_output=True, text=True,
                                check=True).stdout.split()[-1])
    old, new = _sass(there), _sass(here)
    bodies = {tuple(v) for v in new.values()}
    missing = sorted(k for k, v in old.items() if tuple(v) not in bodies)
    return {"parent_kernels": len(old), "kernels": len(new), "parent_kernels_with_same_sass": len(old) - len(missing),
            "parent_kernels_without": missing}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("stack_probe: CUDA is not available; this probe runs on a GPU", file=sys.stderr)
        return 2
    root = Path(argv[argv.index("--root") + 1]).resolve() if "--root" in argv else Path.cwd()
    sys.path.insert(0, str(root))
    from molvax_torch.train.profiling import card_line

    card = card_line()
    if "--sass" in argv:
        print(json.dumps({**sass_check(Path(argv[argv.index("--sass") + 1]).resolve()), "card": card}), flush=True)
        return 0
    inp = make_inputs()
    if "--encode-timeline" in argv:
        at = argv.index("--encode-timeline") + 1
        variant = argv[at] if at < len(argv) and not argv[at].startswith("--") else "base"
        print(json.dumps({"variant": variant, **encode_timeline(root, warm="--warm" in argv, variant=variant),
                          "card": card}), flush=True)
    elif "--encode-split" in argv:
        at = argv.index("--encode-split") + 1
        names = argv[at].split(",") if at < len(argv) and not argv[at].startswith("--") else None
        for row in encode_split(root, names):
            print(json.dumps({**row, "card": card}), flush=True)
    elif "--encode" in argv:
        print(json.dumps({"root": str(root), **encode_times(), "card": card}), flush=True)
    elif "--train" in argv:
        print(json.dumps({"root": str(root), **encode_times(), **train_times(), "card": card}), flush=True)
    elif "--decodes" in argv:
        print(json.dumps({"root": str(root), **automaton_times(), **decode_times(), "card": card}), flush=True)
    elif "--layers" in argv:
        print(json.dumps({"root": str(root), **layer_times(), "card": card}), flush=True)
    elif "--fused3-steps" in argv:
        for row in fused3_step_times(root):
            print(json.dumps({**row, "card": card}), flush=True)
    elif "--layer-steps" in argv:
        for row in layer_step_times(root):
            print(json.dumps({**row, "card": card}), flush=True)
    elif "--steps" in argv:
        for row in step_times(inp, root):
            print(json.dumps({**row, "card": card}), flush=True)
    else:
        print(json.dumps({"root": str(root), **kernel_times(inp, own="--root" not in argv), "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
