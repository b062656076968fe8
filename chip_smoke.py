#!/usr/bin/env python3
"""Drive molvax_torch's serving path and training step once on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the hand-written kernels from
``molvax_torch/kernels/csrc/`` (into ``build/molvax_torch/``), makes
``zinc250k`` weights at full width from a seed, and runs fifteen phases,
each printed on its own lines:

  1. environment: card name and power limit, torch and CUDA versions, the
     global TF32 switches (left at their defaults), kernel build time and
     ptxas report;
  2. weights: numpy-seeded JAX-layout params, loaded through io/convert.py;
  3. generation kernel against plain version, greedy, B=256, T=120: share
     of identical codes, and a margin check: replaying the kernel's codes
     through the plain version, every code the kernel chose scores within
     MARGIN of the plain maximum;
  4. the same check sampled at temperature 1.0 and 0.7, identical noise;
  5. the serving path through the public functions: sample_prior(256) and
     reconstruct of 256 SMILES (deterministic and stochastic), counting
     kernel launches and checking the strings and the encoder;
  6. decode times of the generation kernel and its plain version;
  7. GRU stack forward kernel against its plain version on the training
     inputs of the 256 SMILES: max abs error of out and h_final, and the
     share of bit-identical bf16 h;
  8. the stack's backward kernels (reverse sweep, dW contraction) against
     the plain backward from the same residuals and cotangents: relative
     error of each gradient;
  9. encoder kernel against the plain encoder, sampler kernel against its
     plain version;
 10. the training step through the public functions: init_state from the
     seeded weights, 20 steps of make_train_step on the kernel route
     (every kernel launched once per step, loss falls), the first 3 steps
     again on the plain route from the same weights, one make_eval_step;
 11. times: the train step on both routes, each new kernel against its
     plain version (CUDA events, median of 5 after 2 warm-ups), the
     device-time split of one kernel-route step (torch.profiler), and
     peak device memory;
 12. the per-layer GRU kernels against their plain versions on the same
     inputs, layer 0 (I=329) and layer 1 (I=501): gru_layer_scan_x forward
     and backward in bf16 and in strict fp32, gru_layer_scan forward and
     backward, also at a ragged batch of 6; then gru_layer_scan's own path,
     a 3-layer hoisted-gi decode through its autograd wrapper, counting
     launches;
 13. the zinc250k_quality training step (per-layer kernels, two-pass
     scheduled sampling) through the public functions: 20 steps on the
     kernel route with exact launch counts per step (per-layer forward 6,
     backward 3, encoder 1, sampler 1, stack 0), loss falls, 3 steps on the
     plain route, one make_eval_step;
 14. the strict-fp32 zinc250k step (compute_dtype='float32'): 20 steps on
     the per-layer kernels in fp32 mode (forward 3, backward 3, encoder and
     sampler 0), loss falls, 3 plain-route steps within 1e-4, with the TF32
     switches;
 15. times: both new train steps on both routes, each per-layer kernel
     against its plain version in bf16 and fp32, the device-time split of
     one step of each, and peak device memory.

Any failure raises and exits non-zero. Without CUDA it exits 2 and prints
no result. The last line of standard output is the device JSON.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from molvax_torch.config import get_preset
from molvax_torch.data.charset import DEFAULT_CHARSET
from molvax_torch.data.featurize import decode_codes, encode_smiles, one_hot
from molvax_torch.io.convert import state_dict_from_jax
from molvax_torch.kernels import _build, conv_enc, gru_stack, sampler
from molvax_torch.kernels import gru as kgru
from molvax_torch.kernels import generate as kg
from molvax_torch.latent.sample import reconstruct, sample_prior
from molvax_torch.nn.decoder import latent_embed, teacher_inputs
from molvax_torch.nn.encoder import conv_input_channels, encoder_params, flat_conv_dim
from molvax_torch.nn.gru import gru_layers
from molvax_torch.nn.vae import MolecularVAE, encode
from molvax_torch.train import init_state, make_eval_step, make_train_step

MARGIN = 1e-2  # score units; bf16 operand rounding of a near-tie h can move a logit by ~1e-4
# the stack's gates, which also hold the bf16 per-layer kernels
STACK_FWD_TOL = 3.91e-3  # the reference's on-chip gate for the stack kernel (ROADMAP B)
STACK_BWD_REL = 1e-2  # ||kernel - plain|| / ||plain|| per gradient
ENCODER_TOL = 1e-3  # same bf16 operands and stages, fp32 sums in another order
SAMPLER_REL = 1e-5  # same bits; fp32 transcendentals of the card vs torch's
ROUTE_REL = 1e-2  # per-step loss, kernel route against plain route
FP32_FWD_TOL = 1e-4  # strict fp32: only the sum order differs; a bf16 or TF32
FP32_BWD_REL = 1e-3  # cast would show as ~1e-2
FP32_ROUTE_REL = 1e-4  # per-step loss of the strict-fp32 routes
B = 256
SEED = 0
DEVICE = "cuda:0"
TRAIN_STEPS = 20
PLAIN_STEPS = 3

_HEADS = ["CCO", "CC(C)N", "c1ccccc1", "CC(=O)O", "C1CCNCC1", "COc1ccccc1", "CN(C)C=O",
          "Clc1ccccc1", "CC#N", "OC(=O)c1ccccc1", "CCS", "c1ccncc1", "CC(C)(C)O", "FC(F)F",
          "C1CCOC1", "NC(=O)N"]
_TAILS = ["C", "CC", "CCC(=O)O", "c1ccc(F)cc1", "N1CCCC1", "OC", "C(=O)N", "S(=O)(=O)N",
          "c1ccoc1", "Br", "C#N", "[C@@H](C)O", "CCN(CC)CC", "c1cc[nH]c1", "OCCO", "C1CC1"]
SMILES = [h + t for h in _HEADS for t in _TAILS]  # 256 distinct strings


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def random_params(cfg, seed: int) -> dict:
    """JAX-layout param tree of numpy arrays, uniform +-1/sqrt(fan_in) as in
    the reference's init_*_params, with a non-zero random start token."""
    rng = np.random.default_rng(seed)

    def u(shape, fan_in):
        k = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-k, k, shape).astype(np.float32)

    def lin(i, o):
        return {"w": u((i, o), i), "b": u((o,), i)}

    convs, in_ch = [], conv_input_channels(cfg)
    for out_ch, k in zip(cfg.conv_channels, cfg.conv_kernels):
        convs.append({"w": u((out_ch, in_ch, k), in_ch * k), "b": u((out_ch,), in_ch * k)})
        in_ch = out_ch
    H, C, Lz = cfg.gru_hidden, cfg.charset_size, cfg.latent_dim
    gru = []
    for li in range(cfg.gru_layers):
        in_size = Lz + C if li == 0 else H
        gru.append({"w_ih": u((in_size, 3 * H), H), "w_hh": u((H, 3 * H), H),
                    "b_ih": u((3 * H,), H), "b_hh": u((3 * H,), H)})
    dec = {"linear_3": lin(Lz, Lz), "gru": gru, "linear_out": lin(H, C)}
    if cfg.learned_start:
        dec["start_token"] = rng.standard_normal(C).astype(np.float32)
    return {
        "encoder": {"convs": convs, "linear_0": lin(flat_conv_dim(cfg), cfg.enc_hidden),
                    "linear_mu": lin(cfg.enc_hidden, Lz), "linear_logvar": lin(cfg.enc_hidden, Lz)},
        "decoder": dec,
    }


def check_kernel(model, z_emb, greedy: bool, temperature: float, seed: int) -> float:
    """Kernel against plain version on the same inputs and noise. Returns
    the largest gap between the plain maximum score and the score of the
    kernel's code; raises if it exceeds MARGIN."""
    codes_k = kg.fused_generate(model, model.cfg, z_emb, seed, greedy=greedy, temperature=temperature)
    codes_r = kg.fused_generate_ref(model, model.cfg, z_emb, seed, greedy=greedy, temperature=temperature)
    torch.cuda.synchronize()
    C = model.cfg.charset_size
    if codes_k.shape != codes_r.shape or codes_k.min() < 0 or codes_k.max() >= C:
        raise AssertionError(f"kernel codes out of range or misshapen: {tuple(codes_k.shape)}")
    same = (codes_k == codes_r).float().mean().item()
    _, scores = kg.fused_generate_ref(
        model, model.cfg, z_emb, seed, greedy=greedy, temperature=temperature,
        force_codes=codes_k, return_scores=True,
    )
    if not torch.isfinite(scores).all():
        raise AssertionError("non-finite plain scores")
    chosen = scores.gather(-1, codes_k.long()[..., None])[..., 0]
    gap = (scores.max(-1).values - chosen).max().item()
    mode = "greedy" if greedy else f"sampled_T{temperature}"
    say("phase3" if greedy else "phase4", mode=mode, B=z_emb.shape[0], T=codes_k.shape[1],
        identical_codes=f"{same:.6f}", max_margin_gap=f"{gap:.3e}", margin=MARGIN)
    if gap > MARGIN:
        raise AssertionError(f"{mode}: kernel chose a code {gap:.3e} below the plain maximum")
    return gap


def time_ms(fn, warmup: int = 2, reps: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def reset_counts() -> None:
    kg.launches = conv_enc.launches = sampler.launches = 0
    gru_stack.fwd_launches = gru_stack.bwd_launches = gru_stack.dw_launches = 0
    kgru.layer_fwd_launches = kgru.layer_bwd_launches = kgru.layer_dw_launches = 0
    kgru.scan_fwd_launches = kgru.scan_bwd_launches = 0


def counts() -> dict:
    return {
        "fused_generate": kg.launches,
        "fused_encode": conv_enc.launches,
        "fused_sample_kl": sampler.launches,
        "gru_stack_fwd": gru_stack.fwd_launches,
        "gru_stack_bwd_sweep": gru_stack.bwd_launches,
        "gru_stack_bwd_dw": gru_stack.dw_launches,
        "gru_layer_scan_x_fwd": kgru.layer_fwd_launches,
        "gru_layer_scan_x_bwd_sweep": kgru.layer_bwd_launches,
        "gru_layer_bwd_dw": kgru.layer_dw_launches,
        "gru_layer_scan_fwd": kgru.scan_fwd_launches,
        "gru_layer_scan_bwd_sweep": kgru.scan_bwd_launches,
    }


@contextlib.contextmanager
def plain_route():
    """The kernels' plain versions in place of the wrappers that the
    training forward and the GRU router call, for comparison and timing."""
    saved = (conv_enc.fused_encode, sampler.fused_sample_kl, gru_stack.gru_stack_scan,
             kgru.gru_layer_scan_x, kgru.gru_layer_scan)
    conv_enc.fused_encode = conv_enc.fused_encode_ref
    sampler.fused_sample_kl = sampler.fused_sample_kl_ref
    gru_stack.gru_stack_scan = gru_stack.gru_stack_scan_ref
    kgru.gru_layer_scan_x = kgru.gru_layer_scan_x_ref
    kgru.gru_layer_scan = kgru.gru_layer_scan_ref
    try:
        yield
    finally:
        (conv_enc.fused_encode, sampler.fused_sample_kl, gru_stack.gru_stack_scan,
         kgru.gru_layer_scan_x, kgru.gru_layer_scan) = saved


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def stack_inputs(model, cfg, codes):
    """The stack's arguments on the training path: x0 (T, B, 329) from the
    encoder's mu and the teacher inputs, zero h0, torch-layout weights."""
    with torch.no_grad():
        mu, _ = encode(model, cfg, codes)
        x_seq = teacher_inputs(cfg, latent_embed(model, cfg, mu), one_hot(codes, cfg.charset_size),
                               model.start_token)
        wih0, bih0, wih, bih, whh, bhh = gru_stack._stacked(gru_layers(model.gru))
        h0 = torch.zeros(cfg.gru_layers, codes.shape[0], cfg.gru_hidden, device=codes.device)
    return (x_seq.transpose(0, 1).contiguous(), wih0, bih0, wih, bih, whh, bhh, h0)


def ragged_batch_checks(model, cfg, codes, s_args, rows: int = 6) -> None:
    """Every training kernel against its plain version at a batch that is
    not a multiple of the recurrent kernels' rows per block (4)."""
    x0, wih0, bih0, wih, bih, whh, bhh, h0 = s_args
    args = (x0[:, :rows].contiguous(), wih0, bih0, wih, bih, whh, bhh, h0[:, :rows].contiguous())
    g = torch.Generator(device=x0.device).manual_seed(SEED + 3)
    dY = torch.randn(x0.shape[0], rows, cfg.gru_hidden, device=x0.device, generator=g)
    dhf = torch.randn(cfg.gru_layers, rows, cfg.gru_hidden, device=x0.device, generator=g)
    with torch.no_grad():
        res_k = gru_stack.stack_forward(*args)
        fwd = max_abs(res_k[0], gru_stack.stack_forward_ref(*args)[0])
        res = (*res_k, args[0], args[7], wih0, wih, whh)
        bwd = max(rel_err(a, b) for a, b in zip(gru_stack.stack_backward(res, dY, dhf),
                                                 gru_stack.stack_backward_ref(res, dY, dhf)))
        enc = max(max_abs(a, b) for a, b in zip(conv_enc._encode_kernel(cfg, codes[:rows], encoder_params(model)),
                                                 conv_enc.fused_encode_ref(model, cfg, codes[:rows])))
        mu, lv = conv_enc.fused_encode_ref(model, cfg, codes[:rows])
        smp = max(max_abs(a, b) / b.abs().max().item()
                  for a, b in zip(sampler._sample_kernel(7, mu, lv, 1.0), sampler.fused_sample_kl_ref(7, mu, lv, 1.0)))
    torch.cuda.synchronize()
    say("phase9", ragged_batch=rows, stack_fwd_max_abs_err=f"{fwd:.3e}", stack_bwd_max_rel_err=f"{bwd:.3e}",
        encoder_max_abs_err=f"{enc:.3e}", sampler_rel_err=f"{smp:.3e}")
    if not (fwd <= STACK_FWD_TOL and bwd <= STACK_BWD_REL and enc <= ENCODER_TOL and smp <= SAMPLER_REL):
        raise AssertionError(f"a training kernel differs from its plain version at B={rows}")


def profile_step(step_fn) -> dict:
    """Device time by kernel over one train step, with torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step_fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # host ops report their kernels' time too
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + dev_us / 1e3
    return {"wall_ms": wall_ms, "device_ms": by_name}


GRAD_NAMES = ["dx", "dw_ih", "db_ih", "dw_hh", "db_hh", "dh0"]
SCAN_GRAD_NAMES = ["dgi", "dw_hh", "db_hh", "dh0"]


def layer_args(s_args, l: int, x):
    """gru_layer_scan_x's arguments for layer l of the stack's weights:
    (x, w_ih, b_ih, w_hh, b_hh, h0), torch layout."""
    _, wih0, bih0, wih, bih, whh, bhh, h0 = s_args
    w_ih, b_ih = (wih0, bih0) if l == 0 else (wih[l - 1], bih[l - 1])
    return (x, w_ih, b_ih, whh[l], bhh[l], h0[l])


def _gates(md):
    return (STACK_FWD_TOL, STACK_BWD_REL) if md == torch.bfloat16 else (FP32_FWD_TOL, FP32_BWD_REL)


def _check_grads(what, names, grads_k, grads_r, rel_tol, **kv):
    """Relative error of each gradient; raises over rel_tol. Returns the
    largest max abs error."""
    rels, worst = {}, 0.0
    for name, a, b in zip(names, grads_k, grads_r):
        if not (torch.isfinite(a).all() and a.shape == b.shape):
            raise AssertionError(f"{what} {name}: non-finite or misshapen")
        rels[name] = f"{rel_err(a, b):.3e}"
        worst = max(worst, max_abs(a, b))
    say("phase12", kernel=what, rel_err=json.dumps(rels).replace(" ", ""), max_abs_err=f"{worst:.3e}",
        rel_tol=rel_tol, **kv)
    bad = {name: r for name, r in rels.items() if not float(r) <= rel_tol}
    if bad:
        raise AssertionError(f"{what}: relative errors {bad} > {rel_tol} ({kv})")
    return worst


def check_layer_x(args, md, dY, **kv):
    """gru_layer_scan_x's forward and backward kernels against their plain
    versions on the same inputs. Returns (forward max abs error, gradient
    max abs error, the kernel's residuals)."""
    fwd_tol, bwd_rel = _gates(md)
    with torch.no_grad():
        res_k = kgru.layer_forward(*args, md)
        res_r = kgru.layer_forward_ref(*args, md)
    torch.cuda.synchronize()
    if any(r.dtype != md for r in res_k):
        raise AssertionError(f"gru_layer_scan_x stored {[r.dtype for r in res_k]}, expected {md}")
    out_err = max_abs(res_k[0], res_r[0])
    hf_err = max_abs(res_k[0][-1], res_r[0][-1])
    same = (res_k[0] == res_r[0]).float().mean().item()
    kv = dict(md=str(md).split(".")[-1], B=args[0].shape[1], I=args[0].shape[2], **kv)
    say("phase12", kernel="gru_layer_scan_x_fwd", out_max_abs_err=f"{out_err:.3e}",
        h_final_max_abs_err=f"{hf_err:.3e}", hseq_bit_identical=f"{same:.6f}", tol=fwd_tol, **kv)
    if not max(out_err, hf_err) <= fwd_tol:
        raise AssertionError(f"gru_layer_scan_x forward differs from its plain version by {out_err:.3e} ({kv})")
    x, w_ih, _, w_hh, _, h0 = args
    res = (*res_k, x, h0, w_ih, w_hh)
    with torch.no_grad():
        grads_k = kgru.layer_backward(res, dY)
        grads_r = kgru.layer_backward_ref(res, dY)
    torch.cuda.synchronize()
    bwd_err = _check_grads("gru_layer_scan_x_bwd", GRAD_NAMES, grads_k, grads_r, bwd_rel, **kv)
    return max(out_err, hf_err), bwd_err, res_k


def check_scan(gi, w_hh, b_hh, h0, dY, **kv):
    """gru_layer_scan's forward and backward kernels against their plain
    versions (bf16 gates). Returns (forward error, gradient error)."""
    with torch.no_grad():
        res_k = kgru.scan_forward(gi, w_hh, b_hh, h0)
        res_r = kgru.scan_forward_ref(gi, w_hh, b_hh, h0)
    torch.cuda.synchronize()
    fwd = max(max_abs(res_k[0], res_r[0]), max_abs(res_k[0][-1], res_r[0][-1]))
    kv = dict(B=gi.shape[1], **kv)
    say("phase12", kernel="gru_layer_scan_fwd", out_max_abs_err=f"{fwd:.3e}", tol=STACK_FWD_TOL, **kv)
    if not fwd <= STACK_FWD_TOL:
        raise AssertionError(f"gru_layer_scan forward differs from its plain version by {fwd:.3e}")
    res = (*res_k, h0, w_hh)
    with torch.no_grad():
        grads_k = kgru.scan_backward(res, dY)
        grads_r = kgru.scan_backward_ref(res, dY)
    torch.cuda.synchronize()
    return fwd, _check_grads("gru_layer_scan_bwd", SCAN_GRAD_NAMES, grads_k, grads_r, STACK_BWD_REL, **kv)


def hoisted_decode(s_args) -> float:
    """gru_layer_scan's own path: the 3-layer decode with each layer's input
    GEMM hoisted out of the recurrence (torch.matmul, as the reference left
    it to XLA) and the recurrence through the autograd wrapper, forward and
    backward. Returns the loss; raises on a non-finite gradient."""
    x0, *weights, h0 = s_args
    wih0, bih0, wih, bih, whh, bhh = (w.detach().clone().requires_grad_(True) for w in weights)
    inp = x0
    for l in range(h0.shape[0]):
        w_ih, b_ih = (wih0, bih0) if l == 0 else (wih[l - 1], bih[l - 1])
        inp = kgru.gru_layer_scan(inp @ w_ih.T + b_ih, whh[l], bhh[l], h0[l])
    loss = torch.sin(inp).mean()
    loss.backward()
    for w in (wih0, bih0, wih, bih, whh, bhh):
        if not (torch.isfinite(w.grad).all() and w.grad.abs().sum() > 0):
            raise AssertionError("hoisted decode: a gradient is zero or non-finite")
    return float(loss.detach())


def train_phase(phase, full, weights, codes, per_step, plain_tol):
    """TRAIN_STEPS steps of make_train_step on the kernel route, counting
    every kernel launch: each counter must be exactly per_step[name] times
    the steps (0 for a name not given). Then PLAIN_STEPS steps on the plain
    route from the same weights. Returns (state, step fn, launch counts)."""
    dev = codes.device
    step_fn = make_train_step(full)
    state = init_state(full, device=dev, weights=weights)
    reset_counts()
    losses = []
    for _ in range(TRAIN_STEPS):
        state, metrics = step_fn(state, codes, None)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    got = counts()
    say(phase, preset=full.name, compute_dtype=full.model.compute_dtype, gru_kernel=full.model.gru_kernel,
        steps=TRAIN_STEPS, **got)
    bad = {k: v for k, v in got.items() if v != per_step.get(k, 0) * TRAIN_STEPS}
    if bad:
        raise AssertionError(f"{phase}: launch counts {bad}, expected per step {per_step}")
    losses = [float(x) for x in losses]
    say(phase, route="kernel", loss=json.dumps([round(x, 4) for x in losses]))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: the loss did not fall: {losses[0]} -> {losses[-1]}")
    plain_state = init_state(full, device=dev, weights=weights)
    plain_losses = []
    with plain_route():
        for _ in range(PLAIN_STEPS):
            plain_state, metrics = step_fn(plain_state, codes, None)
            plain_losses.append(float(metrics["loss"]))
    route_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    say(phase, route="plain", loss=json.dumps([round(x, 6) for x in plain_losses]),
        kernel_loss=json.dumps([round(x, 6) for x in losses[:PLAIN_STEPS]]),
        max_rel_diff=f"{route_rel:.3e}", tol=plain_tol)
    if not route_rel <= plain_tol:
        raise AssertionError(f"{phase}: kernel and plain routes differ by {route_rel:.3e} in the loss")
    return state, step_fn, got


def timed_steps(full, weights, codes, step_fn):
    """(kernel-route ms, plain-route ms, peak GB, a kernel step fn) of one
    train step, on a throwaway state the timed steps update in place."""
    bench = init_state(full, device=codes.device, weights=weights)

    def kernel_step():
        nonlocal bench
        bench, _ = step_fn(bench, codes, None)

    def plain_step():
        nonlocal bench
        with plain_route():
            bench, _ = step_fn(bench, codes, None)

    ms, ms_plain = time_ms(kernel_step), time_ms(plain_step)
    torch.cuda.reset_peak_memory_stats()
    kernel_step()
    torch.cuda.synchronize()
    return ms, ms_plain, torch.cuda.max_memory_allocated() / 1e9, kernel_step


def say_profile(phase, prof, ms_step) -> None:
    dev_ms = prof["device_ms"]
    total = sum(dev_ms.values())
    say(phase, profiled_step_wall_ms=f"{prof['wall_ms']:.3f}", device_busy_ms=f"{total:.3f}",
        idle_share=f"{1 - total / ms_step:.4f}" if total else "not measured")
    for name, ms in sorted(dev_ms.items(), key=lambda kv: -kv[1])[:12]:
        say(phase, device_kernel=json.dumps(name[:80]), ms=f"{ms:.3f}", share=f"{ms / total:.4f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU", file=sys.stderr)
        return 2
    if "jax" in sys.modules or any(m == "molvax" or m.startswith("molvax.") for m in sys.modules):
        raise AssertionError("the port pulled in JAX or the JAX package")

    # -- 1. environment ------------------------------------------------------
    dev = torch.device(DEVICE)
    gpu = card()
    print(gpu, flush=True)
    say("phase1", torch=torch.__version__, cuda=torch.version.cuda,
        device=json.dumps(torch.cuda.get_device_name(0)),
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    t0 = time.perf_counter()
    _build.load()
    say("phase1", kernel_build_s=f"{time.perf_counter() - t0:.2f}",
        compiled=_build.info.compiled, nvcc_s=f"{_build.info.seconds:.2f}",
        library=os.path.relpath(_build.info.path))
    for line in _build.info.log.splitlines():
        if line.startswith("==") or ("ptxas info" in line and ("Used" in line or "spill" in line)):
            print("  " + line.strip(), flush=True)

    # -- 2. weights ----------------------------------------------------------
    full = get_preset("zinc250k")
    cfg = full.model
    weights = state_dict_from_jax(random_params(cfg, SEED))
    model = MolecularVAE(cfg, device=dev)
    model.load_state_dict(weights, strict=True)
    model.eval()
    say("phase2", preset="zinc250k", T=cfg.max_len, C=cfg.charset_size, latent=cfg.latent_dim,
        gru=f"{cfg.gru_layers}x{cfg.gru_hidden}", compute_dtype=cfg.compute_dtype,
        params=sum(p.numel() for p in model.parameters()))

    # -- 3, 4. generation kernel against plain version -----------------------
    rng = np.random.default_rng(SEED + 1)
    z = torch.from_numpy(rng.standard_normal((B, cfg.latent_dim)).astype(np.float32)).to(dev)
    with torch.no_grad():
        z_emb = latent_embed(model, cfg, z)
    gaps = [check_kernel(model, z_emb, True, 1.0, 0)]
    for temp, seed in ((1.0, 11), (0.7, 12)):
        gaps.append(check_kernel(model, z_emb, False, temp, seed))

    # -- 5. the serving path through the public functions --------------------
    gen = torch.Generator().manual_seed(SEED)
    reset_counts()
    prior = sample_prior(model, cfg, B, gen)
    recon = reconstruct(model, cfg, SMILES, gen, stochastic=False)
    recon_s = reconstruct(model, cfg, SMILES, gen, stochastic=True)
    torch.cuda.synchronize()
    serve_counts = counts()
    say("phase5", **serve_counts)
    if serve_counts["fused_generate"] != 3:
        raise AssertionError(f"expected 3 generation launches on the serving path, got {serve_counts}")
    for name, strings in (("sample_prior", prior), ("reconstruct", recon),
                          ("reconstruct_stochastic", recon_s)):
        if len(strings) != B or not all(
            isinstance(s, str) and len(s) <= cfg.max_len and all(c in DEFAULT_CHARSET for c in s)
            for s in strings
        ):
            raise AssertionError(f"{name}: strings did not decode")
        say("phase5", call=name, n=len(strings), distinct=len(set(strings)),
            examples=json.dumps(strings[:3]))
    # the encoder on the card against the same model on the CPU, and the
    # deterministic reconstruct against the plain version of the decode
    codes_cpu = torch.from_numpy(encode_smiles(SMILES, DEFAULT_CHARSET, cfg.max_len))
    codes = codes_cpu.to(dev)
    model_cpu = MolecularVAE(cfg)
    model_cpu.load_state_dict(model.state_dict())
    with torch.no_grad():
        mu, logvar = encode(model, cfg, codes)
        mu_cpu, logvar_cpu = encode(model_cpu, cfg, codes_cpu)
    if mu.shape != (B, cfg.latent_dim) or not (torch.isfinite(mu).all() and torch.isfinite(logvar).all()):
        raise AssertionError("encoder output misshapen or non-finite")
    enc_err = max(max_abs(mu.cpu(), mu_cpu), max_abs(logvar.cpu(), logvar_cpu))
    with torch.no_grad():
        ref_codes = kg.fused_generate_ref(model, cfg, latent_embed(model, cfg, mu), 0)
    ref_strings = decode_codes(ref_codes, DEFAULT_CHARSET)
    same_str = sum(a == b for a, b in zip(recon, ref_strings)) / B
    say("phase5", encoder_gpu_vs_cpu_max_abs_err=f"{enc_err:.3e}",
        reconstruct_identical_to_plain=f"{same_str:.4f}")
    if enc_err > ENCODER_TOL:
        raise AssertionError(f"encoder on the card differs from the CPU by {enc_err:.3e}")

    # -- 6. generation times -------------------------------------------------
    ms_gen = time_ms(lambda: kg.fused_generate(model, cfg, z_emb, 0))
    ms_gen_plain = time_ms(lambda: kg.fused_generate_ref(model, cfg, z_emb, 0))
    for name, ms in (("kernel_greedy", ms_gen), ("plain_greedy", ms_gen_plain)):
        say("phase6", path=name, B=B, T=cfg.max_len, ms=f"{ms:.4f}",
            smiles_per_s=f"{B / (ms / 1e3):.1f}", card=json.dumps(gpu))

    # -- 7. stack forward kernel against its plain version -------------------
    s_args = stack_inputs(model, cfg, codes)
    with torch.no_grad():
        res_k = gru_stack.stack_forward(*s_args)
        res_r = gru_stack.stack_forward_ref(*s_args)
    torch.cuda.synchronize()
    L = cfg.gru_layers
    out_err = max_abs(res_k[0][L - 1], res_r[0][L - 1])
    hf_err = max_abs(res_k[0][:, -1], res_r[0][:, -1])
    same_h = (res_k[0] == res_r[0]).float().mean().item()
    fwd_err = max(out_err, hf_err)
    say("phase7", B=B, T=cfg.max_len, I0=s_args[0].shape[2], H=cfg.gru_hidden, L=L,
        out_max_abs_err=f"{out_err:.3e}", h_final_max_abs_err=f"{hf_err:.3e}",
        hseq_bit_identical=f"{same_h:.6f}", tol=STACK_FWD_TOL)
    if not fwd_err <= STACK_FWD_TOL:
        raise AssertionError(f"stack forward differs from its plain version by {fwd_err:.3e}")

    # -- 8. stack backward kernels against the plain backward ----------------
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    dY = 1e-2 * torch.randn(cfg.max_len, B, cfg.gru_hidden, device=dev, generator=g)
    dhf = 1e-2 * torch.randn(L, B, cfg.gru_hidden, device=dev, generator=g)
    x0, wih0, _, wih, _, whh, _, h0 = s_args
    res = (*res_k, x0, h0, wih0, wih, whh)
    with torch.no_grad():
        grads_k = gru_stack.stack_backward(res, dY, dhf)
        grads_r = gru_stack.stack_backward_ref(res, dY, dhf)
    torch.cuda.synchronize()
    bwd_err = 0.0
    for name, a, b in zip(["dx0", "dwih0", "dbih0", "dwih", "dbih", "dwhh", "dbhh", "dh0"], grads_k, grads_r):
        r = rel_err(a, b)
        if not (torch.isfinite(a).all() and a.shape == b.shape):
            raise AssertionError(f"stack backward {name}: non-finite or misshapen")
        bwd_err = max(bwd_err, max_abs(a, b))
        say("phase8", grad=name, shape=tuple(a.shape), rel_err=f"{r:.3e}", max_abs_err=f"{max_abs(a, b):.3e}")
        if not r <= STACK_BWD_REL:
            raise AssertionError(f"stack backward {name}: relative error {r:.3e} > {STACK_BWD_REL}")

    # -- 9. encoder and sampler kernels against their plain versions ---------
    with torch.no_grad():
        mu_k, lv_k = conv_enc._encode_kernel(cfg, codes, encoder_params(model))
        mu_r, lv_r = conv_enc.fused_encode_ref(model, cfg, codes)
        seed9 = 12345
        z_k, kl_k = sampler._sample_kernel(seed9, mu_r, lv_r, cfg.eps_scale)
        z_r, kl_r = sampler.fused_sample_kl_ref(seed9, mu_r, lv_r, cfg.eps_scale)
    torch.cuda.synchronize()
    enc_kernel_err = max(max_abs(mu_k, mu_r), max_abs(lv_k, lv_r))
    z_rel = max_abs(z_k, z_r) / z_r.abs().max().item()
    kl_rel = max_abs(kl_k, kl_r) / kl_r.abs().max().item()
    z_same = (z_k == z_r).float().mean().item()
    say("phase9", encoder_max_abs_err=f"{enc_kernel_err:.3e}", tol=ENCODER_TOL,
        z_rel_err=f"{z_rel:.3e}", kl_rel_err=f"{kl_rel:.3e}", z_bit_identical=f"{z_same:.6f}",
        rel_tol=SAMPLER_REL)
    if not enc_kernel_err <= ENCODER_TOL:
        raise AssertionError(f"encoder kernel differs from the plain encoder by {enc_kernel_err:.3e}")
    if not (z_rel <= SAMPLER_REL and kl_rel <= SAMPLER_REL):
        raise AssertionError(f"sampler kernel differs: z {z_rel:.3e}, kl {kl_rel:.3e}")
    sampler_err = max(max_abs(z_k, z_r), max_abs(kl_k, kl_r))
    ragged_batch_checks(model, cfg, codes, s_args)

    # -- 10. the training step through the public functions ------------------
    state, train_step, train_counts = train_phase(
        "phase10", full, weights, codes,
        {"fused_encode": 1, "fused_sample_kl": 1, "gru_stack_fwd": 1, "gru_stack_bwd_sweep": 1,
         "gru_stack_bwd_dw": 1},
        ROUTE_REL)
    eval_metrics = make_eval_step(full)(state, codes, None)
    eval_m = {k: float(v) for k, v in eval_metrics.items()}
    say("phase10", eval=json.dumps({k: round(v, 4) for k, v in eval_m.items()}))
    if not all(np.isfinite(list(eval_m.values()))):
        raise AssertionError("eval metrics are not finite")

    # -- 11. times -------------------------------------------------------------
    ms_step, ms_step_plain, peak_gb, kernel_step = timed_steps(full, weights, codes, train_step)
    for route, ms in (("kernel", ms_step), ("plain", ms_step_plain)):
        say("phase11", train_step=route, B=B, ms=f"{ms:.4f}", smiles_per_s=f"{B / (ms / 1e3):.1f}",
            card=json.dumps(gpu))
    say("phase11", peak_device_memory_GB=f"{peak_gb:.3f}", card=json.dumps(gpu))

    enc_params = encoder_params(model)
    with torch.no_grad():
        times = {
            "fused_encode": (time_ms(lambda: conv_enc._encode_kernel(cfg, codes, enc_params)),
                             time_ms(lambda: conv_enc.fused_encode_ref(model, cfg, codes))),
            "fused_sample_kl": (time_ms(lambda: sampler._sample_kernel(1, mu_r, lv_r, 1.0)),
                                time_ms(lambda: sampler.fused_sample_kl_ref(1, mu_r, lv_r, 1.0))),
            "gru_stack_fwd": (time_ms(lambda: gru_stack.stack_forward(*s_args)),
                              time_ms(lambda: gru_stack.stack_forward_ref(*s_args))),
            "gru_stack_bwd": (time_ms(lambda: gru_stack.stack_backward(res, dY, dhf)),
                              time_ms(lambda: gru_stack.stack_backward_ref(res, dY, dhf))),
        }
    for name, (ms_k, ms_p) in times.items():
        say("phase11", kernel=name, ms=f"{ms_k:.4f}", plain_ms=f"{ms_p:.4f}", card=json.dumps(gpu))
    # idle share against the event-timed step: the profiler's own wall time
    # includes its overhead
    say_profile("phase11", profile_step(kernel_step), ms_step)

    # -- 12. per-layer kernels against their plain versions ------------------
    T, H = cfg.max_len, cfg.gru_hidden
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    dY_l = 1e-2 * torch.randn(T, B, H, device=dev, generator=g)
    x1 = res_k[0][0].float()  # layer 1's input: the stack kernel's bf16 layer-0 outputs
    layer_err = {torch.bfloat16: [0.0, 0.0], torch.float32: [0.0, 0.0]}
    layer_res = {}
    for md in (torch.bfloat16, torch.float32):
        for l, x_l in ((0, s_args[0]), (1, x1)):
            args = layer_args(s_args, l, x_l)
            fwd_e, bwd_e, layer_res[md, l] = check_layer_x(args, md, dY_l, layer=l)
            ragged = tuple(a[:, :6].contiguous() if i == 0 else a for i, a in enumerate(args[:-1])) + (args[-1][:6],)
            fwd_r, bwd_r, _ = check_layer_x(ragged, md, dY_l[:, :6].contiguous(), layer=l, ragged_batch=6)
            layer_err[md][0] = max(layer_err[md][0], fwd_e, fwd_r)
            layer_err[md][1] = max(layer_err[md][1], bwd_e, bwd_r)
    x0, wih0, bih0, _, _, whh, bhh, h0 = s_args
    with torch.no_grad():
        gi = x0 @ wih0.T + bih0  # the hoisted input GEMM of layer 0
    scan_args = (gi, whh[0], bhh[0], h0[0])
    scan_fwd_err, scan_bwd_err = check_scan(*scan_args, dY_l, layer=0)
    fwd_r, bwd_r = check_scan(gi[:, :6].contiguous(), whh[0], bhh[0], h0[0][:6], dY_l[:, :6].contiguous(),
                              layer=0, ragged_batch=6)
    scan_fwd_err, scan_bwd_err = max(scan_fwd_err, fwd_r), max(scan_bwd_err, bwd_r)
    reset_counts()
    hoisted_loss = hoisted_decode(s_args)
    torch.cuda.synchronize()
    scan_counts = counts()
    with plain_route():
        hoisted_plain = hoisted_decode(s_args)
    hoisted_rel = abs(hoisted_loss - hoisted_plain) / abs(hoisted_plain)
    say("phase12", path="hoisted_gi_decode", loss=f"{hoisted_loss:.6f}", plain_loss=f"{hoisted_plain:.6f}",
        rel_diff=f"{hoisted_rel:.3e}", tol=ROUTE_REL, **scan_counts)
    want_scan = {"gru_layer_scan_fwd": L, "gru_layer_scan_bwd_sweep": L, "gru_layer_bwd_dw": L}
    if any(v != want_scan.get(k, 0) for k, v in scan_counts.items()) or not hoisted_rel <= ROUTE_REL:
        raise AssertionError(f"hoisted-gi decode: counts {scan_counts}, loss rel diff {hoisted_rel:.3e}")

    # -- 13. the zinc250k_quality training step ------------------------------
    qfull = get_preset("zinc250k_quality")
    q_state, q_step, q_counts = train_phase(
        "phase13", qfull, weights, codes,
        {"fused_encode": 1, "fused_sample_kl": 1, "gru_layer_scan_x_fwd": 2 * L,
         "gru_layer_scan_x_bwd_sweep": L, "gru_layer_bwd_dw": L},
        ROUTE_REL)
    reset_counts()
    q_eval = {k: float(v) for k, v in make_eval_step(qfull)(q_state, codes, None).items()}
    eval_counts = counts()
    say("phase13", eval=json.dumps({k: round(v, 4) for k, v in q_eval.items()}), **eval_counts)
    if eval_counts["gru_layer_scan_x_fwd"] != L or eval_counts["gru_layer_scan_x_bwd_sweep"] != 0:
        raise AssertionError(f"eval step: launch counts {eval_counts}")
    if not all(np.isfinite(list(q_eval.values()))):
        raise AssertionError("zinc250k_quality eval metrics are not finite")

    # -- 14. the strict-fp32 zinc250k training step --------------------------
    ffull = dataclasses.replace(full, name="zinc250k_fp32",
                                model=dataclasses.replace(cfg, compute_dtype="float32"))
    _, f_step, f_counts = train_phase(
        "phase14", ffull, weights, codes,
        {"gru_layer_scan_x_fwd": L, "gru_layer_scan_x_bwd_sweep": L, "gru_layer_bwd_dw": L},
        FP32_ROUTE_REL)
    say("phase14", matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        float32_matmul_precision=torch.get_float32_matmul_precision())

    # -- 15. times ---------------------------------------------------------------
    for name, f, fn in (("zinc250k_quality", qfull, q_step), ("zinc250k_fp32", ffull, f_step)):
        ms_k, ms_p, peak, k_step = timed_steps(f, weights, codes, fn)
        for route, ms in (("kernel", ms_k), ("plain", ms_p)):
            say("phase15", train_step=name, route=route, B=B, ms=f"{ms:.4f}",
                smiles_per_s=f"{B / (ms / 1e3):.1f}", card=json.dumps(gpu))
        say("phase15", train_step=name, peak_device_memory_GB=f"{peak:.3f}", card=json.dumps(gpu))
        say_profile("phase15", profile_step(k_step), ms_k)
    layer_ms = {}
    with torch.no_grad():
        for md in (torch.bfloat16, torch.float32):
            for l, x_l in ((0, s_args[0]), (1, x1)):
                args = layer_args(s_args, l, x_l)
                res = (*layer_res[md, l], x_l, args[5], args[1], args[3])
                layer_ms[md, l] = (
                    time_ms(lambda: kgru.layer_forward(*args, md)),
                    time_ms(lambda: kgru.layer_forward_ref(*args, md)),
                    time_ms(lambda: kgru.layer_backward(res, dY_l)),
                    time_ms(lambda: kgru.layer_backward_ref(res, dY_l)),
                )
                say("phase15", kernel="gru_layer_scan_x", md=str(md).split(".")[-1], layer=l, I=x_l.shape[2],
                    fwd_ms=f"{layer_ms[md, l][0]:.4f}", fwd_plain_ms=f"{layer_ms[md, l][1]:.4f}",
                    bwd_ms=f"{layer_ms[md, l][2]:.4f}", bwd_plain_ms=f"{layer_ms[md, l][3]:.4f}",
                    card=json.dumps(gpu))
        s_res = (*kgru.scan_forward(*scan_args), h0[0], whh[0])
        scan_ms = (time_ms(lambda: kgru.scan_forward(*scan_args)), time_ms(lambda: kgru.scan_forward_ref(*scan_args)),
                   time_ms(lambda: kgru.scan_backward(s_res, dY_l)),
                   time_ms(lambda: kgru.scan_backward_ref(s_res, dY_l)))
    say("phase15", kernel="gru_layer_scan", fwd_ms=f"{scan_ms[0]:.4f}", fwd_plain_ms=f"{scan_ms[1]:.4f}",
        bwd_ms=f"{scan_ms[2]:.4f}", bwd_plain_ms=f"{scan_ms[3]:.4f}", card=json.dumps(gpu))
    bf, f32 = torch.bfloat16, torch.float32

    print(json.dumps({"kernels": [
        {"name": "fused_generate", "route": "cuda", "source": "molvax_torch/kernels/csrc/generate.cu",
         "replaces": "molvax/kernels/generate.py:169", "launches": serve_counts["fused_generate"],
         "max_abs_err": max(gaps), "ms": ms_gen, "plain_ms": ms_gen_plain},
        {"name": "fused_encode", "route": "cuda", "source": "molvax_torch/kernels/csrc/conv_enc.cu",
         "replaces": "molvax/kernels/conv_enc.py:181", "launches": train_counts["fused_encode"],
         "max_abs_err": enc_kernel_err, "ms": times["fused_encode"][0], "plain_ms": times["fused_encode"][1]},
        {"name": "fused_sample_kl", "route": "cuda", "source": "molvax_torch/kernels/csrc/sampler.cu",
         "replaces": "molvax/kernels/sampler.py:91", "launches": train_counts["fused_sample_kl"],
         "max_abs_err": sampler_err, "ms": times["fused_sample_kl"][0], "plain_ms": times["fused_sample_kl"][1]},
        {"name": "gru_stack_scan_fwd", "route": "cuda", "source": "molvax_torch/kernels/csrc/gru_stack.cu",
         "replaces": "molvax/kernels/gru_stack.py:552", "launches": train_counts["gru_stack_fwd"],
         "max_abs_err": fwd_err, "ms": times["gru_stack_fwd"][0], "plain_ms": times["gru_stack_fwd"][1]},
        {"name": "gru_stack_scan_bwd", "route": "cuda", "source": "molvax_torch/kernels/csrc/gru_stack.cu",
         "replaces": "molvax/kernels/gru_stack.py:487", "launches": train_counts["gru_stack_bwd_sweep"],
         "max_abs_err": bwd_err, "ms": times["gru_stack_bwd"][0], "plain_ms": times["gru_stack_bwd"][1]},
        # per-layer times at layer 0 (I=329); layer 1's are on the phase15 lines
        {"name": "gru_layer_scan_x_fwd", "route": "cuda", "source": "molvax_torch/kernels/csrc/gru_layer.cu",
         "replaces": "molvax/kernels/gru.py:527",
         "launches": q_counts["gru_layer_scan_x_fwd"] + f_counts["gru_layer_scan_x_fwd"],
         "max_abs_err": layer_err[bf][0], "max_abs_err_fp32": layer_err[f32][0],
         "ms": layer_ms[bf, 0][0], "plain_ms": layer_ms[bf, 0][1],
         "ms_fp32": layer_ms[f32, 0][0], "plain_ms_fp32": layer_ms[f32, 0][1]},
        {"name": "gru_layer_scan_x_bwd", "route": "cuda", "source": "molvax_torch/kernels/csrc/gru_layer.cu",
         "replaces": "molvax/kernels/gru.py:689",
         "launches": q_counts["gru_layer_scan_x_bwd_sweep"] + f_counts["gru_layer_scan_x_bwd_sweep"],
         "max_abs_err": layer_err[bf][1], "max_abs_err_fp32": layer_err[f32][1],
         "ms": layer_ms[bf, 0][2], "plain_ms": layer_ms[bf, 0][3],
         "ms_fp32": layer_ms[f32, 0][2], "plain_ms_fp32": layer_ms[f32, 0][3]},
        {"name": "gru_layer_scan_fwd", "route": "cuda", "source": "molvax_torch/kernels/csrc/gru_layer.cu",
         "replaces": "molvax/kernels/gru.py:237", "launches": scan_counts["gru_layer_scan_fwd"],
         "max_abs_err": scan_fwd_err, "ms": scan_ms[0], "plain_ms": scan_ms[1]},
        {"name": "gru_layer_scan_bwd", "route": "cuda", "source": "molvax_torch/kernels/csrc/gru_layer.cu",
         "replaces": "molvax/kernels/gru.py:348", "launches": scan_counts["gru_layer_scan_bwd_sweep"],
         "max_abs_err": scan_bwd_err, "ms": scan_ms[2], "plain_ms": scan_ms[3]},
    ]}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
