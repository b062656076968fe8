#!/usr/bin/env python3
"""Drive molvax_torch's serving path, training step, chunked trainer,
training loop, constrained decoding, latent workloads, evaluation, CLI and
data parallelism once on one CUDA card.

    python3 chip_smoke.py [--phase 28 | --phase 29]

Run from the root of a checkout. It builds the hand-written kernels from
``molvax_torch/kernels/csrc/`` (into ``build/molvax_torch/``), makes
``zinc250k`` weights at full width from a seed, and runs twenty-seven
phases, each printed on its own lines:

  1. environment: card name and power limit, torch and CUDA versions, the
     global TF32 switches (left at their defaults), kernel build time and
     ptxas report; the automaton kernels' registers, stack frame and spills
     (a stack frame or a spill fails the run);
  2. weights: numpy-seeded JAX-layout params, loaded through io/convert.py;
  3. the generation kernel against its plain version, greedy, T=120, at
     B=256, a ragged 6 and 528 (three slices): share of identical codes,
     and a margin check: replaying the kernel's codes through the plain
     version, every code the kernel chose scores within MARGIN of the
     plain maximum; two decodes give identical codes; each decode takes
     the persistent instance (its launches per decode counted exactly);
  4. the same checks sampled at temperature 1.0 and 0.7, identical noise;
     then the row-block instance at moses_scaled width (4 x GRU-1024, no
     plan), B=16, greedy and sampled, its launches counted;
  5. the serving path through the public functions: sample_prior(256) and
     reconstruct of 256 SMILES (deterministic and stochastic), counting
     kernel launches by instance (the persistent decode once per call, the
     row-block decode never) and checking the strings and the encoder;
  6. decode times: the persistent instance, the row-block instance at the
     same width, the plain version, the wrapper's set-up (giz1's GEMM and
     the packed weights) apart from the launch, and one decode's device
     time by kernel (torch.profiler);
  7. the training kernels' planner: the card's SMs and shared memory from
     the CUDA runtime, the stack's plan and one layer's routes and fp32
     plan on them, and whether they are the H100 SXM constants' plans;
     then the GRU stack (per layer: the input-gate GEMM and the persistent
     recurrence forward; the persistent reverse sweep and the GEMM of the
     cotangent passed down backward; one dW GEMM) against its plain
     composition on the training inputs of the 256 SMILES: max abs error
     of the h sequence, out and h_final, the share of bit-identical bf16
     h, the relative error of each gradient, two backward runs bit for bit;
  8. each of the stack's kernels against its own plain version (the
     GEMM's three epilogues, the recurrence, the sweep); then the stack at
     moses_scaled width (H=1024, L=4, B=256) the same way, and its times;
  9. encoder kernel against the plain encoder at every shape the presets
     give it (zinc250k at B = 256, 1, 6 and 33; chemvae_5k's widths in the
     'charset' orientation, B=64; moses_scaled's, E = Lz = 512), sampler
     kernel against its plain version at B = 256 and 6, two calls bit for
     bit; every training kernel again at a ragged batch of 6;
 10. the training step through the public functions: init_state from the
     seeded weights, 20 steps of make_train_step on the kernel route
     (every kernel launched its exact count per step, loss falls), the
     first 3 steps again on the plain route from the same weights, one
     make_eval_step;
 11. times: the train step on both routes, each new kernel against its
     plain version (CUDA events, median of 5 after 2 warm-ups), the
     encoder's and the sampler's device time a call (calls queued behind a
     sleep kernel) and the device kernels torch.profiler records for one
     wrapper call (its counted launches, no preparation kernel), the
     stack's device time by kernel and the device-time split of one
     kernel-route step (torch.profiler), and peak device memory;
 12. the per-layer GRU kernels against their plain versions on the same
     inputs, layer 0 (I=329) and layer 1 (I=501), also at a ragged batch of
     6: gru_layer_scan_x forward and backward in bf16 and in strict fp32,
     both on the persistent route (input-gate GEMM and recurrence; sweep, dx
     GEMM, one dW GEMM over spans of steps and the sum of the spans), each
     with its exact launches, residual dtypes and two backward runs bit for
     bit, and the in-kernel instance (csrc/gru_layer.cu's persistent
     forward and sweep) on the same inputs, held to the same gates, its
     backward twice bit for bit; the in-kernel instance where it is the
     route, at widths no layout takes (I=329; bf16 H=2304 and fp32 H=1536 at
     B=16, T=16 and at B=256, T=120; bf16 H=4096, B=16, T=16, its W_hh
     streamed from device memory), each with its plan; fp32 where the sweep
     keeps its warp tiles (B=64, H=200); gru_layer_scan forward and
     backward; then gru_layer_scan's own path, a 3-layer hoisted-gi decode
     through its autograd wrapper, counting launches;
 13. the zinc250k_quality training step (per-layer kernels, two-pass
     scheduled sampling) through the public functions: 20 steps on the
     kernel route with exact launch counts per step (per layer and forward
     pass an input-gate GEMM and a recurrence, 6 each; per layer a sweep, a
     dx GEMM, a dW GEMM and the sum of its parts, 3 each; encoder 1, sampler 1; the in-kernel
     instance and the stack 0), loss falls, 3 steps on the plain route, one
     make_eval_step (3 GEMMs and recurrences, no sweep);
 14. the strict-fp32 zinc250k step (compute_dtype='float32'): 20 steps on
     the per-layer kernels in fp32 (per layer an input-gate GEMM, a
     recurrence, a sweep, a dx GEMM, a dW GEMM and the sum of its parts, 3
     each; the in-kernel instance, encoder and sampler 0), loss falls, 3
     plain-route steps within 1e-4, with the TF32 switches;
 15. times: both new train steps on both routes, each per-layer kernel
     against its plain version in bf16 and fp32, the in-kernel instance's
     forward and backward (dx in a GEMM after the sweep and inside it) at
     layers 0 and 1 and its pair's total against the persistent route's
     (the route decision), the forward's and backward's device time by
     kernel on both routes, the library yardsticks (torch.nn.GRU on cuDNN,
     torch.matmul for the dW contraction) in the same call, the in-kernel
     instance and cuDNN at bf16 H=2304 and fp32 H=1536 (B=256, T=120), the
     device-time split of one step of each, and peak device memory;
 16. the automaton kernel (csrc/automaton.cu) against its plain version at
     zinc250k_quality width, B=256: a 120-step greedy walk from seeded
     scores (codes and packed state identical at every step), the same walk
     as one n=120 launch, the 256 SMILES as teacher codes through auto_mask
     / auto_advance (masks and states identical; every parser-valid row
     threads the automaton, closes and never escapes), a ragged batch of 6
     with a NaN row; the 120-step walk again at B = 1, 33 (a partial last
     block) and 1,280 (the beam's rows);
 17. constrained decoding through the public functions: sample_prior
     greedy and at temperature 1.0 and 0.7 (auto_step launched 120 times
     per decode, fused_generate 0, every string chem-valid),
     beam_reconstruct with beam 5 (auto_mask and auto_advance 120 times
     each), and the kernel route against the plain route on the same card
     (greedy codes and logits, beam codes and scores identical);
 18. times: the constrained decode on both routes, the automaton per step
     as n=1 launches, one n=120 launch and its plain version, auto_mask and
     auto_advance, beam 5, each automaton entry point's device time per
     launch (its launches queued behind a sleep kernel, and torch.profiler's
     kernel time where it records them), the device-time split of one
     constrained decode and of one beam-5 decode, and each kernel's bound;
 19. the design probes' kernels against their plain versions at full width
     (B=256, T=120, H=501, L=3) and at a ragged batch of 6: the hoisted-gi
     forward's two probe modes (gru_probe_scan, run_variant's) and the
     fused3 wavefront (gru_fused3_scan: the stack forward as one cooperative
     launch a batch slice, counted per slice) within the bf16 gate, two runs
     bit for bit; floor_loop bit for bit, at the probe's three shapes, with
     int32-limit elements, at 4 chains, 3 (13 ops), 1 and 8; gru_layer_scan_x's
     in-kernel forward (fwd_gi's kernel) at fwd_gi's I=330, and its
     backward (two runs bit for bit);
 20. the three probe modules (molvax_torch/probes/): each run once with its
     launches counted (every probe kernel once), then their tables: the
     recurrence step decomposed (matmul_only, gates_nostore, full) at H=501
     and 512, the 3-layer forward per layer, on the stack, fused3, and
     fused3's work on the per-layer pieces in the same call; the in-kernel
     against the hoisted input GEMM; the automaton per step and its budget;
     the int32-op floor (ns per op, fixed cost, one op's dependent latency
     and the latency floor); each with its bound;
 21. one train step of zinc250k, zinc250k_quality, strict fp32 and a bf16
     step with the property head (three seeded targets, target stats)
     under torch.cuda.set_sync_debug_mode("error"): no host sync on the
     step's path; each step's time and idle share;
 22. the reference's headline training path: synthetic_dataset(4096,
     max_len=120, seed=0) (tokenizer path and seconds), BatchIterator(ds,
     256, seed=0).next_stack(16) on the card, and a K=16 make_train_chunk
     (one CUDA Graph) at zinc250k, zinc250k_quality and moses_scaled width,
     property_joint with EMA and strict-fp32 zinc250k (the plain sampler
     path): against 16 eager steps from a deep copy of the same state on
     the same stack (weights, Adam moments and steps, EMA, stacked metrics;
     bit for bit where two eager runs are, else the non-deterministic
     gradients named and CHUNK_REL; strict fp32 must be bit for bit), the
     next stack and replay under sync debug mode "error" (the weights'
     version counters advanced by it), one replay's device activity
     against 16 eager steps' (the counters move at capture, not at a
     replay), ms per step eager and chunked, SMILES/s, next_stack's host
     ms, capture seconds, the graph's memory and the idle share of one
     profiled chunk;
 23. train() at zinc250k_quality's full width on that corpus: 69 steps
     (4 chunks of 16, 5 single steps), eval every 32 (2 batches and the
     round-trip probe), select_best, a checkpoint every 32; run U straight
     to 69, run S stopped at max_steps=32 and resumed by a fresh train():
     the final checkpoints, the history after step 32, best/'s weights and
     probe.json bit for bit; a restore into a live model decodes as a
     fresh model with the same weights (the packed weights rebuilt); U's
     launches counted exactly (per-layer kernels, encoder, sampler,
     persistent decode, no stack or plain route); ms per step of the loop,
     an eval pass, the probe, a checkpoint's save and restore and bytes,
     the resumed run's idle share; then train() at zinc250k for 256 steps
     against phase 22's replay;
 24. the latent workloads at zinc250k width, each against its plain
     route: encode_corpus of 1,000 SMILES (a tail chunk), decode_latents
     greedy (the persistent decode, margin-checked), constrained and beam 5
     constrained (the automaton kernels, 100% chem-valid, identical to the
     plain automaton), interpolate (8 slerp waypoints), optimize_from_smiles
     on property_joint (16 steps of optimize_z against the CPU),
     fit_aggregate_posterior and sample_aggregate; SMILES/s of the decodes;
 25. evaluate() at zinc250k_quality's full width: a state trained by
     train() for 64 steps with EMA 0.999 on the training split of phase
     22's corpus, scored on the held-out split with beam=5 and the
     temperature sweep: the reference's keys (report_keys of
     tests/test_torch_eval_keys.py), finite values, fractions in [0, 1],
     con_chem_valid 1.0; each metric function's launches exactly (the
     persistent decode a slice for every prior, aggregate, interpolation,
     round-trip and sweep decode, the row-block decode never; auto_step
     120 per constrained decode; per eval batch the encoder, the sampler
     and the per-layer GRU forward), its wall ms and idle share; the same
     seed's report bit for bit, twice; the deterministic metrics against
     the plain route (rates within 0.02, per-character accuracies within
     0.01, the posterior within 1e-3 relative, teacher-forced within
     1e-2 relative); then a property_joint state for optimization_metrics'
     two variants (opt_con_chem_valid 1.0, their launches exact);
 26. the CLI through molvax_torch.cli.main in this process: train
     (zinc250k_quality, 64 steps, eval and checkpoints every 32, EMA,
     best/; property_joint, 32 steps), presets, sample (plain, sampled,
     aggregate, constrained), reconstruct (greedy, equal to a decode by the
     EMA weights of best/ bit for bit; beam 5 constrained), interpolate
     (plain, constrained), evaluate --holdout --beam 5, encode, decode
     (equal to reconstruct; beam 5), optimize --constrained, the refusals
     of a missing checkpoint and of optimize without a property head; each
     command's lines, launches and ms; no module of JAX or of the
     reference loaded; then python3 -m molvax_torch.cli sample in a child
     process;
 27. data parallelism (molvax_torch.parallel): (d) the sampler and both
     decode instances (sampled at T=0.7) at row_base 0 on B=256 and 128 on
     rows 128-255 against their plain versions at the same base, and the
     row_base 128 call equal to the B=256 call's rows 128-255 bit for bit;
     (a) an NCCL world of one rank in this process: the K=16 zinc250k
     chunk over its mesh, the gradients' all-reduce captured in the graph
     (one NCCL kernel a step in a replay), against the no-mesh chunk from
     the same weights, bit for bit (weights, Adam state, metrics), both
     chunks' ms a step and the all-reduce's device ms a step; (b) train()
     at moses_scaled width with 256 rows a chip in that world: the
     reference's warning for its 8x1 mesh, an auto 1-rank mesh, 12
     chunked steps, ms a step and the bytes reduced a step; then two gloo
     ranks on the card (spawned): (c) one eager zinc250k step, 128 rows a
     rank of the global 256, each rank's all-reduced gradients within the
     bf16 gate of the 1-process step's, the metrics (post_std_batch and
     acc_nonpad among them) within 1e-3, rank 1's eps and masks those of
     rows 128-255, the chunk refused on a gloo group; (e) sample_prior(256)
     and decode_latents greedy over the ranks equal to the 1-process
     strings (or a near-tie within MARGIN); (f) the ranks' checkpoint
     restored by this process, and this process's restored by the ranks,
     bit for bit;
 28. the scan route's decode as one CUDA Graph (latent.sample's
     CapturedDecode), its step kernels and its noise table: the step
     kernels (kernels.generate.FusedStep, csrc/decode_step.cu) against
     their plain versions at (B, preset) = (256, zinc250k), (1280,
     zinc250k) and (256, moses_scaled) with seeded weights: the packing
     bit for bit, z's gates, and over 8 sampled steps the hidden states
     and logits within 1e-4, the scores and their first maximum bit for
     bit, two runs bit for bit alike, 2 + (L + 1) launches; at (256,
     zinc250k) a step's device ms, each kernel's, the plain version's and
     the cuBLAS and elementwise chain's it replaces (decoder_step), and
     the bound; the table kernel
     (kernels.generate.gumbel_table, csrc/noise.cu) bit for bit its plain
     version at (T, B, C) = (120, 256, 37) and at B=528 from row_base
     4000, its seed an int, an int64 and an int32 tensor, one launch a
     call, with its ms, device ms and bound; then at B=256, greedy, T=1.0,
     T=0.7 and T=1.0 at row_base 128: five calls a key, op by op until the
     key's third call captures its graph, three seeds replayed; codes and
     logits of every call equal to the op-by-op loop and to the loop that
     draws the per-step noise (both through the step kernels), bit for
     bit; auto_step 120 a call (121 in the capturing call: its step before
     the capture), the noise table 1 a sampled call (2 in the capturing
     call), the step kernels 2 + 120 (L + 1) a call (2 + L + 1 more in
     the capturing call), and 120 auto_step kernels
     and 1 table kernel a replay in the profiler's trace; a key of its own
     under the plain automaton (0 auto_step launches, equal to its loop
     and to the kernel's replay); the device activities the profiler
     records in a replay (at most 8 a step), in the loop and in the
     per-step-noise loop, a replay's device ms (queued behind a sleep); a key's first call, its
     capturing call, a replay and both loops, ms a request. (Phases 17, 18
     and 24-26 decode through the graph where a key comes back: phase 17
     counts its replays' auto_step kernels and each decode's noise tables
     too.) ``--phase 28`` runs phases 1, 2 and this phase alone.
 29. gvae_zinc (the Grammar VAE) at its published widths, with the
     benchmark's seeded weights: the pushdown walk kernel against its plain
     version on the same logits (the decode's, B=10,000, T=277, R=76) and
     seed, sampled and greedy, and at a row_base on a slice, bit for bit,
     one launch a call; sample_prior(10,000): one walk launch a request,
     every string the derivation of its rule codes, the request's ms, the
     walk's ms and the plain version's, peak device memory; the encoder
     at B=500 on the corpus's rule codes through the kernel (its chunked
     dense phase, ReLU; one launch), against the plain encoder; a K=16
     train chunk at B=500 from the same weights: its first loss against
     the plain reference's (perfbench/reference/grammar.py, fp32) within
     GVAE_LOSS_REL, beside the reference in bf16 against itself in fp32.
     ``--phase 29`` runs phase 1 and this phase alone.

Any failure raises and exits non-zero. Without CUDA it exits 2 and prints
no result. The line before the card's is the ``kernels`` JSON: each kernel
with its launches on its path (0 on the main paths for a probe kernel,
which phase 20's run launches), its error against its plain version, its
time, the plain version's, its bound (the larger of its operations over the
card's peak for their type and its bytes over 3.35 TB/s, and which of the
two binds) and the time of one library call computing the same function, or
null where there is none. The last line of standard output is the device
JSON.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from molvax_torch.config import get_preset
from molvax_torch.data import BatchIterator, synthetic_dataset
from molvax_torch.data import native as tokenizer
from molvax_torch.data.charset import DEFAULT_CHARSET
from molvax_torch.data.featurize import decode_codes, encode_smiles, one_hot
from molvax_torch.data.smiles_check import chem_valid
from molvax_torch.io.convert import state_dict_from_jax
from molvax_torch.kernels import _build, conv_enc, gru_stack, sampler
from molvax_torch.kernels import automaton as kauto
from molvax_torch.kernels import floor as kfloor
from molvax_torch.kernels import gru as kgru
from molvax_torch.kernels import generate as kg
from molvax_torch.latent import constrain as kcon
from molvax_torch.latent.beam import beam_generate, beam_reconstruct
from molvax_torch.latent import sample as ls
from molvax_torch.latent.sample import generate, reconstruct, sample_prior
from molvax_torch.nn.decoder import decoder_input_size, decoder_step, latent_embed, teacher_inputs
from molvax_torch.nn.encoder import conv_input_channels, encoder_params, flat_conv_dim, linear
from molvax_torch.nn.gru import gru_layers
from molvax_torch.nn.vae import MolecularVAE, encode
from molvax_torch.probes import auto_loop_probe, gru_experiments, proto_gi_kernel
from molvax_torch.probes.stack_probe import device_kernels, device_ms, queued_ms
from molvax_torch.train import effective_config, init_state, make_eval_step, make_train_chunk, make_train_step
from molvax_torch.train import profiling
from molvax_torch.train.profiling import card_line as card
from molvax_torch.train.profiling import event_ms as time_ms

MARGIN = 1e-2  # score units; bf16 operand rounding of a near-tie h can move a logit by ~1e-4
# the stack's gates, which also hold the bf16 per-layer kernels
STACK_FWD_TOL = 3.91e-3  # the reference's on-chip gate for the stack kernel (ROADMAP B)
STACK_BWD_REL = 1e-2  # ||kernel - plain|| / ||plain|| per gradient
ENCODER_TOL = 1e-3  # same bf16 operands and stages, fp32 sums in another order
SAMPLER_REL = 1e-5  # same bits; fp32 transcendentals of the card vs torch's
ROUTE_REL = 1e-2  # per-step loss, kernel route against plain route
GEMM_REL = 1e-4  # ||GEMM - gemm_ref|| / ||gemm_ref||: the same bf16 operands, fp32 sums in another
# order (dW over 30,720 rows measured 3.6e-5; a bf16-rounded sum would show as ~1e-3)
FP32_FWD_TOL = 1e-4  # strict fp32: only the sum order differs; a bf16 or TF32
FP32_BWD_REL = 1e-3  # cast would show as ~1e-2
FP32_ROUTE_REL = 1e-4  # per-step loss of the strict-fp32 routes
# a K=16 chunk against 16 eager steps: bit for bit where two eager runs are;
# where a library kernel of the step is not deterministic (its gradients
# named by first_nondeterministic), ||chunk - eager|| / ||eager|| per tensor
CHUNK = 16
CHUNK_REL = 1e-5
B = 256
SEED = 0
BEAM = 5
# the least time the card could take, from the published peaks of one H100
# SXM at its full 700 W (train/profiling.py's table)
PEAKS = profiling.H100_SXM
PEAK_BF16 = PEAKS.bf16_tflops * 1e12  # dense bf16 tensor-core FLOP/s
PEAK_FP32 = PEAKS.fp32_tflops * 1e12  # fp32 FLOP/s outside the tensor cores (strict fp32)
PEAK_TF32X3 = PEAKS.tf32_tflops * 1e12 / 3  # fp32 products as 3xTF32 split products
PEAK_INT32 = PEAKS.int32_tops * 1e12  # int32 op/s: half the fp32 lane rate
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


def check_kernel(model, z_emb, greedy: bool, temperature: float, seed: int, instance: str = "persistent",
                 **kv) -> float:
    """Kernel against plain version on the same inputs and noise, on the
    instance ``instance`` (its launches per decode counted exactly; two
    decodes must give identical codes). Returns the largest gap between
    the plain maximum score and the score of the kernel's code; raises if
    it exceeds MARGIN."""
    B, C, H, L = z_emb.shape[0], model.cfg.charset_size, model.cfg.gru_hidden, model.cfg.gru_layers
    plan = kg.generate_plan(B, C, H, L, *kg.card_limits(z_emb.device))
    if (plan is not None) != (instance == "persistent"):
        raise AssertionError(f"B={B}, H={H}, L={L}: the plan {plan} does not route to the {instance} instance")
    per_decode = {"persistent": plan.slices if plan else 0, "row_block": 0 if plan else 1}
    before = (kg.persistent_launches, kg.row_block_launches)
    codes_k = kg.fused_generate(model, model.cfg, z_emb, seed, greedy=greedy, temperature=temperature)
    again = kg.fused_generate(model, model.cfg, z_emb, seed, greedy=greedy, temperature=temperature)
    codes_r = kg.fused_generate_ref(model, model.cfg, z_emb, seed, greedy=greedy, temperature=temperature)
    torch.cuda.synchronize()
    got = {"persistent": (kg.persistent_launches - before[0]) / 2, "row_block": (kg.row_block_launches - before[1]) / 2}
    if got != per_decode:
        raise AssertionError(f"launches per decode {got}, expected {per_decode}")
    twice = torch.equal(codes_k, again)
    if not twice:
        raise AssertionError(f"B={B}: two decodes gave different codes")
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
    say("phase3" if greedy else "phase4", mode=mode, B=B, T=codes_k.shape[1], instance=instance,
        launches_per_decode=json.dumps(per_decode).replace(" ", ""), identical_codes=f"{same:.6f}",
        max_margin_gap=f"{gap:.3e}", margin=MARGIN, two_decodes_identical=twice, **kv)
    if gap > MARGIN:
        raise AssertionError(f"{mode}: kernel chose a code {gap:.3e} below the plain maximum")
    return gap


def row_block_check(dev) -> dict:
    """The row-block instance, which takes the widths no plan does, at
    moses_scaled width (4 x GRU-1024, seeded weights), B=16: greedy and
    sampled against the plain version, its launches and its time."""
    mcfg = get_preset("moses_scaled").model
    mmodel = MolecularVAE(mcfg, device=dev)
    mmodel.load_state_dict(state_dict_from_jax(random_params(mcfg, SEED + 7)), strict=True)
    mmodel.eval()
    rows = 16
    z = np.random.default_rng(SEED + 8).standard_normal((rows, mcfg.latent_dim)).astype(np.float32)
    with torch.no_grad():
        z_emb = latent_embed(mmodel, mcfg, torch.from_numpy(z).to(dev))
    before = kg.row_block_launches
    gap = max(check_kernel(mmodel, z_emb, greedy, temp, seed, "row_block", preset="moses_scaled")
              for greedy, temp, seed in ((True, 1.0, 0), (False, 1.0, 11)))
    launches = kg.row_block_launches - before
    ms = time_ms(lambda: kg.fused_generate(mmodel, mcfg, z_emb, 0))
    say("phase4", preset="moses_scaled", instance="row_block", B=rows, gru=f"{mcfg.gru_layers}x{mcfg.gru_hidden}",
        row_block_launches=launches, ms=f"{ms:.4f}")
    return {"B": rows, "launches": launches, "max_margin_gap": gap, "ms": ms}


def time_on_copies(fn, state: torch.Tensor, warmup: int = 2, reps: int = 5) -> float:
    """time_ms of fn(copy), where fn updates ``state`` in place: each call
    gets its own copy, made before the timing starts, so no copy is timed."""
    pool = [state.clone() for _ in range(warmup + reps)]
    return time_ms(lambda: fn(pool.pop()), warmup, reps)


def reset_counts() -> None:
    kg.launches = kg.persistent_launches = kg.row_block_launches = conv_enc.launches = sampler.launches = 0
    gru_stack.gemm_gi_launches = gru_stack.rec_launches = gru_stack.sweep_launches = 0
    gru_stack.gemm_dx_launches = gru_stack.dw_launches = 0
    kgru.layer_fwd_launches = kgru.layer_bwd_launches = 0
    kgru.layer_gi_launches = kgru.layer_rec_launches = kgru.layer_sweep_launches = 0
    kgru.layer_dx_launches = kgru.layer_gemm_dw_launches = kgru.layer_dw_sum_launches = 0
    kgru.scan_fwd_launches = kgru.scan_bwd_launches = 0
    kauto.step_launches = kauto.mask_launches = kauto.advance_launches = 0
    kgru.probe_matmul_only_launches = kgru.probe_gates_nostore_launches = 0
    kgru.fused3_launches = kfloor.launches = 0


def counts() -> dict:
    return {
        "fused_generate": kg.launches,
        "fused_generate_persistent": kg.persistent_launches,
        "fused_generate_row_block": kg.row_block_launches,
        "fused_encode": conv_enc.launches,
        "fused_sample_kl": sampler.launches,
        "gru_stack_gemm_gi": gru_stack.gemm_gi_launches,
        "gru_stack_rec": gru_stack.rec_launches,
        "gru_stack_sweep": gru_stack.sweep_launches,
        "gru_stack_gemm_dx": gru_stack.gemm_dx_launches,
        "gru_stack_gemm_dw": gru_stack.dw_launches,
        "gru_layer_gemm_gi": kgru.layer_gi_launches,
        "gru_layer_rec": kgru.layer_rec_launches,
        "gru_layer_sweep": kgru.layer_sweep_launches,
        "gru_layer_gemm_dx": kgru.layer_dx_launches,
        "gru_layer_gemm_dw": kgru.layer_gemm_dw_launches,
        "gru_layer_dw_sum": kgru.layer_dw_sum_launches,
        "gru_layer_scan_x_fwd": kgru.layer_fwd_launches,
        "gru_layer_scan_x_bwd_sweep": kgru.layer_bwd_launches,
        "gru_layer_scan_fwd": kgru.scan_fwd_launches,
        "gru_layer_scan_bwd_sweep": kgru.scan_bwd_launches,
        "auto_step": kauto.step_launches,
        "auto_mask": kauto.mask_launches,
        "auto_advance": kauto.advance_launches,
        "gru_probe_matmul_only": kgru.probe_matmul_only_launches,
        "gru_probe_gates_nostore": kgru.probe_gates_nostore_launches,
        "gru_fused3": kgru.fused3_launches,
        "floor_loop": kfloor.launches,
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


def stack_launches(L: int) -> dict:
    """The stack's kernel launches in one forward and backward of L layers:
    per layer the input-gate GEMM, the recurrence, the reverse sweep and the
    GEMM of the cotangent passed down; one GEMM for every dW and db."""
    return {"gru_stack_gemm_gi": L, "gru_stack_rec": L, "gru_stack_sweep": L, "gru_stack_gemm_dx": L,
            "gru_stack_gemm_dw": 1}


def stack_piece_checks(s_args, res_k, dY, dhf, phase: str, **kv) -> dict:
    """Each of the stack's kernels against its own plain version on the same
    inputs: the GEMM's three epilogues (input gates of layers 0 and 1, the
    cotangent passed down to a hidden layer and to x0, dW with h0 as the
    first rows and dW over x0), the recurrence (layer 0, from the plain
    input gates) and the sweep (the top layer, from the kernel's
    residuals). Returns the largest error of each kind."""
    x0, wih0, bih0, wih, bih, whh, bhh, h0 = s_args
    hseq, rzn, ghn = res_k
    top = h0.shape[0] - 1
    gs = gru_stack
    with torch.no_grad():
        gi_r = gs.gemm_ref("gi", x0, wih0, bih0)
        sw_args = (hseq[top], h0[top], rzn[top], ghn[top], whh[top], dY, dhf[top])
        sw_r = gs.layer_sweep_ref(*sw_args)
        gemms = {
            "gi_layer0": (gs.gemm("gi", x0, wih0, bih0), (gi_r,)),
            "gi_layer1": (gs.gemm("gi", hseq[0], wih[0], bih[0]), (gs.gemm_ref("gi", hseq[0], wih[0], bih[0]),)),
            "dx_hidden": (gs.gemm("dx", sw_r[0], wih[top - 1]), (gs.gemm_ref("dx", sw_r[0], wih[top - 1]),)),
            "dx_x0": (gs.gemm("dx", sw_r[0], wih0), (gs.gemm_ref("dx", sw_r[0], wih0),)),
            "dw_hh": (gs.gemm("dw", sw_r[1], hseq[top][:-1], first=h0[top]),
                      gs.gemm_ref("dw", sw_r[1], hseq[top][:-1], first=h0[top])),
            "dw_ih0": (gs.gemm("dw", sw_r[0], x0), gs.gemm_ref("dw", sw_r[0], x0)),
        }
        rec_k = gs.layer_recurrence(gi_r, whh[0], bhh[0], h0[0])
        rec_r = gs.layer_recurrence_ref(gi_r, whh[0], bhh[0], h0[0])
        sw_k = gs.layer_sweep(*sw_args)
    torch.cuda.synchronize()
    errs = {}
    for name, (got, want) in gemms.items():
        got = got if isinstance(got, tuple) else (got,)
        errs[f"gemm_{name}"] = max(rel_err(a, b) for a, b in zip(got, want))
    errs["recurrence"] = max_abs(rec_k[0], rec_r[0])  # hseq; r|z|n and gh_n by norm, as check_stack's
    errs["recurrence_rzn_ghn"] = max(rel_err(a, b) for a, b in zip(rec_k[1:], rec_r[1:]))
    errs["sweep"] = max(rel_err(a, b) for a, b in zip(sw_k, sw_r))
    tols = {name: (STACK_FWD_TOL if name == "recurrence" else STACK_BWD_REL if name in ("sweep", "recurrence_rzn_ghn")
                   else GEMM_REL) for name in errs}
    say(phase, check="stack_kernels_each_against_its_plain_version", B=x0.shape[1],
        err=json.dumps({k: f"{v:.3e}" for k, v in errs.items()}).replace(" ", ""),
        tol=json.dumps(tols).replace(" ", ""), **kv)
    bad = {k: v for k, v in errs.items() if not (v <= tols[k] and np.isfinite(v))}
    if bad:
        raise AssertionError(f"stack kernels differ from their plain versions at B={x0.shape[1]}: {bad}")
    return {"gemm": max(v for k, v in errs.items() if k.startswith("gemm")), "recurrence": errs["recurrence"],
            "sweep": errs["sweep"]}


def check_stack(s_args, dY, dhf, phase: str, **kv):
    """The stack's forward and backward against their plain compositions on
    the same inputs, and two backward runs bit for bit. Returns (forward
    max abs error, gradient max abs error, the kernel's residuals, its
    gradients)."""
    x0, wih0, _, wih, _, whh, _, h0 = s_args
    with torch.no_grad():
        res_k = gru_stack.stack_forward(*s_args)
        res_r = gru_stack.stack_forward_ref(*s_args)
        res = (*res_k, x0, h0, wih0, wih, whh)
        grads_k = gru_stack.stack_backward(res, dY, dhf)
        grads_again = gru_stack.stack_backward(res, dY, dhf)
        grads_r = gru_stack.stack_backward_ref(res, dY, dhf)
    torch.cuda.synchronize()
    L = h0.shape[0]
    out_err = max_abs(res_k[0][L - 1], res_r[0][L - 1])
    hf_err = max_abs(res_k[0][:, -1], res_r[0][:, -1])
    fwd_err = max_abs(res_k[0], res_r[0])
    # r|z|n and gh_n: one bf16 step of gh_n near 2 is 7.8e-3, so by norm
    res_rel = max(rel_err(a, b) for a, b in zip(res_k[1:], res_r[1:]))
    same_h = (res_k[0] == res_r[0]).float().mean().item()
    shape = dict(B=x0.shape[1], T=x0.shape[0], I0=x0.shape[2], H=h0.shape[2], L=L, **kv)
    say(phase, out_max_abs_err=f"{out_err:.3e}", h_final_max_abs_err=f"{hf_err:.3e}",
        hseq_max_abs_err=f"{fwd_err:.3e}", hseq_bit_identical=f"{same_h:.6f}", tol=STACK_FWD_TOL,
        rzn_ghn_rel_err=f"{res_rel:.3e}", rel_tol=STACK_BWD_REL, **shape)
    if not (fwd_err <= STACK_FWD_TOL and res_rel <= STACK_BWD_REL):
        raise AssertionError(f"stack forward differs from its plain version by {fwd_err:.3e} / {res_rel:.3e} ({shape})")
    bwd_err = 0.0
    for name, a, b in zip(["dx0", "dwih0", "dbih0", "dwih", "dbih", "dwhh", "dbhh", "dh0"], grads_k, grads_r):
        r = rel_err(a, b)
        if not (torch.isfinite(a).all() and a.shape == b.shape):
            raise AssertionError(f"stack backward {name}: non-finite or misshapen ({shape})")
        bwd_err = max(bwd_err, max_abs(a, b))
        say(phase, grad=name, shape=tuple(a.shape), rel_err=f"{r:.3e}", max_abs_err=f"{max_abs(a, b):.3e}",
            rel_tol=STACK_BWD_REL, B=shape["B"], H=shape["H"])
        if not r <= STACK_BWD_REL:
            raise AssertionError(f"stack backward {name}: relative error {r:.3e} > {STACK_BWD_REL} ({shape})")
    same = all(torch.equal(a, b) for a, b in zip(grads_k, grads_again))
    say(phase, check="backward_twice_bit_identical", identical=same, B=shape["B"], H=shape["H"])
    if not same:
        raise AssertionError(f"two runs of the stack backward differ ({shape})")
    return fwd_err, bwd_err, res_k, grads_k


def moses_width_check(dev, gpu: str) -> dict:
    """The stack at moses_scaled width (H=1024, L=4, 256 rows per card),
    seeded weights (uniform +-1/sqrt(H)) and inputs: forward and backward
    against the plain compositions, each kernel against its plain version,
    and their times beside the per-layer route's forward; strict-fp32
    gru_layer_scan_x at layer 0 against its plain versions (its plan takes
    two launches per layer), and the fp32 per-layer route's forward."""
    mcfg = get_preset("moses_scaled").model
    T, H, L = mcfg.max_len, mcfg.gru_hidden, mcfg.gru_layers
    I0 = mcfg.latent_dim + mcfg.charset_size
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    k = 1.0 / np.sqrt(H)

    def u(*shape):
        return (2.0 * torch.rand(*shape, generator=g, device=dev) - 1.0) * k

    s_args = (torch.randn(T, B, I0, generator=g, device=dev), u(3 * H, I0), u(3 * H), u(L - 1, 3 * H, H),
              u(L - 1, 3 * H), u(L, 3 * H, H), u(L, 3 * H), 0.1 * torch.randn(L, B, H, generator=g, device=dev))
    dY = 1e-2 * torch.randn(T, B, H, generator=g, device=dev)
    dhf = 1e-2 * torch.randn(L, B, H, generator=g, device=dev)
    plan = gru_stack.stack_plan(B, H, *gru_stack.card_limits(dev))
    say("phase8", preset="moses_scaled", plan=json.dumps(dataclasses.asdict(plan)).replace(" ", ""))
    fwd_err, bwd_err, res_k, _ = check_stack(s_args, dY, dhf, "phase8", preset="moses_scaled")
    stack_piece_checks(s_args, res_k, dY, dhf, "phase8", preset="moses_scaled")
    x0, wih0, bih0, wih, bih, whh, bhh, h0 = s_args
    res = (*res_k, x0, h0, wih0, wih, whh)
    layers = [{"w_ih": wih0 if l == 0 else wih[l - 1], "b_ih": bih0 if l == 0 else bih[l - 1],
               "w_hh": whh[l], "b_hh": bhh[l]} for l in range(L)]
    f32 = torch.float32
    say("phase8", preset="moses_scaled", md="float32",
        plan=json.dumps(dataclasses.asdict(gru_stack.stack_plan(B, H, *gru_stack.card_limits(dev), esize=4)))
        .replace(" ", ""))
    check_layer_x(layer_args(s_args, 0, x0), f32, dY, layer=0, preset="moses_scaled")
    with torch.no_grad():
        ms = {"fwd": time_ms(lambda: gru_stack.stack_forward(*s_args)),
              "bwd": time_ms(lambda: gru_stack.stack_backward(res, dY, dhf))}
        for name, md in (("per_layer_fwd", torch.bfloat16), ("per_layer_fwd_fp32", f32)):
            ms[name] = 1e3 * profiling.step_timer(
                lambda: kgru.gru_forward_pallas(layers, x0.transpose(0, 1), h0, md, kernel="per_layer"),
                steps=1, rounds=6)
    say("phase8", preset="moses_scaled", stack_fwd_ms=f"{ms['fwd']:.4f}", stack_bwd_ms=f"{ms['bwd']:.4f}",
        per_layer_route_fwd_ms=f"{ms['per_layer_fwd']:.4f}",
        per_layer_route_fwd_fp32_ms=f"{ms['per_layer_fwd_fp32']:.4f}", card=json.dumps(gpu))
    return {"fwd_err": fwd_err, "bwd_err": bwd_err, "ms": ms}


STACK_SOURCES = ["molvax_torch/kernels/csrc/gru_stack.cu", "molvax_torch/kernels/csrc/gemm.cuh"]
# gru_layer_scan_x runs the stack's kernels, bf16 and strict fp32; the
# in-kernel instance where no layout fits
LAYER_SOURCES = STACK_SOURCES + ["molvax_torch/kernels/csrc/gru_layer.cu"]
# the stack's kernels as torch.profiler names them (demangled or not), of
# either storage type
STACK_KERNELS = (("gemm_kernel<true, true, 0,", "gemm_gi"), ("gemm_kernelILb1ELb1ELi0E", "gemm_gi"),
                 ("gemm_kernel<true, false, 1,", "gemm_dx"), ("gemm_kernelILb1ELb0ELi1E", "gemm_dx"),
                 ("gemm_kernel<false, false, 2,", "gemm_dw"), ("gemm_kernelILb0ELb0ELi2E", "gemm_dw"),
                 ("gru_rec_kernel", "recurrence"), ("gru_sweep_kernel", "sweep"), ("sum_parts_kernel", "dw_sum"),
                 ("layer_fwd_kernel", "layer_fwd"), ("layer_sweep_kernel", "layer_sweep"))


def stack_split(fn) -> dict:
    """Device ms of one call of fn by stack kernel (torch.profiler); the
    rest (operand copies, allocation of zeroed flags) as 'other'."""
    split = {}
    for name, ms in profile_step(fn)["device_ms"].items():
        part = next((p for key, p in STACK_KERNELS if key in name), "other")
        split[part] = split.get(part, 0.0) + ms
    return split


def ragged_batch_checks(model, cfg, codes, s_args, rows: int = 6) -> dict:
    """Every training kernel against its plain version at a batch that is
    not a multiple of 16, the stack's rows per group: the stack's forward
    and backward, each of its kernels, the encoder and the sampler.
    Returns the stack's errors."""
    x0, wih0, bih0, wih, bih, whh, bhh, h0 = s_args
    args = (x0[:, :rows].contiguous(), wih0, bih0, wih, bih, whh, bhh, h0[:, :rows].contiguous())
    g = torch.Generator(device=x0.device).manual_seed(SEED + 3)
    dY = torch.randn(x0.shape[0], rows, cfg.gru_hidden, device=x0.device, generator=g)
    dhf = torch.randn(cfg.gru_layers, rows, cfg.gru_hidden, device=x0.device, generator=g)
    fwd, bwd, res_k, _ = check_stack(args, dY, dhf, "phase9", ragged_batch=rows)
    pieces = stack_piece_checks(args, res_k, dY, dhf, "phase9", ragged_batch=rows)
    with torch.no_grad():
        enc = max(max_abs(a, b) for a, b in zip(conv_enc._encode_kernel(cfg, codes[:rows], encoder_params(model)),
                                                 conv_enc.fused_encode_ref(model, cfg, codes[:rows])))
        mu, lv = conv_enc.fused_encode_ref(model, cfg, codes[:rows])
    smp = max(sampler_checks(mu, lv, 7, 1.0)[:2])
    say("phase9", ragged_batch=rows, stack_fwd_max_abs_err=f"{fwd:.3e}", stack_bwd_max_abs_err=f"{bwd:.3e}",
        encoder_max_abs_err=f"{enc:.3e}", sampler_rel_err=f"{smp:.3e}")
    if not (enc <= ENCODER_TOL and smp <= SAMPLER_REL):
        raise AssertionError(f"a training kernel differs from its plain version at B={rows}")
    return {"fwd": fwd, "bwd": bwd, **pieces}


def seeded_model(cfg, seed: int, dev):
    """A MolecularVAE of ``cfg`` with random_params(cfg, seed)."""
    m = MolecularVAE(cfg, device=dev)
    m.load_state_dict(state_dict_from_jax(random_params(cfg, seed)), strict=True)
    m.eval()
    return m


def encoder_shape_checks(model, cfg, codes, dev) -> float:
    """The encoder kernel against the plain encoder within ENCODER_TOL at
    every shape the presets give it: zinc250k at B = 256, 1, 6 and 33 (a
    batch that is not a multiple of the 32-row tiles), chemvae_5k's widths
    in the 'charset' orientation (B=64, F=110), moses_scaled's (E = Lz =
    512, B=256). Returns the largest error."""
    ccfg = dataclasses.replace(get_preset("chemvae_5k").model, conv_orientation="charset")
    mcfg = get_preset("moses_scaled").model
    cases = [("zinc250k", model, cfg, codes[:rows]) for rows in (B, 1, 6, 33)]
    cases += [("chemvae_5k_charset", seeded_model(ccfg, SEED + 11, dev), ccfg, codes[:64]),
              ("moses_scaled", seeded_model(mcfg, SEED + 12, dev), mcfg, codes)]
    worst = 0.0
    for name, m, c, x in cases:
        with torch.no_grad():
            got = conv_enc._encode_kernel(c, x, encoder_params(m))
            want = conv_enc.fused_encode_ref(m, c, x)
        torch.cuda.synchronize()
        err = max(max_abs(a, b) for a, b in zip(got, want))
        say("phase9", encoder=name, B=x.shape[0], orientation=c.conv_orientation, F=flat_conv_dim(c),
            E=c.enc_hidden, Lz=c.latent_dim, max_abs_err=f"{err:.3e}", tol=ENCODER_TOL)
        if not err <= ENCODER_TOL:
            raise AssertionError(f"encoder kernel at {name}, B={x.shape[0]}: {err:.3e} from the plain encoder")
        worst = max(worst, err)
    return worst


def sampler_checks(mu, lv, seed: int, eps_scale: float) -> tuple:
    """The sampler kernel against its plain version within SAMPLER_REL, and
    two calls bit for bit: (z relative error, kl relative error, largest
    absolute error). The kernel reads the seed from the card; the plain
    version takes the same tensor and gives the bits of the int seed."""
    seed_t = torch.full((), seed, dtype=torch.int32, device=mu.device)
    with torch.no_grad():
        z_k, kl_k = sampler._sample_kernel(seed_t, mu, lv, eps_scale)
        z_2, kl_2 = sampler._sample_kernel(seed_t, mu, lv, eps_scale)
        z_r, kl_r = sampler.fused_sample_kl_ref(seed_t, mu, lv, eps_scale)
        z_i, kl_i = sampler.fused_sample_kl_ref(seed, mu, lv, eps_scale)
    torch.cuda.synchronize()
    twice = torch.equal(z_k, z_2) and torch.equal(kl_k, kl_2)
    if not (torch.equal(z_r, z_i) and torch.equal(kl_r, kl_i)):
        raise AssertionError("the plain sampler gives other bits for a device seed than for the same int seed")
    z_rel = max_abs(z_k, z_r) / z_r.abs().max().item()
    kl_rel = max_abs(kl_k, kl_r) / kl_r.abs().max().item()
    say("phase9", sampler_B=mu.shape[0], z_rel_err=f"{z_rel:.3e}", kl_rel_err=f"{kl_rel:.3e}",
        z_bit_identical=f"{(z_k == z_r).float().mean().item():.6f}", two_calls_bit_identical=twice,
        rel_tol=SAMPLER_REL)
    if not (z_rel <= SAMPLER_REL and kl_rel <= SAMPLER_REL and twice):
        raise AssertionError(f"sampler kernel at B={mu.shape[0]}: z {z_rel:.3e}, kl {kl_rel:.3e}, repeatable {twice}")
    return z_rel, kl_rel, max(max_abs(z_k, z_r), max_abs(kl_k, kl_r))


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


def saved_x(args, md):
    """gru_layer_scan_x's input x as its autograd wrapper saves it for the
    backward: the padded copy in md that the forward read and the dW GEMM
    reads again, on either route."""
    return gru_stack._padded(args[0], md)


def layer_launches(md, B: int, I: int, H: int, fwd: int, bwd: int) -> dict:
    """The launches of ``fwd`` forwards and ``bwd`` backwards of one
    gru_layer_scan_x layer on the route its shape takes: per batch slice of
    the plan a recurrence and a sweep, the GEMMs and the dW parts' sum; or
    per slice of layer_plan the in-kernel forward and sweep, then the same
    dx and dW GEMMs and sum."""
    limits = gru_stack.card_limits(DEVICE)
    gemms = {"gru_layer_gemm_dx": bwd, "gru_layer_gemm_dw": bwd, "gru_layer_dw_sum": bwd}
    if kgru._persistent(md, B, H, limits):
        n = gru_stack.stack_plan(B, H, *limits, esize=md.itemsize).slices
        return {"gru_layer_gemm_gi": fwd, "gru_layer_rec": n * fwd, "gru_layer_sweep": n * bwd, **gemms}
    n = kgru.layer_plan(B, I, H, *limits, esize=md.itemsize).slices
    return {"gru_layer_scan_x_fwd": n * fwd, "gru_layer_scan_x_bwd_sweep": n * bwd, **{k: v for k, v in gemms.items() if v}}


def model_layer_launches(mcfg, md, fwd: int, bwd: int) -> dict:
    """layer_launches summed over a decoder's GRU layers at B (layer 0 reads
    the decoder's input, the others H wide)."""
    out = {}
    for l in range(mcfg.gru_layers):
        I = decoder_input_size(mcfg) if l == 0 else mcfg.gru_hidden
        for k, v in layer_launches(md, B, I, mcfg.gru_hidden, fwd, bwd).items():
            out[k] = out.get(k, 0) + v
    return out


# check_layer_x's largest in-kernel errors at the presets' widths, forward and gradients, by storage type
IN_KERNEL_ERR = {torch.bfloat16: [0.0, 0.0], torch.float32: [0.0, 0.0]}


def check_layer_x(args, md, dY, **kv):
    """gru_layer_scan_x's forward and backward kernels, on the route the
    shape takes, against their plain versions on the same inputs: residual
    dtypes, exact launches, two backward runs bit for bit. Returns (forward
    max abs error, gradient max abs error, the kernel's residuals)."""
    kv = dict(kv)
    compare = kv.pop("compare_in_kernel", False)
    fwd_tol, bwd_rel = _gates(md)
    T, B, I = args[0].shape
    H = args[5].shape[-1]
    reset_counts()
    with torch.no_grad():
        res_k = kgru.layer_forward(*args, md)
        res_r = kgru.layer_forward_ref(*args, md)
    torch.cuda.synchronize()
    if any(r.dtype != md for r in res_k):
        raise AssertionError(f"gru_layer_scan_x stored {[r.dtype for r in res_k]}, expected {md}")
    out_err = max_abs(res_k[0], res_r[0])
    hf_err = max_abs(res_k[0][-1], res_r[0][-1])
    same = (res_k[0] == res_r[0]).float().mean().item()
    route = "persistent" if kgru._persistent(md, B, H, gru_stack.card_limits(DEVICE)) else "in_kernel"
    kv = dict(md=str(md).split(".")[-1], B=B, I=I, H=H, route=route, **kv)
    say("phase12", kernel="gru_layer_scan_x_fwd", out_max_abs_err=f"{out_err:.3e}",
        h_final_max_abs_err=f"{hf_err:.3e}", hseq_bit_identical=f"{same:.6f}", tol=fwd_tol, **kv)
    if not max(out_err, hf_err) <= fwd_tol:
        raise AssertionError(f"gru_layer_scan_x forward differs from its plain version by {out_err:.3e} ({kv})")
    x, w_ih, _, w_hh, _, h0 = args
    res = (*res_k, saved_x(args, md), h0, w_ih, w_hh)
    with torch.no_grad():
        grads_k = kgru.layer_backward(res, dY)
        grads_again = kgru.layer_backward(res, dY)
        grads_r = kgru.layer_backward_ref(res, dY)
    torch.cuda.synchronize()
    got = {k: v for k, v in counts().items() if v}
    twice = all(torch.equal(a, b) for a, b in zip(grads_k, grads_again))
    say("phase12", kernel="gru_layer_scan_x", launches=json.dumps(got).replace(" ", ""),
        backward_twice_bit_identical=twice, **kv)
    if got != layer_launches(md, B, I, H, 1, 2) or not twice:
        raise AssertionError(f"gru_layer_scan_x ({kv}): launches {got}, two backward runs identical {twice}")
    bwd_err = _check_grads("gru_layer_scan_x_bwd", GRAD_NAMES, grads_k, grads_r, bwd_rel, **kv)
    if compare:  # the in-kernel instance on the same inputs, held to the same gates, beside them
        with torch.no_grad():
            res_i = kgru.layer_forward_in_kernel(*args, md)
            in_res = (*res_i, saved_x(args, md), h0, w_ih, w_hh)
            grads_i, grads_ir = kgru.layer_backward_in_kernel(in_res, dY), kgru.layer_backward_ref(in_res, dY)
            grads_i2 = kgru.layer_backward_in_kernel(in_res, dY)
        torch.cuda.synchronize()
        in_fwd = max_abs(res_i[0], res_r[0])
        in_bwd = max(max_abs(a, b) for a, b in zip(grads_i, grads_ir))
        in_rel = max(rel_err(a, b) for a, b in zip(grads_i, grads_ir))
        in_twice = all(torch.equal(a, b) for a, b in zip(grads_i, grads_i2))
        say("phase12", kernel="gru_layer_scan_x", route_errors="persistent_beside_in_kernel",
            fwd_max_abs_err=f"{max(out_err, hf_err):.3e}", fwd_max_abs_err_in_kernel=f"{in_fwd:.3e}",
            grad_max_abs_err=f"{bwd_err:.3e}", grad_max_abs_err_in_kernel=f"{in_bwd:.3e}",
            grad_max_rel_err_in_kernel=f"{in_rel:.3e}", in_kernel_backward_twice_bit_identical=in_twice, **kv)
        if not (in_fwd <= fwd_tol and in_rel <= bwd_rel and in_twice):
            raise AssertionError(f"in-kernel instance ({kv}): forward {in_fwd:.3e}, gradients {in_rel:.3e} "
                                 f"relative, two backward runs identical {in_twice}")
        IN_KERNEL_ERR[md][0] = max(IN_KERNEL_ERR[md][0], in_fwd)
        IN_KERNEL_ERR[md][1] = max(IN_KERNEL_ERR[md][1], in_bwd)
    return max(out_err, hf_err), bwd_err, res_k


def seeded_layer_args(dev, T_, B_, I_, H_, seed):
    """gru_layer_scan_x's arguments at (T, B, I, H), seeded weights uniform
    +-1/sqrt(H), and a cotangent dY."""
    g = torch.Generator(device=dev).manual_seed(seed)
    k = 1.0 / np.sqrt(H_)

    def u(*shape):
        return (2.0 * torch.rand(*shape, generator=g, device=dev) - 1.0) * k

    args = (torch.randn(T_, B_, I_, generator=g, device=dev), u(3 * H_, I_), u(3 * H_), u(3 * H_, H_), u(3 * H_),
            0.1 * torch.randn(B_, H_, generator=g, device=dev))
    return args, 1e-2 * torch.randn(T_, B_, H_, generator=g, device=dev)


def seeded_layer_check(dev, md, T_, B_, I_, H_, label, seed):
    """gru_layer_scan_x in md at (T, B, I, H) on seeded_layer_args against
    its plain versions on the route the shape takes. Returns (forward error,
    gradient error)."""
    args, dY = seeded_layer_args(dev, T_, B_, I_, H_, seed)
    return check_layer_x(args, md, dY, layer=label)[:2]


def wide_times(dev, gpu) -> dict:
    """At the widths no layout takes (B=256, T=120, I=329; bf16 H=2304, fp32
    H=1536): the in-kernel forward and backward, and cuDNN's one-layer GRU of
    the same sizes and dtype (forward; autograd backward), its yardstick.
    Returns {md: (fwd ms, bwd ms, cuDNN fwd ms, cuDNN bwd ms)}."""
    out = {}
    for md, H_ in ((torch.bfloat16, 2304), (torch.float32, 1536)):
        args, dY = seeded_layer_args(dev, 120, B, 329, H_, SEED + 7)
        with torch.no_grad():
            res = (*kgru.layer_forward_in_kernel(*args, md), saved_x(args, md), args[5], args[1], args[3])
            fwd = time_ms(lambda: kgru.layer_forward_in_kernel(*args, md))
            bwd = time_ms(lambda: kgru.layer_backward_in_kernel(res, dY))
        gru = torch.nn.GRU(329, H_, 1, device=dev, dtype=md)
        x = args[0].to(md)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            with torch.no_grad():
                fwd_lib = time_ms(lambda: gru(x))
            xg = x.detach().clone().requires_grad_(True)
            y, _ = gru(xg)
            dy = dY.to(md)
            inputs = [xg, *gru.parameters()]
            bwd_lib = time_ms(lambda: torch.autograd.grad(y, inputs, dy, retain_graph=True))
        out[md] = (fwd, bwd, fwd_lib, bwd_lib)
        say("phase15", kernel="gru_layer_scan_x", route="in_kernel", md=str(md).split(".")[-1], B=B, T=120, I=329,
            H=H_, fwd_ms=f"{fwd:.4f}", bwd_ms=f"{bwd:.4f}", cudnn_fwd_ms=f"{fwd_lib:.4f}",
            cudnn_autograd_bwd_ms=f"{bwd_lib:.4f}", card=json.dumps(gpu))
    return out


# widths no layout of the persistent kernels takes (I=329): (md, H, B, T); bf16
# H=4096 streams W_hh (100 MB) from device memory each step
WIDE = [(torch.bfloat16, 2304, 16, 16), (torch.bfloat16, 2304, B, 120), (torch.float32, 1536, 16, 16),
        (torch.float32, 1536, B, 120), (torch.bfloat16, 4096, 16, 16)]


def wide_layer_check(dev, md, H_, B_, T_):
    """gru_layer_scan_x at a width no layout of the persistent kernels takes
    in md (I=329): the in-kernel instance of csrc/gru_layer.cu, its weights
    streamed each step (layer_plan). Returns (forward error, gradient error,
    the run's launches of the forward and the sweep)."""
    limits = gru_stack.card_limits(dev)
    plan = kgru.layer_plan(B_, 329, H_, *limits, esize=md.itemsize)
    if kgru.layer_route(B_, H_, md, limits) != "in_kernel" or plan.res_hh:
        raise AssertionError(f"layer_route({B_}, {H_}, {md}) found a persistent layout or W_hh resident: {plan}")
    say("phase12", wide_layer_plan=json.dumps(dataclasses.asdict(plan)).replace(" ", ""), md=str(md).split(".")[-1],
        H=H_, B=B_, T=T_)
    errs = seeded_layer_check(dev, md, T_, B_, 329, H_, "wide", SEED + 5)
    got = counts()
    return (*errs, {k: got[k] for k in ("gru_layer_scan_x_fwd", "gru_layer_scan_x_bwd_sweep")})


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


# the automaton's kernels, as ptxas and the profiler name them
AUTO_KERNELS = {"auto_step": "auto_step_kernel", "auto_mask": "auto_mask_kernel",
                "auto_advance": "auto_advance_kernel"}


def _ptxas_at(lines: list, i: int) -> dict:
    """The registers, stack frame and spilled bytes that the ptxas report
    gives after its "Function properties for" line i."""
    frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      " ".join(lines[i + 1 : i + 3]))
    used = next(x for x in lines[i + 1 : i + 4] if "Used" in x)
    return {"registers": int(re.search(r"Used (\d+) registers", used).group(1)),
            "stack_frame_bytes": int(frame.group(1)), "spill_store_bytes": int(frame.group(2)),
            "spill_load_bytes": int(frame.group(3))}


def ptxas_report(log: str, kernel: str) -> dict:
    """A kernel's registers, stack frame and spilled bytes, from the ptxas
    report (-Xptxas -v) of the build."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line and kernel in line:
            return _ptxas_at(lines, i)
    raise AssertionError(f"the ptxas report names no {kernel}")


def ptxas_instances(log: str, kernel: str) -> dict:
    """``ptxas_report`` of every instance of a kernel template, by its
    template arguments (bf16 / fp32, then the bool and int parameters in
    order), e.g. ``layer_sweep_kernel<bf16,4>``."""
    names = {"13__nv_bfloat16": "bf16", "f": "fp32"}
    lines, out = log.splitlines(), {}
    for i, line in enumerate(lines):
        m = re.search(kernel + r"I(\w+?)EEv", line) if "Function properties for" in line else None
        if m:
            args = [names.get(a, a) for a in re.findall(r"13__nv_bfloat16|^f|(?<=L[bi])\d+", m.group(1))]
            out[f"{kernel}<{','.join(args)}>"] = _ptxas_at(lines, i)
    return out


# -- bounds ----------------------------------------------------------------------


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


bound = profiling.bound_ms  # (bound ms, what binds) of ops at a peak and bytes at the HBM rate


def gru_macs(I: int, H: int) -> int:
    """Multiply-adds of one GRU layer for one row and step: x@W_ih, h@W_hh."""
    return (I + H) * 3 * H


def encoder_macs(cfg) -> int:
    """Multiply-adds of the encoder for one row: the VALID convs, dense, mu
    and logvar heads."""
    in_ch = conv_input_channels(cfg)
    length = cfg.max_len if cfg.conv_orientation == "seq" else cfg.charset_size
    macs = 0
    for out_ch, k in zip(cfg.conv_channels, cfg.conv_kernels):
        length = length - k + 1
        macs += length * out_ch * in_ch * k
        in_ch = out_ch
    return macs + flat_conv_dim(cfg) * cfg.enc_hidden + 2 * cfg.enc_hidden * cfg.latent_dim


def encoder_ops(cfg, codes: torch.Tensor) -> int:
    """Operations of the encoder kernel on these codes ('seq' orientation):
    the first conv a gather, one add for each tap whose code lies in the
    charset; 2 a multiply-add for the later convs, the dense layer and the
    heads."""
    valid = ((codes >= 0) & (codes < cfg.charset_size)).long()
    K, W = cfg.conv_kernels[0], cfg.max_len - cfg.conv_kernels[0] + 1
    taps = sum(int(valid[:, k:k + W].sum()) for k in range(K))
    first = cfg.conv_channels[0] * W * cfg.charset_size * K  # the dense first conv's multiply-adds
    return cfg.conv_channels[0] * taps + 2 * codes.shape[0] * (encoder_macs(cfg) - first)


def automaton_ops(rows: int, C: int, mask: bool = True, select: bool = True, advance: bool = True) -> int:
    """A lower count of the integer operations of one automaton step over
    ``rows`` rows, from the function's arithmetic: the mask tests each of
    the C classes against the 18 token-attribute tables (18 C per row), the
    selection compares the C masked scores for the maximum and its first
    index (2 C), the transition reads the chosen token's 18 table entries
    and writes the 17 scalar fields and at most 4 array words (39). The
    duplicate-ring checks, which scan the row's pair pool as far as the data
    needs, are left out: the count can only understate the work, so the
    bound never flatters the kernel."""
    per_row = (18 * C if mask else 0) + (2 * C if select else 0) + (39 if advance else 0)
    return rows * per_row


# -- the automaton (phases 16-18) -----------------------------------------------


@contextlib.contextmanager
def plain_automaton():
    """The automaton wrappers' plain versions in their place, on the card."""
    saved = (kauto.auto_step, kauto.auto_mask, kauto.auto_advance)
    kauto.auto_step, kauto.auto_mask, kauto.auto_advance = (
        kauto.auto_step_plain, kauto.auto_mask_plain, kauto.auto_advance_plain)
    try:
        yield
    finally:
        kauto.auto_step, kauto.auto_mask, kauto.auto_advance = saved


def trajectory_scores(rows: int, T: int, C: int, dev, seed: int) -> torch.Tensor:
    """(rows, T, C) fp32 scores from a seed, tilted so the greedy walk emits
    branches, rings, brackets and bonds and pads late: the automaton's
    whole state gets exercised."""
    g = torch.Generator(device=dev).manual_seed(seed)
    scores = 2.0 * torch.randn(rows, T, C, generator=g, device=dev)
    tilt = torch.zeros(C, device=dev)
    tilt[DEFAULT_CHARSET.chars.index(" ")] = -4.0
    for ch in "()123[]=#+-@H":
        tilt[DEFAULT_CHARSET.chars.index(ch)] = 1.0
    return scores + tilt


def compare_trajectory(itab, scores, T: int, what: str) -> dict:
    """Step the kernel (auto_step, n=1) and its plain version side by side
    over scores (rows, T, C): codes and packed state must be identical at
    every step. Then the whole walk again as one n=T launch. Returns the
    kernel's codes and final state."""
    rows = scores.shape[0]
    dev = scores.device
    sk, sp = kauto.new_state(rows, T, dev), kauto.new_state(rows, T, dev)
    codes, err = [], 0
    for t in range(T):
        ck = kauto.auto_step(itab, sk, scores[:, t].contiguous(), T - 1 - t)
        cp = kauto.auto_step_plain(itab, sp, scores[:, t], T - 1 - t)
        torch.cuda.synchronize()
        err = max(err, int((ck - cp).abs().max()), int((sk - sp).abs().max()))
        if not torch.equal(ck, cp):
            bad = (ck != cp).nonzero()[:4].tolist()
            raise AssertionError(f"{what}: auto_step codes differ from the plain version at step {t}, rows {bad}")
        if not torch.equal(sk, sp):
            bad = (sk != sp).nonzero()[:4].tolist()
            raise AssertionError(f"{what}: auto_step state differs from the plain version at step {t}, [row, col] {bad}")
        codes.append(ck)
    codes = torch.cat(codes, dim=1)
    s1 = kauto.new_state(rows, T, dev)
    c1 = kauto.auto_step(itab, s1, scores.contiguous(), T - 1)
    torch.cuda.synchronize()
    if not (torch.equal(c1, codes) and torch.equal(s1, sk)):
        raise AssertionError(f"{what}: one n={T} launch differs from {T} launches of n=1")
    return {"codes": codes, "state": sk, "max_abs_err": err}


def teacher_checks(itab, codes, T: int, valid: list) -> dict:
    """Teacher codes through auto_mask / auto_advance and their plain
    versions: masks and states identical on every row at every step; on
    the rows the parser accepts, every teacher token is legal, the row ends
    closed and the escape hatch never fires."""
    rows = codes.shape[0]
    dev = codes.device
    toks = codes.to(torch.int32)
    sk, sp = kauto.new_state(rows, T, dev), kauto.new_state(rows, T, dev)
    legal = torch.ones(rows, dtype=torch.bool, device=dev)
    mask_err = state_err = 0
    for t in range(T):
        mk = kauto.auto_mask(itab, sk, T - 1 - t)
        mp = kauto.auto_mask_plain(itab, sp, T - 1 - t)
        torch.cuda.synchronize()
        mask_err = max(mask_err, int((mk.to(torch.int32) - mp.to(torch.int32)).abs().max()))
        if not torch.equal(mk, mp):
            bad = (mk != mp).nonzero()[:4].tolist()
            raise AssertionError(f"auto_mask differs from the plain mask at step {t}, [row, class] {bad}")
        legal &= mk.gather(1, toks[:, t : t + 1].long())[:, 0]
        kauto.auto_advance(itab, sk, toks[:, t].contiguous())
        kauto.auto_advance_plain(itab, sp, toks[:, t])
        torch.cuda.synchronize()
        state_err = max(state_err, int((sk - sp).abs().max()))
        if not torch.equal(sk, sp):
            bad = (sk != sp).nonzero()[:4].tolist()
            raise AssertionError(f"auto_advance state differs from the plain version at step {t}, [row, col] {bad}")
    st = kauto.unpack_state(sk)
    closed = kcon.is_closed(st)
    ok = torch.tensor(valid, device=dev)
    n_bad = int((ok & ~(legal & closed & ~st.esc)).sum())
    return {"valid_rows": int(ok.sum()), "rows_failing": n_bad,
            "invalid_rows_accepted": int((~ok & legal & closed & ~st.esc).sum()),
            "mask_max_abs_err": mask_err, "state_max_abs_err": state_err}


def phase16(dev, T: int, C: int) -> dict:
    """The automaton kernel against its plain version on the card."""
    itab = kauto.pack_tables(kcon.build_tables(DEFAULT_CHARSET)).to(dev)
    scores = trajectory_scores(B, T, C, dev, SEED + 16)
    traj = compare_trajectory(itab, scores, T, f"B={B}")
    strings = decode_codes(traj["codes"], DEFAULT_CHARSET)
    valid_traj = sum(chem_valid(x) for x in strings)
    st = kauto.unpack_state(traj["state"])
    say("phase16", check="trajectory_n1_and_n120", B=B, T=T, codes_and_state_identical=True,
        mean_len=f"{np.mean([len(x) for x in strings]):.1f}", chem_valid=f"{valid_traj}/{B}",
        esc=int(st.esc.sum()), max_atoms=int(st.n_atoms.max()), max_rings_closed=int(st.pn.max()))
    if valid_traj != B or int(st.esc.sum()):
        raise AssertionError(f"greedy constrained walks: {B - valid_traj} invalid strings, esc {int(st.esc.sum())}")
    codes = torch.from_numpy(encode_smiles(SMILES, DEFAULT_CHARSET, T)).to(dev)
    valid = [chem_valid(x) for x in SMILES]
    tch = teacher_checks(itab, codes, T, valid)
    say("phase16", check="teacher_codes", rows=len(SMILES), masks_and_state_identical=True, **tch)
    if tch["rows_failing"]:
        raise AssertionError(f"{tch['rows_failing']} parser-valid SMILES do not thread the automaton")
    # a ragged batch of 6, one row with a NaN among its legal scores
    rag = trajectory_scores(6, T, C, dev, SEED + 17)
    rag[2, 5] = float("nan")
    rt = compare_trajectory(itab, rag, T, "ragged B=6 with a NaN row")
    rst = kauto.unpack_state(rt["state"])
    say("phase16", check="ragged_6_nan_row", codes_and_state_identical=True,
        nan_row_code_at_nan_step=int(rt["codes"][2, 5]), nan_row_esc=bool(rst.esc[2]),
        other_rows_esc=int(rst.esc.sum()) - int(rst.esc[2]))
    if int(rt["codes"][2, 5]) != 0:
        raise AssertionError("a NaN among the legal scores must give the pad code")
    # one row, 33 (a partial last block), the beam's 1,280 rows
    errs = [traj["max_abs_err"], rt["max_abs_err"]]
    for rows in (1, 33, B * BEAM):
        other = compare_trajectory(itab, trajectory_scores(rows, T, C, dev, SEED + 20 + rows), T, f"B={rows}")
        say("phase16", check="trajectory_n1_and_n120", B=rows, T=T, codes_and_state_identical=True,
            max_abs_err=other["max_abs_err"])
        errs.append(other["max_abs_err"])
    return {"itab": itab, "scores": scores, "step_err": max(errs),
            "mask_err": tch["mask_max_abs_err"], "advance_err": tch["state_max_abs_err"]}


def phase17(model, qcfg, dev) -> dict:
    """Constrained decoding and beam search through the public functions."""
    T = qcfg.max_len
    out = {}
    gen = torch.Generator().manual_seed(SEED + 17)
    for name, greedy, temp in (("greedy", True, 1.0), ("T1.0", False, 1.0), ("T0.7", False, 0.7)):
        reset_counts()
        tables = kg.noise_table_launches
        strings = sample_prior(model, qcfg, B, gen, greedy=greedy, temperature=temp, constrained=True)
        torch.cuda.synchronize()
        got, tables = counts(), kg.noise_table_launches - tables
        bad = [x for x in strings if not chem_valid(x)]
        say("phase17", call="sample_prior", mode=name, n=len(strings), chem_valid=f"{len(strings) - len(bad)}/{len(strings)}",
            distinct=len(set(strings)), examples=json.dumps(strings[:3]), auto_step=got["auto_step"],
            fused_generate=got["fused_generate"], gumbel_table=tables)
        want = {"auto_step": T}
        if any(v != want.get(k, 0) for k, v in got.items()) or tables != (0 if greedy else 1):
            raise AssertionError(f"constrained sample_prior ({name}): launch counts {got}, gumbel_table {tables}, "
                                 f"expected {want} and {0 if greedy else 1} table")
        if bad or len(strings) != B:
            raise AssertionError(f"constrained sample_prior ({name}): invalid strings {bad[:5]}")
        out[name] = got
    # the greedy key again until its graph is captured (latent.sample), then
    # replays: the profiler records T auto_step kernels a replay, and the
    # counter counts T a replay
    z = torch.from_numpy(np.random.default_rng(SEED + 17).standard_normal((B, qcfg.latent_dim))
                         .astype(np.float32)).to(dev)
    caps = ls.graph_captures
    while ls.graph_captures == caps:
        generate(model, qcfg, z, constrained=True)
    reset_counts()
    reps = ls.graph_replays
    per = profiled_kernels_per_call("auto_step", lambda: generate(model, qcfg, z, constrained=True), T, alone=False)
    replays, counted = ls.graph_replays - reps, counts()["auto_step"]
    say("phase17", check="auto_step_in_replays", mode="greedy", replays=replays, counted=counted,
        profiler_auto_step_per_replay=per)
    if per != T or counted != T * replays:
        raise AssertionError(f"constrained replays: the profiler {per} auto_step a replay, counted {counted} "
                             f"in {replays} replays, expected {T}")
    out["replay_auto_step"] = per
    reset_counts()
    beams = beam_reconstruct(model, qcfg, SMILES, beam=BEAM, constrained=True)
    torch.cuda.synchronize()
    got = counts()
    bad = [x for x in beams if not chem_valid(x)]
    say("phase17", call="beam_reconstruct", beam=BEAM, n=len(beams), chem_valid=f"{len(beams) - len(bad)}/{len(beams)}",
        identical_to_input=f"{sum(a == b for a, b in zip(beams, SMILES)) / len(SMILES):.4f}",
        examples=json.dumps(beams[:3]), **{k: got[k] for k in ("auto_step", "auto_mask", "auto_advance", "fused_encode")})
    # vae.encode runs the plain encoder, as the reference's does: the fused
    # encoder serves the training forward only
    want = {"auto_mask": T, "auto_advance": T}
    if any(v != want.get(k, 0) for k, v in got.items()):
        raise AssertionError(f"constrained beam_reconstruct: launch counts {got}, expected {want}")
    if bad:
        raise AssertionError(f"constrained beam search: invalid strings {bad[:5]}")
    out["beam"] = got
    # greedy codes on the kernel route and the plain route, same card
    rng = np.random.default_rng(SEED + 18)
    z = torch.from_numpy(rng.standard_normal((B, qcfg.latent_dim)).astype(np.float32)).to(dev)
    codes_k, logits_k = generate(model, qcfg, z, constrained=True)
    with plain_automaton():
        codes_p, logits_p = generate(model, qcfg, z, constrained=True)
    # the beam decode at its own shape: B latents, B * BEAM automaton rows
    bk, sk = beam_generate(model, qcfg, z, beam=BEAM, constrained=True)
    with plain_automaton():
        bp, sp = beam_generate(model, qcfg, z, beam=BEAM, constrained=True)
    torch.cuda.synchronize()
    same = bool(torch.equal(codes_k, codes_p) and torch.equal(logits_k, logits_p))
    beam_same = bool(torch.equal(bk, bp) and torch.equal(sk, sp))
    say("phase17", check="kernel_vs_plain_route", greedy_codes_identical=same, beam_identical=beam_same,
        B=B, beam_latents=B, beam_rows=B * BEAM)
    if not (same and beam_same):
        raise AssertionError("constrained decode: the kernel route differs from the plain route")
    out["z"] = z
    return out


def profiled_kernels_per_call(name: str, fn, per_call: int, sessions: int = 5, alone: bool = True) -> float:
    """Device kernels per call that torch.profiler records of wrapper
    ``name`` (kernel ``name``_kernel), whose call fn makes ``per_call``
    counted launches; 0.0 where no session recorded any. Every session must
    record no more of that kernel than the calls launch and, ``alone``,
    nothing else (no preparation kernel or copy around it); otherwise the
    other activities are left out. The profiler at times loses a kernel at
    a session's edge (seen: 9 of 10 in every session of a process on an
    H100 80GB HBM3), so the count a call is that of a session of 20 calls
    less that of one of 10, over 10; up to ``sessions`` pairs run until it
    is ``per_call``, and failing that the check fails."""
    def session(calls: int) -> int:
        got = device_kernels(lambda: [fn() for _ in range(calls)])
        foreign = {k: n for k, n in got.items() if f"{name}_kernel" not in k}
        n = sum(got.values()) - sum(foreign.values())
        if (alone and foreign) or n > calls * per_call:
            raise AssertionError(f"{name}: the profiler recorded {got} for {calls} calls of {per_call} launches")
        return n

    seen = []
    for _ in range(sessions):
        n10, n20 = session(10), session(20)
        seen.append((n10, n20))
        if n10 and n20 and n20 - n10 == 10 * per_call:
            return (n20 - n10) / 10
    if not any(n10 or n20 for n10, n20 in seen):
        return 0.0
    raise AssertionError(f"{name}: the profiler recorded {seen} device kernels in sessions of (10, 20) calls "
                         f"of {per_call} launches")


def device_ms_per_launch(fn, name: str, launches: int) -> tuple:
    """Device ms per launch of automaton entry point ``name`` in a call of
    fn that launches it ``launches`` times (counted exactly, each call on
    copies of its own): (``queued_ms`` of the call over its launches, the
    profiler's device time over the kernels it recorded, or None where it
    recorded none)."""
    before = counts()[name]
    queued = queued_ms(fn) / launches
    ms, recorded = device_ms(fn, AUTO_KERNELS[name])
    got = counts()[name] - before
    if got % launches or recorded > launches:
        raise AssertionError(f"{name}: {got} launches in calls of {launches}, the profiler recorded {recorded}")
    return queued, (ms / recorded if recorded else None)


def classify(name: str) -> str:
    if "auto_" in name:
        return "automaton"
    if any(k in name for k in ("cell_kernel", "head_kernel", "pack_kernel")):
        return "step_kernels"
    if any(k in name.lower() for k in ("gemm", "xmma", "cutlass", "sm90", "sm80")):
        return "gru_matmuls"
    return "other"


def phase18(model, qcfg, z, itab, scores, gpu) -> dict:
    """Times of the constrained decode and the automaton kernel."""
    T = qcfg.max_len
    t = {}
    t["decode"] = time_ms(lambda: generate(model, qcfg, z, constrained=True))
    with plain_automaton():
        t["decode_plain"] = time_ms(lambda: generate(model, qcfg, z, constrained=True))
    t["beam"] = time_ms(lambda: beam_generate(model, qcfg, z, beam=BEAM, constrained=True))
    for route in ("decode", "decode_plain"):
        say("phase18", constrained_decode=route, B=B, T=T, ms=f"{t[route]:.4f}",
            smiles_per_s=f"{B / (t[route] / 1e3):.1f}", card=json.dumps(gpu))
    say("phase18", beam_decode=BEAM, B=B, ms=f"{t['beam']:.4f}", smiles_per_s=f"{B / (t['beam'] / 1e3):.1f}",
        card=json.dumps(gpu))
    s0 = kauto.new_state(B, T, z.device)
    sc_steps = [scores[:, k].contiguous() for k in range(T)]

    def steps(step_fn):
        def walk(s):
            for k in range(T):
                step_fn(itab, s, sc_steps[k], T - 1 - k)
        return walk

    # every timed call updates a copy made before the timing starts
    t["step_n1"] = time_on_copies(steps(kauto.auto_step), s0) / T
    t["step_n120"] = time_on_copies(lambda s: kauto.auto_step(itab, s, scores, T - 1), s0) / T
    t["step_plain"] = time_on_copies(steps(kauto.auto_step_plain), s0) / T
    # mask and advance alone, at the beam's rows, on a mid-decode state
    # reached by both routes; both must agree bit for bit on it
    rows = B * BEAM
    sb, sb_plain = kauto.new_state(rows, T, z.device), kauto.new_state(rows, T, z.device)
    walk = trajectory_scores(rows, 40, itab.shape[1], z.device, SEED + 19)
    walk_codes = kauto.auto_step(itab, sb, walk, T - 1)
    walk_codes_plain = kauto.auto_step_plain(itab, sb_plain, walk, T - 1)
    mask_k = kauto.auto_mask(itab, sb, T - 41)
    mask_p = kauto.auto_mask_plain(itab, sb_plain, T - 41)
    tok = mask_k.to(torch.float32).argmax(1).to(torch.int32)
    adv_k, adv_p = sb.clone(), sb.clone()
    kauto.auto_advance(itab, adv_k, tok)
    kauto.auto_advance_plain(itab, adv_p, tok)
    torch.cuda.synchronize()
    agree = {"walk_n40": torch.equal(walk_codes, walk_codes_plain) and torch.equal(sb, sb_plain),
             "mask": torch.equal(mask_k, mask_p), "advance": torch.equal(adv_k, adv_p)}
    say("phase18", check="beam_rows_kernel_vs_plain", rows=rows, **{f"{k}_identical": v for k, v in agree.items()})
    if not all(agree.values()):
        raise AssertionError(f"automaton at {rows} rows: the kernel differs from the plain version {agree}")
    t["mask"] = time_ms(lambda: kauto.auto_mask(itab, sb, T - 41))
    t["mask_plain"] = time_ms(lambda: kauto.auto_mask_plain(itab, sb, T - 41))
    t["advance"] = time_on_copies(lambda s: kauto.auto_advance(itab, s, tok), sb)
    t["advance_plain"] = time_on_copies(lambda s: kauto.auto_advance_plain(itab, s, tok), sb)
    say("phase18", automaton="auto_step per step", B=B, n1_launch_ms=f"{t['step_n1']:.5f}",
        n120_launch_ms_per_step=f"{t['step_n120']:.5f}", plain_ms=f"{t['step_plain']:.5f}",
        card=json.dumps(gpu))
    say("phase18", automaton="auto_mask, auto_advance", rows=rows, mask_ms=f"{t['mask']:.5f}",
        mask_plain_ms=f"{t['mask_plain']:.5f}", advance_ms=f"{t['advance']:.5f}",
        advance_plain_ms=f"{t['advance_plain']:.5f}", card=json.dumps(gpu))
    # each entry point's device time per launch (the n=1 event time above
    # also holds the wrapper's host cost per launch): launches queued behind
    # a sleep, and the profiler's kernel time; each call on copies made before
    pool_1 = [s0.clone() for _ in range(12)]
    pool_120 = [[s0.clone(), s0.clone()] for _ in range(12)]
    pool_adv = [sb.clone() for _ in range(12)]
    t["dev_step_n1"] = device_ms_per_launch(lambda: steps(kauto.auto_step)(pool_1.pop()), "auto_step", T)
    t["dev_step_n120"] = tuple(v / T if v else v for v in device_ms_per_launch(
        lambda: [kauto.auto_step(itab, s, scores, T - 1) for s in pool_120.pop()], "auto_step", 2))
    t["dev_mask"] = device_ms_per_launch(lambda: [kauto.auto_mask(itab, sb, T - 41) for _ in range(20)],
                                         "auto_mask", 20)
    t["dev_advance"] = device_ms_per_launch(
        lambda: [kauto.auto_advance(itab, s, tok) for s in [pool_adv.pop()] for _ in range(20)], "auto_advance", 20)

    def us(v):
        return "not_measured" if v is None else f"{v * 1e3:.3f}"

    for how, i in (("queued_launches", 0), ("profiler", 1)):
        say("phase18", automaton_device_time=how, B=B, rows=rows,
            auto_step_n1_us_per_launch=us(t["dev_step_n1"][i]), auto_step_n120_us_per_step=us(t["dev_step_n120"][i]),
            auto_mask_us_per_launch=us(t["dev_mask"][i]), auto_advance_us_per_launch=us(t["dev_advance"][i]),
            card=json.dumps(gpu))
    t["rows"], t["sb"], t["tok"] = rows, sb, tok
    prof = profile_step(lambda: generate(model, qcfg, z, constrained=True))
    parts = {}
    for name, ms in prof["device_ms"].items():
        parts[classify(name)] = parts.get(classify(name), 0.0) + ms
    busy = sum(parts.values())
    say("phase18", profiled="constrained_decode", wall_ms=f"{prof['wall_ms']:.3f}", device_busy_ms=f"{busy:.3f}",
        idle_share=f"{1 - busy / t['decode']:.4f}" if busy else "not measured",
        **{f"{k}_ms": f"{v:.3f}" for k, v in sorted(parts.items())})
    say_profile("phase18", prof, t["decode"])
    t["split"] = parts
    bprof = profile_step(lambda: beam_generate(model, qcfg, z, beam=BEAM, constrained=True))
    bparts = {}
    for name, ms in bprof["device_ms"].items():
        bparts[classify(name)] = bparts.get(classify(name), 0.0) + ms
    bbusy = sum(bparts.values())
    say("phase18", profiled="beam_decode", beam=BEAM, wall_ms=f"{bprof['wall_ms']:.3f}", device_busy_ms=f"{bbusy:.3f}",
        idle_share=f"{1 - bbusy / t['beam']:.4f}" if bbusy else "not measured",
        **{f"{k}_ms": f"{v:.3f}" for k, v in sorted(bparts.items())})
    return t


def library_times(cfg, s_args, dev, phase: str) -> dict:
    """One PyTorch call computing the same function as a kernel, timed as
    its yardstick and never called by the port: torch.nn.GRU (cuDNN) with
    the kernel's layers, sizes and dtype, forward and autograd backward;
    torch.matmul of the dW contraction's operands."""
    T, H, L = cfg.max_len, cfg.gru_hidden, cfg.gru_layers
    x0 = s_args[0]
    out = {}
    g = torch.Generator(device=dev).manual_seed(SEED + 20)

    def gru_pair(I, layers, dtype):
        # flatten_parameters takes no bf16: cuDNN compacts those weights per call
        gru = torch.nn.GRU(I, H, layers, device=dev, dtype=dtype)
        x = x0[..., :I].to(dtype) if I <= x0.shape[-1] else torch.randn(T, B, I, device=dev, dtype=dtype, generator=g)
        with torch.no_grad():
            fwd = time_ms(lambda: gru(x))
        xg = x.detach().clone().requires_grad_(True)
        y, _ = gru(xg)
        dy = torch.randn_like(y)
        inputs = [xg, *gru.parameters()]
        bwd = time_ms(lambda: torch.autograd.grad(y, inputs, dy, retain_graph=True))
        return fwd, bwd

    I0 = x0.shape[-1]
    out["stack"] = gru_pair(I0, L, torch.bfloat16) + ("bfloat16",)
    out["layer_bf16"] = gru_pair(I0, 1, torch.bfloat16) + ("bfloat16",)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out["layer_fp32"] = gru_pair(I0, 1, torch.float32) + ("float32",)
    # the stack's dW contraction: sum over (T, B) of x^T dgi and h^T dgh
    ops = [(torch.randn(T * B, i, device=dev, generator=g).to(torch.bfloat16),
            torch.randn(T * B, 3 * H, device=dev, generator=g).to(torch.bfloat16))
           for i in [I0, H] + [H, H] * (L - 1)]
    out["dw_stack"] = time_ms(lambda: [torch.matmul(a.T, d) for a, d in ops])
    out["dw_layer0"] = time_ms(lambda: [torch.matmul(a.T, d) for a, d in ops[:2]])
    for name, v in out.items():
        if isinstance(v, tuple):
            say(phase, library=f"torch.nn.GRU[{name}]", fwd_ms=f"{v[0]:.4f}", bwd_ms=f"{v[1]:.4f}", dtype=v[2])
        else:
            say(phase, library=f"torch.matmul[{name}]", ms=f"{v:.4f}")
    return out


# -- the design probes (phases 19-20) -------------------------------------------

# matmul_only times the serial chain over all 3H columns; were its z and n
# products dropped as dead code it would take about a third of full's time
MATMUL_ONLY_MIN_SHARE = 0.6


def phase19(dev) -> dict:
    """The probe kernels against their plain versions at full width (B=256,
    T=120, H=501, L=3) and at a ragged batch of 6, on the probe modules'
    inputs with a nonzero h0; floor_loop bit for bit; gru_layer_scan_x's
    forward at fwd_gi's I=330. Returns the probe modules' inputs, the errors and
    the plain versions' times."""
    g = gru_experiments.make_inputs(device=dev, seed=SEED + 19)
    p = proto_gi_kernel.make_inputs(device=dev, seed=SEED + 20)
    L_, H_ = g["L"], g["H"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    h0 = 0.1 * torch.randn(L_, B, H_, generator=gen, device=dev)
    l0 = g["layers"][0]
    err, plain = {}, {}
    with torch.no_grad():
        for rows in (B, 6):
            one = (g["gi"][:, :rows].contiguous(), l0["w_hh"], l0["b_hh"], h0[0, :rows].contiguous())
            stack = (g["gi"][:, :rows].contiguous(), *g["stack"], h0[:, :rows].contiguous())
            checks = [(f"gru_probe_scan[{m}]", m, lambda m=m: kgru.gru_probe_scan(*one, m),
                       lambda m=m: kgru.gru_probe_scan_ref(*one, m)) for m in kgru.PROBE_MODES]
            checks.append(("gru_fused3_scan", "fused3", lambda: kgru.gru_fused3_scan(*stack),
                           lambda: gru_stack.gru_fused3_scan_ref(*stack)))
            for name, key, kern, ref in checks:
                before = kgru.fused3_launches
                k, r = kern(), ref()
                torch.cuda.synchronize()
                e = max_abs(k, r)
                say("phase19", kernel=name, B=rows, T=g["T"], H=H_, hseq_max_abs_err=f"{e:.3e}",
                    hseq_bit_identical=f"{(k == r).float().mean().item():.6f}", tol=STACK_FWD_TOL)
                if not (torch.isfinite(k.float()).all() and k.shape == r.shape and e <= STACK_FWD_TOL):
                    raise AssertionError(f"{name} differs from its plain version by {e:.3e} at B={rows}")
                if key == "fused3":  # one wavefront launch a batch slice, and a second run bit for bit
                    plan = kgru.fused3_plan(rows, H_, L_, *gru_stack.plan_limits(dev))
                    twice = torch.equal(k, kern())
                    say("phase19", kernel=name, B=rows, plan=json.dumps(dataclasses.asdict(plan)).replace(" ", ""),
                        launches=kgru.fused3_launches - before, twice_bit_identical=twice)
                    if kgru.fused3_launches - before != 2 * plan.slices or not twice:
                        raise AssertionError(f"fused3 at B={rows}: {kgru.fused3_launches - before} launches for "
                                             f"two calls of {plan.slices} slices; twice identical {twice}")
                err[key] = max(err.get(key, 0.0), e)
                if rows == B:
                    plain[key] = time_ms(ref)
        # floor_loop: bit for bit at the probe's shapes, x near the int32 limits too
        for shape in auto_loop_probe.FLOOR_SHAPES:
            x = torch.randint(-64, 64, shape, dtype=torch.int32, generator=gen, device=dev)
            x.view(-1)[:2] = torch.tensor([2**31 - 1, -(2**31)], dtype=torch.int32, device=dev)
            for k_ops, chains in ((auto_loop_probe.FLOOR_K[0], auto_loop_probe.FLOOR_CHAINS), (13, 3), (13, 1),
                                  (13, 8)):
                same = torch.equal(kfloor.floor_loop(x, g["T"], k_ops, chains),
                                   kfloor.floor_loop_ref(x, g["T"], k_ops, chains))
                say("phase19", kernel="floor_loop", shape=json.dumps(shape), T=g["T"], k_ops=k_ops, chains=chains,
                    bit_identical=same)
                if not same:
                    raise AssertionError(f"floor_loop differs from its plain version at {shape}, k_ops={k_ops}")
        fx = torch.ones(auto_loop_probe.FLOOR_SHAPES[-1], dtype=torch.int32, device=dev)
        plain["floor"] = time_ms(lambda: kfloor.floor_loop_ref(fx, g["T"], auto_loop_probe.FLOOR_K[0]))
        # fwd_gi: gru_layer_scan_x's in-kernel bf16 forward at I=330, and a ragged batch
        lay = p["layers"][0]
        for rows in (B, 6):
            args = (p["x"][:, :rows].contiguous(), lay["w_ih"], lay["b_ih"], lay["w_hh"], lay["b_hh"],
                    h0[0, :rows].contiguous())
            k, r = kgru.layer_forward_in_kernel(*args, torch.bfloat16), kgru.layer_forward_ref(*args, torch.bfloat16)
            torch.cuda.synchronize()
            e = max_abs(k[0], r[0])
            say("phase19", kernel="gru_layer_scan_x_fwd[fwd_gi]", B=rows, I=p["I"], H=p["H"],
                hseq_max_abs_err=f"{e:.3e}", tol=STACK_FWD_TOL)
            if not e <= STACK_FWD_TOL:
                raise AssertionError(f"gru_layer_scan_x at I={p['I']} differs from its plain version by {e:.3e}")
            err["fwd_gi"] = max(err.get("fwd_gi", 0.0), e)
            # and its backward, the in-kernel sweep with the dx and dW GEMMs
            dY = 1e-2 * torch.randn(p["T"], rows, p["H"], generator=gen, device=dev)
            res = (*k, saved_x(args, torch.bfloat16), args[5], args[1], args[3])
            gk, gk2, gr = (kgru.layer_backward_in_kernel(res, dY), kgru.layer_backward_in_kernel(res, dY),
                           kgru.layer_backward_ref(res, dY))
            torch.cuda.synchronize()
            rel = max(rel_err(a, b) for a, b in zip(gk, gr))
            twice = all(torch.equal(a, b) for a, b in zip(gk, gk2))
            say("phase19", kernel="gru_layer_scan_x_in_kernel_bwd[fwd_gi]", B=rows, I=p["I"], H=p["H"],
                grad_max_rel_err=f"{rel:.3e}", rel_tol=STACK_BWD_REL, backward_twice_bit_identical=twice)
            if not (rel <= STACK_BWD_REL and twice):
                raise AssertionError(f"in-kernel backward at I={p['I']}: {rel:.3e} relative, twice identical {twice}")
            if rows == B:
                plain["fwd_gi"] = time_ms(lambda: kgru.layer_forward_ref(*args, torch.bfloat16))
    return {"g": g, "p": p, "err": err, "plain": plain}


# each probe module's probe run launches each of its kernels once; both
# 3-layer routes of gru_experiments a GEMM and a recurrence per layer; fwd_gi's
# counterpart, the in-kernel instance, once for one layer and 3 times for the stack
PROBE_LAUNCHES = {
    "gru_experiments": {"gru_probe_matmul_only": 1, "gru_probe_gates_nostore": 1, "gru_layer_scan_fwd": 1,
                        "gru_layer_gemm_gi": 3, "gru_layer_rec": 3, "gru_stack_gemm_gi": 3, "gru_stack_rec": 3,
                        "gru_fused3": 1},
    "proto_gi_kernel": {"gru_layer_scan_x_fwd": 4, "gru_layer_scan_fwd": 4},
    "auto_loop_probe": {"auto_step": 1, "floor_loop": 1},
}


def phase20(dev, g, p, ms_gen: float, gpu: str) -> dict:
    """The three probe modules: one probe run each with its launches
    counted, then their tables (molvax_torch/probes/)."""
    a = auto_loop_probe.make_inputs(device=dev, seed=SEED + 21)
    runs = {}
    for name, module, inp in (("gru_experiments", gru_experiments, g), ("proto_gi_kernel", proto_gi_kernel, p),
                              ("auto_loop_probe", auto_loop_probe, a)):
        reset_counts()
        out = module.probe(inp)
        torch.cuda.synchronize()
        got = counts()
        finite = all(torch.isfinite(v.float()).all().item() for v in out.values())
        say("phase20", probe_run=name, outputs_finite=finite, **{k: v for k, v in got.items() if v})
        if not finite or any(v != PROBE_LAUNCHES[name].get(k, 0) for k, v in got.items()):
            raise AssertionError(f"{name}: launch counts {got}, expected {PROBE_LAUNCHES[name]}; finite {finite}")
        runs[name] = got
    rows = {g["H"]: gru_experiments.measure(g)}
    g512 = gru_experiments.make_inputs(H=512, device=dev, seed=SEED + 19)
    rows[512] = gru_experiments.measure(g512)
    print(gpu, flush=True)
    for h, inp in ((g["H"], g), (512, g512)):
        gru_experiments.print_table(rows[h], inp)
        # the question run_fused3 asks: one launch of all layers against one a layer, same work, same call
        say("phase20", H=h, fused3_ms=f"{rows[h]['fused3']['ms']:.4f}",
            per_layer_same_work_ms=f"{rows[h]['per_layer_same']['ms']:.4f}",
            fused3_over_per_layer=f"{rows[h]['fused3']['ms'] / rows[h]['per_layer_same']['ms']:.4f}",
            fused3_slices=rows[h]["fused3"]["slices"])
    share = rows[g["H"]]["matmul_only"]["ms"] / rows[g["H"]]["full"]["ms"]
    sass = gru_experiments.sass_counts()
    say("phase20", matmul_only_over_full=f"{share:.4f}", min_share=MATMUL_ONLY_MIN_SHARE,
        sass_static_counts=json.dumps(sass).replace(" ", "") if sass else "not measured (no cuobjdump)")
    if not share >= MATMUL_ONLY_MIN_SHARE:
        raise AssertionError(f"matmul_only took {share:.3f} of full's time: its product lost columns")
    prow = proto_gi_kernel.measure(p)
    proto_gi_kernel.print_table(prow, p)
    arow = auto_loop_probe.measure(a, fused_ms=ms_gen, plain_steps=8)
    auto_loop_probe.print_table(arow, a)
    frows = auto_loop_probe.floor_measure(device=dev)
    auto_loop_probe.print_floor(frows)
    dep_ns = frows[auto_loop_probe.LATENCY_SHAPE]["ns_per_op"][-1]
    clock = sm_clock_mhz()
    # the event times above carry the wrapper's host cost; the device's own time of one launch
    fx = torch.ones(auto_loop_probe.FLOOR_SHAPES[-1], dtype=torch.int32, device=dev)
    floor_device_ms = queued_ms(lambda: kfloor.floor_loop(fx, g["T"], auto_loop_probe.FLOOR_K[0],
                                                          auto_loop_probe.FLOOR_CHAINS))
    say("phase20", floor_dependent_ns_per_op=f"{dep_ns:.4f}", sm_clock_max_mhz=clock,
        cycles_per_dependent_op=f"{dep_ns * clock / 1e3:.2f}" if clock else "not measured",
        floor_device_ms=f"{floor_device_ms:.5f}")
    # the one PyTorch call computing fwd_gi's function: cuDNN's one-layer bf16 GRU
    gru = torch.nn.GRU(p["I"], p["H"], 1, device=dev, dtype=torch.bfloat16)
    xb = p["x"].to(torch.bfloat16)
    with torch.no_grad():
        lib_fwd_gi = time_ms(lambda: gru(xb))
    say("phase20", library=f"torch.nn.GRU[one layer, I={p['I']}]", fwd_ms=f"{lib_fwd_gi:.4f}", dtype="bfloat16")
    return {"runs": runs, "rows": rows[g["H"]], "rows512": rows[512], "proto": prow, "auto": arow, "floor": frows,
            "floor_device_ms": floor_device_ms, "lib_fwd_gi": lib_fwd_gi}


def sm_clock_mhz():
    """The card's highest SM clock in MHz (nvidia-smi clocks.max.sm), or
    None where nvidia-smi does not report it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout.split()
    return int(out[0]) if out and out[0].isdigit() else None


def phase21(weights, codes, dev, gpu) -> dict:
    """One train step of zinc250k, zinc250k_quality, strict-fp32 zinc250k
    and a bf16 zinc250k step with the property head (n_properties=3, target
    stats, seeded targets) under torch.cuda.set_sync_debug_mode("error"):
    nothing on the step's path may block the host on the card (ROADMAP
    C 1). Each step is first taken once in the default mode (the property
    stats are made on the card then, once). Then each step's event ms and
    idle share (one profiled step), the step times to compare with the
    parent's from probes/stack_probe.py --root."""
    full = get_preset("zinc250k")
    prop = dataclasses.replace(full, name="zinc250k_properties", model=dataclasses.replace(
        full.model, n_properties=3, property_mean=(2.5, 0.6, 3.0), property_std=(1.5, 0.2, 0.9)))
    fp32 = dataclasses.replace(full, name="zinc250k_fp32", model=dataclasses.replace(full.model, compute_dtype="float32"))
    props = torch.from_numpy(np.random.default_rng(SEED + 13).standard_normal((B, 3)).astype(np.float32)).to(dev)
    out = {}
    for f in (full, get_preset("zinc250k_quality"), fp32, prop):
        step_fn = make_train_step(f)
        state = [init_state(f, device=dev, weights=None if f is prop else weights)]
        target = props if f is prop else None

        def one():
            state[0], metrics = step_fn(state[0], codes, target)
            return metrics

        one()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            metrics = one()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        loss = float(metrics["loss"])
        if not np.isfinite(loss) or (f is prop and "prop_mse" not in metrics):
            raise AssertionError(f"{f.name}: the step under sync debug mode gave loss {loss}")
        ms = time_ms(one)
        prof = profile_step(one)
        busy = sum(prof["device_ms"].values())
        out[f.name] = {"ms": ms, "device_busy_ms": busy, "idle_share": 1 - busy / ms if busy else None}
        say("phase21", train_step=f.name, sync_debug_mode="error", host_syncs=0, loss=f"{loss:.4f}", ms=f"{ms:.4f}",
            device_busy_ms=f"{busy:.3f}", idle_share=f"{1 - busy / ms:.4f}" if busy else "not measured",
            card=json.dumps(gpu))
    return out


# -- the chunk (phase 22) ---------------------------------------------------------


def state_diffs(a, b) -> dict:
    """Largest absolute and relative-norm differences of two train states:
    weights, Adam moments and step counts, EMA."""
    out = {}

    def put(kind, x, y):
        d = (x.float() - y.float()).abs().max().item() if x.numel() else 0.0
        rel = ((x.float() - y.float()).norm() / x.float().norm().clamp_min(1e-30)).item()
        a_max, r_max = out.get(kind, (0.0, 0.0))
        out[kind] = (max(a_max, d), max(r_max, rel))

    for p, q in zip(a.params.parameters(), b.params.parameters()):
        put("weights", p.detach(), q.detach())
        sa, sb = a.opt_state.adam.state[p], b.opt_state.adam.state[q]
        put("adam_moments", torch.stack([sa["exp_avg"], sa["exp_avg_sq"]]), torch.stack([sb["exp_avg"], sb["exp_avg_sq"]]))
        put("adam_steps", sa["step"], sb["step"])
    for name in a.ema_params or {}:
        put("ema", a.ema_params[name], b.ema_params[name])
    return out


def metric_diffs(per_step: list, stacked: dict) -> tuple:
    """(largest absolute, largest relative-norm) difference of the stacked
    metrics of a chunk and of per-step metrics."""
    pairs = [(torch.stack([m[k] for m in per_step]).float(), stacked[k].float()) for k in stacked]
    return (max((x - y).abs().max().item() for x, y in pairs),
            max(((x - y).norm() / x.norm().clamp_min(1e-30)).item() for x, y in pairs))


def eager_run(step, base, stack, props) -> tuple:
    """16 eager steps from a deep copy of ``base``: (state, per-step
    metrics, per-step gradients by parameter name)."""
    s = copy.deepcopy(base)
    per_step, grads = [], []
    for i in range(CHUNK):
        s, m = step(s, stack[i], None if props is None else props[i])
        per_step.append(m)
        grads.append({n: p.grad.clone() for n, p in s.params.named_parameters() if p.grad is not None})
    return s, per_step, grads


def first_nondeterministic(grads_a: list, grads_b: list) -> tuple:
    """(step, parameter names) of the first step whose gradients differ
    between two eager runs from one state on one stack; the weights before
    it are equal (Adam and the EMA are deterministic), so these are the
    gradients that a library kernel of the step computes in a varying
    order. (None, []) where every step agrees."""
    for i, (ga, gb) in enumerate(zip(grads_a, grads_b)):
        names = [n for n in ga if not torch.equal(ga[n], gb[n])]
        if names:
            return i, names
    return None, []


def replay_kernels(eager_step, chunk_fn, n_metrics: int, attempts: int = 3) -> dict:
    """Device activity of one chunk call against 16 times that of one
    eager step, by name (torch.profiler): every kernel and memset of the
    step must be in the replay 16 times, and the replay adds only the
    stacking of its n_metrics metrics. Copies are left out (an eager step
    copies its values, the chunk its stack and values once; a graph's copy
    nodes run as "memcpy32" kernels), and so are annotations (names the
    host side has too); memsets count under one name. The profiler can
    lose a kernel at a session's edge, so each count is that of a session
    of two calls less that of one call; up to ``attempts`` rounds run
    until the counts agree."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def session(fn, calls):
        torch.cuda.synchronize()
        # device activity and the CUDA runtime's calls, not torch's host ops
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        host = {e.key: e.count for e in events if e.device_type != DeviceType.CUDA}
        dev = {}
        for e in events:
            if e.device_type != DeviceType.CUDA or e.key in host or e.key.lower().startswith("memcpy"):
                continue
            # a graph's memset nodes run as kernels ("memset32") that the profiler names apart
            key = "memset" if e.key.lower().startswith("memset") else e.key
            dev[key] = dev.get(key, 0) + e.count
        return dev, host

    def per_call(fn):
        (d1, h1), (d2, h2) = session(fn, 1), session(fn, 2)
        return ({k: d2.get(k, 0) - d1.get(k, 0) for k in set(d1) | set(d2)},
                h2.get("cudaGraphLaunch", 0) - h1.get("cudaGraphLaunch", 0))

    def split(counts, times=1):
        stacks = sum(n for k, n in counts.items() if "CatArrayBatchedCopy" in k)
        return stacks * times, {k: n * times for k, n in counts.items() if n and "CatArrayBatchedCopy" not in k}

    for _ in range(attempts):
        (eager, _), (chunk, graphs) = per_call(eager_step), per_call(chunk_fn)
        (e_stacks, e_rest), (c_stacks, c_rest) = split(eager, CHUNK), split(chunk)
        equal = bool(e_rest) and e_rest == c_rest and c_stacks - e_stacks == n_metrics
        if equal:
            break
    ours = sum(n for k, n in c_rest.items()
               if re.search(r"(fused_encode|fused_sample_kl|gemm|gru_rec|gru_sweep|sum_parts)_kernel", k))
    return {"equal": equal, "eager": eager, "chunk": chunk, "graph_launches": graphs, "our_kernels": ours,
            "device_activities": sum(chunk.values()), "eager_device_activities": sum(eager.values())}


def corpus(dev_phase: str):
    """The reference's benchmark corpus, synthetic_dataset(4096,
    max_len=120, seed=0), with its tokenizer path and seconds."""
    t0 = time.perf_counter()
    ds = synthetic_dataset(4096, max_len=120, seed=0)
    say(dev_phase, corpus="synthetic_dataset(4096, max_len=120, seed=0)", shape=list(ds.codes.shape),
        dtype=str(ds.codes.dtype), tokenizer="native" if tokenizer.native_available() else "numpy",
        seconds=f"{time.perf_counter() - t0:.3f}")
    return ds


def strict_fp32(preset):
    """``preset`` with strict fp32 matmuls (the per-layer fp32 kernels, the
    plain encoder and sampler)."""
    return dataclasses.replace(preset, name=f"{preset.name}_fp32",
                               model=dataclasses.replace(preset.model, compute_dtype="float32"))


def phase22(dev, gpu, ds) -> dict:
    """The reference's headline training path on the card: the synthetic
    corpus, BatchIterator.next_stack(16), a K=16 chunk (one CUDA Graph),
    at zinc250k, zinc250k_quality, moses_scaled width (B=256), the
    property_joint preset with EMA and strict-fp32 zinc250k (the plain
    sampler path); each against 16 eager steps from the same
    state on the same stack, then the next stack and replay under sync
    debug mode "error", the graph's kernels, memory and times."""
    t0 = time.perf_counter()
    chem = synthetic_dataset(4096, max_len=120, seed=0, chem=True, with_properties=True)
    say("phase22", corpus="synthetic_dataset(4096, max_len=120, seed=0, chem=True, with_properties=True)",
        properties=list(chem.properties.shape), seconds=f"{time.perf_counter() - t0:.3f}")
    prop = get_preset("property_joint")
    prop = dataclasses.replace(prop, name="property_joint_ema", train=dataclasses.replace(prop.train, ema_decay=0.999))
    out = {}
    for preset, data in ((get_preset("zinc250k"), ds), (get_preset("zinc250k_quality"), ds),
                         (get_preset("moses_scaled"), ds), (prop, chem), (strict_fp32(get_preset("zinc250k")), ds)):
        out[preset.name] = chunk_case(dev, gpu, preset, data)
    return out


def chunk_case(dev, gpu, preset, data) -> dict:
    """One case of phase 22: a K=16 chunk of ``preset`` on the first
    stacks of ``data`` against 16 eager steps, its replay under sync debug
    mode "error", its device activity, times and memory. Strict fp32 must
    be deterministic (bit for bit), as the bf16 cases are."""
    cfg = effective_config(preset, data)
    with_props = cfg.model.n_properties > 0
    it = BatchIterator(data, B, seed=0, device=dev, with_properties=with_props)
    stack, props = it.next_stack(CHUNK)
    if stack.shape != (CHUNK, B, cfg.model.max_len) or stack.dtype != torch.uint8 or stack.device != dev:
        raise AssertionError(f"next_stack gave {tuple(stack.shape)} {stack.dtype} on {stack.device}")
    step, chunk = make_train_step(cfg), make_train_chunk(cfg, CHUNK)
    base = init_state(cfg, seed=SEED, device=dev)
    t_case = time.perf_counter()
    runs = [eager_run(step, base, stack, props) for _ in range(2)]
    c = copy.deepcopy(base)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    c, stacked = chunk(c, stack, props)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    captured_counts = {k: v for k, v in counts().items() if v}
    captured = chunk.graphs[c.params]
    peak_gb = (torch.cuda.max_memory_allocated() - held_before) / 1e9
    held_gb = (torch.cuda.memory_allocated() - held_before) / 1e9
    (a, a_steps, a_grads), (b, b_steps, b_grads) = runs
    b_stacked = {k: torch.stack([m[k] for m in b_steps]) for k in b_steps[0]}
    eager_twice = {**state_diffs(a, b), "metrics": metric_diffs(a_steps, b_stacked)}
    chunk_vs = {**state_diffs(a, c), "metrics": metric_diffs(a_steps, stacked)}
    deterministic = all(v[0] == 0.0 for v in eager_twice.values())
    first, named = first_nondeterministic(a_grads, b_grads)
    del a_grads, b_grads
    say("phase22", preset=cfg.name, K=CHUNK, B=B, capture_s=f"{captured.capture_seconds:.3f}",
        first_call_s=f"{first_s:.3f}", launches_at_capture=json.dumps(captured_counts).replace(" ", ""),
        graph_peak_GB=f"{peak_gb:.3f}", graph_held_GB=f"{held_gb:.3f}", card=json.dumps(gpu))
    say("phase22", preset=cfg.name, eager_twice_max_abs=json.dumps({k: v[0] for k, v in eager_twice.items()}),
        chunk_vs_eager_max_abs=json.dumps({k: v[0] for k, v in chunk_vs.items()}),
        chunk_vs_eager_max_rel=json.dumps({k: v[1] for k, v in chunk_vs.items()}),
        deterministic=deterministic, first_differing_step=first, nondeterministic_gradients=json.dumps(named))
    if not deterministic and cfg.model.compute_dtype == "float32":
        raise AssertionError(f"{cfg.name}: two eager strict-fp32 runs differ at step {first} in {named}")
    if deterministic:
        if any(v[0] for v in chunk_vs.values()):
            raise AssertionError(f"{cfg.name}: the chunk differs from 16 eager steps: {chunk_vs}")
    else:
        if not named:
            raise AssertionError(f"{cfg.name}: two eager runs differ, but no step's gradients: {eager_twice}")
        bad = {k: v for k, v in chunk_vs.items() if not v[1] <= CHUNK_REL}
        if bad or chunk_vs["adam_steps"][0]:
            raise AssertionError(f"{cfg.name}: the chunk differs from 16 eager steps by {chunk_vs}")
    # the next chunk's host work and replay under sync debug mode "error"
    versions = [p._version for p in c.params.parameters()]
    torch.cuda.set_sync_debug_mode("error")
    try:
        stack2, props2 = it.next_stack(CHUNK)
        c, stacked2 = chunk(c, stack2, props2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    losses = stacked2["loss"].tolist()
    if not all(np.isfinite(losses)) or c.step != 2 * CHUNK:
        raise AssertionError(f"{cfg.name}: the replay under sync debug mode gave {losses} at step {c.step}")
    # what is keyed by a weight's version (the decode's packed weights) must see a replay's update
    if not all(p._version > v for p, v in zip(c.params.parameters(), versions)):
        raise AssertionError(f"{cfg.name}: a replay left the weights' version counters where they were")

    def eager_step(i=0):
        nonlocal a
        a, _ = step(a, stack[i], None if props is None else props[i])

    def eager_steps():
        for i in range(CHUNK):
            eager_step(i)

    def chunk_call():
        nonlocal c
        c, _ = chunk(c, stack, props)

    t_parts = {"compare": time.perf_counter() - t_case}
    t0 = time.perf_counter()
    kern = replay_kernels(eager_step, chunk_call, len(stacked2))
    t_parts["kernels"] = time.perf_counter() - t0
    if not kern["equal"] or kern["graph_launches"] not in (0, 1) or not kern["our_kernels"]:
        raise AssertionError(f"{cfg.name}: a replay's device activity {kern['chunk']} is not 16 times that of "
                             f"an eager step {kern['eager']} (graph launches {kern['graph_launches']})")
    t0 = time.perf_counter()
    ms_eager, ms_chunk = time_ms(eager_steps) / CHUNK, time_ms(chunk_call) / CHUNK
    t1 = time.perf_counter()
    it.next_stack(CHUNK)  # the host's part of a stack: gather, wait on its buffer's event, queue the copy
    stack_ms = (time.perf_counter() - t1) * 1e3
    prof = profile_step(chunk_call)
    busy = sum(prof["device_ms"].values()) / CHUNK
    t_parts["times"] = time.perf_counter() - t0
    out = {"ms_eager": ms_eager, "ms_chunk": ms_chunk, "busy": busy, "stack_ms": stack_ms,
           "capture_s": captured.capture_seconds, "peak_gb": peak_gb, "deterministic": deterministic}
    say("phase22", preset=cfg.name, replay="sync_debug_mode=error", host_syncs=0,
        loss=json.dumps([round(x, 4) for x in losses[:3]]), graph_launches_per_chunk=kern["graph_launches"],
        our_kernels_per_chunk=kern["our_kernels"], our_kernels_per_step=kern["our_kernels"] / CHUNK,
        device_activities_per_chunk=kern["device_activities"],
        eager_device_activities_per_step=kern["eager_device_activities"])
    say("phase22", preset=cfg.name, eager_ms_per_step=f"{ms_eager:.4f}", chunk_ms_per_step=f"{ms_chunk:.4f}",
        chunk_smiles_per_s=f"{B / (ms_chunk / 1e3):.1f}", eager_smiles_per_s=f"{B / (ms_eager / 1e3):.1f}",
        next_stack_host_ms=f"{stack_ms:.3f}", device_busy_ms_per_step=f"{busy:.3f}",
        idle_share=f"{1 - busy / ms_chunk:.4f}" if busy else "not measured", card=json.dumps(gpu))
    say("phase22", preset=cfg.name, seconds=json.dumps({k: round(v, 2) for k, v in t_parts.items()}))
    del a, b, c, base, runs, stacked, stacked2, b_stacked, chunk, step
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


# -- train() (phase 23) and the latent workloads (phase 24) ---------------------


def payload_diffs(a: dict, b: dict, parts=("params", "adam", "ema"), counters=("step", "base_seed", "count")) -> dict:
    """Counters and tensors of two checkpoint payloads (io.checkpoint)
    that differ: {what: largest absolute difference, or the two values}."""
    out = {k: (a[k], b[k]) for k in counters if a[k] != b[k]}

    def walk(x, y, where):
        if isinstance(x, dict) or isinstance(y, dict):
            if not (isinstance(x, dict) and isinstance(y, dict)) or set(x) != set(y):
                out[where] = "structure"
                return
            for k in x:
                walk(x[k], y[k], f"{where}.{k}")
        elif x is None or y is None:
            if (x is None) != (y is None):
                out[where] = "None against a tensor"
        elif x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
            out[where] = (x.float() - y.float()).abs().max().item() if x.shape == y.shape else "shape"

    for part in parts:
        walk(a[part], b[part], part)
    return out


def load_payload(directory: str, step: int) -> dict:
    return torch.load(os.path.join(directory, str(step), "state.pt"), map_location="cpu", weights_only=True)


def disk_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


def host_ms(fn, reps: int = 3) -> float:
    """Median host ms of fn() ending in a device synchronisation."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def phase23(dev, gpu, ds, p22: dict) -> dict:
    """train() at zinc250k_quality's full width (B=256, T=120, 3 x
    GRU-501) on the corpus: 69 steps (4 chunks of 16, 5 single steps), log
    every 16, eval every 32 (2 batches and the round-trip probe on 256
    rows, or the held-out split's), select_best, a checkpoint every 32.
    Run U goes straight to 69; run S stops at max_steps=32 and a fresh
    train() resumes it in the same directory. S's final checkpoint, its
    history after step 32, best/'s weights, EMA and step, and probe.json
    must equal U's bit for bit; a restore into a live model must decode as
    a fresh model holding the same weights; U's launches are counted
    exactly. Then the timings, and a throughput run: train() at zinc250k,
    256 steps, log every 16, no eval and no checkpoint, against phase 22's
    replay of the same config."""
    import shutil
    import tempfile

    from molvax_torch.io import checkpoint as ckpt
    from molvax_torch.train import train
    from molvax_torch.train.evaluate import reconstruction_metrics

    qual = get_preset("zinc250k_quality")
    root = tempfile.mkdtemp(prefix="molvax_phase23_")
    out = {}
    try:
        def cfg_in(name):
            return dataclasses.replace(qual, train=dataclasses.replace(
                qual.train, steps=69, log_every=16, eval_every=32, eval_batches=2, eval_roundtrip_n=256,
                select_best=True, checkpoint_every=32, checkpoint_dir=os.path.join(root, name)))

        u_cfg, s_cfg = cfg_in("U"), cfg_in("S")
        reset_counts()
        t0 = time.perf_counter()
        u_state, u_hist = train(u_cfg, ds, verbose=False)
        torch.cuda.synchronize()
        u_s = time.perf_counter() - t0
        u_counts = counts()
        s1_state, s1_hist = train(s_cfg, ds, max_steps=32, verbose=False)
        prof = {}

        def resume():
            prof["result"] = train(s_cfg, ds, verbose=False)

        busy = profile_step(resume)
        s_state, s_hist = prof["result"]
        s_busy = sum(busy["device_ms"].values())
        # the launches of run U: the chunk's capture (16 steps and the
        # warm-up step), the 5 single steps, 2 evals of 2 batches, and the
        # probe at steps 32, 64 and 69 (the final iterate), n rows each
        L, H = qual.model.gru_layers, qual.model.gru_hidden
        n_eval = len(ds.split(qual.data.test_fraction, qual.data.seed)[1])
        n_probe = min(256, n_eval)
        plan = kg.generate_plan(n_probe, qual.model.charset_size, H, L, *kg.card_limits(dev))
        per_step = {"fused_encode": 1, "fused_sample_kl": 1,
                    **model_layer_launches(qual.model, torch.bfloat16, 2, 1)}
        per_eval = {"fused_encode": 1, "fused_sample_kl": 1,
                    **model_layer_launches(qual.model, torch.bfloat16, 1, 0)}
        want = {k: (CHUNK + 1 + 5) * per_step.get(k, 0) + 4 * per_eval.get(k, 0) for k in u_counts}
        want["fused_generate"] = want["fused_generate_persistent"] = 3 * plan.slices
        say("phase23", run="U", preset=qual.name, steps=69, seconds=f"{u_s:.2f}", eval_rows=n_eval,
            probe_rows=n_probe, launches=json.dumps({k: v for k, v in u_counts.items() if v}).replace(" ", ""))
        if u_counts != want:
            raise AssertionError(f"train(): launch counts {u_counts}, expected {want}")
        # the final checkpoint, the history after the split, best/ and probe.json
        final = payload_diffs(load_payload(u_cfg.train.checkpoint_dir, 69), load_payload(s_cfg.train.checkpoint_dir, 69))

        def strip(rows):
            return [{k: v for k, v in r.items() if k != "wall_s"} for r in rows]

        u_after = strip([r for r in u_hist if r["step"] > 32])
        hist_equal = u_after == strip(s_hist) and strip(s1_hist) == strip([r for r in u_hist if r["step"] <= 32])
        best_dirs = [os.path.join(c.train.checkpoint_dir, "best") for c in (u_cfg, s_cfg)]
        probes = [json.load(open(os.path.join(d, "probe.json"))) for d in best_dirs]
        best_step = probes[0]["step"]
        best_pay = [load_payload(d, best_step) for d in best_dirs]
        # best/ holds the winner's weights and EMA at its step; its Adam state
        # and count are those of the run that wrote it (as the reference's)
        best_diff = payload_diffs(*best_pay, parts=("params", "ema"), counters=("step", "base_seed"))
        best_adam_equal = not payload_diffs(*best_pay, parts=("adam",), counters=("count",))
        say("phase23", run="S", resumed_at=32, final_checkpoint_differences=json.dumps(final),
            history_rows_after_32=len(u_after), history_equal=hist_equal, probe_json=json.dumps(probes[0]),
            probe_json_equal=probes[0] == probes[1], best_differences=json.dumps(best_diff),
            best_adam_state_equal=best_adam_equal, returned_steps=[u_state.step, s_state.step])
        for a, b in zip(u_after + strip([r for r in u_hist if r["step"] <= 32]), strip(s_hist) + strip(s1_hist)):
            if a != b:
                say("phase23", differing_row_u=json.dumps(a), differing_row_s=json.dumps(b))
        if final or not hist_equal or probes[0] != probes[1] or best_diff or u_state.step != s_state.step:
            raise AssertionError("the resumed run differs from the uninterrupted one")
        for r in u_hist:
            if not all(np.isfinite(v) for k, v in r.items() if k != "step"):
                raise AssertionError(f"train(): a non-finite metric in {r}")
        # a restore into a live model: the decode reads the restored weights
        u_mgr, s_mgr = (ckpt.make_manager(c.train.checkpoint_dir, c.train.keep_checkpoints) for c in (u_cfg, s_cfg))
        z_codes = torch.from_numpy(ds.codes[:B]).to(dev)
        with torch.no_grad():
            z = encode(u_state.params, qual.model, z_codes)[0]
        # a step whose weights the live model (U's selected iterate) does not hold
        other = next(x for x in (64, 32, 69) if x != best_step)
        before = generate(u_state.params, qual.model, z)[0]
        packed_key = kg._packed[u_state.params][0]
        ptrs = [p.data_ptr() for p in u_state.params.parameters()]
        live = s_mgr.restore(other, u_state)
        after = generate(live.params, qual.model, z)[0]
        repacked = kg._packed[live.params][0] != packed_key
        fresh = s_mgr.restore(other, init_state(qual, device=dev))
        want_codes = generate(fresh.params, qual.model, z)[0]
        same_ptrs = ptrs == [p.data_ptr() for p in live.params.parameters()]
        say("phase23", check="restore_into_live_model", step=other, same_addresses=same_ptrs,
            packed_weights_rebuilt=repacked, decode_equals_fresh_model=bool(torch.equal(after, want_codes)),
            decode_changed_by_restore=not bool(torch.equal(before, after)))
        if not (same_ptrs and repacked and torch.equal(after, want_codes)):
            raise AssertionError("after a restore into a live model the decode does not read the restored weights")
        # times: the loop, an eval pass, the probe, a save and a restore
        rows = {r["step"]: r["wall_s"] for r in u_hist if "loss" in r}
        ev_it = BatchIterator(ds, B, seed=1, device=dev)
        eval_step = make_eval_step(qual)
        batches = [next(ev_it) for _ in range(2)]
        eval_ms = host_ms(lambda: [eval_step(live, c, p_) for c, p_ in batches])
        gen = torch.Generator().manual_seed(SEED)
        probe_ms = host_ms(lambda: reconstruction_metrics(live.params, qual, ds, gen, n=n_probe))
        t_mgr = ckpt.make_manager(os.path.join(root, "timing"), keep=1)
        save_ms = host_ms(lambda: t_mgr.save(69, live, force=True))
        restore_ms = host_ms(lambda: t_mgr.restore(69, live))
        nbytes = disk_bytes(os.path.join(u_cfg.train.checkpoint_dir, "69"))
        loop_ms = (rows[64] - rows[16]) / 48 * 1e3  # 3 chunks, with the eval and checkpoint at 32
        chunk_ms = (rows[64] - rows[48]) / 16 * 1e3  # one chunk, its next_stack and its host pull
        out["quality"] = {"seconds": u_s, "loop_ms_per_step": loop_ms, "chunk_ms_per_step": chunk_ms,
                          "eval_ms": eval_ms, "probe_ms": probe_ms,
                          "save_ms": save_ms, "restore_ms": restore_ms, "checkpoint_bytes": nbytes,
                          "resume_device_busy_ms": s_busy, "resume_wall_ms": busy["wall_ms"]}
        say("phase23", preset=qual.name, loop_ms_per_step_16_to_64=f"{loop_ms:.4f}",
            loop_ms_per_step_48_to_64=f"{chunk_ms:.4f}",
            eval_pass_ms=f"{eval_ms:.3f}", probe_ms=f"{probe_ms:.3f}", probe_rows=n_probe,
            checkpoint_save_ms=f"{save_ms:.3f}", checkpoint_restore_ms=f"{restore_ms:.3f}",
            checkpoint_bytes=nbytes, resumed_run_wall_ms=f"{busy['wall_ms']:.1f}",
            resumed_run_device_busy_ms=f"{s_busy:.1f}",
            resumed_run_idle_share=f"{1 - s_busy / busy['wall_ms']:.4f}" if s_busy else "not measured",
            card=json.dumps(gpu))
        del u_state, s1_state, s_state, live, fresh
        # the throughput run
        fast = get_preset("zinc250k")
        fast = dataclasses.replace(fast, train=dataclasses.replace(fast.train, steps=256, log_every=16, eval_every=0,
                                                                   checkpoint_dir=None))
        t0 = time.perf_counter()
        state, hist = train(fast, ds, verbose=False)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        walls = {r["step"]: r["wall_s"] for r in hist}
        ms = (walls[256] - walls[16]) / 240 * 1e3
        replay_ms = p22["zinc250k"]["ms_chunk"]
        out["throughput"] = {"ms_per_step": ms, "replay_ms_per_step": replay_ms, "seconds": total_s}
        say("phase23", run="throughput", preset=fast.name, steps=256, seconds=f"{total_s:.2f}",
            ms_per_step_16_to_256=f"{ms:.4f}", smiles_per_s=f"{B / (ms / 1e3):.1f}",
            phase22_replay_ms_per_step=f"{replay_ms:.4f}", phase22_smiles_per_s=f"{B / (replay_ms / 1e3):.1f}",
            train_over_replay=f"{ms / replay_ms:.4f}", card=json.dumps(gpu))
        if state.step != 256 or len(hist) != 16:
            raise AssertionError(f"the throughput run ended at step {state.step} with {len(hist)} rows")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def margin_gap(model, cfg, z: torch.Tensor, codes: torch.Tensor) -> float:
    """The largest gap between the plain decode's maximum score and the
    score of the chosen code, replaying ``codes`` through the plain
    version of fused_generate (greedy)."""
    with torch.no_grad():
        z_emb = latent_embed(model, cfg, z)
    _, scores = kg.fused_generate_ref(model, cfg, z_emb, 0, greedy=True, force_codes=codes, return_scores=True)
    chosen = scores.gather(-1, codes.long()[..., None])[..., 0]
    return (scores.max(-1).values - chosen).max().item()


def phase24(dev, gpu, model, ds) -> dict:
    """The latent workloads at zinc250k width (phase 2's weights; a seeded
    property_joint model for the optimization), each held to its plain
    route: encode_corpus of 1,000 SMILES (a tail chunk of 232) against one
    plain encode; decode_latents greedy (the persistent decode, every code
    within MARGIN of the plain maximum), constrained (auto_step, 100%
    chem-valid) and beam 5 constrained (auto_mask / auto_advance) on 256
    latents, the automaton routes against their plain versions bit for
    bit; interpolate (8 steps, slerp); optimize_from_smiles (16 steps of
    optimize_z on the property head, against the same steps on the CPU,
    constrained decode); fit_aggregate_posterior and sample_aggregate."""
    from molvax_torch.latent import (decode_latents, encode_corpus, fit_aggregate_posterior, interpolate,
                                     optimize_from_smiles, optimize_z, sample_aggregate, slerp)

    cfg = model.cfg
    out = {}
    smiles = decode_codes(ds.codes[:1000])
    reset_counts()
    t0 = time.perf_counter()
    mu, logvar = encode_corpus(model, cfg, smiles, batch=B)
    torch.cuda.synchronize()
    enc_ms = (time.perf_counter() - t0) * 1e3
    with torch.no_grad():
        mu_one, lv_one = encode(model, cfg, torch.from_numpy(encode_smiles(smiles, DEFAULT_CHARSET, cfg.max_len)).to(dev))
    enc_err = max(np.abs(mu - mu_one.cpu().numpy()).max(), np.abs(logvar - lv_one.cpu().numpy()).max())
    say("phase24", call="encode_corpus", n=len(smiles), batch=B, tail=len(smiles) % B, shape=list(mu.shape),
        ms=f"{enc_ms:.2f}", max_abs_err_vs_one_call=f"{enc_err:.3e}", tol=ENCODER_TOL, **{"fused_encode": counts()["fused_encode"]})
    if mu.shape != (1000, cfg.latent_dim) or not np.isfinite(mu).all() or not enc_err <= ENCODER_TOL:
        raise AssertionError(f"encode_corpus: {mu.shape}, error {enc_err}")
    z = torch.from_numpy(mu[:B]).to(dev)
    # greedy: one persistent decode, every code within MARGIN of the plain maximum
    reset_counts()
    strings = decode_latents(model, cfg, mu[:B])
    got = counts()
    codes = kg.fused_generate(model, cfg, latent_embed(model, cfg, z), 0)
    gap = margin_gap(model, cfg, z, codes)
    same = strings == decode_codes(codes)
    ms = time_ms(lambda: decode_latents(model, cfg, mu[:B]))
    say("phase24", call="decode_latents", mode="greedy", n=B, persistent_launches=got["fused_generate_persistent"],
        strings_equal_kernel_codes=same, max_margin_gap=f"{gap:.3e}", margin=MARGIN, ms=f"{ms:.3f}",
        smiles_per_s=f"{B / (ms / 1e3):.1f}", card=json.dumps(gpu))
    if got["fused_generate_persistent"] != 1 or got["fused_generate_row_block"] or not same or gap > MARGIN:
        raise AssertionError(f"decode_latents greedy: launches {got}, equal {same}, gap {gap}")
    out["greedy_ms"] = ms
    # constrained greedy and beam 5, against the plain automaton
    for mode, kw, want in (("constrained", dict(constrained=True), {"auto_step": cfg.max_len}),
                           ("beam5_constrained", dict(constrained=True, beam=BEAM),
                            {"auto_mask": cfg.max_len, "auto_advance": cfg.max_len})):
        reset_counts()
        strings = decode_latents(model, cfg, mu[:B], **kw)
        got = counts()
        with plain_automaton():
            plain = decode_latents(model, cfg, mu[:B], **kw)
        valid = sum(chem_valid(x) for x in strings)
        ms = time_ms(lambda: decode_latents(model, cfg, mu[:B], **kw), warmup=1, reps=3)
        say("phase24", call="decode_latents", mode=mode, n=B, chem_valid=f"{valid}/{len(strings)}",
            identical_to_plain_route=strings == plain, ms=f"{ms:.3f}", smiles_per_s=f"{B / (ms / 1e3):.1f}",
            **{k: got[k] for k in ("auto_step", "auto_mask", "auto_advance", "fused_generate")}, card=json.dumps(gpu))
        if valid != B or strings != plain or any(got[k] != want.get(k, 0) for k in want) or got["fused_generate"]:
            raise AssertionError(f"decode_latents {mode}: {valid}/{B} valid, launches {got}")
        out[f"{mode}_ms"] = ms
    # interpolate: 8 slerp waypoints between two molecules, one persistent decode
    reset_counts()
    path = interpolate(model, cfg, SMILES[0], SMILES[200], steps=8)
    got = counts()
    ends = torch.from_numpy(encode_smiles([SMILES[0], SMILES[200]], DEFAULT_CHARSET, cfg.max_len)).to(dev)
    with torch.no_grad():
        m2 = encode(model, cfg, ends)[0]
    zs = slerp(m2[:1], m2[1:], torch.linspace(0.0, 1.0, 8, device=dev)[:, None])
    codes = kg.fused_generate(model, cfg, latent_embed(model, cfg, zs), 0)
    gap = margin_gap(model, cfg, zs, codes)
    say("phase24", call="interpolate", steps=8, spherical=True, persistent_launches=got["fused_generate_persistent"],
        strings_equal_kernel_codes=path == decode_codes(codes), max_margin_gap=f"{gap:.3e}",
        examples=json.dumps(path[:3]))
    if got["fused_generate_persistent"] != 1 or path != decode_codes(codes) or gap > MARGIN:
        raise AssertionError(f"interpolate: launches {got}, gap {gap}")
    # optimize_from_smiles on the property head: 16 steps, then a constrained decode
    pcfg = get_preset("property_joint").model
    pmodel = init_state(get_preset("property_joint"), seed=SEED + 24, device=dev).params
    reset_counts()
    t0 = time.perf_counter()
    opt_strings, res = optimize_from_smiles(pmodel, pcfg, SMILES, steps=16, constrained=True)
    torch.cuda.synchronize()
    opt_ms = (time.perf_counter() - t0) * 1e3
    got = counts()
    cpu_model = copy.deepcopy(pmodel).cpu()
    with torch.no_grad():
        z0 = encode(pmodel, pcfg, torch.from_numpy(encode_smiles(SMILES, DEFAULT_CHARSET, pcfg.max_len)).to(dev))[0]
    ref = optimize_z(cpu_model, pcfg, z0.cpu(), steps=16)
    traj_rel = ((res.trajectory.cpu() - ref.trajectory).norm() / ref.trajectory.norm()).item()
    z_rel = ((res.z.cpu() - ref.z).norm() / ref.z.norm()).item()
    valid = sum(chem_valid(x) for x in opt_strings)
    rise = (res.objective - res.objective_start).mean().item()
    say("phase24", call="optimize_from_smiles", preset="property_joint", steps=16, n=len(SMILES),
        objective_start=f"{res.objective_start.mean().item():.4f}", objective=f"{res.objective.mean().item():.4f}",
        mean_rise=f"{rise:.4f}", trajectory_rel_vs_cpu=f"{traj_rel:.3e}", z_rel_vs_cpu=f"{z_rel:.3e}",
        tol=FP32_ROUTE_REL, chem_valid=f"{valid}/{len(opt_strings)}", auto_step=got["auto_step"], ms=f"{opt_ms:.2f}")
    if not (traj_rel <= FP32_ROUTE_REL and z_rel <= FP32_ROUTE_REL) or valid != len(SMILES) or not rise > 0:
        raise AssertionError(f"optimize_from_smiles: rel {traj_rel}, {z_rel}; {valid} valid; rise {rise}")
    # the aggregate posterior and a decode from it
    mean, chol = fit_aggregate_posterior(model, cfg, ds.codes[:1000], batch=B)
    mean_err = (mean.cpu().double() - torch.from_numpy(mu).double().mean(0)).abs().max().item()
    reset_counts()
    agg = sample_aggregate(model, cfg, B, torch.Generator().manual_seed(SEED + 25), mean, chol)
    got = counts()
    g = torch.Generator().manual_seed(SEED + 25)
    za = mean[None, :] + torch.randn(B, cfg.latent_dim, generator=g).to(dev) @ chol.T
    codes = kg.fused_generate(model, cfg, latent_embed(model, cfg, za), 0)
    gap = margin_gap(model, cfg, za, codes)
    lower = bool(torch.equal(chol, torch.tril(chol)))
    say("phase24", call="fit_aggregate_posterior", rows=1000, mean_max_abs_err_vs_encode_corpus=f"{mean_err:.3e}",
        chol_lower_triangular=lower)
    say("phase24", call="sample_aggregate", n=B, persistent_launches=got["fused_generate_persistent"],
        strings_equal_kernel_codes=agg == decode_codes(codes), max_margin_gap=f"{gap:.3e}",
        distinct=len(set(agg)))
    if not (mean_err <= 1e-5 and lower and torch.isfinite(chol).all()) or agg != decode_codes(codes) or gap > MARGIN:
        raise AssertionError(f"aggregate posterior: mean error {mean_err}, gap {gap}")
    return out


# -- evaluate() (phase 25) and the CLI (phase 26) --------------------------------

EVAL_METRICS = ("teacher_forced_metrics", "generation_metrics", "constrained_generation_metrics",
                "reconstruction_metrics", "beam_reconstruction_metrics", "posterior_prior_metrics",
                "interpolation_metrics", "aggregate_generation_metrics", "optimization_metrics",
                "temperature_sweep")
# the deterministic metrics, kernel route against plain route: greedy decodes
# differ from the plain version's at near-ties in ~1% of positions, so string
# rates within 0.02 absolute and per-character accuracies within 0.01; the
# posterior's statistics within 1e-3 relative; the teacher-forced metrics
# within ROUTE_REL relative (the bf16 route gate)
EVAL_RATE_TOL = 0.02
EVAL_CHAR_TOL = 0.01
EVAL_POST_REL = 1e-3


def eval_module():
    import importlib

    return importlib.import_module("molvax_torch.train.evaluate")  # the package's name is the function's


@contextlib.contextmanager
def metric_calls(profiled: bool):
    """Each metric function that evaluate() calls, wrapped where evaluate()
    finds it: its launches (counts() before and after), its wall ms (host
    clock, ending in a sync) and, ``profiled``, the device-busy ms of its
    own torch.profiler session. A metric called by another (the sweep's
    generation_metrics) counts in its caller. Yields {name: [record]}."""
    ev = eval_module()
    saved = {n: getattr(ev, n) for n in EVAL_METRICS}
    calls = {n: [] for n in EVAL_METRICS}
    inside = [False]

    def wrap(name, fn):
        def call(*a, **kw):
            if inside[0]:
                return fn(*a, **kw)
            inside[0] = True
            try:
                torch.cuda.synchronize()
                before = counts()
                if profiled:
                    box = {}
                    prof = profile_step(lambda: box.update(out=fn(*a, **kw)))
                    out, wall, busy = box["out"], prof["wall_ms"], sum(prof["device_ms"].values())
                else:
                    t0 = time.perf_counter()
                    out = fn(*a, **kw)
                    torch.cuda.synchronize()
                    wall, busy = (time.perf_counter() - t0) * 1e3, None
                after = counts()
                calls[name].append({"ms": wall, "busy_ms": busy,
                                    "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]}})
                return out
            finally:
                inside[0] = False

        return call

    for n, fn in saved.items():
        setattr(ev, n, wrap(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(ev, n, fn)


@contextlib.contextmanager
def plain_eval_route():
    """plain_route() and plain_automaton(), and the generation kernel's
    plain version in its wrapper's place."""
    saved = kg.fused_generate
    kg.fused_generate = kg.fused_generate_ref
    try:
        with plain_route(), plain_automaton():
            yield
    finally:
        kg.fused_generate = saved


def decode_launches(n: int, mcfg, dev) -> dict:
    """One decode of n rows: the persistent instance, once a slice of its plan."""
    plan = kg.generate_plan(n, mcfg.charset_size, mcfg.gru_hidden, mcfg.gru_layers, *kg.card_limits(dev))
    if plan is None:
        raise AssertionError(f"no persistent plan for a decode of {n} rows")
    return {"fused_generate": plan.slices, "fused_generate_persistent": plan.slices}


def eval_batch_launches(mcfg, rows: int) -> dict:
    """One teacher-forced eval batch of ``rows`` rows: the encoder and the
    sampler, and the decoder's GRU forward on its route (per layer the
    input-gate GEMM and, per batch slice, the recurrence)."""
    out = {"fused_encode": 1, "fused_sample_kl": 1}
    if mcfg.gru_kernel == "per_layer":
        for l in range(mcfg.gru_layers):
            I = decoder_input_size(mcfg) if l == 0 else mcfg.gru_hidden
            for k, v in layer_launches(torch.bfloat16, rows, I, mcfg.gru_hidden, 1, 0).items():
                if v:
                    out[k] = out.get(k, 0) + v
    else:
        n = gru_stack.stack_plan(rows, mcfg.gru_hidden, *gru_stack.card_limits(DEVICE), esize=2).slices
        out.update(gru_stack_gemm_gi=mcfg.gru_layers, gru_stack_rec=n * mcfg.gru_layers)
    return out


def check_eval_report(report: dict, what: str, **flags) -> None:
    """evaluate()'s keys for these flags (tests/test_torch_eval_keys.py,
    held there to the reference's), finite values, fractions in [0, 1],
    the constrained decodes all chemically valid."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from test_torch_eval_keys import is_fraction, report_keys

    want = report_keys(**flags)
    if set(report) != want:
        raise AssertionError(f"{what}: keys differ from the reference's: {sorted(set(report) ^ want)}")
    bad = {k: v for k, v in report.items() if not np.isfinite(v) or (is_fraction(k) and not 0.0 <= v <= 1.0)}
    bad.update({k: report[k] for k in ("con_chem_valid", "opt_con_chem_valid") if k in report and report[k] != 1.0})
    if bad:
        raise AssertionError(f"{what}: values out of range {bad}")


def phase25(dev, gpu, ds) -> dict:
    """evaluate() at zinc250k_quality's full width (3 x GRU-501, latent
    292, T=120, the per-layer bf16 route) with EMA 0.999: a state trained
    by train() for 64 steps on the training split of phase 22's corpus,
    scored on its held-out split with train_dataset= the training split,
    beam=5 and the temperature sweep. Run A: the report's keys and ranges,
    each metric function's exact launches and wall ms. Run B (the whole
    report under the profiler) and run C (each metric under its own
    profiler session): the same report bit for bit, and the idle shares.
    The deterministic metrics against the plain route. Then one evaluate()
    of a property_joint state (EMA 0.999, 32 steps on a chem corpus, the
    target stats backfilled), for optimization_metrics' two variants."""
    from molvax_torch.train import ema_eval_state, evaluate, train

    ev = eval_module()
    out = {}
    qual = get_preset("zinc250k_quality")
    qual = dataclasses.replace(qual, name="zinc250k_quality_ema", train=dataclasses.replace(
        qual.train, ema_decay=0.999, eval_every=0, eval_roundtrip_n=0, select_best=False, log_every=16))
    mcfg, T = qual.model, qual.model.max_len
    train_ds, held = ds.split(qual.data.test_fraction, qual.data.seed)
    t0 = time.perf_counter()
    state, _ = train(qual, train_ds, max_steps=64, verbose=False)
    torch.cuda.synchronize()
    say("phase25", preset=qual.name, trained_steps=state.step, train_s=f"{time.perf_counter() - t0:.2f}",
        train_rows=len(train_ds), held_out_rows=len(held), ema=state.ema_params is not None)
    flags = dict(beam=BEAM, sweep_temperatures=True)

    def report_of():
        return evaluate(state, qual, held, train_dataset=train_ds, **flags)

    with metric_calls(False) as calls:
        t0 = time.perf_counter()
        report = report_of()
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t0) * 1e3
    check_eval_report(report, "evaluate(zinc250k_quality)", **flags)
    rows = min(len(held), qual.train.batch_size)
    n_pairs = min(64, len(held) // 2)
    want = {
        "teacher_forced_metrics": {k: 8 * v for k, v in eval_batch_launches(mcfg, rows).items()},
        "generation_metrics": decode_launches(1000, mcfg, dev),
        "constrained_generation_metrics": {"auto_step": T},
        "reconstruction_metrics": decode_launches(min(256, len(held)), mcfg, dev),
        "beam_reconstruction_metrics": {},  # unconstrained, as the reference's: torch ops a step
        "posterior_prior_metrics": {},  # the inference encode is the plain encoder, as the reference's
        "interpolation_metrics": decode_launches(n_pairs * 9, mcfg, dev),
        "aggregate_generation_metrics": decode_launches(1000, mcfg, dev),
        "temperature_sweep": {k: 4 * v for k, v in decode_launches(500, mcfg, dev).items()},
    }
    got = {n: [c["launches"] for c in calls[n]] for n in EVAL_METRICS}
    for name in EVAL_METRICS:
        say("phase25", metric=name, calls=len(calls[name]),
            launches=json.dumps(got[name][0] if got[name] else {}).replace(" ", ""),
            ms=f"{calls[name][0]['ms']:.2f}" if calls[name] else "-")
    bad = {n: (got[n], [w]) for n, w in want.items() if got[n] != [w]}
    if bad or got["optimization_metrics"]:
        raise AssertionError(f"evaluate(): launches by metric {bad}, optimization {got['optimization_metrics']}")
    # runs B and C: the same report, bit for bit, and where the device idles
    box = {}
    whole = profile_step(lambda: box.update(r=report_of()))
    whole_busy = sum(whole["device_ms"].values())
    with metric_calls(True) as prof_calls:
        report_c = report_of()
    same = {"B": box["r"] == report, "C": report_c == report}
    say("phase25", check="same_seed_reports_identical", run_B=same["B"], run_C=same["C"],
        differing=json.dumps(sorted(k for k in report if box["r"][k] != report[k] or report_c[k] != report[k])))
    if not all(same.values()):
        raise AssertionError("two evaluate() calls with the same seed gave different reports")
    idle = {}
    for name in EVAL_METRICS:
        if prof_calls[name]:
            c = prof_calls[name][0]
            idle[name] = 1 - c["busy_ms"] / c["ms"] if c["busy_ms"] else None
            wall = calls[name][0]["ms"]
            say("phase25", metric=name, wall_ms=f"{wall:.2f}", profiled_wall_ms=f"{c['ms']:.2f}",
                device_busy_ms=f"{c['busy_ms']:.3f}",
                idle_share=f"{idle[name]:.4f}" if idle[name] is not None else "not measured",
                idle_share_of_unprofiled_wall=f"{1 - c['busy_ms'] / wall:.4f}" if c["busy_ms"] else "not measured",
                card=json.dumps(gpu))
    say("phase25", report="evaluate(beam=5, sweep_temperatures=True)", keys=len(report), wall_ms=f"{total_ms:.1f}",
        profiled_wall_ms=f"{whole['wall_ms']:.1f}", device_busy_ms=f"{whole_busy:.1f}",
        idle_share=f"{1 - whole_busy / whole['wall_ms']:.4f}" if whole_busy else "not measured",
        idle_share_of_unprofiled_wall=f"{1 - whole_busy / total_ms:.4f}" if whole_busy else "not measured",
        card=json.dumps(gpu))
    say("phase25", report_values=json.dumps({k: round(v, 5) for k, v in sorted(report.items())}))
    out["quality"] = {"total_ms": total_ms, "by_metric_ms": {n: c[0]["ms"] for n, c in calls.items() if c},
                      "idle": idle, "whole_idle": 1 - whole_busy / whole["wall_ms"] if whole_busy else None}
    # the deterministic metrics on the plain route (the same derived generator for the pairs)
    g4 = ev.split_generator(torch.Generator().manual_seed(0), 7, dev)[3]
    ema = ema_eval_state(state)
    t0 = time.perf_counter()
    with plain_eval_route():
        plain = ev.teacher_forced_metrics(ema, qual, held)
        plain.update(ev.reconstruction_metrics(ema.params, qual, held, None))
        plain.update(ev.beam_reconstruction_metrics(ema.params, qual, held, beam=BEAM))
        plain.update(ev.posterior_prior_metrics(ema.params, qual, held))
        plain.update(ev.interpolation_metrics(ema.params, qual, held, g4, n_pairs=n_pairs))
    gaps, over = {}, {}
    for k, v in plain.items():
        if k.startswith("post_") and k != "post_std_batch":
            gap, tol = abs(report[k] - v) / max(abs(v), 1e-12), EVAL_POST_REL
        elif k in ("acc", "acc_nonpad") or "char" in k:
            gap, tol = abs(report[k] - v), EVAL_CHAR_TOL
        elif k.startswith(("recon_", "interp_")):
            gap, tol = abs(report[k] - v), EVAL_RATE_TOL
        else:  # the teacher-forced loss and its parts
            gap, tol = abs(report[k] - v) / max(abs(v), 1e-12), ROUTE_REL
        gaps[k] = gap
        if gap > tol:
            over[k] = (report[k], v, tol)
    say("phase25", check="deterministic_metrics_kernel_vs_plain_route", plain_route_s=f"{time.perf_counter() - t0:.2f}",
        gaps=json.dumps({k: float(f"{g:.3e}") for k, g in gaps.items()}),
        tolerances=json.dumps({"rates": EVAL_RATE_TOL, "char": EVAL_CHAR_TOL, "posterior_rel": EVAL_POST_REL,
                               "teacher_forced_rel": ROUTE_REL}))
    if over:
        raise AssertionError(f"evaluate(): kernel route against plain route {over}")
    # a property_joint state: optimization_metrics with both variants
    t0 = time.perf_counter()
    chem = synthetic_dataset(1024, max_len=120, seed=0, chem=True, with_properties=True)
    prop = get_preset("property_joint")
    prop = dataclasses.replace(prop, name="property_joint_ema", train=dataclasses.replace(
        prop.train, ema_decay=0.999, log_every=16))
    p_train, p_held = chem.split(prop.data.test_fraction, prop.data.seed)
    p_state, _ = train(prop, p_train, max_steps=32, verbose=False)
    torch.cuda.synchronize()
    corpus_s = time.perf_counter() - t0
    with metric_calls(False) as p_calls:
        t0 = time.perf_counter()
        p_report = evaluate(p_state, prop, p_held, train_dataset=p_train)  # cfg without stats: backfilled
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
    check_eval_report(p_report, "evaluate(property_joint)", n_properties=prop.model.n_properties)
    n_opt = min(64, len(p_held))
    dec = decode_launches(n_opt, prop.model, dev)
    # the two constrained decodes share a key; were the second to capture its
    # graph (latent.sample), the step that runs before the capture would
    # launch auto_step once more
    want_opt = {**{k: 2 * v for k, v in dec.items()}, "auto_step": 2 * T + (ls._CAPTURE_AT_CALL == 2)}
    got_opt = [c["launches"] for c in p_calls["optimization_metrics"]]
    say("phase25", preset=prop.name, trained_steps=p_state.step, corpus_and_train_s=f"{corpus_s:.2f}",
        held_out_rows=len(p_held), optimization_launches=json.dumps(got_opt).replace(" ", ""),
        opt_keys=json.dumps({k: round(v, 4) for k, v in p_report.items() if k.startswith("opt_")}),
        wall_ms=f"{p_ms:.1f}", optimization_ms=f"{p_calls['optimization_metrics'][0]['ms']:.1f}",
        card=json.dumps(gpu))
    if got_opt != [want_opt]:
        raise AssertionError(f"optimization_metrics: launches {got_opt}, expected {want_opt}")
    out["property"] = {"wall_ms": p_ms, "optimization_ms": p_calls["optimization_metrics"][0]["ms"]}
    return out


def phase26(dev, gpu) -> dict:
    """The CLI on the card, through molvax_torch.cli.main in this process:
    train (zinc250k_quality 64 steps with eval, checkpoints, EMA and best/;
    property_joint 32 steps), presets, sample (plain, sampled, aggregate,
    constrained), reconstruct (greedy, beam 5 constrained), interpolate
    (plain, constrained), evaluate --holdout, encode, decode (greedy, beam
    5), optimize --constrained, and the two refusals; each command's lines,
    launches and wall ms. reconstruct equals a decode by the EMA weights of
    best/ bit for bit, decode of encode's file equals reconstruct. Then one
    python3 -m molvax_torch.cli sample in a child process."""
    import io
    import shutil
    import tempfile

    from molvax_torch import cli
    from molvax_torch.config import from_dict
    from molvax_torch.data.charset import Charset
    from molvax_torch.io.checkpoint import CheckpointManager

    root = tempfile.mkdtemp(prefix="molvax_phase26_")
    qdir, pdir = os.path.join(root, "quality"), os.path.join(root, "property")
    times = {}

    def run(name, argv, n_lines):
        stdout, stderr = io.StringIO(), io.StringIO()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        lines, got = stdout.getvalue().splitlines(), counts()
        say("phase26", command=name, rc=rc, lines=len(lines), ms=f"{ms:.1f}",
            launches=json.dumps({k: v for k, v in got.items() if v}).replace(" ", ""), card=json.dumps(gpu))
        if rc != 0 or len(lines) != n_lines:
            raise AssertionError(f"{name}: rc {rc}, {len(lines)} lines, expected {n_lines}: {stderr.getvalue()[-2000:]}")
        times[name] = ms
        return lines, stderr.getvalue(), got

    def refused(name, argv, match):
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            try:
                cli.main(argv)
            except SystemExit as e:
                say("phase26", command=name, refused=json.dumps(str(e)))
                if match not in str(e):
                    raise AssertionError(f"{name}: refused with {e!r}") from e
                return
        raise AssertionError(f"{name}: not refused")

    def over(*pairs):
        return [x for p in pairs for x in ("--override", p)]

    try:
        mcfg, T = get_preset("zinc250k_quality").model, get_preset("zinc250k_quality").model.max_len
        run("train zinc250k_quality", ["train", "--preset", "zinc250k_quality", "--steps", "64", "--quiet",
                                       "--metrics", os.path.join(root, "q.jsonl")] + over(
            f"train.checkpoint_dir={qdir}", "train.eval_every=32", "train.checkpoint_every=32",
            "train.ema_decay=0.999", "data.n_synthetic=4096"), 1)
        evals = [r for r in map(json.loads, open(os.path.join(root, "q.jsonl"))) if "eval_recon_exact" in r]
        best_step = CheckpointManager(os.path.join(qdir, "best")).latest_step()
        top_step = CheckpointManager(qdir).latest_step()
        say("phase26", eval_rows=len(evals), best_step=best_step, top_step=top_step)
        if len(evals) != 2 or best_step is None or top_step != 64:
            raise AssertionError(f"train: {len(evals)} eval rows, best/ step {best_step}, top step {top_step}")
        run("train property_joint", ["train", "--preset", "property_joint", "--steps", "32", "--quiet"] + over(
            f"train.checkpoint_dir={pdir}", "train.ema_decay=0.999", "data.n_synthetic=1024"), 1)
        run("presets", ["presets"], len(cli.PRESETS))
        q = ["--ckpt", qdir]
        dec256 = decode_launches(B, mcfg, dev)
        for name, extra, n in (("sample", [], B), ("sample --stochastic --temperature 0.7",
                                                   ["--stochastic", "--temperature", "0.7"], B),
                               ("sample --aggregate", ["--aggregate"], B)):
            _, _, got = run(name, ["sample"] + q + ["-n", str(n)] + extra, n)
            if any(got[k] != v for k, v in dec256.items()) or got["fused_generate_row_block"]:
                raise AssertionError(f"{name}: launches {got}, expected {dec256}")
        lines, err, got = run("sample --constrained", ["sample"] + q + ["-n", "64", "--constrained"], 64)
        if got["auto_step"] != T or "# chem-valid: 100.00%" not in err:
            raise AssertionError(f"sample --constrained: auto_step {got['auto_step']}, {err[-300:]}")
        recon, err, got = run("reconstruct", ["reconstruct"] + q + SMILES, B)
        if any(got[k] != v for k, v in dec256.items()):
            raise AssertionError(f"reconstruct: launches {got}")
        # the strings of a decode by best/'s EMA weights, made here
        cfg = from_dict(json.load(open(os.path.join(qdir, "config.json"))))
        charset = Charset(chars=tuple(json.load(open(os.path.join(qdir, "charset.json")))))
        payload = load_payload(os.path.join(qdir, "best"), best_step)
        ema_model = init_state(cfg, device=dev, weights=payload["ema"]).params
        raw_model = init_state(cfg, device=dev, weights=payload["params"]).params
        want = reconstruct(ema_model, cfg.model, SMILES, torch.Generator().manual_seed(0), charset=charset)
        raw = reconstruct(raw_model, cfg.model, SMILES, torch.Generator().manual_seed(0), charset=charset)
        got_strings = [line.split("\t")[1] for line in recon]
        say("phase26", check="reconstruct_is_best_ema_decode", equal=got_strings == want,
            differs_from_raw_weights=got_strings != raw, best_dir_served="using best-checkpoint selection dir" in err)
        if got_strings != want or [line.split("\t")[0] for line in recon] != SMILES:
            raise AssertionError("reconstruct did not serve best/'s EMA weights")
        _, _, got = run("reconstruct --beam 5 --constrained", ["reconstruct"] + q + ["--beam", "5", "--constrained"]
                        + SMILES, B)
        if got["auto_mask"] != T or got["auto_advance"] != T:
            raise AssertionError(f"beam 5 constrained: launches {got}")
        run("interpolate -n 9", ["interpolate"] + q + [SMILES[0], SMILES[200], "-n", "9"], 9)
        path, _, _ = run("interpolate -n 9 --constrained", ["interpolate"] + q + [SMILES[0], SMILES[200], "-n", "9",
                                                                              "--constrained"], 9)
        if not all(chem_valid(x) for x in path):
            raise AssertionError(f"interpolate --constrained: {path}")
        lines, _, got = run("evaluate --holdout --beam 5 --n-prior 256", ["evaluate"] + q + [
            "--holdout", "--beam", "5", "--n-prior", "256"], 1)
        check_eval_report(json.loads(lines[0]), "evaluate command", beam=BEAM)
        if got["fused_encode"] != 8 or got["fused_generate_persistent"] == 0 or got["fused_generate_row_block"]:
            raise AssertionError(f"evaluate: launches {got}")
        smi, npz = os.path.join(root, "in.smi"), os.path.join(root, "lat.npz")
        with open(smi, "w") as f:
            f.write("smiles\n" + "\n".join(SMILES) + "\n")
        _, err, got = run("encode --in --out", ["encode"] + q + ["--in", smi, "--out", npz], 0)
        if got["fused_encode"] or f"mu/logvar ({B}, {mcfg.latent_dim})" not in err:
            raise AssertionError(f"encode: {err[-300:]}, launches {got}")  # the plain encoder, as the reference's
        decoded, _, got = run("decode", ["decode"] + q + ["--in", npz], B)
        if decoded != got_strings or any(got[k] != v for k, v in dec256.items()):
            raise AssertionError(f"decode of encode's file differs from reconstruct ({got})")
        run("decode --beam 5", ["decode"] + q + ["--in", npz, "--beam", "5"], B)
        lines, _, got = run("optimize --constrained", ["optimize", "--ckpt", pdir, "--constrained"] + SMILES[:16], 16)
        if not all(chem_valid(line.split("\t")[1]) for line in lines) or got["auto_step"] != T:
            raise AssertionError(f"optimize --constrained: {lines[:3]}, launches {got}")
        refused("sample, no checkpoint", ["sample", "--ckpt", os.path.join(root, "missing")], "no checkpoint found")
        refused("optimize, no property head", ["optimize"] + q + ["CCO"], "no property head")
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "molvax"))
        say("phase26", check="no_jax_or_reference_module", leaked=json.dumps(leaked))
        if leaked:
            raise AssertionError(f"the CLI pulled in {leaked}")
        here = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, "-m", "molvax_torch.cli", "sample", "--ckpt", qdir, "-n", "4"],
                               cwd=here, env=dict(os.environ, PYTHONPATH=here), capture_output=True, text=True,
                               timeout=600)
        child_s = time.perf_counter() - t0
        say("phase26", command="python3 -m molvax_torch.cli sample -n 4 (child process)", rc=child.returncode,
            lines=len(child.stdout.splitlines()), s=f"{child_s:.2f}", card=json.dumps(gpu))
        if child.returncode != 0 or len(child.stdout.splitlines()) != 4:
            raise AssertionError(f"python3 -m molvax_torch.cli: rc {child.returncode}: {child.stderr[-2000:]}")
        times["child sample -n 4 (s)"] = child_s
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return times


# -- data parallelism (phase 27) --------------------------------------------------

DP_RANKS = 2  # gloo ranks on the one card (NCCL refuses two ranks on one device)
DP_GRAD_REL = STACK_BWD_REL  # the bf16 gradient gate: ||dp - one|| / ||one|| per gradient
DP_METRIC_REL = 1e-3
DP_DIR = os.path.join("build", "phase27")
DP_WARNING = ("[molvax] configured mesh 8x1 unusable here (devices=1, batch=256); using an auto 1-device data "
              "mesh")


@contextlib.contextmanager
def recorded_grads(seen: list):
    """``Optimizer.update`` keeps a copy of the gradients it is handed
    (after the data-parallel all-reduce) in ``seen``, one list a step."""
    from molvax_torch.train.loop import Optimizer

    real = Optimizer.update

    def update(self, lr):
        seen.append([None if p.grad is None else p.grad.detach().clone() for p in self.params])
        return real(self, lr)

    Optimizer.update = update
    try:
        yield seen
    finally:
        Optimizer.update = real


def fresh_dir(*parts) -> str:
    import shutil

    path = os.path.join(DP_DIR, *parts)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def row_base_checks(model, codes, dev, gpu) -> dict:
    """Phase 27 (d): the sampler and both decode instances at row_base 0 on
    the B=256 rows and at row_base 128 on rows 128-255, each against its
    plain version at the same row base (the sampler within SAMPLER_REL, a
    decode's codes within MARGIN of the plain maximum, its identical
    share), and the call at row_base 128 equal to the B=256 call's rows
    128-255 bit for bit, kernel and plain version alike."""
    cfg, half = model.cfg, B // 2
    with torch.no_grad():
        mu, lv = encode(model, cfg, codes)
    seed_t = torch.full((), SEED + 27, dtype=torch.int32, device=dev)
    out = {"sampler": {}, "persistent": {}, "row_block": {}}
    calls = {}
    with torch.no_grad():
        for rb in (0, half):
            m, l = mu[rb:].contiguous(), lv[rb:].contiguous()
            calls[rb] = (*sampler._sample_kernel(seed_t, m, l, cfg.eps_scale, rb),
                         *sampler.fused_sample_kl_ref(seed_t, m, l, cfg.eps_scale, rb))
    torch.cuda.synchronize()
    for rb, (zk, klk, zr, klr) in calls.items():
        z_rel, kl_rel = max_abs(zk, zr) / zr.abs().max().item(), max_abs(klk, klr) / klr.abs().max().item()
        out["sampler"][rb] = {"z_rel_err": z_rel, "kl_rel_err": kl_rel, "max_abs_err": max(max_abs(zk, zr),
                                                                                          max_abs(klk, klr))}
        say("phase27", check="d", kernel="fused_sample_kl", row_base=rb, rows=zk.shape[0], z_rel_err=f"{z_rel:.3e}",
            kl_rel_err=f"{kl_rel:.3e}", z_bit_identical=f"{(zk == zr).float().mean().item():.6f}",
            rel_tol=SAMPLER_REL)
        if not (z_rel <= SAMPLER_REL and kl_rel <= SAMPLER_REL):
            raise AssertionError(f"sampler at row_base {rb}: z {z_rel:.3e}, kl {kl_rel:.3e}")
    full, part = calls[0], calls[half]
    rows_k = torch.equal(part[0], full[0][half:]) and torch.equal(part[1], full[1][half:])
    rows_r = torch.equal(part[2], full[2][half:]) and torch.equal(part[3], full[3][half:])
    out["sampler"]["rows_bit_for_bit"] = rows_k and rows_r
    say("phase27", check="d", kernel="fused_sample_kl", row_base128_equals_B256_rows_128_255_kernel=rows_k,
        plain=rows_r)
    if not (rows_k and rows_r):
        raise AssertionError("the sampler at row_base 128 is not the B=256 call's rows 128-255")

    rng = np.random.default_rng(SEED + 27)
    z = torch.from_numpy(rng.standard_normal((B, cfg.latent_dim)).astype(np.float32)).to(dev)
    with torch.no_grad():
        z_emb = latent_embed(model, cfg, z)
    if kg.generate_plan(half, cfg.charset_size, cfg.gru_hidden, cfg.gru_layers, *kg.card_limits(dev)) is None:
        raise AssertionError("no persistent plan at zinc250k width, B=128")
    seed = SEED + 27
    for instance in ("persistent", "row_block"):
        got = {}
        for rb in (0, half):
            zpart = z_emb[rb:]
            before = (kg.persistent_launches, kg.row_block_launches)
            codes_k = kg._decode(model, cfg, zpart, seed, False, 0.7, row_block=instance == "row_block", row_base=rb)
            codes_r, scores = kg.fused_generate_ref(model, cfg, zpart, seed, greedy=False, temperature=0.7,
                                                    force_codes=codes_k, return_scores=True, row_base=rb)
            plain = kg.fused_generate_ref(model, cfg, zpart, seed, greedy=False, temperature=0.7, row_base=rb)
            torch.cuda.synchronize()
            launched = (kg.persistent_launches - before[0], kg.row_block_launches - before[1])
            want = (1, 0) if instance == "persistent" else (0, 1)
            chosen = scores.gather(-1, codes_k.long()[..., None])[..., 0]
            gap = (scores.max(-1).values - chosen).max().item()
            same = (codes_k == plain).float().mean().item()
            out[instance][rb] = {"max_margin_gap": gap, "identical_codes": same}
            say("phase27", check="d", kernel="fused_generate", instance=instance, row_base=rb, rows=zpart.shape[0],
                mode="sampled_T0.7", launches=json.dumps(dict(zip(("persistent", "row_block"), launched))),
                identical_codes=f"{same:.6f}", max_margin_gap=f"{gap:.3e}", margin=MARGIN)
            if launched != want or gap > MARGIN:
                raise AssertionError(f"{instance} decode at row_base {rb}: launches {launched}, gap {gap:.3e}")
            got[rb] = codes_k
        rows = torch.equal(got[half], got[0][half:])
        out[instance]["rows_bit_for_bit"] = rows
        say("phase27", check="d", kernel="fused_generate", instance=instance,
            row_base128_equals_B256_rows_128_255=rows)
        if not rows:
            raise AssertionError(f"the {instance} decode at row_base 128 is not the B=256 decode's rows 128-255")
    return out


def _profile_counts(fn) -> dict:
    """(device ms, launches) by kernel name over one call of ``fn``, with
    torch.profiler; empty where it records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        ms, n = out.get(ev.key, (0.0, 0))
        out[ev.key] = (ms + dev_us / 1e3, n + ev.count)
    return out


def nccl_world_checks(dev, gpu, ds) -> dict:
    """Phase 27 (a) and (b), in this process, in an NCCL world of one rank
    (the card's machine holds one card; NCCL refuses two ranks on one
    device): (a) the K=16 zinc250k chunk over the 1-rank mesh, its
    gradients' all-reduce captured in the graph, against the no-mesh chunk
    from the same weights on the same stack, bit for bit; per-step times of
    both (no mesh, mesh, mesh, no mesh) and the all-reduce's device time a
    step; (b) train() at moses_scaled width with its per-chip batch of 256
    (data_axis left at 8): the reference's warning, an auto 1-rank mesh,
    chunked steps, ms a step and the bytes reduced a step."""
    import io

    import torch.distributed as dist

    from molvax_torch.parallel import make_mesh, replicate
    from molvax_torch.train import train

    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")  # before a collective is captured
    store = fresh_dir("nccl")
    dist.init_process_group("nccl", init_method=f"file://{os.path.abspath(store)}/store", world_size=1, rank=0)
    out = {}
    try:
        mesh = make_mesh(device=dev)
        backend = dist.get_backend(mesh.group)
        say("phase27", check="a", world=dist.get_world_size(), backend=backend, mesh=json.dumps(mesh.shape),
            device=str(mesh.device), nccl_version=".".join(map(str, torch.cuda.nccl.version())))
        if not (mesh.collective and backend == "nccl" and mesh.size == 1 and mesh.device == dev):
            raise AssertionError(f"the NCCL world's mesh is {mesh} on {backend}")
        cfg = effective_config(get_preset("zinc250k"), ds)
        stack, _ = BatchIterator(ds, B, seed=0, device=dev).next_stack(CHUNK)
        base = init_state(cfg, seed=SEED, device=dev)
        plain_chunk, mesh_chunk = make_train_chunk(cfg, CHUNK, device=dev), make_train_chunk(cfg, CHUNK, mesh=mesh)
        a, b = copy.deepcopy(base), replicate(mesh, copy.deepcopy(base))
        a, ma = plain_chunk(a, stack, None)
        # each all-reduce call, and whether a graph was being captured
        reduces, real_all_reduce = [], dist.all_reduce

        def all_reduce(tensor, *args, **kw):
            reduces.append(torch.cuda.is_current_stream_capturing())
            return real_all_reduce(tensor, *args, **kw)

        dist.all_reduce = all_reduce
        try:
            reset_counts()
            b, mb = mesh_chunk(b, stack, None)
            torch.cuda.synchronize()
            launches = {k: v for k, v in counts().items() if v}
            diffs = state_diffs(a, b)
            mdiff = max((ma[k].float() - mb[k].float()).abs().max().item() for k in ma)
            bit = all(v[0] == 0.0 for v in diffs.values()) and mdiff == 0.0 and ma.keys() == mb.keys()
            at_capture = list(reduces)
            b, _ = mesh_chunk(b, stack, None)
            torch.cuda.synchronize()
            at_replay = reduces[len(at_capture):]
        finally:
            dist.all_reduce = real_all_reduce
        say("phase27", check="a", all_reduce_calls_at_capture=len(at_capture),
            of_them_inside_the_capture=sum(at_capture), all_reduce_calls_at_a_replay=len(at_replay))
        # the warm-up step before the capture, then one a captured step
        if at_capture != [False] + [True] * CHUNK or at_replay:
            raise AssertionError(f"all-reduce calls at capture {at_capture}, at a replay {at_replay}")
        say("phase27", check="a", preset="zinc250k", K=CHUNK, B=B, launches_at_capture=json.dumps(launches),
            mesh_chunk_vs_no_mesh_max_abs=json.dumps({**{k: v[0] for k, v in diffs.items()}, "metrics": mdiff}),
            bit_for_bit=bit)
        if not bit:
            raise AssertionError(f"the 1-rank NCCL mesh chunk differs from the no-mesh chunk: {diffs}, {mdiff}")
        if launches.get("fused_sample_kl") != CHUNK + 1 or launches.get("fused_encode") != CHUNK + 1:
            raise AssertionError(f"the mesh chunk's capture launched {launches}")

        def call_plain():
            nonlocal a
            a, _ = plain_chunk(a, stack, None)

        def call_mesh():
            nonlocal b
            b, _ = mesh_chunk(b, stack, None)

        t = [time_ms(fn) / CHUNK for fn in (call_plain, call_mesh, call_mesh, call_plain)]
        prof = _profile_counts(call_mesh)
        nccl = {k: v for k, v in prof.items() if "nccl" in k.lower()}
        nccl_launches = sum(n for _, n in nccl.values())
        # the step's whole reduce (the flat buffer's copy in, the all-reduce,
        # the division, the copies back), eager on gradients of the model's
        # shapes: its device time queued behind a sleep (queued_ms), by the
        # profiler, and its event time (the host's launches included)
        from molvax_torch.parallel import GradientMean

        gm = GradientMean(mesh)
        grads = [torch.randn_like(p) for p in b.params.parameters()]
        gm(grads)
        reduce_ms = queued_ms(lambda: gm(grads))
        reduce_prof = _profile_counts(lambda: gm(grads))
        reduce_event_ms = time_ms(lambda: gm(grads))
        grad_bytes = mesh_chunk.grad_mean.numel * 4
        out["a"] = {"ms_no_mesh": (t[0] + t[3]) / 2, "ms_mesh": (t[1] + t[2]) / 2, "ms_runs": t,
                    "reduce_device_ms_per_step": reduce_ms, "reduce_event_ms": reduce_event_ms,
                    "nccl_kernels_per_chunk": nccl_launches, "grad_bytes": grad_bytes}
        say("phase27", check="a", ms_per_step_no_mesh_mesh_mesh_no_mesh=json.dumps([round(x, 4) for x in t]),
            profiler_kernels_per_replay=sum(n for _, n in prof.values()), nccl_kernels_per_replay=nccl_launches,
            nccl_kernels=json.dumps(sorted(nccl)), reduce_device_ms_per_step=f"{reduce_ms:.4f}",
            reduce_profiler_ms=f"{sum(ms for ms, _ in reduce_prof.values()):.4f}" if reduce_prof else "not measured",
            reduce_profiler_kernels=json.dumps({k: n for k, (_, n) in sorted(reduce_prof.items())}),
            reduce_event_ms=f"{reduce_event_ms:.4f}", grad_bytes_per_step=grad_bytes, card=json.dumps(gpu))
        del a, b, base, plain_chunk, mesh_chunk, ma, mb

        # (b) train() at moses_scaled width, 256 rows a chip
        mp = get_preset("moses_scaled")
        mp = dataclasses.replace(mp, train=dataclasses.replace(mp.train, batch_size=B, train_chunk_size=4, log_every=4))
        err = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            state, hist = train(mp, ds, max_steps=12, verbose=False)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = {k: v for k, v in counts().items() if v}
        warned = [line for line in err.getvalue().splitlines() if line.startswith("[molvax] configured mesh")]
        rows = [row for row in hist if "loss" in row]
        losses = [row["loss"] for row in rows]
        n_params = sum(p.numel() for p in state.params.parameters())
        # the log rows' clock: steps 4 -> 12, two replays after the capture
        ms_step = (rows[-1]["wall_s"] - rows[0]["wall_s"]) / (rows[-1]["step"] - rows[0]["step"]) * 1e3
        out["b"] = {"ms_per_step": ms_step, "grad_bytes": n_params * 4, "warning": warned, "losses": losses,
                    "launches": launches}
        for line in warned:
            print(line, flush=True)
        say("phase27", check="b", preset="moses_scaled", gru=f"{mp.model.gru_layers}x{mp.model.gru_hidden}",
            batch=B, data_axis=mp.mesh.data_axis, steps=state.step, chunk=mp.train.train_chunk_size,
            warning_is_the_references=warned == [DP_WARNING], launches=json.dumps(launches),
            loss=json.dumps([round(x, 4) for x in losses]), ms_per_step=f"{ms_step:.3f}",
            train_s=f"{train_s:.2f}", grad_bytes_per_step=n_params * 4, card=json.dumps(gpu))
        if warned != [DP_WARNING] or state.step != 12 or not all(np.isfinite(losses)) or len(losses) != 3:
            raise AssertionError(f"train() at moses_scaled width: warning {warned}, step {state.step}, loss {losses}")
        if not all(launches.get(k) for k in ("fused_encode", "fused_sample_kl", "gru_stack_rec", "gru_stack_sweep")):
            raise AssertionError(f"train() at moses_scaled width launched {launches}")
        del state
    finally:
        dist.destroy_process_group()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def phase27_rank(rank: int, world: int, root: str, cfg, charset, codes_np, z_np) -> None:
    """A gloo rank of phase 27 (c), (e), (f) on the card (spawned): joins
    the world through the file store in ``root``, writes rank<r>.pt."""
    import torch.distributed as dist

    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{os.path.abspath(root)}/store", world_size=world,
                            rank=rank)
    try:
        out = gloo_rank_checks(rank, root, cfg, charset, codes_np, z_np, dev)
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def gloo_rank_checks(rank: int, root: str, cfg, charset, codes_np, z_np, dev) -> dict:
    from molvax_torch.io import checkpoint as ckpt
    from molvax_torch.latent import decode_latents
    from molvax_torch.nn.vae import bernoulli_mask
    from molvax_torch.parallel import make_mesh, replicate, shard_batch

    mesh = make_mesh(device=dev)
    half = B // DP_RANKS
    out = {"mesh": (mesh.shape, mesh.data_rank, str(mesh.device))}
    # (c) one eager step on this rank's 128 rows of the global 256
    state = replicate(mesh, init_state(cfg, seed=SEED, device=dev))
    seen, drawn = [], []
    real_fs = sampler.fused_sample_kl

    def spy(seed, mu, logvar, eps_scale=1.0, row_base=0):
        z, kl = real_fs(seed, mu, logvar, eps_scale, row_base)
        drawn.append((seed.clone(), mu.detach().clone(), logvar.detach().clone(), z.detach().clone(), row_base))
        return z, kl

    sampler.fused_sample_kl = spy
    reset_counts()
    try:
        with recorded_grads(seen):
            state, metrics = make_train_step(cfg, mesh)(state, shard_batch(mesh, codes_np))
        torch.cuda.synchronize()
    finally:
        sampler.fused_sample_kl = real_fs
    out["launches"] = {k: v for k, v in counts().items() if v}
    one = torch.load(os.path.join(root, "one_step.pt"), weights_only=True)
    names = [n for n, _ in state.params.named_parameters()]
    out["grad_rel"] = {n: ((g.float().cpu() - one["grads"][n]).norm() / one["grads"][n].norm().clamp_min(1e-30)).item()
                       for n, g in zip(names, seen[0]) if g is not None}
    out["metric_rel"] = {k: abs(v.item() - one["metrics"][k]) / max(abs(one["metrics"][k]), 1e-30)
                         for k, v in metrics.items()}
    seed, mu, lv, z, rb = drawn[0]
    L = mu.shape[1]
    eps_rows = torch.equal(sampler.sample_eps(seed, half, L, dev, rb),
                           sampler.sample_eps(seed, B, L, dev)[rb:rb + half])
    z_plain, _ = sampler.fused_sample_kl_ref(seed, mu, lv, cfg.model.eps_scale, rb)
    masks = torch.equal(bernoulli_mask(seed, 0xD409, 0.3, (half, cfg.model.max_len), dev, rb),
                        bernoulli_mask(seed, 0xD409, 0.3, (B, cfg.model.max_len), dev)[rb:rb + half])
    out["noise"] = {"row_base": rb, "rows": mu.shape[0], "eps_rows_bit_for_bit": eps_rows, "masks_bit_for_bit": masks,
                    "z_rel_err": max_abs(z, z_plain) / z_plain.abs().max().item()}
    try:
        make_train_chunk(cfg, CHUNK, mesh=mesh)
        out["chunk_refusal"] = None
    except ValueError as e:
        out["chunk_refusal"] = str(e)
    # (f) the 2-rank state saved (the first rank writes), and rank 1's own
    # copy of what it holds; the 1-process checkpoint restored on the mesh
    mgr = ckpt.make_manager(os.path.join(root, "mesh_ckpt"), mesh=mesh)
    out["saved"] = mgr.save(state.step, state)
    if rank == 1:
        torch.save(ckpt.state_payload(state), os.path.join(root, "rank1_state.pt"))
    one_dir = os.path.join(root, "one_ckpt")
    up = ckpt.make_manager(one_dir).restore_latest(init_state(cfg, seed=SEED + 1, device=dev))
    saved = torch.load(os.path.join(one_dir, "1", ckpt.STATE_FILE), weights_only=True)
    out["up_bit_for_bit"] = payload_diffs(ckpt.state_payload(up), saved)
    # (e) the latent workloads over the mesh, greedy
    emodel = init_state(cfg, seed=SEED, device=dev).params
    reset_counts()
    out["prior"] = sample_prior(emodel, cfg.model, B, torch.Generator().manual_seed(SEED + 27), charset=charset,
                                mesh=mesh)
    out["decode"] = decode_latents(emodel, cfg.model, z_np, charset=charset, batch=B, mesh=mesh)
    torch.cuda.synchronize()
    out["latent_launches"] = {k: v for k, v in counts().items() if v}
    # codes of this rank's rows, for the margin check of any string that differs
    z_prior = torch.randn(B, cfg.model.latent_dim, generator=torch.Generator().manual_seed(SEED + 27))
    rows = slice(rank * half, (rank + 1) * half)
    out["gaps"] = {}
    for name, zz in (("prior", z_prior), ("decode", torch.from_numpy(z_np))):
        z_local = zz[rows].to(dev)
        codes = generate(emodel, cfg.model, z_local, torch.Generator().manual_seed(0), charset=charset,
                         row_base=rows.start)[0]
        out["gaps"][name] = margin_gap(emodel, cfg.model, z_local, codes)
    return out


def gloo_world_checks(dev, gpu, ds) -> dict:
    """Phase 27 (c), (e), (f): two gloo ranks on the one card, spawned,
    against this process's 1-process runs on the same inputs. (c) one eager
    zinc250k step, global B=256, 128 rows a rank: each rank's all-reduced
    gradients within the bf16 gate of the 1-process step's, the metrics
    (post_std_batch and acc_nonpad among them) within DP_METRIC_REL, rank
    r's eps drawn for rows 128 r .. (and the masks' rows); the chunk
    refused on a gloo group. (e) sample_prior(256) and decode_latents
    greedy over the ranks: the 1-process strings, or every differing code
    a near-tie within MARGIN. (f) the 2-rank state saved and restored here,
    and this process's checkpoint restored on the ranks, bit for bit."""
    from molvax_torch.io import checkpoint as ckpt
    from molvax_torch.latent import decode_latents

    root = fresh_dir("gloo")
    cfg = effective_config(get_preset("zinc250k"), ds)
    charset = ds.charset
    codes_np = next(BatchIterator(ds, B, seed=0, device="cpu"))[0].numpy()
    z_np = np.random.default_rng(SEED + 28).standard_normal((B, cfg.model.latent_dim)).astype(np.float32)
    state = init_state(cfg, seed=SEED, device=dev)
    seen = []
    with recorded_grads(seen):
        state, metrics = make_train_step(cfg)(state, torch.from_numpy(codes_np).to(dev))
    names = [n for n, _ in state.params.named_parameters()]
    torch.save({"grads": {n: g.float().cpu() for n, g in zip(names, seen[0]) if g is not None},
                "metrics": {k: v.item() for k, v in metrics.items()}}, os.path.join(root, "one_step.pt"))
    ckpt.make_manager(os.path.join(root, "one_ckpt")).save(1, state)
    emodel = init_state(cfg, seed=SEED, device=dev).params
    prior_one = sample_prior(emodel, cfg.model, B, torch.Generator().manual_seed(SEED + 27), charset=charset)
    decode_one = decode_latents(emodel, cfg.model, z_np, batch=B, charset=charset)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    ctx = torch.multiprocessing.start_processes(phase27_rank, args=(DP_RANKS, root, cfg, charset, codes_np, z_np),
                                                nprocs=DP_RANKS, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > 600:
                raise AssertionError("the gloo ranks of phase 27 outlived 600 s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(30)
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in range(DP_RANKS)]
    half = B // DP_RANKS
    for r, o in enumerate(ranks):
        worst_grad = max(o["grad_rel"].items(), key=lambda kv: kv[1])
        worst_metric = max(o["metric_rel"].items(), key=lambda kv: kv[1])
        say("phase27", check="c", rank=r, mesh=json.dumps(o["mesh"][0]), data_rank=o["mesh"][1], device=o["mesh"][2],
            backend="gloo", rows=o["noise"]["rows"], launches=json.dumps(o["launches"]),
            max_grad_rel_err=f"{worst_grad[1]:.3e}", worst_grad=worst_grad[0], grad_rel_tol=DP_GRAD_REL,
            max_metric_rel_err=f"{worst_metric[1]:.3e}", worst_metric=worst_metric[0],
            post_std_batch_rel_err=f"{o['metric_rel']['post_std_batch']:.3e}",
            acc_nonpad_rel_err=f"{o['metric_rel']['acc_nonpad']:.3e}", metric_rel_tol=DP_METRIC_REL)
        say("phase27", check="c", rank=r, eps_row_base=o["noise"]["row_base"],
            eps_rows_bit_for_bit=o["noise"]["eps_rows_bit_for_bit"], masks_bit_for_bit=o["noise"]["masks_bit_for_bit"],
            z_rel_err_plain=f"{o['noise']['z_rel_err']:.3e}", chunk_refused=json.dumps(o["chunk_refusal"]))
        if worst_grad[1] > DP_GRAD_REL or worst_metric[1] > DP_METRIC_REL:
            raise AssertionError(f"rank {r}: gradient {worst_grad}, metric {worst_metric}")
        if (o["noise"]["row_base"] != r * half or o["noise"]["rows"] != half or not o["noise"]["eps_rows_bit_for_bit"]
                or not o["noise"]["masks_bit_for_bit"] or not o["noise"]["z_rel_err"] <= SAMPLER_REL):
            raise AssertionError(f"rank {r}: the noise of its rows {o['noise']}")
        if not o["chunk_refusal"] or "cannot be captured" not in o["chunk_refusal"]:
            raise AssertionError(f"rank {r}: make_train_chunk on a gloo group: {o['chunk_refusal']}")
        if not all(o["launches"].get(k) for k in ("fused_encode", "fused_sample_kl", "gru_stack_rec")):
            raise AssertionError(f"rank {r}: the DP step launched {o['launches']}")
    out = {"ranks_s": ranks_s, "launches": ranks[1]["launches"], "latent_launches": ranks[1]["latent_launches"]}
    # (e)
    for name, want in (("prior", prior_one), ("decode", decode_one)):
        differing = [sum(a != b for a, b in zip(o[name], want)) for o in ranks]
        gaps = [o["gaps"][name] for o in ranks]
        say("phase27", check="e", call=f"{'sample_prior' if name == 'prior' else 'decode_latents'}(mesh=)", n=B,
            differing_strings_by_rank=json.dumps(differing), ranks_agree=ranks[0][name] == ranks[1][name],
            max_margin_gap_by_rank=json.dumps([f"{g:.3e}" for g in gaps]), margin=MARGIN,
            launches=json.dumps(ranks[1]["latent_launches"]))
        if ranks[0][name] != ranks[1][name] or any(len(o[name]) != B for o in ranks):
            raise AssertionError(f"{name}: the ranks returned different strings")
        if any(differing) and max(gaps) > MARGIN:
            raise AssertionError(f"{name}: {differing} strings differ from the 1-process call beyond a near-tie")
    if not ranks[1]["latent_launches"].get("fused_generate_persistent"):
        raise AssertionError(f"the mesh decodes launched {ranks[1]['latent_launches']}")
    # (f)
    saved_by_ranks = load_payload(os.path.join(root, "mesh_ckpt"), 1)
    restored = ckpt.make_manager(os.path.join(root, "mesh_ckpt")).restore_latest(init_state(cfg, seed=SEED + 2,
                                                                                             device=dev))
    held = torch.load(os.path.join(root, "rank1_state.pt"), weights_only=True)
    down = payload_diffs(ckpt.state_payload(restored), held)
    same_file = payload_diffs(saved_by_ranks, held)
    say("phase27", check="f", saved_on_ranks=json.dumps([o["saved"] for o in ranks]),
        mesh_to_1_differences=json.dumps(down), rank1_state_vs_file=json.dumps(same_file),
        one_to_mesh_differences=json.dumps([o["up_bit_for_bit"] for o in ranks]),
        ranks_s=f"{ranks_s:.1f}", card=json.dumps(gpu))
    if down or same_file or any(o["up_bit_for_bit"] for o in ranks) or not all(o["saved"] for o in ranks):
        raise AssertionError("a checkpoint across the mesh did not restore bit for bit")
    return out


def phase27(dev, gpu, model, codes, ds) -> dict:
    """Data parallelism on the card: (d) the row-offset kernels, (a) and
    (b) an NCCL world of one rank in this process, (c), (e) and (f) two
    gloo ranks on the card in spawned processes."""
    t0 = time.perf_counter()
    out = {"d": row_base_checks(model, codes, dev, gpu)}
    out.update(nccl_world_checks(dev, gpu, ds))
    out["gloo"] = gloo_world_checks(dev, gpu, ds)
    say("phase27", phase_s=f"{time.perf_counter() - t0:.1f}", card=json.dumps(gpu))
    return out


# the noise table's shapes held to its plain version: (T, B, C, row_base)
NOISE_TABLE_SHAPES = ((120, B, 37, 0), (120, 528, 37, 4000))
NOISE_SEED = 0x9E3779B9  # past 2**31: its int32 bit pattern is negative


def per_step_noise_loop(model, cfg, z, seed: int, greedy: bool, temp: float, row_base: int = 0):
    """The constrained scan-route decode op by op with the per-step
    ``gumbel_noise`` drawn inside each step, as the decode drew its noise
    before the table (``kernels.generate.gumbel_table``), through the same
    step kernels (``kernels.generate.FusedStep``): (codes, logits)."""
    rows, T, C = z.shape[0], cfg.max_len, cfg.charset_size
    itab, state = ls._automaton(DEFAULT_CHARSET, rows, T, z.device)
    codes = torch.empty(rows, T, dtype=torch.int32, device=z.device)
    logits = torch.empty(rows, T, C, device=z.device)
    with torch.no_grad():
        fused = kg.FusedStep(model, latent_embed(model, cfg, z))
        h, h_out = fused.state(), fused.state()
        scores = torch.empty(rows, C, device=z.device)
        for t in range(T):
            noise = None if greedy else kg.gumbel_noise(seed, t, rows, C, z.device, row_base)
            fused.step(h, h_out, None if t == 0 else codes[:, t - 1], logits[:, t], scores, noise, temp)
            codes[:, t] = kauto.auto_step(itab, state, scores, T - 1 - t)[:, 0]
            h, h_out = h_out, h
    return codes, logits


# the decode step's kernels against their plain versions: (preset, rows)
STEP_SHAPES = (("zinc250k", B), ("zinc250k", B * BEAM), ("moses_scaled", B))
STEP_TOL = 1e-4  # 3xTF32 products against fp32 ones, sums in other orders; a bf16 or single TF32 product shows ~1e-2
STEP_STEPS = 8
# a step's device activities in a replay, at most: L = 3 cells, the head, auto_step, and the decode's set-up over T
REPLAY_STEP_ACTIVITIES = 8


def step_model(preset: str, dev, seed: int):
    """A model of ``preset``'s widths from ``seed``, its learned start vector drawn too."""
    cfg = get_preset(preset).model
    torch.manual_seed(seed)
    model = MolecularVAE(cfg, device=dev)
    with torch.no_grad():
        if model.start_token is not None:
            model.start_token.normal_()
    model.requires_grad_(False)
    return cfg, model


def step_flops(B_: int, H: int, L: int, C: int) -> float:
    """A step's least operations: layer 0's h product (its z half once a
    decode, its one-hot half a gather), the x and h products of the layers
    above, the head."""
    return 2.0 * B_ * (3 * H * H * (2 * L - 1) + H * C)


def step_kernel_checks(dev, gpu) -> dict:
    """The decode step's kernels (``kernels.generate.FusedStep``,
    ``csrc/decode_step.cu``) at each of ``STEP_SHAPES``, seeded weights: the
    packing bit for bit its plain version, z's gates and, over STEP_STEPS
    steps from the kernels' own state and codes (sampled at T=0.7), the
    hidden states and logits within STEP_TOL of the plain step's, the scores
    torch's and the codes their first maximum bit for bit, the padding
    columns zero, two runs bit for bit alike, 2 + (L + 1) launches; then at
    the first shape a step's device ms (queued), each kernel's ms (profiler),
    the plain version's and the library chain's (``decoder_step`` and the
    head: cuBLAS and elementwise kernels) ms, and the bound."""
    out = {}
    for preset, rows in STEP_SHAPES:
        cfg, model = step_model(preset, dev, SEED + 30)
        _, L, H, C, Lz = kg.step_sizes(model, torch.empty(rows, 1))
        g = torch.Generator(device=dev).manual_seed(SEED + rows)
        z_emb = torch.randn(rows, Lz, device=dev, generator=g)

        def run(n: int):
            before = kg.decode_step_launches
            fs = kg.FusedStep(model, z_emb)
            h, codes, res = fs.state(), None, []
            for t in range(n):
                h_out, logits = torch.empty_like(h), torch.empty(rows, C, device=dev)
                scores, code = torch.empty(rows, C, device=dev), torch.empty(rows, dtype=torch.int32, device=dev)
                fs.step(h, h_out, codes, logits, scores, kg.gumbel_noise(SEED, t, rows, C, dev), 0.7, code)
                res.append((h, codes, h_out, logits, scores, code))
                h, codes = h_out, code
            return fs, res, kg.decode_step_launches - before

        with torch.no_grad():
            fs, res, launches = run(STEP_STEPS)
            _, res2, _ = run(STEP_STEPS)
            ref = kg.pack_step_ref(model, z_emb)
            got_w = [*fs.w.whh, *fs.w.wih[1:], *fs.w.bhh, *fs.w.bih, fs.w.wz, fs.w.wc, fs.w.w4, fs.w.b4, fs.w.z]
            want_w = [*ref.whh, *ref.wih[1:], *ref.bhh, *ref.bih, ref.wz, ref.wc, ref.w4, ref.b4, ref.z]
            pack_equal = all(torch.equal(a, b) for a, b in zip(got_w, want_w))
            gz = kg.latent_gates_ref(model, z_emb)
            gz_err = float((fs.gz.view(rows, 3, fs.Hp)[:, :, :H].reshape(rows, 3 * H) - gz).abs().max())
            h_err = logit_err = 0.0
            scores_same = codes_same = pads_zero = True
            for t, (h, codes, h_out, logits, scores, code) in enumerate(res):
                hs_ref, lg_ref = kg.decode_step_ref(model, h[:, :, :H], gz, codes)
                h_err = max(h_err, float((h_out[:, :, :H] - hs_ref).abs().max()))
                logit_err = max(logit_err, float((logits - lg_ref).abs().max()))
                pads_zero &= bool(h_out[:, :, H:].abs().sum() == 0)
                scores_same &= bool(torch.equal(scores, logits / 0.7 + kg.gumbel_noise(SEED, t, rows, C, dev)))
                codes_same &= bool(torch.equal(code.long(), torch.argmax(scores, dim=-1)))
            twice = all(torch.equal(a[3], b[3]) and torch.equal(a[2], b[2]) for a, b in zip(res, res2))
        plans = {name: fs.plans[m] for name, m in (("gates", 0), ("layer0", 1), ("layers", 2))}
        row = dict(pack_identical=pack_equal, gates_max_abs_err=gz_err, h_max_abs_err=h_err,
                   logits_max_abs_err=logit_err, scores_identical=scores_same, codes_first_max=codes_same,
                   pads_zero=pads_zero, two_runs_identical=twice, launches=launches)
        say("phase28", check="step_kernels", preset=preset, B=rows, H=H, L=L, steps=STEP_STEPS,
            plans=json.dumps(plans), **{k: (f"{v:.3e}" if isinstance(v, float) else v) for k, v in row.items()})
        if not (pack_equal and scores_same and codes_same and pads_zero and twice and gz_err <= STEP_TOL
                and h_err <= STEP_TOL and logit_err <= STEP_TOL and launches == 2 + STEP_STEPS * (L + 1)):
            raise AssertionError(f"the step kernels at ({preset}, B={rows}): {row}")
        out[f"{preset}_B{rows}"] = row
    # times at the first shape: one step, and the library chain it replaces
    preset, rows = STEP_SHAPES[0]
    cfg, model = step_model(preset, dev, SEED + 30)
    _, L, H, C, Lz = kg.step_sizes(model, torch.empty(rows, 1))
    z_emb = torch.randn(rows, Lz, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    with torch.no_grad():
        fs = kg.FusedStep(model, z_emb)
        h, h_out = fs.state(), fs.state()
        logits, scores = torch.empty(rows, C, device=dev), torch.empty(rows, C, device=dev)
        noise = kg.gumbel_noise(SEED, 0, rows, C, dev)
        prev = torch.zeros(rows, dtype=torch.int32, device=dev)
        hs = torch.zeros(L, rows, H, device=dev)
        onehot = one_hot(prev.long(), C)
        gz = kg.latent_gates_ref(model, z_emb)

        def step():
            fs.step(h, h_out, prev, logits, scores, noise, 1.0)

        def library():
            decoder_step(model, hs, z_emb, onehot)

        reps = 20
        t = {"step_device_ms_queued": queued_ms(lambda: [step() for _ in range(reps)]) / reps,
             "step_ms_events": time_ms(step),
             "library_device_ms_queued": queued_ms(library),  # ~60 launches: more would fill the launch queue
             "library_ms_events": time_ms(library),
             "plain_ms": time_ms(lambda: kg.decode_step_ref(model, hs, gz, prev)),
             "setup_device_ms_queued": queued_ms(lambda: kg.FusedStep(model, z_emb))}
        for name in ("cell_kernel", "head_kernel"):
            ms, n = device_ms(lambda: [step() for _ in range(reps)], name)
            t[f"{name}_device_ms_per_launch"] = ms / n if n else "not_measured"
        for name in ("pack_kernel", "cell_kernel"):
            ms, n = device_ms(lambda: kg.FusedStep(model, z_emb), name)
            t[f"setup_{name}_device_ms"] = ms / n if n else "not_measured"
        lib = device_kernels(library)
        t["library_activities_per_step"] = sum(lib.values())
    flops = step_flops(rows, H, L, C)
    t["bound_ms_fma"] = flops / 67e12 * 1e3
    t["bound_ms_3xtf32"] = flops / (494.7e12 / 3) * 1e3
    t["gflop_per_step"] = flops / 1e9
    say("phase28", times="step_kernels", preset=preset, B=rows, card=json.dumps(gpu),
        **{k: (f"{v:.6g}" if isinstance(v, float) else v) for k, v in t.items()})
    out["times"] = t
    return out


def noise_table_checks(dev) -> dict:
    """The noise table (``kernels.generate.gumbel_table``, ``csrc/noise.cu``)
    at each of ``NOISE_TABLE_SHAPES``, its seed an int, a 0-d int64 tensor
    and an int32 bit pattern: bit for bit its plain version, which is bit
    for bit the stack of the per-step ``gumbel_noise`` on the card, one
    launch a call; then at (T, B, C) = (120, 256, 37) its event ms, its
    device ms by the profiler and queued behind a sleep (with the seed's
    fill), the plain version's ms and the bound (bytes written)."""
    out = {}
    for steps, rows, classes, base in NOISE_TABLE_SHAPES:
        forms = {"int": NOISE_SEED, "int64": torch.full((), NOISE_SEED, dtype=torch.int64, device=dev),
                 "int32_bits": torch.full((), NOISE_SEED - (1 << 32), dtype=torch.int32, device=dev)}
        want = kg.gumbel_table_ref(NOISE_SEED, steps, rows, classes, dev, base)
        stacked = torch.stack([kg.gumbel_noise(NOISE_SEED, t, rows, classes, dev, base) for t in range(steps)])
        before = kg.noise_table_launches
        same = {name: bool(torch.equal(kg.gumbel_table(seed, steps, rows, classes, dev, base), want))
                for name, seed in forms.items()}
        launches = kg.noise_table_launches - before
        plain_is_stack = bool(torch.equal(want, stacked))
        say("phase28", check="noise_table", T=steps, B=rows, C=classes, row_base=base,
            identical_to_plain=json.dumps(same), plain_identical_to_per_step_stack=plain_is_stack, launches=launches)
        if not all(same.values()) or not plain_is_stack or launches != len(forms):
            raise AssertionError(f"noise table at {(steps, rows, classes, base)}: {same}, plain is the per-step "
                                 f"stack {plain_is_stack}, {launches} launches for {len(forms)} calls")
        out[f"T{steps}_B{rows}_C{classes}_rb{base}"] = same
    steps, rows, classes, _ = NOISE_TABLE_SHAPES[0]

    def call():
        return kg.gumbel_table(NOISE_SEED, steps, rows, classes, dev)

    prof_ms, prof_n = device_ms(call, "gumbel_table_kernel")
    times = {"ms": time_ms(call), "device_ms_profiler": prof_ms / prof_n if prof_n else "not_measured",
             "device_ms_queued_with_seed_fill": queued_ms(call),
             "plain_ms": time_ms(lambda: kg.gumbel_table_ref(NOISE_SEED, steps, rows, classes, dev)),
             "bound_ms": profiling.bound_ms(0.0, 4.0 * steps * rows * classes, 1.0)[0]}
    say("phase28", times="noise_table", T=steps, B=rows, C=classes,
        **{k: (f"{v:.6g}" if isinstance(v, float) else v) for k, v in times.items()})
    return {"identical": out, **times}


def phase28(model, qcfg, dev, gpu) -> dict:
    """The scan route's decode as one CUDA Graph (``latent.sample.CapturedDecode``)
    at B=256 and its noise table: first ``noise_table_checks``; then
    greedy, T=1.0, T=0.7 and T=1.0 at row_base 128, five calls of a key
    (each its own z and generator seed): the calls before
    ``_CAPTURE_AT_CALL`` op by op, then one capture and replays, each
    call's codes and logits equal, bit for bit, to the op-by-op loop
    (``_eager_scan``) and to the loop that draws the per-step noise
    (``per_step_noise_loop``); auto_step T a call, once more in the
    capturing call (its step before the capture); the noise table once a
    sampled call, twice in the capturing call (its step before the capture
    makes one of one step), never greedy; the profiler's auto_step kernels
    (T) and noise table kernels (1) a replay; a key of its own under the
    plain automaton, equal to its loop and to the kernel's replay; the
    device activities the profiler records in a replay, in the loop and in
    the per-step-noise loop, a replay's device ms (``queued_ms``); a key's first call, its
    capturing call, a replay, the loop and the per-step-noise loop, ms a
    request."""
    t0 = time.perf_counter()
    T, C = qcfg.max_len, qcfg.charset_size
    at = ls._CAPTURE_AT_CALL
    table = noise_table_checks(dev)
    steps = step_kernel_checks(dev, gpu)
    rng = np.random.default_rng(SEED + 28)
    zs = [torch.from_numpy(rng.standard_normal((B, qcfg.latent_dim)).astype(np.float32)).to(dev) for _ in range(5)]
    seeds = [SEED + 280 + i for i in range(len(zs))]
    ls._graphs.pop(model, None)  # phase 17 decoded these keys

    def served(z, seed, greedy, temp, row_base=0):
        return generate(model, qcfg, z, torch.Generator().manual_seed(seed), greedy=greedy, temperature=temp,
                        constrained=True, row_base=row_base)

    def drawn(seed):
        return ls._draw_seed(torch.Generator().manual_seed(seed))

    def eager(z, seed, greedy, temp, row_base=0):
        with torch.no_grad():
            return ls._eager_scan(model, qcfg, z, drawn(seed), greedy, temp, True, DEFAULT_CHARSET, row_base)

    def loop(z, seed, greedy, temp, row_base=0):
        return per_step_noise_loop(model, qcfg, z, drawn(seed), greedy, temp, row_base)

    out = {"noise_table": table, "step_kernels": steps}
    want_launches = [T + (i + 1 == at) for i in range(len(zs))]
    L = model.gru.num_layers  # the step kernels: 2 a decode, then L + 1 a step; the capturing call's first step besides
    want_steps = [2 + T * (L + 1) + (i + 1 == at) * (2 + L + 1) for i in range(len(zs))]
    for name, greedy, temp, base in (("greedy", True, 1.0, 0), ("T1.0", False, 1.0, 0), ("T0.7", False, 0.7, 0),
                                     ("T1.0_row_base", False, 1.0, 128)):
        caps, reps = ls.graph_captures, ls.graph_replays
        same, same_loop, launches, tables, step_launches = [], [], [], [], []
        for z, seed in zip(zs, seeds):
            reset_counts()
            before, steps_before = kg.noise_table_launches, kg.decode_step_launches
            codes, logits = served(z, seed, greedy, temp, base)
            launches.append(counts()["auto_step"])
            tables.append(kg.noise_table_launches - before)
            step_launches.append(kg.decode_step_launches - steps_before)
            codes_e, logits_e = eager(z, seed, greedy, temp, base)
            same.append(bool(torch.equal(codes, codes_e) and torch.equal(logits, logits_e)))
            codes_l, logits_l = loop(z, seed, greedy, temp, base)
            same_loop.append(bool(torch.equal(codes, codes_l) and torch.equal(logits, logits_l)))
        torch.cuda.synchronize()
        got = {"captures": ls.graph_captures - caps, "replays": ls.graph_replays - reps}
        want_tables = [0 if greedy else 1 + (i + 1 == at) for i in range(len(zs))]
        say("phase28", mode=name, B=B, T=T, row_base=base, calls=len(zs), capture_at_call=at, **got,
            equal_to_loop=json.dumps(same), equal_to_per_step_noise_loop=json.dumps(same_loop),
            auto_step_per_call=json.dumps(launches), gumbel_table_per_call=json.dumps(tables),
            decode_step_per_call=json.dumps(step_launches))
        if (got != {"captures": 1, "replays": len(zs) - at} or not all(same) or not all(same_loop)
                or launches != want_launches or tables != want_tables or step_launches != want_steps):
            raise AssertionError(f"captured decode ({name}): {got}, equal to the loop {same}, to the per-step-noise "
                                 f"loop {same_loop}, auto_step {launches}, expected {want_launches}, gumbel_table "
                                 f"{tables}, expected {want_tables}, decode step {step_launches}, expected "
                                 f"{want_steps}")
        out[name] = got
    # what runs in a replay: the profiler's auto_step and noise table kernels beside the counters
    reset_counts()
    reps, tables = ls.graph_replays, kg.noise_table_launches
    per = profiled_kernels_per_call("auto_step", lambda: served(zs[1], seeds[1], False, 1.0), T, alone=False)
    per_table = profiled_kernels_per_call("gumbel_table", lambda: served(zs[1], seeds[1], False, 1.0), 1,
                                          alone=False)
    replays, counted, tables = ls.graph_replays - reps, counts()["auto_step"], kg.noise_table_launches - tables
    say("phase28", check="kernels_in_replays", mode="T1.0", replays=replays, auto_step_counted=counted,
        profiler_auto_step_per_replay=per, gumbel_table_counted=tables, profiler_gumbel_table_per_replay=per_table)
    if per != T or counted != T * replays or per_table != 1 or tables != replays:
        raise AssertionError(f"replays: the profiler {per} auto_step and {per_table} gumbel_table a replay, counted "
                             f"{counted} and {tables} in {replays}")
    # the plain automaton: a key of its own, the same codes
    caps = ls.graph_captures
    with plain_automaton():
        reset_counts()
        for _ in range(at):
            codes_p, logits_p = served(zs[0], seeds[0], False, 1.0)
        plain_launches = counts()["auto_step"]
        codes_pe, logits_pe = eager(zs[0], seeds[0], False, 1.0)
    codes_k, logits_k = served(zs[0], seeds[0], False, 1.0)
    torch.cuda.synchronize()
    plain = {"captures": ls.graph_captures - caps, "auto_step": plain_launches,
             "equal_to_its_loop": bool(torch.equal(codes_p, codes_pe) and torch.equal(logits_p, logits_pe)),
             "equal_to_kernel_route": bool(torch.equal(codes_p, codes_k) and torch.equal(logits_p, logits_k))}
    say("phase28", check="plain_automaton_own_capture", **plain)
    if plain != {"captures": 1, "auto_step": 0, "equal_to_its_loop": True, "equal_to_kernel_route": True}:
        raise AssertionError(f"captured decode under the plain automaton: {plain}")
    # device activities a request, as the profiler records them; a replay's device ms, queued
    runs = {"replay": lambda: served(zs[1], seeds[1], False, 1.0),
            "loop": lambda: eager(zs[1], seeds[1], False, 1.0),
            "per_step_noise_loop": lambda: loop(zs[1], seeds[1], False, 1.0)}
    rec = {k: device_kernels(fn) for k, fn in runs.items()}
    replay_device_ms = queued_ms(runs["replay"])
    say("phase28", profiled_device_activities="T1.0", **{k: sum(v.values()) for k, v in rec.items()},
        **{f"{k}_per_step": f"{sum(v.values()) / T:.2f}" for k, v in rec.items()},
        replay_device_ms_queued=f"{replay_device_ms:.3f}")
    names = {}
    for name, n in rec["replay"].items():
        names[name[:60]] = names.get(name[:60], 0) + n
    say("phase28", replay_device_activities=json.dumps(dict(sorted(names.items(), key=lambda kv: -kv[1]))))
    replay_per_step = sum(rec["replay"].values()) / T
    if not 0 < replay_per_step <= REPLAY_STEP_ACTIVITIES:
        raise AssertionError(f"a replay records {replay_per_step:.2f} device activities a step, expected at most "
                             f"{REPLAY_STEP_ACTIVITIES} (the step kernels, auto_step, one copy)")
    # ms a request at T=1.0: a key's first call, its capturing call, a replay, the loops
    ls._graphs.pop(model, None)
    ms = {}
    for i in range(at):
        torch.cuda.synchronize()
        a = time.perf_counter()
        served(zs[2], seeds[2], False, 1.0)
        torch.cuda.synchronize()
        ms[("first_call", "second_call")[i] if i < at - 1 else "capture_call"] = (time.perf_counter() - a) * 1e3
    ms.update(replay=time_ms(lambda: served(zs[2], seeds[2], False, 1.0)),
              loop=time_ms(lambda: eager(zs[2], seeds[2], False, 1.0), warmup=1, reps=3),
              per_step_noise_loop=time_ms(lambda: loop(zs[2], seeds[2], False, 1.0), warmup=1, reps=3))
    say("phase28", times="T1.0", B=B, **{f"{k}_ms": f"{v:.3f}" for k, v in ms.items()},
        replay_smiles_per_s=f"{B / (ms['replay'] / 1e3):.1f}", loop_smiles_per_s=f"{B / (ms['loop'] / 1e3):.1f}",
        card=json.dumps(gpu))
    say("phase28", phase_s=f"{time.perf_counter() - t0:.1f}")
    out.update(plain=plain, profiled={k: sum(v.values()) for k, v in rec.items()}, replay_device_ms=replay_device_ms,
               replay_auto_step=per, replay_gumbel_table=per_table, ms=ms)
    return out


def entry(name, source, replaces, launches, err, ms, plain_ms, bnd, library_ms, **extra) -> dict:
    """One kernel of the ``kernels`` line."""
    return {"name": name, "route": "cuda", "source": f"molvax_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms, **extra}


def probe_entries(p19: dict, p20: dict, route_comparison: dict) -> list:
    """The probe kernels' entries of the ``kernels`` line, at B=256, T=120,
    H=501: launches of phase 20's probe run (0 on the main paths, which
    phases 5-18 count), errors and plain times of phase 19, times and
    bounds of phase 20's tables. run_variant's ms is matmul_only's."""
    rows, prow, runs = p20["rows"], p20["proto"], p20["runs"]
    g = p19["g"]
    floor_shape, floor_k = auto_loop_probe.FLOOR_SHAPES[-1], auto_loop_probe.FLOOR_K[0]
    bnd = {name: (rows[name]["bound_ms"], rows[name]["bound_by"]) for name in ("matmul_only", "gates_nostore", "fused3")}
    bnd["fwd_gi"] = prow["in_kernel_1"]["bound"]
    bnd["floor_loop"] = auto_loop_probe.floor_bound(floor_shape, g["T"], floor_k)
    for name, (ms_b, by) in bnd.items():
        say("phase20", bound_of=name, bound_ms=f"{ms_b:.6f}", bound_by=by)
    ge_runs = runs["gru_experiments"]
    return [
        entry("run_variant", "gru_layer.cu", "bench/gru_experiments.py:86",
              ge_runs["gru_probe_matmul_only"] + ge_runs["gru_probe_gates_nostore"],
              max(p19["err"]["matmul_only"], p19["err"]["gates_nostore"]), rows["matmul_only"]["ms"],
              p19["plain"]["matmul_only"], bnd["matmul_only"], None, mode="matmul_only",
              ms_gates_nostore=rows["gates_nostore"]["ms"], plain_ms_gates_nostore=p19["plain"]["gates_nostore"],
              bound_ms_gates_nostore=bnd["gates_nostore"][0], ms_full=rows["full"]["ms"]),
        entry("run_fused3", "gru_layer.cu", "bench/gru_experiments.py:155", ge_runs["gru_fused3"],
              p19["err"]["fused3"], rows["fused3"]["ms"], p19["plain"]["fused3"], bnd["fused3"], None,
              layers=g["L"], slices=rows["fused3"]["slices"], per_layer_same_work_ms=rows["per_layer_same"]["ms"],
              ms_H512=p20["rows512"]["fused3"]["ms"], per_layer_same_work_ms_H512=p20["rows512"]["per_layer_same"]["ms"],
              library_none="cuDNN's GRU cannot take layer 0's gates as given"),
        entry("fwd_gi", "gru_layer.cu", "bench/proto_gi_kernel.py:69",
              runs["proto_gi_kernel"]["gru_layer_scan_x_fwd"], p19["err"]["fwd_gi"], prow["in_kernel_1"]["ms"],
              p19["plain"]["fwd_gi"], bnd["fwd_gi"], p20["lib_fwd_gi"], library_dtype="bfloat16",
              I=p19["p"]["I"], ms_hoisted=prow["hoisted_1"]["ms"], route_comparison=route_comparison),
        entry("floor_loop", "floor.cu", "bench/auto_loop_probe.py:152", runs["auto_loop_probe"]["floor_loop"], 0,
              p20["floor"][floor_shape]["ms"][floor_k], p19["plain"]["floor"], bnd["floor_loop"], None,
              shape=list(floor_shape), T=g["T"], k_ops=floor_k, chains=auto_loop_probe.FLOOR_CHAINS,
              ns_per_op=p20["floor"][floor_shape]["ns_per_op"], fixed_ms=p20["floor"][floor_shape]["fixed_ms"],
              device_ms=p20["floor_device_ms"],
              latency_floor_ms=auto_loop_probe.floor_latency_ms(
                  g["T"], floor_k, auto_loop_probe.FLOOR_CHAINS,
                  p20["floor"][auto_loop_probe.LATENCY_SHAPE]["ns_per_op"][-1]),
              library_none="no PyTorch call runs this integer loop"),
    ]


# the first loss of gvae_zinc's K=16 chunk (bf16 products) against the
# plain reference's in fp32: relative gap; the reference in bf16 against
# itself in fp32 is printed beside it (what the precision alone does)
GVAE_LOSS_REL = 1e-3


def phase29(dev, gpu) -> dict:
    """gvae_zinc at its published widths (module docstring, phase 29)."""
    from molvax_torch.data.alphabet import grammar_dataset
    from molvax_torch.data.grammar import ZINC_GRAMMAR
    from molvax_torch.kernels import grammar_walk as kw
    from perfbench.reference import grammar as rg
    from perfbench.reference import model as pref
    from perfbench.reference import noise as pnoise

    t0 = time.perf_counter()
    cfg = get_preset("gvae_zinc")
    mcfg = cfg.model
    conf = json.loads(open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "perfbench", "configs",
                                        "gvae_zinc.json")).read())
    sizes = dict(conf["sizes"], grammar=conf["grammar"], dense_activation=conf["dense_activation"])
    w = rg.make_weights(sizes, SEED + 29, dev)
    model = MolecularVAE(mcfg, device=dev)
    model.load_state_dict(w, strict=True)
    model.requires_grad_(False)
    T, R, N = mcfg.max_len, mcfg.charset_size, 10_000
    if _build.info is not None and _build.info.compiled:
        say("phase29", walk_kernel_ptxas=json.dumps(ptxas_report(_build.info.log, "grammar_walk_kernel")))
    rng = np.random.default_rng(SEED + 29)
    z = torch.from_numpy(rng.standard_normal((N, mcfg.latent_dim)).astype(np.float32)).to(dev)
    with torch.no_grad():
        logits = torch.cat([ls.decode(model, mcfg, z[i:i + 2048]) for i in range(0, N, 2048)])
    out = {}
    for greedy, seed, rows, base in ((False, 0x9E3779B9, N, 0), (True, 0, N, 0), (False, 12345, 1000, 4000)):
        part = logits[base:base + rows]
        before = kw.launches
        got = kw.walk(part, ZINC_GRAMMAR, seed, greedy, 1.0, base)
        if kw.launches != before + 1:
            raise AssertionError(f"the walk launched {kw.launches - before} times, expected 1")
        want = kw.walk_ref(part, ZINC_GRAMMAR, seed, greedy, 1.0, base)
        same = bool(torch.equal(got, want))
        strings = ZINC_GRAMMAR.strings(got[:, T:].cpu().numpy())
        derived = [ZINC_GRAMMAR.derive(r) or "" for r in got[:, :T].cpu().tolist()]
        say("phase29", walk="greedy" if greedy else "sampled", rows=rows, row_base=base, identical_to_plain=same,
            complete=sum(1 for x in strings if x), strings_are_derivations=strings == derived,
            examples=json.dumps([x for x in strings if x][:3]))
        if not same or strings != derived:
            raise AssertionError("the walk kernel differs from its plain version")
    walk_ms = time_ms(lambda: kw.walk(logits, ZINC_GRAMMAR, 7, False, 1.0))
    plain_ms = time_ms(lambda: kw.walk_ref(logits, ZINC_GRAMMAR, 7, False, 1.0), warmup=0, reps=1)
    decode_ms = time_ms(lambda: [ls.decode(model, mcfg, z[i:i + 2048]) for i in range(0, N, 2048)], reps=2)
    del logits
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator().manual_seed(SEED + 290)
    before = kw.launches
    with torch.no_grad():
        strings, codes = sample_prior(model, mcfg, N, gen, greedy=False, with_codes=True)
    torch.cuda.synchronize()
    if kw.launches != before + 1:
        raise AssertionError(f"sample_prior launched the walk {kw.launches - before} times, expected 1")
    if [ZINC_GRAMMAR.derive(r) or "" for r in codes.tolist()] != strings:
        raise AssertionError("sample_prior's strings are not its derivations")
    peak = torch.cuda.max_memory_allocated(dev)
    request_ms = time_ms(lambda: sample_prior(model, mcfg, N, torch.Generator().manual_seed(1), greedy=False), reps=3)
    out.update(walk_ms=walk_ms, walk_plain_ms=plain_ms, decode_ms=decode_ms, request_ms=request_ms, peak=peak)
    say("phase29", rows=N, request_ms=f"{request_ms:.2f}", decode_ms=f"{decode_ms:.2f}", walk_ms=f"{walk_ms:.4f}",
        walk_plain_ms=f"{plain_ms:.1f}", smiles_per_s=f"{N / request_ms * 1e3:.0f}",
        complete=sum(1 for x in strings if x), peak_memory_gb=f"{peak / 1e9:.2f}",
        walk_bound_us=f"{N * (4 * T * R + 3 * T) / 3.35e12 * 1e6:.1f}")
    # the encoder on rule codes at the training batch: the kernel route
    ds = grammar_dataset(ZINC_GRAMMAR, "synthetic_chem", T, 4096, SEED)
    it = BatchIterator(ds, cfg.train.batch_size, seed=SEED, device=dev)
    stack, _ = it.next_stack(CHUNK)
    before = conv_enc.launches
    with torch.no_grad():
        mu_k, lv_k = conv_enc.fused_encode(model, mcfg, stack[0])
        mu_p, lv_p = conv_enc.fused_encode_ref(model, mcfg, stack[0])
    enc_launches = conv_enc.launches - before
    enc_err = max(max_abs(mu_k, mu_p), max_abs(lv_k, lv_p))
    say("phase29", encoder_B=stack.shape[1], encoder_launches=enc_launches, encoder_max_abs_err=f"{enc_err:.3e}")
    if enc_launches != 1 or enc_err > ENCODER_TOL:
        raise AssertionError(f"the encoder at gvae_zinc width: {enc_launches} launches, error {enc_err:.3e}")
    # a K=16 chunk from the same weights: its first loss against the reference's
    state_seed = 0x5EED29
    state = init_state(cfg, seed=state_seed, device=dev, weights={k: v.clone() for k, v in w.items()})
    chunk = make_train_chunk(cfg, CHUNK, device=dev)
    before = conv_enc.launches
    state, m = chunk(state, stack, None)
    torch.cuda.synchronize()
    first = float(m["loss"][0])
    eps = pnoise.normal(int(pnoise.step_seeds(pnoise.fold_in(state_seed, 1), 0, 1)[0]), stack.shape[1],
                        mcfg.latent_dim, dev)
    with torch.no_grad(), pref.strict_fp32():
        ref_loss = float(rg.loss_of(w, sizes, stack[0].long(), eps))
        ref_bf16 = float(rg.loss_of(w, sizes, stack[0].long(), eps, q=pref.bf16))
    rel, rel_bf16 = abs(first - ref_loss) / abs(ref_loss), abs(ref_bf16 - ref_loss) / abs(ref_loss)
    say("phase29", chunk_K=CHUNK, batch=stack.shape[1], first_loss=f"{first:.6f}", reference=f"{ref_loss:.6f}",
        rel_gap=f"{rel:.3e}", reference_bf16_rel_gap=f"{rel_bf16:.3e}", limit=GVAE_LOSS_REL,
        losses=json.dumps([round(float(x), 4) for x in m["loss"]]), encoder_launches_in_chunk=conv_enc.launches - before,
        seconds=f"{time.perf_counter() - t0:.1f}")
    if not rel <= GVAE_LOSS_REL:
        raise AssertionError(f"gvae_zinc's first loss {first} against the reference's {ref_loss}: {rel:.3e}")
    return out


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
    # the automaton's warp program keeps every operand in registers and shared memory
    auto_ptxas = {}
    for name, kernel in AUTO_KERNELS.items():
        if not _build.info.compiled:
            say("phase1", automaton_kernel=name, ptxas="not reported: the library was built by an earlier run")
            continue
        auto_ptxas[name] = ptxas_report(_build.info.log, kernel)
        say("phase1", automaton_kernel=name, **auto_ptxas[name])
        if auto_ptxas[name]["stack_frame_bytes"] or auto_ptxas[name]["spill_store_bytes"]:
            raise AssertionError(f"{kernel} uses local memory: {auto_ptxas[name]}")
    # the per-layer kernels' instances: what ptxas spilled to stay within
    # __launch_bounds__(256) (kernels/gru.py::layer_plan relies on it)
    layer_ptxas = {}
    if _build.info.compiled:
        for kernel in ("layer_fwd_kernel", "layer_sweep_kernel"):
            layer_ptxas.update(ptxas_instances(_build.info.log, kernel))
        if len(layer_ptxas) != 19:  # forward: bf16 in-kernel 3, hoisted 3 modes x 3, fp32 2; sweep: 3 + 2
            raise AssertionError(f"the ptxas report names {sorted(layer_ptxas)}, expected 19 layer kernel instances")
    for name, rep in sorted(layer_ptxas.items()):
        say("phase1", layer_kernel=name, **rep)
    # the probe kernels' instances: the fused3 wavefront (one a row-tile
    # count), the int32 floor (one a chain count)
    probe_ptxas = {}
    if _build.info.compiled:
        for kernel in ("fused3_kernel", "floor_kernel"):
            probe_ptxas.update(ptxas_instances(_build.info.log, kernel))
        if len(probe_ptxas) != 11:
            raise AssertionError(f"the ptxas report names {sorted(probe_ptxas)}, expected 3 fused3 and 8 floor "
                                 "instances")
    for name, rep in sorted(probe_ptxas.items()):
        say("phase1", probe_kernel=name, **rep)
    if sys.argv[1:] == ["--phase", "29"]:
        phase29(dev, gpu)
        return done(gpu)

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
    if sys.argv[1:] == ["--phase", "28"]:
        phase28(model, get_preset("zinc250k_quality").model, dev, gpu)
        return done(gpu)

    # -- 3, 4. generation kernel against plain version -----------------------
    rng = np.random.default_rng(SEED + 1)
    z = torch.from_numpy(rng.standard_normal((B, cfg.latent_dim)).astype(np.float32)).to(dev)
    with torch.no_grad():
        z_emb = latent_embed(model, cfg, z)
    gaps = {}
    for rows in (B, 6, 528):  # 528: three slices of the plan
        if rows == B:
            z_rows = z_emb
        else:
            with torch.no_grad():
                z_rows = latent_embed(model, cfg, torch.from_numpy(
                    rng.standard_normal((rows, cfg.latent_dim)).astype(np.float32)).to(dev))
        gaps[rows] = [check_kernel(model, z_rows, True, 1.0, 0)] + [
            check_kernel(model, z_rows, False, temp, seed) for temp, seed in ((1.0, 11), (0.7, 12))]
    gen_moses = row_block_check(dev)

    # -- 5. the serving path through the public functions --------------------
    gen = torch.Generator().manual_seed(SEED)
    reset_counts()
    prior = sample_prior(model, cfg, B, gen)
    recon = reconstruct(model, cfg, SMILES, gen, stochastic=False)
    recon_s = reconstruct(model, cfg, SMILES, gen, stochastic=True)
    torch.cuda.synchronize()
    serve_counts = counts()
    say("phase5", **serve_counts)
    if (serve_counts["fused_generate"], serve_counts["fused_generate_persistent"],
            serve_counts["fused_generate_row_block"]) != (3, 3, 0):
        raise AssertionError(f"expected 3 persistent generation launches on the serving path, got {serve_counts}")
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
    model_cpu = MolecularVAE(cfg, device="cpu")
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
    ms_gen_row_block = time_ms(lambda: kg._decode(model, cfg, z_emb, 0, True, 1.0, row_block=True))
    ms_gen_plain = time_ms(lambda: kg.fused_generate_ref(model, cfg, z_emb, 0))
    for name, ms in (("kernel_greedy", ms_gen), ("row_block_greedy", ms_gen_row_block),
                     ("plain_greedy", ms_gen_plain)):
        say("phase6", path=name, B=B, T=cfg.max_len, ms=f"{ms:.4f}",
            smiles_per_s=f"{B / (ms / 1e3):.1f}", card=json.dumps(gpu))
    sms, smem = kg.card_limits(z_emb.device)
    gen_plan = kg.generate_plan(B, cfg.charset_size, cfg.gru_hidden, cfg.gru_layers, sms, smem)
    ms_gen_setup = time_ms(lambda: kg._setup(model, z_emb, gen_plan))
    say("phase6", sms=sms, smem_optin=smem, plan=json.dumps(dataclasses.asdict(gen_plan)).replace(" ", ""),
        blocks=gen_plan.blocks,
        setup_ms=f"{ms_gen_setup:.4f}", setup_share=f"{ms_gen_setup / ms_gen:.4f}",
        us_per_step=f"{ms_gen * 1e3 / cfg.max_len:.3f}")
    gen_prof = profile_step(lambda: kg.fused_generate(model, cfg, z_emb, 0))
    say_profile("phase6", gen_prof, ms_gen)

    # -- 7, 8. the stack's kernels against their plain versions ------------------
    s_args = stack_inputs(model, cfg, codes)
    L = cfg.gru_layers
    limits = gru_stack.card_limits(dev)
    plan = gru_stack.stack_plan(B, cfg.gru_hidden, *limits)
    # the training kernels' layouts come from the card's SMs and shared
    # memory; on an H100 SXM (132, 232,448 B) they are the constants' plans
    fp32_plan = gru_stack.stack_plan(B, cfg.gru_hidden, *limits, esize=4)
    say("phase7", planner="card", sms=limits[0], smem=limits[1],
        same_as_h100_sxm_constants=plan == gru_stack.stack_plan(B, cfg.gru_hidden)
        and fp32_plan == gru_stack.stack_plan(B, cfg.gru_hidden, esize=4),
        stack_plan=json.dumps(dataclasses.asdict(plan)).replace(" ", ""),
        layer_route_bf16=kgru.layer_route(B, cfg.gru_hidden, torch.bfloat16, limits),
        layer_route_fp32=kgru.layer_route(B, cfg.gru_hidden, torch.float32, limits),
        layer_plan_fp32=json.dumps(dataclasses.asdict(fp32_plan)).replace(" ", ""),
        layer_plan_in_kernel=json.dumps(dataclasses.asdict(
            kgru.layer_plan(B, s_args[0].shape[-1], cfg.gru_hidden, *limits))).replace(" ", ""),
        dw_parts_layer0=kgru.dw_parts(cfg.max_len, s_args[0].shape[-1], cfg.gru_hidden, limits[0]))
    say("phase7", preset="zinc250k", plan=json.dumps(dataclasses.asdict(plan)).replace(" ", ""),
        blocks=plan.blocks)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    dY = 1e-2 * torch.randn(cfg.max_len, B, cfg.gru_hidden, device=dev, generator=g)
    dhf = 1e-2 * torch.randn(L, B, cfg.gru_hidden, device=dev, generator=g)
    fwd_err, bwd_err, res_k, grads_k = check_stack(s_args, dY, dhf, "phase7")
    piece_err = stack_piece_checks(s_args, res_k, dY, dhf, "phase8")
    x0, wih0, _, wih, _, whh, _, h0 = s_args
    res = (*res_k, x0, h0, wih0, wih, whh)
    moses = moses_width_check(dev, gpu)

    # -- 9. encoder and sampler kernels against their plain versions ---------
    with torch.no_grad():
        mu_k, lv_k = conv_enc._encode_kernel(cfg, codes, encoder_params(model))
        mu_r, lv_r = conv_enc.fused_encode_ref(model, cfg, codes)
    enc_kernel_err = encoder_shape_checks(model, cfg, codes, dev)
    seed9 = 12345
    _, _, sampler_err = sampler_checks(mu_r, lv_r, seed9, cfg.eps_scale)
    seed9_t = torch.full((), seed9, dtype=torch.int32, device=dev)
    with torch.no_grad():
        z_k, kl_k = sampler._sample_kernel(seed9_t, mu_r, lv_r, cfg.eps_scale)
    ragged = ragged_batch_checks(model, cfg, codes, s_args)
    fwd_err, bwd_err = max(fwd_err, ragged["fwd"]), max(bwd_err, ragged["bwd"])
    for k in piece_err:
        piece_err[k] = max(piece_err[k], ragged[k])

    # -- 10. the training step through the public functions ------------------
    state, train_step, train_counts = train_phase(
        "phase10", full, weights, codes,
        {"fused_encode": 1, "fused_sample_kl": 1, **stack_launches(L)},
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
    seed1 = torch.full((), 1, dtype=torch.int32, device=dev)  # the sampler reads its seed on the card
    with torch.no_grad():
        times = {
            "fused_encode": (time_ms(lambda: conv_enc._encode_kernel(cfg, codes, enc_params)),
                             time_ms(lambda: conv_enc.fused_encode_ref(model, cfg, codes))),
            "fused_sample_kl": (time_ms(lambda: sampler._sample_kernel(seed1, mu_r, lv_r, 1.0)),
                                time_ms(lambda: sampler.fused_sample_kl_ref(seed1, mu_r, lv_r, 1.0))),
            "gru_stack_fwd": (time_ms(lambda: gru_stack.stack_forward(*s_args)),
                              time_ms(lambda: gru_stack.stack_forward_ref(*s_args))),
            "gru_stack_bwd": (time_ms(lambda: gru_stack.stack_backward(res, dY, dhf)),
                              time_ms(lambda: gru_stack.stack_backward_ref(res, dY, dhf))),
        }
    for name, (ms_k, ms_p) in times.items():
        say("phase11", kernel=name, ms=f"{ms_k:.4f}", plain_ms=f"{ms_p:.4f}", card=json.dumps(gpu))
    # the encoder's and the sampler's device time a call (20 calls queued
    # behind a sleep kernel: the wrapper's host cost not in it), beside the
    # event time above; and the device kernels torch.profiler records for
    # one wrapper call, which must be its counted launches (no preparation
    # kernel around it)
    dev_call = {}
    with torch.no_grad():
        for name, fn, counter in (
                ("fused_encode", lambda: conv_enc._encode_kernel(cfg, codes, enc_params), lambda: conv_enc.launches),
                ("fused_sample_kl", lambda: sampler._sample_kernel(seed1, mu_r, lv_r, 1.0), lambda: sampler.launches)):
            us = queued_ms(lambda: [fn() for _ in range(20)]) / 20 * 1e3
            before = counter()
            fn()
            per_call = counter() - before
            recorded = profiled_kernels_per_call(name, fn, per_call)
            dev_call[name] = (us, recorded if recorded else "not measured")
            say("phase11", kernel=name, device_us_per_call=f"{us:.3f}", event_ms=f"{times[name][0]:.4f}",
                launches_per_call=per_call, profiler_device_kernels_per_call=dev_call[name][1], card=json.dumps(gpu))
    # the stack's device time by kernel, one forward and one backward
    with torch.no_grad():
        split = {"fwd": stack_split(lambda: gru_stack.stack_forward(*s_args)),
                 "bwd": stack_split(lambda: gru_stack.stack_backward(res, dY, dhf))}
    for name, parts in split.items():
        say("phase11", stack_split=name, **{f"{k}_ms": f"{v:.4f}" for k, v in sorted(parts.items())},
            card=json.dumps(gpu))
    T, H, C, L = cfg.max_len, cfg.gru_hidden, cfg.charset_size, cfg.gru_layers
    I0 = s_args[0].shape[2]
    stack_ops = 2 * B * T * (gru_macs(I0, H) + (L - 1) * gru_macs(H, H))
    w_gen, b_gen = kg._pack(model, dev)
    bounds = {
        # after t = 0 the one-hot product is a gather of W_c's row: no operations
        "fused_generate": bound(2 * B * (C * 3 * H + T * (H * 3 * H + (L - 1) * 2 * H * 3 * H + H * C)),
                                nbytes(w_gen, b_gen) + B * 3 * H * 4 + B * T * 4 + C * 4, PEAK_BF16),
        # the fp32 parameters read once, as the kernel reads them
        "fused_encode": bound(encoder_ops(cfg, codes), nbytes(codes) + nbytes(*enc_params) + nbytes(mu_k, lv_k),
                              PEAK_BF16),
        "fused_sample_kl": bound(30 * B * cfg.latent_dim, nbytes(mu_r, lv_r, z_k, kl_k), PEAK_FP32),
        "gru_stack_fwd": bound(stack_ops, nbytes(*s_args) + nbytes(*res_k), PEAK_BF16),
        "gru_stack_bwd": bound(2 * stack_ops, nbytes(*res, dY, dhf) + nbytes(*grads_k), PEAK_BF16),
    }
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
            fwd_e, bwd_e, layer_res[md, l] = check_layer_x(args, md, dY_l, layer=l, compare_in_kernel=True)
            ragged = tuple(a[:, :6].contiguous() if i == 0 else a for i, a in enumerate(args[:-1])) + (args[-1][:6],)
            fwd_r, bwd_r, _ = check_layer_x(ragged, md, dY_l[:, :6].contiguous(), layer=l, ragged_batch=6,
                                            compare_in_kernel=True)
            layer_err[md][0] = max(layer_err[md][0], fwd_e, fwd_r)
            layer_err[md][1] = max(layer_err[md][1], bwd_e, bwd_r)
    # the in-kernel instance where it is the route: errors by (md, H, B), launches by md
    wide_err, wide_launches = {}, {torch.bfloat16: {}, torch.float32: {}}
    for md, H_, B_, T_ in WIDE:
        *wide_err[md, H_, B_], got = wide_layer_check(dev, md, H_, B_, T_)
        for k, v in got.items():
            wide_launches[md][k] = wide_launches[md].get(k, 0) + v
    # strict fp32 where the sweep keeps its warp tiles: the plan's 1 x 8
    # tiles a block (B=64, H=200) have no K-split instance
    tiles_err = seeded_layer_check(dev, torch.float32, 32, 64, 100, 200, "warp_tiles", SEED + 6)
    layer_err[torch.float32] = [max(a, b) for a, b in zip(layer_err[torch.float32], tiles_err)]
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
    n_scan = kgru.layer_plan(B, 0, H, *gru_stack.card_limits(dev), hoisted=True).slices
    want_scan = {"gru_layer_scan_fwd": L * n_scan, "gru_layer_scan_bwd_sweep": L * n_scan, "gru_layer_gemm_dw": L,
                 "gru_layer_dw_sum": L}
    if any(v != want_scan.get(k, 0) for k, v in scan_counts.items()) or not hoisted_rel <= ROUTE_REL:
        raise AssertionError(f"hoisted-gi decode: counts {scan_counts}, loss rel diff {hoisted_rel:.3e}")

    # -- 13. the zinc250k_quality training step ------------------------------
    qfull = get_preset("zinc250k_quality")
    # two forward passes (scheduled sampling), the graded one's backward
    q_layer = model_layer_launches(qfull.model, torch.bfloat16, 2, 1)
    q_state, q_step, q_counts = train_phase(
        "phase13", qfull, weights, codes, {"fused_encode": 1, "fused_sample_kl": 1, **q_layer}, ROUTE_REL)
    reset_counts()
    q_eval = {k: float(v) for k, v in make_eval_step(qfull)(q_state, codes, None).items()}
    eval_counts = counts()
    say("phase13", eval=json.dumps({k: round(v, 4) for k, v in q_eval.items()}), **eval_counts)
    eval_want = model_layer_launches(qfull.model, torch.bfloat16, 1, 0)
    if any(eval_counts[k] != eval_want.get(k, 0) for k in eval_counts if k.startswith("gru_")):
        raise AssertionError(f"eval step: launch counts {eval_counts}, expected GRU launches {eval_want}")
    if not all(np.isfinite(list(q_eval.values()))):
        raise AssertionError("zinc250k_quality eval metrics are not finite")

    # -- 14. the strict-fp32 zinc250k training step --------------------------
    ffull = dataclasses.replace(full, name="zinc250k_fp32",
                                model=dataclasses.replace(cfg, compute_dtype="float32"))
    f_layer = model_layer_launches(ffull.model, torch.float32, 1, 1)
    if "gru_layer_rec" not in f_layer:
        raise AssertionError(f"the strict-fp32 step at B={B}, H={H} is not on the persistent route")
    _, f_step, f_counts = train_phase("phase14", ffull, weights, codes, f_layer, FP32_ROUTE_REL)
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
    bf, f32 = torch.bfloat16, torch.float32
    layer_ms = {}
    with torch.no_grad():
        for md in (bf, f32):
            for l, x_l in ((0, s_args[0]), (1, x1)):
                args = layer_args(s_args, l, x_l)
                res = (*layer_res[md, l], saved_x(args, md), args[5], args[1], args[3])
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
        # the in-kernel instance (csrc/gru_layer.cu) on the same inputs: its
        # pair (forward + sweep, dx GEMM and dW) against the persistent
        # route's (gi GEMM + recurrence; sweep + dx GEMM + dW)
        in_ms, route_cmp = {}, {}
        limits = gru_stack.card_limits(dev)
        for md in (bf, f32):
            for l, x_l in ((0, s_args[0]), (1, x1)):
                args = layer_args(s_args, l, x_l)
                res_in = (*kgru.layer_forward_in_kernel(*args, md), saved_x(args, md), args[5], args[1], args[3])
                in_ms[md, l] = (time_ms(lambda: kgru.layer_forward_in_kernel(*args, md)),
                                time_ms(lambda: kgru.layer_backward_in_kernel(res_in, dY_l)))
                pair = in_ms[md, l][0] + in_ms[md, l][1]
                route_cmp[md, l] = (pair, layer_ms[md, l][0] + layer_ms[md, l][2])
                say("phase15", kernel="gru_layer_scan_x", md=str(md).split(".")[-1], layer=l, I=x_l.shape[2],
                    route="in_kernel", fwd_ms=f"{in_ms[md, l][0]:.4f}", bwd_ms=f"{in_ms[md, l][1]:.4f}",
                    in_kernel_pair_ms=f"{pair:.4f}", persistent_pair_ms=f"{route_cmp[md, l][1]:.4f}",
                    in_kernel_pair_faster=pair < route_cmp[md, l][1], card=json.dumps(gpu))
        for md in (bf, f32):
            say("phase15", route_decision=str(md).split(".")[-1], B=B, H=H,
                layer_route=kgru.layer_route(B, H, md, limits),
                in_kernel_pair_faster_at_layers=[l for l in (0, 1) if route_cmp[md, l][0] < route_cmp[md, l][1]],
                card=json.dumps(gpu))
        args0 = layer_args(s_args, 0, s_args[0])
        s_res = (*kgru.scan_forward(*scan_args), h0[0], whh[0])
        scan_ms = (time_ms(lambda: kgru.scan_forward(*scan_args)), time_ms(lambda: kgru.scan_forward_ref(*scan_args)),
                   time_ms(lambda: kgru.scan_backward(s_res, dY_l)),
                   time_ms(lambda: kgru.scan_backward_ref(s_res, dY_l)))
        # the kernels' device time by kernel at layer 0 (I=329), bf16 and fp32
        layer_split = {}
        for md in (bf, f32):
            res0_md = (*layer_res[md, 0], saved_x(args0, md), args0[5], args0[1], args0[3])
            layer_split["fwd", md] = stack_split(lambda: kgru.layer_forward(*args0, md))
            layer_split["bwd", md] = stack_split(lambda: kgru.layer_backward(res0_md, dY_l))
            res0_in = (*kgru.layer_forward_in_kernel(*args0, md), saved_x(args0, md), args0[5], args0[1], args0[3])
            layer_split["in_kernel_fwd", md] = stack_split(lambda: kgru.layer_forward_in_kernel(*args0, md))
            layer_split["in_kernel_bwd", md] = stack_split(lambda: kgru.layer_backward_in_kernel(res0_in, dY_l))
        for (name, md), parts in layer_split.items():
            say("phase15", layer_split=name, md=str(md).split(".")[-1], layer=0,
                **{f"{k}_ms": f"{v:.4f}" for k, v in sorted(parts.items())}, card=json.dumps(gpu))
        # bounds of the per-layer kernels at layer 0 (I=329); strict fp32
        # as the 3xTF32 split products the kernels run, at a third of the
        # TF32 peak, and (a side field) at the FMA peak
        ops0 = 2 * B * T * gru_macs(I0, H)
        for md, peak in ((bf, PEAK_BF16), (f32, PEAK_TF32X3), ("fp32_fma", PEAK_FP32)):
            mdt = f32 if md == "fp32_fma" else md
            res0 = (*layer_res[mdt, 0], s_args[0], args0[5], args0[1], args0[3])
            bounds["layer_fwd", md] = bound(ops0, nbytes(*args0) + nbytes(*layer_res[mdt, 0]), peak)
            bounds["layer_bwd", md] = bound(2 * ops0, nbytes(*res0, dY_l) + nbytes(*kgru.layer_backward(res0, dY_l)),
                                            peak)
        bounds["scan_fwd"] = bound(2 * B * T * H * 3 * H, nbytes(*scan_args) + nbytes(*s_res[:3]), PEAK_BF16)
        bounds["scan_bwd"] = bound(4 * B * T * H * 3 * H, nbytes(*s_res, dY_l) + nbytes(*kgru.scan_backward(s_res, dY_l)),
                                   PEAK_BF16)
    say("phase15", kernel="gru_layer_scan", fwd_ms=f"{scan_ms[0]:.4f}", fwd_plain_ms=f"{scan_ms[1]:.4f}",
        bwd_ms=f"{scan_ms[2]:.4f}", bwd_plain_ms=f"{scan_ms[3]:.4f}", card=json.dumps(gpu))
    lib = library_times(cfg, s_args, dev, "phase15")
    wide_ms = wide_times(dev, gpu)
    for md, name in ((bf, "layer_bf16"), (f32, "layer_fp32")):
        say("phase15", kernel="gru_layer_scan_x", md=str(md).split(".")[-1], layer=0, fwd_ms=f"{layer_ms[md, 0][0]:.4f}",
            cudnn_fwd_ms=f"{lib[name][0]:.4f}", bwd_ms=f"{layer_ms[md, 0][2]:.4f}",
            cudnn_autograd_bwd_ms=f"{lib[name][1]:.4f}", card=json.dumps(gpu))

    # -- 16. the automaton kernel against its plain version ------------------
    qfull_cfg = get_preset("zinc250k_quality").model
    auto = phase16(dev, qfull_cfg.max_len, qfull_cfg.charset_size)

    # -- 17. constrained decoding and beam search, public functions ----------
    decodes = phase17(model, qfull_cfg, dev)

    # -- 18. times ---------------------------------------------------------------
    at = phase18(model, qfull_cfg, decodes["z"], auto["itab"], auto["scores"], gpu)
    state_b = nbytes(kauto.new_state(B, T, dev))
    bounds["auto_step"] = bound(automaton_ops(B, C), 2 * state_b + B * C * 4 + B * 4, PEAK_INT32)
    bounds["auto_step_n120"] = bound(T * automaton_ops(B, C), 2 * state_b + B * T * C * 4 + B * T * 4,
                                     PEAK_INT32)
    rows_b = nbytes(at["sb"])
    bounds["auto_mask"] = bound(automaton_ops(at["rows"], C, select=False, advance=False),
                                rows_b + at["rows"] * C, PEAK_INT32)
    bounds["auto_advance"] = bound(automaton_ops(at["rows"], C, mask=False, select=False),
                                   2 * rows_b + at["rows"] * 4, PEAK_INT32)
    for name, (ms_b, by) in sorted((str(k), v) for k, v in bounds.items()):
        say("phase18", bound_of=name, bound_ms=f"{ms_b:.6f}", bound_by=by)

    # -- 19. the design probes' kernels against their plain versions ---------
    p19 = phase19(dev)

    # -- 20. the probe modules' runs and tables ------------------------------
    p20 = phase20(dev, p19["g"], p19["p"], ms_gen, gpu)

    # -- 21. the train steps block the host nowhere (ROADMAP C 1) -------------
    phase21(weights, codes, dev, gpu)

    # -- 22. the chunk: corpus -> next_stack -> one CUDA Graph of 16 steps ------
    ds = corpus("phase22")
    p22 = phase22(dev, gpu, ds)

    # -- 23. train(): resume bit for bit, best/, the loop's throughput --------
    phase23(dev, gpu, ds, p22)

    # -- 24. the latent workloads --------------------------------------------
    phase24(dev, gpu, model, ds)

    # -- 25. evaluate() at full width ------------------------------------------
    t0 = time.perf_counter()
    phase25(dev, gpu, ds)
    say("phase25", phase_s=f"{time.perf_counter() - t0:.1f}")

    # -- 26. the CLI ------------------------------------------------------------
    t0 = time.perf_counter()
    phase26(dev, gpu)
    say("phase26", phase_s=f"{time.perf_counter() - t0:.1f}")

    # -- 27. data parallelism -------------------------------------------------
    p27 = phase27(dev, gpu, model, codes, ds)

    # -- 28. the scan route's decode as one CUDA Graph ----------------------
    phase28(model, qfull_cfg, dev, gpu)
    phase29(dev, gpu)

    beam_counts = decodes["beam"]
    print(json.dumps({"kernels": [
        # launches of the serving path (phase 5); errors: the largest margin
        # gap of phase 3-4's decodes at each B
        entry("fused_generate", "generate.cu", "molvax/kernels/generate.py:169", serve_counts["fused_generate"],
              max(max(v) for v in gaps.values()), ms_gen, ms_gen_plain, bounds["fused_generate"], None,
              launches_by_instance={"persistent": serve_counts["fused_generate_persistent"],
                                    "row_block": serve_counts["fused_generate_row_block"]},
              ms_row_block=ms_gen_row_block, setup_ms=ms_gen_setup, plan=dataclasses.asdict(gen_plan),
              max_margin_gap_by_batch={str(k): max(v) for k, v in gaps.items()}, row_block_moses_scaled=gen_moses,
              row_base_checks={k: p27["d"][k] for k in ("persistent", "row_block")},
              launches_dp_latent=p27["gloo"]["latent_launches"].get("fused_generate", 0)),
        # event ms (what a caller waits) beside the device time a call
        entry("fused_encode", "conv_enc.cu", "molvax/kernels/conv_enc.py:181", train_counts["fused_encode"],
              enc_kernel_err, times["fused_encode"][0], times["fused_encode"][1], bounds["fused_encode"], None,
              sources=["molvax_torch/kernels/csrc/conv_enc.cu", "molvax_torch/kernels/csrc/conv_enc.cuh"],
              device_ms_per_launch=dev_call["fused_encode"][0] / 1e3,
              profiler_device_kernels_per_call=dev_call["fused_encode"][1]),
        entry("fused_sample_kl", "sampler.cu", "molvax/kernels/sampler.py:91", train_counts["fused_sample_kl"],
              sampler_err, times["fused_sample_kl"][0], times["fused_sample_kl"][1], bounds["fused_sample_kl"],
              None, device_ms_per_launch=dev_call["fused_sample_kl"][0] / 1e3,
              profiler_device_kernels_per_call=dev_call["fused_sample_kl"][1], row_base_checks=p27["d"]["sampler"],
              launches_dp_train=p27["b"]["launches"].get("fused_sample_kl", 0),
              launches_dp_gloo_step=p27["gloo"]["launches"].get("fused_sample_kl", 0)),
        # the stack: per layer the input-gate GEMM and the recurrence forward,
        # the sweep and the GEMM of the cotangent backward, one dW GEMM
        entry("gru_stack_scan_fwd", "gru_stack.cu", "molvax/kernels/gru_stack.py:552",
              train_counts["gru_stack_gemm_gi"] + train_counts["gru_stack_rec"], fwd_err,
              times["gru_stack_fwd"][0], times["gru_stack_fwd"][1], bounds["gru_stack_fwd"],
              lib["stack"][0], library_dtype=lib["stack"][2], sources=STACK_SOURCES,
              launches_by_kernel={k: train_counts[f"gru_stack_{k}"] for k in ("gemm_gi", "rec")},
              ms_split=split["fwd"], max_abs_err_by_kernel=piece_err, moses_scaled=moses),
        entry("gru_stack_scan_bwd", "gru_stack.cu", "molvax/kernels/gru_stack.py:487",
              sum(train_counts[f"gru_stack_{k}"] for k in ("sweep", "gemm_dx", "gemm_dw")), bwd_err,
              times["gru_stack_bwd"][0], times["gru_stack_bwd"][1],
              bounds["gru_stack_bwd"], lib["stack"][1], library_dtype=lib["stack"][2],
              library_ms_dw_matmul=lib["dw_stack"], sources=STACK_SOURCES,
              launches_by_kernel={k: train_counts[f"gru_stack_{k}"] for k in ("sweep", "gemm_dx", "gemm_dw")},
              ms_split=split["bwd"]),
        # per-layer times at layer 0 (I=329); layer 1's are on the phase15 lines.
        # Both dtypes on the stack's GEMM and persistent kernels for one layer:
        # bf16 (zinc250k_quality's steps) and strict fp32 (the fp32 steps).
        # ``launches`` counts the serial recurrence's launches forward and the
        # reverse sweep's backward, of both steps; the GEMMs and the dW sum
        # are in launches_by_kernel, with the in-kernel instance's (0 on both
        # steps). The fp32 fields: its errors beside the in-kernel instance's
        # on the same inputs, its times beside the in-kernel instance's, its
        # bound as the 3xTF32 it runs, at a third of the TF32 peak (and at
        # the FMA peak).
        entry("gru_layer_scan_x_fwd", "gru_stack.cu", "molvax/kernels/gru.py:527",
              q_counts["gru_layer_rec"] + f_counts["gru_layer_rec"], layer_err[bf][0], layer_ms[bf, 0][0],
              layer_ms[bf, 0][1], bounds["layer_fwd", bf], lib["layer_bf16"][0],
              library_dtype=lib["layer_bf16"][2], sources=LAYER_SOURCES, source_fp32=STACK_SOURCES,
              launches_by_kernel={"gemm_gi": q_counts["gru_layer_gemm_gi"], "rec": q_counts["gru_layer_rec"],
                                  "gemm_gi_fp32": f_counts["gru_layer_gemm_gi"], "rec_fp32": f_counts["gru_layer_rec"],
                                  "in_kernel": q_counts["gru_layer_scan_x_fwd"] + f_counts["gru_layer_scan_x_fwd"]},
              ms_split=layer_split["fwd", bf], ms_split_fp32=layer_split["fwd", f32],
              max_abs_err_in_kernel_wide={f"{str(k[0]).split('.')[-1]}_H{k[1]}_B{k[2]}": v[0] for k, v in wide_err.items()},
              max_abs_err_fp32=layer_err[f32][0], max_abs_err_fp32_in_kernel=IN_KERNEL_ERR[f32][0],
              ms_fp32=layer_ms[f32, 0][0], ms_fp32_in_kernel=in_ms[f32, 0][0], plain_ms_fp32=layer_ms[f32, 0][1],
              bound_ms_fp32=bounds["layer_fwd", f32][0], bound_ms_fp32_fma=bounds["layer_fwd", "fp32_fma"][0],
              library_ms_fp32=lib["layer_fp32"][0]),
        entry("gru_layer_scan_x_bwd", "gru_stack.cu", "molvax/kernels/gru.py:689",
              q_counts["gru_layer_sweep"] + f_counts["gru_layer_sweep"], layer_err[bf][1],
              layer_ms[bf, 0][2], layer_ms[bf, 0][3], bounds["layer_bwd", bf], lib["layer_bf16"][1],
              library_dtype=lib["layer_bf16"][2], library_ms_dw_matmul=lib["dw_layer0"], sources=LAYER_SOURCES,
              source_fp32=STACK_SOURCES,
              launches_by_kernel={**{k: q_counts[f"gru_layer_{k}"] for k in ("sweep", "gemm_dx", "gemm_dw", "dw_sum")},
                                  **{f"{k}_fp32": f_counts[f"gru_layer_{k}"]
                                     for k in ("sweep", "gemm_dx", "gemm_dw", "dw_sum")},
                                  "in_kernel_sweep": q_counts["gru_layer_scan_x_bwd_sweep"]
                                  + f_counts["gru_layer_scan_x_bwd_sweep"]},
              ms_split=layer_split["bwd", bf], ms_split_fp32=layer_split["bwd", f32],
              max_abs_err_in_kernel_wide={f"{str(k[0]).split('.')[-1]}_H{k[1]}_B{k[2]}": v[1] for k, v in wide_err.items()},
              max_abs_err_fp32=layer_err[f32][1], max_abs_err_fp32_in_kernel=IN_KERNEL_ERR[f32][1],
              ms_fp32=layer_ms[f32, 0][2], ms_fp32_in_kernel=in_ms[f32, 0][1], plain_ms_fp32=layer_ms[f32, 0][3],
              bound_ms_fp32=bounds["layer_bwd", f32][0], bound_ms_fp32_fma=bounds["layer_bwd", "fp32_fma"][0],
              library_ms_fp32=lib["layer_fp32"][1]),
        entry("gru_layer_scan_fwd", "gru_layer.cu", "molvax/kernels/gru.py:237", scan_counts["gru_layer_scan_fwd"],
              scan_fwd_err, scan_ms[0], scan_ms[1], bounds["scan_fwd"], None),
        entry("gru_layer_scan_bwd", "gru_layer.cu", "molvax/kernels/gru.py:348",
              scan_counts["gru_layer_scan_bwd_sweep"], scan_bwd_err, scan_ms[2], scan_ms[3], bounds["scan_bwd"], None),
        # gru_layer_scan_x's in-kernel backward (the sweep, then the dx and dW
        # GEMMs), bf16 and strict fp32, at layer 0 (I=329): launches of its
        # sweep in phase 12's runs at the widths no layout takes, where it is
        # the route (0 on the main paths, whose widths the persistent route
        # takes); errors at the presets' widths (phase 12); the cuDNN
        # yardstick's autograd backward; the widths no layout takes beside
        *(entry(f"gru_layer_scan_x_in_kernel_bwd{tag}", "gru_layer.cu", "molvax/kernels/gru.py:689",
                wide_launches[md].get("gru_layer_scan_x_bwd_sweep", 0), IN_KERNEL_ERR[md][1], in_ms[md, 0][1],
                layer_ms[md, 0][3], bounds["layer_bwd", md], lib[name][1], library_dtype=lib[name][2],
                sources=LAYER_SOURCES, ms_layer1=in_ms[md, 1][1],
                fwd_launches=wide_launches[md].get("gru_layer_scan_x_fwd", 0), ptxas=layer_ptxas,
                max_abs_err_wide={f"H{k[1]}_B{k[2]}": v[1] for k, v in wide_err.items() if k[0] == md},
                wide_B256={"H": 2304 if md == bf else 1536, "fwd_ms": wide_ms[md][0], "bwd_ms": wide_ms[md][1],
                           "cudnn_fwd_ms": wide_ms[md][2], "cudnn_autograd_bwd_ms": wide_ms[md][3]},
                **({"bound_ms_fma": bounds["layer_bwd", "fp32_fma"][0]} if md == f32 else {}))
          for md, tag, name in ((bf, "", "layer_bf16"), (f32, "_fp32", "layer_fp32"))),
        # the automaton: codes, masks and state rows against the plain version (phase 16)
        # launches of one constrained decode (phase 17 holds all three at T)
        entry("auto_step", "automaton.cu", "molvax/kernels/automaton.py:218",
              decodes["greedy"]["auto_step"], auto["step_err"], at["step_n1"],
              at["step_plain"], bounds["auto_step"], None, ms_n120_per_step=at["step_n120"],
              bound_ms_n120_per_step=bounds["auto_step_n120"][0] / T, device_ms_per_launch=at["dev_step_n1"][0],
              device_ms_per_launch_profiler=at["dev_step_n1"][1], device_ms_n120_per_step=at["dev_step_n120"][0],
              device_ms_n120_per_step_profiler=at["dev_step_n120"][1], ptxas=auto_ptxas.get("auto_step")),
        entry("auto_mask", "automaton.cu", "molvax/kernels/automaton.py:218", beam_counts["auto_mask"], auto["mask_err"],
              at["mask"], at["mask_plain"], bounds["auto_mask"], None, rows=at["rows"],
              device_ms_per_launch=at["dev_mask"][0], device_ms_per_launch_profiler=at["dev_mask"][1],
              ptxas=auto_ptxas.get("auto_mask")),
        entry("auto_advance", "automaton.cu", "molvax/kernels/automaton.py:218", beam_counts["auto_advance"],
              auto["advance_err"],
              at["advance"], at["advance_plain"], bounds["auto_advance"], None, rows=at["rows"],
              device_ms_per_launch=at["dev_advance"][0], device_ms_per_launch_profiler=at["dev_advance"][1],
              ptxas=auto_ptxas.get("auto_advance")),
        *probe_entries(p19, p20, {f"{str(md).split('.')[-1]}_layer{l}": {"in_kernel_pair_ms": v[0],
                                                                             "persistent_pair_ms": v[1]}
                                  for (md, l), v in route_cmp.items()}),
    ]}), flush=True)
    return done(gpu)


def done(gpu) -> int:
    """The run's last lines: the card's, then the device JSON line."""
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
