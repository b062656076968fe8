#!/usr/bin/env python3
"""Drive molvax_torch's serving path once on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the hand-written generation
kernel from ``molvax_torch/kernels/csrc/`` (into ``build/molvax_torch/``),
makes ``zinc250k`` weights at full width from a seed, and runs six phases,
each printed on its own lines:

  1. environment: card name and power limit, torch and CUDA versions, TF32
     switched off, kernel build time and ptxas report;
  2. weights: numpy-seeded JAX-layout params, loaded through io/convert.py;
  3. kernel against plain version, greedy, B=256, T=120: share of identical
     codes, and a margin check: replaying the kernel's codes through the
     plain version, every code the kernel chose scores within MARGIN of the
     plain maximum;
  4. the same check sampled at temperature 1.0 and 0.7, identical noise;
  5. the main path through the public functions: sample_prior(256) and
     reconstruct of 256 SMILES (deterministic and stochastic), counting
     kernel launches and checking the strings and the encoder;
  6. decode times of the kernel and the plain version at B=256 (CUDA
     events, warm-up, median of 7).

Any failure raises and exits non-zero. Without CUDA it exits 2 and prints
no result. The last line of standard output is the device JSON.
"""

from __future__ import annotations

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
from molvax_torch.data.featurize import decode_codes, encode_smiles
from molvax_torch.io.convert import state_dict_from_jax
from molvax_torch.kernels import _build
from molvax_torch.kernels import generate as kg
from molvax_torch.latent.sample import reconstruct, sample_prior
from molvax_torch.nn.decoder import latent_embed
from molvax_torch.nn.encoder import conv_input_channels, flat_conv_dim
from molvax_torch.nn.vae import MolecularVAE, encode

MARGIN = 1e-2  # score units; bf16 operand rounding of a near-tie h can move a logit by ~1e-4
B = 256
SEED = 0

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


def time_ms(fn, warmup: int = 2, reps: int = 7) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU", file=sys.stderr)
        return 2
    if "jax" in sys.modules or any(m == "molvax" or m.startswith("molvax.") for m in sys.modules):
        raise AssertionError("the port pulled in JAX or the JAX package")

    # -- 1. environment ------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
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
        if "ptxas info" in line and ("Used" in line or "spill" in line):
            print("  " + line.strip(), flush=True)

    # -- 2. weights ----------------------------------------------------------
    cfg = get_preset("zinc250k").model
    model = MolecularVAE(cfg, device=dev)
    model.load_state_dict(state_dict_from_jax(random_params(cfg, SEED)), strict=True)
    model.eval()
    say("phase2", preset="zinc250k", T=cfg.max_len, C=cfg.charset_size, latent=cfg.latent_dim,
        gru=f"{cfg.gru_layers}x{cfg.gru_hidden}", compute_dtype=cfg.compute_dtype,
        params=sum(p.numel() for p in model.parameters()))

    # -- 3, 4. kernel against plain version ----------------------------------
    rng = np.random.default_rng(SEED + 1)
    z = torch.from_numpy(rng.standard_normal((B, cfg.latent_dim)).astype(np.float32)).to(dev)
    with torch.no_grad():
        z_emb = latent_embed(model, cfg, z)
    gaps = [check_kernel(model, z_emb, True, 1.0, 0)]
    for temp, seed in ((1.0, 11), (0.7, 12)):
        gaps.append(check_kernel(model, z_emb, False, temp, seed))

    # -- 5. the main path through the public functions -----------------------
    gen = torch.Generator().manual_seed(SEED)
    kg.launches = 0
    prior = sample_prior(model, cfg, B, gen)
    recon = reconstruct(model, cfg, SMILES, gen, stochastic=False)
    recon_s = reconstruct(model, cfg, SMILES, gen, stochastic=True)
    torch.cuda.synchronize()
    main_launches = kg.launches
    say("phase5", fused_generate_launches=main_launches)
    if main_launches != 3:
        raise AssertionError(f"expected 3 kernel launches on the main path, got {main_launches}")
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
    codes = torch.from_numpy(encode_smiles(SMILES, DEFAULT_CHARSET, cfg.max_len))
    model_cpu = MolecularVAE(cfg)
    model_cpu.load_state_dict(model.state_dict())
    with torch.no_grad():
        mu, logvar = encode(model, cfg, codes.to(dev))
        mu_cpu, logvar_cpu = encode(model_cpu, cfg, codes)
    if mu.shape != (B, cfg.latent_dim) or not (torch.isfinite(mu).all() and torch.isfinite(logvar).all()):
        raise AssertionError("encoder output misshapen or non-finite")
    enc_err = max((mu.cpu() - mu_cpu).abs().max().item(), (logvar.cpu() - logvar_cpu).abs().max().item())
    with torch.no_grad():
        ref_codes = kg.fused_generate_ref(model, cfg, latent_embed(model, cfg, mu), 0)
    ref_strings = decode_codes(ref_codes, DEFAULT_CHARSET)
    same_str = sum(a == b for a, b in zip(recon, ref_strings)) / B
    say("phase5", encoder_gpu_vs_cpu_max_abs_err=f"{enc_err:.3e}",
        reconstruct_identical_to_plain=f"{same_str:.4f}")
    if enc_err > 1e-3:  # same bf16 operands, fp32 sums in another order
        raise AssertionError(f"encoder on the card differs from the CPU by {enc_err:.3e}")

    # -- 6. times ------------------------------------------------------------
    ms_k = time_ms(lambda: kg.fused_generate(model, cfg, z_emb, 0))
    ms_r = time_ms(lambda: kg.fused_generate_ref(model, cfg, z_emb, 0))
    ms_ks = time_ms(lambda: kg.fused_generate(model, cfg, z_emb, 5, greedy=False, temperature=1.0))
    for name, ms in (("kernel_greedy", ms_k), ("plain_greedy", ms_r), ("kernel_sampled", ms_ks)):
        say("phase6", path=name, B=B, T=cfg.max_len, ms=f"{ms:.4f}",
            smiles_per_s=f"{B / (ms / 1e3):.1f}", card=json.dumps(gpu))

    print(json.dumps({"kernels": [{
        "name": "fused_generate",
        "route": "cuda",
        "source": "molvax_torch/kernels/csrc/generate.cu",
        "replaces": "molvax/kernels/generate.py:169",
        "launches": main_launches,
        "max_abs_err": max(gaps),
        "ms": ms_k,
        "plain_ms": ms_r,
    }]}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
