"""Where a GRU recurrence step's time goes on the card.

Port of the entry point of ``bench/gru_experiments.py`` (the TPU probes
``run_variant`` and ``run_fused3``). Run on a CUDA card:

    python -m molvax_torch.probes.gru_experiments [B]

At B=256 (or B), T=120, L=3, H=501 (the ``zinc250k`` width, where 'full' is
exactly the production kernel) and once more at H=512, one layer's hoisted-
gi forward (``csrc/gru_layer.cu``) in three modes, ms per layer sweep and µs
per step:

  matmul_only   : the serial h @ W_hh chain and the carry, all 3H columns
                  (``gru_probe_scan(mode='matmul_only')``);
  gates_nostore : + reading gi and the gate math, hseq stored;
  full          : + the r|z|n and gh_n residual stores: ``gru_layer_scan``'s
                  forward, the production kernel;

then the production 3-layer forward on both routes of
``gru_forward_pallas``, each per layer an input-gate GEMM and a persistent
recurrence (the per-layer route, three ``gru_layer_scan_x`` calls, takes
each layer's h through fp32 between them; the stack route passes the bf16
h sequence on) and ``fused3`` (``gru_fused3_scan``: the previous design's one-launch stack
kernel with layer 0's gates given and no residuals). Each row carries its bound (the
least time the card could take, ``train.profiling.bound_ms``); the
products count 2 FLOPs per multiply-add at the bf16 tensor-core peak.
"""

from __future__ import annotations

import math
import re
import shutil
import subprocess
import sys
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..kernels import _build
from ..kernels import gru as kgru
from ..kernels import gru_stack as ks
from ..train import profiling
from ..utils import resolve_device

B, T, H, L, I0 = 256, 120, 501, 3, 329
MODES = ("matmul_only", "gates_nostore", "full")


def make_inputs(B: int = B, T: int = T, H: int = H, L: int = L, I0: int = I0,
                device=None, seed: int = 0) -> dict:
    """Seeded weights (uniform +-1/sqrt(H), torch layout), x (B, T, I0), zero
    h0, and layer 0's hoisted gates gi = bf16(x @ W_ih0^T + b_ih0) (T, B,
    3H): the probes' one-layer input and fused3's gi0."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    s = 1.0 / math.sqrt(H)

    def u(*shape):
        return (2.0 * torch.rand(*shape, generator=g, device=dev) - 1.0) * s

    layers = [{"w_ih": u(3 * H, I0 if l == 0 else H), "w_hh": u(3 * H, H), "b_ih": u(3 * H),
               "b_hh": u(3 * H)} for l in range(L)]
    x = torch.randn(B, T, I0, generator=g, device=dev)
    with torch.no_grad():
        gi = F.linear(x.transpose(0, 1), layers[0]["w_ih"], layers[0]["b_ih"]).to(torch.bfloat16)
    wih0, bih0, wih, bih, whh, bhh = ks._stacked(layers)
    return {"layers": layers, "x": x, "h0": torch.zeros(L, B, H, device=dev), "gi": gi,
            "stack": (wih, bih, whh, bhh), "B": B, "T": T, "H": H, "L": L, "I0": I0}


def _one_layer(inp: dict, mode: str) -> torch.Tensor:
    l0, h0 = inp["layers"][0], inp["h0"][0]
    if mode == "full":  # the production forward kernel, its bf16 hseq as the probes'
        fwd = kgru.scan_forward if inp["gi"].is_cuda else kgru.scan_forward_ref
        return fwd(inp["gi"], l0["w_hh"], l0["b_hh"], h0)[0]
    return kgru.gru_probe_scan(inp["gi"], l0["w_hh"], l0["b_hh"], h0, mode)


def _per_layer(inp: dict) -> torch.Tensor:
    return kgru.gru_forward_pallas(inp["layers"], inp["x"], inp["h0"], kernel="per_layer")[0]


def _stack(inp: dict) -> torch.Tensor:
    return kgru.gru_forward_pallas(inp["layers"], inp["x"], inp["h0"])[0]


def _fused3(inp: dict) -> torch.Tensor:
    return ks.gru_fused3_scan(inp["gi"], *inp["stack"], inp["h0"])


def probe(inp: dict) -> Dict[str, torch.Tensor]:
    """One run of every probe kernel: each mode of the one-layer forward,
    both production routes of the 3-layer forward, fused3."""
    with torch.no_grad():
        out = {mode: _one_layer(inp, mode) for mode in MODES}
        out["per_layer_3"] = _per_layer(inp)
        out["stack_3"] = _stack(inp)
        out["fused3"] = _fused3(inp)
    return out


def bounds(inp: dict) -> Dict[str, tuple]:
    """(bound ms, what binds) of each row: operations at the bf16 peak,
    bytes of the inputs read once and the outputs written once. matmul_only
    counts the full 3H columns of h @ W_hh, the product it times, and reads
    no gi."""
    B_, T_, H_, L_, I0_ = (inp[k] for k in ("B", "T", "H", "L", "I0"))
    peak = profiling.H100_SXM.bf16_tflops * 1e12
    G = 3 * H_
    hh_ops = 2 * B_ * T_ * H_ * G  # h @ W_hh of one layer over the sweep
    ih_ops = 2 * B_ * T_ * (I0_ + (L_ - 1) * H_) * G  # x @ W_ih of every layer
    whh_b = H_ * G * 2 + G * 4  # W_hh bf16, b_hh fp32
    wih_b = (I0_ + (L_ - 1) * H_) * G * 2 + L_ * G * 4  # every W_ih bf16, b_ih fp32
    per_layer = B_ * H_ * 4 + T_ * B_ * H_ * 2  # h0 in, hseq out
    gi_b, res_b = T_ * B_ * G * 2, T_ * B_ * (G + H_) * 2  # gi; r|z|n and gh_n
    stack_b = T_ * B_ * I0_ * 4 + wih_b + L_ * (whh_b + per_layer + res_b)
    fused3_b = gi_b + wih_b - I0_ * G * 2 - G * 4 + L_ * (whh_b + per_layer)
    return {
        "matmul_only": profiling.bound_ms(hh_ops, whh_b + per_layer, peak),
        "gates_nostore": profiling.bound_ms(hh_ops, gi_b + whh_b + per_layer, peak),
        "full": profiling.bound_ms(hh_ops, gi_b + whh_b + per_layer + res_b, peak),
        "per_layer_3": profiling.bound_ms(L_ * hh_ops + ih_ops, stack_b, peak),
        "stack_3": profiling.bound_ms(L_ * hh_ops + ih_ops, stack_b, peak),
        "fused3": profiling.bound_ms(L_ * hh_ops + ih_ops - 2 * B_ * T_ * I0_ * G, fused3_b, peak),
    }


def measure(inp: dict) -> Dict[str, dict]:
    """Each row's time (CUDA events for one call, median of 5; step_timer
    for the per-layer route's three layers) and bound."""
    T_ = inp["T"]
    b = bounds(inp)
    rows = {}
    with torch.no_grad():
        for mode in MODES:
            rows[mode] = {"ms": profiling.event_ms(lambda: _one_layer(inp, mode))}
        rows["per_layer_3"] = {"ms": 1e3 * profiling.step_timer(lambda: _per_layer(inp), steps=1, rounds=6)}
        rows["stack_3"] = {"ms": profiling.event_ms(lambda: _stack(inp))}
        rows["fused3"] = {"ms": profiling.event_ms(lambda: _fused3(inp))}
    for name, row in rows.items():
        row["us_per_step"] = row["ms"] * 1e3 / T_
        row["bound_ms"], row["bound_by"] = b[name]
    return rows


def sass_counts() -> Optional[Dict[str, Dict[str, int]]]:
    """Static HMMA and LDGSTS counts of the bf16 hoisted-gi forward's three
    instances at one m16 row tile a warp (the layout of B=256, H=501) in the
    built library (``cuobjdump -sass``), or None where the toolkit has no
    cuobjdump. matmul_only keeps all of W_hh's products only if its z and n
    products were not dropped as dead code."""
    tool = shutil.which("cuobjdump") or shutil.which("/usr/local/cuda/bin/cuobjdump")
    if tool is None:
        return None
    _build.load()
    sass = subprocess.run([tool, "-sass", str(_build.info.path)], capture_output=True, text=True,
                          check=True).stdout
    names = {"0": "full", "1": "gates_nostore", "2": "matmul_only"}
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"layer_fwd_kernelI13__nv_bfloat16Lb0ELi([012])ELi1E", line)
            cur = names[m.group(1)] if m else None
            if cur:
                out[cur] = {"HMMA": 0, "LDGSTS": 0}
        elif cur:
            for op in ("HMMA", "LDGSTS"):
                if re.search(rf"\b{op}\b", line):
                    out[cur][op] += 1
    return out


def print_table(rows: Dict[str, dict], inp: dict, file=sys.stdout) -> None:
    print(f"config: B={inp['B']} T={inp['T']} H={inp['H']} L={inp['L']} I0={inp['I0']}", file=file)
    for name, r in rows.items():
        per = "layer-sweep" if name in MODES else "3-layer fwd"
        print(f"{name:14s}: {r['ms']:8.3f} ms/{per} ({r['us_per_step']:7.2f} us/step)  "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})", file=file)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("-")]
    batch = int(args[0]) if args else B
    print(profiling.card_line())
    for h in (H, 512):
        inp = make_inputs(B=batch, H=h)
        out = probe(inp)
        torch.cuda.synchronize()
        if not all(torch.isfinite(v.float()).all() for v in out.values()):
            raise AssertionError("a probe's output is not finite")
        print_table(measure(inp), inp)
    print(f"sass (static counts, bf16 hoisted-gi forward): {sass_counts()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
