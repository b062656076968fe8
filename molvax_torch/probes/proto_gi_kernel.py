"""The input GEMM inside the recurrence kernel against a hoisted one.

Port of the entry point of ``bench/proto_gi_kernel.py``. Its TPU kernel
``fwd_gi`` computes ``gru_layer_scan_x``'s bf16 forward (x @ W_ih inside the
recurrence; hseq, r|z|n and gh_n stored), so its counterpart is the
in-kernel instance of ``csrc/gru_layer.cu``, called by its name
(``gru_layer_scan_x_in_kernel``): the production ``gru_layer_scan_x`` hoists
its input gates since the per-layer redesign. Run on a CUDA card:

    python -m molvax_torch.probes.proto_gi_kernel

At B=256, T=120, I=330, H=501: one layer (layer 0), in-kernel gi
(``gru_layer_scan_x_in_kernel``) against hoisted gi (one bf16 ``F.linear`` on the
tensor cores, then ``gru_layer_scan``), and the 3-layer version of both.
"""

from __future__ import annotations

import math
import sys
from typing import Dict

import torch
import torch.nn.functional as F

from ..kernels import gru as kgru
from ..train import profiling
from ..utils import resolve_device

B, T, I, H, L = 256, 120, 330, 501, 3


def make_inputs(B: int = B, T: int = T, I: int = I, H: int = H, L: int = L, device=None,
                seed: int = 0) -> dict:
    """Seeded layers (uniform +-1/sqrt(H), torch layout, with bf16 copies of
    W_ih and b_ih for the hoisted GEMM), x (T, B, I), zero h0."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    s = 1.0 / math.sqrt(H)

    def u(*shape):
        return (2.0 * torch.rand(*shape, generator=g, device=dev) - 1.0) * s

    layers = []
    for l in range(L):
        layer = {"w_ih": u(3 * H, I if l == 0 else H), "w_hh": u(3 * H, H), "b_ih": u(3 * H), "b_hh": u(3 * H)}
        layer["w_ih_bf"], layer["b_ih_bf"] = layer["w_ih"].to(torch.bfloat16), layer["b_ih"].to(torch.bfloat16)
        layers.append(layer)
    return {"layers": layers, "x": torch.randn(T, B, I, generator=g, device=dev),
            "h0": torch.zeros(B, H, device=dev), "B": B, "T": T, "I": I, "H": H, "L": L}


def in_kernel(inp: dict, layers: int) -> torch.Tensor:
    """The first ``layers`` layers, each one launch of the in-kernel
    instance."""
    out = inp["x"]
    for lay in inp["layers"][:layers]:
        out = kgru.gru_layer_scan_x_in_kernel(out, lay["w_ih"], lay["b_ih"], lay["w_hh"], lay["b_hh"], inp["h0"])
    return out


def hoisted(inp: dict, layers: int) -> torch.Tensor:
    """The same layers with gi = bf16(x @ W_ih^T + b_ih) from one tensor-core
    GEMM per layer, then ``gru_layer_scan``."""
    out = inp["x"]
    for lay in inp["layers"][:layers]:
        gi = F.linear(out.to(torch.bfloat16), lay["w_ih_bf"], lay["b_ih_bf"])
        out = kgru.gru_layer_scan(gi, lay["w_hh"], lay["b_hh"], inp["h0"])
    return out


def probe(inp: dict) -> Dict[str, torch.Tensor]:
    """One run of both versions, one layer and all L layers."""
    with torch.no_grad():
        return {"in_kernel_1": in_kernel(inp, 1), "hoisted_1": hoisted(inp, 1),
                "in_kernel_L": in_kernel(inp, inp["L"]), "hoisted_L": hoisted(inp, inp["L"])}


def bounds(inp: dict) -> Dict[str, tuple]:
    """(bound ms, what binds) of one layer and of the stack: the input and
    hidden products at the bf16 peak; x, the weights, h0 in, hseq, r|z|n
    and gh_n out."""
    B_, T_, I_, H_, L_ = (inp[k] for k in ("B", "T", "I", "H", "L"))
    peak = profiling.H100_SXM.bf16_tflops * 1e12
    G = 3 * H_

    def layer(i):
        ops = 2 * B_ * T_ * (i + H_) * G
        moved = (i + H_) * G * 2 + 2 * G * 4 + B_ * H_ * 4 + T_ * B_ * (H_ + G + H_) * 2
        return ops, moved

    one = layer(I_)
    stack = [layer(I_)] + [layer(H_)] * (L_ - 1)
    x_b = T_ * B_ * I_ * 4
    return {"1": profiling.bound_ms(one[0], one[1] + x_b, peak),
            "L": profiling.bound_ms(sum(o for o, _ in stack), sum(m for _, m in stack) + x_b, peak)}


def measure(inp: dict) -> Dict[str, dict]:
    """ms of each version: one layer (CUDA events around the single kernel
    launch; the hoisted GEMM and launch), and L layers (step_timer)."""
    b = bounds(inp)
    rows = {}
    with torch.no_grad():
        for name, fn in (("in_kernel", in_kernel), ("hoisted", hoisted)):
            rows[f"{name}_1"] = {"ms": profiling.event_ms(lambda: fn(inp, 1)), "bound": b["1"]}
            sec = profiling.step_timer(lambda: fn(inp, inp["L"]), steps=1, rounds=6)
            rows[f"{name}_L"] = {"ms": 1e3 * sec, "bound": b["L"]}
    return rows


def print_table(rows: Dict[str, dict], inp: dict, file=sys.stdout) -> None:
    print(f"config: B={inp['B']} T={inp['T']} I={inp['I']} H={inp['H']} L={inp['L']}", file=file)
    for n, label in (("1", "one layer fwd"), ("L", f"{inp['L']}-layer fwd")):
        k, h = rows[f"in_kernel_{n}"], rows[f"hoisted_{n}"]
        print(f"{label:14s}: in-kernel gi {k['ms']:8.3f} ms   hoisted gi {h['ms']:8.3f} ms   "
              f"bound {k['bound'][0]:.4f} ms ({k['bound'][1]})", file=file)


def main() -> int:
    print(profiling.card_line())
    inp = make_inputs()
    out = probe(inp)
    torch.cuda.synchronize()
    if not all(torch.isfinite(v).all() for v in out.values()):
        raise AssertionError("a probe's output is not finite")
    print_table(measure(inp), inp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
