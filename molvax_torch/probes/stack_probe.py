"""Where the GRU stack's time goes on the card, and the GRU kernels of one
checkout against another's.

Run by path from the root of a checkout, on a CUDA card:

    python3 molvax_torch/probes/stack_probe.py             # times at zinc250k width
    python3 molvax_torch/probes/stack_probe.py --steps     # a recurrence step decomposed
    python3 molvax_torch/probes/stack_probe.py --root DIR  # the times of the checkout at DIR

Every mode prints one JSON line per run, with the card's name and power
limit. Times are CUDA events, median of 5 after 2 warm-ups, at B=256,
T=120, I0=329, H=501, L=3, seeded weights (uniform +-1/sqrt(H)):

- default and ``--root``: the stack's forward and backward
  (``kernels.gru_stack.stack_forward`` / ``stack_backward``), and the GRU
  kernels beside it: ``gru_layer_scan_x`` bf16 forward and backward at
  layer 0, ``gru_layer_scan`` forward and backward, ``gru_probe_scan``
  (``matmul_only``) and ``gru_fused3_scan``. With ``--root`` the package is
  imported from DIR, so a parent commit unpacked there (``git archive``)
  and this checkout can be timed in turns on one card (parent, change,
  change, parent). The default mode adds the redesigned stack's own pieces
  (one layer's recurrence and sweep, the layer-0 input-gate GEMM) and the
  host time to enqueue a forward and a backward.
- ``--steps``: the recurrence and the sweep of one layer, rebuilt with parts
  of their step taken out (results wrong, times only): the group barrier
  (``nobarrier``), the per-step product with its h / dgh copy
  (``noproduct``), both, and then the per-step loads or stores as well.
  Differences between the variants' times are the parts' costs. A variant
  may let the compiler drop more than was taken out (without stores, the
  forward's gate math has no use), which the reading must allow for.
"""

from __future__ import annotations

import json
import shutil
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
VARIANTS = {
    "base": [],
    "nobarrier": _NOBARRIER,
    "noproduct": _NOPRODUCT,
    "neither": _NOBARRIER + _NOPRODUCT,
    "neither_noloads": _NOBARRIER + _NOPRODUCT + _NOLOADS,
    "neither_nostores": _NOBARRIER + _NOPRODUCT + _NOSTORES,
    "empty": _NOBARRIER + _NOPRODUCT + _NOLOADS + _NOSTORES,
}


def variant_source(text: str, name: str) -> str:
    """csrc/gru_stack.cu's text with variant ``name``'s parts taken out."""
    for old, new in VARIANTS[name]:
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    return text


def make_inputs(device: str = "cuda:0", seed: int = 0) -> dict:
    g = torch.Generator(device=device).manual_seed(seed)
    k = 1.0 / H ** 0.5

    def u(*shape):
        return (2.0 * torch.rand(*shape, generator=g, device=device) - 1.0) * k

    args = (torch.randn(T, B, I0, generator=g, device=device), u(3 * H, I0), u(3 * H), u(L - 1, 3 * H, H),
            u(L - 1, 3 * H), u(L, 3 * H, H), u(L, 3 * H), torch.zeros(L, B, H, device=device))
    return {"args": args, "dY": 1e-2 * torch.randn(T, B, H, generator=g, device=device),
            "dhf": 1e-2 * torch.randn(L, B, H, generator=g, device=device)}


def kernel_times(inp: dict, own: bool) -> dict:
    """The GRU kernels' times, ms, with the package on sys.path; ``own``
    adds the redesigned stack's pieces and the host's enqueue times."""
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
        lres = (*kgru.layer_forward(*layer, bf), x0, h0[0], wih0, whh[0])
        out["layer_x_fwd_bf16"] = event_ms(lambda: kgru.layer_forward(*layer, bf))
        out["layer_x_bwd_bf16"] = event_ms(lambda: kgru.layer_backward(lres, dY))
        gi = x0 @ wih0.T + bih0
        sres = (*kgru.scan_forward(gi, whh[0], bhh[0], h0[0]), h0[0], whh[0])
        out["scan_fwd"] = event_ms(lambda: kgru.scan_forward(gi, whh[0], bhh[0], h0[0]))
        out["scan_bwd"] = event_ms(lambda: kgru.scan_backward(sres, dY))
        out["matmul_only"] = event_ms(lambda: kgru.gru_probe_scan(gi, whh[0], bhh[0], h0[0], "matmul_only"))
        out["fused3"] = event_ms(lambda: ks.gru_fused3_scan(gi.to(bf), wih, bih, whh, bhh, h0))
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


def step_times(inp: dict, root: Path) -> list:
    """One layer's recurrence and sweep in every variant of VARIANTS, each
    built from a copy of csrc/ under build/stack_probe/."""
    from molvax_torch.kernels import _build
    from molvax_torch.kernels import gru_stack as ks
    from molvax_torch.train.profiling import event_ms

    x0, wih0, bih0, _, _, whh, bhh, h0 = inp["args"]
    with torch.no_grad():
        gi = x0 @ wih0.T + bih0
        hseq, rzn, ghn = ks.layer_recurrence_ref(gi, whh[0], bhh[0], h0[0])
    src = Path(ks.__file__).resolve().parent / "csrc"
    rows = []
    for name in VARIANTS:
        d = root / "build" / "stack_probe" / name / "csrc"
        shutil.rmtree(d.parent, ignore_errors=True)
        shutil.copytree(src, d)
        (d / "gru_stack.cu").write_text(variant_source((src / "gru_stack.cu").read_text(), name))
        _build.CSRC, _build.BUILD_DIR, _build._lib = d, d.parent / "lib", None
        _build.load()
        with torch.no_grad():
            rec = event_ms(lambda: ks.layer_recurrence(gi, whh[0], bhh[0], h0[0]))
            sweep = event_ms(lambda: ks.layer_sweep(hseq, h0[0], rzn, ghn, whh[0], inp["dY"], h0[0]))
        rows.append({"variant": name, "recurrence_ms": rec, "recurrence_us_per_step": rec * 1e3 / T,
                     "sweep_ms": sweep, "sweep_us_per_step": sweep * 1e3 / T})
    return rows


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("stack_probe: CUDA is not available; this probe runs on a GPU", file=sys.stderr)
        return 2
    root = Path(argv[argv.index("--root") + 1]).resolve() if "--root" in argv else Path.cwd()
    sys.path.insert(0, str(root))
    from molvax_torch.train.profiling import card_line

    inp = make_inputs()
    card = card_line()
    if "--steps" in argv:
        for row in step_times(inp, root):
            print(json.dumps({**row, "card": card}), flush=True)
    else:
        print(json.dumps({"root": str(root), **kernel_times(inp, own="--root" not in argv), "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
