"""Where a step of the persistent generation kernel's time goes.

Run by path from the root of a checkout, on a CUDA card:

    python3 molvax_torch/probes/generate_probe.py

It rebuilds ``csrc/generate.cu`` (with the headers it includes) in each
variant of ``VARIANTS`` under ``build/generate_probe/``, and times one
greedy decode of the persistent instance at ``zinc250k`` width (B=256,
T=120, 3 x GRU-501, C=37, seeded weights) with each: CUDA events, median
of 5 after 2 warm-ups, with the card's name and power limit, one JSON line
per variant. A variant takes a part of the step out (results wrong, times
only): the group barriers (``nobarrier``), the tensor-core products, whose
operands stay live (``noproduct``), the reads of the h row block from L2,
whose registers become zeros (``nocopy``), the weight fragments'
shared-memory reads (``noldsm``: registers made from the address), or
several of them (``empty``: all but the fragment reads; ``bare``: all).
``head_split`` is the other placement of the head (its logits in one block
per m16 tile of the group's rows, then one more barrier a step) in place of
every block computing the whole group's head; ``prefetchN`` keeps N blocks
of 32 columns of the row block in flight a thread. Differences between the
variants' times are the parts' costs; a variant may let the compiler drop
more than was taken out, which the reading must allow for. Each row holds
the registers and stack bytes a thread of the 3-layer instance takes
(ptxas); the base variant's row also the wrapper's set-up (giz1's GEMM,
the packed weights) and the row-block instance's decode at the same width.
"""

from __future__ import annotations

import json
import re
import shutil
import sys
from pathlib import Path

import torch

_NOBARRIER = [("__device__ __forceinline__ void group_barrier(int* flag, int target) {\n",
               "__device__ __forceinline__ void group_barrier(int* flag, int target) {\n"
               "  if (target > 0) {\n    __syncthreads();\n    return;\n  }\n")]
# an empty asm that reads the operands keeps their loads, and costs no instruction
_NOPRODUCT = [("  mma_bf16(d, a, b);\n",
               '  asm volatile("" ::"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));\n')]
_NOCOPY = [("{ return __ldcg(p); }", "{ return make_uint4(0u, 0u, 0u, 0u); }")]
# the other head placement: warp w of block w alone computes the logits and
# codes of m16 tile w (rows / 16 <= q), the other warps gh_L only; one more
# barrier a step, after which every block reads the step's codes back
_HEAD_SPLIT = [
    ("      group_barrier(a.flags + grp, a.q * (t * L + l + 1));",
     "      group_barrier(a.flags + grp, a.q * (t * (L + 1) + l + 1));"),
    ("    warp_product<3 + GEN_NT_OUT>(xa, xb, kb, tiles, acc);\n",
     "    if (warp == jb)\n"
     "      warp_product<3 + GEN_NT_OUT>(xa, xb, kb, tiles, acc);\n"
     "    else\n"
     "      warp_product<3>(xa, xb, kb, reinterpret_cast<const uint32_t(&)[3]>(tiles),\n"
     "                      reinterpret_cast<float(&)[3][4]>(acc));\n"),
    ("    head_codes(a, acc, b_out, t, row, tq, code);\n    if (jb == 0 && tq == 0) {\n",
     "    if (warp == jb) head_codes(a, acc, b_out, t, row, tq, code);\n    if (warp == jb && tq == 0) {\n"),
    ("      if (rok[2]) a.codes[(size_t)rowB * a.T + t] = code[1];\n    }\n",
     "      if (rok[2]) a.codes[(size_t)rowB * a.T + t] = code[1];\n    }\n"
     "    group_barrier(a.flags + grp, a.q * (t * (L + 1) + L + 1));\n"
     "    code[0] = rok[0] ? __ldcg(a.codes + (size_t)rowA * a.T + t) : 0;\n"
     "    code[1] = rok[2] ? __ldcg(a.codes + (size_t)rowB * a.T + t) : 0;\n"),
]
# the weight fragments' shared-memory reads: registers made from the address instead
_NOLDSM = [('  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\\n"\n'
            '               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])\n'
            '               : "r"(addr));\n',
            "  r[0] = addr, r[1] = addr ^ 1u, r[2] = addr ^ 2u, r[3] = addr ^ 3u;\n")]
GEN_PF = 3  # the source's prefetch depth (csrc/generate.cu GEN_PF)
VARIANTS = {
    "base": [],
    "nobarrier": _NOBARRIER,
    "noproduct": _NOPRODUCT,
    "nocopy": _NOCOPY,
    "noproduct_nocopy": _NOPRODUCT + _NOCOPY,
    "empty": _NOBARRIER + _NOPRODUCT + _NOCOPY,
    "noldsm": _NOLDSM,
    "bare": _NOBARRIER + _NOPRODUCT + _NOCOPY + _NOLDSM,
    "head_split": _HEAD_SPLIT,
}
# the h row block's blocks of 32 columns in flight a thread
for _pf in (2, 4):
    VARIANTS[f"prefetch{_pf}"] = [(f"constexpr int GEN_PF = {GEN_PF};", f"constexpr int GEN_PF = {_pf};")]


def registers(log: str, kernel: str) -> dict:
    """A kernel's registers and stack bytes a thread, from ptxas' report."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line and kernel in line:
            used = next(x for x in lines[i + 1: i + 4] if "Used" in x)
            stack = re.search(r"(\d+) bytes cumulative stack", used)
            return {"registers": int(re.search(r"Used (\d+) registers", used).group(1)),
                    "stack_bytes": int(stack.group(1)) if stack else 0}
    return {}


def step_times(root: Path) -> list:
    """The greedy decode in every variant, each built from a copy of
    csrc/generate.cu and its headers under build/generate_probe/."""
    from molvax_torch.kernels import _build
    from molvax_torch.kernels import generate as kg
    from molvax_torch.probes.stack_probe import build_variant, make_decoder, variant_source
    from molvax_torch.train.profiling import event_ms

    model, cfg, z_emb = make_decoder()
    B, T = z_emb.shape[0], cfg.max_len
    plan = kg.generate_plan(B, cfg.charset_size, cfg.gru_hidden, cfg.gru_layers, *kg.card_limits(z_emb.device))
    src = Path(kg.__file__).resolve().parent / "csrc"
    rows = []
    for name in VARIANTS:
        d = root / "build" / "generate_probe" / name / "csrc"
        shutil.rmtree(d.parent, ignore_errors=True)
        d.mkdir(parents=True)
        for f in src.glob("*.cuh"):
            shutil.copy(f, d)
        (d / "generate.cu").write_text(variant_source((src / "generate.cu").read_text(), name, VARIANTS))
        build_variant(d)
        ms = event_ms(lambda: kg.fused_generate(model, cfg, z_emb, 0))
        row = {"variant": name, "B": B, "T": T, "plan": plan.__dict__, "decode_ms": ms, "us_per_step": ms * 1e3 / T,
               "barriers_per_step": cfg.gru_layers + name.endswith("head_split"),
               **registers(_build.info.log, f"gen_persistent_kernelILi{cfg.gru_layers}E")}
        if name == "base":
            with torch.no_grad():
                row["setup_ms"] = event_ms(lambda: kg._setup(model, z_emb, plan))
                row["row_block_decode_ms"] = event_ms(lambda: kg._decode(model, cfg, z_emb, 0, True, 1.0,
                                                                          row_block=True))
        rows.append(row)
    return rows


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("generate_probe: CUDA is not available; this probe runs on a GPU", file=sys.stderr)
        return 2
    root = Path.cwd()
    sys.path.insert(0, str(root))
    from molvax_torch.train.profiling import card_line

    card = card_line()
    for row in step_times(root):
        print(json.dumps({**row, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
