"""The constrained-decoding automaton per step, and the int32-op floor.

Port of the entry point of ``bench/auto_loop_probe.py``. Its TPU probe
``mosaic_loop`` (T automaton steps inside one kernel) is ``auto_step``'s
n-step mode (``csrc/automaton.cu``, ported with the automaton); its
``floor_loop`` is ``kernels.floor.floor_loop`` (``csrc/floor.cu``). Run on a
CUDA card:

    python -m molvax_torch.probes.auto_loop_probe [B [T]]
    python -m molvax_torch.probes.auto_loop_probe --floor
    python -m molvax_torch.probes.auto_loop_probe --variants
    python -m molvax_torch.probes.auto_loop_probe --floor-variants

At B=256, T=120, with one seeded score row per batch element for every step
(as the reference): µs per step of the plain ``select_advance`` loop
(``auto_step_plain``), of ``auto_step`` as T launches of n=1 and as one
launch of n=T, and the per-step budget the reference set (a constrained
decode of >= 120,000 SMILES/s) on top of this card's own ``fused_generate``
time. ``--floor``: ns per int32 op inside a kernel loop, by differencing
k_ops 64 -> 256 -> 1024 at T=120, at the reference's shapes (128, 16) and
(16, 128) and at (256, 32), one warp per row at B=256, each with its fixed
cost (the intercept of a line through the three times); and one warp of
single chains (``LATENCY_SHAPE``), whose ns per op is one op's dependent
latency: times T ceil(k_ops / chains) it gives a shape's latency floor
(``floor_latency_ms``), beside ``floor_bound``'s throughput bound. ``--variants``:
the automaton kernel rebuilt in each variant of ``VARIANTS`` (under
``build/auto_probe/``): 4 (kept), 2, 8 or 16 rows (warps) a block, each
checked against the plain version on one n=T walk; and the kept kernel
without its transition, its pool scan or its closable slots' reductions
(times only); each timed as ``stack_probe.automaton_times`` times it
(events and the profiler's device time), with its registers.
``--floor-variants``: ``csrc/floor.cu`` rebuilt with each form of its op in
``FLOOR_VARIANTS`` (under ``build/auto_probe/``), each held bit for bit to
the plain version and then measured as ``--floor`` measures.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from ..config import get_preset
from ..data.charset import DEFAULT_CHARSET
from ..kernels import automaton as kauto
from ..kernels import floor as kfloor
from ..kernels import generate as kg
from ..latent.constrain import build_tables
from ..nn.decoder import latent_embed
from ..nn.vae import MolecularVAE
from ..train import profiling
from ..utils import resolve_device

B, T = 256, 120
TARGET_SMILES_S = 120_000  # the reference's goal for constrained decoding
FLOOR_SHAPES: Tuple[Tuple[int, int], ...] = ((128, 16), (16, 128), (256, 32))
FLOOR_K = (64, 256, 1024)
FLOOR_CHAINS = 4
LATENCY_SHAPE = (1, 32)  # one warp, one chain a lane: the dependent chain alone
# --variants: (csrc file, text, replacement) of each variant of the automaton
# kernel: the rows (warps) a block, then parts of a step taken out at the
# kept rows a block (results wrong, times only): the transition (each step
# masks the same state), the pool scan of _dup_wrt, the closable slots'
# anc_pc reductions
_WARPS = "constexpr int AUTO_WARPS = 4;"
VARIANTS = {
    "warps4": [],
    **{f"warps{w}": [("automaton.cu", _WARPS, f"constexpr int AUTO_WARPS = {w};")] for w in (2, 8, 16)},
    "no_advance": [("automaton.cuh", "      row_advance(t, w, popc(s.open));\n", "")],
    "no_pool_scan": [("automaton.cuh", "  const int used = imin(imax(pn, 0), P);", "  const int used = 0 * P;")],
    "no_anc_pc": [("automaton.cuh", "    if ((closing >> j) & 1u) {", "    if (false) {")],
}


# --floor-variants: (csrc file, text, replacement) of each form of floor.cu's
# op and loop: the kept form (a compare beside y - 1, then a predicated
# y + 1: two dependent levels an op; a loop of ops inside a loop of steps);
# the op with no predicate, y - 1 + 2 (max(y, t + 1) - max(y, t)) (three
# levels of integer ALU ops, exact at the int32 limits); one flat loop of
# T ops iterations, t advancing off the chain of y; and the loop of ops
# unrolled 1 or 4 times (the kept kernel leaves the unrolling to nvcc)
_FLOOR_OP = """  const unsigned lo = y - 1u, hi = y + 1u;
  return (int)y > t ? lo : hi;"""
_FLOOR_LOOP = """  for (int t = 0; t < T; ++t) {
    for (int k = 0; k < ops; ++k) y = floor_op(y, t);
  }"""
FLOOR_VARIANTS = {
    "select": [],
    "minmax": [("floor.cu", _FLOOR_OP, """  const int a = max((int)y, t + 1), b = max((int)y, t);
  return y - 1u + 2u * (unsigned)(a - b);""")],
    "flat": [("floor.cu", _FLOOR_LOOP, """  for (int t = 0, k = 0; t < T && ops > 0;) {
    y = floor_op(y, t);
    const bool next = ++k == ops;
    t += next;
    k = next ? 0 : k;
  }""")],
    **{f"unroll{n}": [("floor.cu", "    for (int k = 0; k < ops; ++k) y = floor_op(y, t);",
                       f"#pragma unroll {n}\n    for (int k = 0; k < ops; ++k) y = floor_op(y, t);")]
       for n in (1, 4)},
}


def make_inputs(B: int = B, T: int = T, device=None, seed: int = 0) -> dict:
    """Packed tables, one (B, C) score row per batch element from a seed,
    the same scores for each of T steps, and the packed start state."""
    dev = resolve_device(device)
    itab = kauto.pack_tables(build_tables(DEFAULT_CHARSET)).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    scores = torch.randn(B, itab.shape[1], generator=g, device=dev)
    return {"itab": itab, "scores": scores, "scores_T": scores[:, None].expand(-1, T, -1).contiguous(),
            "state0": kauto.new_state(B, T, dev), "B": B, "T": T,
            "floor_x": torch.ones(FLOOR_SHAPES[-1], dtype=torch.int32, device=dev)}


def _steps(step_fn, inp: dict, n: int):
    """``n`` single steps of step_fn (auto_step or auto_step_plain) on a
    state, rem counting down from T - 1."""
    def walk(state):
        for k in range(n):
            step_fn(inp["itab"], state, inp["scores"], inp["T"] - 1 - k)
    return walk


def _one_launch(inp: dict):
    return lambda state: kauto.auto_step(inp["itab"], state, inp["scores_T"], inp["T"] - 1)


def probe(inp: dict) -> Dict[str, torch.Tensor]:
    """One run of each probe kernel: the T-step walk as one launch (the
    TPU's mosaic_loop), and floor_loop at (256, 32), T steps of 64 ops."""
    state = inp["state0"].clone()
    codes = kauto.auto_step(inp["itab"], state, inp["scores_T"], inp["T"] - 1)
    floor = kfloor.floor_loop(inp["floor_x"], inp["T"], FLOOR_K[0], FLOOR_CHAINS)
    return {"codes": codes, "state": state, "floor": floor}


def _on_copies(fn, state0: torch.Tensor) -> float:
    """event_ms of fn(state) (2 warm-ups, 5 timed) on copies of state0 made
    before the timing."""
    pool = [state0.clone() for _ in range(7)]
    return profiling.event_ms(lambda: fn(pool.pop()))


def fused_generate_ms(B: int = B, device=None, seed: int = 0) -> float:
    """ms of one greedy ``fused_generate`` decode of B rows at ``zinc250k``
    width (T=120), weights from torch's seeded default init."""
    dev = resolve_device(device)
    cfg = get_preset("zinc250k").model
    torch.manual_seed(seed)
    model = MolecularVAE(cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        z_emb = latent_embed(model, cfg, torch.randn(B, cfg.latent_dim, generator=g, device=dev))
        return profiling.event_ms(lambda: kg.fused_generate(model, cfg, z_emb, 0))


def measure(inp: dict, fused_ms: Optional[float] = None, plain_steps: Optional[int] = None) -> Dict[str, float]:
    """µs per step of the plain loop (over ``plain_steps`` steps, default
    T), of T n=1 launches and of one n=T launch, and the budget."""
    T_, s0 = inp["T"], inp["state0"]
    n_plain = plain_steps or T_
    pool = [s0.clone() for _ in range(6)]
    plain_s = profiling.step_timer(lambda: _steps(kauto.auto_step_plain, inp, n_plain)(pool.pop()),
                                   steps=1, rounds=5)
    out = {"plain_us": plain_s * 1e6 / n_plain,
           "n1_us": _on_copies(_steps(kauto.auto_step, inp, T_), s0) * 1e3 / T_,
           "nT_us": _on_copies(_one_launch(inp), s0) * 1e3 / T_}
    if fused_ms is None:
        fused_ms = fused_generate_ms(inp["B"], s0.device)
    out["fused_us"] = fused_ms * 1e3 / T_
    out["budget_us"] = inp["B"] / TARGET_SMILES_S / T_ * 1e6 - out["fused_us"]
    return out


def floor_measure(device=None) -> Dict[Tuple[int, int], dict]:
    """Per shape of FLOOR_SHAPES (FLOOR_CHAINS chains) and LATENCY_SHAPE (1
    chain): ms of one floor_loop launch at T steps of each FLOOR_K ops
    (median of 9), ns per op from each pair of consecutive k_ops (the launch
    and the loop's own overhead cancel), and the fixed cost: the intercept
    at k_ops = 0 of the least-squares line through the times."""
    dev = resolve_device(device)
    rows = {}
    for shape, chains in [(s, FLOOR_CHAINS) for s in FLOOR_SHAPES] + [(LATENCY_SHAPE, 1)]:
        x = torch.ones(shape, dtype=torch.int32, device=dev)
        ms = {k: profiling.event_ms(lambda: kfloor.floor_loop(x, T, k, chains), reps=9) for k in FLOOR_K}
        ns = [(ms[hi] - ms[lo]) * 1e6 / T / (hi - lo) for lo, hi in zip(FLOOR_K, FLOOR_K[1:])]
        k_mean = sum(FLOOR_K) / len(FLOOR_K)
        ms_mean = sum(ms.values()) / len(ms)
        slope = (sum((k - k_mean) * (ms[k] - ms_mean) for k in FLOOR_K)
                 / sum((k - k_mean) ** 2 for k in FLOOR_K))
        rows[shape] = {"chains": chains, "ms": ms, "ns_per_op": ns, "fixed_ms": ms_mean - slope * k_mean}
    return rows


def floor_latency_ms(T_: int, k_ops: int, chains: int, ns_per_dependent_op: float) -> float:
    """The least time one chain's dependent ops take: T ceil(k_ops /
    chains) ops, each one op's dependent latency (``LATENCY_SHAPE``'s ns
    per op, measured on the same card)."""
    return T_ * -(-k_ops // chains) * ns_per_dependent_op * 1e-6


def floor_bound(shape: Tuple[int, int], T_: int, k_ops: int) -> tuple:
    """(bound ms, what binds) of one floor_loop launch: a compare and an add
    per op and element at the int32 rate, x read and the sums written."""
    n = shape[0] * shape[1]
    peaks = profiling.H100_SXM
    return profiling.bound_ms(2 * n * T_ * k_ops + n * (FLOOR_CHAINS - 1), 2 * n * 4, peaks.int32_tops * 1e12)


def _variant_csrc(root: Path, name: str, edits) -> Path:
    """A copy of csrc/ under build/auto_probe/<name>/ with ``edits`` made."""
    src = Path(kauto.__file__).resolve().parent / "csrc"
    d = root / "build" / "auto_probe" / name / "csrc"
    shutil.rmtree(d.parent, ignore_errors=True)
    shutil.copytree(src, d)
    for file, old, new in edits:
        text = (d / file).read_text()
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} is not in csrc/{file}")
        (d / file).write_text(text.replace(old, new))
    return d


def floor_variant_rows(root: Path) -> list:
    """floor.cu in each form of FLOOR_VARIANTS, built from a copy of csrc/:
    bit for bit against the plain version at (256, 32) with the int32
    limits, at 4, 3, 1 and 8 chains, then ``floor_measure``."""
    from .stack_probe import build_variant

    rows = []
    for name, edits in FLOOR_VARIANTS.items():
        build_variant(_variant_csrc(root, f"floor_{name}", edits))
        x = torch.randint(-64, 64, FLOOR_SHAPES[-1], dtype=torch.int32, device="cuda:0")
        x.view(-1)[:2] = torch.tensor([2**31 - 1, -(2**31)], dtype=torch.int32, device="cuda:0")
        for k_ops, chains in ((64, 4), (13, 3), (13, 1), (13, 8)):
            if not torch.equal(kfloor.floor_loop(x, T, k_ops, chains), kfloor.floor_loop_ref(x, T, k_ops, chains)):
                raise AssertionError(f"floor variant {name} differs from the plain version at {k_ops}, {chains}")
        rows.append({"variant": name, **{str(k): v for k, v in floor_measure().items()}})
    return rows


def variant_rows(root: Path) -> list:
    """The automaton kernel in each variant of VARIANTS, each built from a
    copy of csrc/ under build/auto_probe/: where the variant computes the
    same function (the rows per block), one n=T walk at B against the plain
    version (codes and state identical); then its times
    (``stack_probe.automaton_times``) and its three kernels' registers."""
    from ..kernels import _build
    from .generate_probe import registers
    from .stack_probe import automaton_times, build_variant

    rows = []
    for name, edits in VARIANTS.items():
        build_variant(_variant_csrc(root, name, edits))
        if name.startswith("warps"):
            inp = make_inputs()
            got, want = inp["state0"].clone(), inp["state0"].clone()
            codes = kauto.auto_step(inp["itab"], got, inp["scores_T"], inp["T"] - 1)
            same = torch.equal(codes, kauto.auto_step_plain(inp["itab"], want, inp["scores_T"], inp["T"] - 1))
            if not (same and torch.equal(got, want)):
                raise AssertionError(f"variant {name} differs from the plain version")
        automaton_times()  # the first timing of a build warms the card and the new library
        row = {"variant": name, **automaton_times()}
        for kernel in ("auto_step_kernel", "auto_mask_kernel", "auto_advance_kernel"):
            row[f"{kernel}_registers"] = registers(_build.info.log, kernel).get("registers")
        rows.append(row)
    return rows


def print_table(r: Dict[str, float], inp: dict, file=sys.stdout) -> None:
    T_ = inp["T"]
    print(f"plain loop : {r['plain_us'] * T_ / 1e3:10.3f} ms total  {r['plain_us']:9.2f} us/step  (B={inp['B']})",
          file=file)
    print(f"auto_step  : {r['n1_us'] * T_ / 1e3:10.3f} ms total  {r['n1_us']:9.2f} us/step  ({T_} launches of n=1)",
          file=file)
    print(f"auto_step  : {r['nT_us'] * T_ / 1e3:10.3f} ms total  {r['nT_us']:9.2f} us/step  (one launch of n={T_})",
          file=file)
    print(f"budget     : automaton must cost <= {r['budget_us']:.1f} us/step on top of this card's fused_generate "
          f"{r['fused_us']:.1f} us/step for >= {TARGET_SMILES_S:,} SMILES/s"
          + (" (unreachable: the unconstrained decode alone is slower)" if r["budget_us"] < 0 else ""), file=file)


def print_floor(rows, file=sys.stdout) -> None:
    dep_ns = rows[LATENCY_SHAPE]["ns_per_op"][-1]
    for shape, r in rows.items():
        steps = "  ".join(f"k={k}: {ms * 1e3 / T:7.3f} us/step" for k, ms in r["ms"].items())
        ns = ", ".join(f"{v:.4f}" for v in r["ns_per_op"])
        print(f"floor {shape} x {r['chains']} chains: {ns} ns/op, fixed {r['fixed_ms'] * 1e3:.2f} us  ({steps}; "
              f"at k={FLOOR_K[0]}: bound {floor_bound(shape, T, FLOOR_K[0])[0]:.6f} ms, latency floor "
              f"{floor_latency_ms(T, FLOOR_K[0], r['chains'], dep_ns):.6f} ms)", file=file)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    print(profiling.card_line())
    if "--floor" in argv:
        print_floor(floor_measure())
        return 0
    if "--floor-variants" in argv:
        for row in floor_variant_rows(Path.cwd()):
            print(json.dumps(row), flush=True)
        return 0
    if "--variants" in argv:
        for row in variant_rows(Path.cwd()):
            print(json.dumps(row), flush=True)
        return 0
    inp = make_inputs(*(int(a) for a in argv))
    out = probe(inp)
    torch.cuda.synchronize()
    if not torch.equal(out["floor"], kfloor.floor_loop_ref(inp["floor_x"], inp["T"], FLOOR_K[0], FLOOR_CHAINS)):
        raise AssertionError("floor_loop differs from its plain version")
    print_table(measure(inp), inp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
