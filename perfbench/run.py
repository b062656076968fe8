"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It needs as many CUDA cards as the cell's ``chips``, and exits with 4,
printing no result, where there are fewer. A cell on more than one chip
runs one process per card (``ranks.py``); this process then starts them and
prints what rank 0 reports. The checks go to standard error as its last
lines, each number beside its limit; the last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and, traced, ``breakdown``), then ``checks``. Before the
checks, standard error has the set-up's parts and what no part holds, the
card and the host (CPU model, load average), and in a traced run the table
of the spans of the traced window, the program's and the harness's. Where
a module of JAX or of the JAX package ``molvax`` is loaded once the window
has closed, the run exits with 5 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()
WALL_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from . import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "molvax")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``molvax_torch`` is not ``molvax``."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _cache_dirs() -> None:
    """Build and kernel caches inside the checkout, at fixed paths (the
    kernel library itself is kept in ``build/molvax_torch/``)."""
    base = spec.ROOT / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["USE_FLAX"] = "0"


def result_line(res: dict, trace: bool, count: int) -> dict:
    from .harness import correct

    device = {"platform": "gpu", "kind": res["device"], "count": count, "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": correct(res["checks"]), "attempted": res["attempted"], "failed": res["failed"],
           "metrics": res["metrics"], "device": device}
    reading = res.get("reading")
    if trace and reading is not None:
        device["busy_s"], device["window_s"] = reading["busy_s"], reading["window_s"]
        out["breakdown"] = reading["breakdown"]
    # a number that is not finite has failed; JSON has no such number, so it reads null
    out["checks"] = {name: {"value": v if math.isfinite(v) else None, "limit": lim} for name, v, lim in res["checks"]}
    return out


def as_plain(res: dict) -> dict:
    """``harness.run_cell``'s result with its trace reading as plain data."""
    r = res.get("reading")
    if r is not None:
        res = dict(res, reading={"busy_s": r.busy_s, "window_s": r.window_s, "breakdown": r.breakdown(),
                                 "span_s": r.span_s, "span_n": r.span_n})
    return res


def setup_lines(res: dict) -> list:
    """The set-up's parts, and the seconds of ``setup_s`` that no part holds
    (the harness's imports, the collection before the window, and on
    several cards the launcher's start and its ranks' start)."""
    parts = res["parts"]
    rest = res["setup_s"] - sum(parts.values())
    return [f"set-up parts: {' '.join(f'{k}={v:.3f}s' for k, v in parts.items())}",
            f"set-up: setup_s={res['setup_s']:.3f}s, in parts {sum(parts.values()):.3f}s, in no part {rest:.3f}s"]


def cpu_model() -> str:
    """The host's CPU model as ``/proc/cpuinfo`` names it (the first of the
    keys that x86 and Arm kernels use), else its vendor, family and model
    numbers, else the platform's own name."""
    import platform

    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                key, _, value = ln.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    known = {k: v for k, v in fields.items() if v and v != "unknown"}
    name = next((known[k] for k in ("model name", "Model", "Hardware", "cpu model", "CPU part") if k in known), None)
    if name is None and "vendor_id" in known:
        name = f"{known['vendor_id']} family {known.get('cpu family', '?')} model {known.get('model', '?')}"
    return name or platform.processor() or platform.machine() or "unknown"


def machine_line(kind: str, count: int) -> str:
    """The card and the host it shares: the CPU model, cores and load
    average (read from ``/proc``), and the cards' power limit where
    ``nvidia-smi`` reads it."""
    try:
        with open("/proc/loadavg") as f:
            load = " ".join(f.read().split()[:3])
    except OSError:
        load = "unknown"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20).stdout.split("\n")
        limit = ", ".join(x.strip() for x in smi[:count] if x.strip()) or "unknown"
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return (f"card: {kind} x{count}, power limit {limit}; host: {cpu_model()}, "
            f"{os.cpu_count()} cores, load average {load}")


def span_lines(res: dict) -> list:
    """The traced window's spans: count, host ms, and ms a request (sample
    mixes) or a step (training), by name."""
    reading, traced = res.get("reading"), res.get("traced", {})
    if reading is None:
        return []
    unit = "request" if traced.get("requests") else "step"
    units = traced.get("requests") or traced.get("steps") or 0
    out = [f"spans of the traced window ({units} {unit}s, {reading['window_s'] * 1e3:.3f} ms): "
           f"name, count, total ms, ms a {unit}"]
    for name, sec in sorted(reading["span_s"].items(), key=lambda kv: -kv[1]):
        per = f"{1e3 * sec / units:.4f}" if units else "-"
        out.append(f"  {name:<28} {reading['span_n'][name]:>7} {1e3 * sec:>12.4f} {per:>10}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    chips = int(cell["chips"])
    _cache_dirs()
    t0 = time.perf_counter()
    import torch

    t_torch = time.perf_counter() - t0
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: cell {args.workload} needs {chips} CUDA card(s); this machine has {have}", file=sys.stderr)
        return 4
    if chips == 1:
        from .harness import run_cell

        res = as_plain(run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START,
                                parts={"import_torch": t_torch}))
    else:
        from .ranks import launch

        res = launch(args.workload, args.seed, args.seconds, bool(args.trace), chips, "cuda", WALL_START,
                     parts={"launcher_import_torch": t_torch})
    loaded = sorted(set(forbidden_modules()) | set(res.get("forbidden", [])))
    if loaded:
        print(f"perfbench: modules of JAX or of the JAX package were loaded: {', '.join(loaded)}", file=sys.stderr)
        return 5
    for ln in setup_lines(res) + [machine_line(res["device"], chips)] + span_lines(res):
        print(f"perfbench: {ln}", file=sys.stderr)
    for k, v in res.get("notes", {}).items():
        print(f"perfbench: {k}: {v}", file=sys.stderr)
    line = result_line(res, bool(args.trace), chips)
    for name, v, lim in res["checks"]:
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
