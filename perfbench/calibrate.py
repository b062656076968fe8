"""Readings for the limits of a cell's check, on the card, in one process.

    python3 -m perfbench.calibrate --workload <cell> --seeds 1,2,... [--control-seeds 1,2,3]
        [--witness-seeds 1,2] [--seconds 1]

For each seed it runs the cell's set-up and a window of ``--seconds``
(none for training: its check reads the set-up's first chunk) and prints
one JSON line of the numbers its check compares: the program's against the
reference (the lower readings), and on the control seeds those of the
reference computed in fp8 in the program's place (the control) and, for
training, of the reference with half of each batch left out (a fault). On
the witness seeds (training) it prints those of the reference in bf16, the
configurations' precision, against itself in fp32. The
cell's limits lie between the largest lower reading and the smallest
upper one (``PERF.md``).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import run
from .harness import TraceWindow, make_context, traffic_module


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    run._cache_dirs()
    control = {int(s) for s in args.control_seeds.split(",") if s}
    witness = {int(s) for s in args.witness_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        ctx = make_context(args.workload, seed, args.device)
        kind = traffic_module(ctx.mix["kind"])
        kind.setup(ctx)
        if ctx.mix["kind"] != "train":
            kind.window(ctx, args.seconds, TraceWindow(ctx, False))
        kind.release(ctx)
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        got = kind.readings(ctx, seed in control, **({"witness": True} if seed in witness else {}))
        print(json.dumps({"workload": args.workload, "seed": seed, **got,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del ctx
        gc.collect()
    if run.forbidden_modules():
        print(f"forbidden modules loaded: {run.forbidden_modules()}", file=sys.stderr)
        return 5
    return 0


if __name__ == "__main__":
    sys.exit(main())
