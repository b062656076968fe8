"""A cell on several chips: one process per card, one world, one mesh.

``launch`` starts ``chips`` processes of this module, each with its rank;
they join one ``torch.distributed`` world over ``tcp://localhost`` (NCCL on
cards, gloo on the CPU), build the program's data-parallel mesh over it
(``parallel.make_mesh``) and run the cell with it (``harness.run_cell``).
Rank 0 runs the check and reports; the peak memory reported is the fullest
card's, and each rank reports the JAX modules it holds after its window.
``launch`` waits for every rank.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

from . import spec


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(name: str, seed: int, seconds: float, trace: bool, chips: int, device: str, wall_start: float,
           timeout: float = 3000.0, parts=None) -> dict:
    """Run cell ``name`` on ``chips`` ranks (``device`` 'cuda' or 'cpu');
    rank 0's result, with ``memory_peak_bytes`` the ranks' largest and
    ``forbidden`` every rank's JAX modules. ``parts``: set-up parts that
    this process timed before it started the ranks."""
    args = {"name": name, "seed": seed, "seconds": seconds, "trace": trace, "world": chips, "device": device,
            "port": _free_port(), "wall_start": wall_start, "parts": parts or {}}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(spec.ROOT), os.environ.get("PYTHONPATH")])))
    procs = [subprocess.Popen([sys.executable, "-m", f"{__package__}.ranks", json.dumps(dict(args, rank=r))],
                              cwd=spec.ROOT, env=env, stdout=subprocess.PIPE, text=True) for r in range(chips)]
    outs, codes = [], []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            codes.append(p.returncode)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise RuntimeError(f"ranks exited with {codes}")
    return json.loads(outs[0].strip().splitlines()[-1])


def rank_main(args: dict) -> None:
    t_start = time.perf_counter() - (time.time() - args["wall_start"])
    t0 = time.perf_counter()
    import torch
    import torch.distributed as dist

    parts = dict(args["parts"], import_torch=time.perf_counter() - t0)

    from . import run
    from .harness import run_cell

    run._cache_dirs()
    rank, world = args["rank"], args["world"]
    if args["device"] == "cuda":
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
        dev = torch.device(f"cuda:{rank}")
        t0 = time.perf_counter()
        torch.cuda.set_device(dev)
        parts["cuda_init"] = time.perf_counter() - t0
        backend = "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    t0 = time.perf_counter()
    dist.init_process_group(backend, init_method=f"tcp://localhost:{args['port']}", rank=rank, world_size=world)
    try:
        from molvax_torch.parallel import make_mesh

        mesh = make_mesh(None, device=dev)
        parts["mesh"] = time.perf_counter() - t0
        res = run.as_plain(run_cell(args["name"], args["seed"], args["seconds"], args["trace"], dev, t_start, mesh,
                                    rank, world, parts))
        mine = {"memory": res["memory_peak_bytes"], "forbidden": run.forbidden_modules()}
        every = [None] * world
        dist.all_gather_object(every, mine, group=mesh.host_group)
        res["memory_peak_bytes"] = max(e["memory"] for e in every)
        res["forbidden"] = sorted({m for e in every for m in e["forbidden"]})
        if rank == 0:
            print(json.dumps(res), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    rank_main(json.loads(sys.argv[1]))
