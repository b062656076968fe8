"""A copy of the benchmark in a temporary directory with cells of its own.

The copy holds ``BENCHMARK.json`` and ``perfbench/`` as the repository has
them, plus a tiny configuration and its cells, added as new files only.
Runs of the copy go through a child process whose path puts the copy
before the repository (whose ``molvax_torch`` it runs).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_SIZES = dict(max_len=24, latent_dim=8, conv_channels=[3, 3, 4], conv_kernels=[3, 3, 3], enc_hidden=16,
                  gru_hidden=32, gru_layers=2, batch_size=16, train_chunk_size=4, n_synthetic=64)
# set from CPU readings of twelve seeds (the program) and eight (the control)
TINY_LIMITS = {"train": {"data_rows": 0, "loss_gap": 1.6e-4, "adam_m_median": 1.2e-3, "update_gap": 0.03},
               "sample": {"logit_gap": 3e-3}}
TINY_CELLS = {
    "tiny.train": {"kind": "train", "corpus_rows": 64, "len_min": 4, "len_max": 20, "trace_units": 2},
    "tiny.sample": {"kind": "sample", "rows": 32, "greedy": False, "temperature": 1.0, "constrained": False,
                    "trace_units": 2},
    "tiny.sample_greedy": {"kind": "sample", "rows": 32, "greedy": True, "temperature": 1.0, "constrained": False,
                           "trace_units": 2},
    "tiny.sample_constrained": {"kind": "sample", "rows": 32, "greedy": False, "temperature": 1.0,
                                "constrained": True, "trace_units": 2},
}


def make(root: Path, cells=TINY_CELLS, chips: int = 1) -> Path:
    """``root`` holding the copy with the tiny cells; returns ``root``."""
    shutil.copytree(REPO / "perfbench", root / "perfbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    conf = json.loads((REPO / "perfbench" / "configs" / "zinc250k.json").read_text())
    conf["name"] = "tiny"
    conf["sizes"].update(TINY_SIZES)
    conf["overrides"] = {"model.max_len": 24, "model.latent_dim": 8, "model.conv_channels": [3, 3, 4],
                         "model.conv_kernels": [3, 3, 3], "model.enc_hidden": 16, "model.gru_hidden": 32,
                         "model.gru_layers": 2, "train.batch_size": 16, "train.train_chunk_size": 4,
                         "data.n_synthetic": 64, "data.max_len": 24}
    (root / "perfbench" / "configs" / "tiny.json").write_text(json.dumps(conf))
    for name, mix in cells.items():
        mix_name = name.replace(".", "_")
        (root / "perfbench" / "traffic" / f"{mix_name}.json").write_text(json.dumps(mix))
        (root / "perfbench" / "workloads" / f"{name}.json").write_text(json.dumps({"limits": TINY_LIMITS[mix["kind"]]}))
        bench["workloads"].append({"name": name, "config": "tiny", "traffic": mix_name, "chips": chips,
                                   "why": "a test cell"})
        like = ("zinc250k.train" if mix["kind"] == "train" else
                "zinc250k.sample_constrained" if mix["constrained"] else "zinc250k.sample")
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def python(root: Path, code: str, timeout: float = 600) -> subprocess.CompletedProcess:
    """Run ``code`` in a child Python whose path finds the copy first."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), str(REPO)]))
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True, text=True,
                          timeout=timeout)


RUN = """
import json, sys
from perfbench.harness import run_cell
from perfbench.run import as_plain, forbidden_modules, result_line
res = as_plain(run_cell({name!r}, {seed}, {seconds}, {trace}, "cpu"))
line = result_line(res, {trace}, 1)
line["forbidden"] = forbidden_modules()
print(json.dumps(line))
"""


def run_cell(root: Path, name: str, seed: int = 2**31 + 11, seconds: float = 1.0, trace: bool = False,
             prelude: str = "") -> dict:
    """A CPU run of cell ``name`` of the copy: its result line (with the
    JAX modules the child held under ``forbidden``). ``prelude`` runs
    first (a fault planted under the timed path)."""
    out = python(root, prelude + RUN.format(name=name, seed=seed, seconds=seconds, trace=trace))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])
