"""Each cell of ``BENCHMARK.json``, run short on the card as the check runs
it: exit 0 and correct, untraced and traced. Skips without a card."""

import json
import subprocess
import sys

import pytest

from perfbench import spec

CELLS = [w["name"] for w in spec.bench()["workloads"] if w["chips"] == 1]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name, trace):
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", name, "--seed", str(2**31 + 77),
                          "--seconds", "3", "--trace", str(trace)], cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
