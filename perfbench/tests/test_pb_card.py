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


@pytest.mark.card
def test_the_constrained_window_only_replays(card):
    """The constrained cell's set-up warms its key to the capture, so its
    window holds no capture and no op-by-op step: the program's counters
    read no capture and a replay a request, and the traced window has no
    ``sample.capture`` or ``sample.step`` span, one ``sample.replay`` a
    request, which takes part of the request's host time (under the
    profiler a replay's launch is slower than untraced: the test below)."""
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "zinc250k.sample_constrained",
                          "--seed", str(2**31 + 79), "--seconds", "3", "--trace", "1"], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    notes = [ln for ln in out.stderr.splitlines() if ln.startswith("perfbench: window_graph_captures_replays: ")]
    captures, replays = json.loads(notes[-1].split(": ", 2)[2])
    assert captures == 0 and replays == line["attempted"]
    rows = [ln.split()[1:4] for ln in out.stderr.splitlines() if ln.startswith("perfbench:   ")]  # the span table
    spans = {name: int(n) for name, n, _ in rows}
    assert "molvax:sample.capture" not in spans and "molvax:sample.step" not in spans
    assert spans["molvax:sample.replay"] == spans["sample_prior"] == 8
    request_ms = {name: float(ms) for name, _, ms in rows}["sample_prior"] / 8
    assert 0 < line["metrics"]["replay_ms.sample"]["value"] < request_ms


UNTRACED_REPLAY = """
import json, statistics, time
import torch
from perfbench import corpus, run
from perfbench.harness import make_context, traffic_module
from molvax_torch.latent import sample as program

run._cache_dirs()
torch.set_num_threads(1)
ctx = make_context("zinc250k.sample_constrained", 2**31 + 83, "cuda:0")
kind = traffic_module("sample")
kind.setup(ctx)
took, replay = [], program.CapturedDecode.replay


def timed(self, z, seed):
    t0 = time.perf_counter()
    out = replay(self, z, seed)
    took.append(time.perf_counter() - t0)
    return out


program.CapturedDecode.replay = timed
lat = []
for i in range(40):
    t0 = time.perf_counter()
    kind.request(ctx, corpus.request_seed(ctx.seed, i))
    lat.append(time.perf_counter() - t0)
print(json.dumps({"replays": len(took), "replay_ms": 1e3 * statistics.median(took),
                  "request_ms": 1e3 * statistics.median(lat)}))
"""


@pytest.mark.card
def test_an_untraced_replay_holds_the_host_under_a_millisecond(card):
    """With no profiler running, the constrained cell's requests after its
    set-up are replays, and ``CapturedDecode.replay`` (the inputs' copies,
    ``graph.replay()`` and the outputs' copies: what ``sample.replay``
    spans, and the copies out) holds the host under 1 ms a request, by the
    host's clock: ``replay_ms.sample`` reads the traced cost."""
    out = subprocess.run([sys.executable, "-c", UNTRACED_REPLAY], cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["replays"] == 40
    assert 0 < got["replay_ms"] < 1.0 and got["replay_ms"] < got["request_ms"], got
