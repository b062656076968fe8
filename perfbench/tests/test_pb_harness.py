"""The harness is driven by data, and its check fails a broken timed path.

A cell, a configuration, a traffic mix and a per-layer metric are added to
a copy of the benchmark as new files only (and entries in the copy's
``BENCHMARK.json``), and the harness runs the new cell. Then each fault
that a cell of one chip can have is planted under the timed path of a run,
which must come out not correct.
"""

import hashlib
import json

import pytest

from perfbench.tests import bench_copy

NEW_METRIC = '''"""Rows a request: the traced window's SMILES over its requests."""


def read(run):
    requests = run.traced.get("requests", 0)
    return run.traced["smiles"] / requests if requests else None
'''


def digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "perfbench").rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return bench_copy.make(tmp_path_factory.mktemp("pb_harness"))


def test_a_cell_config_mix_and_metric_are_added_as_files(tmp_path):
    before = digests(bench_copy.REPO)
    root = bench_copy.make(tmp_path)
    (root / "perfbench" / "metrics" / "rows_per_request.sample.py").write_text(NEW_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "rows_per_request.sample", "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "sample request (latent/sample.py)",
                               "moves": "sample_smiles_per_s", "workloads": ["tiny.sample"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digests(root)
    assert all(after[k] == v for k, v in before.items() if not k.startswith("perfbench/tests/"))
    line = bench_copy.run_cell(root, "tiny.sample", trace=True)
    assert line["correct"], line["checks"]
    assert line["metrics"]["rows_per_request.sample"] == {"value": 32.0, "unit": "rows"}
    assert {"idle_share.sample", "launches_per_step.sample"} <= set(line["metrics"]) or line["device"]["busy_s"] == 0
    plain = bench_copy.run_cell(root, "tiny.sample")
    assert set(plain["metrics"]) == {"sample_smiles_per_s", "sample_p95_ms", "setup_s"}


def test_a_constrained_cell_reports_its_tail_per_layer(tiny):
    from perfbench.harness import Run, metric_reader

    read = metric_reader("request_p95_ms.sample")
    lat = [9.0, 9.0] + [0.001 * (k + 1) for k in range(100)]  # the two traced requests first, then 1..100 ms
    assert read(Run({}, "cpu", None, {"requests": 2}, {}, {"latency_s": lat})) == pytest.approx(95.05)
    assert read(Run({}, "cpu", None, {"requests": 2}, {}, {"latency_s": lat[:3]})) is None
    traced = bench_copy.run_cell(tiny, "tiny.sample_constrained", seconds=4.0, trace=True)
    assert traced["correct"], traced["checks"]
    assert traced["metrics"]["request_p95_ms.sample"]["value"] > 0  # untraced requests follow the traced ones
    plain = bench_copy.run_cell(tiny, "tiny.sample_constrained")
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"sample_smiles_per_s", "setup_s"}


STATE_UNCHANGED = """
import copy
import molvax_torch.train as T
real = T.make_train_chunk
def broken(*a, **k):
    f = real(*a, **k)
    def chunk(state, stack, props=None):
        _, m = f(copy.deepcopy(state), stack, props)
        return state, m
    return chunk
T.make_train_chunk = broken
"""

HALF_BATCH = """
import molvax_torch.train.loop as L
real = L._loss
def half(cfg, out, codes, beta, props, mesh=None):
    h = codes.shape[0] // 2
    out = out._replace(logits=out.logits[:h], mu=out.mu[:h], logvar=out.logvar[:h], z=out.z[:h],
                       kl=None if out.kl is None else out.kl[:h])
    return real(cfg, out, codes[:h], beta, None if props is None else props[:h], mesh)
L._loss = half
"""

TOKEN_ALTERED = """
import molvax_torch.latent.sample as S
real = S.generate
def altered(*a, **k):
    codes, logits = real(*a, **k)
    codes = codes.clone()
    codes[:, 3] = (codes[:, 3] + 1) % 37
    return codes, logits
S.generate = altered
"""


@pytest.mark.parametrize("name,fault", [("tiny.train", STATE_UNCHANGED), ("tiny.train", HALF_BATCH),
                                        ("tiny.sample", TOKEN_ALTERED), ("tiny.sample_constrained", TOKEN_ALTERED)],
                         ids=["state_unchanged", "half_batch", "token_altered", "token_altered_constrained"])
def test_a_broken_timed_path_is_not_correct(tiny, name, fault):
    line = bench_copy.run_cell(tiny, name, prelude=fault)
    assert line["correct"] is False, line["checks"]
