"""The grammar sampling traffic on the CPU: a tiny cell of ``gvae_zinc``'s
kind is correct and loads no JAX, a served rule or terminal altered under
the timed path is not correct, and the reference in fp8 in the program's
place reads above the limit that the program reads below."""

import json

import pytest

from perfbench.tests import bench_copy

SMALL = dict(max_len=60, latent_dim=8, conv_channels=[3, 3, 4], conv_kernels=[3, 3, 3], enc_hidden=16,
             gru_hidden=32, gru_layers=2, batch_size=16, train_chunk_size=4)
# set from CPU readings of four seeds: the program at most 6.2e-4, the fp8 control at least 5.1e-3
LIMITS = {"logit_gap": 2e-3, "string_mismatch": 0}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = bench_copy.make(tmp_path_factory.mktemp("pb_grammar"), {})
    conf = json.loads((bench_copy.REPO / "perfbench" / "configs" / "gvae_zinc.json").read_text())
    conf["name"] = "tinyg"
    conf["sizes"].update(SMALL)
    conf["overrides"] = {f"model.{k}": v for k, v in SMALL.items() if k not in ("batch_size", "train_chunk_size")}
    conf["overrides"].update({"train.batch_size": 16, "train.train_chunk_size": 4, "data.n_synthetic": 4096})
    pb = root / "perfbench"
    (pb / "configs" / "tinyg.json").write_text(json.dumps(conf))
    (pb / "traffic" / "tinyg_mix.json").write_text(json.dumps(
        {"kind": "grammar_sample", "rows": 64, "greedy": False, "temperature": 1.0, "trace_units": 2}))
    (pb / "workloads" / "tinyg.sample.json").write_text(json.dumps({"limits": LIMITS}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tinyg", "source": "a test", "file": "perfbench/configs/tinyg.json",
                             "reduced": [], "why": "a test configuration"})
    bench["workloads"].append({"name": "tinyg.sample", "config": "tinyg", "traffic": "tinyg_mix", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "gvae_zinc.sample" in m.get("workloads", []):
            m["workloads"].append("tinyg.sample")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_tiny_grammar_cell_is_correct_and_loads_no_jax(tiny):
    line = bench_copy.run_cell(tiny, "tinyg.sample", trace=True)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["forbidden"] == []
    plain = bench_copy.run_cell(tiny, "tinyg.sample")
    assert set(plain["metrics"]) == {"sample_smiles_per_s", "setup_s"}


RULE_ALTERED = """
import torch
import molvax_torch.latent.sample as S
real = S._grammar_generate
def altered(*a, **k):
    out, logits = real(*a, **k)
    out = out.clone()
    out[:, 2] = (out[:, 2].long() + 1).to(out.dtype) % 76
    return out, logits
S._grammar_generate = altered
"""

TERMINAL_ALTERED = """
import torch
import molvax_torch.latent.sample as S
real = S._grammar_generate
def altered(*a, **k):
    out, logits = real(*a, **k)
    out = out.clone()
    t = out.shape[1] // 3
    out[:, t] = torch.where(out[:, t] > 0, out[:, t] % 35 + 1, out[:, t])
    return out, logits
S._grammar_generate = altered
"""


@pytest.mark.parametrize("fault", [RULE_ALTERED, TERMINAL_ALTERED], ids=["rule_altered", "terminal_altered"])
def test_a_broken_timed_path_is_not_correct(tiny, fault):
    line = bench_copy.run_cell(tiny, "tinyg.sample", prelude=fault)
    assert line["correct"] is False, line["checks"]


def test_control_in_fp8_fails_the_check(tiny):
    out = bench_copy.python(tiny, "import sys; from perfbench.calibrate import main; sys.exit(main(['--workload', "
                                  "'tinyg.sample', '--seeds', '3,4,5', '--control-seeds', '3,4,5', '--seconds', "
                                  "'0.5', '--device', 'cpu']))")
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(rows) == 3
    for r in rows:
        assert r["program"]["logit_gap"] < LIMITS["logit_gap"] < r["control_fp8"]["logit_gap"], r
        assert r["program"]["string_mismatch"] == 0
