"""A cell on two chips, rehearsed with two gloo ranks on the CPU: the rank
launcher, the program's data-parallel mesh under the traffic, rank 0's
check over the global batch."""

import json

import pytest

from perfbench.tests import bench_copy

CELLS = {
    "tiny.train2": {"kind": "train", "corpus_rows": 128, "len_min": 4, "len_max": 20, "trace_units": 2},
    "tiny.sample2": {"kind": "sample", "rows": 32, "greedy": False, "temperature": 1.0, "constrained": False,
                     "trace_units": 2},
}

LAUNCH = """
import json, time
from perfbench.ranks import launch
from perfbench.run import result_line
res = launch({name!r}, 2**31 + 3, 1.0, False, 2, "cpu", time.time(), timeout=500)
line = result_line(res, False, 2)
line["forbidden"] = res["forbidden"]
print(json.dumps(line))
"""


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return bench_copy.make(tmp_path_factory.mktemp("pb_ranks"), CELLS, chips=2)


@pytest.mark.parametrize("name", list(CELLS))
def test_two_gloo_ranks(two, name):
    out = bench_copy.python(two, LAUNCH.format(name=name))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["device"]["count"] == 2
    assert line["forbidden"] == []
