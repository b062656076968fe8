"""The harness reads the program's own spans (``molvax:<name>``) beside its
own (``pb:<name>``): ``trace.reduce`` sums and counts both inside the
window and names an idle gap by the innermost span of either origin; the
span readers, the set-up's parts and the per-card share read what they
should, and nothing where their input is missing; the sample mixes warm
the program's path before the window."""

import json
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from perfbench import run as pb_run
from perfbench import spec
from perfbench.harness import Run, metric_reader
from perfbench.tests import bench_copy
from perfbench.trace import PREFIX, PROGRAM, Reading, reduce

CUDA = DeviceType.CUDA
SETUP = ("setup_torch_s", "setup_library_s", "setup_state_s", "setup_warm_s")


def ev(name, start, end, device=DeviceType.CPU, annotation=False):
    return SimpleNamespace(name=name, device_type=device, time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=annotation)


def test_the_program_prefix_is_the_programs():
    from molvax_torch.utils import SPAN_PREFIX

    assert PROGRAM == SPAN_PREFIX


def test_reduce_sums_and_counts_the_spans_of_both_origins_inside_the_window():
    events = [ev(PREFIX + "window", 100, 1100), ev(PREFIX + "sample_prior", 110, 600),
              ev(PREFIX + "sample_prior", 610, 1090), ev("gemm", 200, 300, CUDA)]
    for a in (120, 620):
        events += [ev(PROGRAM + "sample.replay", a, a + 30), ev(PROGRAM + "sample.strings", a + 400, a + 460),
                   ev(PROGRAM + "sample.replay", a + 1, a + 29, CUDA)]  # a mirror without the annotation flag
    events += [ev(PROGRAM + "data.stage_wait", 0, 50), ev(PROGRAM + "data.stage_wait", 1050, 1150),
               ev("aten::copy_", 130, 140)]  # one span before the window, one across its end; an op
    r = reduce(events)
    assert r.span_n == {"sample_prior": 2, "molvax:sample.replay": 2, "molvax:sample.strings": 2,
                        "molvax:data.stage_wait": 1}
    assert r.span_s == pytest.approx({"sample_prior": 970e-6, "molvax:sample.replay": 60e-6,
                                      "molvax:sample.strings": 120e-6, "molvax:data.stage_wait": 50e-6})
    assert r.kernel_n == {"gemm": 1} and r.activities == 1 and r.busy_s == pytest.approx(100e-6)


def test_an_idle_gap_is_named_by_the_innermost_span_of_either_origin():
    events = [ev(PREFIX + "window", 0, 1000), ev(PREFIX + "sample_prior", 0, 850),
              ev(PROGRAM + "sample.decode", 0, 300), ev(PROGRAM + "sample.replay", 0, 100),
              ev(PROGRAM + "sample.to_host", 300, 500), ev(PROGRAM + "sample.strings", 600, 850)]
    events += [ev("k", a, b, CUDA) for a, b in ((100, 200), (290, 300), (450, 500), (550, 600), (850, 900))]
    r = reduce(events)
    assert r.gap_s == pytest.approx({
        "molvax:sample.replay": 100e-6,  # 0-100: three spans start together; the shortest holds it
        "molvax:sample.decode": 90e-6,  # 200-290
        "molvax:sample.to_host": 150e-6,  # 300-450
        "sample_prior": 50e-6,  # 500-550: the harness's span alone
        "molvax:sample.strings": 250e-6,  # 600-850
        "host:other": 100e-6})  # 900-1000
    assert r.idle_s == pytest.approx({"sample_prior": 640e-6, "host:other": 100e-6})  # the harness's spans alone
    assert sum(r.gap_s.values()) == pytest.approx(r.window_s - r.busy_s)
    assert r.breakdown()["idle_gaps"][0] == ["molvax:sample.strings", pytest.approx(250e-6)]


def reading(span_s):
    return Reading(0.1, 0.05, {}, {}, {}, 1, span_s, {k: 1 for k in span_s})


@pytest.mark.parametrize("metric,span,unit", [("data_wait_ms.train", "molvax:data.stage_wait", "steps"),
                                              ("strings_ms.sample", "molvax:sample.strings", "requests"),
                                              ("replay_ms.sample", "molvax:sample.replay", "requests")])
def test_a_span_reader_reads_ms_a_unit_and_nothing_without_its_span(metric, span, unit):
    read = metric_reader(metric)
    traced = {unit: 8, "smiles": 2048}
    assert read(Run({}, "cpu", reading({span: 0.004, "sample_prior": 1.0}), traced, {}, {})) == pytest.approx(0.5)
    assert read(Run({}, "cpu", reading({"sample_prior": 1.0}), traced, {}, {})) is None
    assert read(Run({}, "cpu", None, traced, {}, {})) is None
    assert read(Run({}, "cpu", reading({span: 0.004}), {}, {}, {})) is None


def test_the_setup_parts_fall_in_their_metrics():
    parts = {"config": 0.01, "import_torch": 6.0, "cuda_init": 0.5, "profiler_init": 2.0, "import_program": 0.4,
             "library": 0.3, "weights": 0.2, "warm_requests": 1.5}
    got = {m: metric_reader(m)(Run({}, "cpu", None, {}, {}, {}, parts)) for m in SETUP}
    assert got == pytest.approx({"setup_torch_s": 6.5, "setup_library_s": 0.3, "setup_state_s": 0.61,
                                 "setup_warm_s": 1.5})
    assert metric_reader("setup_library_s")(Run({}, "cpu", None, {}, {}, {}, {"config": 0.01})) is None


def test_a_cards_share_of_a_data_parallel_step_is_the_whole_worlds_over_its_ranks():
    sizes = json.loads((spec.PKG / "configs" / "moses_scaled.json").read_text())["sizes"]
    r = Reading(2.0, 1.9, {}, {}, {}, 100)
    traced = {"steps": 64, "smiles": 64 * 1024}
    one = metric_reader("mfu.train")(Run(sizes, "NVIDIA H100 80GB HBM3", r, traced, {}, {}))
    four = metric_reader("mfu.train_dp4")(Run(sizes, "NVIDIA H100 80GB HBM3", r, traced, {}, {}, {}, 4))
    assert four == pytest.approx(one / 4)
    assert metric_reader("mfu.train_dp4")(Run(sizes, "cpu", r, traced, {}, {}, {}, 4)) is None


def test_the_span_table_and_the_machine_line():
    res = {"reading": {"window_s": 0.2, "span_s": {"sample_prior": 0.16, "molvax:sample.replay": 0.002},
                       "span_n": {"sample_prior": 8, "molvax:sample.replay": 8}},
           "traced": {"requests": 8, "smiles": 2048}}
    lines = pb_run.span_lines(res)
    assert "8 requests" in lines[0] and lines[1].split() == ["sample_prior", "8", "160.0000", "20.0000"]
    assert lines[2].split() == ["molvax:sample.replay", "8", "2.0000", "0.2500"]
    assert pb_run.span_lines({"reading": None}) == []
    line = pb_run.machine_line("cpu", 1)
    assert line.startswith("card: cpu x1, power limit ") and "load average " in line and "cores" in line
    setup = pb_run.setup_lines({"parts": {"import_torch": 1.0, "library": 0.5}, "setup_s": 2.0})
    assert setup[1] == "set-up: setup_s=2.000s, in parts 1.500s, in no part 0.500s"


@pytest.mark.parametrize("name, warm", [("zinc250k.sample_constrained", 3), ("zinc250k.sample", 1)])
def test_the_constrained_mix_warms_its_path_before_the_window(monkeypatch, name, warm):
    """Set-up sends requests of the window's shape, each of a seed the
    window never sends: on the scan route (constrained) at least as many as
    the program runs before its key's capture, so the window only replays
    (on the card ``test_pb_card.py`` reads the program's counters); on the
    generation kernel's route, which captures nothing, one."""
    from molvax_torch.latent import sample as program

    from perfbench import corpus
    from perfbench.harness import make_context
    from perfbench.traffic import sample

    ctx = make_context(name, 2**31 + 5, "cpu")
    sent = []
    monkeypatch.setattr(sample, "request", lambda c, seed: sent.append((c, seed)) or [])
    sample.setup(ctx)
    assert sample.WARM_SCAN >= program._CAPTURE_AT_CALL
    assert len(sent) == sample.warm_requests(ctx.mix) == warm and all(c is ctx for c, _ in sent)
    window_seeds = {corpus.request_seed(ctx.seed, i) for i in range(10_000)}
    assert len({s for _, s in sent}) == warm and not window_seeds & {s for _, s in sent}
    assert "warm_requests" in ctx.parts and ctx.mix["constrained"] == (warm == sample.WARM_SCAN)


def parts_of(metric):
    """The set-up parts that metric reader ``metric`` sums."""
    import importlib.util

    mod_spec = importlib.util.spec_from_file_location(f"parts_{metric}", spec.PKG / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.PARTS


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return bench_copy.make(tmp_path_factory.mktemp("pb_spans"))


PARTS = """
import json
from perfbench.harness import run_cell
from perfbench.run import as_plain
res = as_plain(run_cell({name!r}, 2**31 + 21, 1.0, True, "cpu"))
print(json.dumps({{"parts": res["parts"], "setup_s": res["setup_s"], "metrics": res["metrics"],
                  "span_n": res["reading"]["span_n"], "traced": res["traced"]}}))
"""


@pytest.mark.parametrize("name", ["tiny.train", "tiny.sample_constrained"])
def test_a_traced_run_reads_the_program_spans_and_every_setup_part(tiny, name):
    out = bench_copy.python(tiny, PARTS.format(name=name))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    groups = {p for m in SETUP for p in parts_of(m)} | {"profiler_init"}
    assert set(got["parts"]) <= groups, set(got["parts"]) - groups
    setup = sum(got["metrics"][m]["value"] for m in SETUP) + got["parts"]["profiler_init"]
    assert setup == pytest.approx(sum(got["parts"].values())) and setup <= got["setup_s"]
    if name == "tiny.train":  # two traced chunks; the CPU's data layer has no pinned staging ring to wait on
        assert got["span_n"]["molvax:data.next_stack"] == 2 and "molvax:data.stage_wait" not in got["span_n"]
        assert "data_wait_ms.train" not in got["metrics"]
    else:
        assert got["span_n"]["molvax:sample.strings"] == got["traced"]["requests"] == 2
        assert got["metrics"]["strings_ms.sample"]["value"] > 0
        assert "replay_ms.sample" not in got["metrics"]  # the CPU runs the scan route op by op: no replay


def test_the_cpu_model_skips_a_name_the_host_hides(monkeypatch):
    """A sandboxed host can give ``model name: unknown``; the line then names
    the vendor, family and model numbers."""
    import builtins
    import io

    real = builtins.open
    info = "processor\t: 0\nvendor_id\t: GenuineIntel\ncpu family\t: 6\nmodel\t\t: 143\nmodel name\t: unknown\n"
    monkeypatch.setattr(builtins, "open", lambda path, *a, **k: io.StringIO(info) if path == "/proc/cpuinfo"
                        else real(path, *a, **k))
    assert pb_run.cpu_model() == "GenuineIntel family 6 model 143"
