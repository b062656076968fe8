"""The port's own profiler spans (``utils.span``), on the CPU.

With no profiler running a span is one shared null context and calls no
profiler op. Under a profiler each span is a ``molvax:<name>`` range in its
events, on the clock of the device activity it records: the data layer's
``next_stack``, the chunk, and a sample request split into its z draw, its
decode (on the scan route the Gumbel noise once, before the steps, then
per step the step and its selection), the codes' copy to the host and the
string decode. No JAX: the
spans are the port's alone.
"""

import collections
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from molvax_torch import config as tconfig
from molvax_torch.data import DEFAULT_CHARSET, BatchIterator, Dataset
from molvax_torch.latent.sample import fit_aggregate_posterior, sample_aggregate, sample_prior
from molvax_torch.nn.vae import MolecularVAE
from molvax_torch.train import init_state, make_train_chunk, profiling
from molvax_torch.utils import SPAN_PREFIX, span

T = 12
SMALL = dict(max_len=T, charset_size=37, latent_dim=8, conv_kernels=(3, 3, 3), enc_hidden=16, gru_hidden=16,
             gru_layers=2, learned_start=True)


def _cfg(**kw) -> tconfig.ModelConfig:
    return tconfig.ModelConfig(**{**SMALL, **kw})


def _model(cfg) -> MolecularVAE:
    torch.manual_seed(0)
    return MolecularVAE(cfg, device="cpu")


def _profiled(fn):
    """``fn()``'s result and the counts of the ``molvax:`` spans it recorded
    under a CPU profiler, by name without the prefix."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = [e.name[len(SPAN_PREFIX):] for e in prof.events() if e.name.startswith(SPAN_PREFIX)]
    return out, collections.Counter(names), prof


def _raise(*a, **k):
    raise AssertionError("a profiler op was called")


def test_span_without_a_profiler_calls_no_profiler_op(monkeypatch):
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", _raise)
    assert not torch.autograd._profiler_enabled()
    with span("sample.step"):
        with span("sample.noise"):
            x = torch.ones(3) * 2
    assert span("a") is span("b")  # one shared null context
    assert x.tolist() == [2.0, 2.0, 2.0]


def test_span_under_a_profiler_calls_the_profiler_op(monkeypatch):
    """The control of the test above: the same patch takes hold once a
    profiler runs."""
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", _raise)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="a profiler op was called"):
            with span("x"):
                pass


def test_spans_are_prefixed_and_nest():
    def work():
        with span("outer"):
            for _ in range(3):
                with span("inner"):
                    torch.ones(4, 4) @ torch.ones(4, 4)

    _, counts, prof = _profiled(work)
    assert counts == {"outer": 1, "inner": 3}
    events = {e.name: e for e in prof.events()}
    outer = events["molvax:outer"].time_range
    inner = [e.time_range for e in prof.events() if e.name == "molvax:inner"]
    assert all(outer.start <= r.start and r.end <= outer.end for r in inner)


@pytest.mark.parametrize("constrained", [False, True], ids=["free", "constrained"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "gumbel"])
def test_sample_prior_records_the_request_spans(greedy, constrained):
    cfg = _cfg()
    model = _model(cfg)
    strings, counts, _ = _profiled(lambda: sample_prior(model, cfg, 5, torch.Generator().manual_seed(1),
                                                        greedy=greedy, constrained=constrained))
    assert len(strings) == 5
    assert counts == {"sample.draw_z": 1, "sample.decode": 1, "sample.step": T, "sample.select": T,
                      "sample.to_host": 1, "sample.strings": 1, **({} if greedy else {"sample.noise": 1})}


@pytest.mark.parametrize("constrained", [False, True], ids=["free", "constrained"])
def test_a_repeat_z_decode_selects_once(constrained):
    """The non-autoregressive decode has no step loop: one selection over
    all T scores, one noise table of all T steps."""
    cfg = _cfg(decoder_conditioning="repeat_z", learned_start=False)
    model = _model(cfg)
    _, counts, _ = _profiled(lambda: sample_prior(model, cfg, 4, torch.Generator().manual_seed(2), greedy=False,
                                                  constrained=constrained))
    assert counts == {"sample.draw_z": 1, "sample.decode": 1, "sample.noise": 1, "sample.select": 1,
                      "sample.to_host": 1, "sample.strings": 1}


def test_a_request_nests_its_steps_in_its_decode():
    cfg = _cfg()
    model = _model(cfg)
    _, _, prof = _profiled(lambda: sample_prior(model, cfg, 3, torch.Generator().manual_seed(3), greedy=False,
                                                constrained=True))
    by = collections.defaultdict(list)
    for e in prof.events():
        by[e.name].append(e.time_range)
    (decode,), (to_host,), (strings,) = by["molvax:sample.decode"], by["molvax:sample.to_host"], \
        by["molvax:sample.strings"]
    steps = by["molvax:sample.step"]
    assert all(decode.start <= s.start and s.end <= decode.end for s in steps)
    (noise,) = by["molvax:sample.noise"]  # the decode's noise table, before its first step
    assert decode.start <= noise.start and noise.end <= min(s.start for s in steps)
    assert all(any(s.start <= r.start and r.end <= s.end for s in steps) for r in by["molvax:sample.select"])
    assert decode.end <= to_host.start and to_host.end <= strings.start


def test_spans_leave_a_request_unchanged():
    cfg = _cfg()
    model = _model(cfg)

    def request():
        return sample_prior(model, cfg, 6, torch.Generator().manual_seed(4), greedy=False, constrained=True)

    plain = request()
    traced, counts, _ = _profiled(request)
    assert traced == plain and counts["sample.step"] == T


def test_sample_aggregate_records_the_decode_and_strings_but_no_prior_draw():
    cfg = _cfg()
    model = _model(cfg)
    codes = np.random.default_rng(0).integers(1, 37, size=(16, T)).astype(np.uint8)
    mean, chol = fit_aggregate_posterior(model, cfg, codes, batch=8)
    _, counts, _ = _profiled(lambda: sample_aggregate(model, cfg, 4, torch.Generator().manual_seed(5), mean, chol))
    assert counts == {"sample.decode": 1, "sample.step": T, "sample.select": T, "sample.to_host": 1,
                      "sample.strings": 1}


def _dataset(rows: int = 64) -> Dataset:
    codes = np.random.default_rng(1).integers(0, DEFAULT_CHARSET.size, size=(rows, T)).astype(np.uint8)
    return Dataset(codes, DEFAULT_CHARSET)


def test_next_stack_records_data_next_stack():
    it = BatchIterator(_dataset(), 8, seed=0, device="cpu")
    (stack, _), counts, _ = _profiled(lambda: (it.next_stack(3), it.next_stack(2))[0])
    assert tuple(stack.shape) == (3, 8, T)
    assert counts == {"data.next_stack": 2}


def test_next_stack_is_the_same_under_a_profiler():
    a = BatchIterator(_dataset(), 8, seed=7, device="cpu").next_stack(4)[0]
    b, _, _ = _profiled(lambda: BatchIterator(_dataset(), 8, seed=7, device="cpu").next_stack(4)[0])
    assert torch.equal(a, b)


def test_the_cpu_chunk_records_train_chunk():
    model = dict(SMALL, compute_dtype="float32")
    cfg = tconfig.Config(name="tiny", model=tconfig.ModelConfig(**model), train=tconfig.TrainConfig(batch_size=4))
    state = init_state(cfg, seed=0, device="cpu")
    chunk = make_train_chunk(cfg, 2, device="cpu")
    stack, _ = BatchIterator(_dataset(), 4, seed=0, device="cpu").next_stack(2)
    (state, metrics), counts, _ = _profiled(lambda: chunk(state, stack))
    assert state.step == 2 and metrics["loss"].shape == (2,)
    assert counts == {"train.chunk": 1}  # the graph's capture and replay are the card's


def test_trace_writes_the_program_spans_into_a_chrome_trace(tmp_path):
    cfg = _cfg(max_len=8)
    model = _model(cfg)
    with profiling.trace(str(tmp_path)):
        with span("probe"):
            sample_prior(model, cfg, 2, torch.Generator().manual_seed(6))
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    names = collections.Counter(ev.get("name") for ev in json.loads(files[0].read_text())["traceEvents"])
    assert names["molvax:probe"] == 1 and names["molvax:sample.step"] == 8
    assert names["molvax:sample.decode"] == names["molvax:sample.strings"] == 1
