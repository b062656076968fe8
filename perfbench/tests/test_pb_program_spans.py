"""The program's own spans (``molvax:<name>``, ``molvax_torch.utils.span``)
move no number that ``trace.reduce`` gives: their mirrors on the device's
timeline are user annotations, not device activity. On a synthetic event
list here, and on a real trace of the card (``card``)."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from perfbench.trace import PREFIX, reduce

PROGRAM = "molvax:"


def ev(name, start, end, device=DeviceType.CPU, annotation=False):
    return SimpleNamespace(name=name, device_type=device, time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=annotation)


def numbers(r):
    return r.window_s, r.busy_s, r.kernel_s, r.kernel_n, r.activities, r.idle_s


def without_program_spans(events):
    return [e for e in events if not e.name.startswith(PROGRAM)]


def test_program_spans_and_their_mirrors_move_no_reading():
    cuda = DeviceType.CUDA
    events = [ev(PREFIX + "window", 0, 1000), ev(PREFIX + "sample_prior", 10, 900),
              ev("gemm", 100, 150, cuda), ev("Memcpy HtoD", 160, 170, cuda), ev("gemm", 400, 480, cuda),
              ev("auto_step_kernel", 600, 620, cuda)]
    for t0 in (20, 300, 550):  # three steps, each with its noise and selection, and their device mirrors
        for name, a, b in (("sample.step", t0, t0 + 200), ("sample.noise", t0 + 10, t0 + 40),
                           ("sample.select", t0 + 150, t0 + 190)):
            events += [ev(PROGRAM + name, a, b), ev(PROGRAM + name, a + 5, b + 5, cuda, annotation=True)]
    events += [ev(PROGRAM + "sample.to_host", 700, 800), ev(PROGRAM + "sample.strings", 800, 890)]
    full, bare = reduce(events), reduce(without_program_spans(events))
    assert numbers(full) == numbers(bare)
    assert full.kernel_n == {"gemm": 2, "Memcpy HtoD": 1, "auto_step_kernel": 1} and full.kernels == 3


@pytest.mark.card
def test_a_card_trace_reads_the_same_without_the_program_spans(card):
    from torch.profiler import ProfilerActivity, profile

    from molvax_torch.utils import span

    x = torch.randn(256, 256, device=card)
    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(PREFIX + "window"):
            for _ in range(20):
                with span("sample.step"):
                    with span("sample.noise"):
                        y = x @ x
                    with span("sample.select"):
                        y.argmax(dim=-1).cpu()
            torch.cuda.synchronize(card)
    events = list(prof.events())
    assert any(e.name == PROGRAM + "sample.step" for e in events)
    full, bare = reduce(events), reduce(without_program_spans(events))
    assert numbers(full) == numbers(bare)
    assert full.kernels >= 40 and not any(name.startswith(PROGRAM) for name in full.kernel_n)
