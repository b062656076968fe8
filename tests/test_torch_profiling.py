"""The port's profiling module on the CPU: the H100's peaks, the bound
arithmetic and the step timer. The program's spans and their trace are
``test_torch_tracing.py``'s."""

import pytest
import torch

from molvax_torch.train import profiling as prof


def test_peak_table_and_override():
    h100 = prof.H100_SXM
    assert (h100.bf16_tflops, h100.fp32_tflops, h100.int32_tops, h100.hbm_tb_s) == (989.0, 67.0, 33.5, 3.35)
    assert h100.tf32_tflops == 494.7


def test_bound_ms_is_the_larger_time():
    # 989 GFLOP at the bf16 peak: 1 ms; 3.35 GB at the H100 SXM's HBM rate: 1 ms
    peak = prof.H100_SXM.bf16_tflops * 1e12
    assert prof.bound_ms(989e9, 0.5 * 3.35e9, peak) == (pytest.approx(1.0), "operations")
    assert prof.bound_ms(0.5 * 989e9, 3.35e9, peak) == (pytest.approx(1.0), "bytes")


def test_step_timer_on_a_cpu_function():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    s = prof.step_timer(fn, torch.ones(4), steps=3, rounds=3)
    assert s > 0 and len(calls) == 1 + 3 * 3
    drained = []
    prof.step_timer(fn, torch.ones(4), steps=2, rounds=1, fetch=drained.append)
    assert len(drained) == 2
