"""The port's profiling module against molvax.train.profiling, on the CPU:
FLOP counts for every preset, MFU arithmetic, the peak table and its
override, the step timer, and a trace written with a named span."""

import json

import pytest
import torch

import molvax.config as jcfg_mod
import molvax.train.profiling as jprof
import molvax_torch.config as tcfg_mod
from molvax_torch.train import profiling as prof


@pytest.mark.parametrize("name", sorted(tcfg_mod.PRESETS))
def test_flops_per_smiles_equal_the_reference(name):
    tcfg, jcfg = tcfg_mod.get_preset(name).model, jcfg_mod.get_preset(name).model
    assert prof.forward_flops_per_smiles(tcfg) == jprof.forward_flops_per_smiles(jcfg)
    assert prof.train_flops_per_smiles(tcfg) == jprof.train_flops_per_smiles(jcfg)
    assert prof.train_flops_per_smiles(tcfg) > 0


def test_flops_follow_the_options():
    """Property head, repeat_z conditioning and the charset orientation
    change the count as in the reference."""
    base = tcfg_mod.ModelConfig()
    for kw in (dict(n_properties=3), dict(decoder_conditioning="repeat_z"),
               dict(conv_orientation="charset", conv_kernels=(9, 9, 11))):
        t = tcfg_mod.ModelConfig(**kw)
        assert prof.forward_flops_per_smiles(t) == jprof.forward_flops_per_smiles(jcfg_mod.ModelConfig(**kw))
        assert prof.forward_flops_per_smiles(t) != prof.forward_flops_per_smiles(base)


def test_mfu_arithmetic(monkeypatch):
    cfg = tcfg_mod.get_preset("zinc250k").model
    fps = prof.train_flops_per_smiles(cfg)
    monkeypatch.setenv("MOLVAX_PEAK_TFLOPS", "500")
    out = prof.mfu(2000.0, cfg)
    assert out["flops_per_smiles"] == fps
    assert out["tflops_sustained"] == pytest.approx(fps * 2000.0 / 1e12)
    assert out["mfu"] == pytest.approx(out["tflops_sustained"] / 500.0)
    monkeypatch.delenv("MOLVAX_PEAK_TFLOPS")
    cpu = prof.mfu(2000.0, cfg, device="cpu")
    assert cpu["mfu"] == 0.0 and cpu["tflops_sustained"] == out["tflops_sustained"]


def test_peak_table_and_override(monkeypatch):
    monkeypatch.delenv("MOLVAX_PEAK_TFLOPS", raising=False)
    h100 = prof.PEAKS["NVIDIA H100 80GB HBM3"]
    assert h100 is prof.H100_SXM
    assert (h100.bf16_tflops, h100.fp32_tflops, h100.int32_tops, h100.hbm_tb_s) == (989.0, 67.0, 33.5, 3.35)
    assert "NVIDIA A100-SXM4-80GB" not in prof.PEAKS
    assert prof.device_peak_tflops("cpu") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            prof.device_peak_tflops()  # None means the card
    monkeypatch.setenv("MOLVAX_PEAK_TFLOPS", "123.5")
    assert prof.device_peak_tflops() == 123.5
    assert prof.device_peak_tflops("cpu") == 123.5


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


def test_cost_summary_counts_matmul_flops():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    out = prof.cost_summary(torch.matmul, a, b)
    assert out["flops"] == 2 * 8 * 16 * 4
    assert "sol_step_s" not in out  # a CPU tensor has no peak


def test_trace_and_annotate_write_a_chrome_trace(tmp_path):
    with prof.trace(str(tmp_path)):
        with prof.annotate("molvax_probe_span"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(ev.get("name") == "molvax_probe_span" for ev in events)
