"""The frozen counts at both configurations' widths, by hand, and the peaks."""

import json

import pytest

from perfbench import spec, yardstick

H100 = "NVIDIA H100 80GB HBM3"


def old_convention_train_flops(s):
    """The count the yardstick replaced (``BENCH_r05.json``'s convention):
    three times a forward in which every product is dense and per step."""
    T, C, Lz, H, L, E = (s[k] for k in ("max_len", "charset_size", "latent_dim", "gru_hidden", "gru_layers",
                                        "enc_hidden"))
    f, length, in_ch = 0.0, T, C
    for ch, k in zip(s["conv_channels"], s["conv_kernels"]):
        length = length - k + 1
        f += 2.0 * length * ch * in_ch * k
        in_ch = ch
    f += 2.0 * length * in_ch * E + 2.0 * E * Lz * 2 + 2.0 * Lz * Lz
    for li in range(L):
        f += 2.0 * T * (((Lz + C) if li == 0 else H) + H) * 3 * H
    return 3.0 * (f + 2.0 * T * H * C)


def sizes(name):
    return json.loads((spec.PKG / "configs" / f"{name}.json").read_text())["sizes"]


def test_zinc250k_counts_by_hand():
    s = sizes("zinc250k")
    # conv lengths 112, 104, 94; the first conv a gather over its one-hot input
    enc_fwd = 112 * 9 * 9 + 2 * 104 * 9 * 9 * 9 + 2 * 94 * 10 * 9 * 11 + 2 * 940 * 435 + 2 * 2 * 435 * 292
    enc_bwd = 112 * 9 * 9 + 4 * 104 * 9 * 9 * 9 + 4 * 94 * 10 * 9 * 11 + 2 * (2 * 940 * 435 + 2 * 2 * 435 * 292)
    g = 3 * 501
    gru_fwd = 2 * 292 * g + 120 * g + 3 * (2 * 120 * 501 * g) + 2 * (2 * 120 * 501 * g)
    gru_bwd = 4 * 292 * g + 120 * g + 6 * (2 * 120 * 501 * g) + 4 * (2 * 120 * 501 * g)
    head = 2 * 292 * 292 + 2 * 120 * 501 * 37
    assert yardstick.encoder_ops(s) == {"fwd": enc_fwd, "bwd": enc_bwd}
    assert yardstick.gru_ops(s, True) == {"fwd": gru_fwd, "bwd": gru_bwd}
    assert yardstick.train_ops_per_smiles(s) == enc_fwd + enc_bwd + gru_fwd + gru_bwd + 3 * head
    assert yardstick.decode_ops_per_smiles(s) == gru_fwd + head
    assert yardstick.train_ops_per_smiles(s) == pytest.approx(2.7327e9, rel=1e-4)
    assert old_convention_train_flops(s) == pytest.approx(3.0877e9, rel=1e-4)  # BENCH_r05.json's 3.09


def test_moses_scaled_counts_by_hand():
    s = sizes("moses_scaled")
    g = 3 * 1024
    gru_fwd = 2 * 512 * g + 120 * g + 4 * (2 * 120 * 1024 * g) + 3 * (2 * 120 * 1024 * g)
    head = 2 * 512 * 512 + 2 * 120 * 1024 * 37
    assert yardstick.gru_ops(s, False)["fwd"] == gru_fwd
    assert yardstick.decode_ops_per_smiles(s) == gru_fwd + head
    weights = 512 * 512 + (549 * g + 1024 * g) + 3 * (2 * 1024 * g) + 1024 * 37
    assert yardstick.decode_bytes_per_request(s, 256) == 2 * weights + 256 * (4 * 512 + 4 * 120)


@pytest.mark.parametrize("name", ["zinc250k", "moses_scaled"])
@pytest.mark.parametrize("learned_start,layers", [(True, 1), (False, 3), (True, 6)])
def test_least_work_is_at_most_the_old_convention(name, learned_start, layers):
    """The least-work count never exceeds the dense per-step convention it
    replaces, so a share of the peak by it is never above the old one's."""
    s = dict(sizes(name), learned_start=learned_start, gru_layers=layers)
    assert yardstick.train_ops_per_smiles(s) <= old_convention_train_flops(s)
    assert yardstick.decode_ops_per_smiles(s) <= old_convention_train_flops(s) / 3


def test_peaks_come_from_the_card_name_alone(monkeypatch):
    monkeypatch.setenv("MOLVAX_PEAK_TFLOPS", "1")
    assert yardstick.peak(H100, "bf16_flops") == 989e12
    assert yardstick.peak(H100, "hbm_bytes_s") == 3.35e12
    assert yardstick.peak("cpu", "bf16_flops") is None
    assert yardstick.bound_s(989e12, 0.0, H100) == pytest.approx(1.0)
    assert yardstick.bound_s(0.0, 3.35e12, H100) == pytest.approx(1.0)
    assert yardstick.bound_s(1.0, 1.0, "cpu") is None


def test_gru_bound_at_zinc250k():
    s = sizes("zinc250k")
    ms = 1e3 * yardstick.bound_s(yardstick.gru_train_ops_per_smiles(s) * 256,
                                 yardstick.gru_train_bytes_per_step(s, 256), H100)
    assert ms == pytest.approx(0.7025, rel=1e-3)


def test_fp32_least_time_is_3xtf32_at_a_third_of_the_tf32_peak():
    assert yardstick.peak(H100, "tf32_flops") == 495e12 and yardstick.peak(H100, "fp32_flops") == 67e12
    assert yardstick.flops(H100, "fp32") == pytest.approx(165e12)
    assert yardstick.flops(H100, "bf16") == 989e12 and yardstick.flops("cpu", "fp32") is None
    s = sizes("zinc250k")
    ops = yardstick.decode_ops_per_smiles(s) * 256
    assert ops == pytest.approx(232.6e9, rel=1e-3)
    ms = 1e3 * yardstick.bound_s(ops, yardstick.decode_bytes_per_request(s, 256, weight_bytes=4), H100, "fp32")
    assert ms == pytest.approx(1.41, rel=1e-2)


def test_the_constrained_decodes_two_rooflines_differ_by_the_peaks_ratio():
    """``decode_roofline_fp32.sample`` reads the same work and busy time as
    ``decode_roofline.sample``; where the decode is bound by its operations,
    the two differ by 989 / 165."""
    from perfbench.harness import Run, metric_reader
    from perfbench.trace import Reading

    run = Run(sizes("zinc250k"), H100, Reading(0.2, 0.1, {}, {}, {}, 1), {"requests": 8, "smiles": 2048}, {}, {})
    bf16, fp32 = metric_reader("decode_roofline.sample")(run), metric_reader("decode_roofline_fp32.sample")(run)
    assert fp32 / bf16 == pytest.approx(989 / 165) and fp32 / bf16 == pytest.approx(5.99, abs=5e-3)
    assert fp32 == pytest.approx(100 * 1.41e-3 / 0.0125, rel=1e-2)
