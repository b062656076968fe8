"""The yardstick: least work of a train step and of a decode, and the peaks.

Frozen with the benchmark, so that no change to the program moves it.
Operations are counted as 2 per multiply-add of a product, from the
configuration's sizes, and only as much as these inputs need:

* a product whose operand is constant over a sequence (the latent part of
  GRU layer 0's input) counts once per sequence, not once per step;
* a product with a one-hot operand (the first convolution over the one-hot
  SMILES, and the character part of GRU layer 0's input) counts as the
  gather it is: one add per output element and tap, nothing in the
  backward for the one-hot side.

Elementwise work (gates, activations, the loss, Adam) is left out, as the
MFU convention leaves it out. A backward counts two products for each
forward product (the input's gradient and the weight's), one where one
side needs no gradient. So a legitimate saving (hoisting a product, taking
a gather for a one-hot product) can never read above 100%.

Peaks come from the card's name alone (NVIDIA's data sheet, dense rates
without sparsity, at the full power limit); nothing in the environment
moves them. A card that the table does not name has no peak, and a share
of the peak then reads nothing.

A path that computes in fp32 is held to fp32's own least time, not to
bf16's. The fastest way to fp32-accurate products on the card is 3xTF32:
each operand split into a TF32 high part and a TF32 low part, and three
TF32 products (hi hi, hi lo, lo hi) summed in fp32, so at most a third of
the TF32 peak (165 TFLOP/s on an H100 SXM), which is above the 67 TFLOP/s
of fp32 fused multiply-adds outside the tensor cores. A single TF32 pass
rounds each operand to 10 bits of mantissa: that is not fp32, so its peak
never bounds an fp32 path.
"""

from __future__ import annotations

from typing import Dict, Optional

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "tf32_flops": 495e12, "fp32_flops": 67e12,
                             "hbm_bytes_s": 3.35e12},
}


def peak(device_name: str, what: str) -> Optional[float]:
    row = PEAKS.get(device_name)
    return None if row is None else row[what]


def flops(device_name: str, precision: str) -> Optional[float]:
    """The card's least-time rate of products in ``precision``: 'bf16', or
    'fp32' (the larger of a third of the TF32 peak, 3xTF32, and the fp32
    peak); None without a peak."""
    if precision == "bf16":
        return peak(device_name, "bf16_flops")
    tf32, fp32 = peak(device_name, "tf32_flops"), peak(device_name, "fp32_flops")
    return None if tf32 is None or fp32 is None else max(tf32 / 3.0, fp32)


def _conv_lengths(sizes: dict):
    length, in_ch = sizes["max_len"], sizes["charset_size"]
    for ch, k in zip(sizes["conv_channels"], sizes["conv_kernels"]):
        length = length - k + 1
        yield length, in_ch, ch, k
        in_ch = ch


def encoder_ops(sizes: dict) -> Dict[str, float]:
    """Forward and backward operations of the encoder, per SMILES."""
    fwd = bwd = 0.0
    convs = list(_conv_lengths(sizes))
    for i, (length, in_ch, ch, k) in enumerate(convs):
        if i == 0:  # a one-hot input: a gather of k taps per output, its dW a scatter
            fwd += length * ch * k
            bwd += length * ch * k
        else:
            fwd += 2.0 * length * ch * in_ch * k
            bwd += 2.0 * 2.0 * length * ch * in_ch * k
    length, _, ch, _ = convs[-1]
    flat, E, Lz = length * ch, sizes["enc_hidden"], sizes["latent_dim"]
    dense = 2.0 * flat * E + 2.0 * 2.0 * E * Lz
    return {"fwd": fwd + dense, "bwd": bwd + 2.0 * dense}


def gru_ops(sizes: dict, backward: bool) -> Dict[str, float]:
    """Operations of the GRU stack over one sequence (T steps), per SMILES:
    forward, and with ``backward`` its backward."""
    T, C, Lz, H, L = (sizes[k] for k in ("max_len", "charset_size", "latent_dim", "gru_hidden", "gru_layers"))
    g = 3 * H
    z_part = 2.0 * Lz * g  # once per sequence
    char_part = T * g  # a gathered row of W_ih a step
    hidden = 2.0 * T * H * g  # h W_hh, every layer
    upper_in = 2.0 * T * H * g  # x W_ih of layers 1 ..
    fwd = z_part + char_part + L * hidden + (L - 1) * upper_in
    bwd = 2.0 * z_part + char_part + 2.0 * L * hidden + 2.0 * (L - 1) * upper_in if backward else 0.0
    return {"fwd": fwd, "bwd": bwd}


def head_ops(sizes: dict) -> float:
    """The latent embedding (once per sequence) and the output head (every
    step), forward, per SMILES."""
    Lz = sizes["latent_dim"]
    return 2.0 * Lz * Lz + 2.0 * sizes["max_len"] * sizes["gru_hidden"] * sizes["charset_size"]


def train_ops_per_smiles(sizes: dict) -> float:
    """One training step's least operations, per SMILES."""
    enc, gru, head = encoder_ops(sizes), gru_ops(sizes, True), head_ops(sizes)
    return enc["fwd"] + enc["bwd"] + gru["fwd"] + gru["bwd"] + 3.0 * head


def gru_train_ops_per_smiles(sizes: dict) -> float:
    gru = gru_ops(sizes, True)
    return gru["fwd"] + gru["bwd"]


def gru_train_bytes_per_step(sizes: dict, batch: int) -> float:
    """The GRU stack's least bytes a step, forward and backward: its bf16
    weights read once and their fp32 gradients written once, its inputs
    (the bf16 latent embedding and the codes) and the top layer's
    cotangent (fp32) read once, the top layer's bf16 output written once."""
    T, C, Lz, H, L = (sizes[k] for k in ("max_len", "charset_size", "latent_dim", "gru_hidden", "gru_layers"))
    weights = sum(((Lz + C) if li == 0 else H) * 3 * H + H * 3 * H + 2 * 3 * H for li in range(L))
    return weights * (2 + 4) + batch * (Lz * 2 + T + T * H * 4 + T * H * 2)


def decode_ops_per_smiles(sizes: dict) -> float:
    """A free-running decode's least operations, per SMILES: the latent
    embedding, the GRU stack's forward and the output head."""
    return gru_ops(sizes, False)["fwd"] + head_ops(sizes)


def decode_bytes_per_request(sizes: dict, rows: int, weight_bytes: int = 2) -> float:
    """A decode request's least bytes: the decoder's weights read once
    (bf16, or ``weight_bytes`` a value), the fp32 latents read once, the
    int32 codes written once."""
    T, C, Lz, H, L = (sizes[k] for k in ("max_len", "charset_size", "latent_dim", "gru_hidden", "gru_layers"))
    weights = Lz * Lz + sum(((Lz + C) if li == 0 else H) * 3 * H + H * 3 * H for li in range(L)) + H * C
    return float(weight_bytes) * weights + rows * (4.0 * Lz + 4.0 * T)


def bound_s(ops: float, moved: float, device_name: str, precision: str = "bf16") -> Optional[float]:
    """The least seconds the card could take: the larger of the operations
    at the peak of ``precision`` (``flops``) and the bytes at the memory
    rate; None without a peak."""
    rate_ops, rate = flops(device_name, precision), peak(device_name, "hbm_bytes_s")
    if rate_ops is None or rate is None:
        return None
    return max(ops / rate_ops, moved / rate)

