"""The yardstick of the grammar configurations: least work of a decode and of the walk.

Frozen with the benchmark, beside ``yardstick.py`` (whose peaks it reads),
so that no change to the program moves it. A decode of the Grammar VAE is
one non-autoregressive pass: the latent embedding once a row, GRU layer
0's input product once a row (its input, the embedding, is the same at
every step), and at every step the recurrent products of every layer, the
input products of the layers above the first and the output head.
Operations count 2 per multiply-add; elementwise work is left out. At
``gvae_zinc``'s sizes: 2 x (3,136 + 84,168 + 277 x 3,803,091) = 2.107 GFLOP
a SMILES.

The walk reads each row's fp32 logits once and writes its rule codes and
terminal codes (one byte each, 3T a row) once.
"""

from __future__ import annotations


def decode_ops_per_smiles(sizes: dict) -> float:
    T, C, Lz, H, L = (sizes[k] for k in ("max_len", "charset_size", "latent_dim", "gru_hidden", "gru_layers"))
    g = 3 * H
    step = L * H * g + (L - 1) * H * g + H * C
    return 2.0 * (Lz * Lz + Lz * g + T * step)


def walk_bytes_per_smiles(sizes: dict) -> float:
    T, C = sizes["max_len"], sizes["charset_size"]
    return 4.0 * T * C + 3.0 * T
