"""MolecularVAE: the port's parameter holder, encode, reparameterize,
decode and the training forward.

Port of ``molvax/nn/vae.py:35-156``. Module names are those of the reference
twin (``bench/torch_twin/model.py``): ``conv_1..N``, ``linear_0`` (dense),
``linear_1`` (mu), ``linear_2`` (logvar), ``linear_3`` (latent embed),
``gru`` (weights only: the port never runs ``nn.GRU``'s forward),
``linear_4`` (output head), ``prop_hidden``/``prop_out`` when the config has
a property head, and ``start_token`` when it learns one. A state dict from
``io.convert.state_dict_from_jax`` loads with ``strict=True``.

Where the reference threads a JAX key, the port threads a 32-bit seed: the
sampler's eps (fused or plain: ``kernels.sampler.sample_eps``) and the
scheduled-sampling and word-dropout masks draw from the counter hash of
``kernels.generate.noise_bits`` keyed by it, so a step is deterministic and
resumable on any device. Every draw is keyed by the batch row's global
index: a data-parallel rank passes ``row_base``, the global index of its
first row, and draws the noise of its rows of the global batch (0 in one
process). The seed, and the
scheduled-sampling probability, may be Python numbers or one-element
tensors on the model's device: a train step reads them from vectors on
the card, so nothing in it waits for the host (and a CUDA Graph of steps
replays with new values).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn as nn

from ..data.featurize import one_hot
from ..kernels import conv_enc, sampler
from ..kernels.generate import noise_bits
from ..kernels.sampler import Seed
from ..utils import matmul_dtype, resolve_device
from .decoder import decode as _decode, decoder_input_size
from .encoder import conv_input_channels, encode as _encode, flat_conv_dim
from .property_head import init_property_head, predict_properties


class VAEOutput(NamedTuple):
    logits: torch.Tensor  # (B, T, C) decoder logits
    mu: torch.Tensor  # (B, L)
    logvar: torch.Tensor  # (B, L)
    z: torch.Tensor  # (B, L) sampled latent
    properties: Optional[torch.Tensor] = None  # (B, P) if the head is configured
    kl: Optional[torch.Tensor] = None  # (B,) per-sample KL when the fused sampler ran


class MolecularVAE(nn.Module):
    def __init__(self, cfg, device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        dev = resolve_device(device)
        in_ch = conv_input_channels(cfg)
        for i, (out_ch, k) in enumerate(
            zip(cfg.conv_channels, cfg.conv_kernels), start=1
        ):
            setattr(self, f"conv_{i}", nn.Conv1d(in_ch, out_ch, k, device=dev))
            in_ch = out_ch
        self.linear_0 = nn.Linear(flat_conv_dim(cfg), cfg.enc_hidden, device=dev)
        self.linear_1 = nn.Linear(cfg.enc_hidden, cfg.latent_dim, device=dev)
        self.linear_2 = nn.Linear(cfg.enc_hidden, cfg.latent_dim, device=dev)
        self.linear_3 = nn.Linear(cfg.latent_dim, cfg.latent_dim, device=dev)
        self.gru = nn.GRU(
            decoder_input_size(cfg),
            cfg.gru_hidden,
            cfg.gru_layers,
            batch_first=True,
            device=dev,
        )
        self.linear_4 = nn.Linear(cfg.gru_hidden, cfg.charset_size, device=dev)
        if cfg.n_properties > 0:
            self.prop_hidden, self.prop_out = init_property_head(cfg, dev)
        self.start_token = (
            nn.Parameter(torch.zeros(cfg.charset_size, device=dev))
            if cfg.learned_start
            else None
        )
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self.linear_0.weight.device

    def encode(self, codes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return encode(self, self.cfg, codes)


def encode(model: MolecularVAE, cfg, codes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """codes (B, T) integer -> (mu, logvar). The one-hot is built on the
    codes' device."""
    return _encode(model, cfg, one_hot(codes, cfg.charset_size))


def reparameterize(
    mu: torch.Tensor,
    logvar: torch.Tensor,
    eps_scale: float = 1.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """z = mu + eps_scale * exp(0.5*logvar) * eps, eps ~ N(0, I) drawn from
    ``generator`` (on its own device, then moved to mu's)."""
    gen_device = generator.device if generator is not None else mu.device
    eps = torch.randn(mu.shape, generator=generator, device=gen_device).to(mu.device)
    return mu + eps_scale * torch.exp(0.5 * logvar) * eps


# salts of the per-step mask draws (the reference's fold_in constants)
_SS_SALT = 0x5C4ED
_WD_SALT = 0xD409


Prob = Union[float, torch.Tensor]


def bernoulli_mask(seed: Seed, salt: int, p: Prob, shape, device, row_base: int = 0) -> torch.Tensor:
    """(B, T) bool mask, True with probability ``p``, from the counter hash:
    u = top24(noise_bits(seed, salt, row, t)) / 2**24 in [0, 1), mask = u < p,
    for the global rows ``row_base`` .. ``row_base + B - 1``. Exactly all
    False at p = 0 and all True at p = 1. ``p`` a float or a 0-d fp32
    tensor (compared in fp32 either way)."""
    rows = torch.arange(row_base, row_base + shape[0], dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(shape[1], dtype=torch.int64, device=device)[None, :]
    u = (noise_bits(seed, salt, rows, cols) >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u < p


def decode(
    model: MolecularVAE, cfg, z: torch.Tensor, teacher_codes: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """z -> logits (B, T, C). ``teacher_codes`` (B, T) is required for
    teacher-forced decoding; ``latent.sample.generate`` decodes free-running."""
    teacher = one_hot(teacher_codes, cfg.charset_size) if teacher_codes is not None else None
    return _decode(model, cfg, z, teacher)


def forward(
    model: MolecularVAE,
    cfg,
    seed: Seed,
    codes: torch.Tensor,
    ss_prob: Optional[Prob] = None,
    wd_prob: Optional[float] = None,
    row_base: int = 0,
) -> VAEOutput:
    """The training forward: codes (B, T) -> VAEOutput.

    With ``cfg.use_pallas`` and bf16 matmuls, the encoder is the fused
    encoder kernel and z / KL come from the fused sampler (each takes its
    plain version for CPU tensors). Otherwise the plain encoder runs and
    z = mu + eps_scale * exp(logvar / 2) * eps, with the fused sampler's
    own eps (``sampler.sample_eps``): the two routes draw the same eps for
    the same seed, and a seed on the device is read there, so every
    configuration's step can be captured in a CUDA Graph.

    ``ss_prob`` turns on two-pass scheduled sampling: a first teacher-forced
    decode (no gradient) predicts each character, and each teacher input is
    replaced by its prediction with probability ss_prob. ``wd_prob`` zeroes
    each teacher input's one-hot row with probability wd_prob (word
    dropout). Pass None, not 0, when off. ``row_base``: the global index of
    the first row of ``codes`` (a data-parallel rank's share), which keys
    every draw."""
    kl = None
    if cfg.use_pallas and matmul_dtype(cfg, codes.device) == torch.bfloat16:
        mu, logvar = conv_enc.fused_encode(model, cfg, codes)
        z, kl = sampler.fused_sample_kl(seed, mu, logvar, cfg.eps_scale, row_base)
    else:
        mu, logvar = encode(model, cfg, codes)
        eps = sampler.sample_eps(seed, mu.shape[0], mu.shape[1], mu.device, row_base)
        z = mu + cfg.eps_scale * torch.exp(0.5 * logvar) * eps
    teacher = codes if cfg.decoder_conditioning == "teacher_forced" else None
    if ss_prob is not None and teacher is not None:
        with torch.no_grad():
            pred = decode(model, cfg, z.detach(), teacher).argmax(dim=-1).to(codes.dtype)
        mix = bernoulli_mask(seed, _SS_SALT, ss_prob, codes.shape, codes.device, row_base)
        teacher = torch.where(mix, pred, codes)
    if wd_prob is not None and teacher is not None:
        # drop to the zero vector, not to the pad character (a real symbol)
        toh = one_hot(teacher, cfg.charset_size)
        drop = bernoulli_mask(seed, _WD_SALT, wd_prob, teacher.shape, teacher.device, row_base)
        logits = _decode(model, cfg, z, toh.masked_fill(drop[..., None], 0.0))
    else:
        logits = decode(model, cfg, z, teacher)
    props = predict_properties(model, cfg, z) if cfg.n_properties > 0 else None
    return VAEOutput(logits=logits, mu=mu, logvar=logvar, z=z, properties=props, kl=kl)
