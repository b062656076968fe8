"""Generation: prior sampling and free-running (autoregressive) decoding.

Port of ``molvax/latent/sample.py:36-208,246-271,341-361``. ``generate``
routes as the reference does: 'repeat_z' decoders decode in one
non-autoregressive pass (``nn.decoder.decode``). With
``cfg.use_pallas_generation`` on, a teacher-forced decoder, bf16 matmuls,
``constrained=False`` and tensors on CUDA, the whole decode is one launch of
the hand-written generation kernel (``kernels/generate.py``) and no logits
are materialized. Otherwise the fp32 scan runs as a plain loop over T.

Host-side draws (z from the prior, the reparameterization noise, the
sampling seed) come from a ``torch.Generator``; its stream differs from
``jax.random``'s, so tests hand both packages the same numpy inputs.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..data.charset import DEFAULT_CHARSET, Charset
from ..data.featurize import decode_codes, encode_smiles, one_hot
from ..nn.decoder import decode, latent_embed
from ..nn.encoder import linear
from ..nn.gru import gru_stack_step
from ..nn.vae import encode as vae_encode, reparameterize

_CONSTRAINED_TODO = (
    "constrained decoding is not ported yet (ROADMAP queue A, "
    "'Constrained decoding and beam search', with kernel auto_step_pallas)"
)


def _default_generator() -> torch.Generator:
    return torch.Generator().manual_seed(0)


def _draw_seed(generator: torch.Generator) -> int:
    """A 32-bit seed for the decode's sampling noise, drawn from ``generator``."""
    return int(torch.randint(0, 1 << 32, (), generator=generator, device=generator.device))


def generate(
    model,
    cfg,
    z: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    greedy: bool = True,
    temperature: float = 1.0,
    constrained: bool = False,
    charset: Charset = DEFAULT_CHARSET,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """z (B, latent) -> (codes (B, T) int32, logits (B, T, C) or None).

    On the kernel route the logits are never materialized and the second
    value is None; callers that need logits must take the scan route
    (``dataclasses.replace(cfg, use_pallas_generation=False)``). Sampling
    (``greedy=False``) draws Gumbel-max noise keyed by a seed drawn from
    ``generator``, identical on both routes (``kernels.generate.noise_bits``)."""
    from ..kernels.generate import (
        fused_generate,
        generation_kernel_supported,
        gumbel_noise,
    )

    if constrained:
        raise NotImplementedError(_CONSTRAINED_TODO)
    if charset.size != cfg.charset_size:
        raise ValueError(f"charset size {charset.size} != model charset_size {cfg.charset_size}")
    generator = generator if generator is not None else _default_generator()
    seed = _draw_seed(generator)
    B, T, C = z.shape[0], cfg.max_len, cfg.charset_size

    with torch.no_grad():
        if cfg.decoder_conditioning == "repeat_z":
            # one non-autoregressive pass: the decoder never sees its outputs
            logits = decode(model, cfg, z)
            scores = logits
            if not greedy:
                noise = torch.stack([gumbel_noise(seed, t, B, C, z.device) for t in range(T)], dim=1)
                scores = logits / temperature + noise
            return torch.argmax(scores, dim=-1).to(torch.int32), logits

        z_emb = latent_embed(model, cfg, z)
        if cfg.use_pallas_generation and generation_kernel_supported(cfg, z.device):
            codes = fused_generate(model, cfg, z_emb, seed, greedy=greedy, temperature=temperature)
            return codes, None

        gru = model.gru
        hs = torch.zeros(gru.num_layers, B, cfg.gru_hidden, device=z.device)
        prev = (
            model.start_token.float()[None, :].expand(B, C)
            if model.start_token is not None
            else torch.zeros(B, C, device=z.device)
        )
        codes = torch.empty(B, T, dtype=torch.int32, device=z.device)
        logits = torch.empty(B, T, C, device=z.device)
        for t in range(T):
            x_t = torch.cat([z_emb, prev], dim=-1)
            hs, out = gru_stack_step(gru, hs, x_t)
            logits_t = linear(out, model.linear_4.weight, model.linear_4.bias)
            scores = logits_t
            if not greedy:
                scores = logits_t / temperature + gumbel_noise(seed, t, B, C, z.device)
            code_t = torch.argmax(scores, dim=-1)
            codes[:, t] = code_t.to(torch.int32)
            logits[:, t] = logits_t
            prev = one_hot(code_t, C)
    return codes, logits


def sample_prior(
    model,
    cfg,
    n: int,
    generator: Optional[torch.Generator] = None,
    charset: Charset = DEFAULT_CHARSET,
    greedy: bool = True,
    temperature: float = 1.0,
    scale: float = 1.0,
    constrained: bool = False,
) -> List[str]:
    """Decode n latents from the prior z ~ N(0, scale^2 I) to SMILES strings.
    z is drawn from ``generator`` on its device, then moved to the model's."""
    generator = generator if generator is not None else _default_generator()
    z = scale * torch.randn(n, cfg.latent_dim, generator=generator, device=generator.device)
    codes, _ = generate(
        model, cfg, z.to(model.device), generator, greedy=greedy,
        temperature=temperature, constrained=constrained, charset=charset,
    )
    return decode_codes(codes, charset)


def reconstruct(
    model,
    cfg,
    smiles: List[str],
    generator: Optional[torch.Generator] = None,
    charset: Charset = DEFAULT_CHARSET,
    stochastic: bool = False,
) -> List[str]:
    """encode -> (mu, or z sampled around it) -> greedy free-running decode
    -> strings."""
    generator = generator if generator is not None else _default_generator()
    codes = torch.from_numpy(encode_smiles(smiles, charset, cfg.max_len)).to(model.device)
    with torch.no_grad():
        mu, logvar = vae_encode(model, cfg, codes)
        z = reparameterize(mu, logvar, cfg.eps_scale, generator) if stochastic else mu
    out_codes, _ = generate(model, cfg, z, generator, greedy=True, charset=charset)
    return decode_codes(out_codes, charset)
