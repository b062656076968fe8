"""Generation: prior sampling and free-running (autoregressive) decoding.

Port of ``molvax/latent/sample.py:36-208,246-361``. ``generate``
routes as the reference does: 'repeat_z' decoders decode in one
non-autoregressive pass (``nn.decoder.decode``). With
``cfg.use_pallas_generation`` on, a teacher-forced decoder, bf16 matmuls,
``constrained=False`` and tensors on CUDA, the whole decode is one launch of
the hand-written generation kernel (``kernels/generate.py``) and no logits
are materialized. Otherwise the fp32 scan runs as a plain loop over T.

``constrained=True`` threads the valence automaton (``latent/constrain.py``)
through the decode, as the reference does: the GRU step stays the fp32
scan, and each step's scores (the logits, or logits / temperature + Gumbel
noise) go through one ``kernels.automaton.auto_step`` with n=1, which masks
the illegal tokens, picks the first maximum and advances the automaton: the
hand-written kernel on CUDA, its plain version on the CPU. A 'repeat_z'
decoder takes one ``auto_step`` with n=T over its precomputed scores. The
generation kernel is never taken when ``constrained=True``.

Host-side draws (z from the prior, the reparameterization noise, the
sampling seed) come from a ``torch.Generator``; its stream differs from
``jax.random``'s, so tests hand both packages the same numpy inputs.

``mesh=`` on ``sample_prior`` and ``sample_aggregate`` decodes data-parallel
(``parallel.map_rows``): every rank draws the global z and the noise seed
from a generator in the same state, decodes its rows of z with the noise
of their global rows (``row_base``), and every rank gets all the strings,
those of the 1-rank call.

Under a running profiler a request is marked in spans (``utils.span``):
``sample.draw_z``, ``sample.decode`` (and on the scan route, per step,
``sample.step`` holding ``sample.noise`` and ``sample.select``), then
``sample.to_host``, where the host waits for the card, and ``sample.strings``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..data.charset import DEFAULT_CHARSET, Charset
from ..data.featurize import decode_codes, encode_smiles, one_hot
from ..kernels import automaton as kauto
from ..nn.decoder import decode, latent_embed
from ..nn.encoder import linear
from ..nn.gru import gru_stack_step
from ..nn.vae import encode as vae_encode, reparameterize
from ..parallel import map_rows
from ..utils import span
from .constrain import build_tables
from .embed import encode_codes_chunked


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
    row_base: int = 0,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """z (B, latent) -> (codes (B, T) int32, logits (B, T, C) or None).

    On the kernel route the logits are never materialized and the second
    value is None; callers that need logits must take the scan route
    (``dataclasses.replace(cfg, use_pallas_generation=False)``). Sampling
    (``greedy=False``) draws Gumbel-max noise keyed by a seed drawn from
    ``generator``, identical on both routes (``kernels.generate.noise_bits``).
    ``constrained=True`` masks every step through the valence automaton
    (module docstring) and always returns the logits. ``row_base``: the
    global index of z's first row, which keys its sampling noise (a
    data-parallel rank's share of a global batch)."""
    if charset.size != cfg.charset_size:
        raise ValueError(f"charset size {charset.size} != model charset_size {cfg.charset_size}")
    with span("sample.decode"):
        return _generate(model, cfg, z, generator, greedy, temperature, constrained, charset, row_base)


def _generate(model, cfg, z: torch.Tensor, generator: Optional[torch.Generator], greedy: bool, temperature: float,
              constrained: bool, charset: Charset, row_base: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``generate``'s decode, after its checks."""
    from ..kernels.generate import (
        fused_generate,
        generation_kernel_supported,
        gumbel_noise,
    )

    generator = generator if generator is not None else _default_generator()
    seed = _draw_seed(generator)
    B, T, C = z.shape[0], cfg.max_len, cfg.charset_size
    itab = state = None
    if constrained:
        itab = kauto.pack_tables(build_tables(charset)).to(z.device)
        state = kauto.new_state(B, T, z.device)

    def scores_of(logits_t, t):
        if greedy:
            return logits_t
        with span("sample.noise"):
            noise = gumbel_noise(seed, t, B, C, z.device, row_base)
        return logits_t / temperature + noise

    with torch.no_grad():
        if cfg.decoder_conditioning == "repeat_z":
            # one non-autoregressive pass: the decoder never sees its outputs
            logits = decode(model, cfg, z)
            scores = logits
            if not greedy:
                scores = torch.stack([scores_of(logits[:, t], t) for t in range(T)], dim=1)
            with span("sample.select"):
                if constrained:
                    # non-autoregressive logits, sequential constrained selection
                    return kauto.auto_step(itab, state, scores.float().contiguous(), T - 1), logits
                return torch.argmax(scores, dim=-1).to(torch.int32), logits

        z_emb = latent_embed(model, cfg, z)
        if cfg.use_pallas_generation and not constrained and generation_kernel_supported(cfg, z.device):
            codes = fused_generate(model, cfg, z_emb, seed, greedy=greedy, temperature=temperature,
                                   row_base=row_base)
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
            with span("sample.step"):
                x_t = torch.cat([z_emb, prev], dim=-1)
                hs, out = gru_stack_step(gru, hs, x_t)
                logits_t = linear(out, model.linear_4.weight, model.linear_4.bias)
                scores = scores_of(logits_t, t)
                with span("sample.select"):
                    if constrained:
                        code_t = kauto.auto_step(itab, state, scores.contiguous(), T - 1 - t)[:, 0]
                    else:
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
    mesh=None,
) -> List[str]:
    """Decode n latents from the prior z ~ N(0, scale^2 I) to SMILES strings.
    z is drawn from ``generator`` on its device, then moved to the model's.
    ``mesh`` decodes data-parallel over its 'data' axis (n must divide by
    it; every rank passes a generator in the same state): the strings of
    the 1-rank call, on every rank."""
    generator = generator if generator is not None else _default_generator()
    with span("sample.draw_z"):
        z = scale * torch.randn(n, cfg.latent_dim, generator=generator, device=generator.device)
    return _decode_over(model, cfg, z, generator, greedy, temperature, constrained, charset, mesh)


def _decode_over(model, cfg, z: torch.Tensor, generator, greedy: bool, temperature: float, constrained: bool,
                 charset: Charset, mesh) -> List[str]:
    """``generate`` of z's rows on the model's device, data-parallel over
    ``mesh`` where one is given (the reference's divisibility check), as
    strings."""
    if mesh is not None and mesh.collective and z.shape[0] % mesh.data:
        raise ValueError(f"batch {z.shape[0]} not divisible by mesh data axis {mesh.data}")

    def decode_rows(part: torch.Tensor, row_base: int) -> torch.Tensor:
        return generate(model, cfg, part.to(model.device), generator, greedy=greedy, temperature=temperature,
                        constrained=constrained, charset=charset, row_base=row_base)[0]

    codes = map_rows(mesh, z, decode_rows)
    with span("sample.to_host"):  # the host waits here for the decode on the card
        codes = codes.cpu()
    with span("sample.strings"):
        return decode_codes(codes, charset)


def fit_aggregate_posterior(
    model, cfg, codes, batch: int = 512, max_n: int = 20_000
) -> Tuple[torch.Tensor, torch.Tensor]:
    """N(mean, cov) fitted to the model's aggregate posterior over the
    first ``max_n`` rows of ``codes``: mean and covariance of the encoded
    mu's, plus the mean encoder noise the decoder was trained to absorb
    (cov += eps_scale^2 * E[sigma^2], diagonal), in float64 on the host.
    A trained posterior rarely matches the prior N(0, I) (in the small-eps
    lineage the means spread far past the prior's shell), so samples from
    this fit land on the data manifold where prior samples may not.

    Returns (mean (L,), chol (L, L)), fp32 on the model's device: pass
    them to ``sample_aggregate``."""
    n = min(codes.shape[0], max_n)
    mu_all, logvar_all = encode_codes_chunked(model, cfg, np.asarray(codes)[:n], batch=batch)
    mu_all = mu_all.astype(np.float64)
    var_mean = np.exp(logvar_all.astype(np.float64)).mean(axis=0)
    mean = mu_all.mean(axis=0)
    cov = np.cov(mu_all.T) + np.diag(cfg.eps_scale**2 * var_mean)
    # jitter keeps the factorization stable when some dims are collapsed
    chol = np.linalg.cholesky(cov + 1e-6 * np.eye(cov.shape[0]))
    to = dict(dtype=torch.float32, device=model.device)
    return torch.as_tensor(mean, **to), torch.as_tensor(chol, **to)


def sample_aggregate(
    model,
    cfg,
    n: int,
    generator: Optional[torch.Generator],
    mean: torch.Tensor,
    chol: torch.Tensor,
    charset: Charset = DEFAULT_CHARSET,
    greedy: bool = True,
    temperature: float = 1.0,
    constrained: bool = False,
    mesh=None,
) -> List[str]:
    """Decode n latents z = mean + chol @ eps, eps ~ N(0, I) drawn from
    ``generator`` on its device (``fit_aggregate_posterior``), to SMILES.
    ``mesh`` as ``sample_prior``'s."""
    generator = generator if generator is not None else _default_generator()
    eps = torch.randn(n, cfg.latent_dim, generator=generator, device=generator.device)
    z = mean[None, :] + eps.to(mean.device) @ chol.T
    return _decode_over(model, cfg, z, generator, greedy, temperature, constrained, charset, mesh)


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
