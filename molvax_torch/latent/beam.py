"""Beam-search decoding: approximate-MAP sequences from a latent.

Port of ``molvax/latent/beam.py:45-214``. The beams ride the batch
dimension: the fp32 GRU step runs once per timestep on (B*K, .) rows, and
each step keeps the K best of the (B, K*C) candidates. With
``constrained=True`` the valence automaton masks each step's logits before
``log_softmax`` (``kernels.automaton.auto_mask``), and after the top-K the
packed automaton rows are reordered by parent (one ``index_select``) and
advanced by the chosen tokens (``auto_advance``): the hand-written kernel on
CUDA, its plain version on the CPU. Finished beams (pad emitted) extend only
with pad, at logprob 0.

Tie order: ``jax.lax.top_k`` returns the lower index first among equal
values, and the -1e30 fills make exact ties common (at t=0, and whenever
fewer than K tokens are legal). ``torch.topk`` does not promise an order,
so the top K come from a stable descending sort.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn.functional as F

from ..data.charset import DEFAULT_CHARSET, Charset
from ..data.featurize import decode_codes, encode_smiles, one_hot
from ..kernels import automaton as kauto
from ..nn.decoder import latent_embed
from ..nn.encoder import linear
from ..nn.gru import gru_stack_step
from ..nn.vae import encode as vae_encode
from .constrain import build_tables
from .sample import generate

_NEG = -1e30  # additive -inf that stays nan-free under summation


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row, the lower
    index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_generate(
    model,
    cfg,
    z: torch.Tensor,
    beam: int = 5,
    constrained: bool = False,
    charset: Charset = DEFAULT_CHARSET,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """z (B, L) -> (codes (B, T) int32, logprob (B,) of the best beam).

    Deterministic; ``beam=1`` reproduces greedy decoding. A 'repeat_z'
    decoder is non-autoregressive, so its per-position argmax is the mode:
    beam search reduces to greedy there and routes to ``generate``."""
    B, K = z.shape[0], beam
    T, C = cfg.max_len, cfg.charset_size
    dev = z.device
    pad_id = charset.chars.index(" ") if " " in charset.chars else 0
    if constrained and charset.size != C:
        raise ValueError(f"constrained beam search: model charset_size {C} != charset size {charset.size}")
    itab = kauto.pack_tables(build_tables(charset)).to(dev) if constrained else None

    with torch.no_grad():
        if cfg.decoder_conditioning == "repeat_z":
            # the scan route: this branch consumes logits
            codes, logits = generate(
                model, dataclasses.replace(cfg, use_pallas_generation=False), z,
                greedy=True, constrained=constrained, charset=charset,
            )
            if constrained:
                # renormalize over the legal tokens: replay the chosen codes
                # through the automaton to rebuild each step's mask
                state = kauto.new_state(B, T, dev)
                masks = []
                for t in range(T):
                    masks.append(kauto.auto_mask(itab, state, T - 1 - t))
                    kauto.auto_advance(itab, state, codes[:, t])
                logits = torch.where(torch.stack(masks, dim=1), logits, _NEG)
            logp = F.log_softmax(logits, dim=-1)
            best = logp.gather(-1, codes.long()[..., None])[..., 0].sum(-1)
            return codes, best

        gru = model.gru
        L, H = gru.num_layers, cfg.gru_hidden
        z_tiled = torch.repeat_interleave(latent_embed(model, cfg, z), K, dim=0)  # (B*K, E)
        hs = torch.zeros(L, B * K, H, device=dev)
        prev = (
            model.start_token.float()[None, :].expand(B * K, C)
            if model.start_token is not None
            else torch.zeros(B * K, C, device=dev)
        )
        # only beam 0 is live at t=0, so the top K are K distinct first tokens
        scores = torch.full((B, K), _NEG, device=dev)
        scores[:, 0] = 0.0
        buf = torch.zeros(B, K, T, dtype=torch.int32, device=dev)
        done = torch.zeros(B, K, dtype=torch.bool, device=dev)
        state = kauto.new_state(B * K, T, dev) if constrained else None
        pad_only = torch.full((C,), _NEG, device=dev)
        pad_only[pad_id] = 0.0
        row0 = (torch.arange(B, device=dev) * K)[:, None]

        for t in range(T):
            x_t = torch.cat([z_tiled, prev], dim=-1)
            hs, out = gru_stack_step(gru, hs, x_t)
            logits_t = linear(out, model.linear_4.weight, model.linear_4.bias)  # (B*K, C)
            if constrained:
                logits_t = torch.where(kauto.auto_mask(itab, state, T - 1 - t), logits_t, _NEG)
            logp = F.log_softmax(logits_t, dim=-1)
            # frozen beams extend only with pad, at no cost
            logp = torch.where(done.reshape(B * K)[:, None], pad_only[None, :], logp)
            cand = scores[:, :, None] + logp.reshape(B, K, C)
            scores, flat_idx = _top_k(cand.reshape(B, K * C), K)
            parent = torch.div(flat_idx, C, rounding_mode="floor")
            token = (flat_idx % C).to(torch.int32)
            src = (row0 + parent).reshape(-1)  # parent row of each new beam
            hs = hs[:, src]
            buf = buf.reshape(B * K, T)[src].reshape(B, K, T)
            buf[:, :, t] = token
            done = done.reshape(-1)[src].reshape(B, K) | (token == pad_id)
            prev = one_hot(token.reshape(-1), C)
            if constrained:
                state = torch.index_select(state, 0, src)
                kauto.auto_advance(itab, state, token.reshape(-1))

        best = torch.argmax(scores, dim=1)
        rows = torch.arange(B, device=dev)
        return buf[rows, best], scores[rows, best]


def beam_reconstruct(
    model,
    cfg,
    smiles: List[str],
    beam: int = 5,
    charset: Charset = DEFAULT_CHARSET,
    constrained: bool = False,
) -> List[str]:
    """encode -> mu -> beam-search decode -> strings."""
    codes = torch.from_numpy(encode_smiles(smiles, charset, cfg.max_len)).to(model.device)
    with torch.no_grad():
        mu, _ = vae_encode(model, cfg, codes)
    out_codes, _ = beam_generate(model, cfg, mu, beam=beam, constrained=constrained, charset=charset)
    return decode_codes(out_codes, charset)
