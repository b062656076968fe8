"""Batch latent embedding: corpus -> latents and latents -> SMILES.

Port of ``molvax/latent/embed.py``: encode a library to latent vectors
(the VAE as a fixed featurizer), decode candidate vectors back to
molecules. Work runs in chunks of ``batch`` rows; unlike the reference,
the last chunk is not padded up, since a torch call needs no fixed shape.
``save_latents`` / ``load_latents`` keep the reference's ``.npz`` layout
(``molvax encode`` writes ``mu``, ``logvar`` and ``smiles``; ``molvax
decode`` reads ``z``, else ``mu``, or a bare ``.npy`` array).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.charset import DEFAULT_CHARSET, Charset
from ..data.featurize import decode_codes, encode_smiles
from ..nn.vae import encode as vae_encode


def encode_codes_chunked(model, cfg, codes, batch: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """Posterior encode of codes (N, T) in chunks of ``batch`` rows:
    (mu, logvar), float32 numpy arrays of shape (N, latent_dim); empty
    input gives empty (0, L) arrays. The helper behind ``encode_corpus``
    and ``sample.fit_aggregate_posterior``."""
    codes = np.asarray(codes)
    mus, logvars = [np.zeros((0, cfg.latent_dim), np.float32)], [np.zeros((0, cfg.latent_dim), np.float32)]
    for lo in range(0, codes.shape[0], batch):
        with torch.no_grad():
            mu, logvar = vae_encode(model, cfg, torch.from_numpy(codes[lo : lo + batch]).to(model.device))
        mus.append(mu.float().cpu().numpy())
        logvars.append(logvar.float().cpu().numpy())
    return np.concatenate(mus, axis=0), np.concatenate(logvars, axis=0)


def encode_corpus(
    model, cfg, smiles: List[str], charset: Charset = DEFAULT_CHARSET, batch: int = 256
) -> Tuple[np.ndarray, np.ndarray]:
    """SMILES -> posterior parameters ``(mu, logvar)``, float32 (N,
    latent_dim). ``mu`` is the embedding downstream models should consume
    (the reparameterized sample only adds decoder-facing noise)."""
    return encode_codes_chunked(model, cfg, encode_smiles(smiles, charset, cfg.max_len), batch=batch)


def decode_latents(
    model,
    cfg,
    z,
    generator: Optional[torch.Generator] = None,
    charset: Charset = DEFAULT_CHARSET,
    batch: int = 256,
    greedy: bool = True,
    temperature: float = 1.0,
    constrained: bool = False,
    beam: int = 1,
) -> List[str]:
    """Latent vectors (N, latent_dim) -> SMILES, in chunks of ``batch``.
    ``beam > 1``: the beam-search approximate-MAP string of each latent
    (``latent.beam``); else greedy or temperature sampling
    (``latent.sample.generate``, each chunk's noise seed drawn from
    ``generator``), under the valence automaton where ``constrained``."""
    from .beam import beam_generate  # beam and sample import this module
    from .sample import _default_generator, generate

    z = np.asarray(z.detach().cpu() if isinstance(z, torch.Tensor) else z, np.float32)
    if z.ndim != 2 or z.shape[1] != cfg.latent_dim:
        raise ValueError(f"latents must be (N, {cfg.latent_dim}); got {z.shape}")
    generator = generator if generator is not None else _default_generator()
    out: List[str] = []
    for lo in range(0, z.shape[0], batch):
        zb = torch.from_numpy(z[lo : lo + batch]).to(model.device)
        if beam > 1:
            codes, _ = beam_generate(model, cfg, zb, beam=beam, constrained=constrained, charset=charset)
        else:
            codes, _ = generate(model, cfg, zb, generator, greedy=greedy, temperature=temperature,
                                constrained=constrained, charset=charset)
        out.extend(decode_codes(codes, charset))
    return out


def save_latents(path: str, mu: np.ndarray, logvar: np.ndarray, smiles: Sequence[str]) -> None:
    """The reference's ``molvax encode --out`` file: ``mu``, ``logvar`` and
    ``smiles`` in one ``.npz``."""
    np.savez(path, mu=mu, logvar=logvar, smiles=np.asarray(list(smiles), dtype=object))


def load_latents(path: str) -> np.ndarray:
    """The latents of a ``.npy`` (N, L) array or of an ``.npz`` (its ``z``,
    else its ``mu``), as the reference's ``molvax decode`` reads them."""
    data = np.load(path, allow_pickle=False)  # the latents are numbers: nothing to unpickle
    if not hasattr(data, "files"):
        return data
    name = "z" if "z" in data.files else "mu" if "mu" in data.files else None
    if name is None:
        raise ValueError(f"{path}: expected a 'z' or 'mu' array in the .npz (found: {', '.join(data.files) or 'none'})")
    return data[name]
