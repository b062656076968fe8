"""Batch latent embedding: corpus -> latents and latents -> SMILES.

Port of ``molvax/latent/embed.py``: encode a library to latent vectors
(the VAE as a fixed featurizer), decode candidate vectors back to
molecules. Work runs in chunks of ``batch`` rows; unlike the reference,
the last chunk is not padded up, since a torch call needs no fixed shape.
``save_latents`` / ``load_latents`` keep the reference's ``.npz`` layout
(``molvax encode`` writes ``mu``, ``logvar`` and ``smiles``; ``molvax
decode`` reads ``z``, else ``mu``, or a bare ``.npy`` array).

``mesh=`` runs each chunk data-parallel over the mesh's 'data' axis
(``parallel.map_rows``: a rank encodes or decodes its share of the chunk,
the last chunk's rows padded up to the axis by repeating its first, and
every rank gets all the rows), as the reference shards each chunk; the
``batch`` must divide by the data axis, as there.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.alphabet import DEFAULT_CHARSET, Alphabet, Charset, encode, strings
from ..nn.vae import encode as vae_encode
from ..parallel import map_rows


def _check_batch(mesh, batch: int) -> None:
    """The reference's refusal of a chunk the data axis does not divide."""
    if mesh is not None and mesh.collective and batch % mesh.data:
        raise ValueError(f"batch {batch} not divisible by mesh data axis {mesh.data}")


def encode_codes_chunked(model, cfg, codes, batch: int = 512, mesh=None) -> Tuple[np.ndarray, np.ndarray]:
    """Posterior encode of codes (N, T) in chunks of ``batch`` rows:
    (mu, logvar), float32 numpy arrays of shape (N, latent_dim); empty
    input gives empty (0, L) arrays. The helper behind ``encode_corpus``
    and ``sample.fit_aggregate_posterior``. ``mesh``: each chunk
    data-parallel (module docstring)."""
    _check_batch(mesh, batch)
    codes = np.asarray(codes)

    def encode_rows(part: np.ndarray, row_base: int):
        with torch.no_grad():
            mu, logvar = vae_encode(model, cfg, torch.from_numpy(part).to(model.device))
        return mu.float().cpu(), logvar.float().cpu()

    mus, logvars = [np.zeros((0, cfg.latent_dim), np.float32)], [np.zeros((0, cfg.latent_dim), np.float32)]
    for lo in range(0, codes.shape[0], batch):
        mu, logvar = map_rows(mesh, codes[lo : lo + batch], encode_rows)
        mus.append(mu.numpy())
        logvars.append(logvar.numpy())
    return np.concatenate(mus, axis=0), np.concatenate(logvars, axis=0)


def posterior_of(model, cfg, smiles, charset: Optional[Alphabet] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """SMILES -> (mu, logvar) on the model's device, in one batch."""
    with torch.no_grad():
        return vae_encode(model, cfg, torch.from_numpy(encode(smiles, cfg, charset)).to(model.device))


def encode_corpus(
    model, cfg, smiles: List[str], charset: Charset = DEFAULT_CHARSET, batch: int = 256, mesh=None
) -> Tuple[np.ndarray, np.ndarray]:
    """SMILES -> posterior parameters ``(mu, logvar)``, float32 (N,
    latent_dim). ``mu`` is the embedding downstream models should consume
    (the reparameterized sample only adds decoder-facing noise). ``mesh``:
    each chunk data-parallel (module docstring)."""
    return encode_codes_chunked(model, cfg, encode(smiles, cfg, charset), batch=batch, mesh=mesh)


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
    mesh=None,
) -> List[str]:
    """Latent vectors (N, latent_dim) -> SMILES, in chunks of ``batch``.
    ``beam > 1``: the beam-search approximate-MAP string of each latent
    (``latent.beam``); else greedy or temperature sampling
    (``latent.sample.generate``, each chunk's noise seed drawn from
    ``generator``), under the valence automaton where ``constrained``.
    ``mesh``: each chunk data-parallel (module docstring; every rank
    passes a generator in the same state), the noise of each row that of
    its row in the 1-rank call."""
    from .beam import beam_generate  # beam and sample import this module
    from .sample import _default_generator, generate

    z = np.asarray(z.detach().cpu() if isinstance(z, torch.Tensor) else z, np.float32)
    if z.ndim != 2 or z.shape[1] != cfg.latent_dim:
        raise ValueError(f"latents must be (N, {cfg.latent_dim}); got {z.shape}")
    _check_batch(mesh, batch)
    generator = generator if generator is not None else _default_generator()

    def decode_rows(part: np.ndarray, row_base: int) -> torch.Tensor:
        zb = torch.from_numpy(part).to(model.device)
        if beam > 1:
            return beam_generate(model, cfg, zb, beam=beam, constrained=constrained, charset=charset)[0]
        return generate(model, cfg, zb, generator, greedy=greedy, temperature=temperature,
                        constrained=constrained, charset=charset, row_base=row_base)[0]

    out: List[str] = []
    for lo in range(0, z.shape[0], batch):
        out.extend(strings(map_rows(mesh, z[lo : lo + batch], decode_rows), cfg, charset))
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
