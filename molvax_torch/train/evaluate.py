"""Held-out evaluation: the free-running round trip.

Port of ``molvax/train/evaluate.py:173-201`` (``reconstruction_metrics``,
the probe that ``train()`` runs at its eval cadence). The rest of the
reference's module (generation, constrained, beam, interpolation,
posterior, aggregate and optimization metrics, ``evaluate``) is not ported
yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..data.charset import Charset
from ..data.featurize import decode_codes
from ..latent.sample import generate
from ..nn.vae import encode


def reconstruction_metrics(
    model,
    cfg,
    dataset,
    generator: Optional[torch.Generator] = None,
    n: int = 256,
    charset: Optional[Charset] = None,
) -> Dict[str, float]:
    """Free-running round trip of the first ``n`` rows of ``dataset``
    (encode -> z = mu -> greedy decode, ``latent.sample.generate``; on a
    card at a width ``generate_plan`` lays out, one persistent
    ``fused_generate`` decode): the exact-match string rate, the per-char
    accuracy over all T positions, and over the non-pad ones (the honest
    number: the pad tail is ~2/3 of T on ZINC-length strings). ``cfg`` is
    the whole ``Config``, as the reference's."""
    charset = charset or dataset.charset
    codes_np = np.asarray(dataset.codes[:n])
    codes = torch.from_numpy(codes_np).to(model.device)
    with torch.no_grad():
        mu, _ = encode(model, cfg.model, codes)
    out_codes, _ = generate(model, cfg.model, mu, generator, greedy=True, charset=charset)
    out_np = out_codes.cpu().numpy()
    exact = float(np.mean([a == b for a, b in zip(decode_codes(codes_np, charset), decode_codes(out_np, charset))]))
    hit = out_np == codes_np
    nonpad = codes_np != 0
    return {
        "recon_exact": exact,
        "recon_char_acc": float(np.mean(hit)),
        "recon_char_acc_nonpad": float(hit[nonpad].mean()) if nonpad.any() else 1.0,
    }
