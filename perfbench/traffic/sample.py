"""Sampling traffic: one client in a closed loop of prior-sampling requests.

A request is one call of the program's entry point,
``latent.sample_prior(model, cfg, n, generator, greedy=, temperature=,
constrained=)``, with a CPU generator seeded from the run's seed and the
request's index: the mix gives n, the mode and the temperature, as its
caller sends them. The next request is sent when the strings are back.
Each request's latency runs from the call to its strings; the rate is all
the strings of the window over its wall time.

Set-up makes the weights from the seed (``weights.make``) and warms the
mix's own request shape with requests of seeds the window never uses, as
many as the request's route needs to reach its steady path
(``warm_requests``): on the scan route (a constrained mix) a key runs op by
op at its first two calls and is captured at its third, and every later
call replays the graph (``molvax_torch.latent.sample``), so that route
warms with ``WARM_SCAN`` requests; the generation kernel's route (an
unconstrained mix) captures nothing and warms with one. The window notes
the decode graphs that the program captured and replayed in it (its
counters).

The check, once the window has closed: a sample of the finished requests,
drawn from the seed, with the one whose strings are longest in it. For
each, the plain reference (fp32, TF32 off) replays the request's z and
noise seed from its generator's seed, places the pads that the strings
dropped, and ``logit_gap`` is the widest gap by which a served token's
score (logit / temperature + the Gumbel noise of its row and step) lies
below the reference's best: over all tokens, or in a constrained mix over
the tokens that the reference's own automaton leaves legal after the
served prefix (a served token that it finds illegal reads as infinite);
``reference/served.py``.
"""

from __future__ import annotations

import statistics
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import corpus, weights
from ..reference import model as ref
from ..reference import served

_WARM = 2**32 - 1  # a request index no window reaches; the warm requests count down from it
WARM_SCAN = 3


def warm_requests(mix: dict) -> int:
    """The requests that bring the mix's route to its steady path."""
    return WARM_SCAN if mix["constrained"] else 1


def setup(ctx) -> None:
    t = time.perf_counter()
    from molvax_torch.kernels import _build
    from molvax_torch.nn.vae import MolecularVAE

    t = ctx.part("import_program", t)
    if ctx.device.type == "cuda":
        _build.load()
    t = ctx.part("library", t)
    model = MolecularVAE(ctx.cfg.model, device=ctx.device)
    model.load_state_dict(weights.make(ctx.sizes, ctx.seed, ctx.device))
    model.requires_grad_(False)
    ctx.sync()
    t = ctx.part("weights", t)
    ctx.state["model"] = model
    for k in range(warm_requests(ctx.mix)):
        request(ctx, corpus.request_seed(ctx.seed, _WARM - k))
    ctx.sync()
    ctx.part("warm_requests", t)


def request(ctx, seed: int) -> List[str]:
    """One request: the strings of ``sample_prior`` with a generator seeded ``seed``."""
    from molvax_torch.data.charset import Charset
    from molvax_torch.latent import sample_prior

    mix = ctx.mix
    with ctx.spans("sample_prior"):
        return sample_prior(ctx.state["model"], ctx.cfg.model, mix["rows"], torch.Generator().manual_seed(seed),
                            charset=Charset(), greedy=mix["greedy"], temperature=mix["temperature"],
                            constrained=mix["constrained"], mesh=ctx.mesh)


def _graphs() -> Tuple[int, int]:
    """The program's counts of decode graphs captured and replayed."""
    from molvax_torch.latent import sample

    return sample.graph_captures, sample.graph_replays


def window(ctx, seconds: float, tw) -> dict:
    graphs = _graphs()
    rng = np.random.default_rng([ctx.seed, 0x5A])
    lat, n, i = [], 0, 0
    kept: Optional[Tuple[int, List[str]]] = None  # a uniform draw over the requests (reservoir)
    longest: Tuple[int, int, Optional[List[str]]] = (-1, -1, None)
    t0 = time.perf_counter()
    while not ctx.agreed(time.perf_counter() - t0 - tw.paused >= seconds):
        tw.before(i)
        a = time.perf_counter()
        strings = request(ctx, corpus.request_seed(ctx.seed, i))
        lat.append(time.perf_counter() - a)
        n += len(strings)
        tw.after(i, requests=1, smiles=len(strings))
        if rng.integers(0, i + 1) == 0:
            kept = (i, strings)
        size = sum(map(len, strings))
        if size > longest[1]:
            longest = (i, size, strings)
        i += 1
    elapsed = time.perf_counter() - t0 - tw.paused
    graphs = [b - a for a, b in zip(graphs, _graphs())]
    ctx.state["checked"] = [kept] + ([(longest[0], longest[2])] if longest[0] != kept[0] else [])
    return {
        "metrics": {"sample_smiles_per_s": n / elapsed,
                    "sample_p95_ms": 1e3 * (statistics.quantiles(lat, n=20, method="inclusive")[18]
                                            if len(lat) > 1 else lat[0])},
        "attempted": i,
        "failed": 0,
        "readings": {"latency_s": lat},
        "notes": {"latency_ms_p50_p90_p99_max": [1e3 * float(np.percentile(lat, q)) for q in (50, 90, 99, 100)],
                  "window_graph_captures_replays": graphs},
    }


def release(ctx) -> None:
    ctx.state.pop("model", None)


def _worst(ctx, q=None) -> float:
    p = weights.make(ctx.sizes, ctx.seed, ctx.device)
    return max(served.request_gap(p, ctx.sizes, corpus.request_seed(ctx.seed, i), strings, ctx.mix, ctx.device, q)
               for i, strings in ctx.state["checked"])


def check(ctx) -> List[Tuple[str, float, float]]:
    return [("logit_gap", _worst(ctx), float(ctx.cell["limits"]["logit_gap"]))]


def readings(ctx, control: bool) -> dict:
    """The check's number of the requests a short window kept, and with
    ``control`` the number that the reference in fp8 reads on them."""
    out = {"program": {"logit_gap": _worst(ctx)}}
    if control:
        out["control_fp8"] = {"logit_gap": _worst(ctx, ref.fp8)}
    return out
