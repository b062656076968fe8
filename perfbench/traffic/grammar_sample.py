"""Grammar sampling traffic: one client in a closed loop of prior-sampling
requests to a grammar configuration (the Grammar VAE).

A request is one call of the program's entry point,
``latent.sample_prior(model, cfg, n, generator, greedy=, temperature=,
with_codes=True)``, with a CPU generator seeded from the run's seed and
the request's index: the mix gives n, the mode and the temperature. It
returns the strings and, from the same copy to the host, the derivations
(rule codes) they came from. The next request is sent when the strings
are back; the rate is all the strings of the window over its wall time.

Set-up makes the weights from the seed (``reference.grammar.make_weights``)
and warms the mix's request shape with one request of a seed the window
never uses. The configuration file names the grammar and the dense
layers' activation; set-up refuses a program whose configuration differs.

The check, once the window has closed: a sample of the finished requests,
drawn from the seed, with the one whose strings are longest in it. For
each, the plain reference (fp32, TF32 off) replays the request's z and
noise seed from its generator's seed, computes its logits in row blocks,
and walks the served derivations with its own stack: ``logit_gap`` is the
widest gap by which a served rule's score (logit / temperature + the
Gumbel noise of its row, step and rule) lies below the reference's best
score over the rules that its stack leaves legal at that step (a served
rule outside them reads as infinite), and ``string_mismatch`` counts the
rows whose string is not the reference's derivation of the served rules.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import corpus
from ..reference import grammar as rg
from ..reference import model as ref
from ..reference.served import request_inputs

_WARM = 2**32 - 1  # a request index no window reaches


def sizes_of(ctx) -> dict:
    """The configuration's sizes with the keys the reference reads beside them."""
    return dict(ctx.sizes, grammar=ctx.conf["grammar"], dense_activation=ctx.conf["dense_activation"])


def setup(ctx) -> None:
    t = time.perf_counter()
    from molvax_torch.kernels import _build
    from molvax_torch.nn.vae import MolecularVAE

    model_cfg = ctx.cfg.model
    got = (getattr(model_cfg, "alphabet", "charset"), getattr(model_cfg, "dense_activation", "selu"))
    if got != (ctx.conf["grammar"], ctx.conf["dense_activation"]):
        raise ValueError(f"configuration {ctx.conf['name']}: the program decodes {got}, the file states "
                         f"{(ctx.conf['grammar'], ctx.conf['dense_activation'])}")
    t = ctx.part("import_program", t)
    if ctx.device.type == "cuda":
        _build.load()
    t = ctx.part("library", t)
    model = MolecularVAE(model_cfg, device=ctx.device)
    model.load_state_dict(rg.make_weights(sizes_of(ctx), ctx.seed, ctx.device))
    model.requires_grad_(False)
    ctx.sync()
    t = ctx.part("weights", t)
    ctx.state["model"] = model
    request(ctx, corpus.request_seed(ctx.seed, _WARM))
    ctx.sync()
    ctx.part("warm_request", t)


def request(ctx, seed: int) -> Tuple[List[str], torch.Tensor]:
    """One request: the strings and rule codes of ``sample_prior`` with a generator seeded ``seed``."""
    from molvax_torch.latent import sample_prior

    mix = ctx.mix
    with ctx.spans("sample_prior"):
        return sample_prior(ctx.state["model"], ctx.cfg.model, mix["rows"], torch.Generator().manual_seed(seed),
                            greedy=mix["greedy"], temperature=mix["temperature"], mesh=ctx.mesh, with_codes=True)


def window(ctx, seconds: float, tw) -> dict:
    rng = np.random.default_rng([ctx.seed, 0x5A])
    lat, n, i = [], 0, 0
    kept: Optional[tuple] = None  # a uniform draw over the requests (reservoir)
    longest: Tuple[int, int, Optional[tuple]] = (-1, -1, None)
    t0 = time.perf_counter()
    while not ctx.agreed(time.perf_counter() - t0 - tw.paused >= seconds):
        tw.before(i)
        a = time.perf_counter()
        strings, prods = request(ctx, corpus.request_seed(ctx.seed, i))
        lat.append(time.perf_counter() - a)
        n += len(strings)
        tw.after(i, requests=1, smiles=len(strings))
        if rng.integers(0, i + 1) == 0:
            kept = (i, strings, prods)
        size = sum(map(len, strings))
        if size > longest[1]:
            longest = (i, size, (i, strings, prods))
        i += 1
    elapsed = time.perf_counter() - t0 - tw.paused
    ctx.state["checked"] = [kept] + ([longest[2]] if longest[0] != kept[0] else [])
    return {
        "metrics": {"sample_smiles_per_s": n / elapsed},
        "attempted": i,
        "failed": 0,
        "readings": {"latency_s": lat},
        "notes": {"latency_ms_p50_p90_p99_max": [1e3 * float(np.percentile(lat, q)) for q in (50, 90, 99, 100)],
                  "complete_rows_last_request": sum(1 for s in strings if s)},
    }


def release(ctx) -> None:
    ctx.state.pop("model", None)


def numbers(ctx, q: Optional[ref.Rounding] = None) -> dict:
    """The check's numbers over the checked requests; with ``q`` the gap of
    the reference in that precision put in the program's place."""
    s, mix, dev = sizes_of(ctx), ctx.mix, ctx.device
    p = rg.make_weights(s, ctx.seed, dev)
    gap, mismatch = 0.0, 0
    for i, strings, prods in ctx.state["checked"]:
        z, seed = request_inputs(corpus.request_seed(ctx.seed, i), len(strings), s["latent_dim"])
        z = z.to(dev)
        logits = rg.served_logits(p, s, z)
        control = None if q is None else rg.served_logits(p, s, z, q)
        gap = max(gap, rg.served_gap(logits, prods, seed, bool(mix["greedy"]), float(mix["temperature"]), control))
        mismatch += sum(rg.GRAMMAR.derive(row) != got for row, got in zip(prods.tolist(), strings))
        del logits, control
    return {"logit_gap": gap, "string_mismatch": float(mismatch)}


def check(ctx) -> List[Tuple[str, float, float]]:
    got = numbers(ctx)
    return [(k, got[k], float(limit)) for k, limit in ctx.cell["limits"].items()]


def readings(ctx, control: bool) -> dict:
    """The check's numbers of the requests a short window kept, and with
    ``control`` the gap that the reference in fp8 reads on them."""
    out = {"program": numbers(ctx)}
    if control:
        out["control_fp8"] = {"logit_gap": numbers(ctx, ref.fp8)["logit_gap"]}
    return out
