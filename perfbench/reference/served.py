"""Served strings judged by the plain reference.

A sampling request is ``sample_prior(model, cfg, n, generator)`` with a
CPU generator seeded by the benchmark: it draws z ~ N(0, I) as
``torch.randn(n, latent_dim, generator=...)``, then the decode's 32-bit
noise seed as ``torch.randint(0, 2**32, (), generator=...)``. The benchmark
replays these two draws from the same seed (``request_inputs``): they are
the inputs it hands the program, not anything the program made.

A stochastic decode picks at step t the first maximum of logits /
temperature + g, g the Gumbel(0, 1) noise of (global row, t, class) from
the counter hash (``noise.bits``, draw t): u = (top24(bits) + 1) / 2**24,
g = -log(-log(u)). A greedy decode has g = 0; u = 1 gives g = +inf, and that class is
then the one picked. A constrained decode takes
the maximum over the tokens that the valence automaton leaves legal.

What the program returns is a string a row, its pads dropped. A
constrained decode pads only after the string (the automaton allows
nothing else once a pad is out), so its tokens are the string's codes,
then pads. An unconstrained decode may emit a pad inside a string, so
``align`` finds where the pads were: a walk over the T steps that keeps,
per row, the ``beam`` placings whose widest gap so far is least, and ends
at the one whose widest gap is least. The gap of a token is how far its
reference score lies below the best (legal) reference score at its step.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import constrain as auto
from . import model as ref
from . import noise
from .charset import CHARS

_CODE = {c: i for i, c in enumerate(CHARS)}


def request_inputs(req_seed: int, n: int, latent_dim: int) -> Tuple[torch.Tensor, int]:
    """(z (n, latent_dim) on the CPU, the decode's noise seed) of a request
    whose generator is seeded with ``req_seed``."""
    gen = torch.Generator().manual_seed(req_seed)
    z = torch.randn(n, latent_dim, generator=gen)
    return z, int(torch.randint(0, 1 << 32, (), generator=gen))


def codes_of(strings: Sequence[str], T: int) -> Tuple[np.ndarray, np.ndarray]:
    """(codes (R, T) int64, the strings pad-filled at the end; lengths (R,))."""
    codes = np.zeros((len(strings), T), dtype=np.int64)
    for i, s in enumerate(strings):
        codes[i, :len(s)] = [_CODE[c] for c in s]
    return codes, np.array([len(s) for s in strings], dtype=np.int64)


def gumbel(seed: int, t: int, rows: torch.Tensor, classes: int) -> torch.Tensor:
    """(R, classes) fp32 Gumbel(0, 1) noise of step t for the global rows ``rows`` (R,)."""
    cols = torch.arange(classes, dtype=torch.int64, device=rows.device)[None, :]
    u = ((noise.bits(seed, t, rows[:, None], cols) >> 8).to(torch.float32) + 1.0) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def _gap(best: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """How far ``score`` lies below ``best``: 0 where it is the best, also
    where both are infinite (the noise of u = 1 is +inf)."""
    return torch.where(score >= best, torch.zeros_like(score), best - score)


def _scores(logits: torch.Tensor, t: int, rows: torch.Tensor, seed: int, greedy: bool, temperature: float):
    return logits if greedy else logits / temperature + gumbel(seed, t, rows, logits.shape[-1])


@torch.no_grad()
def align(p: ref.Params, sizes: dict, z: torch.Tensor, codes: torch.Tensor, lengths: torch.Tensor, seed: int,
          greedy: bool, temperature: float, beam: int = 4) -> torch.Tensor:
    """(R, T) tokens: each row's string (``codes`` (R, T), ``lengths``
    (R,)) with pads placed where the reference finds the widest gap least."""
    R, T, C = codes.shape[0], sizes["max_len"], sizes["charset_size"]
    dev = z.device
    with ref.strict_fp32():
        emb = ref.embed(p, z)
        row = torch.arange(R, device=dev)
        used = torch.zeros(R, dtype=torch.int64, device=dev)
        h = z.new_zeros(sizes["gru_layers"], R, sizes["gru_hidden"])
        prev = ref.start(p, sizes, R, dev)
        worst = z.new_zeros(R)
        toks = torch.zeros(R, T, dtype=torch.int64, device=dev)
        for t in range(T):
            logits, h = ref.decode_step(p, sizes, emb[row], h, prev)
            s = _scores(logits, t, row, seed, greedy, temperature)
            best = s.max(-1).values
            nxt = codes[row, used.clamp(max=T - 1)]
            # a pad where the rest of the string still fits; the next character where one is left
            can = torch.stack([T - t - 1 >= lengths[row] - used, used < lengths[row]])
            tok = torch.stack([torch.zeros_like(nxt), nxt])
            gap = _gap(best[None], s.gather(-1, tok.T).T)
            parent = torch.arange(row.numel(), device=dev).repeat(2)
            cand, tok, can = torch.maximum(worst[None], gap).reshape(-1), tok.reshape(-1), can.reshape(-1)
            # by row; in a row the allowed placings first, least widest gap first
            order = torch.argsort(cand, stable=True)
            order = order[torch.argsort((~can[order]).long(), stable=True)]
            order = order[torch.argsort(row[parent[order]], stable=True)]
            r_sorted = row[parent[order]]
            first = torch.searchsorted(r_sorted, r_sorted, right=False)
            keep = order[(torch.arange(order.numel(), device=dev) - first < beam) & can[order]]
            par, tok = parent[keep], tok[keep]
            row, worst, h = row[par], cand[keep], h[:, par]
            used = used[par] + (tok != 0)
            toks = toks[par]
            toks[:, t] = tok
            prev = torch.nn.functional.one_hot(tok, C).float()
        # the first hypothesis of each row is its least widest gap
        first = torch.searchsorted(row, torch.arange(R, device=dev))
        return toks[first]


@torch.no_grad()
def widest_gap(p: ref.Params, sizes: dict, z: torch.Tensor, tok: torch.Tensor, seed: int, greedy: bool,
               temperature: float, constrained: bool, q: Optional[ref.Rounding] = None) -> float:
    """The widest gap of the served tokens ``tok`` (R, T) below the
    reference's best (legal) score, each step fed the token before it; with
    ``q`` (the control's precision), the gap of the token that the
    reference in that precision puts first instead. A served token that the
    automaton finds illegal reads as infinite."""
    R, T, C = tok.shape[0], sizes["max_len"], sizes["charset_size"]
    rows = torch.arange(R, device=tok.device)
    logits = ref.served_logits(p, sizes, z, tok)
    control = None if q is None else ref.served_logits(p, sizes, z, tok, q)
    legal = torch.ones(R, T, C, dtype=torch.bool, device=tok.device)
    if constrained:
        tb, st = auto.build_tables(CHARS, tok.device), auto.init_state(R, T, tok.device)
        for t in range(T):
            legal[:, t] = auto.step_mask_rem(tb, st, T - 1 - t)
            st = auto.advance(tb, st, tok[:, t])
    worst = 0.0
    for t in range(T):
        s = _scores(logits[:, t], t, rows, seed, greedy, temperature)
        masked = s.masked_fill(~legal[:, t], -torch.inf)
        if control is None:
            chosen = tok[:, t]
        else:
            chosen = _scores(control[:, t], t, rows, seed, greedy, temperature).masked_fill(
                ~legal[:, t], -torch.inf).argmax(-1)
        if not bool(legal[:, t].gather(-1, chosen[:, None]).all()):
            return float("inf")
        worst = max(worst, float(_gap(masked.max(-1).values, s.gather(-1, chosen[:, None])[:, 0]).max()))
    return worst


def request_gap(p: ref.Params, sizes: dict, req_seed: int, strings: List[str], mix: dict, device,
                q: Optional[ref.Rounding] = None) -> float:
    """``widest_gap`` of one request's strings, its inputs replayed from
    ``req_seed`` and its pads placed as ``align`` finds them (after the
    string where the decode is constrained)."""
    T = sizes["max_len"]
    z, seed = request_inputs(req_seed, len(strings), sizes["latent_dim"])
    z = z.to(device)
    codes, lengths = (torch.from_numpy(a).to(device) for a in codes_of(strings, T))
    greedy, temperature = bool(mix["greedy"]), float(mix["temperature"])
    tok = codes if mix["constrained"] else align(p, sizes, z, codes, lengths, seed, greedy, temperature)
    return widest_gap(p, sizes, z, tok, seed, greedy, temperature, bool(mix["constrained"]), q)
