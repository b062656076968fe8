"""The Grammar VAE's pushdown walk: wrapper, plain version, output layout.

A grammar config decodes in one non-autoregressive pass of logits (B, T, R)
over the R rules; the walk turns them into derivations, as the published
``_sample_using_masks`` does, row by row over the T steps:

  1. emit the terminals on top of the row's stack (in order: they are the
     SMILES' characters), then pop the top nonterminal, or ``Nothing``
     where the stack is empty;
  2. score the step's rules: the logits, or logits / temperature + the
     Gumbel noise of (seed, step, global row, rule) from the port's counter
     hash (``kernels.generate.noise_bits``, the same bits);
  3. take the first maximum over the nonterminal's rules (where no legal
     score equals the maximum, a NaN, the nonterminal's first rule);
  4. push the rule's right-hand side in reverse, terminals and
     nonterminals alike.

After the last step the terminals left on top are emitted; a nonterminal
left on the stack makes the derivation incomplete, and so does popping a
nonterminal that has no rule (``class``): that step and every later one
take the padding rule. An incomplete row's terminals are all 0, its string
empty.

Output: one (B, 3T) uint8 tensor, each row its T rule codes, then up to 2T
terminal codes (1 .. 35, 0 after the last; no rule emits more than two
terminals), so that one copy brings both to the host. The stack holds at
most 1 + 3T symbols (a step pops one and pushes at most four).

``walk`` launches the kernel ``csrc/grammar_walk.cu`` for CUDA tensors (one
launch per call, counted in ``launches``) and runs ``walk_ref``, the plain
version, for CPU tensors; ``walk_ref`` runs on any device and is what the
kernel is held to, bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Union

import torch

from . import _build
from .generate import gumbel_noise

# kernel launches made by ``walk`` (not by the plain version)
launches = 0

MAX_RULES_PER_SYMBOL = 32  # a warp's lanes: csrc/grammar_walk.cu takes a rule a lane


def walk_ref(logits: torch.Tensor, grammar, seed: Union[int, torch.Tensor], greedy: bool, temperature: float,
             row_base: int = 0) -> torch.Tensor:
    """The walk in plain torch ops on ``logits``' device: logits (B, T, R)
    fp32 -> (B, 3T) uint8 (module docstring)."""
    B, T, R = logits.shape
    dev = logits.device
    NT = len(grammar.nonterminals)
    tab = grammar.tables(dev)["walk"].long()
    lo_of, hi_of, rhs = tab[:NT], tab[NT:2 * NT], tab[2 * NT:].view(R, -1)
    rows = torch.arange(B, device=dev)
    dump = 1 + 3 * T  # the stack's depth; a last column the pushes of no row reach
    stack = torch.full((B, dump + 1), -1, dtype=torch.int64, device=dev)
    stack[:, 0] = grammar.start
    sp = torch.ones(B, dtype=torch.int64, device=dev)
    W = 2 * T
    terms = torch.zeros(B, W + 1, dtype=torch.int64, device=dev)  # a last column the writes of no row reach
    nterm = torch.zeros(B, dtype=torch.int64, device=dev)
    incomplete = torch.zeros(B, dtype=torch.bool, device=dev)
    prods = torch.empty(B, T, dtype=torch.int64, device=dev)
    r_idx = torch.arange(R, device=dev)[None, :]

    def emit_terminals() -> None:
        nonlocal sp, nterm
        while True:
            top = stack[rows, (sp - 1).clamp(min=0)]
            is_t = (sp > 0) & (top >= NT)
            if not bool(is_t.any()):
                return
            terms[rows, torch.where(is_t, nterm, W)] = torch.where(is_t, top - NT + 1, 0)
            nterm = nterm + is_t.long()
            sp = sp - is_t.long()

    for t in range(T):
        emit_terminals()
        has = sp > 0
        nt = torch.where(has, stack[rows, (sp - 1).clamp(min=0)], grammar.nothing)
        sp = sp - has.long()
        lo, hi = lo_of[nt], hi_of[nt]
        none = lo >= hi
        incomplete |= none
        sp = torch.where(none, 0, sp)
        scores = logits[:, t].float()
        if not greedy:
            scores = scores / temperature + gumbel_noise(seed, t, B, R, dev, row_base)
        legal = (r_idx >= lo[:, None]) & (r_idx < hi[:, None])
        sc = torch.where(legal, scores, float("-inf"))
        mx = sc.amax(dim=1, keepdim=True)
        code = torch.where((sc == mx) & legal, r_idx, R).amin(dim=1)
        code = torch.where(code >= R, lo, code)
        code = torch.where(none, grammar.pad_rule, code)
        prods[:, t] = code
        for k in reversed(range(rhs.shape[1])):
            s = rhs[code, k]
            push = (s >= 0) & ~none
            stack[rows, torch.where(push, sp, dump)] = torch.where(push, s, -1)
            sp = sp + push.long()
    emit_terminals()
    incomplete |= sp > 0
    terms = terms[:, :W].masked_fill(incomplete[:, None], 0)
    return torch.cat([prods, terms], dim=1).to(torch.uint8)


def walk(logits: torch.Tensor, grammar, seed: int, greedy: bool, temperature: float,
         row_base: int = 0) -> torch.Tensor:
    """The walk over ``logits`` (B, T, R) fp32: (B, 3T) uint8 rule and
    terminal codes. On CUDA one launch of ``molvax_grammar_walk``; on the
    CPU ``walk_ref``."""
    global launches
    if logits.dim() != 3 or logits.dtype != torch.float32:
        raise ValueError(f"grammar walk: logits must be (B, T, R) fp32, got {logits.dtype} {tuple(logits.shape)}")
    B, T, R = logits.shape
    if R != grammar.size:
        raise ValueError(f"grammar walk: {R} logits a step for a grammar of {grammar.size} rules")
    if logits.device.type == "cpu":
        return walk_ref(logits, grammar, seed, greedy, temperature, row_base)
    if logits.device.type != "cuda":
        raise ValueError(f"grammar walk: unsupported device {logits.device}")
    lo, hi = grammar.rule_ranges
    if int((hi - lo).max()) > MAX_RULES_PER_SYMBOL:
        raise ValueError(f"grammar walk: the kernel takes at most {MAX_RULES_PER_SYMBOL} rules a nonterminal")
    logits = logits.contiguous()
    out = torch.empty(B, 3 * T, dtype=torch.uint8, device=logits.device)
    if B == 0:
        return out
    fn = _build.function("molvax_grammar_walk", [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                         + [ctypes.c_int] * 4 + [ctypes.c_uint32, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                                 ctypes.c_void_p, ctypes.c_void_p])
    err = fn(logits.data_ptr(), B, T, R, grammar.tables(logits.device)["walk"].data_ptr(), len(grammar.nonterminals),
             grammar.start, grammar.nothing, grammar.pad_rule, seed & 0xFFFFFFFF, int(greedy), float(temperature),
             int(row_base), out.data_ptr(), torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check(err, "grammar walk")
    launches += 1
    return out
