"""The plain reference of the Grammar VAE (``gvae_zinc``), in fp32.

Plain PyTorch, written from the paper (Kusner, Paige and Hernandez-Lobato,
ICML 2017, arXiv:1703.01925) and its code (``models/model_zinc.py``,
``zinc_grammar.py``), importing nothing of the program:

  * the grammar: its own copy of the 76 rules of the ZINC grammar (``RULES``),
    the left-hand side of each rule, the (nonterminals x rules) masks, each
    rule's right-hand side, the terminals;
  * the encoder: the one-hot (B, T, 76) of the rule codes through VALID
    Conv1d layers along the T positions with ReLU, flattened channel-major,
    a dense layer with ReLU (``dense_activation``), the mean and
    log-variance heads;
  * the decoder: Dense(latent, ReLU) on z, repeated over the T steps,
    through the GRU stack (gates r|z|n, n = tanh(W_in x + b_in + r *
    (W_hn h + b_hn)): the program's reset-after cell, which Keras's GRU is
    not), a dense head over the rules;
  * the masked ELBO: at each step the logits masked to the rules of the
    nonterminal that the true rule expands, the cross-entropy of that
    softmax summed over the steps, plus the KL divergence from N(0, I),
    averaged over the batch (gradients by autograd);
  * the walk (``sample_walk``), the published ``_sample_using_masks``: per
    row and step, pop the nonterminal (``Nothing`` on an empty stack), take
    the first maximum of logits / temperature + Gumbel noise over its rules,
    push the rule's nonterminals in reverse; the noise is the program's
    counter hash, recomputed as ``served.gumbel`` does. A nonterminal with
    no rule (``class``) ends the row's derivation as incomplete: the padding
    rule from there on, and an empty string;
  * ``served_logits``: the logits of a request's z in row blocks, and
    ``served_gap``: how far a served derivation's scores lie below the
    reference's best legal score, step by step along the served rules.

Every product goes through ``q`` as in ``model.py`` (the identity, or
``model.fp8`` / ``model.bf16`` for the controls); the mean and
log-variance heads stay fp32. Parameter names are the program's state
dict's, so one dictionary of weights, made from the seed (``make_weights``),
is handed to both.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import model as ref
from .served import _gap, gumbel

Params = Dict[str, torch.Tensor]

RULES = """smiles -> chain
atom -> bracket_atom
atom -> aliphatic_organic
atom -> aromatic_organic
aliphatic_organic -> 'B'
aliphatic_organic -> 'C'
aliphatic_organic -> 'N'
aliphatic_organic -> 'O'
aliphatic_organic -> 'S'
aliphatic_organic -> 'P'
aliphatic_organic -> 'F'
aliphatic_organic -> 'I'
aliphatic_organic -> 'Cl'
aliphatic_organic -> 'Br'
aromatic_organic -> 'c'
aromatic_organic -> 'n'
aromatic_organic -> 'o'
aromatic_organic -> 's'
bracket_atom -> '[' BAI ']'
BAI -> isotope symbol BAC
BAI -> symbol BAC
BAI -> isotope symbol
BAI -> symbol
BAC -> chiral BAH
BAC -> BAH
BAC -> chiral
BAH -> hcount BACH
BAH -> BACH
BAH -> hcount
BACH -> charge class
BACH -> charge
BACH -> class
symbol -> aliphatic_organic
symbol -> aromatic_organic
isotope -> DIGIT
isotope -> DIGIT DIGIT
isotope -> DIGIT DIGIT DIGIT
DIGIT -> '1'
DIGIT -> '2'
DIGIT -> '3'
DIGIT -> '4'
DIGIT -> '5'
DIGIT -> '6'
DIGIT -> '7'
DIGIT -> '8'
chiral -> '@'
chiral -> '@@'
hcount -> 'H'
hcount -> 'H' DIGIT
charge -> '-'
charge -> '-' DIGIT
charge -> '-' DIGIT DIGIT
charge -> '+'
charge -> '+' DIGIT
charge -> '+' DIGIT DIGIT
bond -> '-'
bond -> '='
bond -> '#'
bond -> '/'
bond -> '\\'
ringbond -> DIGIT
ringbond -> bond DIGIT
branched_atom -> atom
branched_atom -> atom RB
branched_atom -> atom BB
branched_atom -> atom RB BB
RB -> RB ringbond
RB -> ringbond
BB -> BB branch
BB -> branch
branch -> '(' chain ')'
branch -> '(' bond chain ')'
chain -> branched_atom
chain -> chain branched_atom
chain -> chain bond branched_atom
Nothing -> None"""

_SALT = 0x3EED_0001  # weights.py's, so that a seed draws its weights the same way


class Grammar:
    """The tables of ``RULES``: ``lhs`` (R,), ``masks`` (NT, R) bool, each
    rule's right-hand side as symbols (a nonterminal index, or a terminal
    string), ``start``, ``nothing`` (the padding rule's nonterminal) and
    ``pad`` (the padding rule)."""

    def __init__(self, text: str = RULES):
        self.rules: List[Tuple[str, Tuple[str, ...]]] = []
        for line in text.splitlines():
            lhs, rhs = (part.strip() for part in line.split("->"))
            self.rules.append((lhs, tuple(s.replace("\\\\", "\\") for s in rhs.split() if s != "None")))
        nts: List[str] = []
        for lhs, _ in self.rules:
            if lhs not in nts:
                nts.append(lhs)
        for _, rhs in self.rules:
            nts += [s for s in rhs if not s.startswith("'") and s not in nts]
        self.nonterminals = tuple(nts)
        self.lhs = np.array([nts.index(lhs) for lhs, _ in self.rules])
        self.masks = np.zeros((len(nts), len(self.rules)), dtype=bool)
        self.masks[self.lhs, np.arange(len(self.rules))] = True
        self.rhs = [tuple(s[1:-1] if s.startswith("'") else nts.index(s) for s in rhs) for _, rhs in self.rules]
        self.start, self.pad = nts.index(self.rules[0][0]), len(self.rules) - 1
        self.nothing = int(self.lhs[self.pad])

    def derive(self, prods) -> str:
        """The string of a derivation, '' where it is incomplete (a rule that
        does not expand the leftmost nonterminal ends it so too)."""
        stack, out = [self.start], []
        for p in prods:
            while stack and isinstance(stack[-1], str):
                out.append(stack.pop())
            nt = stack.pop() if stack else self.nothing
            if self.lhs[p] != nt:
                return ""
            stack += list(self.rhs[p])[::-1]
        while stack and isinstance(stack[-1], str):
            out.append(stack.pop())
        return "" if stack else "".join(out)


GRAMMAR = Grammar()


# -- shapes and weights -----------------------------------------------------------


def param_shapes(sizes: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, init bound) of every parameter, uniform in +-1/sqrt(fan_in)
    (1/sqrt(H) for the GRU); the decoder's GRU takes the latent alone."""
    T, C, Lz, E, H = (sizes[k] for k in ("max_len", "charset_size", "latent_dim", "enc_hidden", "gru_hidden"))
    out, in_ch, length = [], C, T
    for i, (ch, k) in enumerate(zip(sizes["conv_channels"], sizes["conv_kernels"]), start=1):
        b = (in_ch * k) ** -0.5
        out += [(f"conv_{i}.weight", (ch, in_ch, k), b), (f"conv_{i}.bias", (ch,), b)]
        in_ch, length = ch, length - k + 1
    for name, (i, o) in (("linear_0", (in_ch * length, E)), ("linear_1", (E, Lz)), ("linear_2", (E, Lz)),
                         ("linear_3", (Lz, Lz))):
        out += [(f"{name}.weight", (o, i), i ** -0.5), (f"{name}.bias", (o,), i ** -0.5)]
    g = H ** -0.5
    for li in range(sizes["gru_layers"]):
        i = Lz if li == 0 else H
        out += [(f"gru.weight_ih_l{li}", (3 * H, i), g), (f"gru.weight_hh_l{li}", (3 * H, H), g),
                (f"gru.bias_ih_l{li}", (3 * H,), g), (f"gru.bias_hh_l{li}", (3 * H,), g)]
    return out + [("linear_4.weight", (C, H), H ** -0.5), ("linear_4.bias", (C,), H ** -0.5)]


def make_weights(sizes: dict, seed: int, device) -> Params:
    """Every parameter from ``seed`` in one draw on the device, as
    ``weights.make`` draws them."""
    shapes = param_shapes(sizes)
    u = torch.rand(sum(math.prod(s) for _, s, _ in shapes),
                   generator=torch.Generator(device=device).manual_seed((seed * 2 + 1) ^ _SALT), device=device)
    out, off = {}, 0
    for name, shape, bound in shapes:
        n = math.prod(shape)
        out[name] = u[off:off + n].view(shape).mul(2.0 * bound).sub_(bound)
        off += n
    return out


# -- forward ---------------------------------------------------------------------


def _act(sizes: dict):
    return F.relu if sizes["dense_activation"] == "relu" else F.selu


def encode(p: Params, sizes: dict, codes: torch.Tensor, q: ref.Rounding = ref.exact):
    """Rule codes (B, T) -> (mu, logvar)."""
    h = F.one_hot(codes.long(), sizes["charset_size"]).float().transpose(1, 2)
    for i in range(1, len(sizes["conv_channels"]) + 1):
        h = F.relu(F.conv1d(q(h), q(p[f"conv_{i}.weight"])) + p[f"conv_{i}.bias"][None, :, None])
    h = _act(sizes)(ref._dense(h.reshape(h.shape[0], -1), p, "linear_0", q))
    return ref._dense(h, p, "linear_1", ref.exact), ref._dense(h, p, "linear_2", ref.exact)


def decode(p: Params, sizes: dict, z: torch.Tensor, q: ref.Rounding = ref.exact) -> torch.Tensor:
    """z (B, Lz) -> logits (B, T, R): the embedding repeated over the steps."""
    B, T, H = z.shape[0], sizes["max_len"], sizes["gru_hidden"]
    emb = _act(sizes)(ref._dense(z, p, "linear_3", q))
    x = emb[None].expand(T, B, emb.shape[1])
    for li in range(sizes["gru_layers"]):
        gi = q(x) @ q(p[f"gru.weight_ih_l{li}"]).T + p[f"gru.bias_ih_l{li}"]
        w_hh, b_hh = q(p[f"gru.weight_hh_l{li}"]).T, p[f"gru.bias_hh_l{li}"]
        h, outs = z.new_zeros(B, H), []
        for t in range(T):
            gh = q(h) @ w_hh + b_hh
            r = torch.sigmoid(gi[t, :, :H] + gh[:, :H])
            u = torch.sigmoid(gi[t, :, H:2 * H] + gh[:, H:2 * H])
            n = torch.tanh(gi[t, :, 2 * H:] + r * gh[:, 2 * H:])
            h = (1.0 - u) * n + u * h
            outs.append(h)
        x = torch.stack(outs)
    return ref._dense(x.transpose(0, 1), p, "linear_4", q)


def masked(logits: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """The logits with every rule outside the true rule's nonterminal at -inf."""
    masks = torch.from_numpy(GRAMMAR.masks).to(logits.device)
    lhs = torch.from_numpy(GRAMMAR.lhs).to(logits.device)
    return logits.masked_fill(~masks[lhs[codes.long()]], float("-inf"))


def loss_of(p: Params, sizes: dict, codes: torch.Tensor, eps: torch.Tensor, beta: float = 1.0,
            q: ref.Rounding = ref.exact) -> torch.Tensor:
    """The batch's mean of the masked cross-entropy summed over the steps +
    beta * KL; ``eps`` the (B, Lz) reparameterisation noise."""
    mu, logvar = encode(p, sizes, codes, q)
    z = mu + sizes["eps_scale"] * torch.exp(0.5 * logvar) * eps
    logp = torch.log_softmax(masked(decode(p, sizes, z, q), codes), dim=-1)
    recon = -torch.gather(logp, -1, codes.long()[..., None])[..., 0].sum(-1)
    kl = -0.5 * torch.sum(1.0 + logvar - mu * mu - torch.exp(logvar), dim=-1)
    return (recon + beta * kl).mean()


@torch.no_grad()
def served_logits(p: Params, sizes: dict, z: torch.Tensor, q: ref.Rounding = ref.exact,
                  block: int = 1024) -> torch.Tensor:
    """Logits (B, T, R) of z, in blocks of ``block`` rows, fp32 with TF32 off."""
    with ref.strict_fp32():
        return torch.cat([decode(p, sizes, z[i:i + block], q) for i in range(0, z.shape[0], block)])


# -- the walk --------------------------------------------------------------------


class _Stacks:
    """Every row's stack as one array: a nonterminal j as j, a terminal as
    NT + its index in ``GRAMMAR.terminals`` (the strings come from
    ``derive``; the walk only drops the terminals it meets)."""

    def __init__(self, rows: int, steps: int):
        nt = len(GRAMMAR.nonterminals)
        terms = sorted({x for rhs in GRAMMAR.rhs for x in rhs if isinstance(x, str)})
        self.rhs = np.full((len(GRAMMAR.rhs), 4), -1, dtype=np.int64)
        for r, rhs in enumerate(GRAMMAR.rhs):
            for k, x in enumerate(rhs):
                self.rhs[r, k] = nt + terms.index(x) if isinstance(x, str) else x
        self.nt, self.rows = nt, np.arange(rows)
        self.s = np.full((rows, 3 * steps + 2), -1, dtype=np.int64)
        self.s[:, 0] = GRAMMAR.start
        self.sp = np.ones(rows, dtype=np.int64)

    def pop(self) -> np.ndarray:
        """Each row's next nonterminal (``Nothing`` on an empty stack)."""
        while True:
            term = (self.sp > 0) & (self.s[self.rows, np.maximum(self.sp - 1, 0)] >= self.nt)
            if not term.any():
                break
            self.sp -= term
        has = self.sp > 0
        out = np.where(has, self.s[self.rows, np.maximum(self.sp - 1, 0)], GRAMMAR.nothing)
        self.sp -= has
        return out

    def push(self, rules: np.ndarray, nts: np.ndarray) -> None:
        none = ~GRAMMAR.masks[nts].any(-1)  # no rule: the derivation ends here
        self.sp[none] = 0
        for k in range(3, -1, -1):
            sym = self.rhs[rules, k]
            put = (sym >= 0) & ~none
            self.s[self.rows[put], self.sp[put]] = sym[put]
            self.sp += put


def _scores(logits_t: torch.Tensor, t: int, rows: torch.Tensor, seed: int, greedy: bool, temperature: float):
    return logits_t if greedy else logits_t / temperature + gumbel(seed, t, rows, logits_t.shape[-1])


@torch.no_grad()
def sample_walk(logits: torch.Tensor, seed: int, greedy: bool, temperature: float,
                row_base: int = 0) -> Tuple[torch.Tensor, List[str]]:
    """The published walk over logits (B, T, R): (rule codes (B, T), strings)."""
    B, T, _ = logits.shape
    rows = torch.arange(row_base, row_base + B, device=logits.device)
    masks = torch.from_numpy(GRAMMAR.masks).to(logits.device)
    st, out = _Stacks(B, T), torch.empty(B, T, dtype=torch.int64)
    for t in range(T):
        nts = st.pop()
        legal = masks[torch.from_numpy(nts).to(logits.device)]
        s = _scores(logits[:, t], t, rows, seed, greedy, temperature).masked_fill(~legal, float("-inf"))
        rule = s.argmax(-1).cpu().numpy()
        rule = np.where(legal.any(-1).cpu().numpy(), rule, GRAMMAR.pad)
        st.push(rule, nts)
        out[:, t] = torch.from_numpy(rule)
    return out, [GRAMMAR.derive(row) for row in out.tolist()]


@torch.no_grad()
def served_gap(logits: torch.Tensor, prods: torch.Tensor, seed: int, greedy: bool, temperature: float,
               control: Optional[torch.Tensor] = None, row_base: int = 0) -> float:
    """The widest gap of the served rules ``prods`` (B, T) below the
    reference's best legal score at each step, the stack walked along the
    served rules; a served rule that the stack makes illegal reads as
    infinite. With ``control`` (logits of the control's precision), the
    gap of the rule that the control puts first instead. ``row_base``: the
    global index of the first row, which keys its noise."""
    B, T, _ = logits.shape
    dev = logits.device
    rows = torch.arange(row_base, row_base + B, device=dev)
    masks = torch.from_numpy(GRAMMAR.masks).to(dev)
    st, worst = _Stacks(B, T), 0.0
    served = prods.to(dev).long()
    for t in range(T):
        nts = st.pop()
        nts_d = torch.from_numpy(nts).to(dev)
        legal = masks[nts_d]
        none = ~legal.any(-1)
        chosen = served[:, t]
        if control is not None:
            chosen = _scores(control[:, t], t, rows, seed, greedy, temperature).masked_fill(
                ~legal, float("-inf")).argmax(-1)
            chosen = torch.where(none, GRAMMAR.pad, chosen)
        # a nonterminal without a rule takes the padding rule, which it makes legal
        ok = torch.where(none, chosen == GRAMMAR.pad, legal.gather(-1, chosen[:, None])[:, 0])
        if not bool(ok.all()):
            return float("inf")
        s = _scores(logits[:, t], t, rows, seed, greedy, temperature)
        best = s.masked_fill(~legal, float("-inf")).max(-1).values
        gap = torch.where(none, torch.zeros_like(best), _gap(best, s.gather(-1, chosen[:, None])[:, 0]))
        worst = max(worst, float(gap.max()))
        st.push(served[:, t].cpu().numpy(), nts)
    return worst
