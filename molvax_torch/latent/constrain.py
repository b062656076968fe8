"""Valence-constrained decoding: the SMILES-validity automaton, plain torch.

Port of ``molvax/latent/constrain.py:96-845``. The automaton masks, at each
decode step, the tokens that the offline parser (``data/smiles_check.py``)
would reject, so every emitted string is chemically valid by construction.
The reference's module docstring sets out the state and the termination
guarantees; this module computes the same function with torch ops,
vectorized over the batch as the reference is, so the two agree exactly:
every mask, every code and every state field.

All integer state is int32 and every flag is bool, as in the reference:
reductions name ``dtype=torch.int32`` (``torch.sum`` of int32 or bool
returns int64), and floor division is written as such
(``rounding_mode="floor"``, the semantics of ``//`` in JAX).

Gathers keep the reference's semantics: an index outside ``[0, n)`` reads 0
(the reference's one-hot contractions), where plain indexing would fail or
wrap. The hand-written kernel (``kernels/csrc/automaton.cu``) computes the
same function on packed rows; ``validate_codes`` goes through its entry
points (``kernels.automaton.auto_mask`` / ``auto_advance``), which run this
plain version for tensors on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple, Union

import torch

from ..data.charset import Charset
from ..utils import resolve_device

DMAX = 16  # max branch nesting depth
NRING = 10  # ring-digit slots (digits 1..9 in slot 1..9; slot 0 unused)
RMAX = 6  # max simultaneously open rings during constrained generation

# Most-permissive bond budgets consistent with smiles_check._VALENCE:
# max(allowed valences), +1 for aromatic slack (see smiles_check module doc).
_BUDGET = {
    "B": 3, "C": 4, "N": 5, "O": 2, "P": 5, "S": 6, "F": 1, "I": 1,
    "c": 5, "n": 6, "o": 3, "s": 7, "b": 4, "p": 6,
}
_BOND = {"-": 1, "=": 2, "#": 3, "/": 1, "\\": 1, ":": 1, "$": 4}

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class Tables:
    """Static per-charset token-attribute tables, on the CPU
    (``kernels.automaton.pack_tables`` packs them for a device). Integer
    tables are int32, flags bool, each (C,)."""

    n: int
    atom_budget: torch.Tensor  # bond budget, -1 if not an atom token
    is_atom: torch.Tensor
    bond_order: torch.Tensor  # 0 if not a bond token
    digit_val: torch.Tensor  # 1..9 for ring digits, 0 otherwise
    is_l: torch.Tensor  # 'l' (Cl continuation)
    is_r: torch.Tensor  # 'r' (Br continuation)
    is_c_upper: torch.Tensor  # 'C' (chlorine prefix)
    is_b_upper: torch.Tensor  # 'B' (bromine prefix)
    is_open: torch.Tensor  # '('
    is_close: torch.Tensor  # ')'
    is_dot: torch.Tensor  # '.'
    is_lbr: torch.Tensor  # '['
    is_rbr: torch.Tensor  # ']'
    is_at: torch.Tensor  # '@'
    is_h: torch.Tensor  # 'H'
    is_plus: torch.Tensor  # '+'
    is_minus: torch.Tensor  # '-'
    is_pad: torch.Tensor  # pad (index 0)


class ConState(NamedTuple):
    """Vectorized automaton state (one row per batch element)."""

    val: torch.Tensor  # (B, A) int32 remaining bond budget per atom slot
    par: torch.Tensor  # (B, A) int32 tree parent per atom slot (-1 root)
    n_atoms: torch.Tensor  # (B,) int32
    prev: torch.Tensor  # (B,) int32 attachment atom index, -1 none
    pend: torch.Tensor  # (B,) int32 pending bond order, 0 none
    stack: torch.Tensor  # (B, DMAX) int32 saved attachment atoms
    sp: torch.Tensor  # (B,) int32 stack depth
    fresh: torch.Tensor  # (B,) bool '(' seen, no atom yet (branch-start rules)
    rpart: torch.Tensor  # (B, NRING) int32 ring-opening atom, -1 closed/unused
    rhint: torch.Tensor  # (B, NRING) int32 bond-order hint at open (0 none)
    rres: torch.Tensor  # (B, NRING) int32 order reserved at open (hint or 1)
    ppa: torch.Tensor  # (B, P) int32 closed ring-bond pair lo atom (-1 unused)
    ppb: torch.Tensor  # (B, P) int32 closed ring-bond pair hi atom (-1 unused)
    pn: torch.Tensor  # (B,) int32 number of pool entries written
    done: torch.Tensor  # (B,) bool pad emitted
    esc: torch.Tensor  # (B,) bool escape hatch fired (must stay False)
    hfix: torch.Tensor  # (B,) int32 halogen fixup: 0 none, 1 fresh 'C', 2 fresh 'B'
    horder: torch.Tensor  # (B,) int32 attach order consumed by the fixup atom
    b: torch.Tensor  # (B,) int32 bracket sub-state 0..8
    bbud: torch.Tensor  # (B,) int32 bracket symbol budget
    bh: torch.Tensor  # (B,) int32 bracket H count
    bchg: torch.Tensor  # (B,) int32 bracket |charge|
    bsign: torch.Tensor  # (B,) int32 bracket charge sign (0 unset)
    bsymc: torch.Tensor  # (B,) bool bracket symbol was 'C' ('l' may follow)
    bsymb: torch.Tensor  # (B,) bool bracket symbol was 'B' ('r' may follow)


@functools.lru_cache(maxsize=8)
def build_tables(charset: Charset) -> Tables:
    """The token tables of ``charset`` (CPU tensors; cached per charset)."""
    chars = charset.chars
    if "C" not in chars:
        raise ValueError("constrained decoding needs 'C' in the charset")

    def flag(pred):
        return torch.tensor([pred(c) for c in chars], dtype=torch.bool)

    budget = torch.tensor([_BUDGET.get(c, -1) for c in chars], dtype=I32)
    return Tables(
        n=len(chars),
        atom_budget=budget,
        is_atom=budget >= 0,
        bond_order=torch.tensor([_BOND.get(c, 0) for c in chars], dtype=I32),
        digit_val=torch.tensor(
            [int(c) if c.isdigit() and c != "0" else 0 for c in chars], dtype=I32
        ),
        is_l=flag(lambda c: c == "l"),
        is_r=flag(lambda c: c == "r"),
        is_c_upper=flag(lambda c: c == "C"),
        is_b_upper=flag(lambda c: c == "B"),
        is_open=flag(lambda c: c == "("),
        is_close=flag(lambda c: c == ")"),
        is_dot=flag(lambda c: c == "."),
        is_lbr=flag(lambda c: c == "["),
        is_rbr=flag(lambda c: c == "]"),
        is_at=flag(lambda c: c == "@"),
        is_h=flag(lambda c: c == "H"),
        is_plus=flag(lambda c: c == "+"),
        is_minus=flag(lambda c: c == "-"),
        is_pad=flag(lambda c: c == " "),
    )


def n_pairs(max_atoms: int) -> int:
    """Ring-pair pool capacity: each closure consumes two digit tokens, so
    max_atoms // 2 entries never overflow within a max_atoms-token row."""
    return max(1, max_atoms // 2)


def init_state(batch: int, max_atoms: int, device=None) -> ConState:
    """The automaton's start state of ``batch`` rows on ``device`` (None:
    the card; it raises where there is none)."""
    device = resolve_device(device)

    def z(*s):
        return torch.zeros(s if s else (batch,), dtype=I32, device=device)

    def f(*s):
        return torch.zeros(s if s else (batch,), dtype=torch.bool, device=device)

    def neg(*s):
        return torch.full(s if s else (batch,), -1, dtype=I32, device=device)

    npair = n_pairs(max_atoms)
    return ConState(
        val=z(batch, max_atoms), par=neg(batch, max_atoms),
        n_atoms=z(), prev=neg(), pend=z(),
        stack=neg(batch, DMAX), sp=z(), fresh=f(),
        rpart=neg(batch, NRING), rhint=z(batch, NRING), rres=z(batch, NRING),
        ppa=neg(batch, npair), ppb=neg(batch, npair), pn=z(),
        done=f(), esc=f(), hfix=z(), horder=z(),
        b=z(), bbud=z(), bh=z(), bchg=z(), bsign=z(), bsymc=f(), bsymb=f(),
    )


# -- helpers -------------------------------------------------------------------


def _ar(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=device)


def _isum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.sum(x, dim=dim, dtype=I32)


def _gather_val(val: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """val[i, idx[i]], 0 where idx is outside [0, A) (idx == -1 -> 0)."""
    oh = _ar(val.shape[1], val.device)[None, :] == idx[:, None]
    return _isum(torch.where(oh, val, 0), 1)


def _gather_rows(val: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """val[i, idx[i, j]] for idx (B, J), 0 where idx is outside [0, A)."""
    oh = idx[:, :, None] == _ar(val.shape[1], val.device)[None, None, :]
    return _isum(torch.where(oh, val[:, None, :], 0), 2)


def _anc_spare_max(val, stack, sp, drop_top: bool = False, adj_idx=None, adj=None):
    """Max remaining budget over stacked ancestor atoms (0 if none).
    ``adj_idx``/``adj`` subtract a candidate token's valence consumption
    from stacked copies of that atom (the post-token view)."""
    depth = _ar(DMAX, val.device)[None, :]
    limit = (sp - 1 if drop_top else sp)[:, None]
    live = depth < limit
    vals = _gather_rows(val, stack)
    if adj_idx is not None:
        vals = vals - torch.where(stack == adj_idx[:, None], adj[:, None], 0)
    return torch.amax(torch.where(live & (stack >= 0), vals, 0), dim=1)


def _dup_wrt(st: ConState, a: torch.Tensor) -> torch.Tensor:
    """(B, NRING) bool: closing a ring at atom ``a`` against each slot's
    partner would put a second bond on an already-bonded pair (the pair
    pool, or the chain bond a-parent / partner-parent). Rows of closed
    slots are garbage; callers mask with the open slots."""
    part = st.rpart
    lo = torch.minimum(part, a[:, None])
    hi = torch.maximum(part, a[:, None])
    pool = torch.any(
        (st.ppa[:, None, :] == lo[:, :, None]) & (st.ppb[:, None, :] == hi[:, :, None]),
        dim=2,
    )
    par_a = _gather_val(st.par, a)
    par_part = _gather_rows(st.par, part)
    chain = (part == par_a[:, None]) | (par_part == a[:, None])
    return pool | chain


def _hist(mask: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """(..., NRING) eligibility + per-slot costs in {1..4} -> (..., 4)
    count per cost."""
    cv = torch.arange(1, 5, dtype=I32, device=res.device)
    resm = torch.where(mask, res, 0)
    return _isum((resm[..., None] == cv).to(I32), -2)


def _take(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Greedy max number of closures affordable within budget ``w`` given
    the cost histogram ``h`` (..., 4), cheapest first. ``w // c`` floors
    (JAX's ``//``) for negative w."""
    m = torch.zeros_like(w)
    for i, c in enumerate((1, 2, 3, 4)):
        t = torch.minimum(
            torch.clamp(torch.div(w, c, rounding_mode="floor"), min=0), h[..., i]
        )
        m = m + t
        w = w - t * c
    return m


def _credit(h, ndir, v, r, partial_only: bool = False):
    """Closures achievable from budget ``v`` given the eligible-ring cost
    histogram ``h``; reserves 1 unit for the enabling atom unless every
    open ring closes directly."""
    k = torch.minimum(_take(h, v - 1), ndir)
    if not partial_only:
        kfull = _take(h, v)
        full_ok = (ndir >= r) & (kfull >= r)
        k = torch.where(full_ok, r, k)
    return torch.minimum(k, r)


# -- the mask ------------------------------------------------------------------


def step_mask(tb: Tables, st: ConState, t: int, max_len: int) -> torch.Tensor:
    """(B, C) bool mask of legal next tokens at step t."""
    return step_mask_rem(tb, st, max_len - t - 1)


def step_mask_rem(tb: Tables, st: ConState, rem: Union[int, torch.Tensor]) -> torch.Tensor:
    """(B, C) bool mask of legal next tokens; ``rem`` = tokens remaining
    AFTER this one."""
    dev = st.prev.device
    B = st.prev.shape[0]
    prev_ok = st.prev >= 0
    vprev = _gather_val(st.val, st.prev)
    anc = _anc_spare_max(st.val, st.stack, st.sp)
    open_d = st.rpart >= 0
    r = _isum(open_d, 1)
    o_att = torch.where(st.pend > 0, st.pend, prev_ok.to(I32))
    outside = (st.b == 0) & ~st.done

    # --- ring-closure credit machinery -----------------------------------
    res = torch.clamp(st.rres, min=1)
    dup_prev = _dup_wrt(st, st.prev)
    same_p = open_d[:, None, :] & (st.rpart[:, :, None] == st.rpart[:, None, :])
    lower = _ar(NRING, dev)[:, None] > _ar(NRING, dev)[None, :]
    first_p = ~torch.any(same_p & lower[None], dim=2)
    direct_prev = open_d & (st.rpart != st.prev[:, None]) & ~dup_prev
    cred_prev = direct_prev & first_p
    h_prev = _hist(cred_prev, res)
    ndir_prev = _isum(cred_prev, 1)
    new_ok = open_d & first_p & (st.rpart != st.prev[:, None])
    h_new = _hist(new_ok, res)
    ndir_new = _isum(new_ok, 1)
    n_att = _isum(open_d & (st.rpart == st.prev[:, None]), 1)

    def need_ok(k, sp=None, rr=None, extra=0):
        need = (st.sp if sp is None else sp) + 2 * (r if rr is None else rr) - k
        return (need + extra) <= rem

    def att_extra(k, rr, natt):
        return ((natt > 0) & (k >= rr - natt)).to(I32)

    # --- atom tokens (outside brackets) ----------------------------------
    g = tb.atom_budget[None, :]
    v_new = g - o_att[:, None]
    anc_att = _anc_spare_max(st.val, st.stack, st.sp, adj_idx=st.prev, adj=o_att)
    t_ok = ~((r[:, None] > 0) & (v_new == 0) & (anc_att[:, None] == 0))
    k_atom = _credit(h_new[:, None, :], ndir_new[:, None], v_new, r[:, None])
    ok_atom = (
        tb.is_atom[None, :] & outside[:, None]
        & (~prev_ok | (vprev >= o_att))[:, None]
        & (v_new >= 0) & t_ok
        & need_ok(k_atom, sp=st.sp[:, None], rr=r[:, None])
    )

    # --- 'l'/'r' halogen continuations (outside brackets) ----------------
    v_hal = 1 - st.horder
    t_hal = ~((r > 0) & (v_hal == 0) & (anc == 0))
    k_hal = _credit(h_prev, ndir_prev, v_hal, r)
    ok_hal_row = outside & (v_hal >= 0) & t_hal & need_ok(k_hal)
    ok_l = tb.is_l[None, :] & (ok_hal_row & (st.hfix == 1))[:, None]
    ok_r = tb.is_r[None, :] & (ok_hal_row & (st.hfix == 2))[:, None]

    # --- bond tokens ------------------------------------------------------
    freshx = st.fresh.to(I32)
    ok_bond_row = outside & prev_ok & (st.pend == 0) & need_ok(torch.zeros_like(r), extra=1 + freshx)
    ok_bond = (
        (tb.bond_order[None, :] > 0) & ok_bond_row[:, None]
        & (vprev[:, None] >= tb.bond_order[None, :])
    )

    # --- ring digits ------------------------------------------------------
    can_open = st.rpart == -1
    v_po = (vprev - o_att)[:, None]
    k_po = _credit(h_prev[:, None, :], ndir_prev[:, None], v_po.expand(B, NRING), r[:, None],
                   partial_only=True)
    ok_open_slot = (
        outside[:, None] & prev_ok[:, None] & can_open & ~st.fresh[:, None]
        & (vprev >= o_att)[:, None] & (r < RMAX)[:, None]
        & ((v_po >= 1) | (anc_att[:, None] >= 1))
        & need_ok(k_po, sp=st.sp[:, None], rr=(r + 1)[:, None],
                  extra=att_extra(k_po, (r + 1)[:, None], (n_att + 1)[:, None]))
    )

    hint = st.rhint
    pend_c = st.pend[:, None]
    o_fin = torch.where(pend_c > 0, pend_c, torch.clamp(hint, min=1))
    mismatch = (pend_c > 0) & (hint > 0) & (pend_c != hint)
    sur = o_fin - res
    vpart = _gather_rows(st.val, st.rpart)  # val at each slot's partner (0 when closed)
    eligible = direct_prev
    v_pc = vprev[:, None] - o_fin
    # ancestor spare after closing each digit j
    stk_vals = _gather_rows(st.val, st.stack)  # (B, DMAX)
    live_anc = (_ar(DMAX, dev)[None, :] < st.sp[:, None]) & (st.stack >= 0)
    vals_j = (
        stk_vals[:, None, :]
        - torch.where(st.stack[:, None, :] == st.prev[:, None, None], o_fin[:, :, None], 0)
        - torch.where(st.stack[:, None, :] == st.rpart[:, :, None], sur[:, :, None], 0)
    )  # (B, NRING, DMAX)
    anc_pc = torch.amax(torch.where(live_anc[:, None, :], vals_j, 0), dim=2)
    t_pc = ~(((r - 1)[:, None] > 0) & (v_pc == 0) & (anc_pc == 0))
    same_part = st.rpart[:, :, None] == st.rpart[:, None, :]
    direct_mat = direct_prev[:, None, :] & ~same_part & first_p[:, None, :]
    h_mat = _hist(direct_mat, res[:, None, :])
    ndir_mat = _isum(direct_mat, 2)
    k_pc = _credit(h_mat, ndir_mat, v_pc, (r - 1)[:, None])
    ok_close_slot = (
        outside[:, None] & prev_ok[:, None] & eligible & ~mismatch
        & (vprev[:, None] >= o_fin) & (vpart >= sur) & t_pc
        & ~st.fresh[:, None]
        & need_ok(k_pc, sp=st.sp[:, None], rr=(r - 1)[:, None],
                  extra=att_extra(k_pc, (r - 1)[:, None], n_att[:, None]))
    )
    slot_ok = ok_open_slot | ok_close_slot  # (B, NRING)
    dig = tb.digit_val
    # token -> its slot (digit value); non-digit tokens (0) read slot 0 and
    # are masked off by dig > 0
    ok_digit = (dig[None, :] > 0) & slot_ok[:, dig.long()]

    # --- '(' / ')' / '.' --------------------------------------------------
    k_cur = _credit(h_prev, ndir_prev, vprev, r)
    ok_open_br = (
        outside & prev_ok & ~st.fresh & (st.pend == 0) & (st.sp < DMAX) & (vprev >= 1)
        & need_ok(k_cur, sp=st.sp + 1, extra=1)
    )[:, None] & tb.is_open[None, :]

    popped = _gather_val(st.stack, torch.where(st.sp > 0, st.sp - 1, 0))
    vpop = _gather_val(st.val, torch.where(st.sp > 0, popped, -1))
    anc2 = _anc_spare_max(st.val, st.stack, st.sp, drop_top=True)
    dup_pop = _dup_wrt(st, popped)
    direct_pop = open_d & (st.rpart != popped[:, None]) & ~dup_pop & first_p
    k_pop = _credit(_hist(direct_pop, res), _isum(direct_pop, 1), vpop, r)
    n_att_pop = _isum(open_d & (st.rpart == popped[:, None]), 1)
    ok_close_br = (
        outside & (st.sp > 0) & (st.pend == 0) & ~st.fresh
        & ~((r > 0) & (vpop == 0) & (anc2 == 0))
        & need_ok(k_pop, sp=st.sp - 1, extra=att_extra(k_pop, r, n_att_pop))
    )[:, None] & tb.is_close[None, :]

    ok_dot = (
        outside & prev_ok & (st.pend == 0) & (st.sp == 0) & (r == 0)
        & (rem >= 1)
    )[:, None] & tb.is_dot[None, :]

    # --- bracket atoms ----------------------------------------------------
    ok_lbr = (
        outside & (~prev_ok | (vprev >= o_att)) & need_ok(k_cur, extra=2)
    )[:, None] & tb.is_lbr[None, :]

    inb = (st.b > 0) & ~st.done
    extra_v = ((r > 0) & (anc_att == 0)).to(I32)
    o_req = o_att + extra_v
    bud_eff = st.bbud + st.bchg - st.bh
    v_brk = bud_eff - o_att
    k_brk = _credit(h_new, ndir_new, v_brk, r)
    fit_rbr = need_ok(k_brk)
    fit_deco = need_ok(k_brk, extra=1)
    ok_sym = (
        tb.is_atom[None, :] & (inb & (st.b == 1))[:, None]
        & (g >= o_req[:, None])
        & need_ok(k_atom, sp=st.sp[:, None], rr=r[:, None], extra=1)
    )
    k_lr = _credit(h_new, ndir_new, 1 - o_att, r)
    fit_lr = need_ok(k_lr, extra=1)
    ok_bl = tb.is_l[None, :] & (inb & (st.b == 2) & st.bsymc & (1 >= o_req) & fit_lr)[:, None]
    ok_br_ = tb.is_r[None, :] & (inb & (st.b == 2) & st.bsymb & (1 >= o_req) & fit_lr)[:, None]
    ok_at = tb.is_at[None, :] & (inb & ((st.b == 2) | (st.b == 3)) & fit_deco)[:, None]
    k_h = _credit(h_new, ndir_new, bud_eff - 1 - o_att, r)
    ok_bh = tb.is_h[None, :] & (
        inb & (st.b >= 2) & (st.b <= 4) & (bud_eff - 1 >= o_req) & need_ok(k_h, extra=1)
    )[:, None]
    sign_new = inb & (st.b >= 2) & (st.b <= 6)
    sign_more = inb & (st.b == 7) & (st.bchg < 3)
    ok_plus = tb.is_plus[None, :] & ((sign_new | (sign_more & (st.bsign > 0))) & fit_deco)[:, None]
    ok_minus = tb.is_minus[None, :] & ((sign_new | (sign_more & (st.bsign < 0))) & fit_deco)[:, None]
    v_hd = st.bbud[:, None] + st.bchg[:, None] - dig[None, :] - o_att[:, None]
    k_hd = _credit(h_new[:, None, :], ndir_new[:, None], v_hd, r[:, None])
    ok_bdig_h = (
        (dig[None, :] > 0) & (inb & (st.b == 5))[:, None] & (v_hd >= extra_v[:, None])
        & need_ok(k_hd, sp=st.sp[:, None], rr=r[:, None], extra=1)
    )
    ok_bdig_c = (
        (dig[None, :] > 0) & (dig[None, :] <= 3)
        & (inb & (st.b == 7) & (st.bchg == 1) & fit_deco)[:, None]
    )
    ok_rbr = tb.is_rbr[None, :] & (inb & (st.b >= 2) & (bud_eff >= o_req) & fit_rbr)[:, None]

    # --- pad --------------------------------------------------------------
    closed = (
        (st.n_atoms >= 1) & (st.pend == 0) & (st.sp == 0) & (r == 0) & (st.b == 0) & prev_ok
    )
    ok_pad = (st.done | closed)[:, None] & tb.is_pad[None, :]

    mask = (
        ok_atom | ok_l | ok_r | ok_bond | ok_digit | ok_open_br | ok_close_br | ok_dot
        | ok_lbr | ok_sym | ok_bl | ok_br_ | ok_at | ok_bh | ok_plus | ok_minus
        | ok_bdig_h | ok_bdig_c | ok_rbr | ok_pad
    )
    d = st.done[:, None]
    mask = (d & tb.is_pad[None, :]) | (~d & mask)
    # defense in depth: a row with no legal token gets the pad escape hatch
    any_ok = torch.any(mask, dim=1)
    return mask | (~any_ok[:, None] & tb.is_pad[None, :])


# -- the transition ------------------------------------------------------------


def _pick(table: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """table[tok], 0 / False where tok is outside [0, C)."""
    ok = (tok >= 0) & (tok < table.shape[0])
    got = table[torch.where(ok, tok, 0).long()]
    return torch.where(ok, got, torch.zeros((), dtype=table.dtype, device=table.device))


def advance(tb: Tables, st: ConState, tok: torch.Tensor) -> ConState:
    """Apply one emitted token (B,) to the automaton state."""
    dev = st.val.device
    A = st.val.shape[1]
    g_tok = _pick(tb.atom_budget, tok)
    is_atom = _pick(tb.is_atom, tok)
    bond_o = _pick(tb.bond_order, tok)
    dig = _pick(tb.digit_val, tok)
    t_l, t_r = _pick(tb.is_l, tok), _pick(tb.is_r, tok)
    t_cu, t_bu = _pick(tb.is_c_upper, tok), _pick(tb.is_b_upper, tok)
    t_open, t_close = _pick(tb.is_open, tok), _pick(tb.is_close, tok)
    t_dot, t_lbr, t_rbr = _pick(tb.is_dot, tok), _pick(tb.is_lbr, tok), _pick(tb.is_rbr, tok)
    t_at, t_h = _pick(tb.is_at, tok), _pick(tb.is_h, tok)
    t_plus, t_minus = _pick(tb.is_plus, tok), _pick(tb.is_minus, tok)
    is_pad = _pick(tb.is_pad, tok)
    outside = (st.b == 0) & ~st.done
    prev_ok = st.prev >= 0
    o_att = torch.where(st.pend > 0, st.pend, prev_ok.to(I32))

    ia = _ar(A, dev)[None, :]
    oh_prev = (ia == st.prev[:, None]) & prev_ok[:, None]
    oh_new = ia == st.n_atoms[:, None]

    def put(cond, v):
        """(B,) value where cond, else 0, as a (B, 1) column."""
        return torch.where(cond, v, 0)[:, None]

    # --- atom emission (outside bracket) ---------------------------------
    do_atom = outside & is_atom
    val = st.val - put(do_atom, o_att) * oh_prev
    val = val + put(do_atom, g_tok - o_att) * oh_new
    par = torch.where((do_atom & prev_ok)[:, None] & oh_new, st.prev[:, None], st.par)
    n_atoms = st.n_atoms + do_atom.to(I32)
    prev = torch.where(do_atom, st.n_atoms, st.prev)
    pend = torch.where(do_atom, 0, st.pend)
    fresh = st.fresh & ~do_atom
    hfix = torch.where(do_atom & t_cu, 1, torch.where(do_atom & t_bu, 2, 0)).to(I32)
    horder = torch.where(do_atom, o_att, 0)

    # --- halogen fixup ('l'/'r' outside bracket) -------------------------
    do_hal = outside & (t_l | t_r) & (st.hfix > 0)
    oh_prev2 = ia == prev[:, None]
    cur_pv = _gather_val(val, torch.clamp(prev, 0, A - 1))
    val = val + put(do_hal, (1 - st.horder) - cur_pv) * oh_prev2

    # --- bond -------------------------------------------------------------
    do_bond = outside & (bond_o > 0) & ~do_hal
    pend = torch.where(do_bond, bond_o, pend)

    # --- ring digit -------------------------------------------------------
    do_dig = outside & (dig > 0)
    slot = torch.where(do_dig, dig, 0)
    i_ring = _ar(NRING, dev)[None, :]
    oh_sl = i_ring == slot[:, None]
    oh_slot = oh_sl & do_dig[:, None]
    slot_part = _isum(torch.where(oh_sl, st.rpart, 0), 1)
    is_close = do_dig & (slot_part >= 0)
    is_openr = do_dig & ~is_close
    res_o = torch.clamp(st.pend, min=1)
    wr_open = oh_slot & is_openr[:, None]
    rpart = torch.where(wr_open, st.prev[:, None], st.rpart)
    rhint = torch.where(wr_open, st.pend[:, None], st.rhint)
    rres = torch.where(wr_open, res_o[:, None], st.rres)
    val = val - put(is_openr, res_o) * oh_prev
    slot_hint = _isum(torch.where(oh_sl, st.rhint, 0), 1)
    slot_res = torch.clamp(_isum(torch.where(oh_sl, st.rres, 0), 1), min=1)
    o_fin = torch.where(st.pend > 0, st.pend, torch.clamp(slot_hint, min=1))
    sur = o_fin - slot_res
    val = val - put(is_close, o_fin) * oh_prev
    oh_part = ia == slot_part[:, None]
    val = val - put(is_close, sur) * oh_part
    lo = torch.minimum(st.prev, slot_part)
    hi = torch.maximum(st.prev, slot_part)
    oh_pn = _ar(st.ppa.shape[1], dev)[None, :] == st.pn[:, None]
    wr_pool = oh_pn & is_close[:, None]
    ppa = torch.where(wr_pool, lo[:, None], st.ppa)
    ppb = torch.where(wr_pool, hi[:, None], st.ppb)
    pn = st.pn + is_close.to(I32)
    rpart = torch.where(oh_slot & is_close[:, None], -1, rpart)
    pend = torch.where(do_dig, 0, pend)

    # --- '(' / ')' / '.' --------------------------------------------------
    i_d = _ar(DMAX, dev)[None, :]
    do_open = outside & t_open
    stack = torch.where((i_d == st.sp[:, None]) & do_open[:, None], st.prev[:, None], st.stack)
    sp = st.sp + do_open.to(I32)
    fresh = fresh | do_open

    do_close = outside & t_close
    oh_top = i_d == torch.clamp(st.sp - 1, 0, DMAX - 1)[:, None]
    top = _isum(torch.where(oh_top, st.stack, 0), 1)
    prev = torch.where(do_close, top, prev)
    sp = torch.where(do_close, st.sp - 1, sp)
    fresh = fresh & ~do_close

    do_dot = outside & t_dot
    prev = torch.where(do_dot, -1, prev)

    # --- bracket machine --------------------------------------------------
    do_lbr = outside & t_lbr
    b = torch.where(do_lbr, 1, st.b)
    inb = (st.b > 0) & ~st.done
    do_sym = inb & (st.b == 1) & is_atom
    b = torch.where(do_sym, 2, b)
    bbud = torch.where(do_sym, g_tok, st.bbud)
    bsymc = (do_sym & t_cu) | (~do_sym & st.bsymc)
    bsymb = (do_sym & t_bu) | (~do_sym & st.bsymb)
    do_bhal = inb & (st.b == 2) & ((t_l & st.bsymc) | (t_r & st.bsymb))
    bbud = torch.where(do_bhal, 1, bbud)
    bsymc = bsymc & ~do_bhal
    bsymb = bsymb & ~do_bhal
    do_at = inb & t_at
    b = torch.where(do_at & (st.b == 2), 3, torch.where(do_at & (st.b == 3), 4, b))
    do_bh = inb & t_h
    b = torch.where(do_bh, 5, b)
    bh = torch.where(do_bh, 1, st.bh)
    do_bhd = inb & (st.b == 5) & (dig > 0)
    b = torch.where(do_bhd, 6, b)
    bh = torch.where(do_bhd, dig, bh)
    do_sign = inb & (t_plus | t_minus)
    new_sign = torch.where(t_plus, 1, -1).to(I32)
    first_sign = do_sign & (st.b != 7)
    more_sign = do_sign & (st.b == 7)
    b = torch.where(do_sign, 7, b)
    bchg = torch.where(first_sign, 1, st.bchg + more_sign.to(I32))
    bsign = torch.where(first_sign, new_sign, st.bsign)
    do_bcd = inb & (st.b == 7) & (dig > 0)
    b = torch.where(do_bcd, 8, b)
    bchg = torch.where(do_bcd, dig, bchg)
    do_rbr = inb & t_rbr & (st.b >= 2)
    bud_eff = torch.clamp(st.bbud + st.bchg - st.bh, min=0)
    val = val - put(do_rbr, o_att) * oh_prev
    val = val + put(do_rbr, bud_eff - o_att) * oh_new
    par = torch.where((do_rbr & (st.prev >= 0))[:, None] & oh_new, st.prev[:, None], par)
    n_atoms = n_atoms + do_rbr.to(I32)
    prev = torch.where(do_rbr, st.n_atoms, prev)
    pend = torch.where(do_rbr, 0, pend)
    fresh = fresh & ~do_rbr
    b = torch.where(do_rbr, 0, b)
    bh = torch.where(do_rbr, 0, bh)
    bchg = torch.where(do_rbr, 0, bchg)
    bsign = torch.where(do_rbr, 0, bsign)
    bbud = torch.where(do_rbr, 0, bbud)

    # --- pad / done -------------------------------------------------------
    closed = (
        (st.n_atoms >= 1) & (st.pend == 0) & (st.sp == 0)
        & (_isum(st.rpart >= 0, 1) == 0) & (st.b == 0) & (st.prev >= 0)
    )
    esc = st.esc | (is_pad & ~st.done & ~closed)
    done = st.done | is_pad

    # halogen fixup window closes after any non-'C'/'B'-atom token
    hfix = torch.where(do_atom, hfix, 0)
    horder = torch.where(do_atom, horder, 0)

    return ConState(
        val=val, par=par, n_atoms=n_atoms, prev=prev, pend=pend,
        stack=stack, sp=sp, fresh=fresh, rpart=rpart, rhint=rhint,
        rres=rres, ppa=ppa, ppb=ppb, pn=pn,
        done=done, esc=esc, hfix=hfix, horder=horder,
        b=b, bbud=bbud, bh=bh, bchg=bchg, bsign=bsign, bsymc=bsymc, bsymb=bsymb,
    )


def is_closed(st: ConState) -> torch.Tensor:
    """(B,) bool: the row accepts padding now (or has emitted it)."""
    return (
        (st.n_atoms >= 1) & (st.pend == 0) & (st.sp == 0)
        & (_isum(st.rpart >= 0, 1) == 0) & (st.b == 0)
        & (st.prev >= 0)  # trailing dot leaves prev == -1
    ) | st.done


def validate_codes(
    codes: torch.Tensor, charset: Charset, max_len: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the automaton over teacher token sequences (B, T) on their device.

    Returns (allowed (B, T) bool: token t was legal under the mask given the
    prefix; closed (B,) bool: the final state accepts padding and the
    escape hatch never fired). Each step goes through ``auto_mask`` and
    ``auto_advance`` (``kernels/automaton.py``): the kernel on CUDA, this
    module's plain version on the CPU."""
    from ..kernels.automaton import auto_advance, auto_mask, pack_tables, unpack_state, new_state

    tb = build_tables(charset)
    itab = pack_tables(tb).to(codes.device)
    B, T = codes.shape
    toks = codes.to(I32)
    state = new_state(B, max_len, codes.device)
    oks = []
    for t in range(T):
        m = auto_mask(itab, state, max_len - t - 1)
        oks.append(torch.gather(m, 1, toks[:, t : t + 1].long())[:, 0])
        auto_advance(itab, state, toks[:, t])
    stf = unpack_state(state)
    return torch.stack(oks, dim=1), is_closed(stf) & ~stf.esc
