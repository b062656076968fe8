"""The SMILES valence automaton, in plain torch: the reference's legal tokens.

Transcribed from the JAX package's automaton (``molvax/latent/
constrain.py``: ``Tables``, ``ConState``, ``build_tables``,
``init_state``, ``step_mask_rem``, ``advance``), the owner of the rules,
expression for expression, with integers held as int64. It imports
nothing of either package; ``perfbench/tests/test_pb_reference.py`` holds
it against the JAX package on the same token streams.

Per row it tracks each atom's remaining bond budget and tree parent, the
attachment atom and pending bond order, the branch stack, the open ring
digits and the closed ring pairs, the two-character halogens, a bracket
atom's sub-state, and ``done`` (a pad was emitted: only pads follow). The
mask admits a token only if the string can still be closed within the
tokens that remain. The constrained cell's check runs it over the served
tokens, and a served token outside its mask fails the check.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Union

import torch

DMAX = 16  # max branch nesting depth
NRING = 10  # ring-digit slots (digits 1..9 in slot 1..9; slot 0 unused)
RMAX = 6  # max simultaneously open rings during constrained generation

# most permissive bond budgets: the largest allowed valence, +1 aromatic slack
_BUDGET = {
    "B": 3, "C": 4, "N": 5, "O": 2, "P": 5, "S": 6, "F": 1, "I": 1,
    "c": 5, "n": 6, "o": 3, "s": 7, "b": 4, "p": 6,
}
_BOND = {"-": 1, "=": 2, "#": 3, "/": 1, "\\": 1, ":": 1, "$": 4}

Num = Union[int, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Tables:
    """Per-character attribute tables (C,) on one device."""

    n: int
    atom_budget: torch.Tensor  # bond budget, -1 if not an atom
    is_atom: torch.Tensor
    bond_order: torch.Tensor  # 0 if not a bond
    digit_val: torch.Tensor  # 1..9 for ring digits, 0 otherwise
    is_l: torch.Tensor
    is_r: torch.Tensor
    is_c_upper: torch.Tensor
    is_b_upper: torch.Tensor
    is_open: torch.Tensor
    is_close: torch.Tensor
    is_dot: torch.Tensor
    is_lbr: torch.Tensor
    is_rbr: torch.Tensor
    is_at: torch.Tensor
    is_h: torch.Tensor
    is_plus: torch.Tensor
    is_minus: torch.Tensor
    is_pad: torch.Tensor


class ConState(NamedTuple):
    val: torch.Tensor  # (B, A) remaining bond budget per atom
    par: torch.Tensor  # (B, A) tree parent (-1 root)
    n_atoms: torch.Tensor
    prev: torch.Tensor  # attachment atom, -1 none
    pend: torch.Tensor  # pending bond order, 0 none
    stack: torch.Tensor  # (B, DMAX) saved attachment atoms
    sp: torch.Tensor
    fresh: torch.Tensor  # '(' seen, no atom yet
    rpart: torch.Tensor  # (B, NRING) ring-opening atom, -1 closed
    rhint: torch.Tensor  # (B, NRING) bond-order hint at open
    rres: torch.Tensor  # (B, NRING) order reserved at open
    ppa: torch.Tensor  # (B, P) closed ring pair, lower atom
    ppb: torch.Tensor  # (B, P) closed ring pair, higher atom
    pn: torch.Tensor
    done: torch.Tensor  # pad emitted
    esc: torch.Tensor  # the escape hatch fired
    hfix: torch.Tensor  # halogen fixup: 1 after 'C', 2 after 'B'
    horder: torch.Tensor
    b: torch.Tensor  # bracket sub-state 0..8
    bbud: torch.Tensor
    bh: torch.Tensor
    bchg: torch.Tensor
    bsign: torch.Tensor
    bsymc: torch.Tensor
    bsymb: torch.Tensor


def build_tables(chars, device="cpu") -> Tables:
    if "C" not in chars:
        raise ValueError("constrained decoding needs 'C' in the charset")

    def flag(pred):
        return torch.tensor([pred(c) for c in chars], dtype=torch.bool, device=device)

    def ints(values):
        return torch.tensor(values, dtype=torch.int64, device=device)

    budget = ints([_BUDGET.get(c, -1) for c in chars])
    return Tables(
        n=len(chars),
        atom_budget=budget,
        is_atom=budget >= 0,
        bond_order=ints([_BOND.get(c, 0) for c in chars]),
        digit_val=ints([int(c) if c.isdigit() and c != "0" else 0 for c in chars]),
        is_l=flag(lambda c: c == "l"), is_r=flag(lambda c: c == "r"),
        is_c_upper=flag(lambda c: c == "C"), is_b_upper=flag(lambda c: c == "B"),
        is_open=flag(lambda c: c == "("), is_close=flag(lambda c: c == ")"),
        is_dot=flag(lambda c: c == "."), is_lbr=flag(lambda c: c == "["),
        is_rbr=flag(lambda c: c == "]"), is_at=flag(lambda c: c == "@"),
        is_h=flag(lambda c: c == "H"), is_plus=flag(lambda c: c == "+"),
        is_minus=flag(lambda c: c == "-"), is_pad=flag(lambda c: c == " "),
    )


def init_state(batch: int, max_atoms: int, device="cpu") -> ConState:
    def z(*s):
        return torch.zeros(s or (batch,), dtype=torch.int64, device=device)

    def f(*s):
        return torch.zeros(s or (batch,), dtype=torch.bool, device=device)

    def neg(*s):
        return torch.full(s or (batch,), -1, dtype=torch.int64, device=device)

    npair = max(1, max_atoms // 2)  # each closure takes two digit tokens
    return ConState(
        val=z(batch, max_atoms), par=neg(batch, max_atoms), n_atoms=z(), prev=neg(), pend=z(),
        stack=neg(batch, DMAX), sp=z(), fresh=f(),
        rpart=neg(batch, NRING), rhint=z(batch, NRING), rres=z(batch, NRING),
        ppa=neg(batch, npair), ppb=neg(batch, npair), pn=z(),
        done=f(), esc=f(), hfix=z(), horder=z(),
        b=z(), bbud=z(), bh=z(), bchg=z(), bsign=z(), bsymc=f(), bsymb=f(),
    )


def _iota(n: int, ndim: int, dim: int, device) -> torch.Tensor:
    """0 .. n-1 along ``dim`` of an ``ndim``-dimensional broadcast shape."""
    shape = [1] * ndim
    shape[dim] = n
    return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)


def _w(cond: torch.Tensor, a: Num, b: Num) -> torch.Tensor:
    """jnp.where with Python integers allowed on either side."""
    dev = cond.device
    a = a if isinstance(a, torch.Tensor) else torch.tensor(a, dtype=torch.int64, device=dev)
    b = b if isinstance(b, torch.Tensor) else torch.tensor(b, dtype=torch.int64, device=dev)
    return torch.where(cond, a, b)


def _max(a: torch.Tensor, b: Num) -> torch.Tensor:
    return torch.maximum(a, b) if isinstance(b, torch.Tensor) else a.clamp(min=b)


def _gather_val(val: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """val[i, idx[i]], 0 where idx is -1."""
    oh = _iota(val.shape[1], 2, 1, val.device) == idx[:, None]
    return _w(oh, val, 0).sum(1)


def _anc_spare_max(val, stack, sp, drop_top=False, adj_idx=None, adj=None, adj_idx2=None, adj2=None):
    """The largest remaining budget over the stacked ancestors (0 if none),
    less a candidate's consumption at ``adj_idx`` / ``adj_idx2``."""
    depth = _iota(DMAX, 2, 1, val.device)
    live = depth < (sp - 1 if drop_top else sp)[:, None]
    oh = stack[:, :, None] == _iota(val.shape[1], 3, 2, val.device)
    vals = _w(oh, val[:, None, :], 0).sum(2)
    if adj_idx is not None:
        vals = vals - _w(stack == adj_idx[:, None], adj[:, None], 0)
    if adj_idx2 is not None:
        vals = vals - _w(stack == adj_idx2[:, None], adj2[:, None], 0)
    return _w(live & (stack >= 0), vals, 0).amax(1)


def _dup_wrt(st: ConState, a: torch.Tensor) -> torch.Tensor:
    """(B, NRING): closing each slot's ring at atom ``a`` would bond an
    already bonded pair (a closed ring pair, or a chain bond)."""
    part = st.rpart
    lo = torch.minimum(part, a[:, None])
    hi = torch.maximum(part, a[:, None])
    pool = ((st.ppa[:, None, :] == lo[:, :, None]) & (st.ppb[:, None, :] == hi[:, :, None])).any(2)
    par_a = _gather_val(st.par, a)
    oh = part[:, :, None] == _iota(st.par.shape[1], 3, 2, part.device)
    par_part = _w(oh, st.par[:, None, :], 0).sum(2)
    chain = (part == par_a[:, None]) | (par_part == a[:, None])
    return pool | chain


def _hist(mask: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """Eligibility mask and per-slot costs 1..4 -> (..., 4) count per cost."""
    cv = _iota(4, res.dim() + 1, res.dim(), res.device) + 1
    resm = _w(mask, res, 0)
    return (resm[..., None] == cv).sum(-2)


def _take(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The most closures affordable within budget ``w``, cheapest first."""
    m = torch.zeros_like(w)
    for i, c in enumerate((1, 2, 3, 4)):
        t = torch.minimum((w // c).clamp(min=0), h[..., i])
        m = m + t
        w = w - t * c
    return m


def _credit(h, ndir, v, r, partial_only=False):
    """Closures achievable from budget ``v`` with the cost histogram ``h``:
    1 unit kept for the enabling atom unless every open ring closes directly."""
    k = torch.minimum(_take(h, v - 1), ndir)
    if not partial_only:
        kfull = _take(h, v)
        full_ok = (ndir >= r) & (kfull >= r)
        k = torch.where(full_ok, r, k)
    return torch.minimum(k, r)


def step_mask_rem(tb: Tables, st: ConState, rem: Num) -> torch.Tensor:
    """(B, C) bool: the legal next tokens; ``rem`` tokens remain after this one."""
    dev = st.prev.device
    B = st.prev.shape[0]
    A = st.val.shape[1]
    rem = torch.as_tensor(rem, dtype=torch.int64, device=dev)
    prev_ok = st.prev >= 0
    vprev = _gather_val(st.val, st.prev)
    anc = _anc_spare_max(st.val, st.stack, st.sp)
    open_d = st.rpart >= 0
    r = open_d.sum(1)
    o_att = _w(st.pend > 0, st.pend, _w(prev_ok, 1, 0))
    outside = (st.b == 0) & ~st.done

    # ring-closure credit
    res = _max(st.rres, 1)
    dup_prev = _dup_wrt(st, st.prev)
    same_p = open_d[:, None, :] & (st.rpart[:, :, None] == st.rpart[:, None, :])
    lower = _iota(NRING, 3, 1, dev) > _iota(NRING, 3, 2, dev)
    first_p = ~(same_p & lower).any(2)
    direct_prev = open_d & (st.rpart != st.prev[:, None]) & ~dup_prev
    cred_prev = direct_prev & first_p
    h_prev = _hist(cred_prev, res)
    ndir_prev = cred_prev.sum(1)
    new_ok = open_d & first_p & (st.rpart != st.prev[:, None])
    h_new = _hist(new_ok, res)
    ndir_new = new_ok.sum(1)
    n_att = (open_d & (st.rpart == st.prev[:, None])).sum(1)

    def need_ok(k, sp=None, rr=None, extra=0):
        need = (st.sp if sp is None else sp) + 2 * (r if rr is None else rr) - k
        return (need + extra) <= rem

    def att_extra(k, rr, natt):
        return ((natt > 0) & (k >= rr - natt)).long()

    # atoms outside brackets
    g = tb.atom_budget[None, :]
    v_new = g - o_att[:, None]
    anc_att = _anc_spare_max(st.val, st.stack, st.sp, adj_idx=st.prev, adj=o_att)
    t_ok = ~((r[:, None] > 0) & (v_new == 0) & (anc_att[:, None] == 0))
    k_atom = _credit(h_new[:, None, :], ndir_new[:, None], v_new, r[:, None])
    ok_atom = (tb.is_atom[None, :] & outside[:, None] & (~prev_ok | (vprev >= o_att))[:, None]
               & (v_new >= 0) & t_ok & need_ok(k_atom, sp=st.sp[:, None], rr=r[:, None]))

    # 'l' / 'r' halogen continuations
    v_hal = 1 - st.horder
    t_hal = ~((r > 0) & (v_hal == 0) & (anc == 0))
    k_hal = _credit(h_prev, ndir_prev, v_hal, r)
    ok_hal_row = outside & (v_hal >= 0) & t_hal & need_ok(k_hal)
    ok_l = tb.is_l[None, :] & (ok_hal_row & (st.hfix == 1))[:, None]
    ok_r = tb.is_r[None, :] & (ok_hal_row & (st.hfix == 2))[:, None]

    # bonds
    freshx = st.fresh.long()
    ok_bond_row = outside & prev_ok & (st.pend == 0) & need_ok(torch.zeros_like(r), extra=1 + freshx)
    ok_bond = (tb.bond_order[None, :] > 0) & ok_bond_row[:, None] & (vprev[:, None] >= tb.bond_order[None, :])

    # ring digits
    can_open = st.rpart == -1
    v_po = (vprev - o_att)[:, None]
    k_po = _credit(h_prev[:, None, :], ndir_prev[:, None], v_po.expand(B, NRING), r[:, None], partial_only=True)
    ok_open_slot = (outside[:, None] & prev_ok[:, None] & can_open & ~st.fresh[:, None]
                    & (vprev >= o_att)[:, None] & (r < RMAX)[:, None]
                    & ((v_po >= 1) | (anc_att[:, None] >= 1))
                    & need_ok(k_po, sp=st.sp[:, None], rr=(r + 1)[:, None],
                              extra=att_extra(k_po, (r + 1)[:, None], (n_att + 1)[:, None])))

    hint = st.rhint
    o_fin = _w(st.pend[:, None] > 0, st.pend[:, None], _max(hint, 1))
    mismatch = (st.pend[:, None] > 0) & (hint > 0) & (st.pend[:, None] != hint)
    sur = o_fin - _max(st.rres, 1)
    oh_part = st.rpart[:, :, None] == _iota(A, 3, 2, dev)
    vpart = _w(oh_part, st.val[:, None, :], 0).sum(2)
    eligible = direct_prev
    v_pc = vprev[:, None] - o_fin
    stk_oh = st.stack[:, :, None] == _iota(A, 3, 2, dev)
    stk_vals = _w(stk_oh, st.val[:, None, :], 0).sum(2)
    live_anc = (_iota(DMAX, 2, 1, dev) < st.sp[:, None]) & (st.stack >= 0)
    vals_j = (stk_vals[:, None, :]
              - _w(st.stack[:, None, :] == st.prev[:, None, None], o_fin[:, :, None], 0)
              - _w(st.stack[:, None, :] == st.rpart[:, :, None], sur[:, :, None], 0))
    anc_pc = _w(live_anc[:, None, :], vals_j, 0).amax(2)
    t_pc = ~(((r - 1)[:, None] > 0) & (v_pc == 0) & (anc_pc == 0))
    same_part = st.rpart[:, :, None] == st.rpart[:, None, :]
    direct_mat = direct_prev[:, None, :] & ~same_part & first_p[:, None, :]
    h_mat = _hist(direct_mat, res[:, None, :])
    ndir_mat = direct_mat.sum(2)
    k_pc = _credit(h_mat, ndir_mat, v_pc, (r - 1)[:, None])
    ok_close_slot = (outside[:, None] & prev_ok[:, None] & eligible & ~mismatch
                     & (vprev[:, None] >= o_fin) & (vpart >= sur) & t_pc & ~st.fresh[:, None]
                     & need_ok(k_pc, sp=st.sp[:, None], rr=(r - 1)[:, None],
                               extra=att_extra(k_pc, (r - 1)[:, None], n_att[:, None])))
    slot_ok = ok_open_slot | ok_close_slot
    dig = tb.digit_val
    dig_sel = (_iota(NRING, 2, 0, dev) == dig[None, :]) & (dig[None, :] > 0)
    ok_digit = (slot_ok.long()[:, :, None] * dig_sel.long()[None, :, :]).sum(1) > 0

    # '(' / ')' / '.'
    k_cur = _credit(h_prev, ndir_prev, vprev, r)
    ok_open_br = (outside & prev_ok & ~st.fresh & (st.pend == 0) & (st.sp < DMAX) & (vprev >= 1)
                  & need_ok(k_cur, sp=st.sp + 1, extra=1))[:, None] & tb.is_open[None, :]

    popped = _gather_val(st.stack, _w(st.sp > 0, st.sp - 1, 0))
    vpop = _gather_val(st.val, _w(st.sp > 0, popped, -1))
    anc2 = _anc_spare_max(st.val, st.stack, st.sp, drop_top=True)
    dup_pop = _dup_wrt(st, popped)
    direct_pop = open_d & (st.rpart != popped[:, None]) & ~dup_pop & first_p
    k_pop = _credit(_hist(direct_pop, res), direct_pop.sum(1), vpop, r)
    n_att_pop = (open_d & (st.rpart == popped[:, None])).sum(1)
    ok_close_br = (outside & (st.sp > 0) & (st.pend == 0) & ~st.fresh
                   & ~((r > 0) & (vpop == 0) & (anc2 == 0))
                   & need_ok(k_pop, sp=st.sp - 1, extra=att_extra(k_pop, r, n_att_pop)))[:, None] & tb.is_close[None, :]

    ok_dot = (outside & prev_ok & (st.pend == 0) & (st.sp == 0) & (r == 0) & (rem >= 1))[:, None] & tb.is_dot[None, :]

    # bracket atoms
    ok_lbr = (outside & (~prev_ok | (vprev >= o_att)) & need_ok(k_cur, extra=2))[:, None] & tb.is_lbr[None, :]

    inb = (st.b > 0) & ~st.done
    extra_v = ((r > 0) & (anc_att == 0)).long()
    o_req = o_att + extra_v
    bud_eff = st.bbud + st.bchg - st.bh
    v_brk = bud_eff - o_att
    k_brk = _credit(h_new, ndir_new, v_brk, r)
    fit_rbr = need_ok(k_brk)
    fit_deco = need_ok(k_brk, extra=1)
    ok_sym = (tb.is_atom[None, :] & (inb & (st.b == 1))[:, None] & (g >= o_req[:, None])
              & need_ok(k_atom, sp=st.sp[:, None], rr=r[:, None], extra=1))
    k_lr = _credit(h_new, ndir_new, 1 - o_att, r)
    fit_lr = need_ok(k_lr, extra=1)
    ok_bl = tb.is_l[None, :] & (inb & (st.b == 2) & st.bsymc & (1 >= o_req) & fit_lr)[:, None]
    ok_br_ = tb.is_r[None, :] & (inb & (st.b == 2) & st.bsymb & (1 >= o_req) & fit_lr)[:, None]
    ok_at = tb.is_at[None, :] & (inb & ((st.b == 2) | (st.b == 3)) & fit_deco)[:, None]
    k_h = _credit(h_new, ndir_new, bud_eff - 1 - o_att, r)
    ok_bh = tb.is_h[None, :] & (inb & (st.b >= 2) & (st.b <= 4) & (bud_eff - 1 >= o_req)
                                & need_ok(k_h, extra=1))[:, None]
    sign_new = inb & (st.b >= 2) & (st.b <= 6)
    sign_more = inb & (st.b == 7) & (st.bchg < 3)
    ok_plus = tb.is_plus[None, :] & ((sign_new | (sign_more & (st.bsign > 0))) & fit_deco)[:, None]
    ok_minus = tb.is_minus[None, :] & ((sign_new | (sign_more & (st.bsign < 0))) & fit_deco)[:, None]
    v_hd = st.bbud[:, None] + st.bchg[:, None] - dig[None, :] - o_att[:, None]
    k_hd = _credit(h_new[:, None, :], ndir_new[:, None], v_hd, r[:, None])
    ok_bdig_h = ((dig[None, :] > 0) & (inb & (st.b == 5))[:, None] & (v_hd >= extra_v[:, None])
                 & need_ok(k_hd, sp=st.sp[:, None], rr=r[:, None], extra=1))
    ok_bdig_c = (dig[None, :] > 0) & (dig[None, :] <= 3) & (inb & (st.b == 7) & (st.bchg == 1) & fit_deco)[:, None]
    ok_rbr = tb.is_rbr[None, :] & (inb & (st.b >= 2) & (bud_eff >= o_req) & fit_rbr)[:, None]

    # pad
    closed = (st.n_atoms >= 1) & (st.pend == 0) & (st.sp == 0) & (r == 0) & (st.b == 0) & prev_ok
    ok_pad = (st.done | closed)[:, None] & tb.is_pad[None, :]

    mask = (ok_atom | ok_l | ok_r | ok_bond | ok_digit | ok_open_br | ok_close_br | ok_dot | ok_lbr | ok_sym
            | ok_bl | ok_br_ | ok_at | ok_bh | ok_plus | ok_minus | ok_bdig_h | ok_bdig_c | ok_rbr | ok_pad)
    d = st.done[:, None]
    mask = (d & tb.is_pad[None, :]) | (~d & mask)
    any_ok = mask.any(1)
    return mask | (~any_ok[:, None] & tb.is_pad[None, :])


def advance(tb: Tables, st: ConState, tok: torch.Tensor) -> ConState:
    """The state after each row emits its token ``tok`` (B,)."""
    B, A = st.val.shape
    dev = st.val.device
    oht = _iota(tb.n, 2, 1, dev) == tok.long()[:, None]

    def pick_i(table):
        return _w(oht, table[None, :], 0).sum(1)

    def pick_b(table):
        return (oht & table[None, :]).any(1)

    g_tok = pick_i(tb.atom_budget)
    is_atom = pick_b(tb.is_atom)
    bond_o = pick_i(tb.bond_order)
    dig = pick_i(tb.digit_val)
    t_l, t_r = pick_b(tb.is_l), pick_b(tb.is_r)
    t_cu, t_bu = pick_b(tb.is_c_upper), pick_b(tb.is_b_upper)
    t_open, t_close = pick_b(tb.is_open), pick_b(tb.is_close)
    t_dot, t_lbr, t_rbr = pick_b(tb.is_dot), pick_b(tb.is_lbr), pick_b(tb.is_rbr)
    t_at, t_h = pick_b(tb.is_at), pick_b(tb.is_h)
    t_plus, t_minus = pick_b(tb.is_plus), pick_b(tb.is_minus)
    is_pad = pick_b(tb.is_pad)
    outside = (st.b == 0) & ~st.done
    prev_ok = st.prev >= 0
    o_att = _w(st.pend > 0, st.pend, _w(prev_ok, 1, 0))
    cols = _iota(A, 2, 1, dev)
    oh_prev = (cols == st.prev[:, None]) & prev_ok[:, None]
    oh_new = cols == st.n_atoms[:, None]

    # an atom outside brackets
    do_atom = outside & is_atom
    val = st.val - _w(do_atom, o_att, 0)[:, None] * oh_prev
    val = val + _w(do_atom, g_tok - o_att, 0)[:, None] * oh_new
    par = _w((do_atom & prev_ok)[:, None] & oh_new, st.prev[:, None], st.par)
    n_atoms = st.n_atoms + do_atom.long()
    prev = _w(do_atom, st.n_atoms, st.prev)
    pend = _w(do_atom, 0, st.pend)
    fresh = st.fresh & ~do_atom
    hfix = _w(do_atom & t_cu, 1, _w(do_atom & t_bu, 2, 0))
    horder = _w(do_atom, o_att, 0)

    # halogen fixup ('l' / 'r' outside brackets)
    do_hal = outside & (t_l | t_r) & (st.hfix > 0)
    oh_prev2 = cols == prev[:, None]
    oh_cur = cols == prev.clamp(0, A - 1)[:, None]
    cur_pv = _w(oh_cur, val, 0).sum(1)
    val = val + _w(do_hal, (1 - st.horder) - cur_pv, 0)[:, None] * oh_prev2

    # bond
    do_bond = outside & (bond_o > 0) & ~do_hal
    pend = _w(do_bond, bond_o, pend)

    # ring digit
    do_dig = outside & (dig > 0)
    slot = _w(do_dig, dig, 0)
    ring = _iota(NRING, 2, 1, dev)
    oh_slot = (ring == slot[:, None]) & do_dig[:, None]
    oh_sl = ring == slot[:, None]
    slot_part = _w(oh_sl, st.rpart, 0).sum(1)
    is_close = do_dig & (slot_part >= 0)
    is_openr = do_dig & ~is_close
    res_o = _max(st.pend, 1)
    rpart = _w(oh_slot & is_openr[:, None], st.prev[:, None], st.rpart)
    rhint = _w(oh_slot & is_openr[:, None], st.pend[:, None], st.rhint)
    rres = _w(oh_slot & is_openr[:, None], res_o[:, None], st.rres)
    val = val - _w(is_openr, res_o, 0)[:, None] * oh_prev
    slot_hint = _w(oh_sl, st.rhint, 0).sum(1)
    slot_res = _max(_w(oh_sl, st.rres, 0).sum(1), 1)
    o_fin = _w(st.pend > 0, st.pend, _max(slot_hint, 1))
    sur = o_fin - slot_res
    val = val - _w(is_close, o_fin, 0)[:, None] * oh_prev
    oh_part = cols == slot_part[:, None]
    val = val - _w(is_close, sur, 0)[:, None] * oh_part
    lo = torch.minimum(st.prev, slot_part)
    hi = torch.maximum(st.prev, slot_part)
    oh_pn = _iota(st.ppa.shape[1], 2, 1, dev) == st.pn[:, None]
    wr_pool = oh_pn & is_close[:, None]
    ppa = _w(wr_pool, lo[:, None], st.ppa)
    ppb = _w(wr_pool, hi[:, None], st.ppb)
    pn = st.pn + is_close.long()
    rpart = _w(oh_slot & is_close[:, None], -1, rpart)
    pend = _w(do_dig, 0, pend)

    # '(' / ')' / '.'
    do_open = outside & t_open
    depth = _iota(DMAX, 2, 1, dev)
    stack = _w((depth == st.sp[:, None]) & do_open[:, None], st.prev[:, None], st.stack)
    sp = st.sp + do_open.long()
    fresh = fresh | do_open
    do_close = outside & t_close
    top = _w(depth == (st.sp - 1).clamp(0, DMAX - 1)[:, None], st.stack, 0).sum(1)
    prev = _w(do_close, top, prev)
    sp = _w(do_close, st.sp - 1, sp)
    fresh = fresh & ~do_close
    do_dot = outside & t_dot
    prev = _w(do_dot, -1, prev)

    # bracket machine
    do_lbr = outside & t_lbr
    b = _w(do_lbr, 1, st.b)
    inb = (st.b > 0) & ~st.done
    do_sym = inb & (st.b == 1) & is_atom
    b = _w(do_sym, 2, b)
    bbud = _w(do_sym, g_tok, st.bbud)
    bsymc = (do_sym & t_cu) | (~do_sym & st.bsymc)
    bsymb = (do_sym & t_bu) | (~do_sym & st.bsymb)
    do_bhal = inb & (st.b == 2) & ((t_l & st.bsymc) | (t_r & st.bsymb))
    bbud = _w(do_bhal, 1, bbud)
    bsymc = bsymc & ~do_bhal
    bsymb = bsymb & ~do_bhal
    do_at = inb & t_at
    b = _w(do_at & (st.b == 2), 3, _w(do_at & (st.b == 3), 4, b))
    do_bh = inb & t_h
    b = _w(do_bh, 5, b)
    bh = _w(do_bh, 1, st.bh)
    do_bhd = inb & (st.b == 5) & (dig > 0)
    b = _w(do_bhd, 6, b)
    bh = _w(do_bhd, dig, bh)
    do_sign = inb & (t_plus | t_minus)
    new_sign = _w(t_plus, 1, -1)
    first_sign = do_sign & (st.b != 7)
    more_sign = do_sign & (st.b == 7)
    b = _w(do_sign, 7, b)
    bchg = _w(first_sign, 1, st.bchg + more_sign.long())
    bsign = _w(first_sign, new_sign, st.bsign)
    do_bcd = inb & (st.b == 7) & (dig > 0)
    b = _w(do_bcd, 8, b)
    bchg = _w(do_bcd, dig, bchg)
    do_rbr = inb & t_rbr & (st.b >= 2)
    bud_eff = _max(st.bbud + st.bchg - st.bh, 0)
    val = val - _w(do_rbr, o_att, 0)[:, None] * oh_prev
    val = val + _w(do_rbr, bud_eff - o_att, 0)[:, None] * oh_new
    par = _w((do_rbr & (st.prev >= 0))[:, None] & oh_new, st.prev[:, None], par)
    n_atoms = n_atoms + do_rbr.long()
    prev = _w(do_rbr, st.n_atoms, prev)
    pend = _w(do_rbr, 0, pend)
    fresh = fresh & ~do_rbr
    b = _w(do_rbr, 0, b)
    bh = _w(do_rbr, 0, bh)
    bchg = _w(do_rbr, 0, bchg)
    bsign = _w(do_rbr, 0, bsign)
    bbud = _w(do_rbr, 0, bbud)

    # pad / done
    closed = ((st.n_atoms >= 1) & (st.pend == 0) & (st.sp == 0) & ((st.rpart >= 0).sum(1) == 0) & (st.b == 0)
              & (st.prev >= 0))
    esc = st.esc | (is_pad & ~st.done & ~closed)
    done = st.done | is_pad
    hfix = _w(do_atom, hfix, 0)
    horder = _w(do_atom, horder, 0)

    return ConState(val=val, par=par, n_atoms=n_atoms, prev=prev, pend=pend, stack=stack, sp=sp, fresh=fresh,
                    rpart=rpart, rhint=rhint, rres=rres, ppa=ppa, ppb=ppb, pn=pn, done=done, esc=esc, hfix=hfix,
                    horder=horder, b=b, bbud=bbud, bh=bh, bchg=bchg, bsign=bsign, bsymc=bsymc, bsymb=bsymb)
