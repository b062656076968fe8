"""Constrained-decoding automaton step: packed layout, plain version, wrappers.

Port of ``molvax/kernels/automaton.py:64-148,218-255``. One automaton step
masks the tokens the SMILES parser would reject (``step_mask_rem``), picks
the first maximum of the masked scores, and applies the token
(``advance``); ``latent/constrain.py`` holds the plain torch version of
both. The hand-written kernel ``csrc/automaton.cu`` computes the same
function, bit for bit, on packed rows. Three entry points, each with a
launch counter:

  * ``auto_step``: n consecutive steps (mask, select, advance) in one
    launch, with rem = rem0, rem0 - 1, ...; the autoregressive decode calls
    it with n=1 per step, the ``repeat_z`` decode once with n=T;
  * ``auto_mask``: the mask alone (beam search, ``validate_codes``);
  * ``auto_advance``: the transition alone (beam search,
    ``validate_codes``).

On a CUDA tensor a wrapper launches the kernel or raises; it runs the plain
version only for tensors on the CPU. So ``ModelConfig.use_pallas_automaton``
has no effect in the port: it chose between two implementations of the same
codes by their speed on the TPU, and the port has one per device.

Layout (defined here once; the kernel gets A and P and computes the same
offsets). One contiguous int32 row per batch element:

    [val A | par A | stack DMAX | rpart NRING | rhint NRING | rres NRING |
     ppa P | ppb P | 17 scalars in _SC_FIELDS order]

with A = max_atoms (= T) and P = max(1, A // 2): S = 423 at T=120. Beam
search reorders beams with one ``index_select`` on dim 0. The wrappers
update the state in place.

Selection: illegal tokens score -inf, and the code is the lowest index
whose masked score equals the row's maximum; a NaN among the legal scores
makes the maximum NaN, nothing equals it, and the code is 0 (pad), which
``advance`` records in ``esc``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..latent.constrain import (
    DMAX,
    NRING,
    ConState,
    Tables,
    advance,
    init_state,
    n_pairs,
    step_mask_rem,
)
from . import _build

# kernel launches made by the wrappers (not by the plain versions)
step_launches = 0
mask_launches = 0
advance_launches = 0

# scalar-field order in the packed row: 12 int32 then 5 bools
_SC_FIELDS = (
    "n_atoms", "prev", "pend", "sp", "pn", "hfix", "horder",
    "b", "bbud", "bh", "bchg", "bsign",
    "fresh", "done", "esc", "bsymc", "bsymb",
)
SC = len(_SC_FIELDS)
_BOOL_FIELDS = frozenset(("fresh", "done", "esc", "bsymc", "bsymb"))
# packed-table row order (ints first, then bool flags as 0/1)
_TAB_ROWS = (
    "atom_budget", "bond_order", "digit_val",
    "is_atom", "is_l", "is_r", "is_c_upper", "is_b_upper", "is_open",
    "is_close", "is_dot", "is_lbr", "is_rbr", "is_at", "is_h", "is_plus",
    "is_minus", "is_pad",
)
_TAB_INT_ROWS = 3

# the kernel keeps a row's legal-token set in a 128-bit mask
MAX_CLASSES = 128


def layout(max_atoms: int) -> dict:
    """Field -> (offset, width) in a packed row of ``max_atoms`` slots."""
    A, P = max_atoms, n_pairs(max_atoms)
    widths = (("val", A), ("par", A), ("stack", DMAX), ("rpart", NRING),
              ("rhint", NRING), ("rres", NRING), ("ppa", P), ("ppb", P), ("sc", SC))
    out, off = {}, 0
    for name, w in widths:
        out[name] = (off, w)
        off += w
    return out


def row_width(max_atoms: int) -> int:
    """S, the int32 width of one packed row."""
    return 2 * max_atoms + DMAX + 3 * NRING + 2 * n_pairs(max_atoms) + SC


def atoms_of(width: int) -> int:
    """The max_atoms whose packed row is ``width`` wide (raises if none)."""
    for a in ((width - SC - DMAX - 3 * NRING) // 3, (width - SC - DMAX - 3 * NRING + 1) // 3, 1):
        if a >= 1 and row_width(a) == width:
            return a
    raise ValueError(f"no automaton layout has a packed row of width {width}")


def pack_tables(tb: Tables) -> torch.Tensor:
    """(18, C) int32: all token-attribute tables as one kernel input."""
    return torch.stack([getattr(tb, name).to(torch.int32) for name in _TAB_ROWS], dim=0).contiguous()


def tables_from(itab: torch.Tensor) -> Tables:
    rows = {name: itab[i] for i, name in enumerate(_TAB_ROWS)}
    for name in _TAB_ROWS[_TAB_INT_ROWS:]:
        rows[name] = rows[name] != 0
    return Tables(n=itab.shape[1], **rows)


def pack_state(st: ConState) -> torch.Tensor:
    """ConState -> (B, S) int32 packed rows."""
    sc = torch.stack([getattr(st, f).to(torch.int32) for f in _SC_FIELDS], dim=1)
    arrs = [st.val, st.par, st.stack, st.rpart, st.rhint, st.rres, st.ppa, st.ppb, sc]
    return torch.cat([a.to(torch.int32) for a in arrs], dim=1).contiguous()


def unpack_state(packed: torch.Tensor) -> ConState:
    """(B, S) packed rows -> ConState (copies; int32 fields, bool flags)."""
    lay = layout(atoms_of(packed.shape[1]))
    fields = {}
    for name in ("val", "par", "stack", "rpart", "rhint", "rres", "ppa", "ppb"):
        off, w = lay[name]
        fields[name] = packed[:, off : off + w].clone()
    off = lay["sc"][0]
    for i, f in enumerate(_SC_FIELDS):
        col = packed[:, off + i].clone()
        fields[f] = col != 0 if f in _BOOL_FIELDS else col
    return ConState(**fields)


def new_state(batch: int, max_atoms: int, device) -> torch.Tensor:
    """The packed initial state of ``batch`` rows on ``device``."""
    return pack_state(init_state(batch, max_atoms, device))


# -- plain versions ----------------------------------------------------------


def select_advance(tb: Tables, st: ConState, scores: torch.Tensor, rem) -> Tuple[ConState, torch.Tensor]:
    """Mask -> select -> advance: (new ConState, code (B,) int32).

    First-argmax at -inf for illegal tokens; a NaN among the legal scores
    gives code 0 (pad)."""
    m = step_mask_rem(tb, st, rem)
    sc = torch.where(m, scores, -float("inf"))
    mx = torch.amax(sc, dim=1, keepdim=True)
    cidx = torch.arange(tb.n, dtype=torch.int32, device=scores.device)[None, :]
    code = torch.amin(torch.where(sc == mx, cidx, tb.n), dim=1)
    code = torch.where(code >= tb.n, 0, code).to(torch.int32)
    return advance(tb, st, code), code


def auto_step_plain(itab: torch.Tensor, state: torch.Tensor, scores: torch.Tensor, rem0: int) -> torch.Tensor:
    """``auto_step``'s plain version, on any device: n steps of
    ``select_advance``, ``state`` updated in place, codes (B, n) int32."""
    sc3 = scores[:, None, :] if scores.dim() == 2 else scores
    tb = tables_from(itab)
    st = unpack_state(state)
    codes = []
    for k in range(sc3.shape[1]):
        st, code = select_advance(tb, st, sc3[:, k], rem0 - k)
        codes.append(code)
    state.copy_(pack_state(st))
    return torch.stack(codes, dim=1)


def auto_mask_plain(itab: torch.Tensor, state: torch.Tensor, rem: int) -> torch.Tensor:
    """``auto_mask``'s plain version, on any device."""
    return step_mask_rem(tables_from(itab), unpack_state(state), rem)


def auto_advance_plain(itab: torch.Tensor, state: torch.Tensor, tok: torch.Tensor) -> None:
    """``auto_advance``'s plain version, on any device (in place)."""
    state.copy_(pack_state(advance(tables_from(itab), unpack_state(state), tok.to(torch.int32))))


# -- the kernel's wrappers ---------------------------------------------------


def _check(itab: torch.Tensor, state: torch.Tensor, what: str) -> Tuple[int, int, int]:
    """Shared checks; returns (B, C, A)."""
    if state.dtype != torch.int32 or state.dim() != 2 or not state.is_contiguous():
        raise ValueError(f"{what}: state must be contiguous (B, S) int32, got {state.dtype} {tuple(state.shape)}")
    if itab.dtype != torch.int32 or itab.dim() != 2 or itab.shape[0] != len(_TAB_ROWS) or not itab.is_contiguous():
        raise ValueError(f"{what}: tables must be contiguous ({len(_TAB_ROWS)}, C) int32")
    if itab.device != state.device:
        raise ValueError(f"{what}: tables on {itab.device}, state on {state.device}")
    if state.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {state.device}")
    A = atoms_of(state.shape[1])
    C = itab.shape[1]
    if state.device.type == "cuda" and not 1 <= C <= MAX_CLASSES:
        raise ValueError(f"{what}: the kernel takes 1..{MAX_CLASSES} token classes, got {C}")
    return state.shape[0], C, A


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def auto_step(itab: torch.Tensor, state: torch.Tensor, scores: torch.Tensor, rem0: int) -> torch.Tensor:
    """n automaton steps over scores (B, n, C) (or (B, C), n = 1) fp32, with
    rem = rem0, rem0 - 1, ..., rem0 - n + 1 tokens remaining after each.
    Updates ``state`` (B, S) in place and returns the codes (B, n) int32.
    On CUDA one launch of ``molvax_auto_step``; on the CPU the plain
    ``select_advance``."""
    global step_launches
    B, C, A = _check(itab, state, "auto_step")
    sc3 = scores[:, None, :] if scores.dim() == 2 else scores
    if sc3.dim() != 3 or sc3.shape[0] != B or sc3.shape[2] != C or sc3.shape[1] < 1:
        raise ValueError(f"auto_step: scores {tuple(scores.shape)} for state of {B} rows and {C} classes")
    if sc3.dtype != torch.float32 or sc3.device != state.device:
        raise ValueError(f"auto_step: scores must be fp32 on {state.device}, got {sc3.dtype} on {sc3.device}")
    n = sc3.shape[1]
    if state.device.type == "cpu":
        return auto_step_plain(itab, state, sc3, rem0)
    sc3 = sc3.contiguous()
    codes = torch.empty(B, n, dtype=torch.int32, device=state.device)
    if B == 0:
        return codes
    fn = _build.function("molvax_auto_step", [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                         + [ctypes.c_int] * 3 + [ctypes.c_void_p] + [ctypes.c_int] * 2
                         + [ctypes.c_void_p] * 2)
    err = fn(itab.data_ptr(), C, state.data_ptr(), B, A, n_pairs(A), sc3.data_ptr(), n, int(rem0),
             codes.data_ptr(), _stream(state))
    _build.check(err, "auto_step")
    step_launches += 1
    return codes


def auto_mask(itab: torch.Tensor, state: torch.Tensor, rem: int) -> torch.Tensor:
    """(B, C) bool mask of legal next tokens, ``rem`` tokens remaining after
    this one. Reads ``state``; on CUDA one launch of ``molvax_auto_mask``."""
    global mask_launches
    B, C, A = _check(itab, state, "auto_mask")
    if state.device.type == "cpu":
        return auto_mask_plain(itab, state, rem)
    out = torch.empty(B, C, dtype=torch.uint8, device=state.device)
    if B == 0:
        return out.bool()
    fn = _build.function("molvax_auto_mask", [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                         + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    err = fn(itab.data_ptr(), C, state.data_ptr(), B, A, n_pairs(A), int(rem), out.data_ptr(),
             _stream(state))
    _build.check(err, "auto_mask")
    mask_launches += 1
    return out.view(torch.bool)


def auto_advance(itab: torch.Tensor, state: torch.Tensor, tok: torch.Tensor) -> None:
    """Apply the tokens ``tok`` (B,) to ``state`` in place; on CUDA one
    launch of ``molvax_auto_advance``."""
    global advance_launches
    B, C, A = _check(itab, state, "auto_advance")
    if tok.shape != (B,) or tok.device != state.device:
        raise ValueError(f"auto_advance: tokens {tuple(tok.shape)} on {tok.device} for {B} rows on {state.device}")
    if state.device.type == "cpu":
        auto_advance_plain(itab, state, tok)
        return
    tok32 = tok.to(torch.int32).contiguous()
    if B == 0:
        return
    fn = _build.function("molvax_auto_advance", [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                         + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    err = fn(itab.data_ptr(), C, state.data_ptr(), B, A, n_pairs(A), tok32.data_ptr(), _stream(state))
    _build.check(err, "auto_advance")
    advance_launches += 1
