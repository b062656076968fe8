"""Offline SMILES validity: a real parser, not a character heuristic.

The port's own copy of ``molvax/data/smiles_check.py`` (pure Python): the
port imports nothing of the ``molvax`` package, and ``chip_smoke.py`` checks
the validity of constrained decodes on a host without JAX.
``tests/test_torch_smiles_check.py`` holds it to the reference.

The round-2 validity metric (`featurize.is_valid_smiles`) checks charset
membership and bracket balance only — VERDICT r2 missing 4 called it out as
a grammar heuristic. RDKit is unavailable offline (SURVEY.md section 7), so
this module implements the OpenSMILES subset the ZINC/MOSES corpora use as
a single-pass parser with chemical bookkeeping:

  * tokenization: organic-subset atoms (B C N O P S F Cl Br I), aromatic
    atoms (b c n o p s), bracket atoms ``[isotope? symbol chiral? Hcount?
    charge? class?]``, bonds ``- = # $ : / \\``, branches, ring-closure
    digits (incl. ``%nn``), dot disconnections;
  * structure: branches must follow an atom, be non-empty, and start with
    an atom or bond (never '(', a ring digit, or '.'); ring-closure digits
    must pair up with consistent bond orders (digits are reusable after
    they close, as in canonical SMILES); no dangling bond at a branch end
    or at the end of the string; no self-ring bonds and no second bond on
    an already-bonded pair — chain bonds included, so 'C1C1' is rejected;
  * valence: per-atom sum of explicit bond orders (+ bracket H counts) must
    fit the atom's allowed valence set (B 3; C 4; N 3,5; O 2; P 3,5;
    S 2,4,6; halogens 1), charge-adjusted for bracket atoms ([N+] gets 4,
    [O-] gets 1). Aromatic atoms get a +1 allowance: their two implied
    ring bonds carry ~1.5 order each in the delocalized ring, which this
    parser counts as 1 (full aromaticity perception needs ring-finding
    plus electron counting — out of scope for a validity gate).

`parse_smiles` returns (ok, reason); `chem_valid` is the boolean gate and
`chem_valid_fraction` the corpus metric used alongside the grammar-level
one in `train/evaluate.py`. `parse_graph` additionally returns the parsed
molecular graph (atoms + bond list with orders) — the substrate for the
computed property targets in `data/properties.py` (round 3).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Iterable, List, Optional, Tuple

# Allowed total bond-order sums (implicit H fills the remainder).
_VALENCE = {
    "B": (3,),
    "C": (4,),
    "N": (3, 5),
    "O": (2,),
    "P": (3, 5),
    "S": (2, 4, 6),
    "F": (1,),
    "Cl": (1,),
    "Br": (1,),
    "I": (1,),
}
_AROMATIC = {"b": "B", "c": "C", "n": "N", "o": "O", "p": "P", "s": "S"}
_ELEMENTS = frozenset(
    "H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe Co "
    "Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In Sn Sb "
    "Te I Xe Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf Ta W Re "
    "Os Ir Pt Au Hg Tl Pb Bi Po At Rn Fr Ra Ac Th Pa U Np Pu".split()
)
_BOND_ORDER = {"-": 1, "=": 2, "#": 3, "$": 4, ":": 1, "/": 1, "\\": 1}

_BRACKET_RE = re.compile(
    r"^(?P<isotope>\d+)?"
    r"(?P<symbol>[A-Z][a-z]?|[bcnops]|se|as)"
    r"(?P<chiral>@{1,2}(?:TH[12]|AL[12]|SP[1-3])?)?"
    r"(?P<hcount>H\d*)?"
    r"(?P<charge>\+{1,3}|-{1,3}|\+\d+|-\d+)?"
    r"(?::(?P<cls>\d+))?$"
)


class _Atom:
    __slots__ = ("symbol", "aromatic", "bond_sum", "explicit_h", "charge", "bracket")

    def __init__(self, symbol, aromatic, explicit_h=0, charge=0, bracket=False):
        self.symbol = symbol
        self.aromatic = aromatic
        self.bond_sum = 0
        self.explicit_h = explicit_h
        self.charge = charge
        self.bracket = bracket


def _parse_bracket(body: str) -> Optional[_Atom]:
    m = _BRACKET_RE.match(body)
    if not m:
        return None
    sym = m.group("symbol")
    aromatic = sym in _AROMATIC or sym in ("se", "as")
    symbol = _AROMATIC.get(sym, sym.capitalize() if aromatic else sym)
    if symbol not in _ELEMENTS:
        return None
    h = m.group("hcount")
    hcount = 0 if h is None else (1 if h == "H" else int(h[1:]))
    c = m.group("charge") or ""
    if c.startswith(("+", "-")) and len(c) > 1 and c[1:].isdigit():
        charge = int(c[1:]) * (1 if c[0] == "+" else -1)
    else:
        charge = c.count("+") - c.count("-")
    return _Atom(symbol, aromatic, hcount, charge, bracket=True)


def _valence_ok(a: _Atom) -> bool:
    allowed = _VALENCE.get(a.symbol)
    if allowed is None:
        # bracket-only element (Si, Se, Sn, ...): no table, stay permissive
        return True
    total = a.bond_sum + a.explicit_h
    slack = 1 if a.aromatic else 0
    if a.bracket and a.charge:
        # Charge shifts valence, but the sign of the shift depends on the
        # element's electron bookkeeping ([N+] 4 = 3+1, [O-] 1 = 2-1,
        # [B-] 4 = 3+1, [C-] 3 = 4-1). A validity gate must not reject
        # real molecules, so allow either direction.
        allowed = tuple(
            max(v + d, 0) for v in allowed for d in (a.charge, -a.charge)
        )
    return any(total <= v + slack for v in allowed)


@dataclasses.dataclass(frozen=True)
class MolGraph:
    """Parsed molecular graph: per-atom records plus a bond list.

    ``atoms[i]`` is ``(symbol, aromatic, charge, hcount)`` where ``hcount``
    is the explicit bracket H count, or ``None`` for organic-subset atoms
    whose hydrogens are implicit (fill rule: `properties.implicit_h`).
    ``bonds`` holds ``(a, b, order)`` with a < b possible in either slot;
    ring-closure bonds are included. Built by `parse_graph`."""

    atoms: Tuple[Tuple[str, bool, int, Optional[int]], ...]
    bonds: Tuple[Tuple[int, int, int], ...]

    def __len__(self) -> int:
        return len(self.atoms)


def _parse(s: str):
    """Internal single-pass parse. Returns (atoms, bonds, reason) —
    atoms/bonds are None when the string is rejected."""
    if not s:
        return None, None, "empty"
    atoms: List[_Atom] = []
    bonds: List[Tuple[int, int, int]] = []
    prev: Optional[int] = None  # index of the atom a new bond attaches to
    stack: List[Optional[int]] = []
    pending: Optional[int] = None  # explicit bond order awaiting its atom
    rings = {}  # digit -> (atom_index, order or None)
    bonded = set()  # canonical (lo, hi) pairs bonded so far (chain AND ring)
    branch_opened_here = False  # '(' must be followed by an atom/bond

    def close_ring(digit: str, order_hint: Optional[int]) -> Optional[str]:
        nonlocal pending
        if prev is None:
            return "ring digit before any atom"
        if digit in rings:
            other, other_hint = rings.pop(digit)
            if other == prev:
                return "ring closure to the same atom"
            if order_hint is not None and other_hint is not None and order_hint != other_hint:
                return "ring bond order mismatch"
            pair = (min(other, prev), max(other, prev))
            # duplicates against EVERY existing bond, chain bonds included:
            # 'C1C1' would put a second bond on an already-bonded pair
            # (round-3 review finding; RDKit/OpenSMILES reject it)
            if pair in bonded:
                return "duplicate bond (ring closure on an existing bond)"
            bonded.add(pair)
            order = order_hint or other_hint or 1
            atoms[other].bond_sum += order
            atoms[prev].bond_sum += order
            bonds.append((other, prev, order))
        else:
            rings[digit] = (prev, order_hint)
        return None

    def add_atom(atom: _Atom) -> None:
        nonlocal prev, pending, branch_opened_here
        atoms.append(atom)
        idx = len(atoms) - 1
        if prev is not None:
            order = pending if pending is not None else 1
            atoms[prev].bond_sum += order
            atom.bond_sum += order
            bonds.append((prev, idx, order))
            bonded.add((prev, idx))
        pending = None
        prev = idx
        branch_opened_here = False

    i, n = 0, len(s)
    while i < n:
        ch = s[i]
        if ch == "[":
            j = s.find("]", i)
            if j < 0:
                return None, None,"unclosed bracket atom"
            atom = _parse_bracket(s[i + 1 : j])
            if atom is None:
                return None, None,f"bad bracket atom [{s[i + 1:j]}]"
            add_atom(atom)
            i = j + 1
        elif ch in ("C", "B") and i + 1 < n and s[i : i + 2] in ("Cl", "Br"):
            add_atom(_Atom(s[i : i + 2], False))
            i += 2
        elif ch in "BCNOPSFI":
            add_atom(_Atom(ch, False))
            i += 1
        elif ch in "bcnops":
            add_atom(_Atom(_AROMATIC[ch], True))
            i += 1
        elif ch in _BOND_ORDER:
            if pending is not None:
                return None, None,"two bonds in a row"
            if prev is None:
                return None, None,"bond before any atom"
            pending = _BOND_ORDER[ch]
            i += 1
        elif ch.isdigit() or ch == "%":
            if branch_opened_here:
                # OpenSMILES: a branch is '(' [bond] chain ')' — ring-bond
                # digits belong to the branched_atom, never open a branch
                return None, None, "ring digit directly after '('"
            if ch == "%":
                if i + 2 >= n or not s[i + 1 : i + 3].isdigit():
                    return None, None,"bad %ring digits"
                digit, i = s[i + 1 : i + 3], i + 3
            else:
                digit, i = ch, i + 1
            err = close_ring(digit, pending)
            pending = None
            if err:
                return None, None,err
        elif ch == "(":
            if prev is None:
                return None, None,"branch before any atom"
            if pending is not None:
                return None, None,"bond before branch open"
            if branch_opened_here:
                # 'C((C)C)' — a branch cannot start with another branch
                # (round-3 review finding; RDKit/OpenSMILES reject it)
                return None, None, "branch directly after '('"
            stack.append(prev)
            branch_opened_here = True
            i += 1
        elif ch == ")":
            if not stack:
                return None, None,"unmatched ')'"
            if pending is not None:
                return None, None,"dangling bond at branch end"
            if branch_opened_here:
                return None, None,"empty branch"
            prev = stack.pop()
            i += 1
        elif ch == ".":
            if pending is not None:
                return None, None,"bond across dot"
            if prev is None:
                return None, None,"leading dot"
            if branch_opened_here:
                return None, None, "dot directly after '('"
            prev = None
            i += 1
        else:
            return None, None,f"unexpected character {ch!r}"

    if stack:
        return None, None,"unclosed branch"
    if pending is not None:
        return None, None,"dangling bond at end"
    if rings:
        return None, None,f"unclosed ring digit(s) {sorted(rings)}"
    if not atoms:
        return None, None,"no atoms"
    if prev is None:
        # prev is only None here when the final character was '.' —
        # OpenSMILES requires a chain after the dot ('CCO.' is invalid)
        return None, None, "trailing dot"
    for a in atoms:
        if not _valence_ok(a):
            return None, None, f"valence of {a.symbol} exceeded ({a.bond_sum}+{a.explicit_h}H)"
    return atoms, bonds, ""


def parse_smiles(s: str) -> Tuple[bool, str]:
    """Parse one SMILES string. Returns (ok, reason); reason is '' when ok."""
    atoms, _, reason = _parse(s)
    return atoms is not None, reason


def parse_graph(s: str) -> Optional[MolGraph]:
    """Parse one SMILES string into its molecular graph, or None if it is
    not chemically valid (same acceptance as `parse_smiles`)."""
    atoms, bonds, _ = _parse(s)
    if atoms is None:
        return None
    return MolGraph(
        atoms=tuple(
            (a.symbol, a.aromatic, a.charge, a.explicit_h if a.bracket else None)
            for a in atoms
        ),
        bonds=tuple(bonds),
    )


def chem_valid(s: str) -> bool:
    """True when ``s`` parses as chemically plausible SMILES (see module doc)."""
    return parse_smiles(s)[0]


def chem_valid_fraction(smiles: Iterable[str]) -> float:
    n = ok = 0
    for s in smiles:
        n += 1
        if chem_valid(s):
            ok += 1
    return ok / max(n, 1)
