"""The ZINC grammar of the Grammar VAE: rules, tables, parser and derivation.

Kusner, Paige and Hernandez-Lobato, "Grammar Variational Autoencoder"
(ICML 2017, arXiv:1703.01925), ``zinc_grammar.py`` of its code: a
context-free grammar of SMILES in 76 production rules, start symbol
``smiles``, the last rule ``Nothing -> None`` (the padding rule). A
molecule is the leftmost derivation of its SMILES string, one rule a step,
padded to ``max_len`` steps with the padding rule; the model's one-hot is
over the rules, so a rule's index is its code.

Built from the rules:

  * ``lhs``: the nonterminal each rule expands (an index into
    ``nonterminals``, which lists the left-hand sides in order of first
    appearance, then ``class``, which appears on a right-hand side only);
  * ``masks``: (nonterminals x rules) bool, the rules of each nonterminal
    (none for ``class``);
  * ``parse``: a SMILES string -> its leftmost derivation, 'Cl', 'Br' and
    '@@' single terminals (the grammar is left-recursive, e.g. ``chain ->
    chain branched_atom``: the parser reads the string left to right and
    emits the derivation's rules in preorder);
  * ``derive``: a derivation -> its SMILES string (None where it stops
    before every nonterminal is expanded);
  * ``walk_table``: what the pushdown walk (``kernels/grammar_walk.py``)
    reads: each nonterminal's rules as the range [lo, hi) (the rules of a
    nonterminal are contiguous), each rule's right-hand side as symbol
    codes (a nonterminal j as j, terminal code k as NT + k - 1, -1 after
    the last), and the terminals as codes 1 .. 35 (0: none).

A nonterminal with no rule of its own (``class``) ends a derivation as
incomplete: its step and every later one take the padding rule, and the
row's string is empty. ``Grammar`` stands where a ``Charset`` stands
(``data/alphabet.py``): ``size`` (the rules), ``chars`` (the rules as text,
``grammar.json``), ``pad_index`` (the padding rule) and ``in`` (a terminal).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

# the rules in the order of zinc_grammar.py; a terminal is quoted
ZINC_RULES = """smiles -> chain
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

MAX_RHS = 4  # the longest right-hand side: branch -> '(' bond chain ')'

Rule = Tuple[str, Tuple[str, ...]]


def _read(text: str) -> Tuple[Rule, ...]:
    rules = []
    for line in text.splitlines():
        lhs, rhs = (part.strip() for part in line.split("->"))
        syms = tuple(s.replace("\\\\", "\\") for s in rhs.split() if s != "None")
        rules.append((lhs, syms))
    return tuple(rules)


def _is_terminal(sym: str) -> bool:
    return sym.startswith("'")


@dataclasses.dataclass(frozen=True)
class Grammar:
    name: str
    rules: Tuple[Rule, ...]

    # -- the tables ----------------------------------------------------------

    @functools.cached_property
    def nonterminals(self) -> Tuple[str, ...]:
        """Left-hand sides in order of first appearance, then the
        nonterminals that appear on a right-hand side only."""
        out = []
        for lhs, _ in self.rules:
            if lhs not in out:
                out.append(lhs)
        for _, rhs in self.rules:
            out += [s for s in rhs if not _is_terminal(s) and s not in out]
        return tuple(out)

    @functools.cached_property
    def terminals(self) -> Tuple[str, ...]:
        """The terminal strings in order of first appearance; terminal code
        k (1 ..) is ``terminals[k - 1]``."""
        out = []
        for _, rhs in self.rules:
            out += [s[1:-1] for s in rhs if _is_terminal(s) and s[1:-1] not in out]
        return tuple(out)

    @property
    def size(self) -> int:
        """The rules: the model's one-hot width."""
        return len(self.rules)

    @property
    def chars(self) -> Tuple[str, ...]:
        return tuple(f"{lhs} -> {' '.join(rhs) or 'None'}" for lhs, rhs in self.rules)

    @functools.cached_property
    def lhs(self) -> np.ndarray:
        index = {nt: i for i, nt in enumerate(self.nonterminals)}
        return np.array([index[lhs] for lhs, _ in self.rules], dtype=np.int64)

    @functools.cached_property
    def masks(self) -> np.ndarray:
        """(nonterminals, rules) bool: the rules of each nonterminal."""
        m = np.zeros((len(self.nonterminals), self.size), dtype=bool)
        m[self.lhs, np.arange(self.size)] = True
        return m

    @property
    def start(self) -> int:
        return self.nonterminals.index(self.rules[0][0])

    @property
    def pad_rule(self) -> int:
        """The padding rule (the last, ``Nothing -> None``)."""
        return self.size - 1

    pad_index = pad_rule  # the pad code, as ``Charset.pad_index``

    @property
    def nothing(self) -> int:
        """The nonterminal popped from an empty stack: the padding rule's."""
        return int(self.lhs[self.pad_rule])

    @functools.cached_property
    def rhs_codes(self) -> np.ndarray:
        """(rules, MAX_RHS) int32: each right-hand side's symbol codes (a
        nonterminal j as j, terminal code k as NT + k - 1), -1 after it."""
        nts, terms = self.nonterminals, self.terminals
        out = np.full((self.size, MAX_RHS), -1, dtype=np.int32)
        for r, (_, rhs) in enumerate(self.rules):
            for k, s in enumerate(rhs):
                out[r, k] = len(nts) + terms.index(s[1:-1]) if _is_terminal(s) else nts.index(s)
        return out

    @functools.cached_property
    def rule_ranges(self) -> np.ndarray:
        """(2, nonterminals) int32: each nonterminal's rules as [lo, hi)
        (lo = hi: none)."""
        lo = np.zeros(len(self.nonterminals), dtype=np.int32)
        hi = np.zeros(len(self.nonterminals), dtype=np.int32)
        for j in range(len(self.nonterminals)):
            idx = np.flatnonzero(self.masks[j])
            if len(idx):
                if idx[-1] - idx[0] + 1 != len(idx):
                    raise ValueError(f"{self.name}: the rules of {self.nonterminals[j]} are not contiguous")
                lo[j], hi[j] = idx[0], idx[-1] + 1
        return np.stack([lo, hi])

    def walk_table(self) -> np.ndarray:
        """int32 [lo (NT) | hi (NT) | rhs codes (rules x MAX_RHS)]: the pushdown walk's table."""
        return np.concatenate([self.rule_ranges.reshape(-1), self.rhs_codes.reshape(-1)]).astype(np.int32)

    @functools.cached_property
    def terminal_bytes(self) -> np.ndarray:
        """(1 + terminals, 2) uint8: terminal code -> its characters, 0-filled."""
        out = np.zeros((len(self.terminals) + 1, 2), dtype=np.uint8)
        for k, t in enumerate(self.terminals, start=1):
            out[k, : len(t)] = np.frombuffer(t.encode("ascii"), dtype=np.uint8)
        return out

    def tables(self, device) -> dict:
        """The tables on ``device``, made once a device: ``masks`` (NT, R)
        bool, ``lhs`` (R,) int64, ``walk`` (``walk_table``) int32. A train
        step or decode captured in a CUDA Graph reads them where they lie."""
        return _device_tables(self, torch.device(device))

    def __contains__(self, char: str) -> bool:
        return any(char in t for t in self.terminals)

    # -- strings <-> derivations -----------------------------------------------

    def _rule(self, lhs: str, *rhs: str) -> int:
        return self._index[(lhs, tuple(rhs))]

    @functools.cached_property
    def _index(self) -> dict:
        return {rule: i for i, rule in enumerate(self.rules)}

    def parse(self, smiles: str) -> List[int]:
        """The leftmost derivation of ``smiles`` as rule indices (its
        length, no padding); raises ValueError where the grammar does not
        derive it."""
        return _Parser(self, smiles).smiles()

    def encode(self, smiles: Union[str, Sequence[str]], max_len: int, strict: bool = True) -> Tuple[np.ndarray, int]:
        """(N, max_len) uint8 rule codes, each padded with the padding rule,
        and the count of strings dropped. A string whose derivation is longer
        than ``max_len`` or that does not parse raises under ``strict``;
        otherwise it is dropped and counted."""
        if isinstance(smiles, str):
            smiles = [smiles]
        rows, dropped = [], 0
        for s in smiles:
            try:
                prods = self.parse(s)
                if len(prods) > max_len:
                    raise ValueError(f"derivation of {len(prods)} steps > max_len={max_len}: {s!r}")
            except ValueError:
                if strict:
                    raise
                dropped += 1
                continue
            rows.append(prods + [self.pad_rule] * (max_len - len(prods)))
        return np.array(rows, dtype=np.uint8).reshape(len(rows), max_len), dropped

    def derive(self, prods: Sequence[int]) -> Optional[str]:
        """The string that the derivation ``prods`` derives: rules applied to
        the leftmost nonterminal in turn (the padding rule where none is
        left); None where a rule does not expand the leftmost nonterminal,
        or a nonterminal is left once the rules run out."""
        nts, terms = len(self.nonterminals), self.terminals
        stack, out = [self.start], []
        for p in prods:
            while stack and stack[-1] >= nts:
                out.append(terms[stack.pop() - nts])
            nt = stack.pop() if stack else self.nothing
            if self.lhs[p] != nt:
                return None
            stack += [int(s) for s in self.rhs_codes[p][::-1] if s >= 0]
        while stack and stack[-1] >= nts:
            out.append(terms[stack.pop() - nts])
        return None if stack else "".join(out)

    @functools.cached_property
    def _terminal_pairs(self) -> np.ndarray:
        """terminal code -> its two characters (0-filled) as one uint16."""
        return np.ascontiguousarray(self.terminal_bytes).view(np.uint16)[:, 0]

    def strings(self, terms: Union[np.ndarray, "object"]) -> List[str]:
        """(N, W) terminal codes, each row's in its first columns (0: none)
        -> strings: one table lookup of the columns in use, one compress of
        the characters into a single string, and a slice a row."""
        if not isinstance(terms, np.ndarray):
            terms = terms.cpu().numpy()
        used = int((terms != 0).any(axis=0).sum())
        chars = np.take(self._terminal_pairs, terms[:, :used]).view(np.uint8)  # (N, 2 used)
        keep = chars != 0
        flat = chars[keep].tobytes().decode("ascii")
        ends = np.cumsum(keep.sum(axis=1)).tolist()
        return [flat[a:b] for a, b in zip([0] + ends[:-1], ends)]


@functools.lru_cache(maxsize=None)
def _device_tables(grammar: Grammar, device: torch.device) -> dict:
    return {"masks": torch.from_numpy(grammar.masks).to(device), "lhs": torch.from_numpy(grammar.lhs).to(device),
            "walk": torch.from_numpy(grammar.walk_table()).to(device)}


class _Parser:
    """Recursive descent over the tokens of one string, emitting the rules
    of its leftmost derivation in preorder."""

    _MULTI = ("Cl", "Br", "@@")
    _ALIPHATIC = ("B", "C", "N", "O", "S", "P", "F", "I", "Cl", "Br")
    _AROMATIC = ("c", "n", "o", "s")
    _BONDS = ("-", "=", "#", "/", "\\")
    _DIGITS = tuple("12345678")

    def __init__(self, g: Grammar, s: str):
        self.g, self.s = g, s
        toks, i = [], 0
        while i < len(s):
            two = s[i:i + 2]
            tok = two if two in self._MULTI else s[i]
            if tok not in g.terminals:
                raise ValueError(f"{g.name}: {tok!r} is not a terminal of the grammar, in {s!r}")
            toks.append(tok)
            i += len(tok)
        self.toks, self.i = toks, 0

    def peek(self, k: int = 0) -> Optional[str]:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def take(self, want=None) -> str:
        tok = self.peek()
        if tok is None or (want is not None and tok not in want):
            raise ValueError(f"{self.g.name}: cannot parse {self.s!r} at token {self.i} ({tok!r})")
        self.i += 1
        return tok

    def r(self, lhs: str, *rhs: str) -> int:
        return self.g._rule(lhs, *rhs)

    def smiles(self) -> List[int]:
        out = [self.r("smiles", "chain")] + self.chain()
        if self.peek() is not None:
            self.take(())
        return out

    def chain(self) -> List[int]:
        elems = [(None, self.branched_atom())]
        while self.peek() is not None and self.peek() != ")":
            bond = self.bond() if self.peek() in self._BONDS else None
            elems.append((bond, self.branched_atom()))
        rules = [self.r("chain", "chain", "bond", "branched_atom") if b is not None
                 else self.r("chain", "chain", "branched_atom") for b, _ in reversed(elems[1:])]
        rules.append(self.r("chain", "branched_atom"))
        for b, atom in elems:
            rules += (b or []) + atom
        return rules

    def branched_atom(self) -> List[int]:
        atom = self.atom()
        rings = []
        while self.peek() in self._DIGITS or (self.peek() in self._BONDS and self.peek(1) in self._DIGITS):
            rings.append(self.ringbond())
        branches = []
        while self.peek() == "(":
            branches.append(self.branch())
        rb = self._left_list("RB", "ringbond", rings)
        bb = self._left_list("BB", "branch", branches)
        parts = ["atom"] + (["RB"] if rings else []) + (["BB"] if branches else [])
        return [self.r("branched_atom", *parts)] + atom + rb + bb

    def _left_list(self, name: str, item: str, items: List[List[int]]) -> List[int]:
        """``name -> name item | item`` over ``items``, in preorder."""
        if not items:
            return []
        out = [self.r(name, name, item)] * (len(items) - 1) + [self.r(name, item)]
        for it in items:
            out += it
        return out

    def ringbond(self) -> List[int]:
        if self.peek() in self._BONDS:
            bond = self.bond()
            return [self.r("ringbond", "bond", "DIGIT")] + bond + self.digit()
        return [self.r("ringbond", "DIGIT")] + self.digit()

    def branch(self) -> List[int]:
        self.take(("(",))
        bond = self.bond() if self.peek() in self._BONDS else None
        chain = self.chain()
        self.take((")",))
        if bond is None:
            return [self.r("branch", "'('", "chain", "')'")] + chain
        return [self.r("branch", "'('", "bond", "chain", "')'")] + bond + chain

    def bond(self) -> List[int]:
        return [self.r("bond", f"'{self.take(self._BONDS)}'")]

    def digit(self) -> List[int]:
        return [self.r("DIGIT", f"'{self.take(self._DIGITS)}'")]

    def organic(self, kind: str) -> List[int]:
        return [self.r(kind, f"'{self.take()}'")]

    def atom(self) -> List[int]:
        tok = self.peek()
        if tok == "[":
            return [self.r("atom", "bracket_atom")] + self.bracket_atom()
        if tok in self._ALIPHATIC:
            return [self.r("atom", "aliphatic_organic")] + self.organic("aliphatic_organic")
        if tok in self._AROMATIC:
            return [self.r("atom", "aromatic_organic")] + self.organic("aromatic_organic")
        self.take(())  # raises: no atom here

    def bracket_atom(self) -> List[int]:
        self.take(("[",))
        digits = []
        while self.peek() in self._DIGITS:
            digits += self.digit()
        if len(digits) > 3:
            self.take(())
        isotope = [self.r("isotope", *["DIGIT"] * len(digits))] + digits if digits else []
        if self.peek() in self._ALIPHATIC:
            symbol = [self.r("symbol", "aliphatic_organic")] + self.organic("aliphatic_organic")
        elif self.peek() in self._AROMATIC:
            symbol = [self.r("symbol", "aromatic_organic")] + self.organic("aromatic_organic")
        else:
            self.take(())
        bac = self.bac()
        self.take(("]",))
        parts = (["isotope"] if digits else []) + ["symbol"] + (["BAC"] if bac else [])
        return [self.r("bracket_atom", "'['", "BAI", "']'"), self.r("BAI", *parts)] + isotope + symbol + bac

    def bac(self) -> List[int]:
        chiral = [self.r("chiral", f"'{self.take()}'")] if self.peek() in ("@", "@@") else []
        hcount = []
        if self.peek() == "H":
            self.take()
            hcount = ([self.r("hcount", "'H'", "DIGIT")] + self.digit() if self.peek() in self._DIGITS
                      else [self.r("hcount", "'H'")])
        charge = []
        if self.peek() in ("-", "+"):
            sign = self.take()
            digits = []
            while self.peek() in self._DIGITS and len(digits) < 2:
                digits += self.digit()
            charge = [self.r("charge", f"'{sign}'", *["DIGIT"] * len(digits))] + digits
        bach = [self.r("BACH", "charge")] + charge if charge else []
        if hcount or bach:
            bah = [self.r("BAH", *(["hcount"] if hcount else []) + (["BACH"] if bach else []))] + hcount + bach
        else:
            bah = []
        if not chiral and not bah:
            return []
        return [self.r("BAC", *(["chiral"] if chiral else []) + (["BAH"] if bah else []))] + chiral + bah


ZINC_GRAMMAR = Grammar("zinc_grammar", _read(ZINC_RULES))
