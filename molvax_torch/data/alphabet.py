"""The alphabet: the table between a model's SMILES and its codes, characters
(``Charset``) or a grammar's rules (``Grammar``), as ``ModelConfig.alphabet``
says. This module alone answers which (``alphabet_of``), encodes and decodes
in it, loads a config's corpus and keeps the checkpoint's table; elsewhere
the question is asked only where the work differs (the decode route, the
grammar-masked loss, beam search's refusal)."""

from __future__ import annotations

import json
import os
import sys
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .charset import DEFAULT_CHARSET, Charset
from .featurize import decode_codes, encode_smiles
from .grammar import ZINC_GRAMMAR, Grammar
from .molgen import random_smiles
from .zinc import Dataset, load_dataset

Alphabet = Union[Charset, Grammar]


def alphabet_of(model_cfg, charset: Optional[Alphabet] = None) -> Alphabet:
    """The grammar ``model_cfg.alphabet`` names, whatever the caller holds;
    else ``charset`` (None: the default), as for no config at all."""
    name = getattr(model_cfg, "alphabet", "charset")
    if name == "charset":
        return DEFAULT_CHARSET if charset is None else charset
    if name == "zinc_grammar":
        return ZINC_GRAMMAR
    raise ValueError(f"unknown alphabet {name!r}; have ('charset', 'zinc_grammar')")


def encode(smiles: Union[str, Sequence[str]], cfg, charset: Optional[Alphabet] = None) -> np.ndarray:
    """SMILES -> (N, ``cfg.max_len``) uint8 codes, padded; ValueError where they do not fit."""
    alphabet = alphabet_of(cfg, charset)
    if isinstance(alphabet, Grammar):
        return alphabet.encode(smiles, cfg.max_len)[0]
    return encode_smiles(smiles, alphabet, cfg.max_len)


def strings(codes: Union[np.ndarray, torch.Tensor], cfg=None, charset: Optional[Alphabet] = None) -> List[str]:
    """(N, T) codes -> strings. Rule codes give what each row derives, ""
    where it ends incomplete, as the pushdown walk's terminal codes do."""
    alphabet = alphabet_of(cfg, charset)
    if not isinstance(alphabet, Grammar):
        return decode_codes(codes, alphabet)
    rows = np.atleast_2d(codes.cpu().numpy() if isinstance(codes, torch.Tensor) else np.asarray(codes))
    # the padding rule changes nothing after a complete derivation: drop the tail
    live = rows.shape[1] - np.argmax(rows[:, ::-1] != alphabet.pad_rule, axis=1)
    return [alphabet.derive(row[:n]) or "" for row, n in zip(rows.tolist(), live.tolist())]


def grammar_dataset(grammar: Grammar, source: str, max_len: int, n: int, seed: int = 0) -> Dataset:
    """The synthetic chemistry corpus or a SMILES file as derivations padded
    to ``max_len``; rows that do not parse or fit are dropped and counted."""
    if source in ("synthetic", "synthetic_chem"):
        smiles = random_smiles(n, seed=seed)
    elif os.path.exists(source):
        with open(source) as f:
            smiles = [line.split()[0].split(",")[0] for line in f if line.strip()]
    else:
        raise FileNotFoundError(f"dataset source {source!r} not found (use 'synthetic_chem' for the offline corpus)")
    codes, dropped = grammar.encode(smiles, max_len, strict=False)
    if dropped:
        print(f"[molvax_torch] {grammar.name}: dropped {dropped} of {len(smiles)} rows (no parse, or a derivation "
              f"longer than {max_len})", file=sys.stderr)
    return Dataset(codes=codes, charset=grammar)


def corpus(cfg, with_properties: bool = False) -> Dataset:
    """The corpus ``cfg.data`` names, in ``cfg.model``'s alphabet."""
    alphabet = alphabet_of(cfg.model)
    if isinstance(alphabet, Grammar):
        return grammar_dataset(alphabet, cfg.data.source, cfg.model.max_len, cfg.data.n_synthetic, cfg.data.seed)
    return load_dataset(cfg.data.source, max_len=cfg.data.max_len, synthetic_n=cfg.data.n_synthetic,
                        seed=cfg.data.seed, with_properties=with_properties, property_source=cfg.data.property_source)


def _table_path(directory: str, alphabet: Alphabet) -> str:
    return os.path.join(directory, "grammar.json" if isinstance(alphabet, Grammar) else "charset.json")


def write_table(directory: str, alphabet: Alphabet) -> None:
    """The table a model trains on, beside its checkpoints: a JSON list in code order."""
    with open(_table_path(directory, alphabet), "w") as f:
        json.dump(list(alphabet.chars), f)


def read_table(directory: str, model_cfg) -> Alphabet:
    """A checkpoint directory's table: the characters of its ``charset.json``
    (none: the default), or the grammar, which its ``grammar.json`` must list."""
    alphabet = alphabet_of(model_cfg)
    path = _table_path(directory, alphabet)
    if not os.path.exists(path):
        return alphabet
    with open(path) as f:
        chars = tuple(json.load(f))
    if not isinstance(alphabet, Grammar):
        return Charset(chars=chars)
    if chars != alphabet.chars:
        raise ValueError(f"{path}: the checkpoint's rules are not those of {alphabet.name}")
    return alphabet
