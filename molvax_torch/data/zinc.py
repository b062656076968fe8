"""Dataset loading: chemvae-format .h5, plain text SMILES, synthetic corpus.

The port's own copy of ``molvax/data/zinc.py`` (numpy only; ``h5py`` is
imported where an .h5 file is read or written). Whatever the source,
datasets normalize to compact (N, T) uint8 code arrays on the host; the
one-hot is made on the device (``featurize.one_hot``). The chemvae .h5
layout (keys ``data_train`` / ``data_test`` / ``charset``) loads as it is,
so real ZINC-250k / MOSES exports work unchanged.

No ZINC / MOSES file ships with the repo, so a deterministic synthetic
SMILES corpus stands in for tests and benchmarks (the reference's headline
measurement trains on ``synthetic_dataset(4096, max_len=120, seed=0)``);
the loaders take real files where they exist. ``tests/test_torch_data.py``
holds every corpus, split and property target to the reference's, byte for
byte.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

from .charset import Charset, DEFAULT_CHARSET
from .featurize import encode_smiles  # noqa: F401 (re-export for callers)
from .native import encode_smiles_native


@dataclasses.dataclass
class Dataset:
    """Host-resident dataset of encoded SMILES (+ optional property targets)."""

    codes: np.ndarray  # (N, T) uint8
    charset: Charset
    properties: Optional[np.ndarray] = None  # (N, P) float32 (logP/QED/SAS)

    def __len__(self) -> int:
        return self.codes.shape[0]

    @property
    def max_len(self) -> int:
        return self.codes.shape[1]

    def split(self, test_fraction: float = 0.1, seed: int = 0) -> Tuple["Dataset", "Dataset"]:
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(self))
        # never floor a requested holdout to 0 rows (evaluate --holdout on a
        # smoke corpus would otherwise run metrics on an empty split)
        n_test = int(len(self) * test_fraction)
        if test_fraction > 0 and n_test == 0 and len(self) >= 2:
            n_test = 1
        te, tr = perm[:n_test], perm[n_test:]
        props = self.properties
        return (
            Dataset(self.codes[tr], self.charset, None if props is None else props[tr]),
            Dataset(self.codes[te], self.charset, None if props is None else props[te]),
        )


# --------------------------------------------------------------------------
# chemvae .h5 export (data_train / data_test / charset), one-hot float inside
# --------------------------------------------------------------------------

def load_h5(path: str, key: str = "data_train") -> Dataset:
    """Load a chemvae-style .h5 export. The file stores (N, 120, C) one-hot;
    we immediately collapse to uint8 codes (argmax over C) - the inverse is
    exact because rows are one-hot. A ``properties_<split>`` dataset (this
    repo's export extension) restores precomputed property targets, so the
    minutes-scale descriptor pass over a MOSES-sized corpus runs once at
    export time, not on every training run."""
    import h5py

    with h5py.File(path, "r") as f:
        charset = Charset.from_list(list(f["charset"][:]))
        data = f[key]
        # Stream in chunks to avoid materializing N*120*C floats at once.
        n = data.shape[0]
        codes = np.empty((n, data.shape[1]), dtype=np.uint8)
        step = max(1, (1 << 26) // max(1, data.shape[1] * data.shape[2]))
        for i in range(0, n, step):
            codes[i : i + step] = np.argmax(data[i : i + step], axis=-1)
        prop_key = key.replace("data_", "properties_")
        props = np.asarray(f[prop_key][:], np.float32) if prop_key in f else None
    return Dataset(codes=codes, charset=charset, properties=props)


def export_h5(dataset: Dataset, path: str, test_fraction: float = 0.1, seed: int = 0) -> None:
    """Write a chemvae-format .h5 (data_train / data_test one-hot float32 +
    charset), byte-compatible with the reference's expected export
    (SURVEY.md 2.8, 3.5) - molvax datasets round-trip into the original
    PyTorch tooling. Property targets, when the dataset carries them, are
    written as ``properties_train``/``properties_test`` (an additive
    extension: readers that only know the reference keys ignore them)."""
    import h5py

    train, test = dataset.split(test_fraction, seed)
    eye = np.eye(dataset.charset.size, dtype=np.float32)
    with h5py.File(path, "w") as f:
        f.create_dataset("data_train", data=eye[train.codes])
        f.create_dataset("data_test", data=eye[test.codes])
        f.create_dataset(
            "charset", data=np.array([c.encode() for c in dataset.charset.chars])
        )
        if dataset.properties is not None:
            f.create_dataset(
                "properties_train", data=np.asarray(train.properties, np.float32)
            )
            f.create_dataset(
                "properties_test", data=np.asarray(test.properties, np.float32)
            )


def load_smiles_file(
    path: str,
    charset: Optional[Charset] = None,
    max_len: int = 120,
) -> Dataset:
    """Load a .smi/.txt/.csv file of SMILES (first whitespace/comma token per
    line; header lines that aren't valid SMILES are skipped)."""
    smiles: List[str] = []
    with open(path) as f:
        for line in f:
            tok = line.strip().split(",")[0].split()
            if not tok:
                continue
            s = tok[0]
            if s.lower() in ("smiles", "canonical_smiles"):
                continue
            if len(s) <= max_len:
                smiles.append(s)
    cs = charset or Charset.from_corpus(smiles)
    return Dataset(codes=encode_smiles_native(smiles, cs, max_len), charset=cs)


# --------------------------------------------------------------------------
# Synthetic corpus (offline stand-in for ZINC-250k / MOSES)
# --------------------------------------------------------------------------

_ATOMS = ["C", "C", "C", "C", "N", "N", "O", "O", "S", "F", "Cl", "Br"]
_AROM = ["c", "c", "c", "n", "o", "s"]
_BONDS = ["", "", "", "", "=", "#"]


def _random_chain(rng: np.random.Generator, budget: int, depth: int = 0) -> str:
    """Grammar-valid SMILES-like fragment: balanced branches, paired ring
    digits, plausible char distribution. Not chemically validated (no RDKit
    offline) - sufficient for training-dynamics and throughput work."""
    out: List[str] = []
    n = int(rng.integers(3, max(4, budget)))
    ring_open: List[str] = []
    for _ in range(n):
        if rng.random() < 0.25:
            out.append(_BONDS[rng.integers(0, len(_BONDS))])
        if rng.random() < 0.3:
            out.append(_AROM[rng.integers(0, len(_AROM))])
        else:
            out.append(_ATOMS[rng.integers(0, len(_ATOMS))])
        # ring digits, opened and closed in pairs
        if ring_open and rng.random() < 0.3:
            out.append(ring_open.pop())
        elif len(ring_open) < 4 and rng.random() < 0.15:
            d = str(rng.integers(1, 9))
            if d not in ring_open:
                ring_open.append(d)
                out.append(d)
        # branch
        if depth < 3 and budget > 8 and rng.random() < 0.2:
            out.append("(" + _random_chain(rng, budget // 2, depth + 1) + ")")
    while ring_open:
        out.append(ring_open.pop())
    return "".join(out)


_SUB_CLASSES = [set("CNOSF"), set("cnos")]


def _mutate(s: str, rng: np.random.Generator, rate: float) -> str:
    """Substitute atom chars within their class (grammar-preserving: ring
    digits, branches, brackets, and Cl/Br pairs untouched)."""
    chars = list(s)
    for i, c in enumerate(chars):
        if rng.random() >= rate:
            continue
        if i + 1 < len(chars) and chars[i + 1] in ("l", "r"):
            continue  # keep Cl/Br intact
        for cls in _SUB_CLASSES:
            if c in cls:
                chars[i] = rng.choice(sorted(cls - {c}))
                break
    return "".join(chars)


def synthetic_smiles(
    n: int,
    seed: int = 0,
    max_len: int = 118,
    min_len: int = 8,
    mode: str = "templates",
    n_templates: Optional[int] = None,
    mutation_rate: float = 0.03,
) -> List[str]:
    """Deterministic synthetic SMILES corpus.

    mode='templates' (default): a pool of distinct skeletons, each emitted
    with small atom-class mutations - mirrors a natural corpus's statistical
    redundancy (real ZINC SMILES are highly predictable character-by-
    character; a maximum-entropy random corpus would cap teacher-forced
    accuracy far below the BASELINE targets through no fault of the model).
    mode='random': every string an independent random chain (worst case for
    the decoder; used for featurizer stress tests)."""
    rng = np.random.default_rng(seed)

    def chain() -> str:
        while True:
            s = _random_chain(rng, int(rng.integers(6, 26)))
            if min_len <= len(s) <= max_len:
                return s

    if mode == "random":
        return [chain() for _ in range(n)]
    k = n_templates or max(20, min(n // 50, 2000))
    templates = [chain() for _ in range(min(k, n))]
    return [
        _mutate(templates[int(rng.integers(0, len(templates)))], rng, mutation_rate)
        for _ in range(n)
    ]


def synthetic_dataset(
    n: int,
    charset: Charset = DEFAULT_CHARSET,
    max_len: int = 120,
    seed: int = 0,
    with_properties: bool = False,
    chem: bool = False,
    property_source: str = "auto",
) -> Dataset:
    """``chem=True`` draws from `molgen.random_smiles` — every sample is a
    chemically valid molecule (parser-verified by construction), so the
    ``*_chem_valid`` evaluation metrics are meaningful. Default stays the
    grammar-level corpus for round-1/2 metric continuity."""
    if chem:
        from .molgen import random_smiles

        smiles = random_smiles(n, seed=seed, max_len=max_len - 2)
    else:
        smiles = synthetic_smiles(n, seed=seed, max_len=max_len - 2)
    codes = encode_smiles_native(smiles, charset, max_len)
    props = None
    if with_properties:
        props = property_targets(smiles, codes, charset, property_source)
    return Dataset(codes=codes, charset=charset, properties=props)


def property_targets(
    smiles: Optional[List[str]],
    codes: np.ndarray,
    charset: Charset,
    mode: str = "auto",
) -> np.ndarray:
    """(N, 3) float32 logP/QED/SAS targets for the property head.

    mode='computed': real structure-level descriptors on the parsed
    molecular graph (`data/properties.py` — Crippen-style fitted logP,
    QED-style drug-likeness, SAS-style complexity); unparseable rows get
    the column means. mode='surrogate': the round-1/2 composition
    surrogates. mode='auto' (default): computed when at least half the
    corpus parses chemically (the chem corpus and real ZINC/MOSES files),
    surrogate otherwise (the grammar-level corpus, where structural
    descriptors are undefined).

    ``smiles=None`` decodes strings from ``codes`` on demand — only the
    non-surrogate branches pay the O(N·max_len) decode."""
    if mode == "surrogate":
        return surrogate_properties(codes, charset)
    if smiles is None:
        from .featurize import decode_codes

        smiles = decode_codes(codes, charset)
    from .properties import computed_properties

    if mode == "auto" and len(smiles) > 2000:
        # decide the parse-fraction gate on a sample first: running the
        # full parse+descriptor pass over a grammar-level corpus (up to
        # 1.9M rows at MOSES scale) only to throw the result away made the
        # surrogate fallback pay the computed path's whole cost
        _, mask_s = computed_properties(smiles[:1000])
        if len(mask_s) == 0 or float(mask_s.mean()) < 0.5:
            return surrogate_properties(codes, charset)
    props, mask = computed_properties(smiles)
    if mode == "computed" or (len(mask) > 0 and float(mask.mean()) >= 0.5):
        return props
    return surrogate_properties(codes, charset)


def surrogate_properties(codes: np.ndarray, charset: Charset) -> np.ndarray:
    """Cheap logP/QED/SAS-like surrogate targets computed from composition
    (no RDKit offline; SURVEY.md section 7). Deterministic functions of the
    string so the property head has real signal to regress:
      p0 ~ 'logP': carbon fraction minus heteroatom fraction, scaled
      p1 ~ 'QED' : ring/branch balance squashed to (0, 1)
      p2 ~ 'SAS' : length + branching complexity, roughly 1..10
    """
    idx = charset.to_index()

    def count(codes_row, chars):
        ids = [idx[c] for c in chars if c in idx]
        return np.isin(codes_row, ids).sum(axis=-1)

    length = (codes != charset.pad_index).sum(axis=-1).astype(np.float32)
    length = np.maximum(length, 1.0)
    carbons = count(codes, ["C", "c"]).astype(np.float32)
    hetero = count(codes, ["N", "O", "S", "n", "o", "s", "F", "l", "r"]).astype(np.float32)
    rings = count(codes, ["1", "2", "3", "4", "5", "6", "7", "8", "9"]).astype(np.float32)
    branches = count(codes, ["("]).astype(np.float32)
    double = count(codes, ["=", "#"]).astype(np.float32)

    logp = 5.0 * (carbons / length) - 4.0 * (hetero / length) + 0.3 * double / length
    qed = 1.0 / (1.0 + np.exp(-(rings - branches) / 2.0))
    sas = 1.0 + 9.0 * np.tanh(length / 80.0 + branches / 10.0)
    return np.stack([logp, qed, sas], axis=-1).astype(np.float32)


def load_dataset(
    source: str,
    charset: Optional[Charset] = None,
    max_len: int = 120,
    synthetic_n: int = 5000,
    seed: int = 0,
    with_properties: bool = False,
    property_source: str = "auto",
) -> Dataset:
    """Dispatch on source: 'synthetic' | 'synthetic_chem' | path.h5 |
    path.{smi,txt,csv}. 'synthetic_chem' is the chemically-valid offline
    corpus (data/molgen.py)."""
    if source not in ("synthetic", "synthetic_chem") and not os.path.exists(source):
        raise FileNotFoundError(
            f"dataset source {source!r} not found (use 'synthetic' or "
            "'synthetic_chem' for the offline corpora)"
        )
    if source in ("synthetic", "synthetic_chem"):
        return synthetic_dataset(
            synthetic_n,
            charset or DEFAULT_CHARSET,
            max_len,
            seed,
            with_properties=with_properties,
            chem=source == "synthetic_chem",
            property_source=property_source,
        )
    if source.endswith((".h5", ".hdf5")):
        ds = load_h5(source)
    else:
        ds = load_smiles_file(source, charset, max_len)
    if with_properties and ds.properties is None:
        ds.properties = property_targets(
            None, ds.codes, ds.charset, property_source
        )
    return ds
