"""The port's copy of the SMILES validity parser (molvax_torch/data/
smiles_check.py) against molvax/data/smiles_check.py: the same verdict and
reason on a molgen corpus, its mutations and hand-picked invalid strings."""

import numpy as np
import pytest

from molvax.data import smiles_check as jsc
from molvax.data.molgen import random_smiles
from molvax_torch.data import smiles_check as tsc

INVALID = [
    "", "C(", "C1CC", "C=", "(C)", "C((C)", "CC)C", "F=F", "O=O=O", "C1C1", "C((C)C)", "C(1CC1)",
    "CCO.", ".C", "C[", "[Xx]", "C%1", "C==C", "C(=)C", "CF(C)C", "c1cc", "C=1CC1", "C1CC=2",
    "[N+4](C)(C)(C)(C)(C)C", "C$C$C", "B(C)(C)(C)C",
]


def _corpus():
    base = random_smiles(200, seed=11) + [
        "CC(=O)Oc1ccccc1C(=O)O", "C[C@@H](N)C(=O)O", "O=[N+]([O-])c1ccccc1", "[NH4+]", "C%12CCCCC%12",
        "[13CH4]", "[Si](C)(C)C", "[se]1cccc1", "CC.CC", "ClC(Cl)(Cl)Cl", "[O-]C(=O)c1ccccc1",
    ]
    rng = np.random.default_rng(3)
    chars = sorted(set("".join(base)))
    mutated = []
    for s in base:
        s = list(s)
        for _ in range(int(rng.integers(1, 3))):
            i = int(rng.integers(len(s)))
            op = rng.random()
            if op < 0.4:
                s[i] = chars[int(rng.integers(len(chars)))]
            elif op < 0.7:
                s.insert(i, chars[int(rng.integers(len(chars)))])
            elif len(s) > 1:
                del s[i]
        mutated.append("".join(s))
    return base + mutated + INVALID


def test_parse_smiles_agrees_with_reference():
    corpus = _corpus()
    verdicts = [tsc.parse_smiles(s) for s in corpus]
    assert verdicts == [jsc.parse_smiles(s) for s in corpus]
    n_ok = sum(ok for ok, _ in verdicts)
    assert 150 < n_ok < len(corpus) - 100  # both kinds well represented
    assert tsc.chem_valid_fraction(corpus) == jsc.chem_valid_fraction(corpus)
    assert [tsc.chem_valid(s) for s in corpus] == [jsc.chem_valid(s) for s in corpus]


@pytest.mark.parametrize("smiles", ["CC(=O)Oc1ccccc1C(=O)O", "C1CC2CCC1CC2", "O=[N+]([O-])c1ccccc1", "CCO.", "C1C1"])
def test_parse_graph_agrees_with_reference(smiles):
    got, want = tsc.parse_graph(smiles), jsc.parse_graph(smiles)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.atoms == want.atoms and got.bonds == want.bonds and len(got) == len(want)
