"""The valence automaton in the port (molvax_torch/latent/constrain.py)
against molvax/latent/constrain.py, on the CPU.

The automaton is integer state and boolean logic, so the two agree exactly:
tables, every mask, every code and every ConState field at every step, on
random score walks (with a NaN row), on teacher codes of chem-valid,
mutated and invalid SMILES, and after the prefixes the reference's own unit
tests probe (tests/unit/test_constrain.py:179-315). Inputs are made with
numpy and handed to both packages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molvax.data.charset import Charset as JCharset, DEFAULT_CHARSET as J_CS
from molvax.data.featurize import encode_smiles as j_encode
from molvax.data.molgen import random_smiles
from molvax.kernels import automaton as jauto
from molvax.latent import constrain as jc
from molvax_torch.data.charset import Charset, DEFAULT_CHARSET
from molvax_torch.kernels import automaton as tauto
from molvax_torch.latent import constrain as tc

T = 40
# tests/unit/test_constrain.py:47 (REAL_SMILES)
REAL_SMILES = [
    "CC(=O)Oc1ccccc1C(=O)O", "CN1C=NC2=C1C(=O)N(C)C(=O)N2C", "Cn1cnc2c1c(=O)n(C)c(=O)n2C",
    "C[C@@H](N)C(=O)O", "C[N+](C)(C)C", "[O-]C(=O)c1ccccc1", "ClC(Cl)(Cl)Cl", "BrCCBr",
    "C1CC2CCC1CC2", "c1ccc2ccccc2c1", "C/C=C/C", "N#Cc1ccccc1", "CCS(=O)(=O)N",
    "O=[N+]([O-])c1ccccc1", "CC(C)(C)OC(=O)N1CCC(N)CC1", "FC(F)(F)c1ccccc1", "C1=CC=CC=C1",
    "CC1=CC(=O)C=CC1=O", "c1ccc(-c2ccccc2)cc1", "c1ccccc1Cc1ccccc1", "CC1CCCCC1C1CCCCC1",
    "O=C(c1ccccc1)c1ccc(N)cc1",
]


def _assert_state_equal(jst, tst, where):
    for name, a, b in zip(jst._fields, jst, tst):
        want = torch.bool if np.asarray(a).dtype == bool else torch.int32
        assert b.dtype == want, (where, name, b.dtype)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{where}: {name}")


@functools.lru_cache(maxsize=1)
def _j_select_advance():
    """The reference's select_advance, jitted once (tables closed over)."""
    jtb = jc.build_tables(J_CS)
    return jax.jit(lambda st, scores, rem: jauto.select_advance(jtb, st, scores, rem))


def _walk_scores(rows, steps, seed, nan_row=None):
    """Seeded scores tilted toward branches, rings, brackets and bonds, away
    from pad, so the walk reaches deep automaton states."""
    rng = np.random.default_rng(seed)
    s = 2.0 * rng.standard_normal((steps, rows, DEFAULT_CHARSET.size)).astype(np.float32)
    s[..., 0] -= 4.0
    for ch in "()123[]=#+-@H":
        s[..., DEFAULT_CHARSET.chars.index(ch)] += rng.random()
    if nan_row is not None:
        s[5, nan_row] = np.nan
    return s


def test_tables_are_the_reference_tables():
    jtb, ttb = jc.build_tables(J_CS), tc.build_tables(DEFAULT_CHARSET)
    assert ttb.n == jtb.n == 37
    for name in tauto._TAB_ROWS:
        got = getattr(ttb, name)
        assert got.dtype == (torch.int32 if name in ("atom_budget", "bond_order", "digit_val") else torch.bool)
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jtb, name)), err_msg=name)
    with pytest.raises(ValueError, match="needs 'C'"):
        tc.build_tables(Charset.from_list(["c", "1"]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_walks_match_reference_exactly(seed):
    """Mask -> first-argmax -> advance over T steps from the same scores:
    codes and every state field identical at every step; a NaN among the
    legal scores gives the pad code."""
    B = 12
    scores = _walk_scores(B, T, seed, nan_row=3)
    ttb = tc.build_tables(DEFAULT_CHARSET)
    jst, tst = jc.init_state(B, T), tc.init_state(B, T, device="cpu")
    _assert_state_equal(jst, tst, "init")
    j_step = _j_select_advance()
    for t in range(T):
        jst, jcode = j_step(jst, jnp.asarray(scores[t]), jnp.int32(T - 1 - t))
        tst, tcode = tauto.select_advance(ttb, tst, torch.from_numpy(scores[t]), T - 1 - t)
        assert tcode.dtype == torch.int32
        np.testing.assert_array_equal(tcode.numpy(), np.asarray(jcode), err_msg=f"step {t}")
        _assert_state_equal(jst, tst, f"step {t}")
    assert int(tst.n_atoms.max()) > 5 and int(tst.pn.max()) > 0  # rings closed somewhere
    assert bool(tst.esc[3]) and not bool(tst.esc[torch.arange(B) != 3].any())


def _mutations(smiles, seed):
    rng = np.random.default_rng(seed)
    chars = [c for c in DEFAULT_CHARSET.chars if c != " "]
    out = []
    for s in smiles:
        s = list(s)
        i = int(rng.integers(len(s)))
        if rng.random() < 0.5:
            s[i] = chars[int(rng.integers(len(chars)))]
        else:
            s.insert(i, chars[int(rng.integers(len(chars)))])
        out.append("".join(s))
    return out


def test_validate_codes_matches_reference_on_corpus():
    """Teacher codes of molgen and hand-written SMILES, their mutations, and
    strings the parser rejects: allowed-token matrix and closed flags equal
    to the reference's."""
    valid = [s for s in random_smiles(80, seed=7) + REAL_SMILES if len(s) < T]
    invalid = ["C(", "C1CC", "C=", "(C)", "C((C)", "CC)C", "F=F", "O=O=O", "C1C1", "C((C)C)", "C(1CC1)"]
    smiles = valid + _mutations(valid, seed=3) + invalid
    codes = j_encode(smiles, J_CS, T)
    j_ok, j_closed = jc.validate_codes(jnp.asarray(codes), J_CS, T)
    t_ok, t_closed = tc.validate_codes(torch.from_numpy(codes.astype(np.int64)), DEFAULT_CHARSET, T)
    assert t_ok.dtype == torch.bool and t_closed.dtype == torch.bool
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    np.testing.assert_array_equal(t_closed.numpy(), np.asarray(j_closed))
    accepted = (t_ok.all(1) & t_closed).numpy()
    assert accepted[: len(valid)].all()  # every valid string threads the automaton
    assert not accepted[-len(invalid):].any()


# the prefixes of tests/unit/test_constrain.py:179-315
PREFIXES = ["", "C", "B", "N", "Cl", "C1", "C=C", "CO", "CF", "C=", "N#C", "CC(", "CC(C", "C1CC", "CC",
            "C[", "C[n", "C[nH", "C[N+", "C[N++", "C1CC1C1CC", "C1CC11CC", "C12CC1C"]


def _masks_after(prefix, jcs, tcs, max_len, rem=None):
    jtb, ttb = jc.build_tables(jcs), tc.build_tables(tcs)
    jst, tst = jc.init_state(1, max_len), tc.init_state(1, max_len, device="cpu")
    for ch in prefix:
        idx = tcs.chars.index(ch)
        jst = jc.advance(jtb, jst, jnp.asarray([idx], jnp.int32))
        tst = tc.advance(ttb, tst, torch.tensor([idx], dtype=torch.int32))
    rem = max_len - len(prefix) - 1 if rem is None else rem
    return np.asarray(jc.step_mask_rem(jtb, jst, jnp.int32(rem))), tc.step_mask_rem(ttb, tst, rem).numpy()


@pytest.mark.parametrize("prefix", PREFIXES + ["dot:CCO.", "dot:CC|0"])
def test_masks_after_prefixes_match_reference(prefix):
    """The legal-token mask after each prefix the reference's unit tests
    probe; 'dot:' runs a charset with '.', '|0' asks at the final slot."""
    if prefix.startswith("dot:"):
        body, _, rem = prefix[4:].partition("|")
        chars = list(DEFAULT_CHARSET.chars) + ["."]
        j, t = _masks_after(body, JCharset.from_list(chars), Charset.from_list(chars), 24,
                            int(rem) if rem else None)
    else:
        j, t = _masks_after(prefix, J_CS, DEFAULT_CHARSET, T)
    np.testing.assert_array_equal(t, j)
    assert t.any()


def test_take_floors_negative_budgets():
    """_take computes w // c, which floors for negative w (JAX's //); the
    port writes floor division on purpose."""
    w = np.arange(-9, 10, dtype=np.int32)
    for h in ([0, 0, 0, 0], [1, 2, 0, 3], [5, 5, 5, 5]):
        hj = jnp.broadcast_to(jnp.asarray(h, jnp.int32), (w.size, 4))
        ht = torch.tensor(h, dtype=torch.int32).expand(w.size, 4)
        np.testing.assert_array_equal(
            tc._take(ht, torch.from_numpy(w)).numpy(), np.asarray(jc._take(hj, jnp.asarray(w)))
        )
    assert int(torch.div(torch.tensor(-3, dtype=torch.int32), 2, rounding_mode="floor")) == -2
