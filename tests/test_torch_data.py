"""The port's data layer against molvax.data, on the CPU: the synthetic
corpora, the chemically valid generator, the property targets, the native
tokenizer and its numpy path, splits, the .h5 and .smi round trips, and
featurization. Every copy must give the reference's bytes on the same
seeds (the reference's headline corpus is ``synthetic_dataset(4096,
max_len=120, seed=0)``). Mirrors tests/unit/test_data.py, test_molgen.py,
test_properties.py, test_native.py and test_featurize.py."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molvax.data import featurize as jfeat
from molvax.data import molgen as jmolgen
from molvax.data import native as jnative
from molvax.data import properties as jprops
from molvax.data import zinc as jzinc
from molvax.data.charset import Charset as JCharset
from molvax_torch import data as tdata
from molvax_torch.data import featurize as tfeat
from molvax_torch.data import molgen as tmolgen
from molvax_torch.data import native as tnative
from molvax_torch.data import properties as tprops
from molvax_torch.data import zinc as tzinc

ROOT = Path(__file__).resolve().parent.parent

# molecules of tests/unit/test_properties.py: rings, aromatics, charges,
# brackets, halogens, alerts, and strings that do not parse
MOLECULES = ["CCO", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O", "c1ccncc1", "c1cc[nH]c1", "C1CCCCC1", "CN(C)C=O",
             "ClC(Cl)(Cl)C(Cl)Cl", "CCCCCCCCCC", "O=C(O)c1ccccc1O", "CC(C)Cc1ccc(C(C)C(=O)O)cc1",
             "[NH4+]", "C[N+](C)(C)C", "OC1=CC=CC=C1", "not_smiles((", "", "))((", "c1ccc2ccccc2c1"]


def _charset(tcs):
    return JCharset(tcs.chars) if tcs is not None else None


# -- the corpora ----------------------------------------------------------------


@pytest.mark.parametrize("mode", ["templates", "random"])
@pytest.mark.parametrize("n,seed", [(50, 3), (700, 0), (4096, 1)])
def test_synthetic_smiles_equal_reference(mode, n, seed):
    assert tzinc.synthetic_smiles(n, seed=seed, mode=mode) == jzinc.synthetic_smiles(n, seed=seed, mode=mode)


@pytest.mark.parametrize("chem", [False, True])
@pytest.mark.parametrize("n,seed,max_len", [(100, 1, 120), (4096, 0, 120), (333, 7, 60)])
def test_synthetic_dataset_codes_byte_identical(chem, n, seed, max_len):
    """The corpus, codes byte for byte, in both modes; n = 4096, seed 0 is
    the reference's headline training corpus."""
    got = tzinc.synthetic_dataset(n, max_len=max_len, seed=seed, chem=chem)
    want = jzinc.synthetic_dataset(n, max_len=max_len, seed=seed, chem=chem)
    assert got.codes.dtype == np.uint8 and got.codes.shape == (n, max_len)
    assert got.codes.tobytes() == want.codes.tobytes()
    assert got.charset.chars == want.charset.chars and got.properties is None


@pytest.mark.parametrize("seed,max_len,min_len", [(3, 100, 8), (0, 118, 8), (11, 40, 4)])
def test_random_smiles_equal_reference(seed, max_len, min_len):
    got = tmolgen.random_smiles(300, seed=seed, max_len=max_len, min_len=min_len)
    assert got == jmolgen.random_smiles(300, seed=seed, max_len=max_len, min_len=min_len)
    assert all(min_len <= len(s) <= max_len for s in got)
    assert all(tdata.chem_valid(s) for s in got)


def test_random_molecule_and_writer_equal_reference():
    a, b = np.random.default_rng(42), np.random.default_rng(42)
    for _ in range(100):
        assert tmolgen.write_smiles(tmolgen.random_molecule(a), a) == jmolgen.write_smiles(jmolgen.random_molecule(b), b)


# -- property targets ---------------------------------------------------------


@pytest.mark.parametrize("chem", [False, True])
@pytest.mark.parametrize("source", ["auto", "computed", "surrogate"])
def test_property_targets_equal_reference(chem, source):
    got = tzinc.synthetic_dataset(600, max_len=120, seed=5, chem=chem, with_properties=True, property_source=source)
    want = jzinc.synthetic_dataset(600, max_len=120, seed=5, chem=chem, with_properties=True, property_source=source)
    assert got.properties.dtype == np.float32 and got.properties.shape == (600, 3)
    assert got.properties.tobytes() == want.properties.tobytes()


def test_auto_targets_decide_on_a_sample_as_the_reference():
    """Past 2,000 rows 'auto' decides on the first 1,000 strings."""
    smiles = jzinc.synthetic_smiles(2500, seed=2)
    codes = tzinc.encode_smiles_native(smiles)
    got = tzinc.property_targets(None, codes, tdata.DEFAULT_CHARSET, "auto")
    want = jzinc.property_targets(None, codes, jzinc.DEFAULT_CHARSET, "auto")
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(got, tzinc.surrogate_properties(codes, tdata.DEFAULT_CHARSET))


def test_computed_properties_and_descriptors_equal_reference():
    got, got_mask = tprops.computed_properties(MOLECULES)
    want, want_mask = jprops.computed_properties(MOLECULES)
    assert got.tobytes() == want.tobytes() and np.array_equal(got_mask, want_mask)
    for s in MOLECULES:
        assert tprops.properties_of(s) == jprops.properties_of(s), s
        g_t, g_j = tdata.parse_graph(s), jprops.parse_graph(s)
        assert (g_t is None) == (g_j is None), s
        if g_t is not None:
            assert dataclasses.astuple(tprops.descriptors(g_t)) == dataclasses.astuple(jprops.descriptors(g_j)), s


def test_surrogate_properties_equal_reference():
    codes = jzinc.synthetic_dataset(200, seed=4).codes
    got = tzinc.surrogate_properties(codes, tdata.DEFAULT_CHARSET)
    assert got.tobytes() == jzinc.surrogate_properties(codes, jzinc.DEFAULT_CHARSET).tobytes()


# -- splits and files ------------------------------------------------------------


@pytest.mark.parametrize("n,fraction,seed", [(100, 0.2, 0), (16, 0.05, 0), (600, 0.1, 3), (2, 0.0, 1)])
def test_split_equal_reference(n, fraction, seed):
    ds_t = tzinc.synthetic_dataset(n, max_len=48, seed=seed, with_properties=True)
    ds_j = jzinc.synthetic_dataset(n, max_len=48, seed=seed, with_properties=True)
    for a, b in zip(ds_t.split(fraction, seed), ds_j.split(fraction, seed)):
        assert a.codes.tobytes() == b.codes.tobytes()
        assert a.properties.tobytes() == b.properties.tobytes()
    if fraction > 0 and n >= 2:
        assert len(ds_t.split(fraction, seed)[1]) >= 1


@pytest.mark.parametrize("with_properties", [False, True])
def test_h5_round_trip_with_the_reference(tmp_path, with_properties):
    """Each package reads what the other writes: the chemvae layout, the
    charset, and the property extension."""
    pytest.importorskip("h5py")
    ds_t = tzinc.synthetic_dataset(40, max_len=48, seed=0, with_properties=with_properties)
    ds_j = jzinc.synthetic_dataset(40, max_len=48, seed=0, with_properties=with_properties)
    pt, pj = str(tmp_path / "port.h5"), str(tmp_path / "ref.h5")
    tzinc.export_h5(ds_t, pt, test_fraction=0.25, seed=0)
    jzinc.export_h5(ds_j, pj, test_fraction=0.25, seed=0)
    for key in ("data_train", "data_test"):
        for a, b in ((tzinc.load_h5(pt, key), jzinc.load_h5(pt, key)), (tzinc.load_h5(pj, key), jzinc.load_h5(pt, key))):
            assert a.codes.tobytes() == b.codes.tobytes() and a.charset.chars == b.charset.chars
            assert (a.properties is None) == (not with_properties)
            if with_properties:
                assert a.properties.tobytes() == b.properties.tobytes()


def test_smiles_file_loader_equal_reference(tmp_path):
    p = tmp_path / "mols.smi"
    p.write_text("smiles name\nCCO ethanol\nc1ccccc1 benzene\nCC(=O)N,0.5\n\n" + "C" * 70 + "\nBrc1ccccc1\n")
    for charset in (None, tdata.DEFAULT_CHARSET):
        got = tzinc.load_smiles_file(str(p), charset, max_len=60)
        want = jzinc.load_smiles_file(str(p), _charset(charset), max_len=60)
        assert got.codes.tobytes() == want.codes.tobytes() and got.charset.chars == want.charset.chars
    assert tdata.decode_codes(got.codes, got.charset) == ["CCO", "c1ccccc1", "CC(=O)N", "Brc1ccccc1"]


def test_load_dataset_dispatch_equal_reference(tmp_path):
    for source in ("synthetic", "synthetic_chem"):
        got = tzinc.load_dataset(source, synthetic_n=64, seed=2, with_properties=True)
        want = jzinc.load_dataset(source, synthetic_n=64, seed=2, with_properties=True)
        assert got.codes.tobytes() == want.codes.tobytes()
        assert got.properties.tobytes() == want.properties.tobytes()
    p = tmp_path / "m.smi"
    p.write_text("CCO\nCCN\n")
    got = tzinc.load_dataset(str(p), with_properties=True)
    assert got.properties.tobytes() == jzinc.load_dataset(str(p), with_properties=True).properties.tobytes()
    with pytest.raises(FileNotFoundError):
        tzinc.load_dataset(str(tmp_path / "missing.h5"))


# -- the native tokenizer ------------------------------------------------------------


def _numpy_path(monkeypatch):
    monkeypatch.setattr(tnative, "get_lib", lambda: None)


def test_native_tokenizer_builds_wherever_g_plus_plus_is():
    if subprocess.run(["sh", "-c", "command -v g++"], capture_output=True).returncode == 0:
        assert tnative.native_available()
        assert tnative.library_path().parent == ROOT / "build" / "tokenizer"


@pytest.mark.parametrize("n,seed", [(2000, 0), (20000, 3)])
def test_native_encode_matches_numpy_and_reference(n, seed):
    smiles = tzinc.synthetic_smiles(n, seed=seed)
    got = tnative.encode_smiles_native(smiles, max_len=120)
    assert got.tobytes() == tfeat.encode_smiles(smiles, max_len=120).tobytes()
    assert got.tobytes() == jnative.encode_smiles_native(smiles, max_len=120).tobytes()


def test_native_decode_and_valid_fraction_match_numpy():
    smiles = tzinc.synthetic_smiles(500, seed=1) + ["CC(O", "CC)O", "C[N+]"]
    codes = tfeat.encode_smiles(smiles, max_len=120)
    assert tnative.decode_codes_native(codes) == tfeat.decode_codes(codes) == smiles
    assert tnative.valid_fraction_native(codes) == pytest.approx(tfeat.valid_fraction(smiles))
    assert tnative.valid_fraction_native(codes) == pytest.approx(jnative.valid_fraction_native(codes))


def test_native_strict_and_truncation():
    with pytest.raises(ValueError):
        tnative.encode_smiles_native(["CC?"], max_len=10, strict=True)
    out = tnative.encode_smiles_native(["C" * 300], max_len=10, strict=False)
    assert out.shape == (1, 10) and (out != tdata.DEFAULT_CHARSET.pad_index).all()


def test_numpy_path_gives_the_native_bytes(monkeypatch):
    smiles = tzinc.synthetic_smiles(300, seed=4) + ["CC(O"]
    native = tnative.encode_smiles_native(smiles, max_len=120)
    strings = tnative.decode_codes_native(native)
    frac = tnative.valid_fraction_native(native)
    _numpy_path(monkeypatch)
    assert tnative.encode_smiles_native(smiles, max_len=120).tobytes() == native.tobytes()
    assert tnative.decode_codes_native(native) == strings
    assert tnative.valid_fraction_native(native) == pytest.approx(frac)
    assert tzinc.synthetic_dataset(64, seed=0).codes.tobytes() == jzinc.synthetic_dataset(64, seed=0).codes.tobytes()


def test_concurrent_first_builds_make_one_library(tmp_path):
    """Six processes build the tokenizer at once into an empty directory:
    each loads a working library, one file is left and no temporary."""
    code = (
        "import sys, numpy as np\n"
        "from pathlib import Path\n"
        "from molvax_torch.data import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "lib = native.get_lib()\n"
        "assert lib is not None\n"
        "out = native.encode_smiles_native(['CCO', 'c1ccccc1'], max_len=12)\n"
        "assert out.shape == (2, 12) and out[0, 0] != 0\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 and o.strip() == "ok" for p, (o, _) in zip(procs, outs)), outs
    names = sorted(f.name for f in tmp_path.iterdir())
    assert [n for n in names if n.endswith(".so")] == [tnative.library_path().name]
    assert not [n for n in names if ".tmp" in n]


# -- featurization ------------------------------------------------------------------


def test_featurize_round_trips_equal_reference():
    smiles = ["CCO", "c1ccccc1", "CC(=O)Nc1ccc(O)cc1", "Brc1ccccc1Cl"]
    x = tfeat.smiles_to_one_hot(smiles, max_len=40, device="cpu")
    want = np.asarray(jfeat.smiles_to_one_hot(smiles, max_len=40))
    assert x.shape == (4, 40, tdata.DEFAULT_CHARSET.size) and x.dtype == torch.float32
    np.testing.assert_array_equal(x.numpy(), want)
    assert tfeat.one_hot_to_smiles(x) == jfeat.one_hot_to_smiles(jnp.asarray(want)) == smiles


def test_argmax_codes_equal_reference_with_ties():
    rng = np.random.default_rng(0)
    logits = rng.integers(0, 3, (5, 12, 7)).astype(np.float32)  # many ties: the first maximum wins
    got = tfeat.argmax_codes(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfeat.argmax_codes(jnp.asarray(logits))))


def test_grammar_validity_equal_reference():
    corpus = tzinc.synthetic_smiles(200, seed=6, mode="random")
    rng = np.random.default_rng(1)
    mutated = ["".join(c for c in s if rng.random() > 0.05) for s in corpus] + ["", "C?", "C[[N]]", "C)(", "[N"]
    for s in corpus + mutated:
        assert tfeat.is_valid_smiles(s) == jfeat.is_valid_smiles(s), s
    assert tfeat.valid_fraction(mutated) == jfeat.valid_fraction(mutated)
    assert tfeat.valid_fraction(corpus) == 1.0 and tfeat.valid_fraction([]) == 0.0


def test_smiles_to_one_hot_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfeat.smiles_to_one_hot(["CCO"], max_len=8)


def test_data_exports_match_reference():
    import molvax.data as jdata

    assert sorted(tdata.__all__) == sorted(jdata.__all__)
