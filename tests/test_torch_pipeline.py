"""The port's batch pipeline and ``effective_config`` against molvax, on the
CPU: ``BatchIterator`` batches, epoch wrap, small-corpus tiling,
``fast_forward`` and ``next_stack`` equal to the reference's
``np.asarray`` of its batches on the same seeds; the host checks that keep
an out-of-range code from reaching ``F.one_hot`` on a card. The card's
pinned, non-blocking copies run only there (``chip_smoke.py`` phase 22)."""

import dataclasses

import numpy as np
import pytest
import torch

from molvax.config import get_preset as j_preset
from molvax.data import BatchIterator as JBatchIterator
from molvax.data import zinc as jzinc
from molvax.data.charset import Charset as JCharset
from molvax.train.loop import effective_config as j_effective_config
from molvax_torch.config import get_preset as t_preset
from molvax_torch.data import BatchIterator, Charset, Dataset, DEFAULT_CHARSET
from molvax_torch.data import zinc as tzinc
from molvax_torch.train import effective_config


def _pair(n, seed=0, with_properties=False, max_len=120, chem=False):
    return (tzinc.synthetic_dataset(n, max_len=max_len, seed=seed, with_properties=with_properties, chem=chem),
            jzinc.synthetic_dataset(n, max_len=max_len, seed=seed, with_properties=with_properties, chem=chem))


def _same(got, want):
    codes, props = got
    assert codes.dtype == torch.uint8 and codes.device.type == "cpu"
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want[0]))
    if want[1] is None:
        assert props is None
    else:
        assert props.dtype == torch.float32
        np.testing.assert_array_equal(props.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("n,batch,seed", [(64, 16, 0), (4096, 256, 0), (100, 32, 7)])
@pytest.mark.parametrize("with_properties", [False, True])
def test_batches_equal_reference_across_epochs(n, batch, seed, with_properties):
    """Two and a half epochs of batches, the epoch counter at each."""
    ds_t, ds_j = _pair(n, seed=1, with_properties=with_properties)
    it = BatchIterator(ds_t, batch, seed=seed, device="cpu", with_properties=with_properties)
    jt = JBatchIterator(ds_j, batch, seed=seed, with_properties=with_properties)
    assert it.steps_per_epoch == jt.steps_per_epoch == n // batch
    for _ in range(it.steps_per_epoch * 5 // 2 + 1):
        _same(next(it), next(jt))
        assert it.epoch == jt.epoch
    assert it.epoch >= 2


@pytest.mark.parametrize("k", [1, 3, 16])
def test_next_stack_equal_reference(k):
    ds_t, ds_j = _pair(600, seed=2, with_properties=True)
    it = BatchIterator(ds_t, 32, seed=4, device="cpu", with_properties=True)
    jt = JBatchIterator(ds_j, 32, seed=4, with_properties=True)
    for _ in range(3):  # crosses epochs at k = 16
        codes, props = it.next_stack(k)
        assert codes.shape == (k, 32, 120) and props.shape == (k, 32, 3)
        _same((codes, props), jt.next_stack(k))
        assert it.epoch == jt.epoch
    _same(next(it), next(jt))


@pytest.mark.parametrize("skip", [0, 1, 5, 23])
def test_fast_forward_equal_reference(skip):
    """A resumed run's batches: fast_forward moves the shuffle, not the data."""
    ds_t, ds_j = _pair(96, seed=3)
    it, jt = BatchIterator(ds_t, 16, seed=9, device="cpu"), JBatchIterator(ds_j, 16, seed=9)
    it.fast_forward(skip)
    jt.fast_forward(skip)
    assert it.epoch == jt.epoch
    _same(it.next_stack(4), jt.next_stack(4))
    fresh = BatchIterator(ds_t, 16, seed=9, device="cpu")
    for _ in range(skip):
        next(fresh)
    assert torch.equal(next(fresh)[0], BatchIterator(ds_t, 16, seed=9, device="cpu").next_stack(skip + 1)[0][-1])


def test_small_corpus_tiles_to_a_batch_as_the_reference():
    ds_t, ds_j = _pair(5, seed=0, with_properties=True)
    it = BatchIterator(ds_t, 16, seed=0, device="cpu", with_properties=True)
    jt = JBatchIterator(ds_j, 16, seed=0, with_properties=True)
    assert len(it.dataset) == len(jt.dataset) == 20
    for _ in range(3):
        _same(next(it), next(jt))


def test_empty_corpus_raises():
    empty = Dataset(np.zeros((0, 16), np.uint8), DEFAULT_CHARSET)
    with pytest.raises(ValueError, match="empty corpus"):
        BatchIterator(empty, batch_size=4, device="cpu")


def test_codes_past_the_charset_raise_on_the_host():
    """On a card F.one_hot of such a code ends the CUDA context; the
    reference's one-hot gave a zero row. The iterator refuses it first."""
    codes = np.full((8, 10), 2, np.uint8)
    codes[3, 4] = DEFAULT_CHARSET.size
    with pytest.raises(ValueError, match="past its charset"):
        BatchIterator(Dataset(codes, DEFAULT_CHARSET), 4, device="cpu")
    codes[3, 4] = DEFAULT_CHARSET.size - 1
    assert next(BatchIterator(Dataset(codes, DEFAULT_CHARSET), 4, device="cpu"))[0].shape == (4, 10)


def test_properties_only_where_asked_and_present():
    ds_t, _ = _pair(40, with_properties=False)
    codes, props = next(BatchIterator(ds_t, 8, device="cpu", with_properties=True))
    assert props is None and codes.shape == (8, 120)


def test_iterator_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ds_t, _ = _pair(32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchIterator(ds_t, 8)


# -- effective_config --------------------------------------------------------------


def test_effective_config_adapts_the_charset_as_the_reference(capsys):
    chars = "".join(sorted(set("CCO c1ccccc1 CN")))
    small = Charset(chars if chars.startswith(" ") else " " + chars.replace(" ", ""))
    codes = tzinc.encode_smiles_native(["CCO", "c1ccccc1", "CN"], small, 20)
    got = effective_config(t_preset("zinc250k"), Dataset(codes, small))
    want = j_effective_config(j_preset("zinc250k"), jzinc.Dataset(codes, JCharset(small.chars)))
    assert got.model.charset_size == want.model.charset_size == small.size
    assert "adapting model.charset_size" in capsys.readouterr().err


@pytest.mark.parametrize("chem", [False, True])
def test_effective_config_standardises_targets_as_the_reference(chem):
    ds_t, ds_j = _pair(300, seed=5, with_properties=True, chem=chem)
    got = effective_config(t_preset("property_joint"), ds_t)
    want = j_effective_config(j_preset("property_joint"), ds_j)
    assert got.model.property_mean == want.model.property_mean
    assert got.model.property_std == want.model.property_std
    assert got.model.charset_size == want.model.charset_size
    # stats already set, or no head: nothing changes
    assert effective_config(got, ds_t) == got
    assert effective_config(t_preset("zinc250k"), ds_t) == t_preset("zinc250k")


def test_effective_config_refuses_codes_past_the_charset():
    codes = np.zeros((4, 10), np.uint8)
    codes[0, 0] = DEFAULT_CHARSET.size + 3
    with pytest.raises(ValueError, match="past its charset"):
        effective_config(t_preset("zinc250k"), Dataset(codes, DEFAULT_CHARSET))
    cfg = dataclasses.replace(t_preset("zinc250k"))
    assert effective_config(cfg, Dataset(codes[1:], DEFAULT_CHARSET)) == cfg
