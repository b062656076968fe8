"""Shared set-up for the molvax_torch tests, and the shared config table.

The port keeps its own copies of the reference's preset table
(``molvax/config.py``) and charset (``molvax/data/charset.py``); the tests
below hold the copies to the originals. The two packages' config classes are
distinct objects: each test builds both packages' configs from the same
keyword arguments and hands both the same numpy weights and inputs. Port
models are built with ``device="cpu"``: the port's default is the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import molvax.config as jcfg_mod
import molvax.data.charset as jcs_mod
import molvax_torch.config as tcfg_mod
import molvax_torch.data.charset as tcs_mod
from molvax.nn import init_vae_params
from molvax_torch.io.convert import state_dict_from_jax
from molvax_torch.nn.vae import MolecularVAE

# the small config of tests/kernels/test_generate_kernel.py
SMALL = dict(
    max_len=20, charset_size=37, latent_dim=16, conv_kernels=(5, 5, 5),
    enc_hidden=16, gru_hidden=24, gru_layers=2,
)


def configs(**kw):
    """(reference ModelConfig, port ModelConfig) from the same arguments."""
    args = {**SMALL, **kw}
    return jcfg_mod.ModelConfig(**args), tcfg_mod.ModelConfig(**args)


def numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def paired(seed: int = 0, **kw):
    """(jax cfg, port cfg, jax params, port model) with identical weights.
    A learned start token is made non-zero, so step 0 exercises it."""
    jcfg, tcfg = configs(**kw)
    params = init_vae_params(jax.random.key(seed), jcfg)
    if jcfg.learned_start:
        start = np.random.default_rng(seed + 100).standard_normal(jcfg.charset_size)
        params["decoder"]["start_token"] = jnp.asarray(start, jnp.float32)
    model = MolecularVAE(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(numpy_tree(params)), strict=True)
    return jcfg, tcfg, params, model


def normal(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_presets_are_the_reference_table():
    """Every reference preset is the port's, field for field, once the
    port-only fields are dropped at their defaults; the port's own presets
    are exactly gvae_zinc."""
    assert set(tcfg_mod.PRESETS) - set(jcfg_mod.PRESETS) == {"gvae_zinc"}
    for name in jcfg_mod.PRESETS:
        port = dataclasses.asdict(tcfg_mod.get_preset(name))
        for field, default in tcfg_mod.PORT_ONLY_DEFAULTS.items():
            assert port["model"].pop(field) == default, (name, field)
        assert port == dataclasses.asdict(jcfg_mod.get_preset(name)), name


def test_charset_is_the_reference_charset():
    assert tcs_mod.DEFAULT_CHARS == jcs_mod.DEFAULT_CHARS
    assert tcs_mod.PAD_CHAR == jcs_mod.PAD_CHAR
    t, j = tcs_mod.DEFAULT_CHARSET, jcs_mod.DEFAULT_CHARSET
    assert t.chars == j.chars and t.size == j.size and t.pad_index == j.pad_index
    np.testing.assert_array_equal(t.encode_table(), j.encode_table())
    np.testing.assert_array_equal(t.decode_table(), j.decode_table())
    assert t.to_index() == j.to_index()
    listed = ["C", "c", "(", ")", "1", "=", "N", b"O"]
    assert tcs_mod.Charset.from_list(listed).chars == jcs_mod.Charset.from_list(listed).chars
    with_pad = [" "] + listed
    assert tcs_mod.Charset.from_list(with_pad).chars == jcs_mod.Charset.from_list(with_pad).chars
    corpus = ["CC(=O)Oc1ccccc1C(=O)O", "C[N+](C)(C)C", "BrCCBr", "c1ccc2ccccc2c1"]
    tc, jc = tcs_mod.Charset.from_corpus(corpus), jcs_mod.Charset.from_corpus(corpus)
    assert tc.chars == jc.chars
    np.testing.assert_array_equal(tc.encode_table(), jc.encode_table())
    for mod in (tcs_mod, jcs_mod):
        with pytest.raises(ValueError, match="nonzero index"):
            mod.Charset.from_list(["C", " "])
        with pytest.raises(ValueError, match="duplicate"):
            mod.Charset(chars=(" ", "C", "C"))


def test_overrides_and_dict_round_trip():
    over = {"model.use_pallas_generation": False, "train.batch_size": 8}
    t = tcfg_mod.apply_overrides(tcfg_mod.get_preset("zinc250k"), over)
    j = jcfg_mod.apply_overrides(jcfg_mod.get_preset("zinc250k"), over)
    assert tcfg_mod.to_dict(t) == jcfg_mod.to_dict(j)
    assert tcfg_mod.from_dict(tcfg_mod.to_dict(t)) == t


def test_port_config_classes_are_not_the_reference_objects():
    """The hazard of two copies: configs do not cross packages."""
    jc, tc = configs()
    assert type(jc) is not type(tc)
    port = dataclasses.asdict(tc)
    assert {k: port.pop(k) for k in tcfg_mod.PORT_ONLY_DEFAULTS} == tcfg_mod.PORT_ONLY_DEFAULTS
    assert dataclasses.asdict(jc) == port


def test_paired_models_hold_identical_weights():
    _, _, params, model = paired(learned_start=True)
    np.testing.assert_array_equal(
        model.gru.weight_hh_l1.detach().numpy(),
        np.asarray(params["decoder"]["gru"][1]["w_hh"]).T,
    )
    assert torch.count_nonzero(model.start_token) > 0
