"""Shared set-up for the molvax_torch tests, and the shared config table.

The port and the reference read one preset table (``molvax/config.py``);
the port loads it by file path, so its classes are distinct objects. Each
test builds both packages' configs from the same keyword arguments and hands
both the same numpy weights and inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import molvax.config as jcfg_mod
import molvax_torch.config as tcfg_mod
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
    model = MolecularVAE(tcfg)
    model.load_state_dict(state_dict_from_jax(numpy_tree(params)), strict=True)
    return jcfg, tcfg, params, model


def normal(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_presets_are_the_reference_table():
    assert sorted(tcfg_mod.PRESETS) == sorted(jcfg_mod.PRESETS)
    for name in jcfg_mod.PRESETS:
        assert dataclasses.asdict(tcfg_mod.get_preset(name)) == dataclasses.asdict(
            jcfg_mod.get_preset(name)
        ), name


def test_overrides_and_dict_round_trip():
    over = {"model.use_pallas_generation": False, "train.batch_size": 8}
    t = tcfg_mod.apply_overrides(tcfg_mod.get_preset("zinc250k"), over)
    j = jcfg_mod.apply_overrides(jcfg_mod.get_preset("zinc250k"), over)
    assert tcfg_mod.to_dict(t) == jcfg_mod.to_dict(j)
    assert tcfg_mod.from_dict(tcfg_mod.to_dict(t)) == t


def test_port_config_classes_are_not_the_reference_objects():
    """The hazard the shared loading brings: configs do not cross packages."""
    jc, tc = configs()
    assert type(jc) is not type(tc)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)


def test_paired_models_hold_identical_weights():
    _, _, params, model = paired(learned_start=True)
    np.testing.assert_array_equal(
        model.gru.weight_hh_l1.detach().numpy(),
        np.asarray(params["decoder"]["gru"][1]["w_hh"]).T,
    )
    assert torch.count_nonzero(model.start_token) > 0
