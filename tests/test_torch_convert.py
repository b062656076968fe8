"""io/convert.py against molvax.io.torch_compat: the same state dict without
JAX, its inverse, and the .npz that carries it between hosts."""

import jax
import numpy as np
import pytest

from molvax.io.torch_compat import from_torch_state_dict, to_torch_state_dict
from molvax_torch.io.convert import (
    jax_from_state_dict,
    load_npz,
    save_npz,
    state_dict_from_jax,
)
from test_torch_support import numpy_tree, paired


@pytest.mark.parametrize("learned_start", [False, True])
@pytest.mark.parametrize("n_properties", [0, 3])
def test_state_dict_matches_to_torch_state_dict(learned_start, n_properties):
    _, _, params, _ = paired(learned_start=learned_start, n_properties=n_properties)
    ref = to_torch_state_dict(params)
    got = state_dict_from_jax(numpy_tree(params))
    assert list(got) == list(ref)
    for k, v in ref.items():
        assert got[k].dtype.is_floating_point and tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("learned_start", [False, True])
def test_inverse_matches_from_torch_state_dict(learned_start):
    jcfg, _, params, model = paired(learned_start=learned_start, n_properties=3)
    sd = model.state_dict()
    back = jax_from_state_dict(sd)
    for ref in (numpy_tree(from_torch_state_dict(sd, jcfg)), numpy_tree(params)):
        leaves_ref, tree_ref = jax.tree.flatten(ref)
        leaves_back, tree_back = jax.tree.flatten(back)
        assert tree_back == tree_ref
        for a, b in zip(leaves_back, leaves_ref):
            np.testing.assert_array_equal(a, b)


def test_npz_round_trip_is_exact(tmp_path):
    _, _, params, model = paired(learned_start=True)
    sd = model.state_dict()
    path = tmp_path / "weights.npz"
    save_npz(path, sd)
    back = load_npz(path)
    assert list(back) == list(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k].numpy(), err_msg=k)


def test_npz_written_on_a_jax_host_loads(tmp_path):
    """What a JAX host writes (np.savez of to_torch_state_dict) loads into
    the port with strict key checking."""
    _, tcfg, params, _ = paired(learned_start=True)
    path = tmp_path / "from_jax.npz"
    np.savez(path, **to_torch_state_dict(params))
    from molvax_torch.nn.vae import MolecularVAE

    model = MolecularVAE(tcfg, device="cpu")
    model.load_state_dict(load_npz(path), strict=True)
    np.testing.assert_array_equal(
        model.start_token.detach().numpy(), np.asarray(params["decoder"]["start_token"])
    )
