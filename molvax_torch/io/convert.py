"""Weights between the JAX param tree and the port, without JAX.

Port of ``molvax/io/torch_compat.py:94-124`` (``to_torch_state_dict``) and
its inverse, on numpy arrays only, so that a host with no JAX can load
weights that a JAX host trained. Layout mapping:

  JAX Linear 'w' (in, out)         <-> torch ``{name}.weight`` (out, in)
  JAX Conv1d 'w' (out, in, k)      <-> torch ``conv_{i}.weight``, as is
  JAX gru[i]['w_ih'] (in, 3H)      <-> torch ``gru.weight_ih_l{i}`` (3H, in)
  gate order r|z|n along 3H is shared by both.

Between hosts, weights travel as an ``.npz`` of the state dict
(``save_npz`` / ``load_npz``); a JAX host writes one with
``np.savez(path, **to_torch_state_dict(params))``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_ENC_LINEARS = (("linear_0", "linear_0"), ("linear_1", "linear_mu"), ("linear_2", "linear_logvar"))


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX param tree (numpy leaves) -> the port's state dict (fp32, CPU),
    key for key what ``molvax.io.torch_compat.to_torch_state_dict`` gives."""
    out: Dict[str, np.ndarray] = {}

    def lin(name, p):
        out[f"{name}.weight"] = np.asarray(p["w"]).T
        out[f"{name}.bias"] = np.asarray(p["b"])

    enc = params["encoder"]
    for i, c in enumerate(enc["convs"], start=1):
        out[f"conv_{i}.weight"] = np.asarray(c["w"])
        out[f"conv_{i}.bias"] = np.asarray(c["b"])
    for name, key in _ENC_LINEARS:
        lin(name, enc[key])

    dec = params["decoder"]
    lin("linear_3", dec["linear_3"])
    for li, layer in enumerate(dec["gru"]):
        out[f"gru.weight_ih_l{li}"] = np.asarray(layer["w_ih"]).T
        out[f"gru.weight_hh_l{li}"] = np.asarray(layer["w_hh"]).T
        out[f"gru.bias_ih_l{li}"] = np.asarray(layer["b_ih"])
        out[f"gru.bias_hh_l{li}"] = np.asarray(layer["b_hh"])
    lin("linear_4", dec["linear_out"])

    if "property_head" in params:
        lin("prop_hidden", params["property_head"]["hidden"])
        lin("prop_out", params["property_head"]["out"])
    if dec.get("start_token") is not None:
        out["start_token"] = np.asarray(dec["start_token"])
    # torch.tensor copies: the leaves may be read-only views of device arrays
    return {k: torch.tensor(np.asarray(v, dtype=np.float32)) for k, v in out.items()}


def jax_from_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Inverse of ``state_dict_from_jax``: state dict -> JAX param tree of
    numpy fp32 arrays (``jax.tree.map(jnp.asarray, ...)`` on a JAX host)."""
    sd = {
        k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
        for k, v in sd.items()
    }

    def t(x):
        return np.ascontiguousarray(x, dtype=np.float32)

    def lin(name):
        return {"w": t(sd[f"{name}.weight"].T), "b": t(sd[f"{name}.bias"])}

    convs = []
    i = 1
    while f"conv_{i}.weight" in sd:
        convs.append({"w": t(sd[f"conv_{i}.weight"]), "b": t(sd[f"conv_{i}.bias"])})
        i += 1
    gru = []
    li = 0
    while f"gru.weight_ih_l{li}" in sd:
        gru.append(
            {
                "w_ih": t(sd[f"gru.weight_ih_l{li}"].T),
                "w_hh": t(sd[f"gru.weight_hh_l{li}"].T),
                "b_ih": t(sd[f"gru.bias_ih_l{li}"]),
                "b_hh": t(sd[f"gru.bias_hh_l{li}"]),
            }
        )
        li += 1
    params: Dict[str, Any] = {
        "encoder": {"convs": convs, **{key: lin(name) for name, key in _ENC_LINEARS}},
        "decoder": {"linear_3": lin("linear_3"), "gru": gru, "linear_out": lin("linear_4")},
    }
    if "prop_hidden.weight" in sd:
        params["property_head"] = {"hidden": lin("prop_hidden"), "out": lin("prop_out")}
    if "start_token" in sd:
        params["decoder"]["start_token"] = t(sd["start_token"])
    return params


def save_npz(path, sd: Mapping[str, Any]) -> None:
    """Write a state dict as an uncompressed ``.npz`` (fp32 arrays)."""
    np.savez(
        path,
        **{
            k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in sd.items()
        },
    )


def load_npz(path) -> Dict[str, torch.Tensor]:
    """Read a state dict written by ``save_npz`` (or by ``np.savez`` of
    ``to_torch_state_dict`` on a JAX host)."""
    with np.load(path, allow_pickle=False) as f:
        return {k: torch.from_numpy(f[k].copy()) for k in f.files}
