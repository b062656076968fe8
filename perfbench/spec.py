"""Finding a cell's files by name, and the program's configuration of it.

``BENCHMARK.json`` at the root names each cell's configuration and traffic
mix; the files of each sit under this package and are found by name. The
configuration file holds the sizes as they run (``sizes``): the program's
configuration is made from its preset and ``overrides``, and every size of
the file must equal the program's, so the file says what runs and the
reference reads its sizes from the file alone.
"""

from __future__ import annotations

import json
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent

# each size of a configuration file, and the program's field that must hold it
FIELDS = {
    "max_len": "model.max_len", "charset_size": "model.charset_size", "latent_dim": "model.latent_dim",
    "conv_channels": "model.conv_channels", "conv_kernels": "model.conv_kernels",
    "conv_orientation": "model.conv_orientation", "enc_hidden": "model.enc_hidden",
    "gru_hidden": "model.gru_hidden", "gru_layers": "model.gru_layers",
    "decoder_conditioning": "model.decoder_conditioning", "learned_start": "model.learned_start",
    "recon_loss": "model.recon_loss", "eps_scale": "model.eps_scale", "n_properties": "model.n_properties",
    "compute_dtype": "model.compute_dtype", "use_pallas": "model.use_pallas",
    "use_pallas_generation": "model.use_pallas_generation", "gru_kernel": "model.gru_kernel",
    "batch_size": "train.batch_size", "learning_rate": "train.learning_rate",
    "lr_schedule": "train.lr_schedule", "grad_clip_norm": "train.grad_clip_norm",
    "ema_decay": "train.ema_decay", "scheduled_sampling": "train.scheduled_sampling",
    "word_dropout": "train.word_dropout", "train_chunk_size": "train.train_chunk_size",
    "kl_kind": "train.kl.kind", "kl_beta_max": "train.kl.beta_max", "kl_cycle_steps": "train.kl.cycle_steps",
    "kl_ratio": "train.kl.ratio", "kl_free_bits": "train.kl.free_bits",
    "n_synthetic": "data.n_synthetic", "data_axis": "mesh.data_axis",
}


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def bench() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    """The cell's entry of ``BENCHMARK.json`` with its own file's keys
    (``limits``) under it."""
    entries = {w["name"]: w for w in bench()["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(entries)}")
    return {**entries[name], **_json(PKG / "workloads" / f"{name}.json")}


def config(name: str) -> dict:
    return _json(PKG / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(PKG / "traffic" / f"{name}.json")


def metrics(name: str, trace: bool) -> list:
    """The metrics a run of cell ``name`` reports: with ``trace`` the
    per-layer ones, else the end-to-end ones, each where its ``workloads``
    (if it has the key) names the cell."""
    b = bench()
    return [m for m in b["per_layer" if trace else "end_to_end"] if name in m.get("workloads", [name])]


def _get(cfg, dotted: str):
    for part in dotted.split("."):
        cfg = getattr(cfg, part)
    return cfg


def program_config(conf: dict):
    """The program's ``Config`` of configuration file ``conf``: its preset
    with its ``overrides``, every size of the file checked against it."""
    from molvax_torch.config import apply_overrides, get_preset

    cfg = apply_overrides(get_preset(conf["preset"]), conf.get("overrides", {}))
    for key, want in conf["sizes"].items():
        got = _get(cfg, FIELDS[key])
        if (list(got) if isinstance(got, tuple) else got) != want:
            raise ValueError(f"configuration {conf['name']}: {key} is {got!r} in the program, {want!r} in the file")
    return cfg
