"""Checkpoints of the port's train state: save, keep, restore.

Port of ``molvax/io/checkpoint.py`` (orbax there, which the port does not
use). A save holds the whole ``train.TrainState``, so a resumed run goes on
exactly where the saved one stopped:

* the weights, by parameter name;
* each parameter's Adam moments and step count (on a card, the capturable
  fp32 step tensor of the device);
* ``Optimizer.count``, ``step`` and ``base_seed``;
* the EMA by name, or None.

Layout: one directory per step, ``<dir>/<step>/state.pt``, written under
``<dir>/<step>.tmp/`` and moved into place with ``os.replace``; a partial
directory (a ``.tmp`` one, or one without ``state.pt``) is never read.
Only the newest ``keep`` steps stay. The tensors are saved from CPU copies
and loaded with ``torch.load(..., weights_only=True)``.

A restore copies into the template state's own tensors in place
(``copy_``), never ``p.data = ...``: every parameter, Adam state tensor and
EMA tensor keeps its object and address, and its ``_version`` advances.
A captured chunk (``train.loop._chunk_key``: the addresses) and the
persistent decode's packed weights (``kernels.generate._packed_blocks``:
the addresses and versions) depend on both. The restore is tolerant as the
reference's is:

* a parameter added since the save (``start_token`` once ``learned_start``
  is on) keeps its fresh init and fresh Adam state;
* a saved tensor whose shape or dtype differs from the template's raises
  ``ValueError``, before anything is copied;
* EMA turned on over a checkpoint without one seeds the EMA from the
  restored weights;
* EMA turned off over a checkpoint with one restores the rest and drops
  the saved EMA (the reference crashes there).

These are the port's own checkpoints. Weights trained by the JAX package
come across through ``io.convert`` (``state_dict_from_jax``), not here.
"""

from __future__ import annotations

import os
import shutil
import sys
from typing import Dict, List, Optional

import torch

STATE_FILE = "state.pt"
_MOMENTS = ("step", "exp_avg", "exp_avg_sq")


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu()


def state_payload(state) -> Dict:
    """What a save holds, as CPU tensors and Python numbers."""
    model, opt = state.params, state.opt_state
    params = dict(model.named_parameters())
    return {
        "step": int(state.step),
        "base_seed": int(state.base_seed),
        "count": int(opt.count),
        "params": {n: _cpu(p) for n, p in params.items()},
        "adam": {n: {k: _cpu(opt.adam.state[p][k]) for k in _MOMENTS} for n, p in params.items()},
        "ema": None if state.ema_params is None else {n: _cpu(t) for n, t in state.ema_params.items()},
    }


def _check(what: str, saved: torch.Tensor, have: torch.Tensor) -> None:
    if tuple(saved.shape) != tuple(have.shape):
        raise ValueError(f"checkpoint tensor {what} has shape {tuple(saved.shape)}, the current state "
                         f"{tuple(have.shape)}: the checkpoint was saved from an incompatible model/optimizer config")
    if saved.dtype != have.dtype:
        raise ValueError(f"checkpoint tensor {what} has dtype {saved.dtype}, the current state {have.dtype}: "
                         "the checkpoint was saved from an incompatible config")


def restore_into(template, payload: Dict):
    """``template`` (a ``TrainState``) with ``payload`` copied into its
    tensors in place, and its counters set from it (module docstring)."""
    model, opt = template.params, template.opt_state
    params = dict(model.named_parameters())
    saved_p, saved_adam, saved_ema = payload["params"], payload["adam"], payload["ema"]
    for n, p in params.items():
        if n in saved_p:
            _check(n, saved_p[n], p)
            for k in _MOMENTS:
                _check(f"{n} ({k})", saved_adam[n][k], opt.adam.state[p][k])
            if template.ema_params is not None and saved_ema is not None and n in saved_ema:
                _check(f"ema {n}", saved_ema[n], template.ema_params[n])
    added = [n for n in params if n not in saved_p]
    dropped = [n for n in saved_p if n not in params]
    with torch.no_grad():
        for n, p in params.items():
            if n not in saved_p:
                continue
            p.copy_(saved_p[n])
            for k in _MOMENTS:
                opt.adam.state[p][k].copy_(saved_adam[n][k])
        if template.ema_params is not None:
            for n, t in template.ema_params.items():
                if saved_ema is None:
                    t.copy_(params[n])
                elif n in saved_ema:
                    t.copy_(saved_ema[n])
    if added or dropped:
        print(f"[molvax] checkpoint restore: parameters new since the save keep their fresh init {added}; "
              f"saved parameters the model no longer has are dropped {dropped}", file=sys.stderr)
    if template.ema_params is not None and saved_ema is None:
        print("[molvax] ema_decay enabled over a pre-EMA checkpoint: seeded ema_params from the restored params",
              file=sys.stderr)
    if template.ema_params is None and saved_ema is not None:
        print("[molvax] ema_decay off over a checkpoint with an EMA: the saved EMA is dropped", file=sys.stderr)
    opt.count = int(payload["count"])
    return template._replace(step=int(payload["step"]), base_seed=int(payload["base_seed"]))


class CheckpointManager:
    """Step directories under ``directory``, the newest ``keep`` kept."""

    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        """The steps with a complete checkpoint, in order."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(os.path.join(self.directory, d, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, force: bool = False) -> bool:
        """Save ``state`` as ``step``; returns whether it did. As orbax's
        manager, a step at or below the latest is skipped unless ``force``:
        a forced save replaces that step and removes every later one (a
        best-iterate save may carry a smaller step than a stale one)."""
        latest = self.latest_step()
        if latest is not None and step <= latest and not force:
            return False
        payload = state_payload(state)
        tmp = self._path(step) + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        for s in self.all_steps():
            if s >= step:
                shutil.rmtree(self._path(s))
        os.replace(tmp, self._path(step))
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self._path(s))
        return True

    def restore(self, step: int, template):
        payload = torch.load(os.path.join(self._path(step), STATE_FILE), map_location="cpu", weights_only=True)
        return restore_into(template, payload)

    def restore_latest(self, template):
        """The newest checkpoint copied into ``template`` (module
        docstring), or None where there is none."""
        step = self.latest_step()
        return None if step is None else self.restore(step, template)

    def wait_until_finished(self) -> None:
        """Saves are synchronous here (orbax's may not be): nothing waits."""


def make_manager(directory: str, keep: int = 3) -> CheckpointManager:
    return CheckpointManager(directory, keep)
