"""The train step makes no tensor from host data (ROADMAP C 1).

On a CUDA device, ``torch.tensor(host data, device=...)`` is a blocking
copy: the host waits for the card before it queues the rest of the step,
and inside CUDA Graph capture the copy fails. Here, on the CPU, every
``torch.tensor`` / ``torch.as_tensor`` that names a device raises while a
train step runs, on the bf16 kernel route (the fused encoder and sampler's
plain versions) and the strict-fp32 route, with and without the property
head. The property stats are made on the device once, by the first step.
No JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from molvax_torch import config as tconfig
from molvax_torch.nn import property_head
from molvax_torch.train import init_state, make_train_step

SMALL = dict(max_len=20, charset_size=37, latent_dim=16, conv_kernels=(5, 5, 5), enc_hidden=16,
             gru_hidden=24, gru_layers=2)


def _config(compute_dtype: str, n_properties: int) -> tconfig.Config:
    stats = {}
    if n_properties:
        stats = dict(property_mean=(2.5, 0.6, 3.0)[:n_properties], property_std=(1.5, 0.2, 0.9)[:n_properties])
    model = tconfig.ModelConfig(**SMALL, compute_dtype=compute_dtype, use_pallas=True, learned_start=True,
                                n_properties=n_properties, **stats)
    kl = tconfig.KLScheduleConfig(kind="cyclical", cycle_steps=8, ratio=0.5, free_bits=0.1)
    return tconfig.Config(model=model, train=tconfig.TrainConfig(batch_size=4, kl=kl, scheduled_sampling=0.25,
                                                                 scheduled_sampling_warmup=2))


def _no_device_copies(monkeypatch):
    """torch.tensor / torch.as_tensor raise when they are asked to put host
    data on a device; the host-side uses (no device named) stay."""
    for name in ("tensor", "as_tensor"):
        real = getattr(torch, name)

        def guarded(*args, _real=real, _name=name, **kw):
            if kw.get("device") is not None:
                raise AssertionError(f"torch.{_name}(..., device={kw['device']}) on the train step's path")
            return _real(*args, **kw)

        monkeypatch.setattr(torch, name, guarded)


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n_properties", [0, 3])
def test_train_step_makes_no_tensor_from_host_data(monkeypatch, compute_dtype, n_properties):
    cfg = _config(compute_dtype, n_properties)
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, cfg.model.charset_size, (4, cfg.model.max_len)).astype(np.int64))
    props = torch.from_numpy(rng.standard_normal((4, n_properties)).astype(np.float32)) if n_properties else None
    step = make_train_step(cfg)
    state = init_state(cfg, seed=0, device="cpu")
    state, _ = step(state, codes, props)  # the first step may make the property stats, once
    made = property_head._stats.cache_info().misses
    _no_device_copies(monkeypatch)
    for _ in range(2):
        state, metrics = step(state, codes, props)
    assert property_head._stats.cache_info().misses == made
    assert metrics["beta"].item() == pytest.approx(0.5) and metrics["beta"].device.type == "cpu"
    assert all(torch.isfinite(v) for v in metrics.values())
    assert ("prop_mse" in metrics) == bool(n_properties)


def test_the_guard_catches_a_copy_from_host_data(monkeypatch):
    """The guard of this file raises on what C 1 repaired."""
    _no_device_copies(monkeypatch)
    with pytest.raises(AssertionError, match="train step's path"):
        torch.tensor(0.5, device="cpu")
    assert torch.tensor(0.5).item() == 0.5


def test_property_stats_are_made_once_per_device():
    cfg = dataclasses.replace(_config("float32", 3).model)
    raw = torch.from_numpy(np.random.default_rng(1).standard_normal((5, 3)).astype(np.float32))
    a = property_head._stats(cfg.property_mean, cfg.property_std, raw.device)
    norm = property_head.normalize_targets(cfg, raw)
    assert property_head._stats(cfg.property_mean, cfg.property_std, raw.device)[0] is a[0]
    torch.testing.assert_close(property_head.denormalize_properties(cfg, norm), raw, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(norm, (raw - torch.tensor(cfg.property_mean)) / torch.tensor(cfg.property_std))
