"""KL-annealing beta and scheduled-sampling probability schedules.

Port of ``molvax/train/schedules.py``: plain functions of the integer step
counter (the port's step runs eagerly, so nothing is traced).
"""

from __future__ import annotations


def _clip01(x: float) -> float:
    return min(max(x, 0.0), 1.0)


def beta_at(cfg, step: int) -> float:
    """beta(step) for a ``KLScheduleConfig``: constant, linear warm-up, or
    cyclical (ramp for ``ratio`` of each cycle, then hold at beta_max)."""
    if cfg.kind == "constant":
        return float(cfg.beta_max)
    if cfg.kind == "linear":
        return cfg.beta_max * _clip01(step / max(cfg.warmup_steps, 1))
    pos = (step % cfg.cycle_steps) / max(cfg.cycle_steps, 1)
    return cfg.beta_max * _clip01(pos / max(cfg.ratio, 1e-8))


def ss_prob_at(cfg, step: int) -> float:
    """Scheduled-sampling probability for a ``TrainConfig``: linear
    0 -> scheduled_sampling over scheduled_sampling_warmup steps."""
    return cfg.scheduled_sampling * _clip01(step / max(cfg.scheduled_sampling_warmup, 1))
