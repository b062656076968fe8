"""The training step: Adam with optax's schedules and clip, ELBO, EMA.

Port of ``molvax/train/loop.py:55-101,153-283``: ``TrainState``,
``ema_eval_state``, ``init_state``, ``make_optimizer``, ``make_train_step``
and ``make_eval_step``. The step runs eagerly, one op at a time.

Where the reference's state is immutable and donated to a jitted step, the
port's ``TrainState`` holds the model and its optimizer, which the step
updates in place (no second copy of the weights and Adam moments); the
step returns a new ``TrainState`` with the counter advanced. The state
carries a base seed; each step derives its seed from (base seed, step), as
the reference's ``fold_in(base_key, step)``, so a run is reproducible and
resumable whatever the batching.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Union

import torch

from ..kernels.generate import fold_in
from ..nn.vae import MolecularVAE, forward
from .loss import vae_loss
from .schedules import beta_at, ss_prob_at

_EVAL_SALT = 0x7FFFFFFF  # disjoint from every train step's seed


# -- optimizer -----------------------------------------------------------------


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    """optax.cosine_decay_schedule (exponent 1)."""

    def schedule(count: int) -> float:
        t = min(count, decay_steps)
        return init_value * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / decay_steps)) + alpha)

    return schedule


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int, end_value: float = 0.0
) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: a linear ramp init -> peak over
    ``warmup_steps``, then a cosine decay to ``end_value`` over the rest of
    ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        return decay(count - warmup_steps)

    return schedule


def learning_rate_schedule(train_cfg) -> Callable[[int], float]:
    """The learning rate of update ``count`` (0 for the first), as
    ``make_optimizer`` of the reference builds it."""
    t = train_cfg
    if t.lr_schedule == "constant":
        return lambda count: t.learning_rate
    if t.lr_schedule == "cosine":
        return cosine_decay_schedule(t.learning_rate, t.lr_decay_steps, alpha=0.1)
    return warmup_cosine_decay_schedule(
        0.0, t.learning_rate, t.lr_warmup_steps, t.lr_decay_steps, 0.1 * t.learning_rate
    )


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g <- g / ||g|| * max_norm when the
    global norm ||g|| is not below max_norm. No epsilon is added to the norm
    (torch.nn.utils.clip_grad_norm_ adds 1e-6)."""
    grads = [g for g in grads if g is not None]
    norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


class Optimizer:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8), the
    reference's learning-rate schedule, and an optional global-norm clip
    before the update. ``count`` is the number of updates made."""

    def __init__(self, params, train_cfg):
        self.params = list(params)
        self.schedule = learning_rate_schedule(train_cfg)
        self.clip = train_cfg.grad_clip_norm
        self.adam = torch.optim.Adam(self.params, lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8)
        self.count = 0

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.clip:
            clip_by_global_norm_([p.grad for p in self.params], self.clip)
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1


def make_optimizer(cfg, model: torch.nn.Module) -> Optimizer:
    """The reference's optimizer (``loop.py:78-101``) over ``model``'s
    parameters."""
    return Optimizer(model.parameters(), cfg.train)


# -- state ---------------------------------------------------------------------


class TrainState(NamedTuple):
    params: MolecularVAE  # updated in place by the step
    opt_state: Optimizer  # updated in place by the step
    step: int
    base_seed: int  # per-step seed = fold_in(base_seed, step)
    # EMA of the parameters by name (TrainConfig.ema_decay > 0), else None
    ema_params: Optional[Dict[str, torch.Tensor]] = None


def ema_eval_state(state: TrainState) -> TrainState:
    """The state evaluation and inference should read: with EMA weights, a
    copy of the model that holds them in place of the last iterate."""
    if state.ema_params is None:
        return state
    model = copy.deepcopy(state.params)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(state.ema_params[name])
    return state._replace(params=model, ema_params=None)


def init_state(
    cfg,
    seed: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    weights: Optional[Mapping[str, torch.Tensor]] = None,
) -> TrainState:
    """A fresh state: weights from torch's default init (the reference's
    distributions) seeded by ``seed`` (default ``cfg.train.seed``) and made
    on the CPU, so they do not depend on the device; or ``weights``, a state
    dict (e.g. ``io.convert.state_dict_from_jax``). Then moved to
    ``device``, with a new optimizer and EMA copy."""
    seed = cfg.train.seed if seed is None else seed
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = MolecularVAE(cfg.model)
    if weights is not None:
        model.load_state_dict(weights, strict=True)
    model.to(device if device is not None else "cpu")
    ema = None
    if cfg.train.ema_decay > 0:
        ema = {name: p.detach().clone() for name, p in model.named_parameters()}
    return TrainState(model, make_optimizer(cfg, model), 0, fold_in(seed, 1), ema)


# -- steps ---------------------------------------------------------------------


def _loss(cfg, out, codes, beta, props):
    return vae_loss(
        cfg.model,
        out.logits,
        codes.long(),
        out.mu,
        out.logvar,
        beta,
        properties_pred=out.properties,
        properties_true=props,
        property_loss_weight=cfg.train.property_loss_weight,
        kl=out.kl,
        kl_free_bits=cfg.train.kl.free_bits,
    )


def make_train_step(cfg):
    """(state, codes (B, T), props (B, P) or None) -> (state, metrics).

    One optimizer step: derive the step's seed, beta and scheduled-sampling
    probability, run the forward and the ELBO, backpropagate, clip and
    update with Adam, update the EMA. Metrics are 0-d tensors on the
    model's device (reading one waits for the step)."""
    use_ss = cfg.train.scheduled_sampling > 0
    wd = cfg.train.word_dropout if cfg.train.word_dropout > 0 else None
    ema_decay = cfg.train.ema_decay

    def train_step(state: TrainState, codes: torch.Tensor, props: Optional[torch.Tensor] = None):
        model, opt = state.params, state.opt_state
        seed = fold_in(state.base_seed, state.step)
        beta = beta_at(cfg.train.kl, state.step)
        ss = ss_prob_at(cfg.train, state.step) if use_ss else None
        out = forward(model, cfg.model, seed, codes, ss_prob=ss, wd_prob=wd)
        loss, metrics = _loss(cfg, out, codes, beta, props)
        opt.zero_grad()
        loss.backward()
        opt.step()
        ema = state.ema_params
        if ema_decay > 0 and ema is not None:
            with torch.no_grad():
                for name, p in model.named_parameters():
                    ema[name].copy_(ema_decay * ema[name] + (1.0 - ema_decay) * p)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return state._replace(step=state.step + 1, ema_params=ema), metrics

    return train_step


def make_eval_step(cfg):
    """Teacher-forced eval: (state, codes, props or None) -> metrics, at
    beta = 1, with a fixed seed disjoint from the train steps', no update."""

    def eval_step(state: TrainState, codes: torch.Tensor, props: Optional[torch.Tensor] = None):
        seed = fold_in(state.base_seed, _EVAL_SALT)
        with torch.no_grad():
            out = forward(state.params, cfg.model, seed, codes)
            _, metrics = _loss(cfg, out, codes, 1.0, props)
        return metrics

    return eval_step
