"""The training step and the chunk of K steps: Adam with optax's schedules
and clip, ELBO, EMA.

Port of ``molvax/train/loop.py``: ``TrainState``, ``effective_config``,
``ema_eval_state``, ``init_state``, ``make_optimizer``,
``make_train_step``, ``make_train_chunk``, ``make_eval_step`` and the
training loop ``train`` (checkpoints, resume, preemption, eval cadence,
the round-trip probe, best-iterate selection, the collapse guard).

Where the reference's state is immutable and donated to a jitted step, the
port's ``TrainState`` holds the model and its optimizer, which the step
updates in place (no second copy of the weights and Adam moments); the
step returns a new ``TrainState`` with the counter advanced. The state
carries a base seed; each step derives its seed from (base seed, step), as
the reference's ``fold_in(base_key, step)``, so a run is reproducible and
resumable whatever the batching.

The values that change from step to step (the seed, beta, the
scheduled-sampling probability and the learning rate) are computed on the
host from the counters, as the reference's schedules (``schedule_vectors``),
and reach the device as one (4, K) vector per call, one pinned
non-blocking copy; step i of the call reads element i as 0-d tensors
(``step_body``). So no step waits for the host, the eager step and each
step of a chunk run one program on the same operands, and a CUDA Graph of
K steps (``make_train_chunk``, the reference's ``lax.scan`` of the step)
replays with each chunk's values.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import signal
import sys
import threading
import time
import weakref
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch.autograd.graph import increment_version

from ..config import to_dict
from ..data import BatchIterator, load_dataset
from ..io import checkpoint as ckpt_io
from ..kernels.generate import fold_in, fold_in_range
from ..nn.vae import MolecularVAE, forward
from ..utils import PinnedStaging, resolve_device
from .evaluate import reconstruction_metrics
from .loss import vae_loss
from .metrics import MetricsLogger, host_rows
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
    before the update. ``count`` is the number of updates made.

    The learning rate is a 0-d fp32 tensor on the parameters' device
    (``lr``), written by every update. On a card, torch's Adam runs
    ``capturable`` (its step counts and bias corrections on the device),
    so that no update reads a host value. Its state tensors (each step
    count a 0-d fp32 tensor, on the card there, on the host on the CPU, as
    torch makes them) are made here, so a CUDA Graph can capture updates
    without making state inside the capture, and a checkpoint always finds
    the state it saves and restores (``io.checkpoint``). torch refuses
    ``capturable`` on the CPU, where Adam runs its single-tensor path with
    the same tensor learning rate."""

    def __init__(self, params, train_cfg):
        self.params = list(params)
        self.schedule = learning_rate_schedule(train_cfg)
        self.clip = train_cfg.grad_clip_norm
        dev = self.params[0].device
        cuda = dev.type == "cuda"
        self.lr = torch.full((), self.schedule(0), dtype=torch.float32, device=dev)
        self.adam = torch.optim.Adam(self.params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8, foreach=cuda,
                                     capturable=cuda)
        for p in self.params:
            self.adam.state[p] = {
                "step": torch.zeros((), dtype=torch.float32, device=dev if cuda else "cpu"),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
            }
        self.count = 0

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def update(self, lr: Union[float, torch.Tensor]) -> None:
        """Clip and update at learning rate ``lr`` (a float, or a 0-d
        tensor on the parameters' device, copied there with no host read).
        ``count`` is the caller's to advance."""
        if self.clip:
            clip_by_global_norm_([p.grad for p in self.params], self.clip)
        if isinstance(lr, torch.Tensor):
            self.lr.copy_(lr)
        else:
            self.lr.fill_(lr)
        self.adam.step()

    def step(self) -> None:
        """One update at the schedule's rate for ``count``."""
        self.update(self.schedule(self.count))
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


def effective_config(cfg, dataset):
    """Reconcile a config with the dataset it will train on (the
    reference's ``effective_config``), before any one-hot is built:

    * the charset width: a corpus-derived charset (.smi / .h5 source) may
      differ from the default; the model's ``charset_size`` follows the
      dataset's charset;
    * property-target standardisation: per-property mean and std of the
      corpus, when the model has a property head and no stats yet.

    A code at or past the charset's size raises here, on the host: the
    reference's one-hot gives such a code a zero row, but on a card
    ``F.one_hot`` fails with a device-side assert that ends the process's
    CUDA context."""
    if dataset.charset.size != cfg.model.charset_size:
        print(f"[molvax_torch] adapting model.charset_size {cfg.model.charset_size} -> "
              f"{dataset.charset.size} (dataset charset)", file=sys.stderr)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, charset_size=dataset.charset.size))
    if len(dataset) and int(dataset.codes.max()) >= cfg.model.charset_size:
        raise ValueError(f"the dataset holds code {int(dataset.codes.max())}, past its charset of "
                         f"{cfg.model.charset_size} characters")
    if cfg.model.n_properties > 0 and dataset.properties is not None and cfg.model.property_mean is None:
        mean = np.mean(dataset.properties, axis=0)
        std = np.maximum(np.std(dataset.properties, axis=0), 1e-6)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, property_mean=tuple(float(m) for m in mean), property_std=tuple(float(s) for s in std)))
    return cfg


def init_state(
    cfg,
    seed: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    weights: Optional[Mapping[str, torch.Tensor]] = None,
) -> TrainState:
    """A fresh state: weights from torch's default init (the reference's
    distributions) seeded by ``seed`` (default ``cfg.train.seed``) and made
    on the CPU, so they do not depend on the device; or ``weights``, a state
    dict (e.g. ``io.convert.state_dict_from_jax``). The model is built on
    ``device`` (default: the card; ``"cpu"`` where the caller asks for it),
    with a new optimizer and EMA copy."""
    seed = cfg.train.seed if seed is None else seed
    dev = resolve_device(device)
    # the caller's RNG streams are left as they were
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        if weights is None:
            weights = MolecularVAE(cfg.model, device="cpu").state_dict()
        model = MolecularVAE(cfg.model, device=dev)
    model.load_state_dict(weights, strict=True)
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


def schedule_vectors(cfg, base_seed: int, step: int, count: int, k: int) -> np.ndarray:
    """The per-step values of steps ``step`` .. ``step + k - 1`` (optimizer
    updates ``count`` ..), computed on the host as the eager reference does,
    packed as one (4, k) int32 array: row 0 the seeds ``fold_in(base_seed,
    step + i)`` as 32-bit patterns, rows 1-3 the fp32 bit patterns of
    ``beta_at``, ``ss_prob_at`` (0 without scheduled sampling) and the
    learning rate of update ``count + i``. ``unpack`` reads it."""
    out = np.empty((4, k), dtype=np.int32)
    out[0] = fold_in_range(base_seed, step, k).view(np.int32)
    use_ss = cfg.train.scheduled_sampling > 0
    lr = learning_rate_schedule(cfg.train)
    vals = out[1:].view(np.float32)
    for i in range(k):
        vals[0, i] = beta_at(cfg.train.kl, step + i)
        vals[1, i] = ss_prob_at(cfg.train, step + i) if use_ss else 0.0
        vals[2, i] = lr(count + i)
    return out


def unpack(values: torch.Tensor):
    """(seeds, beta, ss, lr) views of a packed (4, k) int32 tensor: int32
    seeds, fp32 rest."""
    return values[0], values[1].view(torch.float32), values[2].view(torch.float32), values[3].view(torch.float32)


def _device_values(values: np.ndarray, device: torch.device, staging: Dict) -> torch.Tensor:
    """The packed vector on ``device``: shared with numpy on the CPU; on a
    card one non-blocking copy from pinned memory."""
    if device.type != "cuda":
        return torch.from_numpy(values)
    if device not in staging:
        staging[device] = PinnedStaging(device)
    return staging[device].copy(values.shape, torch.int32, lambda buf: np.copyto(buf, values))


def step_body(cfg, state: TrainState, codes: torch.Tensor, props: Optional[torch.Tensor], seed, beta, ss, lr):
    """One optimizer step on ``state`` in place: the forward at ``seed``
    (with scheduled-sampling probability ``ss`` where the config has it),
    the ELBO at ``beta``, backward, clip and Adam at ``lr``, the EMA. Each
    value a Python number or a 0-d tensor on the model's device. Returns
    the metrics, 0-d tensors on the device. Advances no counter: the
    caller does."""
    model, opt = state.params, state.opt_state
    use_ss = cfg.train.scheduled_sampling > 0
    wd = cfg.train.word_dropout if cfg.train.word_dropout > 0 else None
    out = forward(model, cfg.model, seed, codes, ss_prob=ss if use_ss else None, wd_prob=wd)
    loss, metrics = _loss(cfg, out, codes, beta, props)
    opt.zero_grad()
    loss.backward()
    opt.update(lr)
    ema, decay = state.ema_params, cfg.train.ema_decay
    if decay > 0 and ema is not None:
        with torch.no_grad():
            for name, p in model.named_parameters():
                ema[name].copy_(decay * ema[name] + (1.0 - decay) * p)
    return {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg):
    """(state, codes (B, T), props (B, P) or None) -> (state, metrics).

    One optimizer step: the step's values from ``schedule_vectors`` (one
    pinned non-blocking copy to a card), then ``step_body``. Metrics are
    0-d tensors on the model's device (reading one waits for the step)."""
    staging: Dict = {}

    def train_step(state: TrainState, codes: torch.Tensor, props: Optional[torch.Tensor] = None):
        values = schedule_vectors(cfg, state.base_seed, state.step, state.opt_state.count, 1)
        seeds, beta, ss, lr = unpack(_device_values(values, codes.device, staging))
        metrics = step_body(cfg, state, codes, props, seeds[0], beta[0], ss[0], lr[0])
        state.opt_state.count += 1
        return state._replace(step=state.step + 1), metrics

    return train_step


class CapturedChunk:
    """K steps of one model captured in one CUDA Graph, replayed per chunk.

    Capture reads and writes the state's own tensors (weights, Adam moments
    and counts, EMA), the static inputs (the (K, B, T) codes, the (K, B, P)
    properties, the packed (4, K) values) and the graph's private memory
    pool, which the K steps share: each step frees its activations, so the
    pool peaks near one step. Before capture one step runs, on the side
    stream that captures, on a deep copy of the state: it loads the kernel
    library, makes cuBLAS' workspace and the property stats on the card
    (``nn.property_head._stats``), so that nothing in the capture is made
    from host data; the real state is not advanced by it, and capture
    itself runs no kernel. ``metrics`` are the graph's own (K,) buffers,
    rewritten by every replay."""

    def __init__(self, cfg, k: int, state: TrainState, codes_stack: torch.Tensor,
                 props_stack: Optional[torch.Tensor], values: np.ndarray):
        dev = codes_stack.device
        self.key = _chunk_key(state, codes_stack, props_stack)
        self.written = _state_tensors(state)
        self.staging = PinnedStaging(dev)
        self.codes = codes_stack.clone()
        self.props = None if props_stack is None else props_stack.clone()
        self.values = torch.empty((4, k), dtype=torch.int32, device=dev)
        self.staging.copy(values.shape, torch.int32, lambda buf: np.copyto(buf, values), out=self.values)
        seeds, beta, ss, lr = unpack(self.values)
        props = (lambda i: None) if self.props is None else (lambda i: self.props[i])
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            warm = copy.deepcopy(state)
            step_body(cfg, warm, self.codes[0], props(0), seeds[0], beta[0], ss[0], lr[0])
            del warm
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph, stream=stream):
            steps = [step_body(cfg, state, self.codes[i], props(i), seeds[i], beta[i], ss[i], lr[i])
                     for i in range(k)]
            self.metrics = {name: torch.stack([m[name] for m in steps]) for name in steps[0]}
        self.capture_seconds = time.perf_counter() - t0

    def replay(self, codes_stack: torch.Tensor, props_stack: Optional[torch.Tensor], values: np.ndarray):
        """The per-chunk host work: one copy of the stack into the static
        input (and of the properties), one of the values, one replay. A
        replay writes the state's tensors as the captured steps' in-place
        ops do, but only capture advanced their version counters: they are
        advanced again here, so what is keyed by a weight's version (the
        persistent decode's packed weights, ``kernels.generate``) sees the
        new weights."""
        self.codes.copy_(codes_stack)
        if self.props is not None:
            self.props.copy_(props_stack)
        self.staging.copy(values.shape, torch.int32, lambda buf: np.copyto(buf, values), out=self.values)
        self.graph.replay()
        for t in self.written:
            increment_version(t)
        return self.metrics


def _state_tensors(state: TrainState) -> list:
    """The state's tensors that a step writes in place: weights, Adam
    state, learning rate, EMA."""
    opt = state.opt_state
    return [*opt.params, opt.lr, *(t for p in opt.params for t in opt.adam.state[p].values()),
            *(state.ema_params or {}).values()]


def _chunk_key(state: TrainState, codes_stack, props_stack) -> Tuple:
    """What a captured chunk is bound to: the addresses of the state's
    tensors (``_state_tensors``), which the graph reads and writes in
    place, and the inputs' shapes and types. A state whose tensors moved
    is captured anew."""
    props = None if props_stack is None else (tuple(props_stack.shape), props_stack.dtype)
    return (tuple(t.data_ptr() for t in _state_tensors(state)), tuple(codes_stack.shape), codes_stack.dtype, props)


def make_train_chunk(cfg, chunk: int, device: Optional[Union[str, torch.device]] = None):
    """(state, codes_stack (K, B, T), props_stack (K, B, P) or None) ->
    (state, metrics stacked (K, ...)), with ``state.step`` advanced by
    K = ``chunk``: the reference's fused multi-step trainer
    (``loop.py:240-255``).

    On a card (``device``, the card by default) the K steps are one CUDA
    Graph (``CapturedChunk``), captured at the first call for the state's
    model and the stack's shape and replayed at every call: per chunk the
    host copies the stack into the graph's input, copies the (4, K) step
    values, and replays, with no host sync. The stack must lie on the card
    (``data.BatchIterator(..., device=...).next_stack``). The metrics are
    the graph's buffers, rewritten by the next call: read or copy them
    before it. Every configuration is captured (each sampler path reads its
    seed on the device); the chunk never falls back to eager steps. On the
    CPU (``device="cpu"``) the chunk is K eager steps through the same body."""
    if chunk < 1:
        raise ValueError(f"make_train_chunk: chunk must be >= 1, got {chunk}")
    dev = resolve_device(device)
    step = make_train_step(cfg)
    graphs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def check(state, codes_stack, props_stack):
        if codes_stack.dim() != 3 or codes_stack.shape[0] != chunk:
            raise ValueError(f"make_train_chunk: codes_stack {tuple(codes_stack.shape)} is not ({chunk}, B, T)")
        if props_stack is not None and (props_stack.dim() != 3 or props_stack.shape[0] != chunk):
            raise ValueError(f"make_train_chunk: props_stack {tuple(props_stack.shape)} is not ({chunk}, B, P)")
        where = {state.params.device, codes_stack.device, *(() if props_stack is None else (props_stack.device,))}
        if len(where) != 1 or where.pop().type != dev.type:
            raise ValueError(f"make_train_chunk: the chunk runs on {dev}; the model and the stack must lie there")

    def train_chunk(state: TrainState, codes_stack: torch.Tensor, props_stack: Optional[torch.Tensor] = None):
        check(state, codes_stack, props_stack)
        if dev.type != "cuda":
            per_step = []
            for i in range(chunk):
                state, m = step(state, codes_stack[i], None if props_stack is None else props_stack[i])
                per_step.append(m)
            return state, {name: torch.stack([m[name] for m in per_step]) for name in per_step[0]}
        values = schedule_vectors(cfg, state.base_seed, state.step, state.opt_state.count, chunk)
        captured = graphs.get(state.params)
        if captured is None or captured.key != _chunk_key(state, codes_stack, props_stack):
            captured = graphs[state.params] = CapturedChunk(cfg, chunk, state, codes_stack, props_stack, values)
        metrics = captured.replay(codes_stack, props_stack, values)
        state.opt_state.count += chunk
        return state._replace(step=state.step + chunk), metrics

    train_chunk.graphs = graphs
    return train_chunk


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


# -- the training loop ---------------------------------------------------------

_PROBE_SALT = 0x7EED5EED  # the round-trip probe's seed, disjoint from the train steps' and the eval's


def _cadence_crossed(every: int, prev_step: int, now_step: int) -> bool:
    """True iff a multiple of ``every`` lies in (prev_step, now_step].

    A chunk advances K steps per host iteration; eval and checkpoint
    actions run at chunk boundaries, so they fire at most once per host
    iteration: once per crossed window when ``every >= K``, once per chunk
    (not per window) when ``every`` is smaller than K, which ``train``
    warns about."""
    return every > 0 and now_step // every > prev_step // every


class PosteriorCollapseError(RuntimeError):
    """Raised by ``train`` when the posterior-collapse guard trips
    (``TrainConfig.collapse_std_floor`` / ``collapse_abort``). The run
    checkpoints before raising (when checkpointing is on), so the state at
    the moment of detection is recoverable."""


def _warn(msg: str) -> None:
    print(f"[molvax] {msg}", file=sys.stderr)


def train(
    cfg,
    dataset=None,
    eval_dataset=None,
    device: Optional[Union[str, torch.device]] = None,
    metrics_path: Optional[str] = None,
    max_steps: Optional[int] = None,
    verbose: bool = True,
) -> Tuple[TrainState, list]:
    """End-to-end training per config (the reference's ``train``,
    ``loop.py:286-740``). Returns (final state, metric history).

    Runs on ``device``, the card unless the caller asks for the CPU (data
    parallelism is not ported). The K-step chunk (``make_train_chunk``, one
    CUDA Graph on the card) runs wherever ``step + K <= total``, single
    steps of ``make_train_step`` the tail; each step is logged at its own
    cadence from the chunk's stacked metrics, pulled to the host in one
    copy before the next replay rewrites them. With
    ``cfg.train.eval_every`` set, a held-out eval (teacher-forced ELBO and
    recon accuracy, and the free-running round-trip probe when
    ``eval_roundtrip_n > 0``) runs on ``eval_dataset`` (or a split carved
    from ``dataset``) with the weights inference reads (the EMA where there
    is one, for both) and logs metrics prefixed ``eval_``.

    With ``cfg.train.checkpoint_dir`` set: ``charset.json`` and
    ``config.json`` beside the checkpoints; the latest checkpoint restored
    and the data and eval streams fast-forwarded to it, so a resumed run
    takes the batches an uninterrupted one would; a checkpoint at the
    cadence and at the end; on SIGTERM / SIGINT the current chunk or step
    ends, the run checkpoints and returns (a second signal kills the
    process with the default disposition; the handlers are restored when
    ``train`` returns or raises). ``select_best`` keeps device copies of
    the weights (and EMA) with the best probe, writes them to ``best/``
    (with ``best/probe.json``) and returns them; a standing ``best/`` that
    this run did not beat is loaded back, unless it is incompatible. The
    posterior-collapse guard reads ``post_std_batch`` at log cadence.
    Nothing falls back: a checkpoint that cannot be restored raises
    (``io.checkpoint``), and the chunk never gives way to eager steps."""
    dev = resolve_device(device)
    t = cfg.train
    if dataset is None:
        dataset = load_dataset(cfg.data.source, max_len=cfg.data.max_len, synthetic_n=cfg.data.n_synthetic,
                               seed=cfg.data.seed, with_properties=cfg.model.n_properties > 0,
                               property_source=cfg.data.property_source)
    cfg = effective_config(cfg, dataset)
    if eval_dataset is None and t.eval_every:
        dataset, eval_dataset = dataset.split(cfg.data.test_fraction, cfg.data.seed)
    with_props = cfg.model.n_properties > 0
    it = BatchIterator(dataset, t.batch_size, seed=t.seed, device=dev, with_properties=with_props)
    state = init_state(cfg, device=dev)
    train_step = make_train_step(cfg)
    total_steps = max_steps if max_steps is not None else (t.steps or t.epochs * max(it.steps_per_epoch, 1))

    manager = None
    if t.checkpoint_dir:
        manager = ckpt_io.make_manager(t.checkpoint_dir, keep=t.keep_checkpoints)
        # inference decodes with the exact table the model was trained on,
        # and the directory alone is enough to restore
        with open(os.path.join(t.checkpoint_dir, "charset.json"), "w") as f:
            json.dump(list(dataset.charset.chars), f)
        with open(os.path.join(t.checkpoint_dir, "config.json"), "w") as f:
            json.dump(to_dict(cfg), f, indent=1)
        restored = manager.restore_latest(state)
        if restored is not None:
            state = restored

    eval_step = eval_it = None
    if t.eval_every and t.eval_batches > 0 and eval_dataset is not None and len(eval_dataset) > 0:
        eval_step = make_eval_step(cfg)
        eval_it = BatchIterator(eval_dataset, t.batch_size, seed=t.seed + 1, device=dev, with_properties=with_props)
    if t.eval_roundtrip_n > 0 and eval_step is None:
        _warn("eval_roundtrip_n > 0 needs eval_every > 0, eval_batches > 0 and a held-out split; "
              "the round-trip probe will not run")

    chunk = max(1, t.train_chunk_size)
    if chunk > 1:
        for name, every in (("eval_every", t.eval_every), ("checkpoint_every", t.checkpoint_every)):
            if every and every < chunk:
                _warn(f"{name}={every} < train_chunk_size={chunk}: actions fire at chunk boundaries, at most "
                      "once per chunk (raise the cadence or shrink the chunk)")
    train_chunk = make_train_chunk(cfg, chunk, device=dev) if chunk > 1 else None

    select_best = t.select_best
    best = {"metric": -1.0, "params": None, "ema": None, "step": -1}
    if select_best and (t.eval_roundtrip_n <= 0 or eval_step is None):
        _warn("select_best needs eval_every > 0, eval_batches > 0, eval_roundtrip_n > 0 and a held-out split; "
              "falling back to last-step selection")
        select_best = False
    best_dir = os.path.join(t.checkpoint_dir, "best") if t.checkpoint_dir else None
    best_meta_path = os.path.join(best_dir, "probe.json") if best_dir else None
    if select_best and best_meta_path and os.path.exists(best_meta_path):
        # a rerun on this directory must not let a worse segment overwrite best/
        with open(best_meta_path) as f:
            prior = json.load(f)
        best["metric"] = float(prior.get("metric", -1.0))
        best["step"] = int(prior.get("step", -1))
        _warn(f"select_best: existing best/ has probe {best['metric']:.4f} at step {best['step']}; this run only "
              "replaces it if beaten")

    def consider_best(metric: float, st: TrainState, at_step: int) -> None:
        if metric > best["metric"]:
            # device copies of what inference reads (weights and EMA); not
            # the Adam moments, which would hold ~2x the weights' bytes
            best["metric"] = metric
            best["params"] = {n: p.detach().clone() for n, p in st.params.named_parameters()}
            best["ema"] = None if st.ema_params is None else {n: e.clone() for n, e in st.ema_params.items()}
            best["step"] = at_step

    guard_floor = t.collapse_std_floor
    guard = {"warned": False}
    if guard_floor > 0 and t.log_every <= 0:
        _warn("collapse_std_floor set but log_every=0: the guard only checks at log cadence and will never fire")

    def collapse_check(entry: dict) -> None:
        v, s = entry.get("post_std_batch"), entry["step"]
        if guard_floor <= 0 or v is None or s < t.collapse_guard_after:
            return
        if v >= guard_floor:
            guard["warned"] = False
            return
        msg = (f"[molvax] posterior collapse detected at step {s}: post_std_batch={v:.4g} < "
               f"collapse_std_floor={guard_floor:g} (aggregate-z spread collapsed; see "
               "TrainConfig.collapse_std_floor)")
        if t.collapse_abort:
            if manager is not None:
                # under the host step: detection at step s may sit mid-chunk,
                # while ``state`` is already the chunk's last
                manager.save(step_now, state)
                manager.wait_until_finished()
                msg += f" — checkpointed at step {step_now}"
            raise PosteriorCollapseError(msg)
        if not guard["warned"]:
            print(msg + " - continuing (collapse_abort=False)", file=sys.stderr)
            guard["warned"] = True

    def roundtrip_probe(st: TrainState) -> Dict[str, float]:
        """The free-running round-trip probe on the weights inference reads."""
        gen = torch.Generator().manual_seed(fold_in(st.base_seed, _PROBE_SALT))
        return reconstruction_metrics(ema_eval_state(st).params, cfg, eval_dataset, gen,
                                      n=min(t.eval_roundtrip_n, len(eval_dataset)))

    logger = MetricsLogger(metrics_path, stream=sys.stderr if verbose else False)
    history = []
    last_probe = {"step": -1, "metric": -1.0}
    stop = {"flag": False}
    old_handlers = {}
    step_now = state.step
    try:
        # preemption: finish the current chunk or step, checkpoint, return
        if manager is not None and threading.current_thread() is threading.main_thread():

            def on_signal(signum, frame):
                if stop["flag"]:
                    # the second signal: the default disposition, delivered
                    # again, so the process dies even if a device call hangs
                    signal.signal(signum, signal.SIG_DFL)
                    os.kill(os.getpid(), signum)
                    return
                stop["flag"] = True

            for sig in (signal.SIGTERM, signal.SIGINT):
                old_handlers[sig] = signal.signal(sig, on_signal)
        if step_now > 0:
            # the shuffle replayed: one batch per optimizer step, and the
            # eval stream's eval_batches per crossed cadence window
            it.fast_forward(step_now)
            if eval_it is not None:
                eval_it.fast_forward((step_now // t.eval_every) * t.eval_batches)
        while step_now < total_steps:
            prev_step = step_now
            if train_chunk is not None and step_now + chunk <= total_steps:
                codes_stack, props_stack = it.next_stack(chunk)
                state, stacked = train_chunk(state, codes_stack, props_stack)
                step_now += chunk
                if t.log_every > 0:
                    rows = None
                    for i in range(chunk):
                        s = prev_step + i + 1
                        if s % t.log_every == 0 or s == total_steps:
                            if rows is None:
                                rows = host_rows(stacked)
                            entry = logger.log(s, rows[i])
                            history.append(entry)
                            collapse_check(entry)
            else:
                codes, props = next(it)
                state, metrics = train_step(state, codes, props)
                step_now += 1
                if t.log_every > 0 and (step_now % t.log_every == 0 or step_now == total_steps):
                    entry = logger.log(step_now, metrics)
                    history.append(entry)
                    collapse_check(entry)
            if eval_step is not None and _cadence_crossed(t.eval_every, prev_step, step_now):
                ev = ema_eval_state(state)
                acc = []
                for _ in range(t.eval_batches):
                    e_codes, e_props = next(eval_it)
                    acc.append(eval_step(ev, e_codes, e_props))
                mean = {f"eval_{k}": torch.stack([m[k] for m in acc]).mean() for k in acc[0]}
                if t.eval_roundtrip_n > 0:
                    rt = roundtrip_probe(ev)
                    mean.update({f"eval_{k}": v for k, v in rt.items()})
                    last_probe.update(step=step_now, metric=rt["recon_char_acc_nonpad"])
                    if select_best:
                        consider_best(rt["recon_char_acc_nonpad"], state, step_now)
                history.append(logger.log(step_now, mean))
            if manager is not None and _cadence_crossed(t.checkpoint_every, prev_step, step_now):
                manager.save(step_now, state)
            if stop["flag"]:
                _warn(f"signal received: checkpointing at step {step_now} and stopping")
                break
        if manager is not None:
            manager.save(step_now, state)
            manager.wait_until_finished()
        if select_best:
            # the final iterate competes too, unless the cadence probe
            # already measured this step
            if last_probe["step"] == step_now:
                final_metric = last_probe["metric"]
            else:
                final_metric = roundtrip_probe(state)["recon_char_acc_nonpad"]
                consider_best(final_metric, state, step_now)
            if best["params"] is not None:
                if best["step"] != step_now:
                    _warn(f"select_best: step {best['step']} probe {best['metric']:.4f} beats final step "
                          f"{step_now} ({final_metric:.4f}); returning it")
                # the winner into the state's own tensors; the Adam state
                # stays the last step's (best/ is for inference, resume
                # reads the last-step checkpoints)
                with torch.no_grad():
                    for n, p in state.params.named_parameters():
                        p.copy_(best["params"][n])
                    for n, e in (best["ema"] or {}).items():
                        state.ema_params[n].copy_(e)
                state = state._replace(step=best["step"])
                if manager is not None:
                    best_mgr = ckpt_io.make_manager(best_dir, keep=1)
                    # forced: a stale best/ may hold a later step
                    best_mgr.save(best["step"], state, force=True)
                    best_mgr.wait_until_finished()
                    with open(best_meta_path, "w") as f:
                        json.dump({"step": best["step"], "metric": best["metric"]}, f)
            elif best["step"] >= 0:
                _warn(f"select_best: existing best/ (probe {best['metric']:.4f} at step {best['step']}) stands; "
                      "this run did not beat it")
                # train() returns the selected iterate: the standing winner,
                # unless best/ is incompatible with this config (failing
                # here would discard the whole run)
                try:
                    restored = ckpt_io.make_manager(best_dir, keep=1).restore_latest(init_state(cfg, device=dev))
                except ValueError as e:
                    _warn(f"select_best: standing best/ is incompatible with this config ({e}); returning this "
                          "run's final state instead")
                    restored = None
                if restored is not None:
                    state = restored
    finally:
        # the handlers and the log are restored and closed even when the
        # loop raises: a stale handler would leave the process unkillable
        # by one signal for the rest of its life
        for sig, h in old_handlers.items():
            signal.signal(sig, h)
        logger.close()
    return state, history
