"""The training step and the chunk of K steps: Adam with optax's schedules
and clip, ELBO, EMA.

Port of ``molvax/train/loop.py:55-283``: ``TrainState``,
``effective_config``, ``ema_eval_state``, ``init_state``,
``make_optimizer``, ``make_train_step``, ``make_train_chunk`` and
``make_eval_step``.

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
import math
import sys
import time
import weakref
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..kernels.generate import fold_in, fold_in_range
from ..nn.vae import MolecularVAE, forward
from ..utils import PinnedStaging, matmul_dtype, resolve_device
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
    before the update. ``count`` is the number of updates made.

    The learning rate is a 0-d fp32 tensor on the parameters' device
    (``lr``), written by every update. On a card, torch's Adam runs
    ``capturable`` (its step counts and bias corrections on the device),
    and its state tensors are made here, so that no update reads a host
    value and a CUDA Graph can capture updates without making state inside
    the capture. torch refuses ``capturable`` on the CPU, where Adam runs
    its single-tensor path with the same tensor learning rate."""

    def __init__(self, params, train_cfg):
        self.params = list(params)
        self.schedule = learning_rate_schedule(train_cfg)
        self.clip = train_cfg.grad_clip_norm
        dev = self.params[0].device
        cuda = dev.type == "cuda"
        self.lr = torch.full((), self.schedule(0), dtype=torch.float32, device=dev)
        self.adam = torch.optim.Adam(self.params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8, foreach=cuda,
                                     capturable=cuda)
        if cuda:
            for p in self.params:
                self.adam.state[p] = {
                    "step": torch.zeros((), dtype=torch.float32, device=dev),
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


def host_seed_reason(cfg, device) -> Optional[str]:
    """Why a step of ``cfg`` on ``device`` needs its seed as a host int (and
    so cannot be captured in a CUDA Graph), or None. The plain sampler path
    (not the fused sampler: strict fp32, or ``use_pallas`` off) draws eps
    from a ``torch.Generator`` that a host int seeds."""
    if cfg.model.use_pallas and matmul_dtype(cfg.model, device) == torch.bfloat16:
        return None
    return ("the plain sampler path (use_pallas off or fp32 matmuls) draws eps from a torch.Generator "
            "seeded by a host int each step, which a CUDA Graph would freeze")


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
    value a Python number or a 0-d tensor on the model's device; the seed
    an int where ``host_seed_reason`` says so. Returns the metrics, 0-d
    tensors on the device. Advances no counter: the caller does."""
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
        seed = seeds[0]
        if host_seed_reason(cfg, codes.device) is not None:
            seed = fold_in(state.base_seed, state.step)
        metrics = step_body(cfg, state, codes, props, seed, beta[0], ss[0], lr[0])
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
        input (and of the properties), one of the values, one replay."""
        self.codes.copy_(codes_stack)
        if self.props is not None:
            self.props.copy_(props_stack)
        self.staging.copy(values.shape, torch.int32, lambda buf: np.copyto(buf, values), out=self.values)
        self.graph.replay()
        return self.metrics


def _chunk_key(state: TrainState, codes_stack, props_stack) -> Tuple:
    """What a captured chunk is bound to: the addresses of the state's
    tensors (weights, Adam state, learning rate, EMA), which the graph reads
    and writes in place, and the inputs' shapes and types. A state whose
    tensors moved is captured anew."""
    opt = state.opt_state
    tensors = [*opt.params, opt.lr, *(t for p in opt.params for t in opt.adam.state[p].values()),
               *(state.ema_params or {}).values()]
    props = None if props_stack is None else (tuple(props_stack.shape), props_stack.dtype)
    return (tuple(t.data_ptr() for t in tensors), tuple(codes_stack.shape), codes_stack.dtype, props)


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
    before it. A configuration whose step cannot be captured raises
    (``host_seed_reason``); it never falls back to eager steps. On the CPU
    (``device="cpu"``) the chunk is K eager steps through the same body."""
    if chunk < 1:
        raise ValueError(f"make_train_chunk: chunk must be >= 1, got {chunk}")
    want = torch.device("cuda" if device is None else device)
    if want.type == "cuda":
        reason = host_seed_reason(cfg, want)
        if reason is not None:
            raise ValueError(f"make_train_chunk: {cfg.name} cannot be captured in a CUDA Graph: {reason}")
    dev = resolve_device(want)
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
