"""Training traffic: the chunked trainer fed from the data layer, as ``train()`` feeds it.

Set-up makes the corpus (``corpus.train_corpus``) and the weights
(``weights.make``) from the seed, builds one training state
(``train.init_state``), the data layer (``data.BatchIterator``) and the
K-step chunk (``train.make_train_chunk``, one CUDA Graph on a card), and
drives that state through the first chunk on the first stack, whose K
batches hold every row of the corpus once. It keeps what the check needs
of it: each step's loss, the stack, and per parameter the norm of Adam's
first moment (the gradients as the optimizer got them) and of the change
of the weights. One more chunk warms the replay. The window then feeds
each chunk by ``next_stack(K)`` and calls the same chunk on the same
state, until ``--seconds`` have passed, and drains the device.

The check runs the plain reference (``reference.model.train``, fp32, TF32
off) over the first chunk's K steps from the same weights, on the batches
that it works out itself from the corpus and the data seed, with the noise
it works out itself from the step seeds. ``numbers`` gives every number it
can compare, and a cell compares those that its limits name:
``data_rows``, the stack's rows that are not the reference's batches;
``loss_first`` and ``loss_gap``, the relative gap of the first step's loss
and the largest over the K steps; ``adam_m_gap`` and ``adam_m_median``,
the worst and the median parameter's gap between the norms of Adam's first
moment (the gradients as the optimizer got them), and ``update_gap`` and
``update_median`` the worst and the median parameter's gap of the norms of
the weights' change, each over the
reference's norm of that parameter or of the median parameter, whichever
is larger, among the parameters whose first moment in the reference is at
least a thousandth of the median's.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import corpus, weights
from ..reference import model as ref
from ..reference import noise

_DATA_SALT = 0xDA7A
_STATE_SALT = 0x57A7


def seeds_of(seed: int) -> Tuple[int, int]:
    """(the training state's seed, the data order's seed) of a run seed."""
    return (seed ^ _STATE_SALT) & 0xFFFFFFFF, (seed * 3 + _DATA_SALT) & 0x7FFFFFFFFFFF


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def first_use(ctx) -> None:
    """``import torch._dynamo``: the optimizer's first construction
    (``init_state``) imports it, and so does the profiler's first start. The
    harness runs this before that start in every run, so the state's part
    holds the same work traced and untraced."""
    t = time.perf_counter()
    import torch._dynamo  # noqa: F401

    ctx.part("import_dynamo", t)


def setup(ctx) -> None:
    t = time.perf_counter()
    from molvax_torch.data import BatchIterator
    from molvax_torch.data.charset import Charset
    from molvax_torch.data.zinc import Dataset
    from molvax_torch.kernels import _build
    from molvax_torch.train import init_state, make_train_chunk

    s, mix, dev = ctx.sizes, ctx.mix, ctx.device
    K, B = s["train_chunk_size"], s["batch_size"]
    t = ctx.part("import_program", t)
    if dev.type == "cuda":
        _build.load()
    t = ctx.part("library", t)
    codes = corpus.train_corpus(ctx.seed, mix["corpus_rows"], s["max_len"], s["charset_size"], mix["len_min"],
                                mix["len_max"])
    t = ctx.part("corpus", t)
    w = weights.make(s, ctx.seed, dev)
    ctx.sync()
    t = ctx.part("weights", t)
    state_seed, data_seed = seeds_of(ctx.seed)
    state = init_state(ctx.cfg, seed=state_seed, device=dev, weights=w)
    ctx.sync()
    t = ctx.part("init_state", t)
    it = BatchIterator(Dataset(codes, Charset()), B * ctx.world, seed=data_seed, device=dev, mesh=ctx.mesh)
    chunk = make_train_chunk(ctx.cfg, K, device=dev, mesh=ctx.mesh)
    t = ctx.part("data_and_chunk", t)
    stack, props = it.next_stack(K)
    state, m = chunk(state, stack, props)
    ctx.sync()
    first = {"losses": m["loss"].double().cpu().numpy().copy(), "stack": stack.cpu().numpy().copy()}
    if ctx.world > 1:  # every rank's rows of the global batches, on rank 0
        stacks = [None] * ctx.world
        torch.distributed.all_gather_object(stacks, first["stack"], group=ctx.mesh.host_group)
        first["stack"] = np.concatenate(stacks, axis=1)
    named = dict(state.params.named_parameters())
    adam = state.opt_state.adam.state
    first["m"] = _norms({k: adam[p]["exp_avg"] for k, p in named.items()})
    first["change"] = _norms({k: p.detach() - w[k] for k, p in named.items()})
    del w
    t = ctx.part("first_chunk", t)
    state, m = chunk(state, *it.next_stack(K))
    ctx.sync()
    ctx.part("warm_chunk", t)
    ctx.state.update(state=state, it=it, chunk=chunk, K=K, B=B, first=first, codes=codes, data_seed=data_seed,
                     state_seed=state_seed)


def window(ctx, seconds: float, tw) -> dict:
    st, spans = ctx.state, ctx.spans
    state, it, chunk, K, B = st["state"], st["it"], st["chunk"], st["K"], st["B"]
    steps, i = 0, 0
    t0 = time.perf_counter()
    while not ctx.agreed(time.perf_counter() - t0 - tw.paused >= seconds):
        tw.before(i)
        with spans("next_stack"):
            stack, props = it.next_stack(K)
        with spans("chunk"):
            state, m = chunk(state, stack, props)
        steps += K
        tw.after(i, steps=K, smiles=K * B * ctx.world)
        i += 1
    ctx.sync()
    elapsed = time.perf_counter() - t0 - tw.paused
    last = m["loss"].double().cpu().numpy()
    st["state"] = state
    return {
        "metrics": {"train_smiles_per_s": steps * B * ctx.world / elapsed},
        "attempted": steps,
        "failed": int((~np.isfinite(last)).sum()),
    }


def release(ctx) -> None:
    for k in ("state", "it", "chunk"):
        ctx.state.pop(k, None)


def reference_run(ctx, q=ref.exact, rows=None) -> Tuple[np.ndarray, List[float], Dict[str, float], Dict[str, float]]:
    """The reference over the first chunk: (its batches (K, B, T), each
    step's loss, the norms of its first moment and of its change)."""
    s, st, dev = ctx.sizes, ctx.state, ctx.device
    K, B = st["K"], st["B"] * ctx.world
    order = corpus.batch_order(st["data_seed"], len(st["codes"]), B, K)
    batches = st["codes"][order]
    base = noise.fold_in(st["state_seed"], 1)
    eps = [noise.normal(int(sd), B, s["latent_dim"], dev) for sd in noise.step_seeds(base, 0, K)]
    p = weights.make(s, ctx.seed, dev)
    start = {k: v.clone() for k, v in p.items()}
    losses, opt = ref.train(p, s, torch.from_numpy(batches).to(dev), eps, q, rows)
    change = _norms({k: p[k] - start[k] for k in p})
    return batches, losses, _norms(opt.m), change


def leaf_gaps(prog: Dict[str, float], refn: Dict[str, float], keep) -> List[float]:
    """Each kept parameter's |prog - ref| over max(ref, the median ref)."""
    median = float(np.median([refn[k] for k in keep]))
    return [abs(prog[k] - refn[k]) / max(refn[k], median) for k in keep]


def numbers(ctx, prog: dict, refr: tuple) -> Dict[str, float]:
    """Every number that the check can compare, of a program's first chunk
    against a reference run; a cell compares those its limits name."""
    batches, losses, m_ref, ch_ref = refr
    median_m = float(np.median(list(m_ref.values())))
    keep = [k for k, v in m_ref.items() if v >= 1e-3 * median_m]
    stack, losses = prog["stack"], np.asarray(losses)
    loss = np.abs(prog["losses"] - losses) / np.abs(losses)
    m, ch = leaf_gaps(prog["m"], m_ref, keep), leaf_gaps(prog["change"], ch_ref, keep)
    return {
        "data_rows": float((stack.reshape(-1, stack.shape[-1]) != batches.reshape(-1, batches.shape[-1]))
                           .any(axis=1).sum()),
        "loss_first": float(loss[0]),
        "loss_gap": float(loss.max()),
        "adam_m_gap": max(m),
        "adam_m_median": float(np.median(m)),
        "update_gap": max(ch),
        "update_median": float(np.median(ch)),
    }


def check(ctx) -> List[Tuple[str, float, float]]:
    got = numbers(ctx, ctx.state["first"], reference_run(ctx))
    return [(k, got[k], float(limit)) for k, limit in ctx.cell["limits"].items()]


def readings(ctx, control: bool, witness: bool = False) -> dict:
    """The check's numbers of this run's set-up (no window); with
    ``witness`` those of the reference in bf16, the configurations'
    precision, against itself in fp32 (what that precision alone does to
    the run); with ``control`` those of the reference in fp8 put in the
    program's place and of the reference with half of each batch left out."""
    base = reference_run(ctx)
    first = ctx.state["first"]
    out = {"program": numbers(ctx, first, base),
           "raw": {"reference": {"losses": list(base[1]), "m": base[2], "change": base[3]},
                   "program": {"losses": list(first["losses"]), "m": first["m"], "change": first["change"]}}}
    runs = (("witness_bf16", {"q": ref.bf16}),) if witness else ()
    if control:
        runs += (("control_fp8", {"q": ref.fp8}), ("half_batch", {"rows": ctx.state["B"] * ctx.world // 2}))
    for name, kw in runs:
        batches, losses, m, change = reference_run(ctx, **kw)
        out[name] = numbers(ctx, {"losses": np.asarray(losses), "stack": batches, "m": m, "change": change}, base)
        out["raw"][name] = {"losses": list(losses), "m": m, "change": change}
    return out

