"""Data parallelism of the port (``molvax_torch.parallel``) on the CPU: gloo
ranks started with ``torch.multiprocessing`` (the counterpart of
``tests/distributed/test_gspmd.py`` and ``test_gspmd_chunk.py``, which run
the reference's GSPMD mesh on fake devices).

The contract is the reference's: an N-rank step is the 1-rank step on the
same global batch. One 4-rank world (a file store under the test's
``tmp_path``, never a fixed port) runs every multi-rank case once; each
test below reads its part. The steps run with noise on (eps_scale 1, word
dropout, scheduled sampling), so a rank that drew another rank's noise
would fail. JAX is imported only inside the functions that compare against
it: the ranks import this module and never load it.
"""

import copy
import dataclasses
import itertools
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from molvax_torch import config as tconfig
from molvax_torch.data import synthetic_dataset
from molvax_torch.data.charset import DEFAULT_CHARSET
from molvax_torch.io.checkpoint import state_payload
from molvax_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    make_mesh,
    replicate,
    shard_batch,
    shard_stacked_batch,
)
from molvax_torch.train import init_state, make_eval_step, make_train_chunk, make_train_step

T = 32
WORLD = 4
B = 16
STEPS = 4
K = 3
# the reference's DP-vs-1-device gates (tests/distributed/test_gspmd.py)
RTOL, ATOL = 2e-5, 2e-6
JAX_TOL = 2e-4


def tiny_cfg(batch_size: int = B, noise: bool = True, **model) -> tconfig.Config:
    """The reference's tiny DP config; with ``noise`` eps_scale 1, word
    dropout 0.2 and scheduled sampling 0.5 from step 1."""
    train = dict(batch_size=batch_size, learning_rate=1e-3)
    if noise:
        train.update(word_dropout=0.2, scheduled_sampling=0.5, scheduled_sampling_warmup=1)
    return tconfig.Config(
        model=tconfig.ModelConfig(max_len=T, charset_size=DEFAULT_CHARSET.size, latent_dim=12, enc_hidden=16,
                                  gru_hidden=16, gru_layers=2, eps_scale=1.0 if noise else 0.0, **model),
        train=tconfig.TrainConfig(**train),
        data=tconfig.DataConfig(max_len=T),
    )


# -- ranks ---------------------------------------------------------------------

_runs = itertools.count()


def _rank_main(rank: int, world: int, fn, root: str, args) -> None:
    """One rank: joins the gloo world through the file store in ``root``,
    runs ``fn(rank, world, *args)`` and saves its result as rank<r>.pt."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/store", world_size=world, rank=rank)
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(tmp_path, world: int, fn, *args, timeout: float = 240.0) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned processes (gloo on
    the CPU); the ranks' results in order. A rank that raises fails the
    call with its traceback; a world that outlives ``timeout`` is
    killed."""
    root = tmp_path / f"ranks{next(_runs)}"
    root.mkdir()
    ctx = torch.multiprocessing.start_processes(_rank_main, args=(world, fn, str(root), args), nprocs=world,
                                                join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise AssertionError(f"{world} ranks of {fn.__name__} outlived {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    return [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(world)]


def payload(state) -> dict:
    """A copy of the state's tensors and counters, on the CPU (a
    checkpoint's; ``state_payload`` alone aliases a CPU state's tensors,
    which the next step updates in place)."""
    return copy.deepcopy(state_payload(state))


def host(metrics: dict) -> dict:
    return {k: v.detach().cpu().clone() for k, v in metrics.items()}


def assert_payload_close(got: dict, want: dict, rtol: float = RTOL, atol: float = ATOL, exact: bool = False):
    """Weights, Adam moments and steps, EMA by name; counters equal."""
    for key in ("step", "base_seed", "count"):
        assert got[key] == want[key], key
    for part in ("params", "adam", "ema"):
        a, b = got[part], want[part]
        assert (a is None) == (b is None), part
        if a is None:
            continue
        flat_a = {(n, k): v for n, d in a.items() for k, v in (d.items() if isinstance(d, dict) else [("", d)])}
        flat_b = {(n, k): v for n, d in b.items() for k, v in (d.items() if isinstance(d, dict) else [("", d)])}
        assert flat_a.keys() == flat_b.keys(), part
        for name in flat_a:
            if exact:
                assert torch.equal(flat_a[name], flat_b[name]), (part, name)
            else:
                torch.testing.assert_close(flat_a[name], flat_b[name], rtol=rtol, atol=atol, msg=f"{part} {name}")


def assert_metrics_close(got: dict, want: dict, rtol: float = RTOL, atol: float = ATOL):
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=rtol, atol=atol, msg=k)


# -- the 4-rank world's cases --------------------------------------------------


def _dp_worker(rank: int, world: int, cfg, weights, codes, jax_cfg, jax_weights, jax_codes) -> dict:
    out = {}
    mesh = make_mesh(device="cpu")
    out["mesh"] = (mesh.shape, mesh.data_rank, mesh.model_rank, mesh.is_main, mesh.ranks)
    grid = make_mesh(tconfig.MeshConfig(data_axis=2, model_axis=2), device="cpu")
    out["grid"] = (grid.shape, grid.data_rank, grid.model_rank)
    big = tconfig.MeshConfig(data_axis=8)
    try:
        make_mesh(big, device="cpu")
    except ValueError as e:
        out["too_big"] = str(e)
    rows = np.arange(B * T).reshape(B, T)
    out["shard"] = shard_batch(mesh, rows)
    out["shard_pair"] = shard_batch(mesh, rows, None)
    out["shard_grid"] = shard_batch(grid, rows)
    out["stack"] = shard_stacked_batch(mesh, np.arange(K * B * T).reshape(K, B, T))
    try:
        shard_batch(mesh, rows[:6])
    except ValueError as e:
        out["indivisible"] = str(e)

    # every rank starts from other weights; replicate gives rank 0's
    own = init_state(cfg, seed=100 + rank, device="cpu")
    own = own._replace(step=rank, base_seed=own.base_seed + rank)
    out["replicated"] = payload(replicate(mesh, own))

    state = replicate(mesh, init_state(cfg, device="cpu", weights=weights))
    step = make_train_step(cfg, mesh)
    metrics = []
    for i in range(STEPS):
        state, m = step(state, shard_batch(mesh, codes[i * B:(i + 1) * B]))
        metrics.append(host(m))
        if i == 0:
            out["step1"] = payload(state)
    out["steps"], out["state"] = metrics, payload(state)
    out["grad_numel"] = step.grad_mean.numel
    out["eval"] = host(make_eval_step(cfg, mesh)(state, shard_batch(mesh, codes[:B])))

    chunk = make_train_chunk(cfg, K, device="cpu", mesh=mesh)
    state = init_state(cfg, device="cpu", weights=weights)
    state, m = chunk(state, shard_stacked_batch(mesh, codes[: K * B].reshape(K, B, T)))
    out["chunk"], out["chunk_metrics"] = payload(state), host(m)

    sub = make_mesh(ranks=[0, 1], device="cpu")
    half = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=B // 2))
    if sub.member:
        state = init_state(half, device="cpu", weights=weights)
        state, m = make_train_step(half, sub)(state, shard_batch(sub, codes[: B // 2]))
        out["subset"] = (payload(state), host(m))
    else:
        try:
            make_train_step(half, sub)
        except ValueError as e:
            out["subset"] = str(e)

    state = init_state(jax_cfg, device="cpu", weights=jax_weights)
    state, m = make_train_step(jax_cfg, mesh)(state, shard_batch(mesh, jax_codes))
    out["jax_step"] = (payload(state), host(m))
    return out


def _jax_case():
    """(port cfg, reference cfg, reference params as a port state dict,
    codes): the reference's tiny config in fp32 at eps_scale 0 with the
    reference's own init, carried by io/convert.py."""
    import jax

    from molvax import train as jtrain
    from molvax.config import Config as JConfig, DataConfig as JData, ModelConfig as JModel
    from molvax.config import TrainConfig as JTrain
    from molvax_torch.io.convert import state_dict_from_jax

    model = dict(max_len=T, charset_size=DEFAULT_CHARSET.size, latent_dim=12, enc_hidden=16, gru_hidden=16,
                 gru_layers=2, eps_scale=0.0)
    jcfg = JConfig(model=JModel(**model), train=JTrain(batch_size=B, learning_rate=1e-3), data=JData(max_len=T))
    tcfg = tconfig.Config(model=tconfig.ModelConfig(**model), train=tconfig.TrainConfig(batch_size=B,
                                                                                          learning_rate=1e-3),
                          data=tconfig.DataConfig(max_len=T))
    jstate = jtrain.init_state(jcfg)
    weights = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    codes = synthetic_dataset(64, max_len=T, seed=5).codes[:B]
    return tcfg, jcfg, weights, codes


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The 4-rank world's results beside the 1-rank runs they are held to."""
    cfg = tiny_cfg()
    weights = init_state(cfg, seed=7, device="cpu").params.state_dict()
    codes = synthetic_dataset(64, max_len=T, seed=1).codes[: STEPS * B]
    jax_tcfg, jcfg, jax_weights, jax_codes = _jax_case()
    ranks = run_ranks(tmp_path_factory.mktemp("dp"), WORLD, _dp_worker, cfg, weights, codes, jax_tcfg, jax_weights,
                      jax_codes)

    one = {}
    state = init_state(cfg, device="cpu", weights=weights)
    step = make_train_step(cfg)
    metrics = []
    for i in range(STEPS):
        state, m = step(state, torch.from_numpy(codes[i * B:(i + 1) * B]))
        metrics.append(host(m))
        if i == 0:
            one["step1"] = payload(state)
    one["steps"], one["state"] = metrics, payload(state)
    one["eval"] = host(make_eval_step(cfg)(state, torch.from_numpy(codes[:B])))
    state, m = make_train_chunk(cfg, K, device="cpu")(init_state(cfg, device="cpu", weights=weights),
                                                      torch.from_numpy(codes[: K * B].reshape(K, B, T)))
    one["chunk"], one["chunk_metrics"] = payload(state), host(m)
    half = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=B // 2))
    state, m = make_train_step(half)(init_state(half, device="cpu", weights=weights),
                                     torch.from_numpy(codes[: B // 2]))
    one["subset"] = (payload(state), host(m))
    return {"ranks": ranks, "one": one, "cfg": cfg, "weights": weights, "jax": (jcfg, jax_weights, jax_codes)}


def test_make_mesh_sizes_and_errors(dp):
    for r, out in enumerate(dp["ranks"]):
        assert out["mesh"] == ({DATA_AXIS: WORLD, MODEL_AXIS: 1}, r, 0, r == 0, (0, 1, 2, 3))
        # ranks[d * model + m], as the reference's grid.reshape(data, model)
        assert out["grid"] == ({DATA_AXIS: 2, MODEL_AXIS: 2}, r // 2, r % 2)
        assert out["too_big"] == "mesh 8x1 needs 8 devices, have 4"
    # no world: the 1-rank mesh, which makes no collective call
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {DATA_AXIS: 1, MODEL_AXIS: 1} and not mesh.collective and mesh.is_main
    with pytest.raises(ValueError, match=r"^mesh 2x1 needs 2 devices, have 1$"):
        make_mesh(tconfig.MeshConfig(data_axis=2), device="cpu")


def test_make_mesh_error_is_the_references():
    from molvax.config import MeshConfig as JMesh
    from molvax.parallel import make_mesh as j_make_mesh

    import jax

    with pytest.raises(ValueError) as ref:
        j_make_mesh(JMesh(data_axis=2), devices=jax.devices()[:1])
    with pytest.raises(ValueError) as port:
        make_mesh(tconfig.MeshConfig(data_axis=2), device="cpu")
    assert str(port.value) == str(ref.value)


def test_shard_batch_rows_and_the_stacked_axis(dp):
    rows = torch.arange(B * T).reshape(B, T)
    stack = torch.arange(K * B * T).reshape(K, B, T)
    per = B // WORLD
    for r, out in enumerate(dp["ranks"]):
        assert torch.equal(out["shard"], rows[r * per:(r + 1) * per])
        assert torch.equal(out["shard_pair"][0], out["shard"]) and out["shard_pair"][1] is None
        assert torch.equal(out["stack"], stack[:, r * per:(r + 1) * per])
        # model ranks of one data index take the same rows (P(DATA_AXIS))
        assert torch.equal(out["shard_grid"], rows[(r // 2) * 8:(r // 2 + 1) * 8])
        assert out["indivisible"] == "batch 6 not divisible by mesh data axis 4"
    mesh = make_mesh(device="cpu")
    assert torch.equal(shard_batch(mesh, rows.numpy()), rows)


def test_replicate_gives_every_rank_rank0s_state(dp):
    ranks = dp["ranks"]
    for out in ranks:
        assert_payload_close(out["replicated"], ranks[0]["replicated"], exact=True)
    assert ranks[0]["replicated"]["step"] == 0
    fresh = payload(init_state(dp["cfg"], seed=100, device="cpu"))
    assert_payload_close(ranks[0]["replicated"], fresh, exact=True)


def test_dp_step_matches_single_rank(dp):
    """Same global batch, same init, noise on: the 4-rank step is the
    1-rank step (the reference's rtol 2e-5, atol 2e-6); every rank holds
    the same state, bit for bit."""
    one = dp["one"]
    for out in dp["ranks"]:
        assert_payload_close(out["step1"], one["step1"])
        assert_metrics_close(out["steps"][0], one["steps"][0])
        assert_payload_close(out["step1"], dp["ranks"][0]["step1"], exact=True)
    n = sum(p.numel() for p in init_state(dp["cfg"], device="cpu").params.parameters())
    assert dp["ranks"][0]["grad_numel"] == n


def test_dp_multi_step_trajectory(dp):
    """Four steps stay in lockstep (scheduled sampling on from step 1)."""
    one = dp["one"]
    for out in dp["ranks"]:
        for got, want in zip(out["steps"], one["steps"]):
            assert_metrics_close(got, want, rtol=1e-5, atol=1e-5)
        assert_payload_close(out["state"], one["state"], rtol=1e-5, atol=1e-5)


def test_global_metrics_are_the_single_rank_batchs(dp):
    """post_std_batch (a variance over the batch) and acc_nonpad (a ratio
    of sums) are not means of per-rank values: both equal the 1-rank
    values, as do the eval step's."""
    one = dp["one"]
    for out in dp["ranks"]:
        for name in ("post_std_batch", "acc_nonpad", "acc", "kl", "recon", "elbo", "loss", "beta"):
            torch.testing.assert_close(out["steps"][0][name], one["steps"][0][name], rtol=1e-5, atol=1e-6,
                                       msg=name)
        assert_metrics_close(out["eval"], one["eval"], rtol=1e-5, atol=1e-6)


def test_uneven_mesh_subset(dp):
    """A 2-rank mesh of a 4-rank world: its ranks step on 8 rows as the
    1-rank step does; the others are outside it and take no step."""
    one_payload, one_metrics = dp["one"]["subset"]
    for r, out in enumerate(dp["ranks"]):
        if r < 2:
            assert_payload_close(out["subset"][0], one_payload)
            assert_metrics_close(out["subset"][1], one_metrics)
        else:
            assert "outside the mesh" in out["subset"]


def test_chunk_dp_matches_single(dp):
    """The K=3 chunk over the mesh (K eager steps on the CPU) is the
    1-rank chunk."""
    one = dp["one"]
    for out in dp["ranks"]:
        assert_payload_close(out["chunk"], one["chunk"])
        assert_metrics_close(out["chunk_metrics"], one["chunk_metrics"])


def test_dp_step_matches_the_references_mesh_step(dp):
    """The port's 4-rank fp32 step at eps_scale 0 against
    ``molvax.train.make_train_step`` on a 4-device JAX mesh of the
    conftest's fake devices, from the same weights (the reference's init,
    carried by io/convert.py): the metrics and every weight after the
    update within 2e-4."""
    import jax
    import jax.numpy as jnp

    from molvax import train as jtrain
    from molvax.parallel import make_mesh as j_make_mesh, replicate as j_replicate, shard_batch as j_shard
    from molvax_torch.io.convert import state_dict_from_jax

    jcfg, _, codes = dp["jax"]
    mesh = j_make_mesh(devices=jax.devices()[:WORLD])
    jstate = j_replicate(mesh, jtrain.init_state(jcfg))
    jstate, m = jtrain.make_train_step(jcfg)(jstate, j_shard(mesh, codes), None)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    for out in dp["ranks"]:
        got, metrics = out["jax_step"]
        for name, ref in want.items():
            gap = (got["params"][name] - ref).abs().max().item()
            assert gap <= JAX_TOL, (name, gap)
        for name in ("loss", "recon", "kl", "acc", "acc_nonpad", "post_std_batch"):
            assert metrics[name].item() == pytest.approx(float(jnp.asarray(m[name])), rel=JAX_TOL, abs=1e-6), name


@pytest.mark.parametrize("chunked", [False, True])
def test_a_mesh_without_a_world_is_the_one_process_step(chunked):
    """make_mesh() without a world gives the 1-rank mesh: the step and the
    chunk under it are the one-process ones, bit for bit."""
    cfg = tiny_cfg()
    codes = torch.from_numpy(synthetic_dataset(64, max_len=T, seed=2).codes[: K * B].reshape(K, B, T))
    mesh = make_mesh(device="cpu")
    runs = []
    for m in (None, mesh):
        state = init_state(cfg, seed=3, device="cpu")
        if chunked:
            state, metrics = make_train_chunk(cfg, K, device="cpu", mesh=m)(state, codes)
        else:
            state, metrics = make_train_step(cfg, m)(state, codes[0])
        runs.append((payload(state), host(metrics)))
    assert_payload_close(runs[1][0], runs[0][0], exact=True)
    for k in runs[0][1]:
        assert torch.equal(runs[1][1][k], runs[0][1][k]), k
