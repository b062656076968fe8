"""Checkpoints under a data-parallel mesh on the CPU (gloo ranks), the
counterpart of ``tests/distributed/test_checkpoint_mesh.py``: a save under
a 2-rank mesh (the first rank writes, every rank returns its answer)
restored on the same mesh bit for bit, with the continued trajectories bit
for bit; restored by one process (mesh -> 1) and a one-process save
restored on the mesh (1 -> mesh), the values bit for bit and the continued
trajectories within the reference's DP tolerance. The state carries no
mesh, so no restore re-lays anything out."""

import numpy as np
import pytest
import torch

from molvax_torch.data import synthetic_dataset
from molvax_torch.io import checkpoint as ckpt
from molvax_torch.parallel import make_mesh, replicate, shard_batch
from molvax_torch.train import init_state, make_train_step
from test_torch_parallel import T, assert_payload_close, payload, run_ranks, tiny_cfg

WORLD = 2
B = 16


def _batches(n: int, seed: int) -> list:
    codes = synthetic_dataset(n * B, max_len=T, seed=seed).codes
    return [codes[i * B:(i + 1) * B] for i in range(n)]


def _advance(cfg, state, batches, mesh=None):
    step = make_train_step(cfg, mesh)
    for codes in batches:
        state, _ = step(state, shard_batch(mesh, codes) if mesh is not None else torch.from_numpy(codes))
    return state


def _ckpt_worker(rank: int, world: int, cfg, root: str, one_dir: str) -> dict:
    mesh = make_mesh(device="cpu")
    out = {}
    state = _advance(cfg, replicate(mesh, init_state(cfg, device="cpu")), _batches(2, 0), mesh)
    manager = ckpt.make_manager(root, mesh=mesh)
    out["saved_answer"] = manager.save(2, state)
    out["saved"] = payload(state)
    restored = manager.restore_latest(replicate(mesh, init_state(cfg, seed=99, device="cpu")))
    out["restored"] = payload(restored)
    nxt = _batches(2, 9)
    out["continued"] = payload(_advance(cfg, state, nxt, mesh))
    out["continued_restored"] = payload(_advance(cfg, restored, nxt, mesh))
    # 1 -> mesh: the one-process run's checkpoint
    up = ckpt.make_manager(one_dir, mesh=mesh).restore_latest(replicate(mesh, init_state(cfg, seed=98, device="cpu")))
    out["up"] = payload(up)
    out["up_continued"] = payload(_advance(cfg, up, _batches(2, 7), mesh))
    return out


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    cfg = tiny_cfg()
    root = tmp_path_factory.mktemp("ckpt_mesh")
    one = _advance(cfg, init_state(cfg, device="cpu"), _batches(2, 2))
    ckpt.make_manager(str(root / "one")).save(2, one)
    ranks = run_ranks(root, WORLD, _ckpt_worker, cfg, str(root / "mesh"), str(root / "one"))
    return cfg, root, one, ranks


def test_save_on_the_mesh_restore_on_the_mesh_bit_for_bit(mesh_run):
    _, _, _, ranks = mesh_run
    for out in ranks:
        assert out["saved_answer"] is True
        assert_payload_close(out["restored"], out["saved"], exact=True)
        assert_payload_close(out["continued_restored"], out["continued"], exact=True)
    assert_payload_close(ranks[1]["saved"], ranks[0]["saved"], exact=True)


def test_save_on_the_mesh_restore_in_one_process(mesh_run):
    """mesh -> 1: the values bit for bit; the continued trajectory within
    the reference's DP tolerance of the mesh's."""
    cfg, root, _, ranks = mesh_run
    assert ckpt.make_manager(str(root / "mesh")).all_steps() == [2]
    restored = ckpt.make_manager(str(root / "mesh")).restore_latest(init_state(cfg, seed=97, device="cpu"))
    assert_payload_close(payload(restored), ranks[0]["saved"], exact=True)
    cont = _advance(cfg, restored, _batches(2, 9))
    assert_payload_close(payload(cont), ranks[0]["continued"])


def test_save_in_one_process_restore_on_the_mesh(mesh_run):
    """1 -> mesh: the values bit for bit on every rank; the continued
    trajectory within the reference's DP tolerance of one process's."""
    cfg, _, one, ranks = mesh_run
    saved = payload(one)
    for out in ranks:
        assert_payload_close(out["up"], saved, exact=True)
    cont = _advance(cfg, one, _batches(2, 7))
    for out in ranks:
        assert_payload_close(out["up_continued"], payload(cont))


def test_a_manager_without_a_world_saves_as_before(tmp_path):
    """A 1-rank mesh without a world makes no collective call: the save is
    the one-process save."""
    cfg = tiny_cfg()
    state = init_state(cfg, device="cpu")
    manager = ckpt.make_manager(str(tmp_path), mesh=make_mesh(device="cpu"))
    assert manager.save(0, state) is True and manager.save(0, state) is False
    assert_payload_close(payload(manager.restore_latest(init_state(cfg, seed=5, device="cpu"))), payload(state),
                         exact=True)
    np.testing.assert_equal(manager.all_steps(), [0])
