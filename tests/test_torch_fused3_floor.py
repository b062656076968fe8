"""The fused3 wavefront's planner and order, and the floor probe's chain
split, on the CPU (no JAX).

``csrc/gru_layer.cu``'s fused3 wavefront and ``csrc/floor.cu`` run only on a
card (``chip_smoke.py`` phases 19 and 20 hold them against their plain
versions there). Here: ``fused3_plan`` fits the card it plans for, with one
row split shared by every team; a play of the wavefront's order on the CPU
(layer l's step t on tick t + s l, each step the plain per-step update)
reads only what a tick before it published and gives ``gru_fused3_scan_ref``
bit for bit; the wrapper launches once a batch slice of the plan and raises
where no plan fits; ``floor_loop_ref`` is the wrapping sum of its chains run
one at a time, the identity the kernel's thread per chain rests on.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from molvax_torch.kernels import floor as kfloor
from molvax_torch.kernels import gru as kgru
from molvax_torch.kernels import gru_stack as ks
from molvax_torch.utils import round_to

CARDS = [(132, 232448), (114, 232448)]  # an H100 SXM's SMs and shared memory a block, an H100 PCIe's


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("B", [256, 6])
@pytest.mark.parametrize("H", [501, 512])
def test_fused3_plan_fits_the_card_it_plans_for(card, B, H):
    """At most one block an SM over all L teams; each team's shared memory
    (the forward's layout, ``fwd_smem``: layer 0 hoisted, the others
    in-kernel with I = H) within a block's; the units cover H; one row
    split, whose slices cover B; the warp tiles the kernel's instances."""
    sms, smem = card
    L = 3
    plan = kgru.fused3_plan(B, H, L, sms, smem)
    assert plan.layers == L and plan.blocks == L * plan.g * plan.q <= sms
    assert plan.q * plan.units >= H and plan.units % 8 == 0 and plan.units <= 64
    assert plan.g * plan.rows * plan.slices >= B and plan.g * plan.rows * (plan.slices - 1) < B
    assert plan.rows == 16 * plan.mt * plan.rt and plan.mt in (1, 2, 4) and plan.threads <= 256
    first = kgru.fwd_smem(0, H, plan.units, plan.rows, plan.chunk[0], plan.stages[0], False, False,
                          plan.res_hh[0], 2)
    upper = kgru.fwd_smem(H, H, plan.units, plan.rows, plan.chunk[1], plan.stages[1], True, plan.res_ih,
                          plan.res_hh[1], 2)
    assert plan.smem == (first, upper) and max(plan.smem) <= smem
    assert all(c % 16 == 0 for c in plan.chunk)


def test_fused3_plan_at_zinc250k_width():
    """B=256, H=501 on an H100 SXM: 3 teams of 2 groups x 21 blocks of 24
    units and 128 rows (126 blocks), every slice resident; the hoisted team
    takes its product whole (208,000 bytes), the in-kernel teams in chunks
    of 144 through two buffers (227,584 bytes)."""
    plan = kgru.fused3_plan(256, 501, 3)
    assert plan == kgru.Fused3Plan(3, 2, 21, 24, 128, 2, 1, (512, 144), (1, 2), (True, True), True,
                                   (208000, 227584))
    assert plan.blocks == 126


def test_fused3_plan_shares_one_row_split_where_team_plans_differ():
    """At H=512, B=256, planned apart on a team's 44 SMs, the hoisted step
    and the in-kernel step split the rows differently (4 x 64 against
    2 x 128), and a wait of one group on one group would not hold; the
    fused3 plan gives every team one split."""
    hoisted = kgru.layer_plan(256, 0, 512, sms=44, hoisted=True)
    in_kernel = kgru.layer_plan(256, 512, 512, sms=44)
    assert (hoisted.g, hoisted.rows) == (4, 64) and (in_kernel.g, in_kernel.rows) == (2, 128)
    plan = kgru.fused3_plan(256, 512, 3)
    assert (plan.g, plan.rows, plan.q, plan.slices) == (2, 128, 22, 1) and plan.blocks <= ks.SMS


def test_fused3_plan_raises_where_no_layout_fits():
    """More units than a team's SMs hold (8 SMs, 3 teams, H = 520), a
    shared memory too small for any slice, or bad arguments, raise."""
    with pytest.raises(ValueError, match="no layout"):
        kgru.fused3_plan(16, 520, 3, 8)
    with pytest.raises(ValueError, match="no layout"):
        kgru.fused3_plan(256, 501, 3, 132, 16 * 1024)
    for bad in (dict(B=0), dict(H=0), dict(L=1), dict(L=ks._MAX_LAYERS + 1)):
        with pytest.raises(ValueError, match="fused3_plan"):
            kgru.fused3_plan(**{"B": 4, "H": 16, "L": 3, **bad})


def _stack(L, T, B, H, seed):
    rng = np.random.default_rng(seed)
    s = 1 / np.sqrt(H)

    def u(*shape):
        return torch.from_numpy(rng.uniform(-s, s, shape).astype(np.float32))

    gi0 = torch.from_numpy(rng.standard_normal((T, B, 3 * H)).astype(np.float32) * 0.5)
    h0 = torch.from_numpy(rng.standard_normal((L, B, H)).astype(np.float32) * 0.5)
    return gi0, u(L - 1, 3 * H, H), u(L - 1, 3 * H), u(L, 3 * H, H), u(L, 3 * H), h0


def _wavefront_play(gi0, wih, bih, whh, bhh, h0, skew):
    """The fused3 kernel's order on the CPU: on tick k every layer l with
    t = k - skew l in [0, T) runs its step t, reading x[t] (the bf16 hseq
    of layer l-1) and its own step t-1; what a tick writes is published at
    its end. Raises on a read of a step not yet published."""
    L, B, H = h0.shape
    T = gi0.shape[0]
    bf = torch.bfloat16
    hseq = torch.zeros(L, T, B, H, dtype=bf)
    published = torch.zeros(L, T, dtype=torch.bool)
    h = [h0[l].float() for l in range(L)]
    w_t = [round_to(whh[l], bf).T for l in range(L)]
    for tick in range(T + skew * (L - 1)):
        wrote = []
        for l in range(L):
            t = tick - skew * l
            if not 0 <= t < T:
                continue
            if (l > 0 and not published[l - 1, t]) or (t > 0 and not published[l, t - 1]):
                raise AssertionError(f"layer {l} step {t} on tick {tick} reads a step not yet published")
            gi = round_to(gi0[t], bf) if l == 0 else ks.gemm_ref("gi", hseq[l - 1, t], wih[l - 1], bih[l - 1])
            h[l] = ks.recurrence_step_ref(gi, w_t[l], bhh[l], h[l])[0]
            hseq[l, t] = h[l]
            wrote.append((l, t))
        for l, t in wrote:
            published[l, t] = True
    assert published.all()
    return hseq


@pytest.mark.parametrize("skew", [1, 2])
def test_wavefront_order_reads_only_published_steps_and_is_the_plain_version(skew):
    """Layer l's step t on tick t + skew l reads only published steps, and
    the h sequences are gru_fused3_scan_ref's bit for bit."""
    args = _stack(3, 7, 5, 16, seed=3)
    got = _wavefront_play(*args, skew)
    assert torch.equal(got, ks.gru_fused3_scan_ref(*args))


def test_wavefront_without_skew_reads_an_unpublished_step():
    """With no skew a layer would read its input step on the tick that
    writes it: the play refuses it."""
    with pytest.raises(AssertionError, match="not yet published"):
        _wavefront_play(*_stack(2, 3, 2, 8, seed=4), 0)


def test_fused3_wrapper_launches_once_a_batch_slice(monkeypatch):
    """Stood in for a card of 24 SMs (8 a team) at B=256, H=501: the plan
    takes 4 slices of 64 rows; the wrapper launches the C entry once a
    slice, counted, with the plan's layout and the slice's rows, and
    returns hseq as (L, T, B, H) bf16 rows padded to 16 bytes."""
    L, T, B, H = 3, 2, 256, 501
    plan = kgru.fused3_plan(B, H, L, 24)
    assert plan.slices > 1
    calls = []

    def fn(*a):
        calls.append(a)
        return 0

    monkeypatch.setattr(ks, "plan_limits", lambda device: (24, ks.SMEM))
    monkeypatch.setattr(kgru, "_check_cuda", lambda what, *tensors: None)
    monkeypatch.setattr(kgru, "_plain_here", lambda t: False)
    monkeypatch.setattr(kgru, "_stream", lambda t: 0)
    monkeypatch.setattr(kgru._build, "function", lambda name, argtypes: fn)
    before = kgru.fused3_launches
    gi0, wih, bih, whh, bhh, h0 = _stack(L, T, B, H, seed=5)
    out = kgru.gru_fused3_scan(gi0, wih, bih, whh, bhh, h0)
    assert kgru.fused3_launches - before == plan.slices == len(calls)
    assert out.shape == (L, T, B, H) and out.dtype == torch.bfloat16 and out.stride(-2) == 504
    span = plan.g * plan.rows
    assert [c[-3:-1] for c in calls] == [(b, min(B, b + span)) for b in range(0, B, span)]
    assert all(c[17:21] == (T, B, H, L) and c[21:26] == (plan.units, plan.rows, plan.rt, plan.q, plan.g)
               for c in calls)


def test_fused3_wrapper_raises_where_no_plan_fits(monkeypatch):
    """On a card no plan fits (8 SMs, H = 520) the wrapper raises before
    any launch: no other route, no plain version."""
    monkeypatch.setattr(ks, "plan_limits", lambda device: (8, ks.SMEM))
    monkeypatch.setattr(kgru, "_check_cuda", lambda what, *tensors: None)
    monkeypatch.setattr(kgru, "_plain_here", lambda t: False)

    def fail(*args, **kwargs):
        raise AssertionError("a kernel was loaded")

    monkeypatch.setattr(kgru._build, "function", fail)
    before = kgru.fused3_launches
    with pytest.raises(ValueError, match="no layout"):
        kgru.gru_fused3_scan(*_stack(3, 2, 3, 520, seed=6))
    assert kgru.fused3_launches == before


def test_fused3_step_variants_apply_to_the_kernel_source():
    """Each variant of probes/stack_probe.py's FUSED3_VARIANTS finds the
    text it replaces in csrc/gru_layer.cu exactly once."""
    from molvax_torch.probes import stack_probe

    text = (Path(kgru.__file__).resolve().parent / "csrc" / "gru_layer.cu").read_text()
    assert stack_probe.FUSED3_VARIANTS["base"] == []
    for name, subs in stack_probe.FUSED3_VARIANTS.items():
        for old, _ in subs:
            assert text.count(old) == 1, (name, old)


def test_floor_variants_apply_to_the_kernel_source():
    """Each form of probes/auto_loop_probe.py's FLOOR_VARIANTS finds the
    text it replaces in csrc/floor.cu exactly once."""
    from molvax_torch.probes import auto_loop_probe

    text = (Path(kfloor.__file__).resolve().parent / "csrc" / "floor.cu").read_text()
    assert auto_loop_probe.FLOOR_VARIANTS["select"] == []
    for name, subs in auto_loop_probe.FLOOR_VARIANTS.items():
        for file, old, _ in subs:
            assert file == "floor.cu" and text.count(old) == 1, (name, old)


def _wrap32(v: np.ndarray) -> np.ndarray:
    return ((v.astype(np.int64) + 2**31) % 2**32 - 2**31).astype(np.int32)


@pytest.mark.parametrize("chains", range(1, kfloor.MAX_CHAINS + 1))
def test_floor_loop_is_the_wrapping_sum_of_its_chains(chains):
    """floor_loop_ref(x, T, k_ops, chains) is the int32-wrapping sum over c
    of a single chain from x + c running k_ops // chains + (c < k_ops %
    chains) ops a step: the chain-per-thread split of csrc/floor.cu, at a
    k_ops that chains does not divide (where chains > 1) and x at the
    int32 limits."""
    rng = np.random.default_rng(chains)
    x = rng.integers(-20, 20, size=(3, 7), dtype=np.int32)
    x.flat[0], x.flat[1] = np.iinfo(np.int32).max, np.iinfo(np.int32).min
    T, k_ops = 9, 3 * chains + chains // 2 + 1
    want = kfloor.floor_loop_ref(torch.from_numpy(x), T, k_ops, chains).numpy()
    total = np.zeros(x.shape, dtype=np.int64)
    for c in range(chains):
        start = torch.from_numpy(_wrap32(x.astype(np.int64) + c))
        ops = k_ops // chains + (c < k_ops % chains)
        total += kfloor.floor_loop_ref(start, T, ops, 1).numpy()
    np.testing.assert_array_equal(want, _wrap32(total))
