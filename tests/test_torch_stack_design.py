"""The redesigned GRU stack kernels' plan and plain pieces, on the CPU.

The CUDA kernels (the GEMM of ``csrc/gemm.cuh``, the persistent recurrence
and reverse sweep of ``csrc/gru_stack.cu``) run only on a card, where
``chip_smoke.py`` holds each against its plain version. Here: the planner
that lays them out on an H100, the plain pieces composed by hand against
``stack_forward_ref`` / ``stack_backward_ref`` and against the previous
single-function plain versions (kept below as witnesses), the GEMM's plain
epilogues against float64 products, the operand padding, the ctypes job
table against its C declaration, and the wrappers' refusal of CPU tensors.
"""

import ctypes
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from molvax_torch.config import get_preset
from molvax_torch.kernels import gru as kgru
from molvax_torch.kernels import gru_stack as ks
from molvax_torch.nn.decoder import decoder_input_size
from molvax_torch.utils import round_to
from test_torch_support import normal

CSRC = Path(ks.__file__).resolve().parent / "csrc"
BF = torch.bfloat16


def _uniform(shape, seed, k):
    return torch.from_numpy(np.random.default_rng(seed).uniform(-k, k, shape).astype(np.float32))


def _stack_args(T, B, I, H, L, seed=0):
    k = 1.0 / np.sqrt(H)
    return (torch.from_numpy(normal((T, B, I), seed=seed)), _uniform((3 * H, I), seed + 1, k),
            _uniform((3 * H,), seed + 2, k), _uniform((L - 1, 3 * H, H), seed + 3, k),
            _uniform((L - 1, 3 * H), seed + 4, k), _uniform((L, 3 * H, H), seed + 5, k),
            _uniform((L, 3 * H), seed + 6, k), 0.1 * torch.from_numpy(normal((L, B, H), seed=seed + 7)))


# -- the previous plain versions, one function each (witnesses) ----------------


def _witness_forward(x0, wih0, bih0, wih, bih, whh, bhh, h0):
    """The stack's plain forward as one function, before the split."""
    T, B, _ = x0.shape
    L, _, H = h0.shape
    hseq = torch.empty(L, T, B, H, dtype=BF)
    rzn = torch.empty(L, T, B, 3 * H, dtype=BF)
    ghn = torch.empty(L, T, B, H, dtype=BF)
    for l in range(L):
        if l == 0:
            gi_seq = round_to(x0, BF) @ round_to(wih0, BF).T + bih0
        else:
            gi_seq = hseq[l - 1].float() @ round_to(wih[l - 1], BF).T + bih[l - 1]
        w_hh, b_hh = round_to(whh[l], BF).T, bhh[l]
        h = h0[l].float()
        for t in range(T):
            gi = gi_seq[t]
            gh = round_to(h, BF) @ w_hh + b_hh
            r = torch.sigmoid(gi[:, :H] + gh[:, :H])
            z = torch.sigmoid(gi[:, H : 2 * H] + gh[:, H : 2 * H])
            gn = gh[:, 2 * H :]
            n = torch.tanh(gi[:, 2 * H :] + r * gn)
            h = (1.0 - z) * n + z * h
            hseq[l, t] = h
            rzn[l, t] = torch.cat([r, z, n], dim=-1)
            ghn[l, t] = gn
    return hseq, rzn, ghn


def _witness_backward(res, dY, dhf):
    """The stack's plain backward as one function, before the split."""
    hseq, rzn, ghn, x0, h0, wih0, wih, whh = res
    L, T, B, H = hseq.shape
    dgi = torch.empty(L, T, B, 3 * H, dtype=BF)
    dgh = torch.empty_like(dgi)
    dh0 = torch.empty(L, B, H)
    ext = dY.float()
    for l in reversed(range(L)):
        w_hh = round_to(whh[l], BF)
        dh = dhf[l].float()
        for t in reversed(range(T)):
            r, z, n = rzn[l, t].float().split(H, dim=-1)
            gn = ghn[l, t].float()
            hp = (hseq[l, t - 1] if t > 0 else h0[l].to(BF)).float()
            dout = dh + ext[t]
            dz = dout * (hp - n) * z * (1.0 - z)
            dn = dout * (1.0 - z) * (1.0 - n * n)
            dghn = dn * r
            dr = dn * gn * r * (1.0 - r)
            dgi[l, t] = torch.cat([dr, dz, dn], dim=-1)
            dgh[l, t] = torch.cat([dr, dz, dghn], dim=-1)
            dh = dout * z + dgh[l, t].float() @ w_hh
        dh0[l] = dh
        w_in = wih0 if l == 0 else wih[l - 1]
        ext = dgi[l].float() @ round_to(w_in, BF)
    hprev = [torch.cat([h0[l].to(BF)[None], hseq[l, :-1]], dim=0) for l in range(L)]
    return (
        round_to(ext, BF),
        ks._contract(dgi[0], x0.to(BF)), dgi[0].float().sum((0, 1)),
        torch.stack([ks._contract(dgi[l], hseq[l - 1]) for l in range(1, L)]),
        torch.stack([dgi[l].float().sum((0, 1)) for l in range(1, L)]),
        torch.stack([ks._contract(dgh[l], hprev[l]) for l in range(L)]),
        dgh.float().sum((1, 2)),
        dh0,
    )


# -- the planner ---------------------------------------------------------------


def _blocks(plan, B, H):
    """(rows, units) ranges of every block of every launch of a layer."""
    out = []
    for s in range(plan.slices):
        base = s * plan.g * plan.rows
        for grp in range(plan.g):
            r0 = base + grp * plan.rows
            for j in range(plan.q):
                u0 = j * plan.units
                out.append((range(r0, min(r0 + plan.rows, B, base + plan.g * plan.rows)),
                            range(u0, min(u0 + plan.units, H))))
    return out


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("B", [1, 6, 256])
@pytest.mark.parametrize("preset", ["zinc250k", "chemvae_5k", "moses_scaled"])
def test_stack_plan_fits_the_card_and_covers_every_unit_and_row_once(preset, B, esize):
    """The plan for bf16 (2-byte) and strict-fp32 (4-byte) operands."""
    H = get_preset(preset).model.gru_hidden
    plan = ks.stack_plan(B, H, esize=esize)
    assert plan.fwd_smem <= 232448 and plan.bwd_smem <= 232448
    assert plan.g * plan.q <= 132 and plan.blocks == plan.g * plan.q
    assert plan.units % 8 == 0 and plan.units <= 64
    assert plan.rows % 16 == 0 and 16 <= plan.rows <= 64
    assert plan.fwd_chunk % 16 == 0 and plan.bwd_chunk % 16 == 0
    # shared memory as the kernels lay it out (csrc/gru_stack.cu rec_smem,
    # sweep_smem): the resident W_hh slice, then a ring of 1 or 2 chunks,
    # every row padded by 16 bytes
    for K, chunk, resident, got in ((-(-H // 16) * 16, plan.fwd_chunk, 3 * plan.units, plan.fwd_smem),
                                    (-(-3 * H // 16) * 16, plan.bwd_chunk, plan.units, plan.bwd_smem)):
        assert chunk <= K
        stages = 1 if chunk >= K else 2
        assert got == resident * (K * esize + 16) + stages * plan.rows * (chunk * esize + 16)
    # every (row, unit) exactly once, no empty block
    seen = np.zeros((B, H), dtype=np.int32)
    for rows, units in _blocks(plan, B, H):
        assert len(units) > 0
        seen[rows.start:rows.stop, units.start:units.stop] += 1
    assert (seen == 1).all()
    if preset == "moses_scaled":
        assert plan.q >= 32  # a 3H x H/q W_hh slice of H=1024 fits in 227 KB from q = 32 on
    if preset == "moses_scaled" and B == 256 and esize == 4:  # 2 launches of 2 groups x 64 blocks of 16 units
        assert (plan.g, plan.q, plan.units, plan.rows, plan.slices) == (2, 64, 16, 64, 2)
    if preset == "zinc250k" and B == 256:  # the main path: 128 blocks, one per SM
        want = (16, 8, 64, 16, 1) if esize == 2 else (8, 16, 32, 32, 1)  # 16 rows each; fp32 32
        assert (plan.g, plan.q, plan.units, plan.rows, plan.slices) == want
    if preset == "zinc250k" and B == 6 and esize == 4:  # one group of 32 blocks of 16 units
        assert (plan.g, plan.q, plan.units, plan.rows, plan.slices) == (1, 32, 16, 16, 1)


# every bf16 plan of the test above (and of 2,048 rows), as the planner
# laid them out before it took the element size: (g, q, units, rows,
# slices, fwd_chunk, bwd_chunk, fwd_smem, bwd_smem)
_BF16_PLANS = {
    (1, 501): (1, 9, 56, 16, 1, 512, 1504, 191360, 217728),
    (6, 501): (1, 9, 56, 16, 1, 512, 1504, 191360, 217728),
    (256, 501): (16, 8, 64, 16, 1, 512, 592, 216320, 231936),
    (1, 1024): (1, 64, 16, 16, 1, 1024, 3072, 132096, 197120),
    (6, 1024): (1, 64, 16, 16, 1, 1024, 3072, 132096, 197120),
    (256, 1024): (4, 32, 32, 64, 1, 112, 128, 228864, 231936),
    (2048, 501): (16, 8, 64, 64, 2, 112, 144, 230400, 232448),
}


@pytest.mark.parametrize("B,H", sorted(_BF16_PLANS))
def test_bf16_plans_are_the_plans_before_the_element_size(B, H):
    for plan in (ks.stack_plan(B, H), ks.stack_plan(B, H, esize=2)):
        assert dataclasses.astuple(plan) == _BF16_PLANS[B, H]


def test_stack_plan_rejects_what_no_layout_takes():
    with pytest.raises(ValueError):
        ks.stack_plan(0, 501)
    with pytest.raises(ValueError):
        ks.stack_plan(256, 501, esize=3)
    with pytest.raises(ValueError):
        ks.stack_plan(256, 20000)  # 8 units x 3H of W_hh alone exceed a block's shared memory
    with pytest.raises(ValueError, match="4-byte"):
        ks.stack_plan(256, 1153, esize=4)  # fp32: 16 units need 3 x 16 x 1,168 x 4 bytes; 8 units, q > 132
    big = ks.stack_plan(2048, 501)  # more rows than the SMs' groups hold: several launches
    assert big.slices > 1 and big.g * big.rows * big.slices >= 2048


# -- the card the plans are laid out for -------------------------------------------

# (SMs, shared memory a block may opt in to): an H100 SXM, an H100 PCIe, a MIG-like slice
CARDS = [(132, 232448), (114, 232448), (42, 232448)]


def _layer_shapes():
    """(T, B, I, H, esize) of every GRU layer the training steps run, at B=256
    and 6: zinc250k and zinc250k_quality (bf16), strict fp32 at zinc250k's
    width, and moses_scaled's width."""
    out = set()
    for preset, esize in (("zinc250k", 2), ("zinc250k_quality", 2), ("zinc250k", 4), ("moses_scaled", 2)):
        m = get_preset(preset).model
        for B in (6, 256):
            for I in (decoder_input_size(m), m.gru_hidden):
                out.add((m.max_len, B, I, m.gru_hidden, esize))
    return sorted(out)


@pytest.mark.parametrize("card", CARDS)
def test_plans_fit_the_card_they_run_on(card, monkeypatch):
    """With the CUDA runtime's limits stood in for (``card_limits``), every
    layout the training kernels take on a CUDA device fits that card:
    ``stack_plan``'s group x block count is at most its SMs (the
    cooperative launch is taken) and its blocks' shared memory within its
    limit, or ``layer_route`` sends the layer to the in-kernel instance,
    whose ``layer_plan`` fits the card too; ``dw_parts`` takes
    the fewest waves of the card's SMs. On 132 SMs every plan is the one
    planned without a card, from an H100 SXM's constants, as before."""
    sms, smem = card
    monkeypatch.setattr(ks, "card_limits", lambda device: card)
    cuda = torch.device("cuda", 0)
    assert ks.plan_limits(cuda) == card and ks.plan_limits("cpu") == (ks.SMS, ks.SMEM) == (132, 232448)
    for T, B, I, H, esize in _layer_shapes():
        md = BF if esize == 2 else torch.float32
        route = kgru.layer_route(B, H, md, ks.plan_limits(cuda))
        if route == "persistent":
            plan = ks.stack_plan(B, H, *ks.plan_limits(cuda), esize=esize)
            assert plan.blocks == plan.g * plan.q <= sms, (B, H, esize, plan)
            assert max(plan.fwd_smem, plan.bwd_smem) <= smem
            assert plan.slices * plan.g * plan.rows >= B
        else:
            lplan = kgru.layer_plan(B, I, H, *ks.plan_limits(cuda), esize=esize)
            assert lplan.blocks <= sms and max(lplan.fwd_smem, lplan.bwd_smem) <= smem
        tiles = -(-3 * H // 128) * (-(-(I + 1) // 128) + -(-(H + 1) // 128))
        k = kgru.dw_parts(T, I, H, sms)
        assert 1 <= k <= 4 and all(-(-tiles * k // sms) / k <= -(-tiles * j // sms) / j for j in range(1, 5))
        if card == (132, 232448):
            assert route == "persistent" and plan == ks.stack_plan(B, H, esize=esize)
            assert k == kgru.dw_parts(T, I, H)
    # zinc250k's width at B=256, bf16 and fp32 (g, q, units, rows, slices): on
    # 132 SMs 128 blocks in one launch each; on fewer SMs fewer groups of
    # more rows, and strict fp32 on 42 SMs two launches
    want = {132: ((16, 8, 64, 16, 1), (8, 16, 32, 32, 1)), 114: ((8, 13, 40, 32, 1), (4, 21, 24, 64, 1)),
            42: ((4, 9, 56, 64, 1), (2, 21, 24, 64, 2))}[sms]
    for esize, w in zip((2, 4), want):
        plan = ks.stack_plan(256, 501, *ks.plan_limits(cuda), esize=esize)
        assert (plan.g, plan.q, plan.units, plan.rows, plan.slices) == w


def test_the_wrappers_plan_from_their_device(monkeypatch):
    """The stack's wrappers and the per-layer route lay their launches out
    by ``plan_limits`` of their tensors' device: a card of 42 SMs stood in,
    each launch replaced by a stand-in that records its plan."""
    card = (42, 232448)
    T, B, I, H, L = 2, 256, 40, 501, 2
    monkeypatch.setattr(ks, "plan_limits", lambda device: card)
    for mod in (ks, kgru):
        monkeypatch.setattr(mod, "_check_cuda", lambda what, *tensors: None)
        monkeypatch.setattr(mod, "_gemm", lambda *args, **kw: None)
    plans, sms_seen, limits_seen = [], [], []
    monkeypatch.setattr(ks, "_recurrence", lambda *a, **kw: plans.append(a[8]))
    monkeypatch.setattr(ks, "_sweep", lambda *a, **kw: plans.append(a[10]))
    monkeypatch.setattr(kgru, "_sum_parts", lambda parts, out: None)
    dw_parts, layer_route = kgru.dw_parts, kgru.layer_route
    monkeypatch.setattr(kgru, "dw_parts", lambda T_, I_, H_, sms=132: sms_seen.append(sms) or dw_parts(T_, I_, H_, sms))
    monkeypatch.setattr(kgru, "layer_route", lambda B_, H_, md, limits=(132, 232448): limits_seen.append(limits)
                        or layer_route(B_, H_, md, limits))
    args = _stack_args(T, B, I, H, L)
    x0, wih0, bih0, wih, bih, whh, bhh, h0 = args
    res = ks.stack_forward(*args)
    ks.stack_backward((*res, x0, h0, wih0, wih, whh), torch.zeros(T, B, H), torch.zeros(L, B, H))
    hseq, rzn, ghn = ks.layer_recurrence(torch.zeros(T, B, 3 * H), whh[0], bhh[0], h0[0])
    ks.layer_sweep(hseq, h0[0], rzn, ghn, whh[0], torch.zeros(T, B, H), h0[0])
    lres = kgru.layer_forward(x0, wih0, bih0, whh[0], bhh[0], h0[0], BF)
    kgru.layer_backward((*lres, ks._padded(x0), h0[0], wih0, whh[0]), torch.zeros(T, B, H))
    want = ks.stack_plan(B, H, *card)
    assert want != ks.stack_plan(B, H) and want.blocks <= 42
    assert len(plans) == 2 * L + 2 + 2 and all(p == want for p in plans)
    assert sms_seen == [42] and limits_seen == [card, card]


# -- the plain pieces ------------------------------------------------------------


@pytest.mark.parametrize("T,B,I,H,L", [(5, 3, 10, 24, 2), (4, 6, 9, 130, 3)])
def test_plain_pieces_compose_to_the_stack_forward_bit_for_bit(T, B, I, H, L):
    args = _stack_args(T, B, I, H, L, seed=H)
    x0, wih0, bih0, wih, bih, whh, bhh, h0 = args
    layers, x = [], None
    for l in range(L):
        gi = ks.gemm_ref("gi", x0, wih0, bih0) if l == 0 else ks.gemm_ref("gi", x, wih[l - 1], bih[l - 1])
        layers.append(ks.layer_recurrence_ref(gi, whh[l], bhh[l], h0[l]))
        x = layers[-1][0]
    by_hand = [torch.stack(r) for r in zip(*layers)]
    for got, ref, old in zip(by_hand, ks.stack_forward_ref(*args), _witness_forward(*args)):
        assert got.dtype == BF and torch.equal(got, ref) and torch.equal(ref, old)


@pytest.mark.parametrize("T,B,I,H,L", [(5, 3, 10, 24, 2), (4, 6, 9, 130, 3)])
def test_plain_pieces_compose_to_the_stack_backward_bit_for_bit(T, B, I, H, L):
    args = _stack_args(T, B, I, H, L, seed=H + 1)
    x0, wih0, bih0, wih, bih, whh, bhh, h0 = args
    res = (*ks.stack_forward_ref(*args), x0, h0, wih0, wih, whh)
    hseq, rzn, ghn = res[:3]
    dY = torch.from_numpy(normal((T, B, H), seed=3))
    dhf = torch.from_numpy(normal((L, B, H), seed=4))
    dgi, dgh, dh0, ext = {}, {}, {}, dY
    for l in reversed(range(L)):
        dgi[l], dgh[l], dh0[l] = ks.layer_sweep_ref(hseq[l], h0[l], rzn[l], ghn[l], whh[l], ext, dhf[l])
        assert dgi[l].dtype == BF and dgh[l].dtype == BF and dh0[l].dtype == torch.float32
        ext = ks.gemm_ref("dx", dgi[l], wih0 if l == 0 else wih[l - 1])
    ih = [ks.gemm_ref("dw", dgi[l], hseq[l - 1]) for l in range(1, L)]
    hh = [ks.gemm_ref("dw", dgh[l], hseq[l, :-1], first=h0[l]) for l in range(L)]
    by_hand = (round_to(ext, BF), *ks.gemm_ref("dw", dgi[0], x0), torch.stack([a for a, _ in ih]),
               torch.stack([b for _, b in ih]), torch.stack([a for a, _ in hh]), torch.stack([b for _, b in hh]),
               torch.stack([dh0[l] for l in range(L)]))
    ref = ks.stack_backward_ref(res, dY, dhf)
    old = _witness_backward(res, dY, dhf)
    for name, a, b, c in zip(["dx0", "dwih0", "dbih0", "dwih", "dbih", "dwhh", "dbhh", "dh0"], by_hand, ref, old):
        assert torch.equal(a, b) and torch.equal(b, c), name


# fp32 sums of bf16 products against float64 sums: relative error of a
# K-term fp32 sum, K <= 64 here (measured <= 1e-7)
GEMM_F64_REL = 1e-5


@pytest.mark.parametrize("md", [BF, torch.float32])
@pytest.mark.parametrize("kind", ["gi", "dx", "dw"])
def test_gemm_ref_epilogues_against_float64_and_contract(kind, md):
    """bf16 operands (the default), and strict fp32 ones, rounded to nothing."""
    T, B, K, N = 3, 4, 40, 24
    a = torch.from_numpy(normal((T, B, K), seed=20))
    ab = a.to(md).double()
    if kind == "gi":
        w, bias = torch.from_numpy(normal((N, K), seed=21)), torch.from_numpy(normal((N,), seed=22))
        got = ks.gemm_ref(kind, a, w, bias, md=md)
        want = ab @ w.to(md).double().T + bias.double()
        assert got.dtype == torch.float32 and got.shape == (T, B, N)
        if md == BF:
            assert torch.equal(got, ks.gemm_ref(kind, a, w, bias))
    elif kind == "dx":
        w = torch.from_numpy(normal((K, N), seed=23))
        got = ks.gemm_ref(kind, a, w, md=md)
        want = ab @ w.to(md).double()
    else:
        x = torch.from_numpy(normal((T - 1, B, N), seed=24))
        first = torch.from_numpy(normal((B, N), seed=25))
        got, db = ks.gemm_ref(kind, a, x, first=first, md=md)
        xs = torch.cat([first[None], x]).to(md)
        assert torch.equal(got, ks._contract(a.to(md), xs))  # the h one step behind, h0 first
        want = ab.reshape(-1, K).T @ xs.double().reshape(-1, N)
        np.testing.assert_allclose(db.numpy(), ab.sum((0, 1)).numpy(), rtol=GEMM_F64_REL, atol=1e-6)
    rel = (got.double() - want).norm() / want.norm()
    assert rel <= GEMM_F64_REL, rel
    with pytest.raises(ValueError, match="epilogue"):
        ks.gemm_ref("dy", a, a)


# -- the wrappers' plumbing ----------------------------------------------------


def test_padded_keeps_aligned_rows_and_pads_the_rest():
    x = torch.randn(4, 5, 16).to(BF)
    assert ks._padded(x) is x  # rows of 16 elements: already so
    y = torch.randn(4, 5, 21)
    p = ks._padded(y)
    assert p.dtype == BF and p.shape == y.shape and p.stride(-2) == 24 and p.stride(-1) == 1
    assert torch.equal(p.float(), y.to(BF).float())
    assert ks._padded(p) is p  # a padded view is taken as it is
    t = ks._padded(torch.randn(6, 21).t())  # a transposed operand is copied
    assert t.shape == (21, 6) and t.stride() == (8, 1)
    # fp32 rows pad to a multiple of 4 elements: 16 bytes
    f = torch.randn(4, 5, 12)
    assert ks._padded(f, torch.float32) is f and not ks._is_padded(f)
    q = ks._padded(y, torch.float32)
    assert q.dtype == torch.float32 and q.stride(-2) == 24 and torch.equal(q, y)
    r = ks._padded(torch.randn(3, 501), torch.float32)
    assert r.stride() == (504, 1) and ks._is_padded(r, torch.float32) and not ks._is_padded(r)


def test_gemm_job_table_is_the_c_struct():
    """The ctypes job table has the fields of csrc/gemm.cuh's GemmJob, in
    order, five pointers then eight ints: 72 bytes, no padding."""
    src = (CSRC / "gemm.cuh").read_text()
    body = re.sub(r"//.*", "", re.search(r"struct GemmJob \{(.*?)\};", src, re.S).group(1))
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            names += [n.strip().lstrip("*") for n in re.sub(r"^.*?\b(?:void|float|int)\b\s*\*?", "", decl).split(",")]
    assert names == [f for f, _ in ks._Job._fields_]
    assert ctypes.sizeof(ks._Job) == 5 * 8 + 8 * 4


def _launch_counts():
    return (ks.gemm_gi_launches, ks.rec_launches, ks.sweep_launches, ks.gemm_dx_launches, ks.dw_launches)


@pytest.mark.parametrize("wrapper", ["gemm", "layer_recurrence", "layer_sweep", "stack_forward", "stack_backward"])
def test_new_wrappers_raise_on_cpu_tensors_and_never_fall_back(wrapper):
    T, B, I, H, L = 3, 2, 5, 8, 2
    args = _stack_args(T, B, I, H, L)
    x0, wih0, bih0, wih, bih, whh, bhh, h0 = args
    before = _launch_counts()
    calls = {
        "gemm": lambda: ks.gemm("gi", x0, wih0, bih0),
        "layer_recurrence": lambda: ks.layer_recurrence(torch.zeros(T, B, 3 * H), whh[0], bhh[0], h0[0]),
        "layer_sweep": lambda: ks.layer_sweep(torch.zeros(T, B, H, dtype=BF), h0[0], torch.zeros(T, B, 3 * H),
                                              torch.zeros(T, B, H), whh[0], torch.zeros(T, B, H), h0[0]),
        "stack_forward": lambda: ks.stack_forward(*args),
        "stack_backward": lambda: ks.stack_backward((*ks.stack_forward_ref(*args), x0, h0, wih0, wih, whh),
                                                    torch.zeros(T, B, H), torch.zeros(L, B, H)),
    }
    with pytest.raises(ValueError, match="unsupported device cpu"):
        calls[wrapper]()
    assert _launch_counts() == before


def test_loss_metrics_lie_on_the_loss_device():
    """Every metric of vae_loss, beta included, is on the model's device
    (make_train_step's promise), here the meta device."""
    from molvax_torch import config as tconfig
    from molvax_torch.train import loss as tloss

    cfg = tconfig.ModelConfig(max_len=12)
    B, T = 3, 12
    meta = torch.device("meta")
    logits = torch.empty(B, T, cfg.charset_size, device=meta)
    mu = torch.empty(B, cfg.latent_dim, device=meta)
    _, metrics = tloss.vae_loss(cfg, logits, torch.empty(B, T, dtype=torch.long, device=meta), mu, mu, 0.5)
    assert {k: v.device for k, v in metrics.items()} == {k: meta for k in metrics}


def test_stack_probe_variants_apply_to_the_kernel_source():
    """Each decomposition variant of probes/stack_probe.py finds the parts
    it takes out in csrc/gru_stack.cu, and takes out only those; each
    strict-fp32 product form of csrc/gemm.cuh applies, the one built by
    default leaving the source as it is."""
    from molvax_torch.probes import stack_probe

    text = (CSRC / "gru_stack.cu").read_text()
    assert stack_probe.variant_source(text, "base") == text
    for name in stack_probe.VARIANTS:
        out = stack_probe.variant_source(text, name)
        assert ("group_barrier(a.flags" in out) == ("nobarrier" not in name and "neither" not in name
                                                     and name != "empty"), name
    with pytest.raises(ValueError, match="not in the source"):
        stack_probe.variant_source("int main() {}", "nobarrier")
    gemm = (CSRC / "gemm.cuh").read_text()
    forms = {name: stack_probe.variant_source(gemm, name, stack_probe.FORMS) for name in stack_probe.FORMS}
    assert forms[stack_probe.KEPT] == gemm and len(set(forms.values())) == len(forms)
    assert "mma_tf32" not in forms["ffma"].split("__device__ __forceinline__ void fp32_k8")[1].split("// -- the GEMM")[0]
    assert 'asm("cvt.rna.tf32' in forms["split_tf32_cvt"] and "fp32_k8(acc, acc," in forms["split_tf32_noflush"]
