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
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from molvax_torch.config import get_preset
from molvax_torch.kernels import gru_stack as ks
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


@pytest.mark.parametrize("B", [1, 6, 256])
@pytest.mark.parametrize("preset", ["zinc250k", "chemvae_5k", "moses_scaled"])
def test_stack_plan_fits_the_card_and_covers_every_unit_and_row_once(preset, B):
    H = get_preset(preset).model.gru_hidden
    plan = ks.stack_plan(B, H)
    assert plan.fwd_smem <= 232448 and plan.bwd_smem <= 232448
    assert plan.g * plan.q <= 132 and plan.blocks == plan.g * plan.q
    assert plan.units % 8 == 0 and plan.units <= 64 and plan.threads == plan.units // 8 * 32
    assert plan.rows % 16 == 0 and 16 <= plan.rows <= 64
    assert plan.fwd_chunk % 16 == 0 and plan.bwd_chunk % 16 == 0
    # shared memory as the kernels lay it out (csrc/gru_stack.cu rec_smem,
    # sweep_smem): the resident W_hh slice, then a ring of 1 or 2 chunks
    for K, chunk, resident, got in ((-(-H // 16) * 16, plan.fwd_chunk, 3 * plan.units, plan.fwd_smem),
                                    (-(-3 * H // 16) * 16, plan.bwd_chunk, plan.units, plan.bwd_smem)):
        assert chunk <= K
        stages = 1 if chunk >= K else 2
        assert got == 2 * (resident * (K + 8) + stages * plan.rows * (chunk + 8))
    # every (row, unit) exactly once, no empty block
    seen = np.zeros((B, H), dtype=np.int32)
    for rows, units in _blocks(plan, B, H):
        assert len(units) > 0
        seen[rows.start:rows.stop, units.start:units.stop] += 1
    assert (seen == 1).all()
    if preset == "moses_scaled":
        assert plan.q >= 32  # a 3H x H/q W_hh slice of H=1024 fits in 227 KB from q = 32 on
    if preset == "zinc250k" and B == 256:  # the main path: 128 blocks, one per SM, 16 rows each
        assert (plan.g, plan.q, plan.units, plan.rows, plan.slices) == (16, 8, 64, 16, 1)


def test_stack_plan_rejects_what_no_layout_takes():
    with pytest.raises(ValueError):
        ks.stack_plan(0, 501)
    with pytest.raises(ValueError):
        ks.stack_plan(256, 20000)  # 8 units x 3H of W_hh alone exceed a block's shared memory
    big = ks.stack_plan(2048, 501)  # more rows than the SMs' groups hold: several launches
    assert big.slices > 1 and big.g * big.rows * big.slices >= 2048


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


@pytest.mark.parametrize("kind", ["gi", "dx", "dw"])
def test_gemm_ref_epilogues_against_float64_and_contract(kind):
    T, B, K, N = 3, 4, 40, 24
    a = torch.from_numpy(normal((T, B, K), seed=20))
    ab = a.to(BF).double()
    if kind == "gi":
        w, bias = torch.from_numpy(normal((N, K), seed=21)), torch.from_numpy(normal((N,), seed=22))
        got = ks.gemm_ref(kind, a, w, bias)
        want = ab @ w.to(BF).double().T + bias.double()
        assert got.dtype == torch.float32 and got.shape == (T, B, N)
    elif kind == "dx":
        w = torch.from_numpy(normal((K, N), seed=23))
        got = ks.gemm_ref(kind, a, w)
        want = ab @ w.to(BF).double()
    else:
        x = torch.from_numpy(normal((T - 1, B, N), seed=24))
        first = torch.from_numpy(normal((B, N), seed=25))
        got, db = ks.gemm_ref(kind, a, x, first=first)
        xs = torch.cat([first[None], x]).to(BF)
        assert torch.equal(got, ks._contract(a.to(BF), xs))  # the h one step behind, h0 first
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
    it takes out in csrc/gru_stack.cu, and takes out only those."""
    from molvax_torch.probes import stack_probe

    text = (CSRC / "gru_stack.cu").read_text()
    assert stack_probe.variant_source(text, "base") == text
    for name in stack_probe.VARIANTS:
        out = stack_probe.variant_source(text, name)
        assert ("group_barrier(a.flags" in out) == ("nobarrier" not in name and "neither" not in name
                                                     and name != "empty"), name
    with pytest.raises(ValueError, match="not in the source"):
        stack_probe.variant_source("int main() {}", "nobarrier")
