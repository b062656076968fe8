"""The persistent generation kernel's design, on the CPU (no card, no JAX).

The CUDA kernel runs only on a card (``chip_smoke.py`` holds it against
``fused_generate_ref`` there). Here: its planner ``generate_plan`` at the
presets' widths, the per-block packed weights (round trip to the dense
weights, and the packed K order against the mma.sync fragments the kernel
builds from its 16-byte loads), the one-hot gather of layer 1's input
gates, the kernel's plain pieces composed over T steps against
``fused_generate_ref``, and the wrapper on the CPU with its launches
replaced by those pieces: its routes, slices and counters.
"""

import dataclasses

import numpy as np
import pytest
import torch

from molvax_torch.config import ModelConfig, get_preset
from molvax_torch.kernels import generate as kg
from molvax_torch.kernels.gru_stack import SMEM, SMS
from molvax_torch.nn.decoder import latent_embed
from molvax_torch.nn.vae import MolecularVAE
from molvax_torch.utils import round_to

BF = torch.bfloat16


def _model(seed=0, learned_start=True, **kw):
    """A small bf16 teacher-forced model (H=24, L=2, C=37, T=20), seeded
    weights (torch's init), a non-zero learned start token."""
    args = dict(max_len=20, charset_size=37, latent_dim=16, conv_kernels=(5, 5, 5), enc_hidden=16,
                gru_hidden=24, gru_layers=2, compute_dtype="bfloat16", learned_start=learned_start)
    cfg = ModelConfig(**{**args, **kw})
    torch.manual_seed(seed)
    model = MolecularVAE(cfg, device="cpu")
    if learned_start:
        with torch.no_grad():
            model.start_token.copy_(torch.randn(cfg.charset_size, generator=torch.Generator().manual_seed(seed)))
    return cfg, model


def _z_emb(model, cfg, B, seed=1):
    z = torch.from_numpy(np.random.default_rng(seed).standard_normal((B, cfg.latent_dim)).astype(np.float32))
    with torch.no_grad():
        return latent_embed(model, cfg, z)


def _compose(giz1, start, w_c, layers, w_out, b_out, T, rows, seed=0, greedy=True, temperature=1.0):
    """The persistent kernel's phases in its order, as plain pieces: gh_l of
    step t+1 comes from phase l+2 of step t (the head for the top layer),
    from the operand that phase reads for its own input gates."""
    L, B = len(layers), giz1.shape[0]
    H = layers[0][2].shape[0]
    hs = [torch.zeros(B, H) for _ in layers]
    gh = [round_to(h, BF) @ round_to(w_hh, BF) + b_hh for h, (_, _, w_hh, b_hh) in zip(hs, layers)]
    codes = torch.empty(B, T, dtype=torch.int32)
    code = None
    for t in range(T):
        gi = kg.start_gi1_ref(giz1, w_c, start) if t == 0 else kg.gather_gi1_ref(giz1, w_c, code)
        hs[0] = kg.gate_ref(gi, gh[0], hs[0])
        for l in range(1, L):
            w_ih, b_ih, _, _ = layers[l]
            _, _, w_hh, b_hh = layers[l - 1]
            gi, gh[l - 1] = kg.phase_ref(hs[l - 1], w_ih, b_ih, w_hh, b_hh)
            hs[l] = kg.gate_ref(gi, gh[l], hs[l])
        gh[L - 1], code = kg.head_ref(hs[L - 1], *layers[L - 1][2:], w_out, b_out, t, rows, seed, greedy,
                                      temperature)
        codes[:, t] = code.to(torch.int32)
    return codes


def _unpack(w, plan, C, H, L):
    """``pack_blocks``' inverse: (w_c (C, 3H), [w_hh_l], [w_ih_l for l >= 1],
    w_out (H, C)) fp32 from block 0's W_out and every block's slices; also
    asserts that every block holds the same W_out and that the padding
    (K past H, rows past the classes, units past H) is zero."""
    K, KS, q = plan.K, plan.K + kg._KPAD, plan.q
    inv = torch.argsort(kg.k_order(K))
    blocks = w.float()
    off = 0

    def product_rows():
        nonlocal off
        d = blocks[:, off: off + 3 * 8 * KS].reshape(q, 3, 8, KS)
        off += 3 * 8 * KS
        assert not d[..., K:].any()
        d = d[..., :K][..., inv].permute(3, 1, 0, 2).reshape(K, 3, q * 8)
        assert not d[H:].any() and not d[:, :, H:].any()
        return d[:H, :, :H].reshape(H, 3 * H)

    w_hh = [product_rows() for _ in range(L)]
    w_ih = [product_rows() for _ in range(L - 1)]
    out = blocks[:, off: off + kg._NOUT * KS].reshape(q, kg._NOUT, KS)
    off += kg._NOUT * KS
    assert torch.equal(out, out[:1].expand_as(out)) and not out[:, :, K:].any()
    out = out[0, :, :K][:, inv].T
    assert not out[H:].any() and not out[:, C:].any()
    CS = -(-C // 8) * 8
    wc = blocks[:, off: off + 3 * 8 * CS].reshape(q, 3, 8, CS).permute(3, 1, 0, 2).reshape(CS, 3, q * 8)
    assert off + 3 * 8 * CS == w.shape[1]
    assert not wc[C:].any() and not wc[:, :, H:].any()
    return wc[:C, :, :H].reshape(C, 3 * H), w_hh, w_ih, out[:H, :C]


# -- the planner -------------------------------------------------------------------


@pytest.mark.parametrize("preset,B,sms", [("zinc250k", 1, SMS), ("zinc250k", 6, SMS), ("zinc250k", 16, SMS),
                                          ("zinc250k", 256, SMS), ("zinc250k", 528, SMS), ("chemvae_5k", 64, SMS),
                                          ("zinc250k", 256, 114), ("zinc250k", 528, 114)])
def test_plan_fits_the_card(preset, B, sms):
    """Every plan's block holds its weights in one block's shared memory,
    the groups fit on the card's SMs (an H100 SXM's 132, an H100 PCIe's
    114), so that the cooperative launch is taken, and the slices cover B;
    at zinc250k width and B=256: 2 groups x 63 blocks of 8 units, 128 rows,
    one launch on 132 SMs, 1 group in each of 2 launches on 114."""
    m = get_preset(preset).model
    plan = kg.generate_plan(B, m.charset_size, m.gru_hidden, m.gru_layers, sms=sms)
    assert plan is not None
    assert plan.smem <= SMEM == 232448 and plan.blocks <= sms and SMS == 132
    assert plan.smem == 2 * kg._block_elems(m.charset_size, plan.K, m.gru_layers)
    assert kg._UNITS == 8 and plan.q == -(-m.gru_hidden // 8) and plan.K == 512
    assert plan.rows % 16 == 0 and 16 <= plan.rows <= 128
    assert plan.slices * plan.g * plan.rows >= B > (plan.slices - 1) * plan.g * plan.rows
    if (B, sms) == (256, SMS):
        assert (plan.g, plan.q, plan.rows, plan.slices, plan.blocks) == (2, 63, 128, 1, 126)
        # W_hh / W_ih slices ~125 KB, W_out ~42 KB, W_c ~2 KB
        assert plan.smem == 5 * 24 * 520 * 2 + 40 * 520 * 2 + 24 * 40 * 2 == 168320
    if (B, sms) == (256, 114):
        assert (plan.g, plan.q, plan.rows, plan.slices, plan.blocks) == (1, 63, 128, 2, 63)
    if (B, sms) == (528, SMS):
        assert (plan.g, plan.rows, plan.slices) == (2, 96, 3)


def test_moses_scaled_and_the_kernels_limits_have_no_plan():
    """moses_scaled's 4 x GRU-1024 weights exceed a block's shared memory
    at q = 128; more than 4 layers or 40 classes has no kernel instance; a
    card of too few SMs or too little shared memory has no layout."""
    m = get_preset("moses_scaled").model
    assert kg.generate_plan(256, m.charset_size, m.gru_hidden, m.gru_layers) is None
    assert kg.generate_plan(16, m.charset_size, m.gru_hidden, m.gru_layers) is None
    assert kg.generate_plan(256, 37, 501, 5) is None
    assert kg.generate_plan(256, 41, 501, 3) is None
    assert kg.generate_plan(256, 37, 501, 3, sms=62) is None
    assert kg.generate_plan(256, 37, 501, 3, smem=168319) is None
    assert kg.generate_plan(256, 37, 501, 3, smem=168320) is not None
    with pytest.raises(ValueError):
        kg.generate_plan(0, 37, 501, 3)


# -- the packed weights --------------------------------------------------------------


@pytest.mark.parametrize("C,H,L", [(37, 24, 2), (37, 501, 3), (5, 13, 1), (40, 40, 4)])
def test_packed_blocks_round_trip_to_the_dense_weights(C, H, L):
    """pack_blocks' layout read back block by block gives the bf16 weights
    exactly, with W_out whole in every block and every pad zero."""
    g = torch.Generator().manual_seed(H)
    w_c = torch.randn(C, 3 * H, generator=g)
    layers = [(None if l == 0 else torch.randn(H, 3 * H, generator=g), None if l == 0 else torch.randn(3 * H),
               torch.randn(H, 3 * H, generator=g), torch.randn(3 * H)) for l in range(L)]
    w_out = torch.randn(H, C, generator=g)
    plan = kg.generate_plan(256, C, H, L)
    w = kg.pack_blocks(w_c, layers, w_out, plan)
    assert w.dtype == BF and w.shape == (plan.q, kg._block_elems(C, plan.K, L)) and w.is_contiguous()
    assert 2 * w.shape[1] == plan.smem and (2 * w.shape[1]) % 16 == 0
    wc, w_hh, w_ih, out = _unpack(w, plan, C, H, L)
    assert torch.equal(wc, round_to(w_c, BF)) and torch.equal(out, round_to(w_out, BF))
    for l in range(L):
        assert torch.equal(w_hh[l], round_to(layers[l][2], BF))
    for l in range(1, L):
        assert torch.equal(w_ih[l - 1], round_to(layers[l][0], BF))
    b = kg._biases(layers, torch.randn(C))
    assert b.shape == ((2 * L - 1) * 3 * H + C,) and b.dtype == torch.float32


@pytest.mark.parametrize("K", [32, 512])
def test_packed_k_order_feeds_the_mma_fragments(K):
    """One warp's product as the kernel forms it, emulated lane by lane:
    each lane's 16-byte loads of its rows (gq, gq + 8) give the A fragments
    of two k16 steps (words 0, 1 then 2, 3), one ldmatrix.x4 a block gives
    the B fragments of both from the packed rows (K in k_order), and mma.m16n8k16's
    fragment layout puts them together: the sum over all k16 steps equals
    the dense product (float64, exact for these small integers)."""
    rng = np.random.default_rng(K)
    A = rng.integers(-4, 5, (16, K)).astype(np.float64)  # the warp's 16 rows of h
    W = rng.integers(-4, 5, (K, 8)).astype(np.float64)  # one tile of 8 output columns
    packed = W[kg.k_order(K).numpy()].T  # shared memory: row n = column n of W, K packed
    D = np.zeros((16, 8))
    for c in range(K // 32):
        for s in range(2):
            Af, Bf = np.zeros((16, 16)), np.zeros((16, 8))
            for lane in range(32):
                gq, tq = lane >> 2, lane & 3
                words = [A[r, 32 * c + 8 * tq: 32 * c + 8 * tq + 8].reshape(4, 2) for r in (gq, gq + 8)]
                a = [words[0][2 * s], words[1][2 * s], words[0][2 * s + 1], words[1][2 * s + 1]]  # a0..a3
                Af[gq, 2 * tq: 2 * tq + 2], Af[gq + 8, 2 * tq: 2 * tq + 2] = a[0], a[1]
                Af[gq, 2 * tq + 8: 2 * tq + 10], Af[gq + 8, 2 * tq + 8: 2 * tq + 10] = a[2], a[3]
                # ldmatrix.x4 at element 32 c of the packed rows: matrix m
                # is columns 8 m .. 8 m + 7, and the lane gets row gq,
                # elements 2 tq, 2 tq + 1 of each; step s takes matrices 2 s
                # (b0) and 2 s + 1 (b1)
                k0 = 32 * c + 16 * s
                b0, b1 = packed[gq, k0 + 2 * tq: k0 + 2 * tq + 2], packed[gq, k0 + 8 + 2 * tq: k0 + 10 + 2 * tq]
                Bf[2 * tq: 2 * tq + 2, gq], Bf[2 * tq + 8: 2 * tq + 10, gq] = b0, b1
            D += Af @ Bf
    np.testing.assert_array_equal(D, A @ W)
    assert sorted(kg.k_order(K).tolist()) == list(range(K))


def test_w_c_row_gather_equals_the_one_hot_product_bit_for_bit():
    """t >= 1: prev is one-hot, so bf16(prev) @ W_c has one non-zero term
    per output: row ``code`` of bf16 W_c, summed exactly in fp32."""
    g = torch.Generator().manual_seed(3)
    B, C, H = 64, 37, 501
    giz1, w_c = torch.randn(B, 3 * H, generator=g), torch.randn(C, 3 * H, generator=g)
    code = torch.randint(0, C, (B,), generator=g)
    product = round_to(torch.nn.functional.one_hot(code, C).float(), BF) @ round_to(w_c, BF)
    assert torch.equal(round_to(w_c, BF)[code], product)
    assert torch.equal(kg.gather_gi1_ref(giz1, w_c, code), giz1 + product)


# -- the plain pieces and the wrapper ----------------------------------------------


@pytest.mark.parametrize("greedy,temperature", [(True, 1.0), (False, 1.0), (False, 0.7)])
@pytest.mark.parametrize("learned_start", [False, True])
@pytest.mark.parametrize("layers", [2, 3])
def test_plain_pieces_compose_to_the_plain_decode(greedy, temperature, learned_start, layers):
    """start / gather, phase, gate and head, composed over T steps in the
    persistent kernel's order (gh of each layer from the phase above), give
    fused_generate_ref's codes exactly: the same products on the same
    operands, the one-hot product replaced by its exact gather."""
    cfg, model = _model(seed=layers, learned_start=learned_start, gru_layers=layers)
    B = 12
    z_emb = _z_emb(model, cfg, B)
    with torch.no_grad():
        _, _, w_c, lw, w_out, b_out = kg._layer_weights(model)
        got = _compose(kg.latent_gates_ref(model, z_emb), kg._start(model, cfg.charset_size, "cpu"), w_c, lw, w_out, b_out,
                       cfg.max_len, torch.arange(B), 5, greedy, temperature)
    want = kg.fused_generate_ref(model, cfg, z_emb, 5, greedy, temperature)
    assert torch.equal(got, want)


def _plain_launches(monkeypatch, C, H, L, sms=SMS):
    """Both instances' launches replaced by the plain pieces on what the
    wrapper hands them, on a card of ``sms`` SMs (``card_limits``, which
    asks the CUDA runtime, stands in for). The persistent stand-in reads its weights back
    from the packed blocks and its biases from the bias buffer, decodes
    only its slice's rows (their own noise rows) and checks the shared
    h buffer's shape; the row-block stand-in reads the flat buffers. Each
    counts as its launch would."""
    calls = []

    def persistent(giz1, start, w, b, hbuf, codes, plan, base, end, C_, H_, L_, greedy, seed, temperature, row_base):
        assert (C_, H_, L_) == (C, H, L) and plan.K == kg._up(H, 32)
        assert hbuf.shape == (L, 2, plan.slices * plan.g * plan.rows, plan.K) and hbuf.dtype == BF
        assert not hbuf.any() and base % (plan.g * plan.rows) == 0 and end <= codes.shape[0]
        wc, w_hh, w_ih, w_out = _unpack(w, plan, C, H, L)
        G = 3 * H
        bh, bi, b_out = b[: L * G].reshape(L, G), b[L * G: (2 * L - 1) * G].reshape(L - 1, G), b[(2 * L - 1) * G:]
        layers = [(None if l == 0 else w_ih[l - 1], None if l == 0 else bi[l - 1], w_hh[l], bh[l]) for l in range(L)]
        codes[base:end] = _compose(giz1[base:end], start, wc, layers, w_out, b_out, codes.shape[1],
                                   torch.arange(base, end) + row_base, seed, greedy, temperature)
        calls.append(("persistent", base, end))
        kg._count("persistent")

    def row_block(giz1, start, w, b, codes, C_, H_, L_, greedy, seed, temperature, row_base):
        assert (C_, H_, L_) == (C, H, L)
        G, mats, bs, off, boff = 3 * H, [], [], 0, 0
        for n in [C] + [H] * (2 * L - 1) + [H]:
            cols = C if len(mats) == 2 * L else G
            mats.append(w[off: off + n * cols].float().reshape(n, cols))
            off += n * cols
        for n in [G] * (2 * L - 1) + [C]:
            bs.append(b[boff: boff + n])
            boff += n
        assert off == w.numel() and boff == b.numel()
        layers = [(None, None, mats[1], bs[0])] + [
            (mats[2 * l], bs[2 * l - 1], mats[2 * l + 1], bs[2 * l]) for l in range(1, L)]
        codes.copy_(_compose(giz1, start, mats[0], layers, mats[-1], bs[-1], codes.shape[1],
                             torch.arange(codes.shape[0]) + row_base, seed, greedy, temperature))
        calls.append(("row_block", 0, codes.shape[0]))
        kg._count("row_block")

    monkeypatch.setattr(kg, "_launch_persistent", persistent)
    monkeypatch.setattr(kg, "_launch_row_block", row_block)
    monkeypatch.setattr(kg, "card_limits", lambda device: (sms, SMEM))
    return calls


def _counts():
    return kg.launches, kg.persistent_launches, kg.row_block_launches


@pytest.mark.parametrize("greedy,temperature", [(True, 1.0), (False, 0.7)])
@pytest.mark.parametrize("case", ["persistent", "sliced", "no_plan", "forced_row_block"])
def test_wrapper_routes_by_the_plan_with_plain_launches(case, greedy, temperature, monkeypatch):
    """The wrapper's set-up and launches on the CPU, each launch replaced by
    the plain pieces: the persistent instance wherever generate_plan lays
    the decode out (once, or once per slice on a card of 3 SMs), the
    row-block instance where it returns None (5 layers) or where asked;
    codes equal fused_generate_ref's, each launch counted on its own
    instance and on ``launches``, never on the other."""
    L = 5 if case == "no_plan" else 2
    cfg, model = _model(seed=7, gru_layers=L)
    B = 200 if case == "sliced" else 9
    calls = _plain_launches(monkeypatch, cfg.charset_size, cfg.gru_hidden, L, sms=3 if case == "sliced" else SMS)
    z_emb = _z_emb(model, cfg, B)
    before = _counts()
    got = kg._decode(model, cfg, z_emb, 11, greedy, temperature, row_block=case == "forced_row_block")
    want = kg.fused_generate_ref(model, cfg, z_emb, 11, greedy, temperature)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    n = len(calls)
    kind = "persistent" if case in ("persistent", "sliced") else "row_block"
    assert all(c[0] == kind for c in calls)
    assert n == (2 if case == "sliced" else 1)
    if case == "sliced":
        assert kg.generate_plan(B, cfg.charset_size, cfg.gru_hidden, L, sms=3).slices == 2
        assert kg.generate_plan(B, cfg.charset_size, cfg.gru_hidden, L).slices == 1
        assert calls == [("persistent", 0, 112), ("persistent", 112, 200)]
    added = tuple(a - b for a, b in zip(_counts(), before))
    assert added == ((n, n, 0) if kind == "persistent" else (n, 0, n))


def test_wrapper_takes_the_plain_version_on_the_cpu_and_launches_nothing(monkeypatch):
    with pytest.raises(ValueError, match="not a CUDA device"):
        kg.card_limits("cpu")  # the card's limits come from the CUDA runtime only
    calls = _plain_launches(monkeypatch, 37, 24, 2)
    cfg, model = _model()
    z_emb = _z_emb(model, cfg, 4)
    before = _counts()
    got = kg.fused_generate(model, cfg, z_emb, 3, greedy=False, temperature=0.9)
    assert torch.equal(got, kg.fused_generate_ref(model, cfg, z_emb, 3, greedy=False, temperature=0.9))
    assert calls == [] and _counts() == before
    # a CUDA tensor would launch: the wrapper's own checks come first
    with pytest.raises(ValueError, match="unsupported device"):
        kg.fused_generate(model, cfg, torch.empty(2, cfg.latent_dim, device="meta"))
    assert dataclasses.is_dataclass(kg.generate_plan(4, 37, 24, 2))


def test_probe_variants_apply_to_the_kernel_source():
    """Every variant of probes/generate_probe.py finds the text it replaces
    in csrc/generate.cu, and the base variant is the source itself; the
    other head placement adds the one barrier a step and reads the codes
    back."""
    from pathlib import Path

    from molvax_torch.probes.generate_probe import VARIANTS
    from molvax_torch.probes.stack_probe import variant_source

    text = (Path(kg.__file__).parent / "csrc" / "generate.cu").read_text()
    assert variant_source(text, "base", VARIANTS) == text
    for name in VARIANTS:
        assert (variant_source(text, name, VARIANTS) != text) == (name != "base")
    split = variant_source(text, "head_split", VARIANTS)
    assert split.count("group_barrier(a.flags + grp") == text.count("group_barrier(a.flags + grp") + 1
    assert "t * L + l + 1" not in split and "__ldcg(a.codes" in split


def test_packed_weights_are_built_once_per_weight_version(monkeypatch):
    """The persistent decode packs the decoder's weights once and reuses
    them while the weights stay as they are; an in-place update (as an
    optimizer step makes) repacks them, and the codes follow the new
    weights."""
    _plain_launches(monkeypatch, 37, 24, 2)
    cfg, model = _model(seed=4)
    z_emb = _z_emb(model, cfg, 8)
    plan = kg.generate_plan(8, 37, 24, 2)
    before = kg._decode(model, cfg, z_emb, 0, True, 1.0)
    w1, b1 = kg._packed_blocks(model, plan)
    assert kg._packed_blocks(model, plan)[0] is w1
    with torch.no_grad():
        model.linear_4.weight.mul_(-1.0)  # in place: the version counter moves
        model.gru.weight_hh_l1.add_(0.5)
    w2, b2 = kg._packed_blocks(model, plan)
    assert w2 is not w1 and not torch.equal(w2, w1) and torch.equal(b2, b1)
    after = kg._decode(model, cfg, z_emb, 0, True, 1.0)
    assert torch.equal(after, kg.fused_generate_ref(model, cfg, z_emb))
    assert not torch.equal(after, before)
