"""The scan route's fp32 decoder step as hand-written kernels
(``kernels.generate.FusedStep``, ``csrc/decode_step.cu``), on the CPU.

On a card the scan route and beam search run a decode as one packing launch
and one latent-gate launch, then per step one fused GRU-cell launch a layer
and one head launch; on the CPU they run ``nn.decoder.decoder_step``. What
the CPU can hold: the kernels' plain versions (the packed layout, z's half of
layer 0's gates hoisted out of the steps, the one-hot half as a gather, the
fused step, its scores and codes) against ``decoder_step`` and the dense
products, at ``zinc250k``'s, ``moses_scaled``'s and a strict-fp32 model's
widths, B = 1, 256 and 1,280, and at 80 classes (the head's two chunks);
the cluster planner; the scan route's wiring of the step (its buffers, the
last codes, the scores for ``auto_step``, the first maximum) with each
launch replaced by its plain version; the CPU's stepper
(``nn.decoder.PlainStep``) bit for bit the loop of ``decoder_step``; the
CPU counting no launch. The kernels against their plain versions, the
launch counter per launch and per replay: the ``card`` tests, which skip
here, and ``chip_smoke.py`` phase 28. No JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from molvax_torch.config import ModelConfig, get_preset
from molvax_torch.data.charset import DEFAULT_CHARSET
from molvax_torch.data.featurize import one_hot
from molvax_torch.kernels import automaton as kg_auto
from molvax_torch.kernels import generate as kg
from molvax_torch.kernels.gru_stack import SMEM
from molvax_torch.latent import sample as ls
from molvax_torch.nn.decoder import decoder_start, decoder_step, latent_embed
from molvax_torch.nn.vae import MolecularVAE

TOL = 1e-5  # the plain step against decoder_step: the same fp32 products, summed in another order
CARD_TOL = 1e-4  # the kernels against their plain versions: 3xTF32 products, other sum orders
STEPS = 2  # t = 0 (the start vector) and t = 1 (a gathered code)

CONFIGS = {
    "zinc250k": get_preset("zinc250k").model,
    "moses_scaled": get_preset("moses_scaled").model,
    "strict_fp32": ModelConfig(compute_dtype="float32"),
    "charset_80": ModelConfig(compute_dtype="float32", charset_size=80),  # the head's classes in two chunks
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the step kernels run on the chip (chip_smoke.py phase 28)")
    return torch.device("cuda:0")


def _model(cfg, learned: bool, device="cpu", seed: int = 0):
    cfg = dataclasses.replace(cfg, learned_start=learned)
    torch.manual_seed(seed)
    model = MolecularVAE(cfg, device=device)
    if model.start_token is not None:
        with torch.no_grad():
            model.start_token.normal_()
    model.requires_grad_(False)
    return cfg, model


def _z_emb(model, cfg, B: int, seed: int = 1) -> torch.Tensor:
    z = torch.randn(B, cfg.latent_dim, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        return latent_embed(model, cfg, z.to(model.linear_4.weight.device))


@pytest.mark.parametrize("mode", ["greedy", "gumbel"])
@pytest.mark.parametrize("learned", [True, False], ids=["learned_start", "zero_start"])
@pytest.mark.parametrize("B", [1, 256, 1280])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_step_equals_decoder_step(name, B, learned, mode):
    """``decode_step_ref`` (z's gates hoisted, the one-hot product a gather)
    against ``decoder_step`` over the first steps, fed the same codes (the
    first maximum of decoder_step's scores): hidden states, logits and
    scores within 1e-5."""
    cfg, model = _model(CONFIGS[name], learned)
    C = cfg.charset_size
    z_emb = _z_emb(model, cfg, B)
    with torch.no_grad():
        hs, prev = decoder_start(model, cfg, B, "cpu")
        gz = kg.latent_gates_ref(model, z_emb)
        hs_f, codes = hs.clone(), None
        for t in range(STEPS):
            hs, logits = decoder_step(model, hs, z_emb, prev)
            hs_f, logits_f = kg.decode_step_ref(model, hs_f, gz, codes)
            assert (hs_f - hs).abs().max() <= TOL and (logits_f - logits).abs().max() <= TOL
            if mode == "gumbel":
                noise = kg.gumbel_noise(7, t, B, C, "cpu")
                scores, scores_f = logits / 0.7 + noise, logits_f / 0.7 + noise
            else:
                scores, scores_f = logits, logits_f
            assert (scores_f - scores).abs().max() <= TOL / 0.7
            codes = torch.argmax(scores, dim=-1).to(torch.int32)
            prev = one_hot(codes, C)


@pytest.mark.parametrize("learned", [True, False], ids=["learned_start", "zero_start"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_gathered_one_hot_and_hoisted_gates_equal_their_dense_products(name, learned):
    """The one-hot half of layer 0's gates is row ``code`` of W_ic^T (the
    dense product of the one-hot, exactly), the start vector's product at
    t = 0; z's half plus it is layer 0's dense input product within 1e-5."""
    cfg, model = _model(CONFIGS[name], learned)
    B, C = 64, cfg.charset_size
    codes = torch.randint(0, C, (B,), generator=torch.Generator().manual_seed(3), dtype=torch.int32)
    w0, b0 = model.gru.weight_ih_l0, model.gru.bias_ih_l0
    wc = w0[:, w0.shape[1] - C:]
    with torch.no_grad():
        assert torch.equal(kg.code_gates_ref(model, codes), one_hot(codes, C) @ wc.T)
        start = model.start_token if learned else torch.zeros(C)
        assert torch.equal(kg.code_gates_ref(model, None), start[None, :] @ wc.T)
        z_emb = _z_emb(model, cfg, B)
        dense = torch.cat([z_emb, one_hot(codes, C)], dim=-1) @ w0.T + b0
        hoisted = kg.latent_gates_ref(model, z_emb) + kg.code_gates_ref(model, codes)
        assert (hoisted - dense).abs().max() <= TOL


@pytest.mark.parametrize("name", list(CONFIGS))
def test_packed_layout_holds_the_weights_with_zero_padding(name):
    """``pack_step_ref`` (the packing launch's output): each matrix at its
    padded place (rows gate * Hp + unit, columns to a multiple of 32; W_ic
    transposed; W_out's rows to a multiple of 8), every padding element
    zero, z's embedding padded to Kz."""
    cfg, model = _model(CONFIGS[name], True)
    B = 5
    z_emb = _z_emb(model, cfg, B)
    _, L, H, C, Lz = kg.step_sizes(model, z_emb)
    Hp, Kz, Cp = -(-H // 32) * 32, -(-Lz // 32) * 32, -(-C // 8) * 8
    w = kg.pack_step_ref(model, z_emb)
    gru = model.gru

    def unpad(m: torch.Tensor, K: int, Kp: int) -> torch.Tensor:  # (3 Hp, Kp) -> (3 H, K), pads zero
        m3 = m.reshape(3, Hp, Kp)
        assert m3[:, H:].abs().sum() == 0 and m3[:, :, K:].abs().sum() == 0
        return m3[:, :H, :K].reshape(3 * H, K)

    for li in range(L):
        assert torch.equal(unpad(w.whh[li], H, Hp), getattr(gru, f"weight_hh_l{li}"))
        assert torch.equal(unpad(w.bhh[li][:, None], 1, 1)[:, 0], getattr(gru, f"bias_hh_l{li}"))
        assert torch.equal(unpad(w.bih[li][:, None], 1, 1)[:, 0], getattr(gru, f"bias_ih_l{li}"))
        if li:
            assert torch.equal(unpad(w.wih[li], H, Hp), getattr(gru, f"weight_ih_l{li}"))
        else:
            assert w.wih[li] is None
    assert torch.equal(unpad(w.wz, Lz, Kz), gru.weight_ih_l0[:, :Lz])
    assert w.wc.shape == (C, 3 * Hp)
    assert torch.equal(unpad(w.wc.T.contiguous(), C, C), gru.weight_ih_l0[:, Lz:])
    assert w.w4.shape == (Cp, Hp) and torch.equal(w.w4[:C, :H], model.linear_4.weight)
    assert w.w4[C:].abs().sum() == 0 and w.w4[:, H:].abs().sum() == 0
    assert torch.equal(w.b4[:C], model.linear_4.bias) and w.b4[C:].abs().sum() == 0
    assert w.z.shape == (B, Kz) and torch.equal(w.z[:, :Lz], z_emb) and w.z[:, Lz:].abs().sum() == 0


# (B, Hp, k-tiles) of the launches: z's gates, layer 0, layers l >= 1, at
# zinc250k (Hp 512, Kz 320), moses_scaled (1024, 512), beam search's rows,
# one row, a ragged batch
PLAN_SHAPES = [(B, Hp, kt) for B in (1, 6, 256, 1280) for Hp, kts in ((512, (10, 16, 32)), (1024, (16, 32, 64)))
               for kt in kts] + [(33, 64, 2), (2, 32, 1)]
# clusters of 1 .. 8 blocks held at once: an H100's, and a smaller card's
CLUSTERS = {"h100": kg.H100_CLUSTERS, "smaller": (100, 50, 33, 25, 20, 16, 14, 12)}


@pytest.mark.parametrize("card_name", list(CLUSTERS))
@pytest.mark.parametrize("B,Hp,kt", PLAN_SHAPES)
def test_cell_plan_takes_the_least_cost(B, Hp, kt, card_name):
    """``cell_plan``: a cluster of 1 .. min(8, kt) blocks, and no other size
    of less ``plan_cost`` (waves x (a wave's fixed cost + a block's
    k-tiles)); the tile's 32 units divide Hp, and its shared memory fits an
    H100's."""
    clusters = CLUSTERS[card_name]
    s = kg.cell_plan(B, Hp, kt, clusters)
    assert 1 <= s <= min(8, kt) and Hp % 32 == 0
    assert kg.CELL_SMEM <= SMEM
    cost = kg.plan_cost(s, B, Hp, kt, clusters)
    assert all(cost <= kg.plan_cost(q, B, Hp, kt, clusters) for q in range(1, min(8, kt) + 1))


def test_cell_plan_at_zinc250k_width():
    """B=256, H=501 on an H100: 2 x 16 tiles of 128 rows x 32 units, 3
    blocks a cluster (32 clusters, 39 held at once: one wave), 96 blocks,
    for every launch of the step; beam search's 1,280 rows and
    moses_scaled's H=1,024 take clusters of 2 (the fastest measured)."""
    for kt in (10, 16, 32):
        s = kg.cell_plan(256, 512, kt)
        assert (s, kg.cell_tiles(256, 512), s * kg.cell_tiles(256, 512)) == (3, 32, 96)
    assert kg.cell_plan(1280, 512, 32) == 2
    assert kg.cell_plan(256, 1024, 64) == 2


class _PlainStep:
    """``kernels.generate.FusedStep``'s interface over the plain versions:
    the padded hidden states, the last codes read from a view, the logits,
    scores and codes written where the kernels write them."""

    launches = 0

    def __init__(self, model, z_emb):
        self.model = model
        self.B, self.L, self.H, self.C, _ = kg.step_sizes(model, z_emb)
        self.Hp = -(-self.H // 32) * 32
        self.gz = kg.latent_gates_ref(model, z_emb)

    def state(self, *lead):
        return torch.zeros(*lead, self.L, self.B, self.Hp)

    def step(self, h, h_out, prev, logits, scores=None, noise=None, temperature=1.0, codes=None):
        hs, lg = kg.decode_step_ref(self.model, h[:, :, : self.H], self.gz, prev)
        h_out.zero_()
        h_out[:, :, : self.H] = hs
        logits.copy_(lg)
        sc = lg if noise is None else lg * float(np.float32(1.0) / np.float32(temperature)) + noise
        if scores is not None:
            scores.copy_(sc)
        if codes is not None:
            codes.copy_(torch.argmax(sc, dim=-1).to(torch.int32))


def _wiring_model(C: int):
    cfg = ModelConfig(max_len=16, charset_size=C, latent_dim=16, conv_kernels=(5, 5, 5), enc_hidden=16,
                      gru_hidden=24, gru_layers=2, learned_start=True, use_pallas_generation=False)
    return _model(cfg, True)


def _scan_with(model, cfg, z, seed, greedy: bool, constrained: bool):
    """``latent.sample._scan`` over fresh buffers: (codes, logits)."""
    B, T, C = z.shape[0], cfg.max_len, cfg.charset_size
    itab, state = ls._automaton(DEFAULT_CHARSET, B, T, "cpu") if constrained else (None, None)
    codes = torch.empty(B, T, dtype=torch.int32)
    logits = torch.empty(B, T, C)
    ls._scan(model, cfg, z, seed, None if greedy else 1.0, itab, state, 0, codes, logits)
    return codes, logits


def _check_card_wiring(monkeypatch, C: int, greedy: bool, constrained: bool) -> None:
    cfg, model = _wiring_model(C)
    B = 6
    z = 2.0 * torch.randn(B, cfg.latent_dim, generator=torch.Generator().manual_seed(5))
    seed = ls._draw_seed(torch.Generator().manual_seed(9))
    with torch.no_grad():
        want_codes, want_logits = ls._eager_scan(model, cfg, z, seed, greedy, 1.0, constrained, DEFAULT_CHARSET, 0)
        monkeypatch.setattr(ls, "decoder_stepper", lambda model, cfg, z_emb: _PlainStep(model, z_emb))
        codes, logits = _scan_with(model, cfg, z, seed, greedy, constrained)
    assert torch.equal(codes, want_codes)
    assert (logits - want_logits).abs().max() <= TOL


@pytest.mark.parametrize("constrained", [False, True], ids=["free", "constrained"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_card_wiring_of_the_scan_decodes_what_the_cpu_route_decodes(monkeypatch, greedy, constrained):
    """``latent.sample._scan`` with ``FusedStep``'s launches replaced by
    their plain versions (padded hidden states): the codes of the CPU route
    (decoder_step), logits within 1e-5; the last codes read from
    codes[:, t - 1], the scores handed to auto_step, the first maximum
    written into codes[:, t]."""
    _check_card_wiring(monkeypatch, 37, greedy, constrained)


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_card_wiring_at_80_classes(monkeypatch, greedy):
    """The same past the head kernel's 64-class chunk, at C = 80 (no
    automaton: it is the 37-character charset's)."""
    _check_card_wiring(monkeypatch, 80, greedy, False)


@pytest.mark.parametrize("constrained,C", [(False, 37), (True, 37), (False, 80)],
                         ids=["free-37", "constrained-37", "free-80"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_plain_stepper_decodes_as_the_decoder_step_loop(greedy, constrained, C):
    """On the CPU the scan route's stepper (``nn.decoder.PlainStep``) is
    the loop of ``decoder_step``, the scores and the selection written out
    op by op, bit for bit: codes and logits."""
    cfg, model = _wiring_model(C)
    B, T = 6, cfg.max_len
    z = 2.0 * torch.randn(B, cfg.latent_dim, generator=torch.Generator().manual_seed(5))
    seed = ls._draw_seed(torch.Generator().manual_seed(9))
    with torch.no_grad():
        codes, logits = _scan_with(model, cfg, z, seed, greedy, constrained)
        itab, state = ls._automaton(DEFAULT_CHARSET, B, T, "cpu") if constrained else (None, None)
        table = None if greedy else kg.gumbel_table(seed, T, B, C, "cpu")
        z_emb = latent_embed(model, cfg, z)
        hs, prev = decoder_start(model, cfg, B, "cpu")
        want_codes, want_logits = torch.empty(B, T, dtype=torch.int32), torch.empty(B, T, C)
        for t in range(T):
            hs, logits_t = decoder_step(model, hs, z_emb, prev)
            scores = logits_t if table is None else logits_t / 1.0 + table[t]
            if itab is not None:
                code_t = kg_auto.auto_step(itab, state, scores.contiguous(), T - 1 - t)[:, 0]
            else:
                code_t = torch.argmax(scores, dim=-1)
            want_codes[:, t] = code_t.to(torch.int32)
            want_logits[:, t] = logits_t
            prev = one_hot(code_t, C)
    assert torch.equal(codes, want_codes) and torch.equal(logits, want_logits)


def test_cpu_decode_counts_no_step_launch_and_the_step_refuses_the_cpu():
    """On the CPU the scan route runs decoder_step: no launch is counted;
    ``FusedStep`` takes only a card's tensors."""
    cfg, model = _model(CONFIGS["zinc250k"], True)
    cfg = dataclasses.replace(cfg, max_len=4)
    before = kg.decode_step_launches
    z = torch.randn(3, cfg.latent_dim)
    with torch.no_grad():
        ls._eager_scan(model, cfg, z, 11, False, 1.0, True, DEFAULT_CHARSET, 0)
    assert kg.decode_step_launches == before
    with pytest.raises(ValueError, match="plain route"):
        kg.FusedStep(model, _z_emb(model, cfg, 3))


@pytest.mark.card
@pytest.mark.parametrize("name,B", [("zinc250k", 256), ("zinc250k", 1280), ("moses_scaled", 256), ("charset_80", 256)])
def test_kernels_equal_their_plain_versions_on_the_card(card, name, B):
    """The packing bit for bit its plain version; z's gates, then each
    step's hidden states and logits within 1e-4 of the plain step fed the
    same state and codes; the scores torch's, and the codes their first
    maximum, bit for bit; L + 1 launches a step, 2 a decode's set-up."""
    cfg, model = _model(CONFIGS[name], True, device=card)
    C = cfg.charset_size
    z_emb = _z_emb(model, cfg, B)
    with torch.no_grad():
        before = kg.decode_step_launches
        fs = kg.FusedStep(model, z_emb)
        assert kg.decode_step_launches == before + 2
        ref = kg.pack_step_ref(model, z_emb)
        assert all(torch.equal(a, b) for a, b in zip([*fs.w.whh, *fs.w.bhh, *fs.w.bih, fs.w.wz, fs.w.wc, fs.w.w4,
                                                      fs.w.b4, fs.w.z],
                                                     [*ref.whh, *ref.bhh, *ref.bih, ref.wz, ref.wc, ref.w4, ref.b4,
                                                      ref.z]))
        H, Hp = fs.H, fs.Hp
        gz = kg.latent_gates_ref(model, z_emb)
        assert (fs.gz.view(B, 3, Hp)[:, :, :H].reshape(B, 3 * H) - gz).abs().max() <= CARD_TOL
        h, codes = fs.state(), None
        for t in range(4):
            h_out, logits = torch.empty_like(h), torch.empty(B, C, device=card)
            scores, out = torch.empty(B, C, device=card), torch.empty(B, dtype=torch.int32, device=card)
            noise = kg.gumbel_noise(5, t, B, C, card)
            before = kg.decode_step_launches
            fs.step(h, h_out, codes, logits, scores, noise, 0.7, out)
            assert kg.decode_step_launches == before + fs.L + 1
            hs_ref, lg_ref = kg.decode_step_ref(model, h[:, :, :H], gz, codes)
            assert (h_out[:, :, :H] - hs_ref).abs().max() <= CARD_TOL
            assert (logits - lg_ref).abs().max() <= CARD_TOL and h_out[:, :, H:].abs().sum() == 0
            assert torch.equal(scores, logits / 0.7 + noise)
            assert torch.equal(out.long(), torch.argmax(scores, dim=-1))
            h, codes = h_out, out


@pytest.mark.card
def test_launch_counter_per_decode_and_per_replay_on_the_card(card):
    """A constrained decode of a zinc250k-width model: 2 + T (L + 1) step
    launches a call, op by op and replayed alike; the capturing call counts
    its first step's (2 + L + 1) besides its replay's."""
    cfg, model = _model(CONFIGS["zinc250k"], True, device=card)
    T, L = cfg.max_len, cfg.gru_layers
    z = torch.randn(32, cfg.latent_dim, device=card)
    ls._graphs.pop(model, None)
    per_call = []
    for i in range(ls._CAPTURE_AT_CALL + 2):
        before = kg.decode_step_launches
        ls.generate(model, cfg, z, torch.Generator().manual_seed(i), greedy=False, constrained=True)
        per_call.append(kg.decode_step_launches - before)
    want = [2 + T * (L + 1)] * len(per_call)
    want[ls._CAPTURE_AT_CALL - 1] += 2 + L + 1
    assert per_call == want
