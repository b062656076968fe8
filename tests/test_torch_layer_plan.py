"""The in-kernel per-layer GRU's planner and wrappers, on the CPU (no JAX).

The persistent forward and reverse sweep of ``csrc/gru_layer.cu`` run only
on a card (``chip_smoke.py`` phases 12, 15, 19 and 20 hold them against
their plain versions there). Here: ``layer_plan`` fits the card it plans
for (shared memory, threads, blocks) at the widths the presets and the
wide layers give it, on an H100 SXM's 132 SMs and an H100 PCIe's 114; the
widths that no layout of the persistent route takes get a plan that
streams W_hh; and the wrappers raise, before any launch, where no plan
fits the card.
"""

import functools
from pathlib import Path

import pytest
import torch

from molvax_torch.config import get_preset
from molvax_torch.kernels import gru as kgru
from molvax_torch.kernels import gru_stack as ks
from molvax_torch.nn.decoder import decoder_input_size

CARDS = [(132, 232448), (114, 232448)]  # an H100 SXM's SMs and shared memory a block, an H100 PCIe's
_MOSES = get_preset("moses_scaled").model
# (I, H) by element size: zinc250k (I = 329, 330: fwd_gi's, 501; H = 501),
# moses_scaled (H = 1024), and the wide layers
WIDTHS = {2: [(329, 501), (330, 501), (501, 501), (decoder_input_size(_MOSES), 1024), (1024, 1024), (329, 2304),
              (329, 4096)],
          4: [(329, 501), (330, 501), (501, 501), (decoder_input_size(_MOSES), 1024), (329, 1536), (329, 2304)]}


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("esize,hoisted", [(2, False), (4, False), (2, True)])
def test_layer_plan_fits_the_card_it_plans_for(card, esize, hoisted):
    """Every plan at B = 1, 16 and 256 fits a card of ``card``'s SMs and
    shared memory: at most one block an SM, each block's shared memory (the
    kernels' layouts, ``fwd_smem`` / ``sweep_smem``) within a block's, its
    threads within the kernels' ``__launch_bounds__(256)``, which holds a
    thread to 255 registers, so that a block's fit an SM's 65,536; the
    slices cover B rows and the blocks H units; the warp tiles are the
    kernels' instances; one ring buffer only where a product is whole and
    nothing streams."""
    sms, smem = card
    for I, H in WIDTHS[esize]:
        I = 0 if hoisted else I
        for B in (1, 16, 256):
            plan = kgru.layer_plan(B, I, H, sms, smem, esize, hoisted)
            assert plan.blocks <= sms and plan.g * plan.rows * plan.slices >= B, (B, I, H, plan)
            assert plan.q * plan.units >= H and plan.units % 8 == 0 and plan.units <= 64
            assert plan.fwd_smem == kgru.fwd_smem(I, H, plan.units, plan.rows, plan.chunk, plan.stages, not hoisted,
                                                  plan.res_ih, plan.res_hh, esize)
            assert plan.bwd_smem == kgru.sweep_smem(H, plan.units, plan.rows, plan.bwd_chunk, plan.bwd_stages,
                                                    plan.bwd_res_hh, esize)
            assert max(plan.fwd_smem, plan.bwd_smem) <= smem
            assert plan.threads <= kgru._MAX_THREADS == 256
            assert plan.rows == 16 * plan.mt * plan.rt and plan.mt in ((1, 2, 4) if esize == 2 else (1, 2))
            assert plan.chunk % 16 == 0 and plan.bwd_chunk % 16 == 0
            whole = max(ks._up(H, 16), ks._up(I, 16))
            assert (plan.stages == 1) == (plan.chunk >= whole and plan.res_hh and (hoisted or plan.res_ih))
            assert (plan.bwd_stages == 1) == (plan.bwd_chunk >= ks._up(3 * H, 16) and plan.bwd_res_hh)
            assert not (hoisted and plan.res_ih)


@pytest.mark.parametrize("H,esize", [(2304, 2), (4096, 2), (1536, 4), (2304, 4)])
def test_widths_no_layout_takes_get_a_streamed_plan(H, esize):
    """bf16 H = 2,304 and 4,096 and fp32 H = 1,536 and 2,304 at B=256: no
    layout of the persistent route (``stack_plan`` raises), but a layer
    plan on one launch a group of every SM it needs, with W_hh streamed
    from L2 or device memory each step, as the previous shared-memory check
    refused for bf16 H = 4,096 and fp32 H = 2,304."""
    with pytest.raises(ValueError, match="no layout fits"):
        ks.stack_plan(256, H, esize=esize)
    md = torch.bfloat16 if esize == 2 else torch.float32
    assert kgru.layer_route(256, H, md) == "in_kernel"
    plan = kgru.layer_plan(256, 329, H, esize=esize)
    assert not plan.res_hh and not plan.bwd_res_hh and plan.blocks <= ks.SMS
    assert kgru.layer_plan(256, 0, H, esize=2, hoisted=True).blocks <= ks.SMS


def test_layer_plan_at_zinc250k_width():
    """zinc250k, B=256: bf16, 8 groups x 16 blocks of 32 units and 32 rows,
    every slice resident and each product whole in one ring buffer; the
    hoisted instance the same layout; strict fp32 takes fewer units and
    more rows."""
    assert kgru.layer_plan(256, 329, 501) == kgru.LayerPlan(8, 16, 32, 32, 2, 1, 512, 1504, 1, 1, True, True, True,
                                                             199168, 217088)
    hoisted = kgru.layer_plan(256, 0, 501, hoisted=True)
    assert (hoisted.g, hoisted.q, hoisted.units, hoisted.rows) == (8, 16, 32, 32) and not hoisted.res_ih
    fp32 = kgru.layer_plan(256, 329, 501, esize=4)
    assert fp32.units < 32 and fp32.rows > 32 and fp32.res_hh and fp32.res_ih


def test_layer_plan_raises_where_no_layout_fits():
    """More units than 64 on each SM, or bad arguments, raise."""
    with pytest.raises(ValueError, match="no layout"):
        kgru.layer_plan(256, 329, 64 * ks.SMS + 1)
    with pytest.raises(ValueError, match="no layout"):
        kgru.layer_plan(16, 329, 64 * 8 + 8, 8)
    for bad in (dict(B=0), dict(I=0), dict(H=0), dict(esize=3)):
        with pytest.raises(ValueError, match="layer_plan"):
            kgru.layer_plan(**{"B": 4, "I": 8, "H": 16, **bad})


def _fail(*args, **kwargs):
    raise AssertionError("a kernel was loaded")


_SMALL_CARD = (8, ks.SMEM)  # 8 SMs: at most 512 units a layer
T, B, I, H = 2, 3, 5, 64 * 8 + 8


@pytest.mark.parametrize("wrapper", ["layer_forward", "layer_forward_in_kernel", "layer_backward_in_kernel",
                                     "scan_forward", "scan_backward", "gru_probe_scan"])
def test_wrappers_raise_where_no_plan_fits_the_card(wrapper, monkeypatch):
    """On a card that no plan fits (stood in for: 8 SMs, H = 520), the
    in-kernel route's wrappers, the router's too, raise before any launch:
    no other route, no plain version, no CPU."""
    monkeypatch.setattr(ks, "plan_limits", lambda device: _SMALL_CARD)
    monkeypatch.setattr(kgru, "_check_cuda", lambda what, *tensors: None)
    monkeypatch.setattr(kgru, "_plain_here", lambda t: False)
    monkeypatch.setattr(kgru._build, "function", _fail)
    z = torch.zeros
    x, w_ih, b, w_hh, h0 = z(T, B, I), z(3 * H, I), z(3 * H), z(3 * H, H), z(B, H)
    bf = torch.bfloat16
    res = (z(T, B, H, dtype=bf), z(T, B, 3 * H, dtype=bf), z(T, B, H, dtype=bf))
    gi = z(T, B, 3 * H)
    call = {"layer_forward": lambda: kgru.layer_forward(x, w_ih, b, w_hh, b, h0, bf),
            "layer_forward_in_kernel": lambda: kgru.layer_forward_in_kernel(x, w_ih, b, w_hh, b, h0, bf),
            "layer_backward_in_kernel": lambda: kgru.layer_backward_in_kernel((*res, x, h0, w_ih, w_hh), z(T, B, H)),
            "scan_forward": lambda: kgru.scan_forward(gi, w_hh, b, h0),
            "scan_backward": lambda: kgru.scan_backward((*res, h0, w_hh), z(T, B, H)),
            "gru_probe_scan": functools.partial(kgru.gru_probe_scan, gi, w_hh, b, h0, "matmul_only")}
    before = (kgru.layer_fwd_launches, kgru.layer_bwd_launches, kgru.scan_fwd_launches, kgru.scan_bwd_launches,
              kgru.probe_matmul_only_launches)
    with pytest.raises(ValueError, match="no layout"):
        call[wrapper]()
    assert before == (kgru.layer_fwd_launches, kgru.layer_bwd_launches, kgru.scan_fwd_launches,
                      kgru.scan_bwd_launches, kgru.probe_matmul_only_launches)


def test_layer_step_probe_variants_apply_to_the_kernel_source():
    """Each variant of probes/stack_probe.py's LAYER_VARIANTS (the in-kernel
    forward's step with its barrier or a product taken out) finds the text
    it replaces in csrc/gru_layer.cu exactly once."""
    from molvax_torch.probes import stack_probe

    text = (Path(kgru.__file__).resolve().parent / "csrc" / "gru_layer.cu").read_text()
    assert stack_probe.LAYER_VARIANTS["base"] == []
    for name, subs in stack_probe.LAYER_VARIANTS.items():
        for old, _ in subs:
            assert text.count(old) == 1, (name, old)
        assert stack_probe.variant_source(text, name, stack_probe.LAYER_VARIANTS) != text or not subs
