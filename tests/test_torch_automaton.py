"""The automaton kernel's module (molvax_torch/kernels/automaton.py) on the
CPU: the packed layout, the plain packed step (``auto_step_plain``) against the reference's
``auto_step_ref`` (molvax/kernels/automaton.py:142), n steps in one call,
and the wrappers' routing.

The reference's ``auto_step_ref`` is the Pallas kernel's math by
construction (the kernel body calls the same select_advance), and the
reference's own slow tests hold the Pallas kernel to it bit for bit; the
CUDA kernel itself runs only on a card, where ``chip_smoke.py`` (phase 16)
holds it to the plain version here, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molvax.data.charset import DEFAULT_CHARSET as J_CS
from molvax.kernels import automaton as jauto
from molvax.latent import constrain as jc
from molvax_torch.data.charset import DEFAULT_CHARSET
from molvax_torch.kernels import automaton as tauto
from molvax_torch.latent import constrain as tc

T = 40
B = 8
TB = tc.build_tables(DEFAULT_CHARSET)
ITAB = tauto.pack_tables(TB)
C = TB.n


def _scores(steps, rows, seed):
    rng = np.random.default_rng(seed)
    s = 2.0 * rng.standard_normal((rows, steps, C)).astype(np.float32)
    s[..., 0] -= 3.0
    return s


def test_layout_constants():
    assert tauto.row_width(120) == 423  # S at T=120
    assert tauto.SC == 17 and len(tauto._TAB_ROWS) == 18 and ITAB.shape == (18, C)
    lay = tauto.layout(120)
    assert [name for name in lay] == ["val", "par", "stack", "rpart", "rhint", "rres", "ppa", "ppb", "sc"]
    assert lay["val"] == (0, 120) and lay["par"] == (120, 120) and lay["stack"] == (240, 16)
    assert lay["rpart"] == (256, 10) and lay["ppa"] == (286, 60) and lay["sc"] == (406, 17)
    for a in (1, 2, 3, 7, 20, 39, 40, 120, 121):
        assert tauto.atoms_of(tauto.row_width(a)) == a
    with pytest.raises(ValueError, match="width"):
        tauto.atoms_of(64)
    assert ITAB.dtype == torch.int32 and ITAB.is_contiguous()


def test_pack_unpack_round_trip():
    st = tc.init_state(B, T, device="cpu")
    # move every field off its initial value
    scores = torch.from_numpy(_scores(12, B, 0))
    for k in range(12):
        st, _ = tauto.select_advance(TB, st, scores[:, k], T - 1 - k)
    packed = tauto.pack_state(st)
    assert packed.dtype == torch.int32 and packed.shape == (B, tauto.row_width(T))
    back = tauto.unpack_state(packed)
    for name, a, b in zip(st._fields, st, back):
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name
    assert torch.equal(tauto.new_state(B, T, "cpu"), tauto.pack_state(tc.init_state(B, T, device="cpu")))


def test_auto_step_ref_matches_reference_auto_step_ref():
    """30 steps of the port's plain packed step (``auto_step_plain``, one
    step per call, in place) against the reference's ``auto_step_ref``,
    exact: codes and every state field."""
    jtb = jc.build_tables(J_CS)
    j_step = jax.jit(lambda p, s, r: jauto.auto_step_ref(jtb, p, s, r))
    p_t = tauto.new_state(B, T, "cpu")
    p_j = jauto.pack_state(jc.init_state(B, T))
    scores = _scores(30, B, 1)
    for t in range(30):
        p_j, c_j = j_step(p_j, jnp.asarray(scores[:, t]), jnp.int32(T - 1 - t))
        c_t = tauto.auto_step_plain(ITAB, p_t, torch.from_numpy(scores[:, t]), T - 1 - t)
        assert c_t.shape == (B, 1)
        np.testing.assert_array_equal(c_t[:, 0].numpy(), np.asarray(c_j), err_msg=f"step {t}")
        for name, a, b in zip(jc.ConState._fields, jauto.unpack_state(p_j), tauto.unpack_state(p_t)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"step {t}: {name}")


def test_n_steps_in_one_call_equal_n_calls():
    scores = torch.from_numpy(_scores(T, B, 2))
    one = tauto.new_state(B, T, "cpu")
    codes_one = tauto.auto_step(ITAB, one, scores, T - 1)
    many = tauto.new_state(B, T, "cpu")
    codes_many = torch.cat([tauto.auto_step(ITAB, many, scores[:, t], T - 1 - t) for t in range(T)], dim=1)
    assert codes_one.shape == (B, T) and codes_one.dtype == torch.int32
    assert torch.equal(codes_one, codes_many) and torch.equal(one, many)
    # and the same walk through auto_mask / auto_advance
    third = tauto.new_state(B, T, "cpu")
    for t in range(T):
        m = tauto.auto_mask(ITAB, third, T - 1 - t)
        assert m.dtype == torch.bool and bool(m.gather(1, codes_one[:, t : t + 1].long()).all())
        tauto.auto_advance(ITAB, third, codes_one[:, t])
    assert torch.equal(third, one)


def test_wrappers_take_the_plain_version_on_the_cpu_only():
    counts = (tauto.step_launches, tauto.mask_launches, tauto.advance_launches)
    st = tauto.new_state(3, T, "cpu")
    tauto.auto_step(ITAB, st, torch.zeros(3, C), T - 1)
    tauto.auto_mask(ITAB, st, T - 2)
    tauto.auto_advance(ITAB, st, torch.zeros(3, dtype=torch.int32))
    assert (tauto.step_launches, tauto.mask_launches, tauto.advance_launches) == counts
    meta = tauto.new_state(3, T, "cpu").to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tauto.auto_mask(ITAB.to("meta"), meta, 3)
    with pytest.raises(ValueError, match="int32"):
        tauto.auto_mask(ITAB, st.to(torch.int64), 3)
    with pytest.raises(ValueError, match="scores"):
        tauto.auto_step(ITAB, st, torch.zeros(3, C, dtype=torch.float64), 3)
    with pytest.raises(ValueError, match="scores"):
        tauto.auto_step(ITAB, st, torch.zeros(2, C), 3)
    with pytest.raises(ValueError, match="tokens"):
        tauto.auto_advance(ITAB, st, torch.zeros(2, dtype=torch.int32))
