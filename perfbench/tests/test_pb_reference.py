"""The plain reference on the CPU: its automaton against the JAX package's,
its hash and data order against the program's, the pads of served strings
put back, a tiny cell of each traffic kind correct, the control (the
reference in fp8 in the program's place) failing, and no JAX loaded."""

import json
import os

import numpy as np
import pytest
import torch

from perfbench import corpus, weights
from perfbench.reference import constrain as ref_auto
from perfbench.reference import model as ref
from perfbench.reference import noise, served
from perfbench.reference.charset import CHARS
from perfbench.tests import bench_copy


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return bench_copy.make(tmp_path_factory.mktemp("pb_ref"))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 0xFFFFFFFF])
def test_noise_is_the_program_s(seed):
    from molvax_torch.kernels.generate import fold_in
    from molvax_torch.kernels.sampler import sample_eps

    assert noise.fold_in(seed, 1) == fold_in(seed, 1)
    step = noise.step_seeds(noise.fold_in(seed, 1), 3, 4)
    assert list(step) == [fold_in(fold_in(seed, 1), 3 + i) for i in range(4)]
    assert torch.equal(noise.normal(int(step[0]), 9, 13, "cpu"), sample_eps(int(step[0]), 9, 13, "cpu"))


@pytest.mark.parametrize("walk,B,T", [("legal", 32, 120), ("random", 16, 40)])
def test_automaton_is_the_jax_package_s(walk, B, T):
    """Masks and every state field, step by step, against the JAX package's
    automaton (the owner of the rules) on the same token streams: seeded
    walks of legal tokens, and of any tokens."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from molvax.data.charset import Charset
    from molvax.latent import constrain as owner

    assert tuple(Charset().chars) == CHARS
    tb_r, tb_o = ref_auto.build_tables(CHARS), owner.build_tables(Charset())
    st_r, st_o = ref_auto.init_state(B, T), owner.init_state(B, T)
    gen = torch.Generator().manual_seed(3)
    for t in range(T):
        m_r = ref_auto.step_mask_rem(tb_r, st_r, T - 1 - t)
        assert np.array_equal(m_r.numpy(), np.asarray(owner.step_mask_rem(tb_o, st_o, T - 1 - t)))
        scores = torch.rand(B, len(CHARS), generator=gen)
        tok = (torch.where(m_r, scores, -1.0) if walk == "legal" else scores).argmax(-1)
        st_r, st_o = ref_auto.advance(tb_r, st_r, tok), owner.advance(tb_o, st_o, jnp.asarray(tok.numpy(), jnp.int32))
        for field, a, b in zip(st_o._fields, st_r, st_o):
            assert np.array_equal(a.numpy(), np.asarray(b).astype(np.int64)), (t, field)
    assert walk == "random" or bool(st_r.done.any())


@pytest.mark.parametrize("greedy", [False, True], ids=["gumbel", "greedy"])
def test_align_places_the_pads_that_the_strings_dropped(greedy):
    """Rows decoded by the reference itself, pads inside them, are turned
    into strings; ``align`` puts every pad back where it was."""
    sizes = dict(json.loads((bench_copy.REPO / "perfbench" / "configs" / "zinc250k.json").read_text())["sizes"],
                 **bench_copy.TINY_SIZES)
    T, C, R, seed = sizes["max_len"], sizes["charset_size"], 48, 0x9E3779B9
    p = weights.make(sizes, 5, "cpu")
    z = torch.randn(R, sizes["latent_dim"], generator=torch.Generator().manual_seed(2))
    rows, emb = torch.arange(R), ref.embed(p, z)
    h, prev = z.new_zeros(sizes["gru_layers"], R, sizes["gru_hidden"]), ref.start(p, sizes, R, "cpu")
    tok = torch.zeros(R, T, dtype=torch.int64)
    with torch.no_grad(), ref.strict_fp32():
        for t in range(T):
            logits, h = ref.decode_step(p, sizes, emb, h, prev)
            tok[:, t] = (logits if greedy else logits + served.gumbel(seed, t, rows, C)).argmax(-1)
            prev = torch.nn.functional.one_hot(tok[:, t], C).float()
    strings = ["".join(CHARS[c] for c in row if c) for row in tok.tolist()]
    inner = sum(len(s.rstrip(" ")) - len(s.replace(" ", "")) for s in ("".join(CHARS[c] for c in row)
                                                                      for row in tok.tolist()))
    assert greedy or inner > 0  # pads inside strings, which the strings drop
    codes, lengths = (torch.from_numpy(a) for a in served.codes_of(strings, T))
    got = served.align(p, sizes, z, codes, lengths, seed, greedy, 1.0)
    assert torch.equal(got, tok)
    assert served.widest_gap(p, sizes, z, got, seed, greedy, 1.0, False) == 0.0


def test_a_gap_is_nought_for_the_best_also_where_the_noise_is_infinite():
    inf = float("inf")
    best, score = torch.tensor([inf, inf, 2.0, 2.0]), torch.tensor([inf, 1.0, 1.5, 2.0])
    assert served._gap(best, score).tolist() == [0.0, inf, 0.5, 0.0]


def test_batch_order_is_the_data_layer_s():
    from molvax_torch.data import BatchIterator
    from molvax_torch.data.charset import Charset
    from molvax_torch.data.zinc import Dataset

    codes = corpus.train_corpus(5, 40, 24, 37, 4, 20)
    it = BatchIterator(Dataset(codes, Charset()), 8, seed=11, device="cpu")
    got = np.concatenate([it.next_stack(3)[0].numpy(), it.next_stack(3)[0].numpy()])
    assert np.array_equal(got, codes[corpus.batch_order(11, 40, 8, 6)])


def test_corpus_rows_differ_and_sizes_follow_the_mix():
    a, b = corpus.train_corpus(1, 256, 120, 37, 8, 118), corpus.train_corpus(2, 256, 120, 37, 8, 118)
    assert len(np.unique(a, axis=0)) == 256
    assert sorted((a != 0).sum(1)) == sorted((b != 0).sum(1))
    assert not np.array_equal(a, b)
    assert np.array_equal(a, corpus.train_corpus(1, 256, 120, 37, 8, 118))


@pytest.mark.parametrize("name", list(bench_copy.TINY_CELLS))
def test_tiny_cell_is_correct_and_loads_no_jax(tiny, name):
    line = bench_copy.run_cell(tiny, name)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["forbidden"] == []


@pytest.mark.parametrize("name,number", [("tiny.train", "loss_gap"), ("tiny.train", "adam_m_median"),
                                         ("tiny.sample", "logit_gap"), ("tiny.sample_constrained", "logit_gap")])
def test_control_in_fp8_fails_the_check(tiny, name, number):
    """The reference in fp8, in the program's place, reads above the limit
    on every seed tried, and the program below it."""
    out = bench_copy.python(tiny, f"import sys; from perfbench.calibrate import main; "
                                  f"sys.exit(main(['--workload', {name!r}, '--seeds', '3,4,5', '--control-seeds', "
                                  f"'3,4,5', '--seconds', '0.5', '--device', 'cpu']))")
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    limit = bench_copy.TINY_LIMITS["train" if name.endswith("train") else "sample"][number]
    assert len(rows) == 3
    for r in rows:
        assert r["program"][number] < limit < r["control_fp8"][number], r
