"""The chunked trainer (``make_train_chunk``) and the step body it shares
with the eager step, on the CPU. Mirrors tests/unit/test_train_chunk.py.

A step reads its seed, beta, scheduled-sampling probability and learning
rate as 0-d tensors from one (4, K) vector computed on the host
(``schedule_vectors``), so a CUDA Graph of K steps can replay with new
values; on the CPU the chunk is K eager steps through the same body. The
graph itself runs only on a card (``chip_smoke.py`` phase 22 holds a
replay to 16 eager steps there)."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from molvax import train as jtrain
from molvax.data import synthetic_dataset
from molvax.train.loop import make_train_chunk as j_make_train_chunk
from molvax_torch import config as tconfig
from molvax_torch.io.convert import state_dict_from_jax
from molvax_torch.kernels.generate import fold_in, fold_in_range
from molvax_torch.nn import property_head
from molvax_torch.train import init_state, make_train_chunk, make_train_step
from molvax_torch.train import loop as tloop
from molvax_torch.train.schedules import beta_at, ss_prob_at
from test_torch_support import numpy_tree
from test_torch_train import BATCH, _parity_cfgs
from test_torch_train_sync import _no_device_copies

SMALL = dict(max_len=20, charset_size=37, latent_dim=16, conv_kernels=(5, 5, 5), enc_hidden=16, gru_hidden=24,
             gru_layers=3, learned_start=True)


def _cfg(kind: str) -> tconfig.Config:
    """Small configs shaped as the trainers: 'zinc250k' (bf16 kernels, the
    stack route), 'quality' (bf16 per-layer route, scheduled sampling,
    free bits, small eps), 'fp32' (strict fp32, the plain sampler) and
    'props' (bf16 with the property head, EMA and word dropout)."""
    kl = tconfig.KLScheduleConfig(kind="cyclical", cycle_steps=4, ratio=0.5)
    train = dict(batch_size=4, kl=kl, learning_rate=1e-2, lr_schedule="warmup_cosine", lr_warmup_steps=2,
                 lr_decay_steps=12, grad_clip_norm=1.0)
    model = dict(SMALL, compute_dtype="bfloat16", use_pallas=True)
    if kind == "quality":
        model.update(eps_scale=0.02, gru_kernel="per_layer")
        train.update(kl=dataclasses.replace(kl, free_bits=0.1), scheduled_sampling=0.25,
                     scheduled_sampling_warmup=3)
    elif kind == "fp32":
        model.update(compute_dtype="float32")
    elif kind == "props":
        model.update(n_properties=3, property_mean=(2.5, 0.6, 3.0), property_std=(1.5, 0.2, 0.9))
        train.update(ema_decay=0.9, word_dropout=0.1, property_loss_weight=0.5)
    return tconfig.Config(name=kind, model=tconfig.ModelConfig(**model), train=tconfig.TrainConfig(**train))


def _stack(cfg, k: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.integers(0, cfg.model.charset_size, (k, 4, cfg.model.max_len)).astype(np.uint8))
    props = None
    if cfg.model.n_properties:
        props = torch.from_numpy(rng.standard_normal((k, 4, cfg.model.n_properties)).astype(np.float32))
    return codes, props


def _assert_states_equal(a, b):
    """Weights, Adam moments and step counts, EMA: bit for bit."""
    for (name, p), q in zip(a.params.named_parameters(), b.params.parameters()):
        assert torch.equal(p, q), name
        sa, sb = a.opt_state.adam.state[p], b.opt_state.adam.state[q]
        assert sorted(sa) == sorted(sb)
        for key in sa:
            assert torch.equal(sa[key], sb[key]), (name, key)
    assert (a.ema_params is None) == (b.ema_params is None)
    for name in a.ema_params or {}:
        assert torch.equal(a.ema_params[name], b.ema_params[name]), name
    assert a.step == b.step and a.opt_state.count == b.opt_state.count


# -- the step body -------------------------------------------------------------


@pytest.mark.parametrize("kind", ["zinc250k", "quality", "props"])
def test_step_body_fed_device_values_equals_the_step_fed_python_scalars(kind):
    """make_train_step (the body fed 0-d tensors of the packed vector)
    against the body fed the host schedules' Python numbers, bit for bit,
    over steps that cross a KL cycle and the scheduled-sampling warm-up."""
    cfg = _cfg(kind)
    a = init_state(cfg, seed=1, device="cpu")
    b = copy.deepcopy(a)
    codes, props = _stack(cfg, 6)
    step = make_train_step(cfg)
    lr = tloop.learning_rate_schedule(cfg.train)
    for i in range(6):
        a, m_a = step(a, codes[i], None if props is None else props[i])
        m_b = tloop.step_body(cfg, b, codes[i], None if props is None else props[i],
                              fold_in(b.base_seed, b.step), beta_at(cfg.train.kl, b.step),
                              ss_prob_at(cfg.train, b.step), lr(b.opt_state.count))
        b.opt_state.count += 1
        b = b._replace(step=b.step + 1)
        assert sorted(m_a) == sorted(m_b)
        for k in m_a:
            assert torch.equal(m_a[k], m_b[k]), (i, k)
        _assert_states_equal(a, b)


def test_schedule_vectors_equal_the_host_schedules():
    """Seeds fold_in(base, step), beta_at, ss_prob_at and the learning rate
    of update count + i, over steps that cross a KL cycle edge, the
    scheduled-sampling warm-up end and the lr warm-up end; the float rows
    are the fp32 of the host's double."""
    cfg = _cfg("quality")
    lr = tloop.learning_rate_schedule(cfg.train)
    base, step, count, k = 0x9E3779B9, 2, 1, 9
    packed = tloop.schedule_vectors(cfg, base, step, count, k)
    assert packed.shape == (4, k) and packed.dtype == np.int32
    seeds, beta, ss, lrs = (t.numpy() for t in tloop.unpack(torch.from_numpy(packed)))
    assert seeds.dtype == np.int32 and beta.dtype == ss.dtype == lrs.dtype == np.float32
    for i in range(k):
        assert int(seeds[i]) & 0xFFFFFFFF == fold_in(base, step + i)
        assert beta[i] == np.float32(beta_at(cfg.train.kl, step + i))
        assert ss[i] == np.float32(ss_prob_at(cfg.train, step + i))
        assert lrs[i] == np.float32(lr(count + i))
    assert beta.min() == 0.0 and beta.max() == 1.0  # the cycle's edge
    assert ss[0] < ss[-1] == np.float32(0.25)  # past the warm-up
    assert (tloop.schedule_vectors(_cfg("zinc250k"), base, step, count, k)[2] == 0).all()  # no scheduled sampling
    # fold_in_range against the hash written out in Python ints, across 2**32
    m = 0xFFFFFFFF

    def mix32(x):
        x ^= x >> 16
        x = (x * 0x7FEB352D) & m
        x ^= x >> 15
        x = (x * 0x846CA68B) & m
        return x ^ (x >> 16)

    want = [mix32((mix32(base) + ((2**32 - 2 + i) & m)) & m) for i in range(4)]
    np.testing.assert_array_equal(fold_in_range(base, 2**32 - 2, 4), want)
    assert [fold_in(base, 2**32 - 2 + i) for i in range(4)] == want


def test_learning_rates_are_optax_schedules():
    cfg = _cfg("zinc250k")
    want = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 12, 1e-3)
    _, _, _, lrs = tloop.unpack(torch.from_numpy(tloop.schedule_vectors(cfg, 0, 0, 0, 16)))
    np.testing.assert_allclose(lrs.numpy(), [float(want(c)) for c in range(16)], rtol=1e-6, atol=1e-12)


# -- the chunk -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["zinc250k", "quality", "fp32", "props"])
@pytest.mark.parametrize("k", [1, 4])
def test_chunk_equals_k_eager_steps(kind, k):
    """K chunked steps against K eager steps: weights, Adam moments, EMA
    and the stacked metrics bit for bit; state.step advanced by K."""
    cfg = _cfg(kind)
    a = init_state(cfg, seed=2, device="cpu")
    a = a._replace(step=3)  # mid-run: the cycle and warm-ups continue from step 3
    a.opt_state.count = 3
    b = copy.deepcopy(a)
    codes, props = _stack(cfg, 2 * k, seed=5)
    step, chunk = make_train_step(cfg), make_train_chunk(cfg, k, device="cpu")
    for c in range(2):
        per_step = []
        for i in range(c * k, (c + 1) * k):
            a, m = step(a, codes[i], None if props is None else props[i])
            per_step.append(m)
        b, stacked = chunk(b, codes[c * k:(c + 1) * k], None if props is None else props[c * k:(c + 1) * k])
        assert sorted(stacked) == sorted(per_step[0])
        for name, v in stacked.items():
            assert v.shape == (k,)
            assert torch.equal(v, torch.stack([m[name] for m in per_step])), name
        _assert_states_equal(a, b)
    assert b.step == 3 + 2 * k and b.opt_state.count == 3 + 2 * k
    assert ("prop_mse" in stacked) == (kind == "props")


def test_fp32_chunk_tracks_the_reference_chunk():
    """A small strict-fp32 chunk of 6 steps against molvax's
    make_train_chunk (a lax.scan of the step) on identical weights and
    batches, eps_scale = 0: every step's loss within 2e-4 relative (the
    repo's fp32 parity tolerance), the final weights within 1e-2 of the
    largest weight of their tensor, as the eager six-step test."""
    jcfg, tcfg = _parity_cfgs()
    k = 6
    params = jtrain.init_state(jcfg).params
    ds = synthetic_dataset(BATCH * k, max_len=40, seed=0)
    stack = ds.codes.reshape(k, BATCH, 40)
    tstate = init_state(tcfg, device="cpu", weights=state_dict_from_jax(numpy_tree(params)))
    jstate = jtrain.init_state(jcfg)
    jstate = jstate._replace(params=params, opt_state=jtrain.loop.make_optimizer(jcfg).init(params))
    jstate, jm = j_make_train_chunk(jcfg, k)(jstate, jnp.asarray(stack), None)
    tstate, tm = make_train_chunk(tcfg, k, device="cpu")(tstate, torch.from_numpy(stack))
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]), rtol=2e-4)
    np.testing.assert_allclose(tm["kl"].numpy(), np.asarray(jm["kl"]), rtol=2e-4, atol=2e-4)
    assert tstate.step == int(jax.device_get(jstate.step)) == k
    final = state_dict_from_jax(numpy_tree(jstate.params))
    for name, p in tstate.params.state_dict().items():
        gap = (p - final[name]).abs().max().item()
        assert gap <= 1e-2 * max(final[name].abs().max().item(), 1e-2), (name, gap)


def test_chunk_refuses_on_the_card_what_it_cannot_capture():
    """Every sampler path reads its seed on the device (the plain path
    draws the fused sampler's eps), so strict fp32 and
    ``use_pallas`` off no longer raise a graph reason: on the card they
    are captured like any other configuration, and on this CPU-only host
    asking for the card raises "CUDA is not available" instead. A bad K
    still raises."""
    plain = dataclasses.replace(_cfg("zinc250k"), model=dataclasses.replace(_cfg("zinc250k").model, use_pallas=False))
    assert not hasattr(tloop, "host_seed_reason")
    for cfg in (_cfg("fp32"), plain, _cfg("zinc250k"), _cfg("quality")):
        make_train_chunk(cfg, 4, device="cpu")
        if not torch.cuda.is_available():
            for dev in ("cuda", torch.device("cuda", 0), None):
                with pytest.raises(RuntimeError, match="CUDA is not available"):
                    make_train_chunk(cfg, 4, device=dev)
    with pytest.raises(ValueError, match="chunk must be"):
        make_train_chunk(_cfg("zinc250k"), 0, device="cpu")


@pytest.mark.parametrize("seed_kind", ["int", "tensor"])
def test_plain_sampler_path_draws_the_fused_samplers_eps(seed_kind):
    """The plain path (strict fp32, or ``use_pallas`` off) forms
    z = mu + eps_scale * exp(logvar / 2) * sample_eps(seed), for an int
    seed and for a 0-d int32 tensor seed alike; at eps_scale = 1 that is
    ``fused_sample_kl_ref``'s z bit for bit."""
    from molvax_torch.kernels import sampler
    from molvax_torch.nn import vae

    seed_int = 0x9E3779B9
    seed = seed_int if seed_kind == "int" else torch.tensor(seed_int, dtype=torch.int64).to(torch.int32)
    for eps_scale in (0.02, 1.0):
        cfg = _cfg("fp32")
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, eps_scale=eps_scale))
        state = init_state(cfg, seed=3, device="cpu")
        codes, _ = _stack(cfg, 1)
        with torch.no_grad():
            out = vae.forward(state.params, cfg.model, seed, codes[0])
            mu, logvar = vae.encode(state.params, cfg.model, codes[0])
        assert torch.equal(out.mu, mu) and torch.equal(out.logvar, logvar) and out.kl is None
        eps = sampler.sample_eps(seed_int, mu.shape[0], mu.shape[1], mu.device)
        assert torch.equal(out.z, mu + eps_scale * torch.exp(0.5 * logvar) * eps)
        if eps_scale == 1.0:
            z_ref, _ = sampler.fused_sample_kl_ref(seed, mu, logvar, 1.0)
            assert torch.equal(out.z, z_ref)


def test_strict_conv_backward_is_deterministic_without_tf32(monkeypatch):
    """A strict-fp32 conv of the plain encoder runs its forward with TF32
    off, and its backward under flags of its own (autograd runs it after
    the forward's are gone): the input gradient on cuDNN's deterministic
    algorithms with TF32 off, the weight gradient as one fp32 GEMM over
    (batch, position). Values equal ``F.conv1d``'s, gradients within fp32
    summation order (2e-6 of their largest entry), the same bits on every
    run; the flags are restored after."""
    from molvax_torch.nn import encoder

    calls = []
    real = encoder._strict_flags

    def flags(deterministic):
        calls.append((torch.is_grad_enabled(), deterministic))
        return real(deterministic)

    monkeypatch.setattr(encoder, "_strict_flags", flags)
    before = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 5, 19, generator=g, requires_grad=True)
    w = torch.randn(3, 5, 4, generator=g, requires_grad=True)
    b = torch.randn(3, generator=g, requires_grad=True)
    out = encoder.conv1d(x, w, b, torch.float32)
    want = torch.nn.functional.conv1d(x, w) + b[None, :, None]
    assert torch.equal(out, want)
    grads = torch.autograd.grad(out.square().sum(), (x, w, b))
    for got, ref in zip(grads, torch.autograd.grad(want.square().sum(), (x, w, b))):
        assert got.shape == ref.shape
        assert (got - ref).abs().max().item() <= 2e-6 * ref.abs().max().item()
    again = torch.autograd.grad(encoder.conv1d(x, w, b, torch.float32).square().sum(), (x, w, b))
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
    assert calls[:2] == [(False, before[0]), (False, True)]
    calls.clear()
    xs = x.detach()  # the one-hot input of the first conv: no input gradient, no transposed conv
    (gw,) = torch.autograd.grad(encoder.conv1d(xs, w, b, torch.float32).sum(), (w,))
    assert calls == [(False, before[0])] and gw.shape == w.shape
    encoder.conv1d(x, w, b, torch.bfloat16)  # bf16 operands are exact in TF32: cuDNN's own flags
    assert len(calls) == 1
    with real(True):
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32) == before


def test_chunk_checks_its_inputs():
    cfg = _cfg("props")
    state = init_state(cfg, seed=0, device="cpu")
    codes, props = _stack(cfg, 4)
    chunk = make_train_chunk(cfg, 4, device="cpu")
    with pytest.raises(ValueError, match=r"is not \(4, B, T\)"):
        chunk(state, codes[:3], props[:3])
    with pytest.raises(ValueError, match=r"is not \(4, B, P\)"):
        chunk(state, codes, props[0])
    assert state.step == 0


@pytest.mark.parametrize("kind", ["zinc250k", "quality", "props"])
def test_chunk_body_makes_no_tensor_from_host_data(monkeypatch, kind):
    """Under the patch of test_torch_train_sync.py (torch.tensor /
    torch.as_tensor naming a device raise), after one chunk has made the
    property stats: a chunk's steps make no tensor from host data, which
    on a card would be a blocking copy and inside capture an error."""
    cfg = _cfg(kind)
    state = init_state(cfg, seed=0, device="cpu")
    codes, props = _stack(cfg, 2)
    chunk = make_train_chunk(cfg, 2, device="cpu")
    state, _ = chunk(state, codes, props)
    made = property_head._stats.cache_info().misses
    _no_device_copies(monkeypatch)
    state, metrics = chunk(state, codes, props)
    assert property_head._stats.cache_info().misses == made
    assert all(torch.isfinite(v).all() for v in metrics.values()) and state.step == 4


def test_encoder_backward_runs_on_deterministic_cudnn(monkeypatch):
    """The fused encoder's backward (autograd of the plain encoder) asks
    cuDNN for deterministic algorithms, and leaves the flags as they were:
    cuDNN's default conv weight gradient sums in a varying order, and a
    chunk is held to its eager steps bit for bit on the card."""
    from molvax_torch.kernels import conv_enc
    from molvax_torch.nn import encoder

    seen = []
    real = encoder.F.conv1d

    def conv1d(*args, **kw):
        seen.append((torch.is_grad_enabled(), torch.backends.cudnn.deterministic, torch.backends.cudnn.enabled))
        return real(*args, **kw)

    monkeypatch.setattr(encoder.F, "conv1d", conv1d)
    cfg = _cfg("zinc250k")
    state = init_state(cfg, seed=0, device="cpu")
    codes, _ = _stack(cfg, 1)
    before = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32)
    mu, logvar = conv_enc.fused_encode(state.params, cfg.model, codes[0])
    n_fwd = len(seen)
    (mu.sum() + logvar.sum()).backward()
    assert n_fwd == 3 and len(seen) == 6
    assert all(det and on for grad, det, on in seen[n_fwd:]) and all(grad for grad, _, _ in seen[n_fwd:])
    assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.backends.cudnn.allow_tf32) == before


def test_a_replay_advances_the_versions_of_what_it_writes():
    """A CUDA Graph replay updates the weights, Adam state, learning rate
    and EMA in place without the version-counter bumps of the eager ops
    (only capture made those): ``CapturedChunk.replay`` advances them, so
    the persistent decode's packed weights (keyed by each weight's version)
    are rebuilt after a chunk. The graph and the pinned copy are stood in
    for here: the card is needed for the real ones."""
    from types import SimpleNamespace

    cfg = _cfg("props")
    state = init_state(cfg, seed=0, device="cpu")
    codes, props = _stack(cfg, 2)
    captured = tloop.CapturedChunk.__new__(tloop.CapturedChunk)
    captured.codes, captured.props = codes.clone(), props.clone()
    captured.values = torch.empty((4, 2), dtype=torch.int32)
    captured.staging = SimpleNamespace(copy=lambda shape, dtype, fill, out: fill(out.numpy()) or out)
    replays = []
    captured.graph = SimpleNamespace(replay=lambda: replays.append(1))
    captured.metrics = {"loss": torch.zeros(2)}
    captured.written = tloop._state_tensors(state)
    tensors = tloop._state_tensors(state)
    assert {id(p) for p in state.params.parameters()} <= {id(t) for t in tensors}
    assert all(id(e) in {id(t) for t in tensors} for e in state.ema_params.values())
    before = [t._version for t in tensors]
    values = tloop.schedule_vectors(cfg, state.base_seed, 0, 0, 2)
    assert captured.replay(codes, props, values) is captured.metrics and replays == [1]
    assert all(t._version > v for t, v in zip(tensors, before))
    assert torch.equal(captured.values, torch.from_numpy(values))


def test_a_captured_chunk_is_bound_to_where_the_state_lies():
    """The graph reads and writes the state's tensors in place: its key
    holds their addresses, so a step (in place) keeps it and a state whose
    weights, Adam state or EMA moved gets a new capture."""
    cfg = _cfg("props")
    state = init_state(cfg, seed=0, device="cpu")
    codes, props = _stack(cfg, 2)
    step = make_train_step(cfg)
    state, _ = step(state, codes[0], props[0])
    key = tloop._chunk_key(state, codes, props)
    state, _ = step(state, codes[1], props[1])
    assert tloop._chunk_key(state, codes, props) == key
    assert tloop._chunk_key(state, codes[:, :3], props[:, :3]) != key
    assert tloop._chunk_key(state, codes, None) != key
    moved = copy.deepcopy(state)
    assert tloop._chunk_key(moved, codes, props) != key
    name = next(iter(state.ema_params))
    state.ema_params[name] = state.ema_params[name].clone()
    assert tloop._chunk_key(state, codes, props) != key
