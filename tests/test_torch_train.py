"""The training step in the port against molvax, on the CPU: losses,
schedules, the optimizer, EMA, six fp32 Adam steps against
``molvax.train.make_train_step``, and one step's gradients on the bf16
kernel route against a composition of the reference's kernels."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from molvax import train as jtrain
from molvax.config import Config as JConfig
from molvax.config import DataConfig as JData
from molvax.config import KLScheduleConfig as JKL
from molvax.config import ModelConfig as JModel
from molvax.config import TrainConfig as JTrain
from molvax.data import DEFAULT_CHARSET, synthetic_dataset
from molvax.data.featurize import one_hot as j_one_hot
from molvax.kernels.conv_enc import fused_encode as j_fused_encode
from molvax.kernels.gru_stack import gru_forward_wavefront as j_wavefront
from molvax.nn import init_vae_params
from molvax.nn.decoder import latent_embed as j_latent_embed
from molvax.nn.decoder import teacher_inputs as j_teacher_inputs
from molvax.nn.encoder import linear as j_linear
from molvax.train import loss as jloss
from molvax.train import schedules as jsched
from molvax_torch import config as tconfig
from molvax_torch.io.convert import state_dict_from_jax
from molvax_torch.kernels import conv_enc, gru_stack, sampler
from molvax_torch.nn.vae import forward
from molvax_torch.train import loop as tloop
from molvax_torch.train import loss as tloss
from molvax_torch.train import schedules as tsched
from molvax_torch.train import ema_eval_state, init_state, make_eval_step, make_train_step
from test_torch_support import normal, numpy_tree, paired

# fp32 on both sides: the repo's parity tolerance
FP32_TOL = 2e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=FP32_TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want), atol=tol, rtol=tol)


# -- losses and schedules ------------------------------------------------------


def _loss_inputs(B=6, T=9, C=37, L=8, seed=0):
    logits = 3.0 * normal((B, T, C), seed)
    codes = np.random.default_rng(seed + 1).integers(0, C, (B, T)).astype(np.int32)
    codes[:, -2:] = 0  # some pad
    mu = normal((B, L), seed + 2)
    logvar = 0.5 * normal((B, L), seed + 3)
    return logits, codes, mu, logvar


def test_loss_functions_match_reference():
    logits, codes, mu, logvar = _loss_inputs()
    _close(tloss.recon_ce(_t(logits), _t(codes)), jloss.recon_ce(jnp.asarray(logits), jnp.asarray(codes)))
    _close(tloss.recon_bce(_t(logits), _t(codes), 37), jloss.recon_bce(jnp.asarray(logits), jnp.asarray(codes), 37))
    _close(tloss.gaussian_kl(_t(mu), _t(logvar)), jloss.gaussian_kl(jnp.asarray(mu), jnp.asarray(logvar)))
    _close(tloss.gaussian_kl_per_dim(_t(mu), _t(logvar)),
           jloss.gaussian_kl_per_dim(jnp.asarray(mu), jnp.asarray(logvar)))
    for got, want in zip(tloss.recon_accuracy(_t(logits), _t(codes)),
                         jloss.recon_accuracy(jnp.asarray(logits), jnp.asarray(codes))):
        _close(got, want)


@pytest.mark.parametrize(
    "recon_loss,free_bits,with_kl,with_props",
    [("ce", 0.0, False, False), ("bce", 0.0, True, False), ("ce", 0.1, True, True), ("ce", 0.3, False, True)],
)
def test_vae_loss_and_metrics_match_reference(recon_loss, free_bits, with_kl, with_props):
    logits, codes, mu, logvar = _loss_inputs(seed=4)
    stats = dict(property_mean=(0.5, -1.0), property_std=(2.0, 0.25)) if with_props else {}
    kw = dict(recon_loss=recon_loss, eps_scale=0.3, n_properties=2 if with_props else 0, **stats)
    jcfg = JModel(latent_dim=8, **kw)
    tcfg = tconfig.ModelConfig(latent_dim=8, **kw)
    kl = np.asarray(jloss.gaussian_kl(jnp.asarray(mu), jnp.asarray(logvar))) if with_kl else None
    pp = normal((6, 2), 5) if with_props else None
    pt = normal((6, 2), 6) if with_props else None
    _, jm = jloss.vae_loss(
        jcfg, jnp.asarray(logits), jnp.asarray(codes), jnp.asarray(mu), jnp.asarray(logvar), jnp.float32(0.7),
        properties_pred=None if pp is None else jnp.asarray(pp), properties_true=None if pt is None else jnp.asarray(pt),
        property_loss_weight=0.5, kl=None if kl is None else jnp.asarray(kl), kl_free_bits=free_bits,
    )
    loss, tm = tloss.vae_loss(
        tcfg, _t(logits), _t(codes), _t(mu), _t(logvar), 0.7,
        properties_pred=None if pp is None else _t(pp), properties_true=None if pt is None else _t(pt),
        property_loss_weight=0.5, kl=None if kl is None else _t(kl), kl_free_bits=free_bits,
    )
    assert sorted(tm) == sorted(jm)
    for k in jm:
        _close(tm[k], jm[k], 1e-5 if k == "post_std_batch" else FP32_TOL)
    _close(loss, jm["loss"])


def test_schedules_match_reference():
    kls = [JKL(kind="constant", beta_max=0.5), JKL(kind="linear", warmup_steps=7, beta_max=2.0),
           JKL(kind="cyclical", cycle_steps=10, ratio=0.3), JKL(kind="cyclical", cycle_steps=8000, ratio=0.5)]
    for jk in kls:
        tk = tconfig.KLScheduleConfig(**dataclasses.asdict(jk))
        for step in (0, 1, 3, 7, 9, 10, 13, 4000, 8001):
            assert tsched.beta_at(tk, step) == pytest.approx(float(jsched.beta_at(jk, step)), rel=1e-6, abs=1e-7)
    jt = JTrain(scheduled_sampling=0.25, scheduled_sampling_warmup=50)
    tt = tconfig.TrainConfig(scheduled_sampling=0.25, scheduled_sampling_warmup=50)
    for step in (0, 1, 25, 50, 70):
        assert tsched.ss_prob_at(tt, step) == pytest.approx(float(jsched.ss_prob_at(jt, step)), rel=1e-6, abs=1e-7)


# -- optimizer -----------------------------------------------------------------


def test_lr_schedules_match_optax():
    cos = optax.cosine_decay_schedule(1e-3, 100, alpha=0.1)
    wc = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 10, 100, 1e-4)
    t_cos = tloop.cosine_decay_schedule(1e-3, 100, alpha=0.1)
    t_wc = tloop.warmup_cosine_decay_schedule(0.0, 1e-3, 10, 100, 1e-4)
    for count in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        assert t_cos(count) == pytest.approx(float(cos(count)), rel=1e-6, abs=1e-12)
        assert t_wc(count) == pytest.approx(float(wc(count)), rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    grads = [normal((3, 4), 1), normal((5,), 2)]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    got = [_t(g).clone() for g in grads]
    tloop.clip_by_global_norm_(got, max_norm)
    for a, b in zip(got, want):
        _close(a, b, 1e-6)


@pytest.mark.parametrize("schedule,clip", [("constant", None), ("warmup_cosine", 0.05), ("cosine", 1.0)])
def test_optimizer_matches_optax(schedule, clip):
    """Three updates of the port's Adam (+ schedule, + clip) against the
    reference's make_optimizer on the same parameters and gradients."""
    kw = dict(learning_rate=1e-2, lr_schedule=schedule, lr_warmup_steps=2, lr_decay_steps=5, grad_clip_norm=clip)
    jcfg, tcfg = JConfig(train=JTrain(**kw)), tconfig.Config(train=tconfig.TrainConfig(**kw))
    params = [normal((4, 3), 10), normal((6,), 11)]
    tx = jtrain.loop.make_optimizer(jcfg)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(_t(p).clone()) for p in params]
    opt = tloop.Optimizer(tp, tcfg.train)
    for i in range(3):
        grads = [normal(p.shape, 20 + 3 * i + k) for k, p in enumerate(params)]
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        for p, g in zip(tp, grads):
            p.grad = _t(g).clone()
        opt.step()
    for a, b in zip(tp, jp):
        _close(a, b, 1e-6)


def test_ema_update_and_eval_state():
    cfg = tconfig.Config(
        model=tconfig.ModelConfig(max_len=12, latent_dim=8, conv_kernels=(3, 3, 3), enc_hidden=8,
                                  gru_hidden=8, gru_layers=2),
        train=tconfig.TrainConfig(ema_decay=0.75, learning_rate=1e-2),
    )
    state = init_state(cfg, seed=3)
    before = {k: v.detach().clone() for k, v in state.params.named_parameters()}
    codes = torch.from_numpy(np.random.default_rng(0).integers(0, 37, (4, 12)))
    state, _ = make_train_step(cfg)(state, codes)
    assert state.step == 1
    for name, p in state.params.named_parameters():
        want = 0.75 * before[name] + 0.25 * p.detach()
        torch.testing.assert_close(state.ema_params[name], want, atol=1e-7, rtol=1e-6)
    ev = ema_eval_state(state)
    assert ev.ema_params is None and ev.params is not state.params
    for name, p in ev.params.named_parameters():
        assert torch.equal(p.detach(), state.ema_params[name])
    assert ema_eval_state(ev) is ev


def test_init_state_is_seeded_and_device_independent():
    cfg = tconfig.Config(model=tconfig.ModelConfig(max_len=12, latent_dim=8, conv_kernels=(3, 3, 3),
                                                   enc_hidden=8, gru_hidden=8, gru_layers=2))
    a, b, c = init_state(cfg, seed=1), init_state(cfg, seed=1), init_state(cfg, seed=2)
    for (n, p), q, r in zip(a.params.named_parameters(), b.params.parameters(), c.params.parameters()):
        assert torch.equal(p, q), n
        assert n == "start_token" or not torch.equal(p, r), n
    assert a.base_seed == b.base_seed != c.base_seed
    assert a.step == 0 and a.ema_params is None


# -- the slice as a whole ------------------------------------------------------

STEPS = 6
BATCH = 16


def _parity_cfgs(**model_kw):
    model = dict(max_len=40, charset_size=DEFAULT_CHARSET.size, latent_dim=16, conv_kernels=(9, 9, 11),
                 enc_hidden=24, gru_hidden=20, gru_layers=2, eps_scale=0.0, learned_start=True, **model_kw)
    train = dict(batch_size=BATCH, learning_rate=1e-3)
    kl = dict(kind="constant", beta_max=1.0)
    jcfg = JConfig(model=JModel(**model), train=JTrain(kl=JKL(**kl), **train), data=JData(max_len=40))
    tcfg = tconfig.Config(model=tconfig.ModelConfig(**model),
                          train=tconfig.TrainConfig(kl=tconfig.KLScheduleConfig(**kl), **train),
                          data=tconfig.DataConfig(max_len=40))
    return jcfg, tcfg


def test_six_fp32_adam_steps_track_reference():
    """The slice as a whole, fp32: identical weights and batches,
    eps_scale = 0 (z = mu), six steps of each package's make_train_step.
    Tolerances of tests/parity/test_train_parity.py: step-0 loss rel 2e-4,
    every loss rel 1e-2; the final weights within 1e-2 of the largest
    weight of their tensor (six Adam steps at lr 1e-3 move a weight by at
    most 6e-3; the measured gap is far below)."""
    track_reference_six_steps(*_parity_cfgs())


def track_reference_six_steps(jcfg, tcfg):
    """Six steps of each package's make_train_step from identical weights
    and batches, held to the tolerances above."""
    params = init_vae_params(jax.random.key(0), jcfg.model)
    params["decoder"]["start_token"] = jnp.asarray(normal((DEFAULT_CHARSET.size,), 1))
    ds = synthetic_dataset(BATCH * STEPS, max_len=40, seed=0)
    batches = [ds.codes[i * BATCH:(i + 1) * BATCH] for i in range(STEPS)]
    # before the reference's step, which donates (deletes) its input state
    tstate = init_state(tcfg, weights=state_dict_from_jax(numpy_tree(params)))

    jstate = jtrain.init_state(jcfg)
    jstate = jstate._replace(params=params, opt_state=jtrain.loop.make_optimizer(jcfg).init(params))
    jstep = jtrain.make_train_step(jcfg)
    j_losses = []
    for b in batches:
        jstate, m = jstep(jstate, jnp.asarray(b), None)
        j_losses.append(float(m["loss"]))

    tstep = make_train_step(tcfg)
    t_losses = []
    for b in batches:
        tstate, m = tstep(tstate, torch.from_numpy(b), None)
        t_losses.append(float(m["loss"]))

    assert t_losses[0] == pytest.approx(j_losses[0], rel=2e-4)
    for j, t in zip(j_losses, t_losses):
        assert t == pytest.approx(j, rel=1e-2), (j_losses, t_losses)
    assert t_losses[-1] < t_losses[0]
    final = state_dict_from_jax(numpy_tree(jstate.params))
    for name, p in tstate.params.state_dict().items():
        ref = final[name]
        gap = (p - ref).abs().max().item()
        assert gap <= 1e-2 * max(ref.abs().max().item(), 1e-2), (name, gap)


def _slice_grads_jax(params, jcfg, codes, beta):
    """One step's loss on the reference's kernel route, composed by hand:
    fused_encode -> z = mu -> latent_embed -> teacher_inputs ->
    gru_stack_scan (interpret) -> linear_out -> vae_loss."""

    def loss_fn(p):
        mu, logvar = j_fused_encode(p["encoder"], jcfg, codes)
        dec = p["decoder"]
        z_emb = j_latent_embed(dec, jcfg, mu)
        x_seq = j_teacher_inputs(jcfg, z_emb, j_one_hot(codes, jcfg.charset_size), dec["start_token"])
        out, _ = j_wavefront(dec["gru"], x_seq)
        logits = j_linear(dec["linear_out"], out, jnp.bfloat16)
        return jloss.vae_loss(jcfg, logits, codes.astype(jnp.int32), mu, logvar, beta)[0]

    return jax.value_and_grad(loss_fn)(params)


def test_bf16_kernel_route_gradients_match_reference_composition():
    """The slice as a whole on the bf16 kernel route: the port's train-step
    loss and gradients on the CPU (the kernels' plain versions) against the
    reference's kernels composed by hand, at max_len 12, conv kernels
    (3, 3, 3), H = 130, eps_scale = 0."""
    jcfg, tcfg, params, model = paired(
        max_len=12, conv_kernels=(3, 3, 3), latent_dim=16, enc_hidden=24, gru_hidden=130,
        gru_layers=3, compute_dtype="bfloat16", use_pallas=True, learned_start=True, eps_scale=0.0,
    )
    codes = synthetic_dataset(16, max_len=12, seed=3).codes  # the reference plan needs B % 16 == 0
    loss_j, grads_j = _slice_grads_jax(params, jcfg, jnp.asarray(codes), jnp.float32(0.5))

    counts = (conv_enc.launches, sampler.launches, gru_stack.fwd_launches, gru_stack.bwd_launches)
    out = forward(model, tcfg, 0, torch.from_numpy(codes))
    loss_t, _ = tloss.vae_loss(tcfg, out.logits, torch.from_numpy(codes).long(), out.mu, out.logvar, 0.5, kl=out.kl)
    names = [n for n, _ in model.named_parameters()]
    grads_t = dict(zip(names, torch.autograd.grad(loss_t, list(model.parameters()))))
    assert counts == (conv_enc.launches, sampler.launches, gru_stack.fwd_launches, gru_stack.bwd_launches)

    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    want = state_dict_from_jax(numpy_tree(grads_j))
    report = {}
    for name in names:
        got, ref = grads_t[name], want[name]
        report[name] = ((got - ref).norm() / ref.norm()).item()
    tol = {n: (SLICE_CONV_TOL if n.startswith("conv_") else SLICE_TOL) for n in names}
    bad = {n: r for n, r in report.items() if not r <= tol[n]}
    assert not bad, (bad, report)


# relative norm of each gradient on the bf16 route (measured <= 2.5e-4
# outside the convs): the same rounding points, fp32 sums in another order,
# where a sum next to a bf16 rounding boundary can round one step (2**-8)
# the other way; and the conv gradients (measured <= 4.9e-3), whose patch
# cotangents JAX sums in bf16 (see test_torch_encode_kernel.py)
SLICE_TOL = 2e-3
SLICE_CONV_TOL = 2e-2


def test_eval_step_and_kernel_route_step_run_on_cpu():
    """make_eval_step reads the fixed eval seed; on the bf16 kernel route
    (plain versions on the CPU) a train step moves the weights and keeps
    the loss finite."""
    cfg = tconfig.Config(
        model=tconfig.ModelConfig(max_len=12, latent_dim=8, conv_kernels=(3, 3, 3), enc_hidden=8,
                                  gru_hidden=16, gru_layers=3, compute_dtype="bfloat16", use_pallas=True,
                                  learned_start=True),
        train=tconfig.TrainConfig(kl=tconfig.KLScheduleConfig(kind="cyclical", cycle_steps=4)),
    )
    state = init_state(cfg, seed=5)
    codes = torch.from_numpy(np.random.default_rng(1).integers(0, 37, (4, 12)))
    ev = make_eval_step(cfg)
    m0 = ev(state, codes)
    assert float(m0["loss"]) == float(ev(state, codes)["loss"])
    w0 = state.params.gru.weight_hh_l2.detach().clone()
    state, m = make_train_step(cfg)(state, codes)
    assert np.isfinite(float(m["loss"])) and float(m["beta"]) == 0.0
    assert not torch.equal(w0, state.params.gru.weight_hh_l2)
