"""The training step on the per-layer GRU route against molvax, on the CPU:
one bf16 step shaped like ``zinc250k_quality`` (``gru_kernel='per_layer'``)
against the reference's kernels composed by hand, six strict-fp32 Adam
steps on the per-layer fp32 route against ``molvax.train.make_train_step``,
and the ``zinc250k_quality`` step with scheduled sampling on."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molvax.data import synthetic_dataset
from molvax.data.featurize import one_hot as j_one_hot
from molvax.kernels.conv_enc import fused_encode as j_fused_encode
from molvax.kernels.gru import gru_forward_pallas as j_gru_forward_pallas
from molvax.nn.decoder import latent_embed as j_latent_embed
from molvax.nn.decoder import teacher_inputs as j_teacher_inputs
from molvax.nn.encoder import linear as j_linear
from molvax.train import loss as jloss
from molvax_torch import config as tconfig
from molvax_torch.io.convert import state_dict_from_jax
from molvax_torch.kernels import conv_enc, gru, gru_stack, sampler
from molvax_torch.nn.vae import forward
from molvax_torch.train import init_state, make_train_step
from molvax_torch.train import loss as tloss
from test_torch_support import numpy_tree, paired
from test_torch_train import SLICE_CONV_TOL, SLICE_TOL, _parity_cfgs, track_reference_six_steps

FREE_BITS = 0.1  # zinc250k_quality's


def _launches():
    return (conv_enc.launches, sampler.launches, gru_stack.rec_launches, gru_stack.sweep_launches,
            gru.layer_fwd_launches, gru.layer_bwd_launches, gru.layer_dw_launches)


def _per_layer_grads_jax(params, jcfg, codes, beta):
    """One step's loss on the reference's per-layer kernel route, composed
    by hand: fused_encode -> z = mu -> latent_embed -> teacher_inputs ->
    gru_forward_pallas(kernel='per_layer'), i.e. gru_layer_scan_x per layer
    (interpret) -> linear_out -> vae_loss with free bits."""

    def loss_fn(p):
        mu, logvar = j_fused_encode(p["encoder"], jcfg, codes)
        dec = p["decoder"]
        z_emb = j_latent_embed(dec, jcfg, mu)
        x_seq = j_teacher_inputs(jcfg, z_emb, j_one_hot(codes, jcfg.charset_size), dec["start_token"])
        out, _ = j_gru_forward_pallas(dec["gru"], x_seq, compute_dtype=jnp.bfloat16, kernel="per_layer")
        logits = j_linear(dec["linear_out"], out, jnp.bfloat16)
        return jloss.vae_loss(jcfg, logits, codes.astype(jnp.int32), mu, logvar, beta,
                              kl_free_bits=FREE_BITS)[0]

    return jax.value_and_grad(loss_fn)(params)


def test_quality_shaped_bf16_step_matches_reference_composition():
    """The slice on the bf16 per-layer route: the port's loss and every
    gradient on the CPU (the kernels' plain versions) against the
    reference's kernels composed by hand, at max_len 12, conv kernels
    (3, 3, 3), H = 130, 3 layers, free bits 0.1, eps_scale = 0."""
    jcfg, tcfg, params, model = paired(
        max_len=12, conv_kernels=(3, 3, 3), latent_dim=16, enc_hidden=24, gru_hidden=130,
        gru_layers=3, compute_dtype="bfloat16", use_pallas=True, learned_start=True, eps_scale=0.0,
        gru_kernel="per_layer",
    )
    codes = synthetic_dataset(16, max_len=12, seed=4).codes
    loss_j, grads_j = _per_layer_grads_jax(params, jcfg, jnp.asarray(codes), jnp.float32(0.5))

    before = _launches()
    out = forward(model, tcfg, 0, torch.from_numpy(codes))
    loss_t, _ = tloss.vae_loss(tcfg, out.logits, torch.from_numpy(codes).long(), out.mu, out.logvar, 0.5,
                               kl=out.kl, kl_free_bits=FREE_BITS)
    names = [n for n, _ in model.named_parameters()]
    grads_t = dict(zip(names, torch.autograd.grad(loss_t, list(model.parameters()))))
    assert _launches() == before  # plain versions on the CPU

    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    want = state_dict_from_jax(numpy_tree(grads_j))
    # free bits floor every dim's KL at this init and eps_scale is 0, so the
    # logvar head gets no gradient on either side: compare it exactly
    report = {n: ((grads_t[n] - want[n]).norm() / want[n].norm()).item() if want[n].norm() > 0
              else grads_t[n].norm().item() for n in names}
    bad = {n: r for n, r in report.items() if not r <= (SLICE_CONV_TOL if n.startswith("conv_") else SLICE_TOL)}
    assert not bad, (bad, report)


def test_six_strict_fp32_steps_on_per_layer_route_track_reference():
    """Strict fp32 with use_pallas: the port routes the decoder through the
    per-layer kernels' fp32 mode (their plain versions here), the encoder
    and reparameterization through the plain fp32 path, as the reference
    does; six Adam steps against molvax.train.make_train_step (which on the
    CPU runs its fp32 XLA path), at the fp32 slice's tolerances."""
    before = _launches()
    calls = []
    real = gru.gru_layer_scan_x

    def counting(*args):
        calls.append(args[-1])
        return real(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gru, "gru_layer_scan_x", counting)
        track_reference_six_steps(*_parity_cfgs(use_pallas=True))
    assert calls and set(calls) == {"float32"}
    assert len(calls) == 6 * 2  # 2 layers per step, no scheduled sampling
    assert _launches() == before


def _small_quality_cfg():
    """zinc250k_quality's training recipe (scheduled sampling 0.25, free bits
    0.1, eps 0.02, per-layer kernels, bf16, learned start) at a small width."""
    cfg = tconfig.get_preset("zinc250k_quality")
    model = dataclasses.replace(cfg.model, max_len=12, latent_dim=8, conv_kernels=(3, 3, 3), enc_hidden=8,
                                gru_hidden=16, gru_layers=3)
    return dataclasses.replace(cfg, model=model, data=dataclasses.replace(cfg.data, max_len=12))


def test_quality_step_with_scheduled_sampling_runs_and_moves_weights():
    """Two decode passes per step even at step 0, where the scheduled-
    sampling probability is 0: 2 x 3 per-layer forwards, the graded pass's
    3 backwards. The step moves the weights and keeps the loss finite."""
    cfg = _small_quality_cfg()
    assert cfg.model.gru_kernel == "per_layer" and cfg.train.scheduled_sampling == 0.25
    state = init_state(cfg, seed=7, device="cpu")
    codes = torch.from_numpy(np.random.default_rng(2).integers(0, 37, (4, 12)))
    w0 = state.params.gru.weight_ih_l0.detach().clone()
    calls = []
    real = gru.gru_layer_scan_x

    def counting(*args):
        calls.append(torch.is_grad_enabled())
        return real(*args)

    step = make_train_step(cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gru, "gru_layer_scan_x", counting)
        state, m = step(state, codes)
    assert calls == [False] * 3 + [True] * 3
    assert np.isfinite(float(m["loss"])) and state.step == 1
    assert not torch.equal(w0, state.params.gru.weight_ih_l0)
