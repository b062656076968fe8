"""Headline evaluation: teacher-forced metrics, generation quality,
round-trip reconstruction, interpolation, the posterior against the prior,
latent optimization.

Port of ``molvax/train/evaluate.py``. Every metric function returns the
reference's keys letter for letter. ``model`` is the ``MolecularVAE`` (the
reference's ``params``), ``cfg`` the whole ``Config``.

Randomness: a ``torch.Generator`` takes the place of each ``key``, in the
same argument position. Where the reference splits a key, the port derives
as many generators from it (``split_generator``: seeds drawn from it,
generators on the model's device). The streams differ from ``jax.random``'s
by design (ROADMAP C, "Known differences by design"), so the sampled
metrics agree with the reference's in distribution, not draw for draw; the
tests hand the port's draws to the reference where they can.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.alphabet import DEFAULT_CHARSET, Charset, strings
from ..data.featurize import is_valid_smiles
from ..data.smiles_check import chem_valid, chem_valid_fraction
from ..latent.sample import generate
from ..nn.vae import encode
from ..parallel import map_rows


def split_generator(generator: Optional[torch.Generator], n: int, device) -> List[torch.Generator]:
    """``n`` generators on ``device``, seeded by ``n`` draws from
    ``generator`` (the port's ``jax.random.split``); None means seed 0."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    seeds = torch.randint(0, 1 << 62, (n,), generator=generator, device=generator.device).tolist()
    return [torch.Generator(device=device).manual_seed(s) for s in seeds]


def _round_trip(codes_np: np.ndarray, out_np: np.ndarray, cfg, charset: Charset):
    """(exact-match string rate, per-position hits, non-pad accuracy)."""
    exact = float(np.mean([a == b for a, b in zip(strings(codes_np, cfg.model, charset),
                                                  strings(out_np, cfg.model, charset))]))
    hit = out_np == codes_np
    nonpad = codes_np != charset.pad_index
    return exact, hit, float(hit[nonpad].mean()) if nonpad.any() else 1.0


def _encode_mu(model, cfg, codes_np: np.ndarray) -> torch.Tensor:
    with torch.no_grad():
        mu, _ = encode(model, cfg.model, torch.from_numpy(np.asarray(codes_np)).to(model.device))
    return mu


def novelty_reference(dataset, cap: int = 50000) -> set:
    """The decoded training-string set against which novelty is scored.
    Build it once per ``evaluate`` and pass it to the metric functions as
    ``train_set``."""
    return set(strings(dataset.codes[: min(len(dataset), cap)], charset=dataset.charset))


def _sample_quality(smiles, valid_smiles, train_set: Optional[set]):
    """(valid_frac, uniqueness among valid, novelty of the unique valid,
    mean_len): the MOSES-convention block."""
    uniq_valid = set(valid_smiles)
    novelty = 1.0
    if train_set is not None:
        novelty = len([s for s in uniq_valid if s not in train_set]) / max(len(uniq_valid), 1)
    return (
        len(valid_smiles) / max(len(smiles), 1),
        len(uniq_valid) / max(len(valid_smiles), 1),
        novelty,
        float(np.mean([len(s) for s in smiles])),
    )


def teacher_forced_metrics(state, cfg, dataset, batches: int = 8) -> Dict[str, float]:
    """Mean ELBO / recon / KL / char accuracy over ``batches`` batches of
    ``dataset`` (``make_eval_step``), at the reference's row offsets. The
    batches' metrics come to the host in one copy."""
    from .loop import make_eval_step

    eval_step = make_eval_step(cfg)
    B = cfg.train.batch_size
    dev = state.params.device
    out: List[Dict] = []
    for i in range(batches):
        lo = (i * B) % max(len(dataset) - B, 1)
        codes = torch.from_numpy(dataset.codes[lo : lo + B]).to(dev)
        props = (
            torch.from_numpy(dataset.properties[lo : lo + B]).to(dev)
            if dataset.properties is not None and cfg.model.n_properties > 0
            else None
        )
        out.append(eval_step(state, codes, props))
    keys = list(out[0])
    values = torch.stack([torch.stack([m[k].float() for k in keys]) for m in out]).cpu().numpy()
    return {k: float(np.mean(values[:, j])) for j, k in enumerate(keys)}


def generation_metrics(
    model,
    cfg,
    generator: Optional[torch.Generator],
    n: int = 1000,
    train_dataset=None,
    charset: Optional[Charset] = None,
    temperature: float = 1.0,
    train_set: Optional[set] = None,
) -> Dict[str, float]:
    """MOSES-style sample quality from the prior: validity (grammar and
    chemistry), uniqueness among valid samples, novelty of the unique valid
    ones against the training corpus, mean length. z ~ N(0, I) and the
    decode's Gumbel noise come from two generators derived from
    ``generator``."""
    if charset is None:
        charset = train_dataset.charset if train_dataset is not None else DEFAULT_CHARSET
    if train_set is None and train_dataset is not None:
        train_set = novelty_reference(train_dataset)
    g_z, g_g = split_generator(generator, 2, model.device)
    z = torch.randn(n, cfg.model.latent_dim, generator=g_z, device=model.device)
    codes, _ = generate(model, cfg.model, z, g_g, greedy=False, temperature=temperature, charset=charset)
    smiles = strings(codes, cfg.model, charset)
    valid, uniq, novelty, mean_len = _sample_quality(
        smiles, [s for s in smiles if is_valid_smiles(s, charset)], train_set
    )
    return {
        "gen_valid": valid,
        "gen_chem_valid": chem_valid_fraction(smiles),
        "gen_unique": uniq,
        "gen_novelty": novelty,
        "gen_mean_len": mean_len,
    }


def constrained_generation_metrics(
    model,
    cfg,
    generator: Optional[torch.Generator],
    n: int = 256,
    train_dataset=None,
    charset: Optional[Charset] = None,
    temperature: float = 1.0,
    train_set: Optional[set] = None,
) -> Dict[str, float]:
    """Sample quality from the prior under valence-constrained decoding:
    ``con_chem_valid`` is 1.0 by construction; uniqueness, novelty and
    length say whether the model stays diverse on the valid manifold."""
    if charset is None:
        charset = train_dataset.charset if train_dataset is not None else DEFAULT_CHARSET
    if train_set is None and train_dataset is not None:
        train_set = novelty_reference(train_dataset)
    g_z, g_g = split_generator(generator, 2, model.device)
    z = torch.randn(n, cfg.model.latent_dim, generator=g_z, device=model.device)
    codes, _ = generate(model, cfg.model, z, g_g, greedy=False, temperature=temperature, constrained=True,
                        charset=charset)
    smiles = strings(codes, cfg.model, charset)
    valid, uniq, novelty, mean_len = _sample_quality(smiles, [s for s in smiles if chem_valid(s)], train_set)
    return {
        "con_chem_valid": valid,
        "con_unique": uniq,
        "con_novelty": novelty,
        "con_mean_len": mean_len,
    }


def reconstruction_metrics(
    model,
    cfg,
    dataset,
    generator: Optional[torch.Generator] = None,
    n: int = 256,
    charset: Optional[Charset] = None,
    mesh=None,
) -> Dict[str, float]:
    """Free-running round trip of the first ``n`` rows of ``dataset``
    (encode -> z = mu -> greedy decode, ``latent.sample.generate``; on a
    card at a width ``generate_plan`` lays out, one persistent
    ``fused_generate`` decode): the exact-match string rate, the per-char
    accuracy over all T positions, and over the non-pad ones (the honest
    number: the pad tail is ~2/3 of T on ZINC-length strings). Under a
    data-parallel ``mesh`` each rank round-trips its share of the rows and
    every rank scores all of them (``parallel.map_rows``)."""
    charset = charset or dataset.charset
    codes_np = np.asarray(dataset.codes[:n])

    def round_trip(part: np.ndarray, row_base: int) -> torch.Tensor:
        mu = _encode_mu(model, cfg, part)
        return generate(model, cfg.model, mu, generator, greedy=True, charset=charset, row_base=row_base)[0]

    out_codes = map_rows(mesh, codes_np, round_trip)
    exact, hit, nonpad_acc = _round_trip(codes_np, out_codes.cpu().numpy(), cfg, charset)
    return {"recon_exact": exact, "recon_char_acc": float(np.mean(hit)), "recon_char_acc_nonpad": nonpad_acc}


def beam_reconstruction_metrics(
    model,
    cfg,
    dataset,
    n: int = 256,
    beam: int = 5,
    charset: Optional[Charset] = None,
) -> Dict[str, float]:
    """Round trip with beam-search decoding (``latent.beam``, unconstrained,
    as the reference's): the approximate-MAP string instead of the greedy
    one."""
    from ..latent.beam import beam_generate

    charset = charset or dataset.charset
    codes_np = np.asarray(dataset.codes[:n])
    mu = _encode_mu(model, cfg, codes_np)
    out_codes, _ = beam_generate(model, cfg.model, mu, beam=beam)
    exact, _, nonpad_acc = _round_trip(codes_np, out_codes.cpu().numpy(), cfg, charset)
    return {"recon_beam_exact": exact, "recon_beam_char_acc_nonpad": nonpad_acc}


def interpolation_metrics(
    model,
    cfg,
    dataset,
    generator: Optional[torch.Generator],
    n_pairs: int = 64,
    steps: int = 9,
    charset: Optional[Charset] = None,
    spherical: bool = True,
) -> Dict[str, float]:
    """Latent-interpolation quality over random pairs of ``dataset``,
    drawn without replacement (``torch.randperm``), each path decoded
    greedily in one batch:

    * interp_valid          — fraction of grammar-valid waypoints
    * interp_chem_valid     — fraction of chemically valid waypoints
    * interp_endpoint_exact — endpoint decodes recovering the inputs
    * interp_endpoint_char  — endpoint non-pad char accuracy
    * interp_distinct       — mean (#unique strings along a path) / steps
    """
    from ..latent.interpolate import lerp, slerp

    charset = charset or dataset.charset
    n_pairs = min(n_pairs, len(dataset) // 2)
    if n_pairs < 1:
        raise ValueError(f"interpolation_metrics needs >= 2 molecules, got {len(dataset)}")
    g_pick, g_gen = split_generator(generator, 2, model.device)
    idx = torch.randperm(len(dataset), generator=g_pick, device=g_pick.device)[: 2 * n_pairs].cpu().numpy()
    codes_np = np.asarray(dataset.codes[idx])
    mu = _encode_mu(model, cfg, codes_np)
    z0, z1 = mu[:n_pairs], mu[n_pairs:]
    t = torch.linspace(0.0, 1.0, steps, device=mu.device)[None, :, None]
    zs = (slerp if spherical else lerp)(z0[:, None, :], z1[:, None, :], t)  # (pairs, steps, L)
    out_codes, _ = generate(model, cfg.model, zs.reshape(-1, zs.shape[-1]), g_gen, greedy=True, charset=charset)
    out_np = out_codes.cpu().numpy()
    smiles = strings(out_np, cfg.model, charset)
    paths = [smiles[i * steps : (i + 1) * steps] for i in range(n_pairs)]

    valid = float(np.mean([is_valid_smiles(s, charset) for p in paths for s in p]))
    # the paths' ends against their inputs: z0's rows, then z1's, as codes_np
    end_codes = out_np.reshape(n_pairs, steps, -1)
    exact, _, char = _round_trip(codes_np, np.concatenate([end_codes[:, 0], end_codes[:, -1]]), cfg, charset)
    distinct = float(np.mean([len(set(p)) / steps for p in paths]))
    return {
        "interp_valid": valid,
        "interp_chem_valid": chem_valid_fraction([s for p in paths for s in p]),
        "interp_endpoint_exact": exact,
        "interp_endpoint_char": char,
        "interp_distinct": distinct,
    }


def posterior_prior_metrics(model, cfg, dataset, n: int = 4096) -> Dict[str, float]:
    """How far the aggregate posterior sits from the N(0, I) prior, in
    float64 on the host:

    * post_mean_norm — ||E[mu]|| (prior: 0)
    * post_std_mean  — mean over dims of std(z_d), the eps-scaled encoder
                       noise included (prior: 1)
    * post_prior_w2  — diagonal-Gaussian 2-Wasserstein distance
                       sqrt(||E[z]||^2 + sum_d (std_d - 1)^2)
    """
    from ..latent.embed import encode_codes_chunked

    mu_all, logvar_all = encode_codes_chunked(model, cfg.model, dataset.codes[: min(len(dataset), n)], batch=512)
    mu_all = mu_all.astype(np.float64)
    var_z = mu_all.var(axis=0) + cfg.model.eps_scale**2 * np.exp(logvar_all.astype(np.float64)).mean(axis=0)
    mean = mu_all.mean(axis=0)
    std = np.sqrt(var_z)
    w2 = float(np.sqrt(np.sum(mean**2) + np.sum((std - 1.0) ** 2)))
    return {
        "post_mean_norm": float(np.linalg.norm(mean)),
        "post_std_mean": float(std.mean()),
        "post_prior_w2": w2,
    }


def aggregate_generation_metrics(
    model,
    cfg,
    generator: Optional[torch.Generator],
    dataset,
    n: int = 1000,
    temperature: float = 1.0,
    train_set: Optional[set] = None,
    fit=None,
) -> Dict[str, float]:
    """``generation_metrics`` with z from the fitted aggregate posterior
    N(mean, cov) instead of the prior: keys ``agg_*``. ``fit``, a
    ``(mean, chol)`` from ``fit_aggregate_posterior``, skips the encode and
    the fit when sweeping."""
    from ..latent.sample import fit_aggregate_posterior, sample_aggregate

    charset = dataset.charset
    if train_set is None:
        train_set = novelty_reference(dataset)
    mean, chol = fit if fit is not None else fit_aggregate_posterior(model, cfg.model, dataset.codes)
    smiles = sample_aggregate(model, cfg.model, n, generator, mean, chol, charset=charset, greedy=False,
                              temperature=temperature)
    valid, uniq, novelty, mean_len = _sample_quality(
        smiles, [s for s in smiles if is_valid_smiles(s, charset)], train_set
    )
    return {
        "agg_valid": valid,
        "agg_chem_valid": chem_valid_fraction(smiles),
        "agg_unique": uniq,
        "agg_novelty": novelty,
        "agg_mean_len": mean_len,
    }


def optimization_metrics(
    model,
    cfg,
    dataset,
    generator: Optional[torch.Generator],
    n: int = 64,
    steps: int = 100,
    lr: float = 0.05,
    property_index: int = 0,
    charset: Optional[Charset] = None,
    constrained: bool = False,
    variants=None,
) -> Dict[str, float]:
    """Encode the first ``n`` molecules, gradient-ascend the property head's
    prediction in z (``latent.optimize.optimize_z``), greedy-decode the seed
    and the optimized latents, and re-compute the property on the decoded
    strings (``data.properties``):

    * opt_pred_lift  — mean predicted gain the head claims (de-normalized)
    * opt_real_lift  — mean computed gain over pairs where both parse
    * opt_chem_valid — fraction of optimized decodes that parse
    * opt_pairs      — number of scored pairs

    One optimization serves every entry of ``variants`` (default
    ``(constrained,)``); a constrained variant decodes under the valence
    automaton and its keys take the prefix ``opt_con_``."""
    from ..data.properties import properties_of
    from ..latent.optimize import default_objective, optimize_z

    charset = charset or dataset.charset
    mu = _encode_mu(model, cfg, dataset.codes[:n])
    objective = default_objective(cfg.model, property_index=property_index)
    result = optimize_z(model, cfg.model, mu, objective=objective, steps=steps, lr=lr)
    g1, g2 = split_generator(generator, 2, model.device)
    pred_lift = float(torch.mean(result.objective - result.objective_start))
    out: Dict[str, float] = {}
    for con in variants if variants is not None else (constrained,):
        seed_codes, _ = generate(model, cfg.model, mu, g1, greedy=True, constrained=con, charset=charset)
        opt_codes, _ = generate(model, cfg.model, result.z, g2, greedy=True, constrained=con, charset=charset)
        seed_smiles = strings(seed_codes, cfg.model, charset)
        opt_smiles = strings(opt_codes, cfg.model, charset)
        lifts = []
        chem_ok = 0
        for s0, s1 in zip(seed_smiles, opt_smiles):
            p1 = properties_of(s1)
            if p1 is not None:
                chem_ok += 1
            p0 = properties_of(s0)
            if p0 is not None and p1 is not None:
                lifts.append(p1[property_index] - p0[property_index])
        pre = "opt_con_" if con else "opt_"
        out.update({
            pre + "pred_lift": pred_lift,
            pre + "real_lift": float(np.mean(lifts)) if lifts else 0.0,
            pre + "chem_valid": chem_ok / max(len(opt_smiles), 1),
            pre + "pairs": float(len(lifts)),
        })
    return out


def temperature_sweep(
    model,
    cfg,
    generator: Optional[torch.Generator],
    temperatures=(0.5, 0.7, 1.0, 1.3),
    n: int = 500,
    train_dataset=None,
    train_set: Optional[set] = None,
) -> Dict[str, float]:
    """Prior-sample quality against softmax temperature, one generator
    derived from ``generator`` per temperature: keys ``gen_valid@T`` etc."""
    if train_set is None and train_dataset is not None:
        train_set = novelty_reference(train_dataset)
    gens = split_generator(generator, len(temperatures), model.device)
    out: Dict[str, float] = {}
    for g, t in zip(gens, temperatures):
        m = generation_metrics(model, cfg, g, n=n, train_dataset=train_dataset, temperature=float(t),
                               train_set=train_set)
        for k, v in m.items():
            out[f"{k}@{t:g}"] = v
    return out


def evaluate(
    state,
    cfg,
    dataset,
    generator: Optional[torch.Generator] = None,
    n_prior: int = 1000,
    sweep_temperatures: bool = False,
    interpolation: bool = True,
    aggregate_posterior: bool = True,
    train_dataset=None,
    constrained: bool = True,
    beam: int = 0,
) -> Dict[str, float]:
    """The full report: teacher-forced, generation (and constrained),
    reconstruction (and beam), posterior against prior, interpolation,
    aggregate-posterior generation, optimization for a model with a
    property head, and optionally a temperature sweep, on the EMA weights
    where the state has them (``ema_eval_state``).

    For a held-out report pass the held-out split as ``dataset`` and the
    training split as ``train_dataset``: the novelty reference and the
    aggregate-posterior fit come from the data the model trained on. With
    ``train_dataset=None`` both roles fall to ``dataset``. ``generator=None``
    means seed 0; the seven metric families draw from seven generators
    derived from it, on the model's device."""
    from .loop import effective_config, ema_eval_state

    state = ema_eval_state(state)
    model = state.params
    if cfg.model.n_properties > 0 and cfg.model.property_mean is None:
        # a hand-built cfg (not restored from config.json) has no target
        # stats: fit them from the split that carries properties, the
        # training split preferred
        stats_src = train_dataset if train_dataset is not None else dataset
        if stats_src.properties is None and dataset.properties is not None:
            stats_src = dataset
        if stats_src.properties is not None:
            cfg = effective_config(cfg, stats_src)
    g1, g2, g3, g4, g5, g6, g7 = split_generator(generator, 7, model.device)
    ref = train_dataset if train_dataset is not None else dataset
    ref_set = novelty_reference(ref)
    metrics = teacher_forced_metrics(state, cfg, dataset)
    metrics.update(generation_metrics(model, cfg, g1, n=n_prior, train_dataset=ref, train_set=ref_set))
    if constrained:
        metrics.update(constrained_generation_metrics(model, cfg, g7, n=min(n_prior, 256), train_dataset=ref,
                                                      train_set=ref_set))
    metrics.update(reconstruction_metrics(model, cfg, dataset, g2))
    if beam > 1:
        metrics.update(beam_reconstruction_metrics(model, cfg, dataset, beam=beam))
    metrics.update(posterior_prior_metrics(model, cfg, dataset))
    if interpolation:
        n_pairs = min(64, len(dataset) // 2)
        if n_pairs >= 2:
            metrics.update(interpolation_metrics(model, cfg, dataset, g4, n_pairs=n_pairs))
    if aggregate_posterior:
        metrics.update(aggregate_generation_metrics(model, cfg, g5, ref, n=n_prior, train_set=ref_set))
    if cfg.model.n_properties > 0 and getattr(model, "prop_out", None) is not None:
        metrics.update(optimization_metrics(model, cfg, dataset, g6,
                                            variants=(False, True) if constrained else (False,)))
    if sweep_temperatures:
        metrics.update(temperature_sweep(model, cfg, g3, train_dataset=ref, train_set=ref_set))
    return metrics
