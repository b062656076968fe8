"""CLI: ``python3 -m molvax_torch.cli <command> --preset <name> [--override k=v ...]``.

Port of ``molvax/cli.py`` (installed as ``molvax-torch``): named presets
plus dotted-path overrides, with the reference's subcommands (train,
sample, interpolate, reconstruct, evaluate, optimize, encode, decode,
export-data, presets). Every command prints what the reference's prints.

The device: ``MOLVAX_PLATFORM=cpu`` runs on the CPU; unset, ``cuda`` or
``gpu`` runs on the card, and a command that builds a model raises where
there is none. A checkpoint directory is the port's own (``train()``'s
``config.json``, ``charset.json``, ``<step>/state.pt`` and ``best/``).

Under ``torchrun`` (``torchrun --nproc_per_node=N -m molvax_torch.cli
train ...``) ``train`` joins the world (NCCL, one card a rank; gloo on the
CPU with ``MOLVAX_PLATFORM=cpu``, the counterpart of the reference's
``MOLVAX_CPU_DEVICES``) and trains data-parallel on the mesh ``train()``
picks from the config's ``mesh``. The other commands take no mesh, as the
reference's: rank 0 runs them, and the other ranks exit 0 having written
nothing.
"""

from __future__ import annotations

import argparse
import ast
import os
import sys
from typing import Dict, Optional

from .config import Config, PRESETS, apply_overrides, get_preset


def _platform_device() -> Optional[str]:
    """The device ``MOLVAX_PLATFORM`` asks for: ``"cpu"``, or None (the
    card, through ``utils.resolve_device``)."""
    platform = os.environ.get("MOLVAX_PLATFORM", "").lower()
    if platform == "cpu":
        return "cpu"
    if platform in ("", "cuda", "gpu"):
        return None
    raise SystemExit(f"MOLVAX_PLATFORM={platform!r}: expected cpu, cuda or gpu")


def _parse_overrides(pairs) -> Dict:
    out = {}
    for p in pairs or []:
        if "=" not in p:
            raise SystemExit(f"--override expects key=value, got {p!r}")
        k, v = p.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v  # bare string
    return out


def _load_cfg(args) -> Config:
    cfg = get_preset(args.preset)
    return apply_overrides(cfg, _parse_overrides(args.override))


def _generator(seed: int):
    import torch

    return torch.Generator().manual_seed(seed)


def _torchrun_rank() -> int:
    """This process's rank where ``torchrun`` started it, else 0."""
    return int(os.environ.get("RANK", "0")) if "WORLD_SIZE" in os.environ else 0


def cmd_train(args) -> int:
    import torch.distributed as dist

    from .parallel import init_from_env
    from .train import train

    cfg = _load_cfg(args)
    joined = not dist.is_initialized() and init_from_env(cpu=_platform_device() == "cpu")
    try:
        state, history = train(
            cfg,
            device=_platform_device(),
            metrics_path=args.metrics,
            max_steps=args.steps,
            verbose=not args.quiet,
        )
    finally:
        if joined:
            dist.destroy_process_group()
    train_rows = [h for h in history if "loss" in h]
    if train_rows and _torchrun_rank() == 0:
        last = train_rows[-1]
        print(
            f"done: step {last['step']} loss {last['loss']:.3f} "
            f"acc {last.get('acc', float('nan')):.3f}"
        )
    return 0


def _restore(cfg: Config, ckpt_dir: str, args=None):
    """Restore (cfg, state, charset) from a checkpoint directory.

    ``config.json`` (the run's effective config) becomes the base, with
    ``--override`` on top; the table the model was trained on
    (``data.alphabet.read_table``) is the charset returned, and
    ``charset_size`` follows it. A run with
    ``select_best`` (by the checkpoint's own config) is served from
    ``best/``, or from the top level where ``best/`` holds no checkpoint.
    The weights are copied into a fresh state's tensors in place
    (``io.checkpoint``); the state served is ``ema_eval_state``'s, the EMA
    where the run trained one."""
    import dataclasses
    import json

    from .config import from_dict
    from .data.alphabet import read_table
    from .io import checkpoint as ckpt_io
    from .train import init_state
    from .train.loop import ema_eval_state

    cfg_path = os.path.join(ckpt_dir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = from_dict(json.load(f))
        if args is not None and args.override:
            cfg = apply_overrides(cfg, _parse_overrides(args.override))
        print(f"[molvax] restored config from {cfg_path} (name={cfg.name})", file=sys.stderr)

    try:
        charset = read_table(ckpt_dir, cfg.model)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if charset.size != cfg.model.charset_size:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, charset_size=charset.size))
    # best/ only when this checkpoint's own config selects it: a later run
    # with select_best off stops maintaining best/, and must stop it being served
    best_dir = os.path.join(ckpt_dir, "best")
    use_dir = ckpt_dir
    if os.path.isdir(best_dir) and cfg.train.select_best:
        use_dir = best_dir
        print(f"[molvax] using best-checkpoint selection dir {best_dir}", file=sys.stderr)
    template = init_state(cfg, device=_platform_device())

    def latest(directory):
        # a read-side entry point creates no directory
        if not os.path.isdir(directory):
            return None
        return ckpt_io.make_manager(directory).restore_latest(template)

    state = latest(use_dir)
    if state is None and use_dir != ckpt_dir:
        state = latest(ckpt_dir)
    if state is None:
        raise SystemExit(f"no checkpoint found in {ckpt_dir}")
    return cfg, ema_eval_state(state), charset


def cmd_sample(args) -> int:
    from .data import valid_fraction
    from .latent import sample_prior

    cfg = _load_cfg(args)
    cfg, state, charset = _restore(cfg, args.ckpt, args)
    if args.aggregate:
        # z from a Gaussian fitted to the aggregate posterior over the
        # training corpus instead of N(0, I)
        from .data.alphabet import corpus
        from .latent import fit_aggregate_posterior, sample_aggregate

        ds = corpus(cfg)
        mean, chol = fit_aggregate_posterior(state.params, cfg.model, ds.codes)
        smiles = sample_aggregate(
            state.params, cfg.model, args.n, _generator(args.seed), mean, chol, charset=charset,
            greedy=not args.stochastic, temperature=args.temperature, constrained=args.constrained,
        )
    else:
        smiles = sample_prior(
            state.params, cfg.model, args.n, _generator(args.seed), charset=charset,
            greedy=not args.stochastic, temperature=args.temperature, constrained=args.constrained,
        )
    for s in smiles:
        print(s)
    print(f"# grammar-valid: {valid_fraction(smiles, charset):.2%}", file=sys.stderr)
    if args.constrained:
        from .data import chem_valid_fraction

        print(
            f"# chem-valid: {chem_valid_fraction(smiles):.2%} "
            "(valence-constrained decode)",
            file=sys.stderr,
        )
    return 0


def cmd_interpolate(args) -> int:
    from .latent import interpolate

    cfg = _load_cfg(args)
    cfg, state, charset = _restore(cfg, args.ckpt, args)
    for s in interpolate(state.params, cfg.model, args.start, args.end, steps=args.n, charset=charset,
                         constrained=args.constrained):
        print(s)
    return 0


def cmd_reconstruct(args) -> int:
    from .latent import beam_reconstruct, reconstruct

    cfg = _load_cfg(args)
    cfg, state, charset = _restore(cfg, args.ckpt, args)
    if args.beam > 1:
        out = beam_reconstruct(state.params, cfg.model, args.smiles, beam=args.beam, charset=charset,
                               constrained=args.constrained)
    else:
        out = reconstruct(state.params, cfg.model, args.smiles, _generator(args.seed), charset=charset)
    for inp, rec in zip(args.smiles, out):
        print(f"{inp}\t{rec}")
    return 0


def cmd_evaluate(args) -> int:
    import json

    from .data.alphabet import corpus
    from .train.evaluate import evaluate

    cfg = _load_cfg(args)
    cfg, state, charset = _restore(cfg, args.ckpt, args)
    dataset = corpus(cfg, with_properties=cfg.model.n_properties > 0)
    train_ds = None
    if args.holdout:
        # the held-out split; the novelty reference and the aggregate fit
        # stay on the training split
        train_ds, dataset = dataset.split(cfg.data.test_fraction, cfg.data.seed)
    report = evaluate(
        state,
        cfg,
        dataset,
        n_prior=args.n_prior,
        sweep_temperatures=args.sweep,
        train_dataset=train_ds,
        beam=args.beam,
    )
    print(json.dumps({k: round(v, 5) for k, v in report.items()}, sort_keys=True))
    return 0


def cmd_optimize(args) -> int:
    """Gradient-based property optimization in z."""
    from .latent import optimize_from_smiles
    from .latent.optimize import default_objective

    cfg = _load_cfg(args)
    # without config.json the preset must carry the head: a headless
    # template cannot take a property checkpoint
    if not os.path.exists(os.path.join(args.ckpt, "config.json")) and cfg.model.n_properties == 0:
        raise SystemExit(
            "config has no property head; pass the preset/overrides the "
            "checkpoint was trained with (e.g. --preset property_joint)"
        )
    cfg, state, charset = _restore(cfg, args.ckpt, args)
    if cfg.model.n_properties == 0:
        raise SystemExit("checkpoint has no property head; train with model.n_properties>0")
    sign = -1.0 if args.minimize else 1.0
    objective = default_objective(cfg.model, property_index=args.property, sign=sign)
    out, result = optimize_from_smiles(
        state.params,
        cfg.model,
        args.smiles,
        _generator(args.seed),
        objective=objective,
        steps=args.steps,
        lr=args.lr,
        charset=charset,
        constrained=args.constrained,
    )
    # the property values themselves (the minimize sign undone), at the
    # encoded seed and at the optimized latent
    start = sign * result.objective_start.cpu().numpy()
    end = sign * result.objective.cpu().numpy()
    for s_in, s_out, o0, o1 in zip(args.smiles, out, start, end):
        print(f"{s_in}\t{s_out}\t{o0:.4f}->{o1:.4f}")
    return 0


def _read_smiles_lines(path: str) -> list:
    """One SMILES per line; '#' comments and blank lines skipped. A row
    gives its first comma- or whitespace-separated field, as
    ``data.zinc.load_smiles_file`` parses it."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split(",")[0].split()
            if not tok:
                continue
            s = tok[0]
            if s.lower() in ("smiles", "canonical_smiles"):
                continue
            out.append(s)
    return out


def cmd_encode(args) -> int:
    """Corpus -> latent embeddings (the VAE as a featurizer)."""
    from .latent import encode_corpus
    from .latent.embed import save_latents

    cfg = _load_cfg(args)
    cfg, state, charset = _restore(cfg, args.ckpt, args)
    smiles = list(args.smiles)
    if args.infile:
        smiles = _read_smiles_lines(args.infile) + smiles
    n_all = len(smiles)
    smiles = [s for s in smiles if len(s) <= cfg.model.max_len]
    if len(smiles) < n_all:
        print(
            f"[molvax] skipped {n_all - len(smiles)} SMILES longer than "
            f"max_len={cfg.model.max_len}",
            file=sys.stderr,
        )
    if not smiles:
        raise SystemExit("no SMILES given (positional args or --in FILE)")
    mu, logvar = encode_corpus(state.params, cfg.model, smiles, charset=charset, batch=args.batch)
    if args.out:
        save_latents(args.out, mu, logvar, smiles)
        print(f"wrote {args.out}: mu/logvar {mu.shape}", file=sys.stderr)
    else:
        for row in mu:
            print(",".join(f"{v:.6g}" for v in row))
    return 0


def cmd_decode(args) -> int:
    """Latent vectors -> SMILES (the inverse of ``encode``)."""
    from .data import valid_fraction
    from .latent import decode_latents
    from .latent.embed import load_latents

    cfg = _load_cfg(args)
    cfg, state, charset = _restore(cfg, args.ckpt, args)
    try:
        z = load_latents(args.infile)
    except ValueError as e:  # an .npz without z or mu: the reference's exit
        raise SystemExit(str(e)) from e
    smiles = decode_latents(
        state.params,
        cfg.model,
        z,
        _generator(args.seed),
        charset=charset,
        batch=args.batch,
        greedy=not args.stochastic,
        temperature=args.temperature,
        constrained=args.constrained,
        beam=args.beam,
    )
    for s in smiles:
        print(s)
    print(f"# grammar-valid: {valid_fraction(smiles, charset):.2%}", file=sys.stderr)
    return 0


def cmd_export_data(args) -> int:
    """Export a corpus to the chemvae .h5 layout."""
    from .data import export_h5
    from .data.alphabet import corpus

    cfg = _load_cfg(args)
    dataset = corpus(cfg, with_properties=args.properties)
    export_h5(dataset, args.out, test_fraction=cfg.data.test_fraction, seed=cfg.data.seed)
    props = "" if dataset.properties is None else f", properties {dataset.properties.shape[1]}"
    print(f"wrote {args.out}: {len(dataset)} molecules, charset {dataset.charset.size}{props}")
    return 0


def cmd_presets(args) -> int:
    for name, fn in PRESETS.items():
        print(f"{name}: {fn.__doc__.strip().splitlines()[0]}")
    return 0


def main(argv=None) -> int:
    _platform_device()  # refuse an unknown MOLVAX_PLATFORM before any work

    p = argparse.ArgumentParser(prog="molvax-torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("--preset", default="chemvae_5k", choices=sorted(PRESETS))
        sp.add_argument(
            "--override",
            action="append",
            metavar="KEY=VALUE",
            help="dotted config override, e.g. train.batch_size=128",
        )

    sp = sub.add_parser("train", help="train a preset config")
    common(sp)
    sp.add_argument("--steps", type=int, default=None, help="override step count")
    sp.add_argument("--metrics", default=None, help="JSONL metrics path")
    sp.add_argument("--quiet", action="store_true")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("sample", help="sample SMILES from the prior")
    common(sp)
    sp.add_argument("--ckpt", required=True)
    sp.add_argument("-n", type=int, default=10)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--stochastic", action="store_true")
    sp.add_argument("--temperature", type=float, default=1.0)
    sp.add_argument(
        "--aggregate",
        action="store_true",
        help="sample z from the aggregate posterior fitted to the training "
        "corpus instead of the N(0, I) prior",
    )
    sp.add_argument(
        "--constrained",
        action="store_true",
        help="valence-constrained decoding: mask tokens the SMILES validity "
        "parser would reject, so every sample is chemically valid",
    )
    sp.set_defaults(fn=cmd_sample)

    sp = sub.add_parser("interpolate", help="latent interpolation between two SMILES")
    common(sp)
    sp.add_argument("--ckpt", required=True)
    sp.add_argument("start")
    sp.add_argument("end")
    sp.add_argument("-n", type=int, default=10)
    sp.add_argument(
        "--constrained",
        action="store_true",
        help="decode waypoints under the valence automaton so every point "
        "on the path is a chemically valid molecule",
    )
    sp.set_defaults(fn=cmd_interpolate)

    sp = sub.add_parser("reconstruct", help="encode->decode round trip")
    common(sp)
    sp.add_argument("--ckpt", required=True)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument(
        "--beam",
        type=int,
        default=1,
        help="beam width >1 decodes with beam search (approximate-MAP "
        "string instead of greedy)",
    )
    sp.add_argument(
        "--constrained",
        action="store_true",
        help="with --beam: search only over chemically valid continuations "
        "(valence automaton)",
    )
    sp.add_argument("smiles", nargs="+")
    sp.set_defaults(fn=cmd_reconstruct)

    sp = sub.add_parser("evaluate", help="headline metrics: ELBO/acc, sample quality, round trip")
    common(sp)
    sp.add_argument("--ckpt", required=True)
    sp.add_argument("--n-prior", type=int, default=1000)
    sp.add_argument(
        "--beam",
        type=int,
        default=0,
        help="also report beam-search round-trip metrics at this width",
    )
    sp.add_argument(
        "--holdout",
        action="store_true",
        help="evaluate on the data.test_fraction split (same split the "
        "train loop holds out when train.eval_every is set; if the model "
        "was trained WITHOUT eval_every it saw this data too)",
    )
    sp.add_argument(
        "--sweep",
        action="store_true",
        help="add a softmax-temperature sweep of prior-sample quality",
    )
    sp.set_defaults(fn=cmd_evaluate)

    sp = sub.add_parser("optimize", help="gradient-ascend a property in latent space")
    common(sp)
    sp.add_argument("--ckpt", required=True)
    sp.add_argument("--property", type=int, default=0, help="property index (0=logP)")
    sp.add_argument("--minimize", action="store_true")
    sp.add_argument("--steps", type=int, default=100)
    sp.add_argument("--lr", type=float, default=0.05)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument(
        "--constrained",
        action="store_true",
        help="decode the optimized latent under the valence automaton so "
        "the output molecule is chemically valid by construction",
    )
    sp.add_argument("smiles", nargs="+")
    sp.set_defaults(fn=cmd_optimize)

    sp = sub.add_parser("encode", help="embed SMILES as latent vectors (featurizer workflow)")
    common(sp)
    sp.add_argument("--ckpt", required=True)
    sp.add_argument("--in", dest="infile", default=None, help=".smi/.csv file, one SMILES per line")
    sp.add_argument("--out", default=None,
                    help=".npz output (keys mu, logvar, smiles); default prints mu rows as CSV")
    sp.add_argument("--batch", type=int, default=256, help="rows a device call (the last chunk may be smaller)")
    sp.add_argument("smiles", nargs="*")
    sp.set_defaults(fn=cmd_encode)

    sp = sub.add_parser("decode", help="decode latent vectors (.npy/.npz) back to SMILES")
    common(sp)
    sp.add_argument("--ckpt", required=True)
    sp.add_argument("--in", dest="infile", required=True, help=".npy (N,L) array or .npz with key z or mu")
    sp.add_argument("--batch", type=int, default=256)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--stochastic", action="store_true")
    sp.add_argument("--temperature", type=float, default=1.0)
    sp.add_argument("--beam", type=int, default=1, help="beam width >1: approximate-MAP decoding")
    sp.add_argument(
        "--constrained",
        action="store_true",
        help="valence-constrained decoding (chemically valid by construction)",
    )
    sp.set_defaults(fn=cmd_decode)

    sp = sub.add_parser("export-data", help="export a corpus to the chemvae .h5 layout")
    common(sp)
    sp.add_argument("--out", required=True, help="output .h5 path")
    sp.add_argument(
        "--properties",
        action="store_true",
        help="compute logP/QED/SAS targets once and store them in the .h5 "
        "(properties_train/test; training loads them instead of re-running "
        "the descriptor pass)",
    )
    sp.set_defaults(fn=cmd_export_data)

    sp = sub.add_parser("presets", help="list named presets")
    sp.set_defaults(fn=cmd_presets)

    args = p.parse_args(argv)
    if args.fn is not cmd_train and _torchrun_rank() > 0:
        return 0  # the reference's other commands take no mesh: rank 0 runs them
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
