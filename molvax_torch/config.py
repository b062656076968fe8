"""Frozen config tree + the five benchmark presets (BASELINE.json:6-12).

The port's own copy of ``molvax/config.py``: the same dataclasses, the
same seven presets, ``PRESETS``, ``get_preset``, ``to_dict``, ``from_dict``
and ``apply_overrides``. The port imports nothing of the ``molvax``
package, so it keeps this copy;
``tests/test_torch_support.py::test_presets_are_the_reference_table``
holds it to the reference field by field. The port adds two fields of its
own, each at a default that leaves the reference's presets as they are
(``alphabet``, ``dense_activation``), and one preset of its own,
``gvae_zinc``: the Grammar VAE, which the reference does not run. The classes are not the
reference's objects: build each package's config from the same preset name
or keyword arguments, never hand one package's config to the other.

What the routing flags mean in the port:
  * ``use_pallas`` / ``gru_kernel``: the hand-written kernels of
    ``kernels/`` on CUDA tensors (``kernels/gru.py`` routes the GRU);
  * ``use_pallas_generation``: the hand-written generation kernel
    (``kernels/generate.py``) for an unconstrained teacher-forced decode;
  * ``use_pallas_automaton`` has no effect. In the reference it chooses
    between two implementations of identical codes by their speed on the
    TPU. The port has one per device: on CUDA the constrained decode always
    launches the automaton kernel (``kernels/automaton.py``), on the CPU it
    always runs its plain version. The flag is accepted and changes nothing;
  * ``compute_dtype``: resolved per device (``utils.matmul_dtype``).

Reference parity: the reference configures via argparse flags / top-of-file
constants (SURVEY.md 2.13). Here: one frozen dataclass tree per run, hashable
so model configs can be jit static args; presets are named constructors.

The two reference-lineage ambiguities (SURVEY.md section 2 notes A/B) are
explicit config axes, not code forks:
  * ``conv_orientation``: 'seq' (paper-faithful: convolve along the 120
    positions, charset = input channels) vs 'charset' (the compact-port
    quirk: Conv1d(120, ...) convolves along the charset axis).
  * ``decoder_conditioning``: 'teacher_forced' (spec, BASELINE.json:5) vs
    'repeat_z' (compact-port simplification).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    max_len: int = 120
    charset_size: int = 37  # molvax.data.DEFAULT_CHARSET size; ~35 per spec
    latent_dim: int = 292
    conv_channels: Tuple[int, ...] = (9, 9, 10)
    conv_kernels: Tuple[int, ...] = (9, 9, 11)
    conv_orientation: str = "seq"  # 'seq' | 'charset'  (note A)
    enc_hidden: int = 435
    gru_hidden: int = 501
    gru_layers: int = 3
    decoder_conditioning: str = "teacher_forced"  # | 'repeat_z'  (note B)
    # Learned start token: the decoder's step-0 "previous character" input is
    # a trained C-vector instead of the reference's all-zero vector. Off by
    # default (reference parity); improves free-running decode fidelity
    # (VERDICT r1 weak 6) because generation starts from the same learned
    # anchor the teacher-forced trainer saw.
    learned_start: bool = False
    recon_loss: str = "ce"  # 'ce' (spec) | 'bce' (compact-port BCE-on-softmax)
    eps_scale: float = 1.0  # reparam noise scale; compact ports use 1e-2
    n_properties: int = 0  # 0 = no property head; 3 = logP/QED/SAS
    property_hidden: int = 67
    # Per-property target standardization (mean/std tuples, length
    # n_properties). Raw logP/QED/SAS spans differ ~10x (SAS 1-10, QED (0,1)),
    # so an unnormalized multi-task MSE is gradient-dominated by the widest
    # property (VERDICT r1 weak 7). train() fills these from the dataset when
    # unset; they persist in the checkpoint's config.json so inference
    # de-normalizes predictions back to raw units (property_head.py).
    property_mean: Optional[Tuple[float, ...]] = None
    property_std: Optional[Tuple[float, ...]] = None
    # Matmul dtype policy — HONORED on every path (VERDICT r4 next 4):
    #   'float32'  strict fp32 end to end: XLA paths run fp32 matmuls and
    #              the per-layer Pallas GRU kernels run their strict-fp32
    #              mode (fp32 operands/residuals/cotangents); the bf16-only
    #              fused stack / encoder / generation kernels are bypassed
    #              for their fp32-honoring twins. The numerics-conservative
    #              fallback for collapse-boundary work (measured cost:
    #              see BASELINE.md fp32-mode row).
    #   'bfloat16' bf16 matmul operands everywhere (fp32 gate math,
    #              accumulation, reductions, KL/loss — SURVEY.md section 7).
    #   'auto'     bfloat16 on TPU, float32 elsewhere — the platform policy
    #              chemvae_5k runs (bf16 on its benched TPU path, fp32 on
    #              its CPU-runnable path; XLA CPU cannot execute bf16 dots).
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16' | 'auto'
    use_pallas: bool = False  # Pallas kernels for hot ops (TPU only)
    # Fused autoregressive generation kernel (kernels/generate.py): whole
    # decode loop VMEM-resident, bf16 matmuls (99.7% greedy agreement and
    # equal round-trip accuracy vs the fp32 lax.scan path on trained
    # weights). Drain-honest device timing (bench.py measure_generation,
    # 96-dispatch rounds, spread 0.2%): fused 145.4k vs scan 94.9k
    # SMILES/s at B=256 on v5 lite (+53%) — the round-2 "both paths
    # measure equal" reading was dispatch-latency noise at 5-call rounds.
    # Default False only because the kernel needs a TPU and B%128==0
    # (generation_kernel_supported falls back to the scan otherwise); the
    # TPU production presets switch it on.
    use_pallas_generation: bool = False
    # Fused constrained-decoding automaton step (kernels/automaton.py):
    # legality mask + masked selection + state transition in ONE Mosaic
    # program per decode step, replacing the few hundred small XLA ops the
    # valence automaton otherwise lowers to inside the generation scan
    # (the measured wall of `--constrained` sampling). The kernel body and
    # the XLA fallback are the same functions (latent/constrain.py), so
    # numerics agree exactly; off-TPU the call runs in interpret mode.
    # In the port the flag has no effect (see the module docstring).
    use_pallas_automaton: bool = False
    # Which Pallas recurrence serves the decoder when use_pallas is on.
    # 'auto' (default): the fused all-layers stack kernel on hardware
    # wherever its VMEM plan fits — the round-4 measured winner at every
    # fitting batch (24.3k/34.8k/37.4k SMILES/s at B=64/256/512 vs the
    # per-layer kernels' 23.3k/32.2k/34.8k on v5 lite) — with per-layer
    # kernels serving oversize shapes (4xGRU-1024) and interpret mode.
    # 'per_layer'/'fused_stack' pin one path for A/Bs and other hardware.
    gru_kernel: str = "auto"
    # Port-only. What a code is: 'charset' (a character of the charset) or
    # 'zinc_grammar' (a production rule of the Grammar VAE's ZINC grammar,
    # data/grammar.py: the one-hot is over the rules, the likelihood is the
    # grammar-masked softmax, decoding is the pushdown walk).
    alphabet: str = "charset"
    # Port-only. The activation of the encoder's dense layer and of the
    # decoder's latent embedding: SELU (the ChemVAE lineage) or ReLU (the
    # Grammar VAE's Keras model).
    dense_activation: str = "selu"

    def __post_init__(self):
        assert self.conv_orientation in ("seq", "charset")
        assert self.compute_dtype in ("float32", "bfloat16", "auto")
        assert self.gru_kernel in ("auto", "per_layer", "fused_stack")
        assert self.decoder_conditioning in ("teacher_forced", "repeat_z")
        assert self.recon_loss in ("ce", "bce")
        assert self.alphabet in ("charset", "zinc_grammar")
        assert self.dense_activation in ("selu", "relu")
        assert self.alphabet == "charset" or self.recon_loss == "ce", "a grammar's likelihood is the masked softmax"
        assert len(self.conv_channels) == len(self.conv_kernels)
        for stats in (self.property_mean, self.property_std):
            assert stats is None or len(stats) == self.n_properties


@dataclasses.dataclass(frozen=True)
class KLScheduleConfig:
    kind: str = "linear"  # 'constant' | 'linear' | 'cyclical'
    beta_max: float = 1.0
    warmup_steps: int = 2000  # linear: steps to reach beta_max
    cycle_steps: int = 10000  # cyclical: period
    ratio: float = 0.5  # cyclical: fraction of cycle spent ramping
    # Free bits (nats per latent dim): the loss KL is sum(max(kl_i, fb)),
    # so dims already below the floor stop being pushed toward the prior.
    # Guards against posterior collapse — measured round 2: beta-annealed-
    # to-1 training collapsed to 2.9 total nats over 292 dims and capped
    # free-running round-trip accuracy at ~70%. 0 = off (reference parity).
    free_bits: float = 0.0

    def __post_init__(self):
        assert self.kind in ("constant", "linear", "cyclical")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 64
    learning_rate: float = 1e-3
    lr_schedule: str = "constant"  # 'constant' | 'cosine' | 'warmup_cosine'
    lr_warmup_steps: int = 500  # warmup_cosine: linear ramp length
    lr_decay_steps: int = 100_000  # cosine horizon (end value = 10% of peak)
    epochs: int = 50
    steps: Optional[int] = None  # overrides epochs when set
    seed: int = 0
    kl: KLScheduleConfig = KLScheduleConfig()
    # Scheduled sampling (VERDICT r1 weak 6): probability of replacing each
    # teacher-forced input character with the model's own (first-pass,
    # stop-gradient) prediction, annealed linearly 0 -> this value over
    # `scheduled_sampling_warmup` steps. 0 = pure teacher forcing (reference
    # behavior). Uses the parallel two-pass scheme (train/loop.py) so the
    # training decode stays batch-parallel (no sequential sampling loop).
    # Round-5 measurement: ss=0.25 is the ONLY lever that makes held-out
    # round-trip fidelity seed-robust at the quality operating point
    # ({96.5, 97.2, 97.2}% vs the teacher-forced lottery's {95.7, 37.8,
    # 53.3}); it costs aggregate-sampler grammar validity (~51-75%,
    # temperature-insensitive). zinc250k_quality adopts it; see
    # docs/PERFORMANCE.md "basin lottery".
    scheduled_sampling: float = 0.0
    scheduled_sampling_warmup: int = 5000
    # Word dropout (Bowman et al. 2016): probability of zeroing each teacher
    # input character's one-hot during training, forcing molecule identity
    # through z instead of the decoder's local context. 0 = off (reference
    # behavior). Round-5 measurement: REFUTED at the quality operating
    # point — wd 0.1/0.25 degrade BOTH held-out round-trip (36/59% vs 96%)
    # and sample validity (45/37% vs 97%), alone or combined with ss; no
    # preset uses it (kept as a tested, measured-and-demoted knob).
    word_dropout: float = 0.0
    property_loss_weight: float = 1.0
    # Posterior-collapse guard (VERDICT r4 next 1): train() watches the
    # in-batch aggregate-z std metric (`post_std_batch`, train/loss.py) at
    # log cadence once past `collapse_guard_after` steps; a value below
    # `collapse_std_floor` means the encoder means have converged and the
    # latent is collapsing (round 4 measured collapsed runs at ~0.015 vs
    # O(0.1-1) healthy at the quality operating point). 0.0 = guard off
    # (reference behavior). With `collapse_abort` the run checkpoints and
    # raises PosteriorCollapseError so a collapsed run dies in ~1k steps,
    # not 16k; otherwise it warns once per crossing and keeps training.
    collapse_std_floor: float = 0.0
    collapse_guard_after: int = 1000
    collapse_abort: bool = True
    grad_clip_norm: Optional[float] = None
    # Exponential moving average of the weights (Polyak averaging), updated
    # in the jitted step (ema = d*ema + (1-d)*params) and preferred by
    # evaluation/inference entry points when present. Round-5 motivation:
    # the quality operating point's held-out round-trip fidelity is
    # dominated by where in the late-training noise the final step happens
    # to land (seed trajectories spike and recover); an averaged iterate
    # evaluates the trajectory's center instead of its endpoint. 0 = off.
    ema_decay: float = 0.0
    train_chunk_size: int = 1  # optimizer steps fused per device program
    log_every: int = 50
    eval_every: int = 0  # steps between held-out evals (0 = off)
    eval_batches: int = 4  # batches per eval pass
    # Free-running round-trip probe at eval cadence: encode -> z=mu ->
    # greedy decode on this many held-out molecules, logged as
    # eval_recon_{exact,char_acc,char_acc_nonpad}. Round-5 motivation: the
    # quality operating point's failure mode is FREE-RUNNING infidelity
    # with healthy teacher-forced metrics (seed study: 97%+ teacher-forced
    # acc with 38-53% round-trip), so teacher-forced eval alone cannot see
    # a failing run. 0 = off.
    eval_roundtrip_n: int = 0
    # Best-checkpoint selection on the round-trip probe (requires
    # eval_roundtrip_n > 0 and eval_every > 0): train() returns the
    # highest-probe iterate instead of the last one, and saves it under
    # <checkpoint_dir>/best/ (inference prefers it; resume keeps using the
    # regular last-step checkpoints). Round-5 measurement: the training
    # endpoint at the quality operating point is a noise draw — seed
    # trajectories pass through >=95% round-trip states but land anywhere
    # from 38% to 96% at the final step; selecting on the held-out probe
    # converts that endpoint lottery into a max over the run's eval points.
    select_best: bool = False
    checkpoint_every: int = 1000
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3

    def __post_init__(self):
        assert self.lr_schedule in ("constant", "cosine", "warmup_cosine")
        assert 0.0 <= self.ema_decay < 1.0, "ema_decay must be in [0, 1)"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    # 'synthetic' (grammar-level random strings) | 'synthetic_chem'
    # (chemically valid molecules, data/molgen.py) | path to .h5/.smi/.csv
    source: str = "synthetic"
    # Property-head targets: 'auto' uses computed structure-level
    # logP/QED/SAS (data/properties.py) when >=50% of the corpus parses
    # chemically, composition surrogates otherwise; 'computed'/'surrogate'
    # force one path (zinc.property_targets).
    property_source: str = "auto"
    n_synthetic: int = 5000
    max_len: int = 120
    test_fraction: float = 0.05
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data_axis: int = 1  # devices along the 'data' axis (DP degree)
    model_axis: int = 1  # reserved: 'model' axis for future TP (SURVEY.md 2)


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    train: TrainConfig = TrainConfig()
    data: DataConfig = DataConfig()
    mesh: MeshConfig = MeshConfig()
    name: str = "default"


# --------------------------------------------------------------------------
# Presets: the five benchmark configs (BASELINE.json:6-12) + parity variant
# --------------------------------------------------------------------------

def chemvae_5k() -> Config:
    """Preset 1: reference ChemVAE on a 5k ZINC subset, batch 64 (CPU-runnable;
    use_pallas engages the fused kernels on TPU - the batch-64 block variant,
    VERDICT r1 weak 2 - and falls back to the jnp path elsewhere).
    compute_dtype='auto' resolves to bf16 on TPU / fp32 on CPU. vs the
    round-4 benched TPU runs (which ran bf16 kernels but fp32 XLA-side
    linears under the then-unhonored 'float32' setting), 'auto' also moves
    the small latent-embed/logit-head XLA matmuls to bf16 (~3% of FLOPs;
    loss/KL/accumulation stay fp32 by design) — re-gated on hardware by
    bench.tpu_validation and the in-bench numerics checks. A strict-fp32
    TPU run is one override away and now means what it says."""
    return Config(
        name="chemvae_5k",
        model=ModelConfig(use_pallas=True, compute_dtype="auto"),
        train=TrainConfig(batch_size=64, epochs=50),
        data=DataConfig(n_synthetic=5000),
    )


def chemvae_ref_faithful() -> Config:
    """Parity variant: every compact-port quirk on (notes A/B, BCE loss,
    1e-2 noise). Used by the PyTorch parity twin to pin numerics."""
    return Config(
        name="chemvae_ref_faithful",
        model=ModelConfig(
            conv_orientation="charset",
            decoder_conditioning="repeat_z",
            recon_loss="bce",
            eps_scale=1e-2,
        ),
        train=TrainConfig(batch_size=64, epochs=50),
        data=DataConfig(n_synthetic=5000),
    )


def zinc250k() -> Config:
    """Preset 2: full ZINC-250k, batch 256, cyclical KL-annealing, bf16 matmuls."""
    return Config(
        name="zinc250k",
        model=ModelConfig(
            compute_dtype="bfloat16",
            use_pallas=True,
            use_pallas_generation=True,  # +53% decode throughput (see field doc)
            learned_start=True,
        ),
        train=TrainConfig(
            batch_size=256,
            epochs=50,
            train_chunk_size=16,
            kl=KLScheduleConfig(kind="cyclical", cycle_steps=8000, ratio=0.5),
        ),
        data=DataConfig(n_synthetic=250_000),
    )


def zinc250k_quality() -> Config:
    """Preset 2b: zinc250k tuned for SEED-ROBUST reconstruction fidelity
    with guaranteed-valid generation (VERDICT r2 next 1; re-centered by
    the round-5 seed study — docs/PERFORMANCE.md "basin lottery").

    Round 4 pinned eps_scale=0.02 / per-layer kernels off a one-seed
    95.7%-round-trip / 96.5%-aggregate-valid measurement. The round-5
    study (~40 seeded runs) showed that operating point is a RUN-LEVEL
    lottery: the decoder either couples to the latent (95-98% held-out
    round-trip) or never does (<10% for the whole run while teacher-forced
    accuracy converges to a deceptive ~91%), and the basin assignment is
    chaotic in both the parameter seed and the data order. Plain seeds
    {0,1,2}: {95.7, 37.8, 53.3}% at 16k, {98.1, 61.9, 84.3} at 48k.
    Gradient clipping, cosine decay, EMA, longer budgets, and
    best-checkpoint selection all fail to make it robust (each measured,
    each with its number in docs/PERFORMANCE.md).

    The one measured robust lever is scheduled sampling: ss=0.25 forces
    molecule identity through z by training the decoder on its own
    free-running prefixes — held-out round-trip {96.5, 97.2, 97.2}% across
    seeds {0,1,2} (exact-match 53-56%), which this preset adopts. Its
    measured cost: the aggregate/prior samplers drop to ~51-75%
    grammar-valid (temperature-insensitive — sweeping T 0.6-1.0 moves it
    <3 points, bench/ss_temp_probe.py), so the preset's documented
    GENERATION path is the valence-constrained sampler
    (`molvax sample --constrained`): 100% chem-valid / ~95% unique /
    ~100% novel in every run of the study, by construction. A
    generation-first user who prefers the aggregate sampler's 96-99%
    grammar validity can drop ss (`--override train.scheduled_sampling=0`)
    and accept the reconstruction lottery — the two axes do not currently
    meet robustly in one set of weights at this scale (measured, not
    assumed).

    Also on for this preset:
      * per-layer GRU kernels (round-4 finding: the fused stack's bf16
        cross-layer numerics flip outcomes at this boundary — same seed
        95.7% per-layer vs 21% stack; stack seeds {21, 78, 4}%);
      * the free-running round-trip probe + best-iterate selection
        (eval_roundtrip_n/select_best): the probe makes the coupling
        failure visible DURING training (teacher-forced metrics cannot
        see it), and selection returns the best probed iterate, guarding
        the endpoint against late loss spikes;
      * the posterior-collapse guard (round 4's failure mode at this
        boundary: post_std collapsing to ~0.015) — checkpoints and aborts
        instead of burning the budget;
      * free bits, to keep the KL term meaningful at small eps; the
        learned start token anchors step 0.
    `zinc250k` stays the pure teacher-forced production trainer the
    benchmarks compare against."""
    cfg = zinc250k()
    return dataclasses.replace(
        cfg,
        name="zinc250k_quality",
        model=dataclasses.replace(
            cfg.model, eps_scale=0.02, gru_kernel="per_layer"
        ),
        train=dataclasses.replace(
            cfg.train,
            kl=dataclasses.replace(cfg.train.kl, free_bits=0.1),
            scheduled_sampling=0.25,
            collapse_std_floor=0.05,
            collapse_guard_after=2000,
            eval_every=2000,
            eval_batches=1,
            eval_roundtrip_n=256,
            select_best=True,
        ),
    )


def property_joint() -> Config:
    """Preset 3: joint logP/QED/SAS regression head on z, multi-task ELBO.

    Trains on the chemically-valid corpus so the targets are the computed
    structure-level logP/QED/SAS (data/properties.py via
    zinc.property_targets 'auto'), not composition surrogates — and
    latent-space optimization can be scored by re-computing the property
    on decoded molecules (evaluate.optimization_metrics)."""
    cfg = zinc250k()  # the measured-good training recipe (kernels, bf16,
    #                   learned start, cyclical KL) — property work rides it
    return dataclasses.replace(
        cfg,
        name="property_joint",
        model=dataclasses.replace(cfg.model, n_properties=3, eps_scale=0.03),
        train=dataclasses.replace(
            cfg.train,
            property_loss_weight=1.0,
            kl=dataclasses.replace(cfg.train.kl, free_bits=0.1),
        ),
        data=dataclasses.replace(cfg.data, source="synthetic_chem"),
    )


def moses_scaled() -> Config:
    """Preset 4: scaled decoder (4x GRU-1024, latent-512), MOSES 1.9M,
    data-parallel v5e-8."""
    return Config(
        name="moses_scaled",
        model=ModelConfig(
            latent_dim=512,
            gru_hidden=1024,
            gru_layers=4,
            enc_hidden=512,
            compute_dtype="bfloat16",
            use_pallas=True,
            use_pallas_generation=True,
        ),
        train=TrainConfig(
            batch_size=2048,  # global; 256/chip on v5e-8
            epochs=10,
            train_chunk_size=16,
            kl=KLScheduleConfig(kind="cyclical", cycle_steps=20000),
        ),
        data=DataConfig(n_synthetic=1_900_000),
        mesh=MeshConfig(data_axis=8),
    )


def latent_workloads() -> Config:
    """Preset 5: batched prior sampling, slerp interpolation, gradient-based
    property optimization in z (inference workloads on a trained model)."""
    return Config(
        name="latent_workloads",
        model=ModelConfig(n_properties=3),
        train=TrainConfig(batch_size=256, epochs=5),
        data=DataConfig(n_synthetic=50_000, source="synthetic_chem"),
    )


def gvae_zinc() -> Config:
    """Port-only preset: the Grammar VAE at its published ZINC widths
    (Kusner et al. 2017, arXiv:1703.01925; its code's models/model_zinc.py
    and train_zinc.py). A molecule is the leftmost derivation of its SMILES
    in the 76-rule ZINC grammar, padded to 277 steps with the padding rule
    (data/grammar.py); Conv1D 9/9/10 filters of kernels 9/9/11 and a dense
    435 with ReLU, latent 56 at epsilon_std 0.01; Dense(56, ReLU) on z
    repeated over the steps into 3 x GRU-501 and a dense head over the 76
    rules; the grammar-masked softmax as the likelihood (a categorical ELBO
    with a constant KL weight of 1); batch 500. Decoding is the pushdown
    walk over one non-autoregressive pass of logits
    (kernels/grammar_walk.py). The corpus is the offline chemistry corpus
    (ZINC itself is not in the repository)."""
    return Config(
        name="gvae_zinc",
        model=ModelConfig(
            max_len=277,
            charset_size=76,
            latent_dim=56,
            enc_hidden=435,
            gru_hidden=501,
            gru_layers=3,
            decoder_conditioning="repeat_z",
            recon_loss="ce",
            eps_scale=0.01,
            compute_dtype="bfloat16",
            use_pallas=True,
            alphabet="zinc_grammar",
            dense_activation="relu",
        ),
        train=TrainConfig(
            batch_size=500,
            epochs=100,
            train_chunk_size=16,
            kl=KLScheduleConfig(kind="constant", beta_max=1.0),
        ),
        data=DataConfig(source="synthetic_chem", n_synthetic=250_000, max_len=277),
    )


PRESETS = {
    f.__name__: f
    for f in (
        chemvae_5k,
        chemvae_ref_faithful,
        zinc250k,
        zinc250k_quality,
        property_joint,
        moses_scaled,
        latent_workloads,
        gvae_zinc,
    )
}


def get_preset(name: str) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]()


# the port's own ModelConfig fields and their defaults
PORT_ONLY_DEFAULTS = {"alphabet": "charset", "dense_activation": "selu"}


def to_dict(cfg: Config) -> dict:
    """Config -> plain JSON-serializable dict (tuples become lists). A
    port-only field appears only where it differs from its default, so a
    character config's dict is the reference's (its ``from_dict`` reads
    it; ``from_dict`` here fills a missing one with its default)."""
    d = dataclasses.asdict(cfg)
    for field, default in PORT_ONLY_DEFAULTS.items():
        if d["model"][field] == default:
            del d["model"][field]
    return d


def from_dict(d: dict) -> Config:
    """Inverse of to_dict (lists that landed on tuple fields are converted)."""
    model = dict(d["model"])
    for k in ("conv_channels", "conv_kernels"):
        model[k] = tuple(model[k])
    for k in ("property_mean", "property_std"):
        if model.get(k) is not None:
            model[k] = tuple(model[k])
    train = dict(d["train"])
    train["kl"] = KLScheduleConfig(**train["kl"])
    return Config(
        model=ModelConfig(**model),
        train=TrainConfig(**train),
        data=DataConfig(**d["data"]),
        mesh=MeshConfig(**d["mesh"]),
        name=d.get("name", "default"),
    )


def apply_overrides(cfg: Config, overrides: dict) -> Config:
    """Dotted-path overrides: {'train.batch_size': 128, 'model.use_pallas': True}."""
    for path, value in overrides.items():
        parts = path.split(".")
        objs = [cfg]
        for p in parts[:-1]:
            objs.append(getattr(objs[-1], p))
        new = value
        for obj, field in zip(reversed(objs), reversed(parts)):
            new = dataclasses.replace(obj, **{field: new})
        cfg = new
    return cfg
