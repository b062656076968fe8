"""Data-parallel latent workloads on the CPU (gloo ranks), the counterpart of
``tests/distributed/test_latent_mesh.py``: ``sample_prior``,
``sample_aggregate``, ``encode_corpus`` and ``decode_latents`` with
``mesh=`` against the 1-rank calls (the strings identical, the encodes
within 1e-5), with the reference's divisibility ``ValueError``s; and the
global-row noise under them: ``sample_eps``, ``bernoulli_mask``,
``gumbel_noise``, the plain sampler and the plain decode at ``row_base=k``
equal rows k.. of the full call, and the generation wrapper's launches
(replaced by its plain pieces) handing the kernels the row base."""

import numpy as np
import pytest
import torch

from molvax_torch import config as tconfig
from molvax_torch.data import synthetic_dataset
from molvax_torch.data.charset import DEFAULT_CHARSET
from molvax_torch.data.featurize import decode_codes
from molvax_torch.kernels import generate as kg
from molvax_torch.kernels import sampler
from molvax_torch.latent import decode_latents, encode_corpus, sample_aggregate, sample_prior
from molvax_torch.nn.decoder import latent_embed
from molvax_torch.nn.vae import MolecularVAE, bernoulli_mask
from molvax_torch.parallel import make_mesh
from test_torch_parallel import run_ranks

T = 32
WORLD = 2
N = 16


def _model(seed: int = 3, **kw):
    cfg = tconfig.ModelConfig(max_len=T, charset_size=DEFAULT_CHARSET.size, latent_dim=8, enc_hidden=12,
                              gru_hidden=16, gru_layers=2, learned_start=True, **kw)
    torch.manual_seed(seed)
    model = MolecularVAE(cfg, device="cpu")
    with torch.no_grad():
        model.start_token.normal_()
    return cfg, model


def _gen(seed: int = 7) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _calls(mesh, cfg, model, smiles, mean, chol):
    """Every workload once, with ``mesh`` (None: the 1-rank calls)."""
    out = {
        "prior": sample_prior(model, cfg, N, _gen(), mesh=mesh),
        "prior_T07": sample_prior(model, cfg, N, _gen(), greedy=False, temperature=0.7, mesh=mesh),
        "prior_constrained": sample_prior(model, cfg, N, _gen(), greedy=False, temperature=0.7, constrained=True,
                                          mesh=mesh),
        "aggregate": sample_aggregate(model, cfg, N, _gen(), mean, chol, greedy=False, mesh=mesh),
        "encode": encode_corpus(model, cfg, smiles, batch=8, mesh=mesh),
    }
    mu = out["encode"][0]
    out["decode"] = decode_latents(model, cfg, mu, batch=8, mesh=mesh)
    out["decode_T07"] = decode_latents(model, cfg, mu, _gen(), batch=8, greedy=False, temperature=0.7, mesh=mesh)
    out["decode_beam"] = decode_latents(model, cfg, mu[:6], batch=4, beam=3, mesh=mesh)
    return out


def _latent_worker(rank: int, world: int, smiles, mean, chol) -> dict:
    cfg, model = _model()
    mesh = make_mesh(device="cpu")
    out = _calls(mesh, cfg, model, smiles, mean, chol)
    errors = []
    for fn in (lambda: sample_prior(model, cfg, 15, _gen(), mesh=mesh),
               lambda: encode_corpus(model, cfg, smiles, batch=7, mesh=mesh),
               lambda: decode_latents(model, cfg, out["encode"][0], batch=7, mesh=mesh)):
        try:
            fn()
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


@pytest.fixture(scope="module")
def latent(tmp_path_factory):
    ds = synthetic_dataset(64, max_len=T, seed=3)
    smiles = decode_codes(ds.codes[:19], ds.charset)  # 19 rows: a ragged last chunk of 3
    rng = np.random.default_rng(0)
    mean = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    chol = torch.from_numpy(np.tril(rng.standard_normal((8, 8))).astype(np.float32) * 0.5)
    ranks = run_ranks(tmp_path_factory.mktemp("latent"), WORLD, _latent_worker, smiles, mean, chol)
    cfg, model = _model()
    return ranks, _calls(None, cfg, model, smiles, mean, chol)


@pytest.mark.parametrize("name", ["prior", "prior_T07", "prior_constrained", "aggregate", "decode", "decode_T07",
                                  "decode_beam"])
def test_mesh_strings_equal_the_one_rank_strings(latent, name):
    ranks, one = latent
    assert len(one[name]) in (N, 19, 6)
    for out in ranks:
        assert out[name] == one[name]


def test_mesh_encode_equals_the_one_rank_encode(latent):
    ranks, one = latent
    for out in ranks:
        for got, want in zip(out["encode"], one["encode"]):
            assert got.shape == want.shape == (19, 8)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_mesh_divisibility_errors(latent):
    ranks, _ = latent
    for out in ranks:
        assert out["errors"] == ["batch 15 not divisible by mesh data axis 2"] + \
            ["batch 7 not divisible by mesh data axis 2"] * 2


# -- global-row noise --------------------------------------------------------------


@pytest.mark.parametrize("k", [0, 5, 128])
def test_row_offset_noise_is_the_full_calls_rows(k):
    """Each plain draw at row_base=k equals rows k.. of the call over all
    rows, bit for bit; the seed as an int or a device tensor alike."""
    full = 160
    seed_t = torch.full((), 11, dtype=torch.int32)
    for seed in (11, seed_t):
        assert torch.equal(sampler.sample_eps(seed, 16, 12, "cpu", row_base=k),
                           sampler.sample_eps(seed, full, 12, "cpu")[k:k + 16])
        assert torch.equal(bernoulli_mask(seed, 0xD409, 0.3, (16, 20), "cpu", row_base=k),
                           bernoulli_mask(seed, 0xD409, 0.3, (full, 20), "cpu")[k:k + 16])
    assert torch.equal(kg.gumbel_noise(11, 4, 16, 37, "cpu", row_base=k),
                       kg.gumbel_noise(11, 4, full, 37, "cpu")[k:k + 16])
    mu, lv = torch.randn(full, 12), torch.randn(full, 12)
    z, kl = sampler.fused_sample_kl_ref(seed_t, mu[k:k + 16], lv[k:k + 16], 0.5, row_base=k)
    z_all, kl_all = sampler.fused_sample_kl_ref(seed_t, mu, lv, 0.5)
    assert torch.equal(z, z_all[k:k + 16]) and torch.equal(kl, kl_all[k:k + 16])
    # the autograd wrapper takes the plain version on the CPU, with the row base
    z_w, kl_w = sampler.fused_sample_kl(seed_t, mu[k:k + 16], lv[k:k + 16], 0.5, k)
    assert torch.equal(z_w, z) and torch.equal(kl_w, kl)


def _decoder(seed: int = 7):
    cfg, model = _model(seed, compute_dtype="bfloat16")
    z = torch.from_numpy(np.random.default_rng(seed).standard_normal((48, cfg.latent_dim)).astype(np.float32))
    with torch.no_grad():
        return cfg, model, latent_embed(model, cfg, z)


@pytest.mark.parametrize("k", [0, 16])
def test_row_offset_decode_is_the_full_decodes_rows(k):
    """The plain decode sampled at row_base=k on rows k.. equals those rows
    of the decode of all rows, bit for bit (greedy ignores the base)."""
    cfg, model, z_emb = _decoder()
    full = kg.fused_generate_ref(model, cfg, z_emb, 5, greedy=False, temperature=0.7)
    part = kg.fused_generate_ref(model, cfg, z_emb[k:k + 16], 5, greedy=False, temperature=0.7, row_base=k)
    assert torch.equal(part, full[k:k + 16])
    assert torch.equal(kg.fused_generate(model, cfg, z_emb[k:k + 16], 5, greedy=False, temperature=0.7, row_base=k),
                       part)


@pytest.mark.parametrize("row_block", [False, True])
def test_the_wrapper_hands_each_instance_the_row_base(row_block, monkeypatch):
    """``_decode`` on the CPU with each launch recorded: the persistent and
    the row-block instance receive the row base as their last scalar."""
    cfg, model, z_emb = _decoder()
    seen = []

    def persistent(*args):
        seen.append(("persistent", args[-1]))
        args[5][args[7]:args[8]] = kg.fused_generate_ref(model, cfg, z_emb[args[7]:args[8]], args[13], args[12],
                                                         args[14], row_base=args[-1] + args[7])

    def row_block_(*args):
        seen.append(("row_block", args[-1]))
        args[4].copy_(kg.fused_generate_ref(model, cfg, z_emb, args[9], args[8], args[10], row_base=args[-1]))

    monkeypatch.setattr(kg, "_launch_persistent", persistent)
    monkeypatch.setattr(kg, "_launch_row_block", row_block_)
    monkeypatch.setattr(kg, "card_limits", lambda device: (kg.SMS, kg.SMEM))
    got = kg._decode(model, cfg, z_emb, 5, False, 0.7, row_block=row_block, row_base=40)
    assert seen == [("row_block" if row_block else "persistent", 40)]
    assert torch.equal(got, kg.fused_generate_ref(model, cfg, z_emb, 5, greedy=False, temperature=0.7, row_base=40))
