"""The fused encoder's conv stages (``csrc/conv_enc.cuh``) on the CPU, and
what the encoder and sampler wrappers hand their kernels.

The kernel's phase A runs a warp per batch row: the first conv as a gather
by the codes, the later convs on the tensor cores, the last stage flushed
as bf16 in NCH order. ``csrc/conv_enc.cuh`` writes that once over lanes,
with ``mma.sync`` emulated over the 32 lanes' fragments in host C++;
``csrc/conv_enc_host.cpp`` drives the same row function. It is built here
with g++ into ``build/conv_enc_host/`` (keyed by a hash of the sources, to a
temporary file ``os.replace``d into place under an exclusive lock, so xdist
workers build it once) and held to the plain encoder's conv stages, stage
by stage, in both orientations, with out-of-range codes. The kernel's
layout is held to the card's shared memory at every preset's widths. The
wrappers are run on the CPU with the launch recorded: they hand the kernels
the model's own parameters and codes, and make nothing but their outputs
and scratch. No JAX; the plain versions are held to the reference in
``test_torch_encode_kernel.py`` and ``test_torch_sampler.py``, the CUDA
build to the plain versions on the card by ``chip_smoke.py``.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from molvax_torch.config import ModelConfig, get_preset
from molvax_torch.data.featurize import one_hot
from molvax_torch.kernels import _build, conv_enc, gru_stack, sampler
from molvax_torch.nn.encoder import conv_input_channels, encoder_params, flat_conv_dim
from molvax_torch.nn.vae import MolecularVAE

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "molvax_torch" / "kernels" / "csrc"
BUILD = ROOT / "build" / "conv_enc_host"
FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC", "-Wall", "-Wno-unknown-pragmas")
SMEM = gru_stack.SMEM  # an H100's shared memory a block (232,448 B)


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in ("conv_enc.cuh", "conv_enc_host.cpp"):
        h.update((CSRC / name).read_bytes())
    return BUILD / f"libconv_enc_host_{h.hexdigest()[:16]}.so"


@pytest.fixture(scope="module")
def host():
    """The conv stages built for the host, with ctypes signatures."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the conv stages' host build needs it")
    path = _library_path()
    BUILD.mkdir(parents=True, exist_ok=True)
    with open(BUILD / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not path.exists():
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
                os.close(fd)
                try:
                    subprocess.run(["g++", *FLAGS, "-o", tmp, str(CSRC / "conv_enc_host.cpp")], check=True,
                                   capture_output=True, text=True)
                    os.replace(tmp, path)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.molvax_encode_layout_host.argtypes = [i, p, p, i, i, i, i, i, i, i, i, ctypes.c_longlong, p]
    lib.molvax_encode_conv_host.argtypes = [p, i, p, p, i, p, p, i, i, i, i, i, p]
    return lib


def _ints(values):
    return (ctypes.c_int * len(values))(*values)


def layout(lib, cfg: ModelConfig, B: int, smem: int = SMEM, grid: int = gru_stack.SMS, code_size: int = 8) -> dict:
    out = (ctypes.c_longlong * 12)()
    n = len(cfg.conv_channels)
    assert lib.molvax_encode_layout_host(n, _ints(cfg.conv_channels), _ints(cfg.conv_kernels), cfg.max_len,
                                         cfg.charset_size, int(cfg.conv_orientation == "seq"), B, cfg.enc_hidden,
                                         cfg.latent_dim, grid, code_size, smem, out) == 0
    keys = ("ok", "smem", "smem_conv", "smem_dense", "smem_head", "pre_dense", "F", "Fp", "Ep", "tiles_dense",
            "tiles_head", "team")
    return dict(zip(keys, out))


def host_conv(lib, cfg: ModelConfig, codes: torch.Tensor, weights, biases, stages: int, team: int = 1) -> torch.Tensor:
    """The first ``stages`` convs through the host build, by teams of
    ``team`` warps: h (B, F) fp32 from the bf16 bits it flushed, NCH
    order."""
    ch, ks = cfg.conv_channels[:stages], cfg.conv_kernels[:stages]
    width = cfg.max_len if cfg.conv_orientation == "seq" else cfg.charset_size
    width -= sum(k - 1 for k in ks)
    F_, B = ch[-1] * width, codes.shape[0]
    Fp = -(-F_ // 16) * 16
    h3 = torch.full((B, Fp), 0x7FC0, dtype=torch.int16)  # NaN bits: every element must be written
    ws = (ctypes.c_void_p * stages)(*(w.data_ptr() for w in weights[:stages]))
    bs = (ctypes.c_void_p * stages)(*(b.data_ptr() for b in biases[:stages]))
    assert lib.molvax_encode_conv_host(codes.data_ptr(), conv_enc.CODE_KINDS[codes.dtype], ws, bs, stages,
                                       _ints(ch), _ints(ks), cfg.max_len, cfg.charset_size,
                                       int(cfg.conv_orientation == "seq"), B, team, h3.data_ptr()) == 0
    h = (h3.to(torch.int32) << 16).view(torch.float32)
    assert torch.equal(h[:, F_:], torch.zeros(B, Fp - F_)), "the padding of h3 is not zero"
    return h[:, :F_]


def plain_conv(cfg: ModelConfig, codes: torch.Tensor, weights, biases, stages: int) -> torch.Tensor:
    """The plain encoder's conv stages (``nn.encoder.encode_with``) in bf16:
    operands rounded to bf16, fp32 sums, the output rounded to bf16 as the
    next product rounds it, flattened channel-major."""
    bf = torch.bfloat16
    x = one_hot(codes.long(), cfg.charset_size)
    h = x.transpose(1, 2) if cfg.conv_orientation == "seq" else x
    for w, b in list(zip(weights, biases))[:stages]:
        h = F.relu(F.conv1d(h.to(bf).float(), w.to(bf).float()) + b[None, :, None])
    return h.to(bf).float().reshape(h.shape[0], -1)


def _weights(cfg: ModelConfig, seed: int):
    g = torch.Generator().manual_seed(seed)
    weights, biases, cin = [], [], conv_input_channels(cfg)
    for cout, k in zip(cfg.conv_channels, cfg.conv_kernels):
        s = 1.0 / (cin * k) ** 0.5
        weights.append(((2 * torch.rand(cout, cin, k, generator=g) - 1) * s).contiguous())
        biases.append(((2 * torch.rand(cout, generator=g) - 1) * s).contiguous())
        cin = cout
    return weights, biases


def _codes(cfg: ModelConfig, B: int, dtype, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, cfg.charset_size, (B, cfg.max_len))
    codes[0, cfg.max_len // 2 :] = 0  # a padded tail
    return torch.from_numpy(codes).to(dtype).contiguous()


ZINC = get_preset("zinc250k").model
SHAPES = {
    "zinc250k": ZINC,
    "zinc250k_charset": ModelConfig(conv_orientation="charset"),  # chemvae_ref_faithful's stack, F = 110
    # 4 convs, an odd first width, channels past one block of 16, an n8
    # tile beyond the last pair, a single m16 tile
    "ragged": ModelConfig(max_len=40, charset_size=23, conv_channels=(17, 5, 24, 3), conv_kernels=(3, 4, 2, 5)),
    "ragged_charset": ModelConfig(max_len=21, charset_size=30, conv_channels=(33, 8), conv_kernels=(6, 7),
                                  conv_orientation="charset"),
    "one_conv": ModelConfig(max_len=16, charset_size=11, conv_channels=(6,), conv_kernels=(4,)),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("dtype,team", [(torch.uint8, 1), (torch.int64, 2), (torch.int64, 4), (torch.int32, 8)])
def test_conv_stages_match_the_plain_encoder(host, name, dtype, team):
    """Each stage of the host build, its work split over a team of 1, 2, 4
    or 8 warps, against the plain conv stack cut after it: every element
    within one bf16 step of the plain value (a sum next to a rounding
    boundary may round the other way, in another order), and almost all of
    them identical."""
    cfg = SHAPES[name]
    weights, biases = _weights(cfg, seed=len(name))
    codes = _codes(cfg, 5, dtype, seed=3)
    for stages in range(1, len(cfg.conv_channels) + 1):
        got = host_conv(host, cfg, codes, weights, biases, stages, team)
        want = plain_conv(cfg, codes, weights, biases, stages)
        scale = want.abs().max().item()
        assert scale > 0
        err = (got - want).abs().max().item()
        same = (got == want).float().mean().item()
        assert err <= 2 ** -7 * scale, (name, stages, err, scale)
        assert same >= 0.98, (name, stages, same)


@pytest.mark.parametrize("orientation", ["seq", "charset"])
def test_codes_outside_the_charset_give_zero_rows(host, orientation):
    """A code outside [0, C) adds nothing to the first conv, as
    jax.nn.one_hot's zero row; int64 codes beyond the int range too."""
    cfg = ModelConfig(max_len=24, charset_size=13, conv_channels=(7, 5), conv_kernels=(4, 3),
                      conv_orientation=orientation)
    weights, biases = _weights(cfg, seed=9)
    codes = _codes(cfg, 4, torch.int64, seed=5)
    codes[1, 3] = cfg.charset_size
    codes[1, 9] = -1
    codes[2, :5] = 2 ** 40
    codes[3, :] = -7
    for stages in (1, 2):
        got = host_conv(host, cfg, codes, weights, biases, stages)
        zeroed = codes.clone()
        zeroed[(codes < 0) | (codes >= cfg.charset_size)] = -1  # one_hot(-1) below: a zero row
        x = torch.zeros(4, cfg.max_len, cfg.charset_size)
        ok = zeroed >= 0
        x[ok] = F.one_hot(zeroed[ok], cfg.charset_size).float()
        h = x.transpose(1, 2) if orientation == "seq" else x
        for w, b in list(zip(weights, biases))[:stages]:
            h = F.relu(F.conv1d(h.to(torch.bfloat16).float(), w.to(torch.bfloat16).float()) + b[None, :, None])
        want = h.to(torch.bfloat16).float().reshape(4, -1)
        assert (got - want).abs().max().item() <= 2 ** -7 * want.abs().max().item()
    # a row of codes all outside the charset is the biases alone, through the stack
    first = host_conv(host, cfg, codes[3:], weights, biases, 1)
    width = cfg.max_len - 3 if orientation == "seq" else cfg.charset_size - 3
    assert torch.equal(first, torch.relu(biases[0]).to(torch.bfloat16).float().repeat_interleave(width)[None])


PRESETS = ["zinc250k", "zinc250k_quality", "chemvae_5k", "chemvae_ref_faithful", "moses_scaled", "property_joint"]


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("B", [1, 6, 33, 64, 256])
def test_layout_fits_the_card_at_every_preset(host, preset, B):
    """One block of the kernel fits an H100's shared memory at every preset
    that runs the encoder, both orientations, with the first dense tile's
    W_0 copied during the conv stack; the tiles take one pass of 132 blocks
    at B=256 (zinc250k width: 112 dense and 120 head tiles)."""
    cfg = get_preset(preset).model
    for orientation in ("seq", "charset"):
        c = ModelConfig(**{**cfg.__dict__, "conv_orientation": orientation})
        lay = layout(host, c, B)
        F_ = flat_conv_dim(c)
        assert lay["ok"] == 1 and lay["smem"] <= SMEM, (preset, orientation, lay)
        assert lay["smem"] >= max(lay["smem_conv"], lay["smem_dense"], lay["smem_head"]) and lay["pre_dense"] == 1
        assert (lay["F"], lay["Fp"], lay["Ep"]) == (F_, -(-F_ // 16) * 16, -(-c.enc_hidden // 8) * 8)
        assert lay["tiles_dense"] == -(-B // 32) * -(-c.enc_hidden // 32)
        assert lay["tiles_head"] == -(-B // 32) * -(-2 * c.latent_dim // 40)
        assert lay["team"] == {1: 8, 6: 8, 33: 8, 64: 8, 256: 4}[B]  # a block's rows share its 8 warps
    if preset == "zinc250k" and B == 256:
        assert (lay["tiles_dense"], lay["tiles_head"]) == (112, 120)
        assert layout(host, c, B, grid=114)["team"] == 2
        big = layout(host, ZINC, 2048)  # a warp a row: eight teams' buffers leave no room to copy W_0 early
        assert big["team"] == 1 and big["ok"] == 1 and big["pre_dense"] == 0


@pytest.mark.parametrize("B", [1, 64, 500])
def test_layout_fits_gvae_zinc_with_its_dense_rows_in_chunks(host, B):
    """gvae_zinc's encoder (T=277, C=76: F = 2,510, whose W_0 rows for a
    dense tile take 321 KB whole) fits an H100 block with W_0 staged in
    chunks of columns, at its training batch of 500 too; the batch's
    teams of warps are those of any other config, and the tiles one
    pass's count."""
    cfg = get_preset("gvae_zinc").model
    lay = layout(host, cfg, B)
    assert lay["ok"] == 1 and lay["smem"] <= SMEM and lay["pre_dense"] == 0, lay
    assert lay["smem_dense"] < 32 * 2510 * 4, lay  # W_0's tile rows are not staged whole
    assert (lay["F"], lay["Fp"]) == (2510, 2512) and lay["team"] == {1: 8, 64: 8, 500: 2}[B]
    assert lay["tiles_dense"] == -(-B // 32) * -(-cfg.enc_hidden // 32)


def test_no_layout_where_the_card_has_too_little_shared_memory(host):
    """A stack whose staged weights outgrow the card has no layout, nor a
    dense layer whose rows do; the wrapper raises for both (below)."""
    wide = ModelConfig(conv_channels=(9, 512, 10), conv_kernels=(9, 9, 11))
    assert layout(host, wide, 256)["ok"] == 0
    long_rows = ModelConfig(max_len=400, conv_channels=(9, 9, 10))  # F = 3,740
    assert layout(host, long_rows, 256)["ok"] == 0
    # a card with less shared memory than the head phase's 127,504 bytes (the
    # dense phase fits in less, its W_0 staged in chunks of columns)
    assert layout(host, ZINC, 256, smem=120_000)["ok"] == 0


class _Ops(TorchDispatchMode):
    """The aten ops a call runs."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _record_launch(monkeypatch, ret: int = 0):
    """The kernels' C entry points replaced by a recorder of their
    arguments; the device checks and the stream let CPU tensors through."""
    calls = []

    def function(name, argtypes):
        def fn(*args):
            calls.append((name, args))
            return ret

        return fn

    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(gru_stack, "_stream", lambda t: 1234)
    monkeypatch.setattr(conv_enc, "_check_device", lambda codes, params: None)
    monkeypatch.setattr(sampler, "_check_device", lambda mu, logvar: None)
    return calls


def _pointers(array) -> list:
    return [array[i] for i in range(len(array))]


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.int64])
def test_encoder_wrapper_hands_the_kernel_the_models_own_tensors(monkeypatch, dtype):
    """The wrapper launches on the module's own fp32 parameters and the
    codes in their own type: no cast, copy, transpose or cat; the only ops
    it runs are the three allocations of mu, logvar and the scratch."""
    cfg = ZINC
    model = MolecularVAE(cfg, device="cpu")
    codes = _codes(cfg, 6, dtype, seed=1)
    calls = _record_launch(monkeypatch)
    params = encoder_params(model)
    before = conv_enc.launches
    with _Ops() as ops:
        mu, logvar = conv_enc._encode_kernel(cfg, codes, params)
    assert ops.ops == ["aten.empty.memory_format"] * 3
    assert conv_enc.launches == before + 1 and len(calls) == 1
    name, args = calls[0]
    assert name == "molvax_fused_encode"
    n = len(cfg.conv_channels)
    assert args[0] == codes.data_ptr() and args[1] == conv_enc.CODE_KINDS[dtype]
    assert _pointers(args[2]) == [params[2 * i].data_ptr() for i in range(n)]
    assert _pointers(args[3]) == [params[2 * i + 1].data_ptr() for i in range(n)]
    assert args[4] == n and _pointers(args[5]) == list(cfg.conv_channels) and _pointers(args[6]) == list(cfg.conv_kernels)
    assert list(args[7:13]) == [p.data_ptr() for p in params[2 * n :]]
    assert args[13:15] == (mu.data_ptr(), logvar.data_ptr())
    assert mu.shape == logvar.shape == (6, cfg.latent_dim) and mu.dtype == torch.float32
    B, T, C, seq, E, Lz, relu, sms, smem = args[16:25]
    assert (B, T, C, seq, E, Lz, relu) == (6, cfg.max_len, cfg.charset_size, 1, cfg.enc_hidden, cfg.latent_dim, 0)
    assert (sms, smem) == gru_stack.plan_limits("cpu") and args[25] == 1234
    assert conv_enc.scratch_bytes(cfg, 6) == 6 * 944 * 2 + 6 * 440 * 4


def test_encoder_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    cfg = ZINC
    model = MolecularVAE(cfg, device="cpu")
    params = encoder_params(model)
    _record_launch(monkeypatch, ret=conv_enc.NO_LAYOUT)
    before = conv_enc.launches
    with pytest.raises(ValueError, match="no layout"):
        conv_enc._encode_kernel(cfg, _codes(cfg, 2, torch.int64, 0), params)
    with pytest.raises(ValueError, match="integer tensor"):
        conv_enc._encode_kernel(cfg, _codes(cfg, 2, torch.float32, 0), params)
    with pytest.raises(ValueError, match="contiguous fp32"):
        conv_enc._encode_kernel(cfg, _codes(cfg, 2, torch.int64, 0), [p.to(torch.bfloat16) for p in params])
    wide = ModelConfig(conv_channels=(3,) * 9, conv_kernels=(3,) * 9)
    with pytest.raises(ValueError, match="1 to 8"):
        conv_enc._encode_kernel(wide, _codes(wide, 2, torch.int64, 0), params)
    assert conv_enc.launches == before


def test_sampler_wrapper_hands_the_kernel_its_inputs(monkeypatch):
    """The sampler's wrapper hands the kernel mu and logvar themselves, the
    address of the seed on the device (the kernel reads its low 32 bits:
    2**33 + 5 is seed 5 to it and to the plain version), and allocates z
    and kl, nothing else; it refuses what is not contiguous fp32 rather
    than copying it, and a seed that is not a one-element integer tensor."""
    calls = _record_launch(monkeypatch)
    mu, lv = torch.randn(6, 292), torch.randn(6, 292)
    seed = torch.full((), 2 ** 33 + 5, dtype=torch.int64)
    before = sampler.launches
    with _Ops() as ops:
        z, kl = sampler._sample_kernel(seed, mu, lv, 0.5)
    assert ops.ops == ["aten.empty.memory_format"] * 2
    name, args = calls[0]
    assert name == "molvax_fused_sample_kl" and sampler.launches == before + 1
    assert args == (mu.data_ptr(), lv.data_ptr(), z.data_ptr(), kl.data_ptr(), 6, 292, seed.data_ptr(), 0.5, 0, 1234)
    assert z.shape == (6, 292) and kl.shape == (6,)
    for a, b in zip(sampler.fused_sample_kl_ref(seed, mu, lv, 0.5), sampler.fused_sample_kl_ref(5, mu, lv, 0.5)):
        assert torch.equal(a, b)
    one = torch.ones((), dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous fp32"):
        sampler._sample_kernel(one, mu.t(), lv.t(), 1.0)
    with pytest.raises(ValueError, match="contiguous fp32"):
        sampler._sample_kernel(one, mu.double(), lv.double(), 1.0)
    for bad in (1, torch.ones(()), torch.ones(2, dtype=torch.int32)):
        with pytest.raises(ValueError, match="one-element int32 or int64 tensor"):
            sampler._sample_kernel(bad, mu, lv, 1.0)
    assert sampler.launches == before + 1


def test_sampler_kernel_is_a_warp_per_row():
    """The sampler's KL is a shuffle reduction inside the row's warp: no
    shared memory, no block barrier."""
    src = (CSRC / "sampler.cu").read_text()
    body = src.split("fused_sample_kl_kernel(")[1].split("}  // namespace")[0]
    assert "__shfl_xor_sync" in body and "__syncthreads" not in body and "__shared__" not in body


def test_encoder_probe_variants_apply_to_the_kernel_source():
    """Each variant of probes/stack_probe.py's ENC_VARIANTS, and each clock
    stamp of its TIMELINE, finds the text it replaces in the encoder's and
    the sampler's sources exactly once (the timeline's in turn, the
    timeline-only variant after them)."""
    from molvax_torch.probes import stack_probe

    texts = {f: (CSRC / f).read_text() for f in stack_probe.ENC_SOURCES}
    stamped = dict(texts)
    for f, old, new in stack_probe.TIMELINE + stack_probe.TIMELINE_WARM:
        assert stamped[f].count(old) == 1, old
        stamped[f] = stamped[f].replace(old, new)
    for name, subs in stack_probe.ENC_VARIANTS.items():
        base = stamped if name == "smem_chase" else texts
        for f, old, new in subs:
            assert base[f].count(old) == 1, (name, old)
    assert stack_probe.ENC_VARIANTS["base"] == []
