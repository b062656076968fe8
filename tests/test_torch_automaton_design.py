"""The automaton kernel's warp program (``csrc/automaton.cuh``) on the CPU.

The kernel runs a warp per row: its mask, selection and transition are
written once as lane pieces over the warp primitives (ballot, shuffle,
reductions, match, syncwarp), which the header also defines as host C++
that runs the 32 lanes one after another. ``csrc/automaton_host.cpp``
drives that program row by row through the same row functions the CUDA
kernels call; it is built here with g++ into ``build/automaton_host/``
(keyed by a hash of the sources, to a temporary file ``os.replace``d into
place under an exclusive lock, so concurrent xdist workers build it once)
and held bit for bit to ``auto_step_plain``, ``auto_mask_plain`` and
``auto_advance_plain`` of ``kernels/automaton.py``: masks, codes and packed
state. No JAX; the plain versions are held to the reference in
``test_torch_automaton.py`` and ``test_torch_constrain.py``, and the CUDA
build itself to the plain versions on the card by ``chip_smoke.py``.
"""

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from molvax_torch.data.charset import DEFAULT_CHARSET
from molvax_torch.data.featurize import encode_smiles
from molvax_torch.kernels import automaton as ka
from molvax_torch.latent import constrain as kc

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "molvax_torch" / "kernels" / "csrc"
BUILD = ROOT / "build" / "automaton_host"
FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC", "-Wall", "-Wno-unknown-pragmas")
ITAB = ka.pack_tables(kc.build_tables(DEFAULT_CHARSET))
C = ITAB.shape[1]
T = 120

# tests/unit/test_constrain.py:47 (REAL_SMILES), and strings the parser rejects
REAL_SMILES = [
    "CC(=O)Oc1ccccc1C(=O)O", "CN1C=NC2=C1C(=O)N(C)C(=O)N2C", "Cn1cnc2c1c(=O)n(C)c(=O)n2C",
    "C[C@@H](N)C(=O)O", "C[N+](C)(C)C", "[O-]C(=O)c1ccccc1", "ClC(Cl)(Cl)Cl", "BrCCBr",
    "C1CC2CCC1CC2", "c1ccc2ccccc2c1", "C/C=C/C", "N#Cc1ccccc1", "CCS(=O)(=O)N",
    "O=[N+]([O-])c1ccccc1", "CC(C)(C)OC(=O)N1CCC(N)CC1", "FC(F)(F)c1ccccc1", "C1=CC=CC=C1",
    "CC1=CC(=O)C=CC1=O", "c1ccc(-c2ccccc2)cc1", "c1ccccc1Cc1ccccc1", "CC1CCCCC1C1CCCCC1",
    "O=C(c1ccccc1)c1ccc(N)cc1",
]
INVALID = ["C(", "C1CC", "C=", "(C)", "C((C)", "CC)C", "F=F", "O=O=O", "C1C1", "C((C)C)", "C(1CC1)",
           "C[nH+]1ccc(Cl)c1", "[C@@H]12C3C1C23", "c1cc2c(cc1)[nH]c2Br", "CC(=O)[O-]", "C1=CC=CN=C1(", "CC##C", "[NH4+]C"]
# chip_smoke.py's 256 strings: every head followed by every tail
_HEADS = ["CCO", "CC(C)N", "c1ccccc1", "CC(=O)O", "C1CCNCC1", "COc1ccccc1", "CN(C)C=O",
          "Clc1ccccc1", "CC#N", "OC(=O)c1ccccc1", "CCS", "c1ccncc1", "CC(C)(C)O", "FC(F)F",
          "C1CCOC1", "NC(=O)N"]
_TAILS = ["C", "CC", "CCC(=O)O", "c1ccc(F)cc1", "N1CCCC1", "OC", "C(=O)N", "S(=O)(=O)N",
          "c1ccoc1", "Br", "C#N", "[C@@H](C)O", "CCN(CC)CC", "c1cc[nH]c1", "OCCO", "C1CC1"]
CORPUS = REAL_SMILES + INVALID + [h + t for h in _HEADS for t in _TAILS]


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in ("automaton.cuh", "automaton_host.cpp"):
        h.update((CSRC / name).read_bytes())
    return BUILD / f"libautomaton_host_{h.hexdigest()[:16]}.so"


@pytest.fixture(scope="module")
def host():
    """The warp program built for the host, with ctypes signatures."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the warp program's host build needs it")
    path = _library_path()
    BUILD.mkdir(parents=True, exist_ok=True)
    with open(BUILD / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not path.exists():
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
                os.close(fd)
                try:
                    subprocess.run(["g++", *FLAGS, "-o", tmp, str(CSRC / "automaton_host.cpp")], check=True,
                                   capture_output=True, text=True)
                    os.replace(tmp, path)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.molvax_auto_step_host.argtypes = [p, i, p, i, i, i, p, i, i, p]
    lib.molvax_auto_mask_host.argtypes = [p, i, p, i, i, i, i, p]
    lib.molvax_auto_advance_host.argtypes = [p, i, p, i, i, i, p]
    return lib


def _dims(state):
    A = ka.atoms_of(state.shape[1])
    return state.shape[0], A, kc.n_pairs(A)


def host_step(lib, state, scores, rem0):
    """``auto_step`` through the warp program: state updated in place, codes (B, n)."""
    sc3 = (scores[:, None, :] if scores.dim() == 2 else scores).contiguous()
    B, A, P = _dims(state)
    codes = torch.empty(B, sc3.shape[1], dtype=torch.int32)
    assert lib.molvax_auto_step_host(ITAB.data_ptr(), C, state.data_ptr(), B, A, P, sc3.data_ptr(), sc3.shape[1],
                                     rem0, codes.data_ptr()) == 0
    return codes


def host_mask(lib, state, rem):
    B, A, P = _dims(state)
    out = torch.empty(B, C, dtype=torch.uint8)
    assert lib.molvax_auto_mask_host(ITAB.data_ptr(), C, state.data_ptr(), B, A, P, rem, out.data_ptr()) == 0
    return out.view(torch.bool)


def host_advance(lib, state, tok):
    B, A, P = _dims(state)
    tok32 = tok.to(torch.int32).contiguous()
    assert lib.molvax_auto_advance_host(ITAB.data_ptr(), C, state.data_ptr(), B, A, P, tok32.data_ptr()) == 0


def _walk_scores(rows, steps, seed):
    """Seeded (rows, steps, C) scores tilted toward branches, rings, brackets,
    bonds and charges and away from the pad (chip_smoke.py's walk)."""
    rng = np.random.default_rng(seed)
    s = 2.0 * rng.standard_normal((rows, steps, C)).astype(np.float32)
    s[..., DEFAULT_CHARSET.chars.index(" ")] -= 4.0
    for ch in "()123[]=#+-@H":
        s[..., DEFAULT_CHARSET.chars.index(ch)] += 1.0
    return torch.from_numpy(s)


def _mask_and_advance_all(lib, state, rems, where):
    """From ``state``: the mask at each rem, and every class applied as the
    token (and one out of range each side), warp program against plain."""
    for rem in rems:
        want = ka.auto_mask_plain(ITAB, state, rem)
        got = host_mask(lib, state.clone(), rem)
        assert torch.equal(got, want), f"{where}: mask at rem {rem}, [row, class] {(got != want).nonzero()[:4].tolist()}"
    for tok in range(-1, C + 1):
        toks = torch.full((state.shape[0],), tok, dtype=torch.int32)
        got, want = state.clone(), state.clone()
        host_advance(lib, got, toks)
        ka.auto_advance_plain(ITAB, want, toks)
        assert torch.equal(got, want), f"{where}: advance by {tok}, [row, col] {(got != want).nonzero()[:4].tolist()}"


@pytest.mark.parametrize("n,ties", [(1, False), (T, False), (1, True)])
def test_greedy_walks_match_the_plain_version(host, n, ties):
    """64 seeded greedy walks of T=120 steps: as 120 calls of n=1 (masks,
    codes and packed state identical to the plain version's at every step)
    or as one call of n=120 (codes and final state identical); with scores
    rounded to whole numbers, so that the maximum is often tied and the
    first of the tied classes is taken."""
    B = 64
    scores = _walk_scores(B, T, seed=10 + n + ties)
    if ties:
        scores = scores.round()
    got, want = ka.new_state(B, T, "cpu"), ka.new_state(B, T, "cpu")
    if n == 1:
        for t in range(T):
            m = host_mask(host, got.clone(), T - 1 - t)
            assert torch.equal(m, ka.auto_mask_plain(ITAB, want, T - 1 - t)), f"mask at step {t}"
            ck = host_step(host, got, scores[:, t], T - 1 - t)
            cp = ka.auto_step_plain(ITAB, want, scores[:, t], T - 1 - t)
            assert torch.equal(ck, cp), f"codes at step {t}, rows {(ck != cp).nonzero()[:4].tolist()}"
            assert torch.equal(got, want), f"state at step {t}, [row, col] {(got != want).nonzero()[:4].tolist()}"
    else:
        ck = host_step(host, got, scores, T - 1)
        cp = ka.auto_step_plain(ITAB, want, scores, T - 1)
        assert ck.shape == (B, T) and torch.equal(ck, cp) and torch.equal(got, want)
    st = ka.unpack_state(got)
    # the walks reach deep states (rings closed, long chains) and end closed, none escaped
    assert int(st.pn.max()) >= 4 and int(st.n_atoms.max()) >= 20 and not bool(st.esc.any())
    assert bool((kc.is_closed(st) | st.done).all())


def test_teacher_codes_match_the_plain_version(host):
    """The corpus's teacher codes through the mask and the transition alone
    (``auto_mask`` / ``auto_advance``): masks and states identical to the
    plain versions' at every step, valid strings and invalid ones."""
    codes = torch.from_numpy(encode_smiles(CORPUS, DEFAULT_CHARSET, T).astype(np.int32))
    got, want = ka.new_state(len(CORPUS), T, "cpu"), ka.new_state(len(CORPUS), T, "cpu")
    for t in range(T):
        m = host_mask(host, got, T - 1 - t)
        assert torch.equal(m, ka.auto_mask_plain(ITAB, want, T - 1 - t)), f"mask at step {t}"
        host_advance(host, got, codes[:, t])
        ka.auto_advance_plain(ITAB, want, codes[:, t])
        assert torch.equal(got, want), f"state at step {t}, [row, col] {(got != want).nonzero()[:4].tolist()}"
    st = ka.unpack_state(got)
    valid = kc.is_closed(st)[: len(REAL_SMILES)] & ~st.esc[: len(REAL_SMILES)]
    assert bool(valid.all())


def test_ragged_batch_with_a_nan_row(host):
    """Six rows, one with a NaN among its legal scores at step 5: the pad
    there, escape recorded, everything identical to the plain version."""
    scores = _walk_scores(6, T, seed=17)
    scores[2, 5] = float("nan")
    scores[4, 7, :] = float("-inf")  # every legal score -inf: the first class scoring the maximum
    got, want = ka.new_state(6, T, "cpu"), ka.new_state(6, T, "cpu")
    ck = torch.cat([host_step(host, got, scores[:, t], T - 1 - t) for t in range(T)], dim=1)
    cp = ka.auto_step_plain(ITAB, want, scores, T - 1)
    assert torch.equal(ck, cp) and torch.equal(got, want)
    assert int(ck[2, 5]) == 0 and bool(ka.unpack_state(got).esc[2])


@pytest.mark.parametrize("prefix", [
    "C1CC2CC3C(C(C(C(C(C(C(C(C(C(C(C(C(C(C(C(C",  # 16 branches open: the stack full, 3 rings open
    "C1CC2CC3C(C(C(C(C(C(C(C(C(C(C(C(C(C(C(C(C(C",  # 17: one open branch more than the stack holds
    "C1C2C3C4C5C6C(C(C(C",  # six rings open (RMAX), branches open
    "C1CC1C1CC1C2CC2C1CC1C2CC2C1CC1C2CC2C1CC1C2CC2C1CC1C2CC2C1CC1C2CC2C1CC1C2CC2C1CC1C2CC2C1CC1C2CC2C1CC1",  # pool full
    "C[C@@H",  # inside a bracket atom
    "C=C(",  # a pending bond, then a branch
    "CC1(C",  # a ring open at the branch point: ')' pays for it
    "CC12(C3CC3",  # two rings at the branch point, one closed inside the branch
    "C1CC(C1",  # a ring closable from inside a branch
])
def test_open_rings_and_a_full_branch_stack(host, prefix):
    """From the states after each prefix (teacher-forced), the mask at rem
    0..119 and every token class applied, warp program against plain."""
    codes = torch.from_numpy(encode_smiles([prefix], DEFAULT_CHARSET, T).astype(np.int32))
    n = len(prefix)
    state = ka.new_state(1, T, "cpu")
    for t in range(n):
        ka.auto_advance_plain(ITAB, state, codes[:, t])
    st = ka.unpack_state(state)
    if prefix.count("(") >= kc.DMAX:
        assert int(st.sp[0]) == prefix.count("(")
    _mask_and_advance_all(host, state, [0, 1, 2, 3, 5, 8, 17, 30, T - 1 - n], prefix)


def test_seeded_mid_walk_states(host):
    """At every 10th step of 32 greedy walks: the mask at three rems and
    every class applied, warp program against plain."""
    scores = _walk_scores(32, T, seed=23)
    state = ka.new_state(32, T, "cpu")
    for t in range(0, T, 10):
        _mask_and_advance_all(host, state, [0, 1, 2, 3, 4, 6, 9, T - 1 - t], f"walk step {t}")
        ka.auto_step_plain(ITAB, state, scores[:, t : t + 10], T - 1 - t)


def _device_path():
    """automaton.cu and automaton.cuh without the header's host stand-in."""
    cuh = (CSRC / "automaton.cuh").read_text()
    start, end = cuh.index("#else  // the host stand-in"), cuh.index("#endif", cuh.index("#else  // the host stand-in"))
    return (CSRC / "automaton.cu").read_text() + cuh[:start] + cuh[end:]


def test_the_device_path_is_a_warp_program():
    """The kernels index rows by warp and keep no per-row array: the thread
    per row (the previous design) and local arrays indexed at run time (the
    slot, class and mask arrays it kept in local memory) do not come back.
    Only shared memory is declared as an array."""
    src = _device_path()
    code = re.sub(r"//[^\n]*", "", src)
    assert "blockIdx.x * blockDim.x + threadIdx.x" not in code
    assert re.search(r"blockIdx\.x \* AUTO_WARPS \+ threadIdx\.x / WARP", code)
    for intrinsic in ("__ballot_sync", "__shfl_sync", "__shfl_xor_sync", "__reduce_max_sync", "__reduce_or_sync",
                      "__match_any_sync", "__syncwarp"):
        assert intrinsic in code, intrinsic
    # a declaration: a type, a name, a subscript, then ; or = or { (not ==)
    decls = re.finditer(r"\b([A-Za-z_]\w*)\s+\**[A-Za-z_]\w*\s*\[[^\]]*\]\s*(;|=(?!=)|\{)", code)
    arrays = [m.group(0) for m in decls if m.group(1) not in ("return", "case", "else")]
    assert arrays == ["int srow[];"], arrays  # extern __shared__: the rows
    assert "uint64_t" not in code and "get_bit" not in code and "row_mask(" not in code


def test_probe_variants_apply_to_the_kernel_source():
    """Each variant of ``auto_loop_probe --variants`` is a text substitution
    that finds its text in the kernel's sources, once."""
    from molvax_torch.probes import auto_loop_probe

    assert "warps4" in auto_loop_probe.VARIANTS and auto_loop_probe.VARIANTS["warps4"] == []
    for name, edits in auto_loop_probe.VARIANTS.items():
        for file, old, new in edits:
            assert (CSRC / file).read_text().count(old) == 1, (name, old)
            assert new != old
