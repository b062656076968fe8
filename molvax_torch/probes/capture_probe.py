"""Whether the port's kernels can be captured in a CUDA Graph, on the card.

    python3 -m molvax_torch.probes.capture_probe

A chunk of K train steps (``train.loop.make_train_chunk``) is one CUDA
Graph, so every launch on a train step's path must be capturable in
torch's default (global) capture mode: the cooperative launches of the
encoder, the stack's recurrence and sweep and the persistent decode
(``cudaLaunchCooperativeKernel``), and the runtime calls their C entry
points make at every launch (``cudaFuncSetAttribute``, ``cudaGetDevice``,
``cudaDeviceGetAttribute``). Each case runs in a process of its own, so a
capture that fails cannot leave the next case a broken context:

  * ``coop_launch`` / ``coop_launch_ex``: a small cooperative kernel with a
    grid barrier (``CASE_SOURCE``, built under ``build/capture_probe/``)
    launched by ``cudaLaunchCooperativeKernel`` and by ``cudaLaunchKernelEx``
    with ``cudaLaunchAttributeCooperative``, with the same runtime calls
    first; captured, then replayed with a new seed read from device memory;
  * ``fused_encode``, ``stack_forward``, ``stack_backward``,
    ``fused_sample_kl``, ``fused_generate``: the library's wrapper at
    ``zinc250k`` width, B=256, captured alone and replayed; its outputs
    against an eager call on the same inputs, bit for bit.

Prints one JSON line: each case's outcome (``captured``, ``replay_equal``,
or the error) with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

BUILD = Path(__file__).resolve().parents[2] / "build" / "capture_probe"
B = 256

CASE_SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

// out[i] = *seed + i, a grid barrier, then out2[i] = out[i] + out[(i + 1) % n]:
// each block reads a value another block wrote before the barrier.
__global__ void coop_kernel(const int* seed, int* out, int* out2, int n) {
  cg::grid_group grid = cg::this_grid();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = *seed + i;
  grid.sync();
  if (i < n) out2[i] = out[i] + out[(i + 1) % n];
}

extern "C" int probe_coop(int form, const int* seed, int* out, int* out2, int n, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(coop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 0);
  if (err != cudaSuccess) return (int)err;
  const int blocks = sms, threads = 256;
  if (n > blocks * threads) return (int)cudaErrorInvalidValue;
  if (form == 0) {
    void* params[] = {&seed, &out, &out2, &n};
    err = cudaLaunchCooperativeKernel((void*)coop_kernel, dim3(blocks), dim3(threads), params, 0,
                                      (cudaStream_t)stream);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, coop_kernel, seed, out, out2, n);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
"""


def _build_case_library() -> Path:
    from molvax_torch.kernels import _build

    BUILD.mkdir(parents=True, exist_ok=True)
    src, lib = BUILD / "coop_case.cu", BUILD / "libcoop_case.so"
    src.write_text(CASE_SOURCE)
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O2", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(lib), str(src)], check=True, capture_output=True, text=True)
    return lib


def _capture(fn):
    """fn() eagerly, then captured in a CUDA Graph and replayed: (eager
    outputs, the graph, its outputs); the caller changes inputs in place
    between the two."""
    eager = [t.clone() for t in fn()]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=stream):
        out = fn()
    return eager, graph, out


def _coop_case(form: int) -> dict:
    import ctypes

    lib = ctypes.CDLL(str(_build_case_library()))
    fn = lib.probe_coop
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = 4096
    seed = torch.full((), 5, dtype=torch.int32, device="cuda")
    out = torch.zeros(n, dtype=torch.int32, device="cuda")
    out2 = torch.zeros(n, dtype=torch.int32, device="cuda")
    errs = []

    def launch():
        errs.append(fn(form, seed.data_ptr(), out.data_ptr(), out2.data_ptr(), n,
                       torch.cuda.current_stream().cuda_stream))
        return (out2,)

    eager, graph, (got,) = _capture(launch)
    seed.fill_(11)
    out2.zero_()
    graph.replay()
    torch.cuda.synchronize()
    i = torch.arange(n, device="cuda", dtype=torch.int32)
    want = 2 * 11 + i + (i + 1) % n
    return {"launch_errors": errs, "eager_right": bool(torch.equal(eager[0], want - 12)),
            "replay_equal": bool(torch.equal(got, want))}


def _library_case(name: str) -> dict:
    """The wrapper ``name`` captured alone at zinc250k width, replayed on
    the same inputs: its outputs bit for bit against the eager call's."""
    from molvax_torch.kernels import conv_enc, gru_stack, sampler
    from molvax_torch.kernels import generate as kg
    from molvax_torch.nn.encoder import encoder_params
    from molvax_torch.probes import stack_probe

    dev = "cuda:0"
    model, cfg, z_emb = stack_probe.make_decoder(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    codes = torch.randint(0, cfg.charset_size, (B, cfg.max_len), generator=g, device=dev).to(torch.uint8)
    inp = stack_probe.make_inputs(dev)
    args = tuple(a.contiguous() for a in inp["args"])
    with torch.no_grad():
        if name == "fused_encode":
            params = encoder_params(model)
            fn = lambda: conv_enc._encode_kernel(cfg, codes, params)  # noqa: E731
        elif name == "fused_sample_kl":
            mu, lv = conv_enc.fused_encode_ref(model, cfg, codes)
            seed = torch.full((), 7, dtype=torch.int32, device=dev)
            fn = lambda: sampler._sample_kernel(seed, mu, lv, 1.0)  # noqa: E731
        elif name == "stack_forward":
            fn = lambda: gru_stack.stack_forward(*args)  # noqa: E731
        elif name == "stack_backward":
            x0, wih0, _, wih, _, whh, _, h0 = args
            res = (*gru_stack.stack_forward(*args), x0, h0, wih0, wih, whh)
            fn = lambda: gru_stack.stack_backward(res, inp["dY"], inp["dhf"])  # noqa: E731
        else:
            fn = lambda: (kg.fused_generate(model, cfg, z_emb, 0),)  # noqa: E731
        eager, graph, out = _capture(fn)
        graph.replay()
        torch.cuda.synchronize()
    return {"replay_equal": all(torch.equal(a, b) for a, b in zip(eager, out)), "outputs": len(eager)}


CASES = ("coop_launch", "coop_launch_ex", "fused_encode", "fused_sample_kl", "stack_forward", "stack_backward",
         "fused_generate")


def run_case(name: str) -> dict:
    try:
        if name.startswith("coop_launch"):
            got = _coop_case(0 if name == "coop_launch" else 1)
        else:
            got = _library_case(name)
        return {"captured": True, **got}
    except Exception as e:  # noqa: BLE001 - the probe reports what refused
        return {"captured": False, "error": f"{type(e).__name__}: {e}"[:400]}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("capture_probe: CUDA is not available; this probe runs on a GPU", file=sys.stderr)
        return 2
    if len(argv) == 2 and argv[0] == "--case":
        print(json.dumps(run_case(argv[1])), flush=True)
        return 0
    from molvax_torch.train.profiling import card_line

    out = {"card": card_line()}
    for name in CASES:
        proc = subprocess.run([sys.executable, "-m", "molvax_torch.probes.capture_probe", "--case", name],
                              capture_output=True, text=True, timeout=600)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        out[name] = json.loads(lines[-1]) if lines else {"captured": False, "rc": proc.returncode,
                                                         "stderr": proc.stderr[-400:]}
        print(json.dumps({name: out[name]}), flush=True)
    print(json.dumps(out), flush=True)
    return 0 if all(out[n].get("captured") and out[n].get("replay_equal") for n in CASES) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
