// The integer-op floor probe: what one native int32 op costs inside a
// kernel's loop.
//
// Replaces bench/auto_loop_probe.py::floor_loop (_floor_kernel), the TPU
// probe that measured the floor for an automaton written as vector ops, and
// computes what it computes, bit for bit: for each element of x (int32),
// `chains` independent chains start at x + c; every step t = 0 .. T-1 applies
// `k_ops` ops y = (y > t) ? y - 1 : y + 1, op i to chain i % chains; the
// output is the sum of the chains, with int32 wrap-around.
//
// Design. One thread per element (a warp is 32 neighbouring elements: one
// row of a (B, 32) layout). T and k_ops are runtime arguments, so nvcc cannot
// fold the loop; the chains are a template argument (an instance per count,
// 1 .. MAX_CHAINS) so that they live in registers. Differencing two k_ops
// cancels the launch and the loop overhead.
//
// What bounds it on an H100: the integer pipes. Each op is a compare and an
// add (the select folds into them): 2 int32 operations per element and op,
// dependent within a chain, independent across chains.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CHAINS = 8;

template <int CHAINS>
__global__ void __launch_bounds__(THREADS)
floor_kernel(const int* __restrict__ x, int* __restrict__ out, int n, int T, int k_ops) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  // unsigned adds wrap as the TPU's int32 adds do
  unsigned y[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) y[c] = (unsigned)x[i] + (unsigned)c;
  const int rounds = k_ops / CHAINS, tail = k_ops % CHAINS;
  for (int t = 0; t < T; ++t) {
    for (int k = 0; k < rounds; ++k) {
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) y[c] = (int)y[c] > t ? y[c] - 1u : y[c] + 1u;
    }
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      if (c < tail) y[c] = (int)y[c] > t ? y[c] - 1u : y[c] + 1u;
  }
  unsigned s = 0;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s += y[c];
  out[i] = (int)s;
}

template <int CHAINS>
cudaError_t launch(const int* x, int* out, int n, int T, int k_ops, cudaStream_t stream) {
  floor_kernel<CHAINS><<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(x, out, n, T, k_ops);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int molvax_floor_loop(const void* x, void* out, int n, int T, int k_ops, int chains,
                                 void* stream) {
  if (n <= 0 || T < 0 || k_ops < 0) return (int)cudaErrorInvalidValue;
  const int* x_ = static_cast<const int*>(x);
  int* out_ = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chains) {
    case 1: return (int)launch<1>(x_, out_, n, T, k_ops, s);
    case 2: return (int)launch<2>(x_, out_, n, T, k_ops, s);
    case 3: return (int)launch<3>(x_, out_, n, T, k_ops, s);
    case 4: return (int)launch<4>(x_, out_, n, T, k_ops, s);
    case 5: return (int)launch<5>(x_, out_, n, T, k_ops, s);
    case 6: return (int)launch<6>(x_, out_, n, T, k_ops, s);
    case 7: return (int)launch<7>(x_, out_, n, T, k_ops, s);
    case 8: return (int)launch<MAX_CHAINS>(x_, out_, n, T, k_ops, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
