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
// What bounds it on an H100: the integer pipes, and the dependent chain. Each
// op is a compare and an add (the select folds into them): 2 int32
// operations per element and op; the ops of a chain depend on each other, so
// one chain's T ceil(k_ops / chains) ops take at least as many times one
// op's dependent latency.
//
// Design. A thread per (element, chain): chain c runs its k_ops / chains +
// (c < k_ops % chains) ops a step, in registers. The chains of an element sit
// in P neighbouring lanes (P the power of two at or above `chains`; lanes past
// `chains` carry 0), and __shfl_xor_sync adds them: wrapping addition is
// associative and commutative, so the sum is bit for bit the one of a single
// thread. At (256, 32) with 4 chains that is 32,768 threads on the 132 SMs
// where a thread an element (the previous design) gave 8,192 threads with
// ILP 4 on 32 of them. T and k_ops are runtime arguments, so nvcc cannot
// fold the loop, and differencing two k_ops cancels the launch and the loop's
// fixed cost; the chains are a template argument (an instance per count, 1 ..
// MAX_CHAINS). The op is written as a select between y - 1 and y + 1, both
// computed beside the compare: one compare-and-adds level and the select, two
// dependent instructions an op (ISETP | IADD3, then SEL; PERF.md has the
// SASS).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CHAINS = 8;

// One op of a chain at step t (unsigned adds wrap as the TPU's int32 adds do)
__device__ __forceinline__ unsigned floor_op(unsigned y, int t) {
  const unsigned lo = y - 1u, hi = y + 1u;
  return (int)y > t ? lo : hi;
}

template <int CHAINS>
__global__ void __launch_bounds__(THREADS)
floor_kernel(const int* __restrict__ x, int* __restrict__ out, int n, int T, int k_ops) {
  constexpr int P = CHAINS <= 1 ? 1 : CHAINS <= 2 ? 2 : CHAINS <= 4 ? 4 : 8;  // lanes an element
  const int i = (blockIdx.x * THREADS + threadIdx.x) / P, c = threadIdx.x % P;
  // a lane of a partial last element group still takes part in the shuffles
  const bool live = i < n && c < CHAINS;
  unsigned y = live ? (unsigned)x[i] + (unsigned)c : 0u;
  const int ops = live ? k_ops / CHAINS + (c < k_ops % CHAINS) : 0;
  for (int t = 0; t < T; ++t) {
    for (int k = 0; k < ops; ++k) y = floor_op(y, t);
  }
#pragma unroll
  for (int m = P / 2; m > 0; m /= 2) y += __shfl_xor_sync(0xffffffffu, y, m);
  if (i < n && c == 0) out[i] = (int)y;
}

template <int CHAINS>
cudaError_t launch(const int* x, int* out, int n, int T, int k_ops, cudaStream_t stream) {
  constexpr int P = CHAINS <= 1 ? 1 : CHAINS <= 2 ? 2 : CHAINS <= 4 ? 4 : 8;
  const long long threads = (long long)n * P;
  floor_kernel<CHAINS><<<(int)((threads + THREADS - 1) / THREADS), THREADS, 0, stream>>>(x, out, n, T, k_ops);
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
