// Constrained-decoding automaton: mask, first-argmax, state transition.
//
// Replaces molvax/kernels/automaton.py::auto_step_pallas (the Pallas TPU
// kernel, body _auto_kernel) and computes what it computes: one step of the
// SMILES-validity automaton per batch row, the legal-token mask of
// step_mask_rem, the lowest-index maximum of the masked scores (illegal
// tokens at -inf, a NaN among the legal scores gives 0, the pad), and the
// transition of advance, bit for bit against the plain version in
// molvax_torch/latent/constrain.py. The warp program is in automaton.cuh.
//
// It is not a block-by-block carry-over of the Mosaic program. The TPU has
// no vector gather, so the reference turns every lookup into a one-hot
// contraction over the atom, stack and pool axes; here a row's state is
// small and indexing is cheap, so the code indexes directly.
//
// What bounds it on an H100: not bytes. One step at B=256 moves 2 x 256 x
// 423 x 4 B of state and 256 x 37 x 4 B of scores (~0.91 MB, 0.27 us at
// 3.35 TB/s). The step is a chain of dependent integer operations and warp
// collectives on each row: latency. So the design spreads a row over a
// warp and keeps every operand on chip.
//
// Design. A warp per row, AUTO_WARPS = 4 rows per block (B=256 fills 64
// blocks, 1,280 beam rows 320). The warp copies its packed row
// (kernels/automaton.py::layout, 423 int32 at T=120) into shared memory
// with coalesced loads, works on it there for all n steps, and writes it
// back coalesced once (auto_mask writes nothing back). Lane l keeps the
// attributes of classes l, l + 32, ... in registers, loaded once per warp.
// The mask's stages run on the lanes (ring slot j on lane j, stack entry d
// on lane d, class c on lane c mod 32) and meet in ballots and max- and
// or-reductions; the selection is a NaN ballot, a shuffle max and the first
// set bit of a ballot; the transition runs on lane 0 on the shared row.
// Three entry points share the row functions:
//   molvax_auto_step     n consecutive steps (mask, select, advance) over
//                        scores (B, n, C), rem = rem0, rem0 - 1, ...;
//   molvax_auto_mask     the mask alone, as uint8 (B, C);
//   molvax_auto_advance  the transition alone, for tokens (B,).
// Fusing the automaton into the generation kernel (csrc/generate.cu) is
// later work; these row functions are its pieces.

#include <cuda_runtime.h>

#include "automaton.cuh"

namespace {

using namespace automaton;

constexpr int AUTO_WARPS = 4;  // rows (warps) a block; 2, 8, 16 measured (auto_loop_probe.py --variants)
constexpr int AUTO_THREADS = AUTO_WARPS * WARP;

// this warp's row in shared memory, copied from state (coalesced)
__device__ __forceinline__ int* stage_in(const int* __restrict__ state, int row, int S) {
  extern __shared__ int srow[];
  int* s = srow + (threadIdx.x / WARP) * S;
  const int* g = state + (size_t)row * S;
  for (int i = lane_id(); i < S; i += WARP) s[i] = g[i];
  __syncwarp();
  return s;
}

__device__ __forceinline__ void stage_out(const int* s, int* __restrict__ state, int row, int S) {
  __syncwarp();
  int* g = state + (size_t)row * S;
  for (int i = lane_id(); i < S; i += WARP) g[i] = s[i];
}

__device__ __forceinline__ int row_of() { return blockIdx.x * AUTO_WARPS + threadIdx.x / WARP; }

__global__ void __launch_bounds__(AUTO_THREADS)
auto_step_kernel(const int* __restrict__ tab, int C, int* __restrict__ state, int B, Layout L,
                 const float* __restrict__ scores, int n, int rem0, int* __restrict__ codes) {
  const int row = row_of();
  if (row >= B) return;  // a whole warp
  const int S = L.width();
  int* s = stage_in(state, row, S);
  const Lanes<Classes> cls = load_classes(tab, C);
  steps_row(cls, C, Row{s, L}, scores + (size_t)row * n * C, n, rem0, codes + (size_t)row * n);
  stage_out(s, state, row, S);
}

__global__ void __launch_bounds__(AUTO_THREADS)
auto_mask_kernel(const int* __restrict__ tab, int C, const int* __restrict__ state, int B, Layout L, int rem,
                 unsigned char* __restrict__ mask) {
  const int row = row_of();
  if (row >= B) return;
  int* s = stage_in(state, row, L.width());
  const Lanes<Classes> cls = load_classes(tab, C);
  mask_row(cls, C, Row{s, L}, rem, mask + (size_t)row * C);
}

__global__ void __launch_bounds__(AUTO_THREADS)
auto_advance_kernel(const int* __restrict__ tab, int C, int* __restrict__ state, int B, Layout L,
                    const int* __restrict__ tok) {
  const int row = row_of();
  if (row >= B) return;
  const int S = L.width();
  int* s = stage_in(state, row, S);
  const Lanes<Classes> cls = load_classes(tab, C);
  advance_row(cls, C, Row{s, L}, tok[row]);
  stage_out(s, state, row, S);
}

dim3 grid_of(int B) { return dim3((B + AUTO_WARPS - 1) / AUTO_WARPS); }

// The block's shared memory (its rows), opted in where above the 48 KB
// default; 0 where the rows do not fit a block at all (T beyond ~19,000).
template <class K>
size_t smem_for(K kernel, Layout L) {
  const size_t bytes = sizeof(int) * (size_t)AUTO_WARPS * L.width();
  if (bytes <= 48 * 1024) return bytes;
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      bytes > (size_t)optin ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes) != cudaSuccess)
    return 0;
  return bytes;
}

bool bad_shape(int C, int B, int A, int P) {
  return C < 1 || C > MAXC || B < 1 || A < 1 || P < 1;
}

}  // namespace

// Each launches on `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int molvax_auto_step(const int* tab, int C, int* state, int B, int A, int P,
                                const float* scores, int n, int rem0, int* codes, void* stream) {
  if (bad_shape(C, B, A, P) || n < 1) return (int)cudaErrorInvalidValue;
  const Layout L{A, P};
  const size_t smem = smem_for(auto_step_kernel, L);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  auto_step_kernel<<<grid_of(B), AUTO_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      tab, C, state, B, L, scores, n, rem0, codes);
  return (int)cudaGetLastError();
}

extern "C" int molvax_auto_mask(const int* tab, int C, const int* state, int B, int A, int P,
                                int rem, unsigned char* mask, void* stream) {
  if (bad_shape(C, B, A, P)) return (int)cudaErrorInvalidValue;
  const Layout L{A, P};
  const size_t smem = smem_for(auto_mask_kernel, L);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  auto_mask_kernel<<<grid_of(B), AUTO_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      tab, C, state, B, L, rem, mask);
  return (int)cudaGetLastError();
}

extern "C" int molvax_auto_advance(const int* tab, int C, int* state, int B, int A, int P,
                                   const int* tok, void* stream) {
  if (bad_shape(C, B, A, P)) return (int)cudaErrorInvalidValue;
  const Layout L{A, P};
  const size_t smem = smem_for(auto_advance_kernel, L);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  auto_advance_kernel<<<grid_of(B), AUTO_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      tab, C, state, B, L, tok);
  return (int)cudaGetLastError();
}
