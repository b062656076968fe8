// Constrained-decoding automaton: mask, first-argmax, state transition.
//
// Replaces molvax/kernels/automaton.py::auto_step_pallas (the Pallas TPU
// kernel, body _auto_kernel) and computes what it computes: one step of the
// SMILES-validity automaton per batch row, the legal-token mask of
// step_mask_rem, the lowest-index maximum of the masked scores (illegal
// tokens at -inf, a NaN among the legal scores gives 0, the pad), and the
// transition of advance, bit for bit against the plain version in
// molvax_torch/latent/constrain.py. The row logic is in automaton.cuh.
//
// It is not a block-by-block carry-over of the Mosaic program. The TPU has
// no vector gather, so the reference turns every lookup into a one-hot
// contraction over the atom, stack and pool axes; here a row's state is
// small and indexing is cheap, so the code indexes directly.
//
// Design. One thread per batch row; the (18, C) token tables in shared
// memory; the packed state row (kernels/automaton.py::layout, 423 int32 at
// T=120) is read and written in place in device memory. Three entry
// points share the row functions:
//   molvax_auto_step     n consecutive steps (mask, select, advance) over
//                        scores (B, n, C), rem = rem0, rem0 - 1, ...;
//   molvax_auto_mask     the mask alone, as uint8 (B, C);
//   molvax_auto_advance  the transition alone, for tokens (B,).
//
// What bounds it on an H100: not bytes. One step at B=256 moves 2 x 256 x
// 423 x 4 B of state and 256 x 37 x 4 B of scores (~0.91 MB, 0.27 us at
// 3.35 TB/s); the step costs a launch and a serial chain of a few thousand
// integer operations per row on one thread. With n > 1 the launch is paid
// once. Spreading a row over a warp, and fusing the automaton into the
// generation kernel (csrc/generate.cu), are later work.

#include <cuda_runtime.h>

#include "automaton.cuh"

namespace {

using namespace automaton;

constexpr int AUTO_THREADS = 64;

__device__ __forceinline__ void load_tables(const int* __restrict__ tab, int C, int* stab) {
  for (int i = threadIdx.x; i < T_ROWS * C; i += blockDim.x) stab[i] = tab[i];
  __syncthreads();
}

__global__ void __launch_bounds__(AUTO_THREADS)
auto_step_kernel(const int* __restrict__ tab, int C, int* __restrict__ state, int B, Layout L,
                 const float* __restrict__ scores, int n, int rem0, int* __restrict__ codes) {
  extern __shared__ int stab[];
  load_tables(tab, C, stab);
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const Row w{state + (size_t)row * L.width(), L};
  uint64_t bits[MWORDS];
  for (int k = 0; k < n; ++k) {
    row_mask(stab, C, w, rem0 - k, bits);
    const int code = row_select(bits, scores + ((size_t)row * n + k) * C, C);
    codes[(size_t)row * n + k] = code;
    row_advance(stab, C, w, code);
  }
}

__global__ void __launch_bounds__(AUTO_THREADS)
auto_mask_kernel(const int* __restrict__ tab, int C, const int* __restrict__ state, int B,
                 Layout L, int rem, unsigned char* __restrict__ mask) {
  extern __shared__ int stab[];
  load_tables(tab, C, stab);
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const Row w{const_cast<int*>(state) + (size_t)row * L.width(), L};
  uint64_t bits[MWORDS];
  row_mask(stab, C, w, rem, bits);
  for (int c = 0; c < C; ++c) mask[(size_t)row * C + c] = get_bit(bits, c) ? 1 : 0;
}

__global__ void __launch_bounds__(AUTO_THREADS)
auto_advance_kernel(const int* __restrict__ tab, int C, int* __restrict__ state, int B, Layout L,
                    const int* __restrict__ tok) {
  extern __shared__ int stab[];
  load_tables(tab, C, stab);
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const Row w{state + (size_t)row * L.width(), L};
  row_advance(stab, C, w, tok[row]);
}

bool bad_shape(int C, int B, int A, int P) {
  return C < 1 || C > MAXC || B < 1 || A < 1 || P < 1;
}

dim3 grid_of(int B) { return dim3((B + AUTO_THREADS - 1) / AUTO_THREADS); }
size_t smem_of(int C) { return sizeof(int) * T_ROWS * C; }

}  // namespace

// Each launches on `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int molvax_auto_step(const int* tab, int C, int* state, int B, int A, int P,
                                const float* scores, int n, int rem0, int* codes, void* stream) {
  if (bad_shape(C, B, A, P) || n < 1) return (int)cudaErrorInvalidValue;
  auto_step_kernel<<<grid_of(B), AUTO_THREADS, smem_of(C), static_cast<cudaStream_t>(stream)>>>(
      tab, C, state, B, Layout{A, P}, scores, n, rem0, codes);
  return (int)cudaGetLastError();
}

extern "C" int molvax_auto_mask(const int* tab, int C, const int* state, int B, int A, int P,
                                int rem, unsigned char* mask, void* stream) {
  if (bad_shape(C, B, A, P)) return (int)cudaErrorInvalidValue;
  auto_mask_kernel<<<grid_of(B), AUTO_THREADS, smem_of(C), static_cast<cudaStream_t>(stream)>>>(
      tab, C, state, B, Layout{A, P}, rem, mask);
  return (int)cudaGetLastError();
}

extern "C" int molvax_auto_advance(const int* tab, int C, int* state, int B, int A, int P,
                                   const int* tok, void* stream) {
  if (bad_shape(C, B, A, P)) return (int)cudaErrorInvalidValue;
  auto_advance_kernel<<<grid_of(B), AUTO_THREADS, smem_of(C), static_cast<cudaStream_t>(stream)>>>(
      tab, C, state, B, Layout{A, P}, tok);
  return (int)cudaGetLastError();
}
