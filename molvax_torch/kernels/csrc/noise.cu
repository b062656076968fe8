// The sampling noise of a whole decode in one launch.
//
// The scan route of latent/sample.py (the fp32 decoder step, the valence
// automaton's auto_step) adds Gumbel noise to every step's scores. Element
// (t, b, c) of the (T, B, C) fp32 table is
//   u = (top24(noise_bits(seed, t, row_base + b, c)) + 1) / 2^24   in (0, 1]
//   g = -log(-log(u))
// the expression gen_persistent_kernel draws inside its head
// (generate.cu), with noise_bits of common.cuh. t enters the hash only as
// one added word, so all T steps are drawn at once, before the loop, and
// step t reads the contiguous (B, C) slice table[t].
// molvax_torch/kernels/generate.py::gumbel_table_ref computes the same bits
// with torch integer ops and torch.log, which is logf without fast math on
// the card, as this file is built.
//
// The seed is read from device memory (the low 32 bits of a one-element
// int32 or int64 tensor), so a captured decode replays with each request's
// seed (latent/sample.py::CapturedDecode).
//
// Design: a thread per element; blockIdx.y is the step, the x blocks cover
// its B x C elements in the table's order, so a warp's stores are
// coalesced. What bounds it on an H100: 4 T B C bytes written (4.5 MB at
// T=120, B=256, C=37: ~1.4 us at 3.35 TB/s) and, a thread, four mix32 and
// two logf.

#include <climits>

#include "common.cuh"

namespace {

constexpr int TABLE_THREADS = 256;

__global__ void __launch_bounds__(TABLE_THREADS)
gumbel_table_kernel(float* __restrict__ table, int B, int C, const uint32_t* __restrict__ seed_ptr,
                    uint32_t row_base) {
  const int per_step = B * C;
  const int j = blockIdx.x * TABLE_THREADS + threadIdx.x;
  if (j >= per_step) return;
  const int t = blockIdx.y;
  const int b = j / C;
  const uint32_t bits = noise_bits(__ldg(seed_ptr), (uint32_t)t, row_base + (uint32_t)b, (uint32_t)(j - b * C));
  const float u = ((float)(bits >> 8) + 1.0f) * (1.0f / 16777216.0f);
  table[(size_t)t * per_step + j] = -logf(-logf(u));
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 = success).
// `table` is (T, B, C) fp32, contiguous; `seed` points at the seed's low
// 32-bit word on the device; batch row b draws the noise of global row
// row_base + b.
extern "C" int molvax_gumbel_table(float* table, int T, int B, int C, const unsigned int* seed,
                                   unsigned int row_base, void* stream) {
  if (T <= 0 || T > 65535 || B <= 0 || C <= 0 || (long long)B * C > INT_MAX || table == nullptr ||
      seed == nullptr)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((B * C - 1) / TABLE_THREADS + 1), (unsigned)T);
  gumbel_table_kernel<<<grid, TABLE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(table, B, C, seed, row_base);
  return (int)cudaGetLastError();
}
