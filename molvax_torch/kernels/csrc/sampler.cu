// Fused reparameterization sampler + per-row KL in one pass.
//
// Replaces molvax/kernels/sampler.py::fused_sample_kl (the Pallas TPU
// kernel) and computes what it computes, per batch row b and latent dim d:
//   u1  = (top24(noise_bits(seed, 0, b, d)) + 1) / 2^24     in (0, 1]
//   u2  =  top24(noise_bits(seed, 1, b, d)) / 2^24          in [0, 1)
//   eps = sqrt(-2 log u1) cos(2 pi u2)                       Box-Muller
//   z   = mu + eps_scale exp(logvar / 2) eps
//   kl  = -1/2 sum_d (1 + logvar - mu^2 - exp(logvar))
// all in fp32. The TPU kernel drew its bits from the core's hardware PRNG;
// this one draws them from the counter hash of csrc/common.cuh, which
// molvax_torch/kernels/sampler.py reproduces with torch integer ops, so the
// kernel and its plain version see identical bits. Like the TPU stream, the
// stream is seed-deterministic and differs from jax.random's. The backward
// is closed-form and stays in plain torch, as in the TPU package.
//
// The seed is read from device memory (the low 32 bits of a one-element
// int32 or int64 tensor), not passed by value: a train step takes it from a
// vector of per-step seeds on the card, so a CUDA Graph of K steps replays
// with the seeds of each new chunk.
//
// Design. A warp per batch row, 4 rows a block (B=256 gives 64 blocks):
// lane l takes latent dims l, l + 32, ..., so a warp's loads of mu and
// logvar are coalesced; the KL sum is a butterfly of warp shuffles in a
// fixed order, with no shared memory and no block barrier, so two calls
// give the same bits. The loop over a lane's dims is unrolled by 4, so
// their transcendentals overlap.
//
// What bounds it on an H100: 2 x B x L fp32 in, B x (L + 1) out (~0.9 MB at
// B=256, L=292) and four transcendentals per element: a few microseconds.
// In practice a lane's serial chain of ~10 dims (292 / 32) of hash, log,
// cos, sqrt and two exp: a block of 128 threads a row, 3 dims a thread,
// measured ~1.4 us less device time a call (PERF.md).

#include "common.cuh"

namespace {

constexpr int SAMPLER_ROWS = 4;  // warps (batch rows) a block

__global__ void __launch_bounds__(SAMPLER_ROWS * 32)
fused_sample_kl_kernel(const float* __restrict__ mu, const float* __restrict__ logvar,
                       float* __restrict__ z, float* __restrict__ kl, int B, int Lz,
                       const uint32_t* __restrict__ seed_ptr, float eps_scale) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * SAMPLER_ROWS + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp: no barrier follows
  const uint32_t seed = __ldg(seed_ptr);
  const float two_pi = 6.283185307179586f;
  const float scale24 = 1.0f / 16777216.0f;
  float part = 0.0f;
#pragma unroll 4  // four of the lane's dims in flight
  for (int d = lane; d < Lz; d += 32) {
    const size_t i = (size_t)b * Lz + d;
    const float m = mu[i], lv = logvar[i];
    const uint32_t bits1 = noise_bits(seed, 0u, (uint32_t)b, (uint32_t)d);
    const uint32_t bits2 = noise_bits(seed, 1u, (uint32_t)b, (uint32_t)d);
    const float u1 = ((float)(bits1 >> 8) + 1.0f) * scale24;
    const float u2 = (float)(bits2 >> 8) * scale24;
    const float eps = sqrtf(-2.0f * logf(u1)) * cosf(two_pi * u2);
    z[i] = m + eps_scale * expf(0.5f * lv) * eps;
    part += 1.0f + lv - m * m - expf(lv);
  }
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) kl[b] = -0.5f * part;
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 = success).
// `seed` points at the seed's low 32-bit word on the device.
extern "C" int molvax_fused_sample_kl(const float* mu, const float* logvar, float* z,
                                      float* kl, int B, int Lz, const unsigned int* seed,
                                      float eps_scale, void* stream) {
  if (B <= 0 || Lz <= 0 || seed == nullptr) return (int)cudaErrorInvalidValue;
  const int blocks = (B + SAMPLER_ROWS - 1) / SAMPLER_ROWS;
  fused_sample_kl_kernel<<<blocks, SAMPLER_ROWS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      mu, logvar, z, kl, B, Lz, seed, eps_scale);
  return (int)cudaGetLastError();
}
