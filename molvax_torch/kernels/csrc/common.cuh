// Device helpers shared by the hand-written kernels.
//
// RB batch rows share one block in the recurrent kernels; their bf16
// operands sit row-interleaved in shared memory ([k][RB]), so one 8-byte
// load gives operand k of all RB rows. mix32 / noise_bits are the
// counter-based hash of the sampling noise; molvax_torch/kernels/generate.py
// computes the same bits with torch integer ops.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RB = 4;  // batch rows per block in the recurrent kernels

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t noise_bits(uint32_t seed, uint32_t t,
                                               uint32_t row, uint32_t cls) {
  uint32_t h = mix32(seed);
  h = mix32(h + row);
  h = mix32(h + t);
  return mix32(h + cls);
}

__device__ __forceinline__ float bf16_to_f(__nv_bfloat16 v) {
  return __uint_as_float(static_cast<uint32_t>(__bfloat16_as_ushort(v)) << 16);
}

// Operand k of all RB (= 4) rows from a [k][RB] bf16 buffer, as fp32.
__device__ __forceinline__ void load_rows(const __nv_bfloat16* buf, int k,
                                          float x[RB]) {
  const uint2 v = reinterpret_cast<const uint2*>(buf)[k];
  x[0] = __uint_as_float(v.x << 16);
  x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16);
  x[3] = __uint_as_float(v.y & 0xffff0000u);
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

__device__ __forceinline__ void store_rows(__nv_bfloat16* buf, int k,
                                           const float x[RB]) {
  uint2 v;
  v.x = bf16_bits(x[0]) | (bf16_bits(x[1]) << 16);
  v.y = bf16_bits(x[2]) | (bf16_bits(x[3]) << 16);
  reinterpret_cast<uint2*>(buf)[k] = v;
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// acc[g][r] += sum_k x[k][r] * w[k][g*H + j], g = r|z|n; w is (K, 3H)
__device__ __forceinline__ void gate_products(const __nv_bfloat16* __restrict__ x,
                                              const __nv_bfloat16* __restrict__ w,
                                              int K, int H, int j,
                                              float acc[3][RB]) {
  const size_t G = 3 * (size_t)H;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float xr[RB];
    load_rows(x, k, xr);
    const __nv_bfloat16* wk = w + k * G + j;
    const float w0 = __bfloat162float(wk[0]);
    const float w1 = __bfloat162float(wk[H]);
    const float w2 = __bfloat162float(wk[2 * H]);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      acc[0][r] = fmaf(xr[r], w0, acc[0][r]);
      acc[1][r] = fmaf(xr[r], w1, acc[1][r]);
      acc[2][r] = fmaf(xr[r], w2, acc[2][r]);
    }
  }
}

// acc[r] += sum_k x[k][r] * w[k * ld + c]: one output column c
__device__ __forceinline__ void column_product(const __nv_bfloat16* __restrict__ x,
                                               const __nv_bfloat16* __restrict__ w,
                                               int K, int ld, int c, float acc[RB]) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float xr[RB];
    load_rows(x, k, xr);
    const float wv = __bfloat162float(w[(size_t)k * ld + c]);
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = fmaf(xr[r], wv, acc[r]);
  }
}

}  // namespace
