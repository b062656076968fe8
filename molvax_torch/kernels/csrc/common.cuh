// Device helpers shared by the hand-written kernels.
//
// RB batch rows share one block in the recurrent kernels; their operands
// sit row-interleaved in shared memory ([k][RB]), so one 8-byte (bf16) or
// 16-byte (fp32) load gives operand k of all RB rows. The product helpers
// are templated on the operand type T (__nv_bfloat16 or float); products
// always accumulate in fp32. mix32 / noise_bits are the counter-based hash
// of the sampling noise; molvax_torch/kernels/generate.py computes the same
// bits with torch integer ops.

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

// to_f / from_f<T>: an operand of type T as fp32, and fp32 rounded to T
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// Operand k of all RB (= 4) rows from a [k][RB] buffer, as fp32.
__device__ __forceinline__ void load_rows(const __nv_bfloat16* buf, int k,
                                          float x[RB]) {
  const uint2 v = reinterpret_cast<const uint2*>(buf)[k];
  x[0] = __uint_as_float(v.x << 16);
  x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16);
  x[3] = __uint_as_float(v.y & 0xffff0000u);
}

__device__ __forceinline__ void load_rows(const float* buf, int k, float x[RB]) {
  const float4 v = reinterpret_cast<const float4*>(buf)[k];
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
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

__device__ __forceinline__ void store_rows(float* buf, int k, const float x[RB]) {
  reinterpret_cast<float4*>(buf)[k] = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// acc[g][r] += sum_k x[k][r] * w[k][g*H + j], g = r|z|n; w is (K, 3H)
template <typename T>
__device__ __forceinline__ void gate_products(const T* __restrict__ x,
                                              const T* __restrict__ w,
                                              int K, int H, int j,
                                              float acc[3][RB]) {
  const size_t G = 3 * (size_t)H;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float xr[RB];
    load_rows(x, k, xr);
    const T* wk = w + k * G + j;
    const float w0 = to_f(wk[0]);
    const float w1 = to_f(wk[H]);
    const float w2 = to_f(wk[2 * H]);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      acc[0][r] = fmaf(xr[r], w0, acc[0][r]);
      acc[1][r] = fmaf(xr[r], w1, acc[1][r]);
      acc[2][r] = fmaf(xr[r], w2, acc[2][r]);
    }
  }
}

// acc[r] += sum_k x[k][r] * w[k * ld + c]: one output column c
template <typename T>
__device__ __forceinline__ void column_product(const T* __restrict__ x,
                                               const T* __restrict__ w,
                                               int K, int ld, int c, float acc[RB]) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float xr[RB];
    load_rows(x, k, xr);
    const float wv = to_f(w[(size_t)k * ld + c]);
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = fmaf(xr[r], wv, acc[r]);
  }
}

}  // namespace
