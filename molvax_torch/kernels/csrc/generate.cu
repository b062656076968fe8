// Fused free-running generation: the whole T-step decode in one launch.
//
// Replaces molvax/kernels/generate.py::fused_generate (the Pallas TPU
// kernel) and computes what it computes. Per step t, for each batch row:
//   gi_1   = giz1 + bf16(prev) @ W_c          giz1 = z_emb @ W_ih1[:Lz] + b_ih1,
//                                              computed outside (fp32 GEMM)
//   h_1    = gate(gi_1, bf16(h_1) @ W_hh1 + b_hh1, h_1)
//   h_l    = gate(bf16(h_{l-1}) @ W_ihl + b_ihl, bf16(h_l) @ W_hhl + b_hhl, h_l)
//   logits = bf16(h_L) @ W_out + b_out
//   code   = first argmax(logits)                                (greedy)
//          | first argmax(logits / temperature + gumbel(seed,t,row,c))
//   prev   = one_hot(code); prev at t=0 is the start token (zero or learned)
// with gate(gi, gh, h) = n + z (h - n), r = sigmoid(gi_r + gh_r),
// z = sigmoid(gi_z + gh_z), n = tanh(gi_n + r gh_n), torch gate order r|z|n.
// Products take bf16 operands and accumulate in fp32; gates and the h carry
// are fp32, as in the TPU kernel.
//
// Design. Rows are independent, so the grid runs over blocks of RB batch
// rows and each block loops over T and over the L layers by itself: no
// grid-wide synchronisation. Thread j of the block owns hidden unit j (and
// j + THREADS, ...) of every layer for its RB rows: it computes the six dot
// products (gi and gh, gates r|z|n) of that unit in registers, applies the
// gate, and keeps the fp32 h carry of its own units in shared memory. The
// bf16 operand copy of each layer's h, which every thread reads, is double
// buffered by step parity and stored row-interleaved ([k][RB]), so one
// 8-byte shared load gives the operand of all RB rows. Weights are bf16 in
// (in, 3H) layout: a warp reads 32 neighbouring columns of one row per load.
//
// What bounds it on an H100: each block re-reads all decoder weights every
// step (about 7.7 MB bf16 at zinc250k width, 3 x GRU-501, C=37), from the
// 50 MB L2 where they stay resident. That is ~2 bytes of weight per 2*RB
// FLOPs, far below the card's bf16 balance point, and the products run on
// the fp32 FMA pipes rather than the tensor cores. RB trades the weight
// traffic per row against the number of blocks in flight (B/RB blocks
// against 132 SMs). The TPU kernel kept the weights in VMEM instead; a
// block's 227 KB of shared memory cannot hold them, so moving W_hh closer
// (cluster-distributed shared memory, wgmma tiles) is work for later.
//
// Sampling noise is a counter-based 32-bit hash of (seed, t, row, class),
// lowbias32 rounds; molvax_torch/kernels/generate.py computes the same bits
// with torch integer ops, so kernel and plain version see identical noise.

#include "common.cuh"

namespace {

constexpr int THREADS = 512;   // 16 warps; one hidden unit per thread at H <= 512

// w:    bf16 [W_c (C,3H) | W_hh_0 (H,3H) | (W_ih_l, W_hh_l) (H,3H) l=1..L-1 | W_out (H,C)]
// bias: fp32 [b_hh_0 (3H) | (b_ih_l, b_hh_l) (3H) l=1..L-1 | b_out (C)]
// shared memory: h32 fp32 [L][RB][H], hb bf16 [2][L][H][RB],
//                prev bf16 [C][RB], score fp32 [RB][C], code int [RB]
__global__ void __launch_bounds__(THREADS)
fused_generate_kernel(const float* __restrict__ giz1,
                      const float* __restrict__ start,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bias, int* __restrict__ codes,
                      int B, int T, int C, int H, int L, int greedy,
                      uint32_t seed, float temperature) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t G = 3 * (size_t)H;
  const size_t HG = (size_t)H * G;
  float* h32 = reinterpret_cast<float*>(smem);
  __nv_bfloat16* hb = reinterpret_cast<__nv_bfloat16*>(h32 + (size_t)L * RB * H);
  __nv_bfloat16* prev = hb + (size_t)2 * L * H * RB;
  float* score = reinterpret_cast<float*>(prev + (size_t)C * RB);
  int* code = reinterpret_cast<int*>(score + RB * C);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * RB;
  const __nv_bfloat16* w_out = w + C * G + HG + (size_t)(L - 1) * 2 * HG;
  const float* b_out = bias + G + (size_t)(L - 1) * 2 * G;

  for (int i = tid; i < L * RB * H; i += THREADS) h32[i] = 0.0f;
  for (int i = tid; i < L * H * RB; i += THREADS) hb[i] = __float2bfloat16_rn(0.0f);
  // step 0 feeds the start token, rounded to bf16 like every operand
  for (int i = tid; i < C * RB; i += THREADS) prev[i] = __float2bfloat16_rn(start[i / RB]);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    for (int l = 0; l < L; ++l) {
      const __nv_bfloat16* x_in;
      const __nv_bfloat16* w_ih;
      const __nv_bfloat16* w_hh;
      const float* b_ih;
      const float* b_hh;
      int K;
      if (l == 0) {
        x_in = prev;
        K = C;
        w_ih = w;
        w_hh = w + C * G;
        b_ih = nullptr;  // folded into giz1
        b_hh = bias;
      } else {
        x_in = hb + ((size_t)nxt * L + (l - 1)) * H * RB;
        K = H;
        w_ih = w + C * G + HG + (size_t)(l - 1) * 2 * HG;
        w_hh = w_ih + HG;
        b_ih = bias + G + (size_t)(l - 1) * 2 * G;
        b_hh = b_ih + G;
      }
      const __nv_bfloat16* h_old = hb + ((size_t)cur * L + l) * H * RB;
      __nv_bfloat16* h_new = hb + ((size_t)nxt * L + l) * H * RB;
      float* h_l = h32 + (size_t)l * RB * H;

      for (int j = tid; j < H; j += THREADS) {
        float gi[3][RB], gh[3][RB];
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int r = 0; r < RB; ++r) gi[g][r] = gh[g][r] = 0.0f;
        gate_products(x_in, w_ih, K, H, j, gi);
        gate_products(h_old, w_hh, H, H, j, gh);
        float hv[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          float ir, iz, in;
          if (l == 0) {
            const int row = row0 + r;
            const float* gz = giz1 + (size_t)(row < B ? row : 0) * G;
            const float m = row < B ? 1.0f : 0.0f;
            ir = m * gz[j] + gi[0][r];
            iz = m * gz[H + j] + gi[1][r];
            in = m * gz[2 * H + j] + gi[2][r];
          } else {
            ir = gi[0][r] + b_ih[j];
            iz = gi[1][r] + b_ih[H + j];
            in = gi[2][r] + b_ih[2 * H + j];
          }
          const float rg = sigmoid_f(ir + (gh[0][r] + b_hh[j]));
          const float zg = sigmoid_f(iz + (gh[1][r] + b_hh[H + j]));
          const float n = tanhf(in + rg * (gh[2][r] + b_hh[2 * H + j]));
          const float hp = h_l[r * H + j];
          hv[r] = n + zg * (hp - n);
          h_l[r * H + j] = hv[r];  // only this thread touches unit j's carry
        }
        store_rows(h_new, j, hv);
      }
      __syncthreads();  // layer l's new h is the next layer's input
    }

    const __nv_bfloat16* h_top = hb + ((size_t)nxt * L + (L - 1)) * H * RB;
    for (int c = tid; c < C; c += THREADS) {
      float acc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = 0.0f;
      column_product(h_top, w_out, H, C, c, acc);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        float s = acc[r] + b_out[c];
        if (!greedy) {
          const uint32_t bits = noise_bits(seed, (uint32_t)t, (uint32_t)(row0 + r), (uint32_t)c);
          const float u = ((float)(bits >> 8) + 1.0f) * (1.0f / 16777216.0f);
          s = s / temperature + (-logf(-logf(u)));
        }
        score[r * C + c] = s;
      }
    }
    __syncthreads();

    if (tid < RB) {
      // first maximum, as jnp.argmax / torch.argmax (a NaN counts as maximal)
      const float* s = score + tid * C;
      int best = 0;
      float bv = s[0];
      for (int c = 1; c < C; ++c) {
        const float v = s[c];
        if (v > bv || (v != v && bv == bv)) {
          bv = v;
          best = c;
        }
      }
      code[tid] = best;
      const int row = row0 + tid;
      if (row < B) codes[(size_t)row * T + t] = best;
    }
    __syncthreads();
    for (int i = tid; i < C * RB; i += THREADS)
      prev[i] = __float2bfloat16_rn((i / RB) == code[i % RB] ? 1.0f : 0.0f);
    __syncthreads();
  }
}

}  // namespace

extern "C" size_t molvax_fused_generate_smem(int C, int H, int L) {
  return (size_t)L * RB * H * sizeof(float) +
         (size_t)2 * L * H * RB * sizeof(__nv_bfloat16) +
         (size_t)C * RB * sizeof(__nv_bfloat16) + (size_t)RB * C * sizeof(float) +
         RB * sizeof(int);
}

// Launches on `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int molvax_fused_generate(const float* giz1, const float* start,
                                     const void* w, const float* bias,
                                     int* codes, int B, int T, int C, int H,
                                     int L, int greedy, unsigned int seed,
                                     float temperature, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || H <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = molvax_fused_generate_smem(C, H, L);
  cudaError_t err = cudaFuncSetAttribute(
      fused_generate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + RB - 1) / RB);
  fused_generate_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      giz1, start, static_cast<const __nv_bfloat16*>(w), bias, codes, B, T, C, H, L,
      greedy, seed, temperature);
  return (int)cudaGetLastError();
}
