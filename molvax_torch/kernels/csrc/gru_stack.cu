// Stacked-GRU recurrence for training: the persistent forward recurrence
// and reverse sweep of one layer, and the stack's products through
// csrc/gemm.cuh.
//
// Replaces molvax/kernels/gru_stack.py::gru_stack_scan, the Pallas TPU
// kernel pair _fused_fwd_kernel (forward) and _fused_bwd_kernel (backward,
// with its in-kernel dW), and computes what they compute, with the same
// rounding points (torch gate order r|z|n):
//
// forward, layer l, step t, batch row b:
//   gi  = x_l @ W_ih_l^T + b_ih_l       fp32, x_0 = bf16 x0, x_l = hseq[l-1]
//   gh  = bf16(h) @ W_hh_l^T + b_hh_l
//   r = sigmoid(gi_r + gh_r), z = sigmoid(gi_z + gh_z), n = tanh(gi_n + r gh_n)
//   h = (1 - z) n + z h                fp32 carry
//   stores hseq = bf16(h), rzn = bf16(r|z|n), ghn = bf16(gh_n)
// backward, layer l = L-1 .. 0, t = T-1 .. 0:
//   dout = dh + ext[t]                 ext = dY for the top layer, else the
//                                      fp32 cotangent from the layer above
//   dz = dout (hprev - n) z (1 - z), dn = dout (1 - z)(1 - n^2),
//   dr = dn gh_n r (1 - r)
//   dgi = bf16(dr | dz | dn), dgh = bf16(dr | dz | dn r)
//   dh = dout z + dgh @ W_hh_l
// then ext for the layer below = dgi @ W_ih_l (fp32; bf16 dx0 for l = 0),
// and dW_hh_l = sum_{t,b} dgh^T hprev, dW_ih_l = sum dgi^T x_l,
// db = sum dgi | dgh, with hprev = hseq[l][t-1] (bf16(h0) at t = 0).
// Batch rows are independent, so the layers run one after the other over
// the whole sequence, as the plain versions do.
//
// What bounds it on an H100. Of the stack's ~0.26 TFLOP per forward (0.53
// backward) at zinc250k width, B=256, all but the recurrent products
// h @ W_hh^T and dgh @ W_hh do not depend on the step before: the input
// gates, the cotangent passed down and dW are large GEMMs, on the tensor
// cores through csrc/gemm.cuh at a small fraction of a millisecond each.
// What is left is serial: per layer, T = 120 dependent steps of an M = B,
// N = 3H, K = H product (K = 3H, N = H backward) plus the gate math. A
// single step is ~0.4 GFLOP: tens of nanoseconds of the card's tensor
// cores, so latency bounds the step: reading the weights (1.5 MB bf16 per
// layer), reading h from the other blocks, and the barrier that makes
// step t's h visible to all before step t+1.
//
// What the design does about it. One persistent cooperative launch per
// layer and pass, one block per SM (stack_plan in kernels/gru_stack.py
// picks the layout): g row groups x q blocks; block (group, j) owns
// `units` hidden units, all three gate columns of each, for the group's
// `rows` batch rows. Its slice of W_hh (3 units x H bf16 forward; the
// transposed H-rows of its units, units x 3H, backward) is copied into
// shared memory once and stays there for the whole sweep, so no weight
// leaves L2 after the first step. Each step a block copies the group's bf16
// h (dgh backward) row block from L2 with cp.async, in chunks through a
// 2-stage ring where it does not fit whole, and runs its slice of the
// product on mma.sync (one warp per 8 units); each thread's accumulator
// fragment is also its set of (row, unit) pairs, so the fp32 carry (h
// forward, dh backward) lives in registers and the gate math runs on the
// fragments. Then the group meets at a barrier on a global counter
// (release / acquire at gpu scope). The cooperative launch fails, and the
// wrapper raises, unless every block is resident.
//
// The reverse sweep needs one barrier per step: phase A (the gate
// cotangents of the block's own units, from dh, which only it holds)
// writes dgi / dgh; after the barrier, phase B reads the whole dgh row block
// and adds dgh @ W_hh[:, units] to dh. Phase A's operands of the next step
// are loaded while phase B runs.
//
// Where a step's time goes at zinc250k width on an H100
// (probes/stack_probe.py --steps, which rebuilds this file with parts taken
// out): ~10 us forward, ~18 us in the sweep; the group barrier ~2 us and
// ~3 us of them, the product with its h / dgh copy ~2.6 us and ~8.4 us,
// the rest the per-step loads, gate math and stores. Latency, not the
// tensor cores or bandwidth, bounds all three.
//
// The fused3 probe (molvax_gru_fused3_fwd, gru_stack_fwd_kernel<true>) is
// the previous design's stack forward as the design probe
// bench/gru_experiments.py::run_fused3 (_fused3_kernel) ran it: a block of
// RB = 4 rows runs time outer, layers inner, with products on the FMA pipes
// and weights re-read from L2 each step; layer 0 reads its input gates gi0
// (T, B, 3H) bf16, bias included (b_ih0 is then a zero vector); the upper
// layers compute theirs in the kernel; hseq of every layer is stored and no
// r|z|n or gh_n. The TPU probe's separate copy of the top layer (htop) was a
// layout device: hseq[L-1] is already contiguous here. The template's other
// instance, the previous production forward, is no longer built.

#include <string.h>

#include "common.cuh"
#include "gemm.cuh"

namespace {

constexpr int THREADS = 512;  // one hidden unit per thread at H <= 512

// shared memory: h32 fp32 [L][RB][H], hb bf16 [2][L][H][RB], xb bf16 [I0][RB]
// (FUSED3: I0 = 0, no xb)
template <bool FUSED3 = false>
__global__ void __launch_bounds__(THREADS)
gru_stack_fwd_kernel(const __nv_bfloat16* __restrict__ x0,    // (T, B, I0)
                     const __nv_bfloat16* __restrict__ wih0,  // (I0, 3H)
                     const float* __restrict__ bih0,          // (3H)
                     const __nv_bfloat16* __restrict__ wih,   // (L-1, H, 3H)
                     const float* __restrict__ bih,           // (L-1, 3H)
                     const __nv_bfloat16* __restrict__ whh,   // (L, H, 3H)
                     const float* __restrict__ bhh,           // (L, 3H)
                     const float* __restrict__ h0,            // (L, B, H)
                     __nv_bfloat16* __restrict__ hseq,        // (L, T, B, H)
                     __nv_bfloat16* __restrict__ rzn,         // (L, T, B, 3H), !FUSED3
                     __nv_bfloat16* __restrict__ ghn,         // (L, T, B, H), !FUSED3
                     int T, int B, int I0, int H, int L,
                     const __nv_bfloat16* __restrict__ gi0) { // (T, B, 3H), FUSED3
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t G = 3 * (size_t)H;
  float* h32 = reinterpret_cast<float*>(smem);
  __nv_bfloat16* hb = reinterpret_cast<__nv_bfloat16*>(h32 + (size_t)L * RB * H);
  __nv_bfloat16* xb = hb + (size_t)2 * L * H * RB;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * RB;

  // rows past B run on zeros and store nothing
  for (int i = tid; i < L * RB * H; i += THREADS) {
    const int l = i / (RB * H), r = (i / H) % RB, j = i % H;
    const int row = row0 + r;
    const float v = row < B ? h0[((size_t)l * B + row) * H + j] : 0.0f;
    h32[i] = v;
    hb[((size_t)l * H + j) * RB + r] = __float2bfloat16_rn(v);  // step parity 0
  }

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    for (int i = tid; i < RB * I0; i += THREADS) {
      const int r = i / I0, k = i % I0;
      const int row = row0 + r;
      __nv_bfloat16 v = __float2bfloat16_rn(0.0f);
      if (row < B) v = x0[((size_t)t * B + row) * I0 + k];
      xb[(size_t)k * RB + r] = v;
    }
    __syncthreads();

    for (int l = 0; l < L; ++l) {
      const __nv_bfloat16* x_in;
      const __nv_bfloat16* w_in;
      const float* b_in;
      int K;
      if (l == 0) {
        x_in = xb;
        w_in = wih0;
        b_in = bih0;
        K = I0;
      } else {
        x_in = hb + ((size_t)nxt * L + (l - 1)) * H * RB;
        w_in = wih + (size_t)(l - 1) * H * G;
        b_in = bih + (size_t)(l - 1) * G;
        K = H;
      }
      const __nv_bfloat16* w_h = whh + (size_t)l * H * G;
      const float* b_h = bhh + (size_t)l * G;
      const __nv_bfloat16* h_old = hb + ((size_t)cur * L + l) * H * RB;
      __nv_bfloat16* h_new = hb + ((size_t)nxt * L + l) * H * RB;
      float* h_l = h32 + (size_t)l * RB * H;

      for (int j = tid; j < H; j += THREADS) {
        float gi[3][RB], gh[3][RB];
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int r = 0; r < RB; ++r) gi[g][r] = gh[g][r] = 0.0f;
        if constexpr (FUSED3) {
          if (l == 0) {  // layer 0's gates are given (b_ih0 is zero)
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              const int row = row0 + r;
              if (row < B) {
                const __nv_bfloat16* gr = gi0 + ((size_t)t * B + row) * G + j;
                gi[0][r] = __bfloat162float(gr[0]);
                gi[1][r] = __bfloat162float(gr[H]);
                gi[2][r] = __bfloat162float(gr[2 * H]);
              }
            }
          } else {
            gate_products(x_in, w_in, K, H, j, gi);
          }
        } else {
          gate_products(x_in, w_in, K, H, j, gi);
        }
        gate_products(h_old, w_h, H, H, j, gh);
        float hv[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float rg = sigmoid_f((gi[0][r] + b_in[j]) + (gh[0][r] + b_h[j]));
          const float zg = sigmoid_f((gi[1][r] + b_in[H + j]) + (gh[1][r] + b_h[H + j]));
          const float gn = gh[2][r] + b_h[2 * H + j];
          const float n = tanhf((gi[2][r] + b_in[2 * H + j]) + rg * gn);
          const float h = (1.0f - zg) * n + zg * h_l[r * H + j];
          h_l[r * H + j] = h;  // only this thread touches unit j's carry
          hv[r] = h;
          const int row = row0 + r;
          if (row < B) {
            const size_t o = ((size_t)l * T + t) * B + row;
            hseq[o * H + j] = __float2bfloat16_rn(h);
            if constexpr (!FUSED3) {
              rzn[o * G + j] = __float2bfloat16_rn(rg);
              rzn[o * G + H + j] = __float2bfloat16_rn(zg);
              rzn[o * G + 2 * H + j] = __float2bfloat16_rn(n);
              ghn[o * H + j] = __float2bfloat16_rn(gn);
            }
          }
        }
        store_rows(h_new, j, hv);
      }
      __syncthreads();  // layer l's new h is the next layer's input
    }
  }
}


// -- the persistent recurrences ---------------------------------------------

constexpr int SPAD = 8;  // elements of padding per shared-memory row

// The row groups' barrier: every block of the group has stored its part of
// step t (count reaches `target`) before any reads it.
__device__ __forceinline__ void group_barrier(int* flag, int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(flag, 1);
    int v;
    do {
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(flag) : "memory");
    } while (v < target);
    __threadfence();
  }
  __syncthreads();
}

// The group's bf16 row block (rows x K of a (., ld) array, rows from r0,
// valid below rlim, columns valid below klim) streamed in chunks of
// `chunk` columns through `stages` (1 or 2) buffers of rows x (chunk +
// SPAD); body(buf, k0, klen) runs on each chunk once it landed. Earlier
// cp.async groups of the thread are waited for too.
template <typename Body>
__device__ __forceinline__ void stream_rows(__nv_bfloat16* ring, const __nv_bfloat16* src,
                                            int ld, int rows, int r0, int rlim, int K, int klim,
                                            int chunk, Body body) {
  const int nch = (K + chunk - 1) / chunk;
  const int cpr = chunk / 8;  // 16-byte chunks per row
  const int stride = chunk + SPAD;
  auto issue = [&](int c) {
    __nv_bfloat16* buf = ring + (size_t)(c & 1) * rows * stride;
    for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
      const int row = i / cpr, kc = (i % cpr) * 8;
      const int r = r0 + row, k = c * chunk + kc;
      const int bytes = r < rlim ? chunk_bytes(k, klim) : 0;
      cp_async16(buf + row * stride + kc, bytes ? src + (size_t)r * ld + k : src, bytes);
    }
    cp_async_commit();
  };
  issue(0);
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      issue(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    body(ring + (size_t)(c & 1) * rows * stride, c * chunk, min(chunk, K - c * chunk));
    __syncthreads();
  }
}

// Copy `n` rows of K valid columns (of Kp) into shared memory rows of
// Kp + SPAD; row i comes from src_row(i) or is zero where that is null
// (`base`, any valid global address, stands in for it).
template <typename RowPtr>
__device__ __forceinline__ void load_resident(__nv_bfloat16* s, int n, int K, int Kp,
                                              const __nv_bfloat16* base, RowPtr src_row) {
  const int cpr = Kp / 8;
  for (int i = threadIdx.x; i < n * cpr; i += blockDim.x) {
    const int row = i / cpr, kc = (i % cpr) * 8;
    const __nv_bfloat16* g = src_row(row);
    const int bytes = g ? chunk_bytes(kc, K) : 0;
    cp_async16(s + (size_t)row * (Kp + SPAD) + kc, bytes ? g + kc : base, bytes);
  }
  cp_async_commit();
}

struct RecArgs {
  const float* gi;            // (T, B, 3H) fp32, bias included
  const __nv_bfloat16* whh;   // (3H, ldw) bf16, torch layout
  const float* bhh;           // (3H)
  const float* h0;            // (B, H) fp32
  const __nv_bfloat16* h0b;   // (B, ldh) bf16(h0)
  __nv_bfloat16* hseq;        // (T, B, ldh)
  __nv_bfloat16* rzn;         // (T, B, 3H)
  __nv_bfloat16* ghn;         // (T, B, H)
  int* flags;                 // (g) zeros
  int T, B, H, ldw, ldh;
  int units, rows, q, chunk;  // the plan
  int row_base, row_end;      // the batch rows of this launch
};

struct SweepArgs {
  const __nv_bfloat16* hseq;  // (T, B, ldh) the layer's h sequence
  const __nv_bfloat16* h0b;   // (B, ldh)
  const __nv_bfloat16* rzn;   // (T, B, 3H)
  const __nv_bfloat16* ghn;   // (T, B, H)
  const float* ext;           // (T, B, H) fp32 cotangent from above
  const float* dhf;           // (B, H) fp32 cotangent of h_final
  const __nv_bfloat16* whhT;  // (H, ldw) bf16: W_hh transposed
  __nv_bfloat16* dgi;         // (T, B, ldd)
  __nv_bfloat16* dgh;         // (T, B, ldd)
  float* dh0;                 // (B, H)
  int* flags;
  int T, B, H, ldh, ldw, ldd;
  int units, rows, q, chunk;
  int row_base, row_end;
};

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// the resident W_hh slice, then the ring of one or two chunk buffers
size_t rec_smem(int H, int units, int rows, int chunk) {
  const int K = round16(H);
  return ((size_t)3 * units * (K + SPAD) + (size_t)(chunk >= K ? 1 : 2) * rows * (chunk + SPAD)) *
         sizeof(__nv_bfloat16);
}

size_t sweep_smem(int H, int units, int rows, int chunk) {
  const int K = round16(3 * H);
  return ((size_t)units * (K + SPAD) + (size_t)(chunk >= K ? 1 : 2) * rows * (chunk + SPAD)) *
         sizeof(__nv_bfloat16);
}

// Forward recurrence of one layer. MT = rows / 16 m16 tiles; warp w owns
// units [8w, 8w + 8) of the block's slice, their r, z and n columns.
template <int MT>
__global__ void __launch_bounds__(256) gru_rec_kernel(const RecArgs a) {
  extern __shared__ __align__(16) unsigned char rsmem[];
  const int H = a.H, G = 3 * H, K = round16(H);
  const int grp = blockIdx.x / a.q, u0 = (blockIdx.x % a.q) * a.units;
  const int r0 = a.row_base + grp * a.rows;
  __nv_bfloat16* sW = reinterpret_cast<__nv_bfloat16*>(rsmem);
  __nv_bfloat16* ring = sW + (size_t)3 * a.units * (K + SPAD);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // W_hh rows gate * H + u0 + u, resident for the whole sweep
  load_resident(sW, 3 * a.units, H, K, a.whh, [&](int row) -> const __nv_bfloat16* {
    const int gate = row / a.units, u = u0 + row % a.units;
    return u < H ? a.whh + (size_t)(gate * H + u) * a.ldw : nullptr;
  });

  // this thread's (row, unit) pairs: fragment element (mt, e)
  int rowof[MT][4], unit[4];
  bool ok[MT][4];
  float h[MT][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) unit[e] = u0 + warp * 8 + (lane & 3) * 2 + (e & 1);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      rowof[mt][e] = r0 + mt * 16 + (lane >> 2) + (e >> 1) * 8;
      ok[mt][e] = rowof[mt][e] < a.row_end && unit[e] < H && unit[e] < u0 + a.units;
      h[mt][e] = ok[mt][e] ? a.h0[(size_t)rowof[mt][e] * H + unit[e]] : 0.0f;
    }
  float bh[3][4];
#pragma unroll
  for (int gte = 0; gte < 3; ++gte)
#pragma unroll
    for (int e = 0; e < 4; ++e) bh[gte][e] = unit[e] < H ? a.bhh[gte * H + unit[e]] : 0.0f;

  const __nv_bfloat16* wrow = sW + (size_t)(warp * 8 + (lane & 7)) * (K + SPAD) + ((lane >> 3) & 1) * 8;
  const size_t wgate = (size_t)a.units * (K + SPAD);
  for (int t = 0; t < a.T; ++t) {
    // the input gates do not wait for h: load them first
    float gi[MT][4][3];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* p = a.gi + ((size_t)t * a.B + rowof[mt][e]) * G + unit[e];
#pragma unroll
        for (int gte = 0; gte < 3; ++gte) gi[mt][e][gte] = ok[mt][e] ? p[gte * H] : 0.0f;
      }
    float acc[MT][3][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int gte = 0; gte < 3; ++gte)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][gte][e] = 0.0f;
    const __nv_bfloat16* src = t == 0 ? a.h0b : a.hseq + (size_t)(t - 1) * a.B * a.ldh;
    stream_rows(ring, src, a.ldh, a.rows, r0, a.row_end, K, H, a.chunk,
                [&](const __nv_bfloat16* buf, int k0, int klen) {
                  const int stride = a.chunk + SPAD;
#pragma unroll 4
                  for (int kk = 0; kk < klen; kk += 16) {
                    uint32_t bw[3][2];
#pragma unroll
                    for (int gte = 0; gte < 3; ++gte) ldmatrix_x2(bw[gte], wrow + gte * wgate + k0 + kk);
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
                      uint32_t af[4];
                      ldmatrix_x4(af, buf + (mt * 16 + (lane & 15)) * stride + kk + (lane >> 4) * 8);
#pragma unroll
                      for (int gte = 0; gte < 3; ++gte) mma_bf16(acc[mt][gte], af, bw[gte]);
                    }
                  }
                });
    // the gate math on the fragments
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float rg = sigmoid_f(gi[mt][e][0] + (acc[mt][0][e] + bh[0][e]));
        const float zg = sigmoid_f(gi[mt][e][1] + (acc[mt][1][e] + bh[1][e]));
        const float gn = acc[mt][2][e] + bh[2][e];
        const float n = tanhf(gi[mt][e][2] + rg * gn);
        const float hv = (1.0f - zg) * n + zg * h[mt][e];
        h[mt][e] = hv;
        if (ok[mt][e]) {
          const size_t o = (size_t)t * a.B + rowof[mt][e];
          const int j = unit[e];
          a.hseq[o * a.ldh + j] = __float2bfloat16_rn(hv);
          a.rzn[o * G + j] = __float2bfloat16_rn(rg);
          a.rzn[o * G + H + j] = __float2bfloat16_rn(zg);
          a.rzn[o * G + 2 * H + j] = __float2bfloat16_rn(n);
          a.ghn[o * H + j] = __float2bfloat16_rn(gn);
        }
      }
    if (t + 1 < a.T) group_barrier(a.flags + grp, a.q * (t + 1));
  }
}

// Reverse sweep of one layer. Warp w owns units [8w, 8w + 8) of the slice:
// phase A's gate cotangents and dh for them, and their columns of phase B's
// product (two accumulator sets over alternate k steps, for two chains in
// flight).
template <int MT>
__global__ void __launch_bounds__(256) gru_sweep_kernel(const SweepArgs a) {
  extern __shared__ __align__(16) unsigned char ssmem[];
  const int H = a.H, G = 3 * H, K = round16(G);
  const int grp = blockIdx.x / a.q, u0 = (blockIdx.x % a.q) * a.units;
  const int r0 = a.row_base + grp * a.rows;
  __nv_bfloat16* sW = reinterpret_cast<__nv_bfloat16*>(ssmem);
  __nv_bfloat16* ring = sW + (size_t)a.units * (K + SPAD);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // W_hh[:, u0 + u] as shared row u, resident for the whole sweep
  load_resident(sW, a.units, G, K, a.whhT, [&](int row) -> const __nv_bfloat16* {
    const int u = u0 + row;
    return u < H ? a.whhT + (size_t)u * a.ldw : nullptr;
  });

  int rowof[MT][4], unit[4];
  bool ok[MT][4];
  float dh[MT][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) unit[e] = u0 + warp * 8 + (lane & 3) * 2 + (e & 1);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      rowof[mt][e] = r0 + mt * 16 + (lane >> 2) + (e >> 1) * 8;
      ok[mt][e] = rowof[mt][e] < a.row_end && unit[e] < H && unit[e] < u0 + a.units;
      dh[mt][e] = ok[mt][e] ? a.dhf[(size_t)rowof[mt][e] * H + unit[e]] : 0.0f;
    }

  // phase A's operands of step t (r, z, n, gh_n, hprev, ext): they do not
  // wait for dh, so step t-1's are loaded while phase B of step t runs
  float in[MT][4][6];
  auto load_in = [&](int t) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!ok[mt][e]) continue;
        const int j = unit[e], row = rowof[mt][e];
        const size_t o = (size_t)t * a.B + row;
        in[mt][e][0] = __bfloat162float(a.rzn[o * G + j]);
        in[mt][e][1] = __bfloat162float(a.rzn[o * G + H + j]);
        in[mt][e][2] = __bfloat162float(a.rzn[o * G + 2 * H + j]);
        in[mt][e][3] = __bfloat162float(a.ghn[o * H + j]);
        in[mt][e][4] = __bfloat162float(t > 0 ? a.hseq[(o - a.B) * a.ldh + j] : a.h0b[(size_t)row * a.ldh + j]);
        in[mt][e][5] = a.ext[o * H + j];
      }
  };
  load_in(a.T - 1);

  const __nv_bfloat16* wrow = sW + (size_t)(warp * 8 + (lane & 7)) * (K + SPAD) + ((lane >> 3) & 1) * 8;
  for (int t = a.T - 1, s = 1; t >= 0; --t, ++s) {
    // phase A: the gate cotangents of the block's own units
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!ok[mt][e]) continue;
        const int j = unit[e];
        const size_t o = (size_t)t * a.B + rowof[mt][e];
        const float rg = in[mt][e][0], zg = in[mt][e][1], n = in[mt][e][2], gn = in[mt][e][3];
        const float hp = in[mt][e][4];
        const float dout = dh[mt][e] + in[mt][e][5];
        const float dz = dout * (hp - n) * zg * (1.0f - zg);
        const float dn = dout * (1.0f - zg) * (1.0f - n * n);
        const float dghn = dn * rg;
        const float dr = dn * gn * rg * (1.0f - rg);
        const __nv_bfloat16 b_r = __float2bfloat16_rn(dr);
        const __nv_bfloat16 b_z = __float2bfloat16_rn(dz);
        __nv_bfloat16* pi = a.dgi + o * a.ldd + j;
        __nv_bfloat16* ph = a.dgh + o * a.ldd + j;
        pi[0] = b_r;
        pi[H] = b_z;
        pi[2 * H] = __float2bfloat16_rn(dn);
        ph[0] = b_r;
        ph[H] = b_z;
        ph[2 * H] = __float2bfloat16_rn(dghn);
        dh[mt][e] = dout * zg;
      }
    group_barrier(a.flags + grp, a.q * s);
    if (t > 0) load_in(t - 1);

    // phase B: dh[:, units] += dgh[t] @ W_hh[:, units]
    float acc[2][MT][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][mt][e] = 0.0f;
    stream_rows(ring, a.dgh + (size_t)t * a.B * a.ldd, a.ldd, a.rows, r0, a.row_end, K, G, a.chunk,
                [&](const __nv_bfloat16* buf, int k0, int klen) {
                  const int stride = a.chunk + SPAD;
#pragma unroll 2
                  for (int kk = 0; kk < klen; kk += 32) {
#pragma unroll
                    for (int p = 0; p < 2; ++p) {
                      if (kk + 16 * p >= klen) break;
                      uint32_t bw[2];
                      ldmatrix_x2(bw, wrow + k0 + kk + 16 * p);
#pragma unroll
                      for (int mt = 0; mt < MT; ++mt) {
                        uint32_t af[4];
                        ldmatrix_x4(af, buf + (mt * 16 + (lane & 15)) * stride + kk + 16 * p + (lane >> 4) * 8);
                        mma_bf16(acc[p][mt], af, bw);
                      }
                    }
                  }
                });
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dh[mt][e] += acc[0][mt][e] + acc[1][mt][e];
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (ok[mt][e]) a.dh0[(size_t)rowof[mt][e] * H + unit[e]] = dh[mt][e];
}

// One cooperative launch of `kernel` over g * q blocks; every block must be
// resident (one per SM) or the launch fails.
template <typename Args>
int launch_persistent(void (*kernel)(Args), const Args& args, int blocks, int threads,
                      size_t smem, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {const_cast<Args*>(&args)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(blocks), dim3(threads),
                                    params, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// a plan the kernels take: units a multiple of 8 (one warp each 8, at most
// 8 warps), rows 16 .. 64 in steps of 16, chunk a multiple of 16
bool bad_plan(int units, int rows, int q, int g, int chunk) {
  return units <= 0 || units % 8 || units > 64 || rows <= 0 || rows % 16 || rows > 64 ||
         q <= 0 || g <= 0 || chunk <= 0 || chunk % 16;
}

}  // namespace

// Each entry point launches on `stream` and returns the launch's
// cudaError_t (0 = success).

// The products of csrc/gemm.cuh: kind 0 the input gates (EPI_BIAS, A and B
// K-major), 1 the cotangent passed down (EPI_OUT, B (K, N)), 2 dW and db
// (EPI_DW, A and B (K, .)); n jobs in one launch.
extern "C" int molvax_gemm(int kind, const void* jobs, int n, void* stream) {
  if (n <= 0 || n > GEMM_MAX_JOBS) return (int)cudaErrorInvalidValue;
  GemmJobs js;
  memcpy(js.job, jobs, n * sizeof(GemmJob));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return (int)launch_gemm<true, true, EPI_BIAS>(js, n, s);
    case 1: return (int)launch_gemm<true, false, EPI_OUT>(js, n, s);
    case 2: return (int)launch_gemm<false, false, EPI_DW>(js, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The parts of a split product summed in order: parts (k, n) fp32 -> out (n).
extern "C" int molvax_sum_parts(const float* parts, int k, long long n, float* out, void* stream) {
  if (k <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const long long threads = 256, blocks = (n + threads - 1) / threads;
  sum_parts_kernel<<<(int)(blocks < 1024 ? blocks : 1024), (int)threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(parts, k, n, out);
  return (int)cudaGetLastError();
}

extern "C" int molvax_gru_rec(const float* gi, const void* whh, const float* bhh, const float* h0,
                              const void* h0b, void* hseq, void* rzn, void* ghn, int* flags, int T,
                              int B, int H, int ldw, int ldh, int units, int rows, int q, int g,
                              int chunk, int row_base, int row_end, void* stream) {
  if (bad_plan(units, rows, q, g, chunk) || T <= 0 || H <= 0 || ldw % 8 || ldh % 8 ||
      row_base < 0 || row_end > B || row_end <= row_base)
    return (int)cudaErrorInvalidValue;
  typedef const __nv_bfloat16* cbf;
  typedef __nv_bfloat16* bf;
  const RecArgs a{gi, static_cast<cbf>(whh), bhh, h0, static_cast<cbf>(h0b), static_cast<bf>(hseq),
                  static_cast<bf>(rzn), static_cast<bf>(ghn), flags, T, B, H, ldw, ldh,
                  units, rows, q, chunk, row_base, row_end};
  const size_t smem = rec_smem(H, units, rows, chunk);
  const int threads = units / 8 * 32;
  switch (rows / 16) {
    case 1: return launch_persistent(gru_rec_kernel<1>, a, g * q, threads, smem, stream);
    case 2: return launch_persistent(gru_rec_kernel<2>, a, g * q, threads, smem, stream);
    case 3: return launch_persistent(gru_rec_kernel<3>, a, g * q, threads, smem, stream);
    default: return launch_persistent(gru_rec_kernel<4>, a, g * q, threads, smem, stream);
  }
}

extern "C" int molvax_gru_sweep(const void* hseq, const void* h0b, const void* rzn, const void* ghn,
                                const float* ext, const float* dhf, const void* whhT, void* dgi,
                                void* dgh, float* dh0, int* flags, int T, int B, int H, int ldh,
                                int ldw, int ldd, int units, int rows, int q, int g, int chunk,
                                int row_base, int row_end, void* stream) {
  if (bad_plan(units, rows, q, g, chunk) || T <= 0 || H <= 0 || ldh % 8 || ldw % 8 || ldd % 8 ||
      row_base < 0 || row_end > B || row_end <= row_base)
    return (int)cudaErrorInvalidValue;
  typedef const __nv_bfloat16* cbf;
  typedef __nv_bfloat16* bf;
  const SweepArgs a{static_cast<cbf>(hseq), static_cast<cbf>(h0b), static_cast<cbf>(rzn),
                    static_cast<cbf>(ghn), ext, dhf, static_cast<cbf>(whhT), static_cast<bf>(dgi),
                    static_cast<bf>(dgh), dh0, flags, T, B, H, ldh, ldw, ldd,
                    units, rows, q, chunk, row_base, row_end};
  const size_t smem = sweep_smem(H, units, rows, chunk);
  const int threads = units / 8 * 32;
  switch (rows / 16) {
    case 1: return launch_persistent(gru_sweep_kernel<1>, a, g * q, threads, smem, stream);
    case 2: return launch_persistent(gru_sweep_kernel<2>, a, g * q, threads, smem, stream);
    case 3: return launch_persistent(gru_sweep_kernel<3>, a, g * q, threads, smem, stream);
    default: return launch_persistent(gru_sweep_kernel<4>, a, g * q, threads, smem, stream);
  }
}

// run_fused3's probe: gi0 (T, B, 3H) bf16 in place of x0 and W_ih0, hseq
// (L, T, B, H) out, no residuals. gi0 holds layer 0's bias; `zeros` (3H)
// stands in for b_ih0, so the gate math is the previous production kernel's.
extern "C" int molvax_gru_fused3_fwd(const void* gi0, const float* zeros, const void* wih,
                                     const float* bih, const void* whh, const float* bhh,
                                     const float* h0, void* hseq, int T, int B, int H, int L,
                                     void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || L < 2 || 2 * L > MAX_JOBS) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)L * RB * H * sizeof(float) +
                      (size_t)2 * L * H * RB * sizeof(__nv_bfloat16);
  auto kernel = gru_stack_fwd_kernel<true>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  typedef const __nv_bfloat16* cbf;
  kernel<<<(B + RB - 1) / RB, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      nullptr, nullptr, zeros, static_cast<cbf>(wih), bih, static_cast<cbf>(whh), bhh, h0,
      static_cast<__nv_bfloat16*>(hseq), nullptr, nullptr, T, B, 0, H, L,
      static_cast<cbf>(gi0));
  return (int)cudaGetLastError();
}
