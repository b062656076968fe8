// The scan route's free-running fp32 decoder step: one fused GRU-cell
// launch a layer and one head launch a step, after one packing launch and
// one latent-gate launch a decode.
//
// Replaces no Pallas kernel: the reference's scan decode (the constrained
// path, the Gumbel or greedy scan, evaluate()'s logit decodes, beam search)
// runs its fp32 GRU step as plain JAX ops, which the port ran as PyTorch
// ops: per layer two cuBLAS fp32 GEMMs, the bias adds, the gates' strided
// slices, sigmoid, tanh and the blend, then the stack and the head's GEMM,
// ~60 graph nodes a step. These kernels compute the same step, torch's GRU
// (gate order r|z|n):
//   r = sigmoid(x W_ir + b_ir + h W_hr + b_hr), z likewise,
//   n = tanh(x W_in + b_in + r (h W_hn + b_hn)), h' = (1 - z) n + z h,
//   logits = h'_top W_out + b_out,
// in fp32. Every product is 3xTF32 (csrc/gemm.cuh split_tf32, fp32_k8):
// hi.hi + hi.lo + lo.hi on mma.sync.m16n8k8.tf32 with fp32 sums, each
// k-tile summed apart and added to its total in fp32 registers, so nothing
// is rounded to bf16 or to a single TF32.
//
// Layer 0's input is [z_emb, the last one-hot]. Its z half is the same for
// all T steps: cell_kernel in its CELL_GATES mode computes it once a decode,
// z_emb W_iz + b_i0 -> gz (B, 3 Hp). Its one-hot half is a gather: row
// `code` of W_ic transposed (wc, (C, 3 Hp)); at t = 0 the start vector's
// product (sum over c of start[c] wc[c], in order) or zero.
//
// Layout (pack_kernel, once a decode, so that in-place updates of the
// weights show in the next decode, a CUDA Graph's replay included): every
// matrix fp32, zero-padded, 16-byte aligned: W_hh and W_ih (l >= 1) as
// (3 Hp, Hp), rows gate * Hp + unit, Hp = H rounded up to 32; W_iz as
// (3 Hp, Kz), Kz the latent width rounded up to 32; biases (3 Hp); W_out as
// (Cp, Hp), Cp = C rounded up to 8; z_emb as (B, Kz). The hidden states are
// (B, Hp) with zero padding columns, which the cells write.
//
// What bounds a step on an H100 (zinc250k: B = 256, H = 501, L = 3): 1.94
// GFLOP, 11.7 us as 3xTF32 at a third of the TF32 peak, 29 us at the fp32
// FMA peak; the weights (17 MB) sit in L2. mma.sync runs the split products
// at ~0.3 m16n8k8 a cycle an SM, so a layer l >= 1 (1.18 M of them) is ~16 us
// of tensor work over 132 SMs, and a grid of 2-D output tiles that filled
// the card would read its weights 8 times and its input 16 times from L2.
// What the design does about it: a block owns a tile of rows x units (all
// three gate columns of each unit), and a cluster of `slices` blocks splits
// the tile's K (the x half, then the h half) into contiguous k-tile ranges,
// so that few tiles fill the card in one wave: 2 x 16 tiles of 128 rows x
// 32 units x 3 slices = 96 blocks at zinc250k width. Each block streams its k-tiles of
// input rows and weight rows through a 3-stage cp.async ring and keeps, per
// (row, unit), four fp32 sums: r and z over x and h, and the x and h parts
// of n apart (n needs r times the h part alone). The cluster then meets
// once: each block stores its sums in its shared memory and, while the
// cluster meets, loads its share's biases, input gates and h; then each
// sums its share of the tile's rows over the cluster's blocks in rank order
// through distributed shared memory, runs the gate math and writes h' once.
// A fixed order and no atomics: two runs are bit for bit alike. Launches
// after a step's first are programmatic dependent launches: a cell's blocks
// take SMs as the launch before leaves them and prefetch their first
// weight tiles before they wait for it. The tile is 128 rows x 32 units
// (4 warps along the rows, 2 along the units), the shape measured fastest
// at every batch a cell runs; the cluster size adapts to (B, H, I) and to
// the clusters the card holds at once (kernels/generate.py cell_plan,
// card_clusters): the same kernels take 256 rows at H = 501, beam search's
// 1,280 rows and H = 1,024 with L = 4. On an
// H100 at zinc250k width a layer l >= 1 takes ~30 us, layer 0 ~19 us, a step
// with the head ~92 us against the cuBLAS and elementwise chain's ~244 us;
// a launch pays a fixed ~7 us (its first loads after the launch before it,
// the cluster's meeting, the gate math) beside ~1.9 us a k-tile.
//
// head_kernel: 16 rows a block, 8 warps splitting K, the partial sums met
// in shared memory in warp order, the classes in chunks of up to 64 (one
// chunk at C <= 64), the first maximum carried across them; it writes logits[:, t] straight into the
// decode's (B, T, C) output, the scores (logits * (1 / temperature) +
// noise[t], as torch computes a division by a scalar on the card; the
// logits when greedy) for auto_step, or the first maximum of the scores as
// the step's code where no automaton selects.

#include <cooperative_groups.h>
#include <string.h>

#include "common.cuh"
#include "gemm.cuh"

namespace cg = cooperative_groups;

namespace {

// -- packing -----------------------------------------------------------------

// dst (rg Rp, qg Qp) dense: element (gr Rp + r, gq Qp + q) is
// src[off + (gr R + r) sr + (gq Q + q) sq] for r < R, q < Q, else 0.
struct PackJob {
  const float* src;
  float* dst;
  long long sr, sq, off;
  int rg, R, Rp, qg, Q, Qp;
};

constexpr int PACK_MAX_JOBS = 32;
constexpr int PACK_THREADS = 256;

struct PackJobs {
  PackJob job[PACK_MAX_JOBS];
};

__global__ void __launch_bounds__(PACK_THREADS) pack_kernel(const __grid_constant__ PackJobs js) {
  const PackJob& j = js.job[blockIdx.y];
  const int cols = j.qg * j.Qp, n = j.rg * j.Rp * cols;
  for (int i = blockIdx.x * PACK_THREADS + threadIdx.x; i < n; i += gridDim.x * PACK_THREADS) {
    const int r = i / cols, q = i - r * cols;
    const int gr = r / j.Rp, ri = r - gr * j.Rp, gq = q / j.Qp, qi = q - gq * j.Qp;
    float v = 0.0f;
    if (ri < j.R && qi < j.Q) v = j.src[j.off + (long long)(gr * j.R + ri) * j.sr + (long long)(gq * j.Q + qi) * j.sq];
    j.dst[i] = v;
  }
}

// -- the GRU cell ----------------------------------------------------------------

enum CellMode { CELL_GATES = 0, CELL_FIRST = 1, CELL_NEXT = 2 };

__device__ __forceinline__ float4 f4_add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// component e (a constant once unrolled) of v
__device__ __forceinline__ float f4_at(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

__device__ __forceinline__ float4 f4_fma(float s, float4 w, float4 c) {
  return make_float4(fmaf(s, w.x, c.x), fmaf(s, w.y, c.y), fmaf(s, w.z, c.z), fmaf(s, w.w, c.w));
}

// Programmatic dependent launch: a step's launches after its first may
// start while the launch before them ends. A kernel lets its dependents
// launch at once (their blocks take SMs only as its own leave), prefetches
// what no earlier launch of the step writes (the packed weights), and waits
// for the launch before it to complete before it reads anything else. Where
// it was launched without the attribute the wait returns at once.
__device__ __forceinline__ void pdl_trigger() { asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory"); }
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

struct CellArgs {
  const float* x;      // (B, ldx): the padded z_emb (CELL_GATES), the layer below's h' (CELL_NEXT)
  const float* h;      // (B, Hp): the layer's h (CELL_FIRST, CELL_NEXT)
  const float* wx;     // (3 Hp, ldx): W_iz (CELL_GATES), W_ih (CELL_NEXT)
  const float* wh;     // (3 Hp, Hp): W_hh
  const float* bx;     // (3 Hp): b_ih (CELL_GATES, CELL_NEXT)
  const float* bh;     // (3 Hp): b_hh
  const float* gz;     // CELL_FIRST: (B, 3 Hp) z's gates, b_ih included
  const float* wc;     // CELL_FIRST: (C, 3 Hp) W_ih's one-hot columns, transposed
  const int* code;     // CELL_FIRST: row b's last code at code[b * code_ld]; null: the start vector
  const float* start;  // CELL_FIRST with no code: the start vector (C), or null for zeros
  float* out;          // h' (B, Hp), pad columns 0; CELL_GATES: the gates (B, 3 Hp)
  int B, H, Hp, ldx, C, code_ld;
};

constexpr int CELL_THREADS = 256;  // 8 warps
constexpr int CELL_NU = 2;         // 8-unit groups a warp: 16 units, 6 n8 tiles (r, z, n)
constexpr int CELL_MT = 2;         // m16 row tiles a warp: 32 rows
constexpr int SK = 32;             // k a stage
constexpr int SROW = SK + 4;       // words a staged row: 4 of padding keep fp32_k8's reads free of conflicts
constexpr int SSTAGES = 3;

// A tile: 4 warps along its rows, 2 along its units
constexpr int CELL_WR = 4;
constexpr int CELL_WU = 8 / CELL_WR;
constexpr int CELL_BM = 16 * CELL_MT * CELL_WR;  // 128 rows a block
constexpr int CELL_UN = 8 * CELL_NU * CELL_WU;   // 32 units a block
constexpr int CELL_BR = 3 * CELL_UN;             // weight rows a stage
constexpr int CELL_RLD = 4 * CELL_UN + 8;        // a row of the cluster's sums: r, z, n_x, n_h
constexpr size_t CELL_RING = (size_t)SSTAGES * (CELL_BM + CELL_BR) * SROW;
constexpr size_t CELL_RED = (size_t)CELL_BM * CELL_RLD;
constexpr size_t CELL_SMEM = 4 * (CELL_RING > CELL_RED ? CELL_RING : CELL_RED);
constexpr int CELL_ITEMS = (CELL_BM * CELL_UN / 4 + CELL_THREADS - 1) / CELL_THREADS;  // a thread's items of 4 units

template <int MODE>
__global__ void __launch_bounds__(CELL_THREADS, 1) cell_kernel(const CellArgs a) {
  extern __shared__ __align__(16) float csm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int slices = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int u0 = (blockIdx.x / slices) * CELL_UN, r0 = blockIdx.y * CELL_BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp / CELL_WU, wu = warp % CELL_WU;
  const int Hp = a.Hp;
  // this block's k-tiles: [kt0, kt1) of the x tiles, then the h tiles
  const int KX = MODE == CELL_FIRST ? 0 : a.ldx / SK;
  const int KT = KX + (MODE == CELL_GATES ? 0 : Hp / SK);
  const int kt0 = rank * KT / slices, nk = (rank + 1) * KT / slices - kt0;

  float* sA = csm;
  float* sB = csm + SSTAGES * CELL_BM * SROW;
  // stage i's input rows (A) and weight rows (B) of k-tile kt0 + i
  auto issue_a = [&](int i) {
    const int kt = kt0 + i;
    const bool xp = kt < KX;
    const float* A = xp ? a.x : a.h;
    const int ld = xp ? a.ldx : Hp, k0 = (xp ? kt : kt - KX) * SK;
    float* dA = sA + (i % SSTAGES) * CELL_BM * SROW;
    for (int c = tid; c < CELL_BM * (SK / 4); c += CELL_THREADS) {
      const int row = c / (SK / 4), kc = (c % (SK / 4)) * 4;
      const bool ok = r0 + row < a.B;  // rows past B read as zeros
      cp_async16(dA + row * SROW + kc, ok ? A + (size_t)(r0 + row) * ld + k0 + kc : A, ok ? 16 : 0);
    }
  };
  auto issue_b = [&](int i) {
    const int kt = kt0 + i;
    const bool xp = kt < KX;
    const float* W = xp ? a.wx : a.wh;
    const int ld = xp ? a.ldx : Hp, k0 = (xp ? kt : kt - KX) * SK;
    float* dB = sB + (i % SSTAGES) * CELL_BR * SROW;
    for (int c = tid; c < CELL_BR * (SK / 4); c += CELL_THREADS) {
      const int row = c / (SK / 4), kc = (c % (SK / 4)) * 4;
      const int gate = row / CELL_UN, u = u0 + row % CELL_UN;
      cp_async16(dB + row * SROW + kc, W + ((size_t)gate * Hp + u) * ld + k0 + kc, 16);
    }
  };
  auto issue = [&](int i) {
    if (i < nk) {
      issue_a(i);
      issue_b(i);
    }
    cp_async_commit();  // empty groups keep the count uniform
  };

  // acc[mt][set][half][e]: set r, z, n_x, n_h; half: the warp's units 0-7 or 8-15
  float acc[CELL_MT][4][CELL_NU][4];
#pragma unroll
  for (int mt = 0; mt < CELL_MT; ++mt)
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int h = 0; h < CELL_NU; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][s][h][e] = 0.0f;

  // the first stages' weights before the wait, one group; then their inputs, a group each
  pdl_trigger();
#pragma unroll
  for (int s = 0; s < SSTAGES - 1; ++s)
    if (s < nk) issue_b(s);
  cp_async_commit();
  pdl_wait();
#pragma unroll
  for (int s = 0; s < SSTAGES - 1; ++s) {
    if (s < nk) issue_a(s);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<SSTAGES - 2>();
    __syncthreads();
    issue(i + SSTAGES - 1);
    const float* tA = sA + (i % SSTAGES) * CELL_BM * SROW + wr * 16 * CELL_MT * SROW;
    const float* tB = sB + (i % SSTAGES) * CELL_BR * SROW + wu * 8 * CELL_NU * SROW;
    // n8 tile j of the warp: gate j / 2, units (j % 2) 8 .. + 8 of its 16
    float part[CELL_MT][3 * CELL_NU][4] = {};
#pragma unroll
    for (int kk = 0; kk < SK; kk += 8)
      fp32_k8(part, part, [&](int m, int k) { return tA[m * SROW + kk + k]; },
              [&](int k, int n) { return tB[((n >> 4) * CELL_UN + (n & 15)) * SROW + kk + k]; }, lane);
    const bool xp = kt0 + i < KX;
#pragma unroll
    for (int mt = 0; mt < CELL_MT; ++mt)
#pragma unroll
      for (int h = 0; h < CELL_NU; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mt][0][h][e] += part[mt][h][e];
          acc[mt][1][h][e] += part[mt][CELL_NU + h][e];
          if (xp)
            acc[mt][2][h][e] += part[mt][2 * CELL_NU + h][e];
          else
            acc[mt][3][h][e] += part[mt][2 * CELL_NU + h][e];
        }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is read no more: it becomes the sums' buffer

  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < CELL_MT; ++mt)
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int h = 0; h < CELL_NU; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = wr * 16 * CELL_MT + mt * 16 + g + 8 * (e >> 1);
          const int col = s * CELL_UN + wu * 8 * CELL_NU + h * 8 + 2 * tq + (e & 1);
          csm[row * CELL_RLD + col] = acc[mt][s][h][e];
        }

  // this block's share of the tile's rows, [rl0, rl1); a thread takes 4
  // units of a row (an item) at a time, at most CELL_ITEMS items, and loads
  // their operands from global memory while the cluster meets
  constexpr int U4 = CELL_UN / 4;
  const int rl0 = rank * CELL_BM / slices, items = ((rank + 1) * CELL_BM / slices - rl0) * U4;
  float4 xg[CELL_ITEMS][3], hb[CELL_ITEMS][3], hold[CELL_ITEMS];
#pragma unroll
  for (int it = 0; it < CELL_ITEMS; ++it) {
    const int i = tid + it * CELL_THREADS;
    const int row = r0 + rl0 + i / U4, u = u0 + (i % U4) * 4;
    if (i >= items || row >= a.B) continue;
    if constexpr (MODE == CELL_FIRST) {  // z's gates and the last code's, b_ih included
      const float* gz = a.gz + (size_t)row * 3 * Hp + u;
#pragma unroll
      for (int s = 0; s < 3; ++s) xg[it][s] = *reinterpret_cast<const float4*>(gz + s * Hp);
      if (a.code != nullptr) {
        const float* w = a.wc + (size_t)a.code[(size_t)row * a.code_ld] * 3 * Hp + u;
#pragma unroll
        for (int s = 0; s < 3; ++s) xg[it][s] = f4_add(xg[it][s], *reinterpret_cast<const float4*>(w + s * Hp));
      } else if (a.start != nullptr) {  // the start vector's product, in class order
        float4 c[3] = {};
        for (int k = 0; k < a.C; ++k) {
          const float sv = a.start[k];
          const float* w = a.wc + (size_t)k * 3 * Hp + u;
#pragma unroll
          for (int s = 0; s < 3; ++s) c[s] = f4_fma(sv, *reinterpret_cast<const float4*>(w + s * Hp), c[s]);
        }
#pragma unroll
        for (int s = 0; s < 3; ++s) xg[it][s] = f4_add(xg[it][s], c[s]);
      }
    } else {  // b_ih
#pragma unroll
      for (int s = 0; s < 3; ++s) xg[it][s] = *reinterpret_cast<const float4*>(a.bx + s * Hp + u);
    }
    if constexpr (MODE != CELL_GATES) {
#pragma unroll
      for (int s = 0; s < 3; ++s) hb[it][s] = *reinterpret_cast<const float4*>(a.bh + s * Hp + u);
      hold[it] = *reinterpret_cast<const float4*>(a.h + (size_t)row * Hp + u);
    }
  }
  cluster.sync();

#pragma unroll
  for (int it = 0; it < CELL_ITEMS; ++it) {
    const int i = tid + it * CELL_THREADS;
    const int rl = rl0 + i / U4, ul = (i % U4) * 4;
    const int row = r0 + rl, u = u0 + ul;
    if (i >= items || row >= a.B) continue;
    float4 v[4] = {};  // r, z, n_x, n_h, summed in rank order
    for (int q = 0; q < slices; ++q) {
      const float* p = cluster.map_shared_rank(csm, q) + rl * CELL_RLD + ul;
#pragma unroll
      for (int s = 0; s < 4; ++s) v[s] = f4_add(v[s], *reinterpret_cast<const float4*>(p + s * CELL_UN));
    }
    if constexpr (MODE == CELL_GATES) {
      float* o = a.out + (size_t)row * 3 * Hp + u;
#pragma unroll
      for (int s = 0; s < 3; ++s) *reinterpret_cast<float4*>(o + s * Hp) = f4_add(v[s], xg[it][s]);
    } else {
      float hn[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float gin = MODE == CELL_FIRST ? f4_at(xg[it][2], e) : f4_at(v[2], e) + f4_at(xg[it][2], e);
        const float rg = sigmoid_f(f4_at(xg[it][0], e) + (f4_at(v[0], e) + f4_at(hb[it][0], e)));
        const float zg = sigmoid_f(f4_at(xg[it][1], e) + (f4_at(v[1], e) + f4_at(hb[it][1], e)));
        const float n = tanhf(gin + rg * (f4_at(v[3], e) + f4_at(hb[it][2], e)));
        hn[e] = u + e < a.H ? (1.0f - zg) * n + zg * f4_at(hold[it], e) : 0.0f;
      }
      *reinterpret_cast<float4*>(a.out + (size_t)row * Hp + u) = make_float4(hn[0], hn[1], hn[2], hn[3]);
    }
  }
  cluster.sync();  // no block leaves while another reads its sums
}

template <int MODE>
cudaError_t launch_cell(const CellArgs& a, int slices, cudaStream_t stream) {
  if (a.Hp % CELL_UN) return cudaErrorInvalidValue;
  auto kernel = cell_kernel<MODE>;
  // the shared-memory opt-in is the current device's: set at every launch
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CELL_SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(slices * (a.Hp / CELL_UN)), (unsigned)((a.B + CELL_BM - 1) / CELL_BM));
  cfg.blockDim = dim3(CELL_THREADS);
  cfg.dynamicSmemBytes = CELL_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // a step's cells start while the launch before them ends (pdl_wait); z's
  // gates, after the packing, wait for it whole
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = MODE != CELL_GATES;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// -- the head ------------------------------------------------------------------

constexpr int HEAD_WARPS = 8;
constexpr int HEAD_BATCH = 4;  // k8 steps a warp loads at once

struct HeadArgs {
  const float* h;      // (B, Hp) the top layer's h'
  const float* w;      // (Cp, Hp) W_out, zero rows past C
  const float* b;      // (Cp) b_out
  float* logits;       // row b's C logits at logits[b * logits_ld]
  float* scores;       // (B, C) the scores, or null
  const float* noise;  // (B, C) the step's noise, or null (greedy)
  int* code;           // row b's first maximum of the scores at code[b * code_ld], or null
  float inv_temp;      // 1 / temperature in fp32
  int B, C, Hp, logits_ld, code_ld;
};

// NT n8 tiles a chunk: the classes in chunks of 8 NT, a chunk's logits
// summed over the warps in shared memory before the next chunk's products
template <int NT>
__global__ void __launch_bounds__(HEAD_WARPS * 32) head_kernel(const HeadArgs a) {
  __shared__ float red[HEAD_WARPS][16][8 * NT + 1];
  __shared__ float sc[16][8 * NT];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tq = lane & 3;
  const int r0 = blockIdx.x * 16;
  pdl_trigger();
  pdl_wait();  // h' is the launch before's
  // thread m < 16: row r0 + m's first maximum of the scores so far, a NaN the maximum (torch.argmax)
  int best = 0;
  float top = 0.0f;
  const int steps = a.Hp / 8;
  for (int c0 = 0; c0 < a.C; c0 += 8 * NT) {
    const int cn = min(8 * NT, a.C - c0);
    float acc[1][NT][4] = {};
    // warp w takes the k8 steps w, w + 8, ...: HEAD_BATCH of them a round,
    // every operand of the round loaded first, then summed apart into acc
    for (int s0 = warp; s0 < steps; s0 += HEAD_BATCH * HEAD_WARPS) {
      float av[HEAD_BATCH][4], bv[HEAD_BATCH][NT][2];
#pragma unroll
      for (int q = 0; q < HEAD_BATCH; ++q) {
        const int k0 = 8 * (s0 + q * HEAD_WARPS);
        const bool on = k0 < a.Hp;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = r0 + g + 8 * (r & 1);
          av[q][r] = on && row < a.B ? __ldg(a.h + (size_t)row * a.Hp + k0 + tq + 4 * (r >> 1)) : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = c0 + 8 * j + g;
#pragma unroll
          for (int h = 0; h < 2; ++h) bv[q][j][h] = on && c < a.C ? __ldg(a.w + (size_t)c * a.Hp + k0 + tq + 4 * h) : 0.0f;
        }
      }
      float part[1][NT][4] = {};
#pragma unroll
      for (int q = 0; q < HEAD_BATCH; ++q)  // fp32_k8 reads a(g + 8 (r & 1), tq + 4 (r >> 1)) and b(tq + 4 h, 8 j + g)
        fp32_k8(part, part, [&](int m, int k) { return av[q][((m >> 3) & 1) | ((k >> 2) << 1)]; },
                [&](int k, int n) { return bv[q][n >> 3][k >> 2]; }, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][j][e] += part[0][j][e];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[warp][g + 8 * (e >> 1)][8 * j + 2 * tq + (e & 1)] = acc[0][j][e];
    __syncthreads();
    for (int i = threadIdx.x; i < 16 * cn; i += HEAD_WARPS * 32) {
      const int m = i / cn, cl = i - m * cn, c = c0 + cl, row = r0 + m;
      if (row >= a.B) continue;
      float s = red[0][m][cl];
#pragma unroll
      for (int w = 1; w < HEAD_WARPS; ++w) s += red[w][m][cl];
      const float logit = s + a.b[c];
      a.logits[(size_t)row * a.logits_ld + c] = logit;
      const float v = a.noise == nullptr
                          ? logit
                          : __fadd_rn(__fmul_rn(logit, a.inv_temp), a.noise[(size_t)row * a.C + c]);
      if (a.scores != nullptr) a.scores[(size_t)row * a.C + c] = v;
      sc[m][cl] = v;
    }
    __syncthreads();  // the chunk's scores are in sc; red is free again
    if (a.code != nullptr && threadIdx.x < 16) {
      for (int cl = 0; cl < cn; ++cl) {
        const float v = sc[threadIdx.x][cl];
        if (c0 + cl == 0 || (!isnan(top) && (v > top || isnan(v)))) {
          top = v;
          best = c0 + cl;
        }
      }
    }
    __syncthreads();  // sc is read before the next chunk writes it
  }
  if (a.code != nullptr && threadIdx.x < 16 && r0 + threadIdx.x < a.B)
    a.code[(size_t)(r0 + threadIdx.x) * a.code_ld] = best;
}

template <int NT>
cudaError_t launch_head(const HeadArgs& a, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((a.B + 15) / 16));
  cfg.blockDim = dim3(HEAD_WARPS * 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, head_kernel<NT>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns the launch's
// cudaError_t (0 = success).

// n packing jobs (PackJob) in one launch.
extern "C" int molvax_step_pack(const void* jobs, int n, int max_elems, void* stream) {
  if (n <= 0 || n > PACK_MAX_JOBS || max_elems <= 0) return (int)cudaErrorInvalidValue;
  PackJobs js;
  memset(&js, 0, sizeof(js));
  memcpy(js.job, jobs, n * sizeof(PackJob));
  const int blocks = (max_elems + PACK_THREADS - 1) / PACK_THREADS;
  pack_kernel<<<dim3((unsigned)(blocks < 1024 ? blocks : 1024), (unsigned)n), PACK_THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(js);
  return (int)cudaGetLastError();
}

// One cell launch: mode 0 z's gates, 1 layer 0's step, 2 a layer l >= 1's
// step; `slices` the blocks of a cluster.
extern "C" int molvax_step_cell(const void* args, int mode, int slices, void* stream) {
  CellArgs a;
  memcpy(&a, args, sizeof(a));
  const int KT = (mode == 1 ? 0 : a.ldx / SK) + (mode == 0 ? 0 : a.Hp / SK);
  if (a.B <= 0 || a.H <= 0 || a.Hp % SK || a.ldx % SK || a.H > a.Hp || slices < 1 || slices > 8 ||
      slices > KT || (mode == 1 && (a.gz == nullptr || a.wc == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case CELL_GATES: return (int)launch_cell<CELL_GATES>(a, slices, s);
    case CELL_FIRST: return (int)launch_cell<CELL_FIRST>(a, slices, s);
    case CELL_NEXT: return (int)launch_cell<CELL_NEXT>(a, slices, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The clusters of `slices` cell blocks that the card holds at once
// (cudaOccupancyMaxActiveClusters), into *clusters; the cell kernel's modes
// share their resources.
extern "C" int molvax_step_cell_clusters(int slices, int* clusters) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(CELL_THREADS);
  cfg.gridDim = dim3((unsigned)slices * 64);
  cfg.dynamicSmemBytes = CELL_SMEM;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto kernel = cell_kernel<CELL_NEXT>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CELL_SMEM);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// One head launch (HeadArgs): the classes in chunks of 64 past 64.
extern "C" int molvax_step_head(const void* args, void* stream) {
  HeadArgs a;
  memcpy(&a, args, sizeof(a));
  if (a.B <= 0 || a.C < 1 || a.Hp % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((a.C + 7) / 8) {
    case 1: return (int)launch_head<1>(a, s);
    case 2: return (int)launch_head<2>(a, s);
    case 3: return (int)launch_head<3>(a, s);
    case 4: return (int)launch_head<4>(a, s);
    case 5: return (int)launch_head<5>(a, s);
    case 6: return (int)launch_head<6>(a, s);
    case 7: return (int)launch_head<7>(a, s);
    default: return (int)launch_head<8>(a, s);
  }
}
