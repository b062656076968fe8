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
// Strict fp32 (the per-layer route's compute_dtype='float32') runs the same
// kernels with E = float: every operand, residual and cotangent fp32, the
// products fp32, or 3xTF32 split products of fp32 accuracy (csrc/gemm.cuh,
// fp32_k8), never a single-pass TF32 or bf16 product. An fp32 W_hh slice
// takes twice the shared memory, so the plan (stack_plan with 4-byte
// elements) gives a block half the units and twice the rows (zinc250k,
// B=256: 8 groups x 16 blocks of 32 units and 32 rows) and streams the row
// block in chunks (128 columns forward, 144 in the sweep). A 3xTF32 k-step
// is three products and six operand splits where bf16 has one product, so
// the fp32 warps of a block split its rows as well as its units
// (warp_tile, up to 8 warps), the cross terms sum into accumulators of
// their own (two chains in flight a k-step), and the main loops carry no
// branch, so that loads run ahead of the products. The sweep, whose warp
// tile (16 rows x 8 units) would read and split six operand words per
// three products, splits its K across 8 warps instead where the plan's
// tiles fit (gru_sweep_kernel's RT x NG instances). Where a step's time
// goes: PERF.md (section 6), from stack_probe.py --steps.

#include <string.h>

#include "common.cuh"
#include "gemm.cuh"
#include "persist.cuh"

namespace {

// -- the persistent recurrences ---------------------------------------------

// The group's row block of E (rows x K of a (., ld) array, rows from r0,
// valid below rlim, columns valid below klim) streamed in chunks of
// `chunk` columns through `stages` (1 or 2) buffers of rows x (chunk +
// SPAD); body(buf, k0, klen) runs on each chunk once it landed. Earlier
// cp.async groups of the thread are waited for too.
template <typename E, typename Body>
__device__ __forceinline__ void stream_rows(E* ring, const E* src, int ld, int rows, int r0, int rlim,
                                            int K, int klim, int chunk, Body body) {
  constexpr int EPC = 16 / (int)sizeof(E);  // elements per 16-byte chunk
  const int nch = (K + chunk - 1) / chunk;
  const int cpr = chunk / EPC;  // 16-byte chunks per row
  const int stride = chunk + SPAD<E>;
  auto issue = [&](int c) {
    E* buf = ring + (size_t)(c & 1) * rows * stride;
    for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
      const int row = i / cpr, kc = (i % cpr) * EPC;
      const int r = r0 + row, k = c * chunk + kc;
      const int bytes = r < rlim ? chunk_bytes<E>(k, klim) : 0;
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
template <typename E, typename RowPtr>
__device__ __forceinline__ void load_resident(E* s, int n, int K, int Kp, const E* base, RowPtr src_row) {
  constexpr int EPC = 16 / (int)sizeof(E);
  const int cpr = Kp / EPC;
  for (int i = threadIdx.x; i < n * cpr; i += blockDim.x) {
    const int row = i / cpr, kc = (i % cpr) * EPC;
    const E* g = src_row(row);
    const int bytes = g ? chunk_bytes<E>(kc, K) : 0;
    cp_async16(s + (size_t)row * (Kp + SPAD<E>) + kc, bytes ? g + kc : base, bytes);
  }
  cp_async_commit();
}

// E: the storage type, __nv_bfloat16 or float (strict fp32)
template <typename E>
struct RecArgs {
  const float* gi;            // (T, B, 3H) fp32, bias included
  const E* whh;               // (3H, ldw) torch layout
  const float* bhh;           // (3H)
  const float* h0;            // (B, H) fp32
  const E* h0b;               // (B, ldh) h0 in E
  E* hseq;                    // (T, B, ldh)
  E* rzn;                     // (T, B, 3H)
  E* ghn;                     // (T, B, H)
  int* flags;                 // (g) zeros
  int T, B, H, ldw, ldh;
  int units, rows, q, chunk;  // the plan
  int row_base, row_end;      // the batch rows of this launch
};

template <typename E>
struct SweepArgs {
  const E* hseq;              // (T, B, ldh) the layer's h sequence
  const E* h0b;               // (B, ldh)
  const E* rzn;               // (T, B, 3H)
  const E* ghn;               // (T, B, H)
  const float* ext;           // (T, B, H) fp32 cotangent from above
  const float* dhf;           // (B, H) fp32 cotangent of h_final
  const E* whhT;              // (H, ldw): W_hh transposed
  E* dgi;                     // (T, B, ldd)
  E* dgh;                     // (T, B, ldd)
  float* dh0;                 // (B, H)
  int* flags;
  int T, B, H, ldh, ldw, ldd;
  int units, rows, q, chunk;
  int row_base, row_end;
};

// the resident W_hh slice, then the ring of one or two chunk buffers
template <typename E>
size_t rec_smem(int H, int units, int rows, int chunk) {
  const int K = round16(H);
  return ((size_t)3 * units * (K + SPAD<E>) + (size_t)(chunk >= K ? 1 : 2) * rows * (chunk + SPAD<E>)) *
         sizeof(E);
}

template <typename E>
size_t sweep_smem(int H, int units, int rows, int chunk) {
  const int K = round16(3 * H);
  return ((size_t)units * (K + SPAD<E>) + (size_t)(chunk >= K ? 1 : 2) * rows * (chunk + SPAD<E>)) *
         sizeof(E);
}

// Which of the block's (row, unit) pairs warp w holds: units [8 wu, 8 wu +
// 8) of the slice, for MT m16 row tiles from row wr of the group's block of
// rows. bf16: all of them (wu = w, wr = 0, MT = rows / 16). fp32, whose
// products take 4-6 times as long: the warps of a block split the rows too
// (warp_rows), so that up to 8 warps share a step.
template <typename E, int MT>
__device__ __forceinline__ void warp_tile(int warp, int units, int& wu, int& wr) {
  wu = sizeof(E) == 2 ? warp : warp % (units / 8);
  wr = sizeof(E) == 2 ? 0 : warp / (units / 8) * 16 * MT;
}

// Forward recurrence of one layer, MT m16 row tiles a warp (warp_tile):
// warp w owns 8 units of the block's slice, their r, z and n columns. bf16
// products on mma.sync.m16n8k16, fp32 ones through fp32_k8: the same
// accumulator fragments either way.
template <typename E, int MT>
__global__ void __launch_bounds__(256) gru_rec_kernel(const RecArgs<E> a) {
  extern __shared__ __align__(16) unsigned char rsmem[];
  const int H = a.H, G = 3 * H, K = round16(H);
  const int grp = blockIdx.x / a.q, u0 = (blockIdx.x % a.q) * a.units;
  const int r0 = a.row_base + grp * a.rows;
  E* sW = reinterpret_cast<E*>(rsmem);
  E* ring = sW + (size_t)3 * a.units * (K + SPAD<E>);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int wu, wr;
  warp_tile<E, MT>(warp, a.units, wu, wr);

  // W_hh rows gate * H + u0 + u, resident for the whole sweep
  load_resident(sW, 3 * a.units, H, K, a.whh, [&](int row) -> const E* {
    const int gate = row / a.units, u = u0 + row % a.units;
    return u < H ? a.whh + (size_t)(gate * H + u) * a.ldw : nullptr;
  });

  // this thread's (row, unit) pairs: fragment element (mt, e)
  int rowof[MT][4], unit[4];
  bool ok[MT][4];
  float h[MT][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) unit[e] = u0 + wu * 8 + (lane & 3) * 2 + (e & 1);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      rowof[mt][e] = r0 + wr + mt * 16 + (lane >> 2) + (e >> 1) * 8;
      ok[mt][e] = rowof[mt][e] < a.row_end && unit[e] < H && unit[e] < u0 + a.units;
      h[mt][e] = ok[mt][e] ? a.h0[(size_t)rowof[mt][e] * H + unit[e]] : 0.0f;
    }
  float bh[3][4];
#pragma unroll
  for (int gte = 0; gte < 3; ++gte)
#pragma unroll
    for (int e = 0; e < 4; ++e) bh[gte][e] = unit[e] < H ? a.bhh[gte * H + unit[e]] : 0.0f;

  const E* wrow = sW + (size_t)(wu * 8 + (lane & 7)) * (K + SPAD<E>) + ((lane >> 3) & 1) * 8;
  const size_t wgate = (size_t)a.units * (K + SPAD<E>);
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
    float acc[MT][3][4], corr[MT][3][4];  // corr: fp32's cross terms
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int gte = 0; gte < 3; ++gte)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][gte][e] = corr[mt][gte][e] = 0.0f;
    const E* src = t == 0 ? a.h0b : a.hseq + (size_t)(t - 1) * a.B * a.ldh;
    stream_rows(ring, src, a.ldh, a.rows, r0, a.row_end, K, H, a.chunk,
                [&](const E* buf, int k0, int klen) {
                  const int stride = a.chunk + SPAD<E>;
                  if constexpr (sizeof(E) == 2) {
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
                  } else {  // column n of the warp's tile: gate n / 8, unit n % 8
                    const E* w = sW + (size_t)wu * 8 * (K + SPAD<E>) + k0;
                    auto k8 = [&](int kk) {
                      fp32_k8(acc, corr, [&](int m, int k) { return buf[(wr + m) * stride + kk + k]; },
                              [&](int k, int n) { return w[(n >> 3) * wgate + (n & 7) * (K + SPAD<E>) + kk + k]; },
                              lane);
                    };
                    int kk = 0;
                    for (; kk + 32 <= klen; kk += 32) {  // no branch inside: loads run ahead
#pragma unroll
                      for (int s = 0; s < 4; ++s) k8(kk + 8 * s);
                    }
                    for (; kk < klen; kk += 8) k8(kk);
                  }
                });
    if constexpr (sizeof(E) == 4) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int gte = 0; gte < 3; ++gte)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][gte][e] += corr[mt][gte][e];
    }
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
          a.hseq[o * a.ldh + j] = from_f<E>(hv);
          a.rzn[o * G + j] = from_f<E>(rg);
          a.rzn[o * G + H + j] = from_f<E>(zg);
          a.rzn[o * G + 2 * H + j] = from_f<E>(n);
          a.ghn[o * H + j] = from_f<E>(gn);
        }
      }
    if (t + 1 < a.T) group_barrier(a.flags + grp, a.q * (t + 1));
  }
}

// Reverse sweep of one layer. Warp w owns 8 units of the slice for MT row
// tiles (warp_tile): phase A's gate cotangents and dh for them, and their
// columns of phase B's product (accumulator sets over alternate k steps, for
// chains in flight: two in bf16, four in fp32, whose 3xTF32 k-step is three
// dependent products). The fp32 instances with RT x NG > 0 split phase B's
// K instead (8 warps, MT = 1): every warp computes all RT x NG tiles (RT =
// rows / 16, NG = units / 8) for every 8th k-step, so that a k-step's
// operand reads and splits serve NG (A) and RT (B) tiles, not one; the 8
// partial sums meet in the ring, free after the last chunk, and the warp
// that owns a tile in phase A adds them up in warp order (deterministic).
template <typename E, int MT, int RT = 0, int NG = 0>
__global__ void __launch_bounds__(256) gru_sweep_kernel(const SweepArgs<E> a) {
  constexpr bool KSPLIT = RT > 0;
  static_assert(!KSPLIT || (MT == 1 && sizeof(E) == 4 && RT * NG <= 8), "the K split: fp32, 8 warps");
  extern __shared__ __align__(16) unsigned char ssmem[];
  const int H = a.H, G = 3 * H, K = round16(G);
  const int grp = blockIdx.x / a.q, u0 = (blockIdx.x % a.q) * a.units;
  const int r0 = a.row_base + grp * a.rows;
  E* sW = reinterpret_cast<E*>(ssmem);
  E* ring = sW + (size_t)a.units * (K + SPAD<E>);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int wu, wr;
  warp_tile<E, MT>(warp, a.units, wu, wr);

  // W_hh[:, u0 + u] as shared row u, resident for the whole sweep
  load_resident(sW, a.units, G, K, a.whhT, [&](int row) -> const E* {
    const int u = u0 + row;
    return u < H ? a.whhT + (size_t)u * a.ldw : nullptr;
  });

  int rowof[MT][4], unit[4];
  bool ok[MT][4];
  float dh[MT][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) unit[e] = u0 + wu * 8 + (lane & 3) * 2 + (e & 1);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      rowof[mt][e] = r0 + wr + mt * 16 + (lane >> 2) + (e >> 1) * 8;
      ok[mt][e] = rowof[mt][e] < a.row_end && unit[e] < H && unit[e] < u0 + a.units &&
                  (!KSPLIT || warp < RT * NG);
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
        in[mt][e][0] = to_f(a.rzn[o * G + j]);
        in[mt][e][1] = to_f(a.rzn[o * G + H + j]);
        in[mt][e][2] = to_f(a.rzn[o * G + 2 * H + j]);
        in[mt][e][3] = to_f(a.ghn[o * H + j]);
        in[mt][e][4] = to_f(t > 0 ? a.hseq[(o - a.B) * a.ldh + j] : a.h0b[(size_t)row * a.ldh + j]);
        in[mt][e][5] = a.ext[o * H + j];
      }
  };
  load_in(a.T - 1);

  const E* wrow = sW + (size_t)(wu * 8 + (lane & 7)) * (K + SPAD<E>) + ((lane >> 3) & 1) * 8;
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
        const E b_r = from_f<E>(dr);
        const E b_z = from_f<E>(dz);
        E* pi = a.dgi + o * a.ldd + j;
        E* ph = a.dgh + o * a.ldd + j;
        pi[0] = b_r;
        pi[H] = b_z;
        pi[2 * H] = from_f<E>(dn);
        ph[0] = b_r;
        ph[H] = b_z;
        ph[2 * H] = from_f<E>(dghn);
        dh[mt][e] = dout * zg;
      }
    group_barrier(a.flags + grp, a.q * s);
    if (t > 0) load_in(t - 1);

    // phase B: dh[:, units] += dgh[t] @ W_hh[:, units]
    if constexpr (KSPLIT) {
      float kacc[RT][NG][4], kcorr[RT][NG][4];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int u = 0; u < NG; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) kacc[i][u][e] = kcorr[i][u][e] = 0.0f;
      stream_rows(ring, a.dgh + (size_t)t * a.B * a.ldd, a.ldd, a.rows, r0, a.row_end, K, G, a.chunk,
                  [&](const E* buf, int k0, int klen) {
                    const int stride = a.chunk + SPAD<E>;
                    // this warp's k-steps: those j = warp (mod 8) of the row
                    for (int kk = 8 * ((warp - k0 / 8 % 8 + 8) % 8); kk < klen; kk += 64)
                      fp32_k8(kacc, kcorr, [&](int m, int k) { return buf[m * stride + kk + k]; },
                              [&](int k, int n) { return sW[n * (K + SPAD<E>) + k0 + kk + k]; }, lane);
                  });
      // the partial sums in the ring: (warp, tile, element, lane)
      float* red = reinterpret_cast<float*>(ring);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int u = 0; u < NG; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red[((warp * RT * NG + i * NG + u) * 4 + e) * 32 + lane] = kacc[i][u][e] + kcorr[i][u][e];
      __syncthreads();
      if (warp < RT * NG) {  // tile `warp` is this warp's in phase A (warp_tile)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sum = 0.0f;
          for (int w = 0; w < 8; ++w) sum += red[((w * RT * NG + warp) * 4 + e) * 32 + lane];
          dh[0][e] += sum;
        }
      }
      continue;  // the next step's ring copy follows phase A's barrier
    }
    constexpr int NP = sizeof(E) == 2 ? 2 : 4;
    float acc[NP][MT][4], corr[NP][MT][4];  // corr: fp32's cross terms
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][mt][e] = corr[p][mt][e] = 0.0f;
    stream_rows(ring, a.dgh + (size_t)t * a.B * a.ldd, a.ldd, a.rows, r0, a.row_end, K, G, a.chunk,
                [&](const E* buf, int k0, int klen) {
                  const int stride = a.chunk + SPAD<E>;
                  if constexpr (sizeof(E) == 2) {
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
                  } else {  // the warp's 8 units are the tile's 8 columns
                    const E* w = sW + (size_t)wu * 8 * (K + SPAD<E>) + k0;
                    auto k8 = [&](float(&c)[MT][4], float(&r)[MT][4], int kk) {
                      using Tile = float(&)[MT][1][4];
                      fp32_k8(reinterpret_cast<Tile>(c), reinterpret_cast<Tile>(r),
                              [&](int m, int k) { return buf[(wr + m) * stride + kk + k]; },
                              [&](int k, int n) { return w[n * (K + SPAD<E>) + kk + k]; }, lane);
                    };
                    int kk = 0;
                    for (; kk + 8 * NP <= klen; kk += 8 * NP) {  // no branch inside: loads run ahead
#pragma unroll
                      for (int p = 0; p < NP; ++p) k8(acc[p], corr[p], kk + 8 * p);
                    }
#pragma unroll
                    for (int p = 0; p < NP - 1; ++p)
                      if (kk + 8 * p < klen) k8(acc[p], corr[p], kk + 8 * p);
                  }
                });
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (NP == 2)
          dh[mt][e] += acc[0][mt][e] + acc[1][mt][e];
        else
          dh[mt][e] += ((acc[0][mt][e] + corr[0][mt][e]) + (acc[1][mt][e] + corr[1][mt][e])) +
                       ((acc[2][mt][e] + corr[2][mt][e]) + (acc[3][mt][e] + corr[3][mt][e]));
      }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (ok[mt][e]) a.dh0[(size_t)rowof[mt][e] * H + unit[e]] = dh[mt][e];
}

// a plan the kernels take: units a multiple of 8 (one warp each 8, at most
// 8 warps), rows 16 .. 64 in steps of 16, chunk a multiple of 16
bool bad_plan(int units, int rows, int q, int g, int chunk) {
  return units <= 0 || units % 8 || units > 64 || rows <= 0 || rows % 16 || rows > 64 ||
         q <= 0 || g <= 0 || chunk <= 0 || chunk % 16;
}

// Row tiles that the warps of a block split between them (warp_tile): 1 for
// bf16; for fp32 the most that divides the block's rows / 16 with at most 8
// warps a block. A warp then holds rows / 16 / warp_rows tiles.
template <typename E>
int warp_rows(int units, int rows) {
  if (sizeof(E) == 2) return 1;
  int rt = min(rows / 16, 8 / (units / 8));
  while ((rows / 16) % rt) --rt;
  return rt;
}

template <typename E>
int gru_rec(const float* gi, const void* whh, const float* bhh, const float* h0, const void* h0b,
            void* hseq, void* rzn, void* ghn, int* flags, int T, int B, int H, int ldw, int ldh,
            int units, int rows, int q, int g, int chunk, int row_base, int row_end, void* stream) {
  constexpr int EPC = 16 / (int)sizeof(E);
  if (bad_plan(units, rows, q, g, chunk) || T <= 0 || H <= 0 || ldw % EPC || ldh % EPC ||
      row_base < 0 || row_end > B || row_end <= row_base)
    return (int)cudaErrorInvalidValue;
  const RecArgs<E> a{gi, static_cast<const E*>(whh), bhh, h0, static_cast<const E*>(h0b),
                     static_cast<E*>(hseq), static_cast<E*>(rzn), static_cast<E*>(ghn), flags,
                     T, B, H, ldw, ldh, units, rows, q, chunk, row_base, row_end};
  const size_t smem = rec_smem<E>(H, units, rows, chunk);
  const int rt = warp_rows<E>(units, rows), threads = units / 8 * 32 * rt;
  switch (rows / 16 / rt) {
    case 1: return launch_persistent(gru_rec_kernel<E, 1>, a, g * q, threads, smem, stream);
    case 2: return launch_persistent(gru_rec_kernel<E, 2>, a, g * q, threads, smem, stream);
    case 3: return launch_persistent(gru_rec_kernel<E, 3>, a, g * q, threads, smem, stream);
    default: return launch_persistent(gru_rec_kernel<E, 4>, a, g * q, threads, smem, stream);
  }
}

// The fp32 sweep's K-split instance for RT row tiles and NG unit tiles a
// block, or null where none is built (those plans take the warp tiles)
template <typename E>
void (*ksplit_sweep(int rt, int ng))(SweepArgs<E>) {
  if constexpr (sizeof(E) == 4) {
    switch (rt * 16 + ng) {
      case 1 * 16 + 2: return gru_sweep_kernel<E, 1, 1, 2>;
      case 1 * 16 + 4: return gru_sweep_kernel<E, 1, 1, 4>;
      case 2 * 16 + 2: return gru_sweep_kernel<E, 1, 2, 2>;
      case 2 * 16 + 4: return gru_sweep_kernel<E, 1, 2, 4>;
      case 4 * 16 + 2: return gru_sweep_kernel<E, 1, 4, 2>;
    }
  }
  return nullptr;
}

template <typename E>
int gru_sweep(const void* hseq, const void* h0b, const void* rzn, const void* ghn, const float* ext,
              const float* dhf, const void* whhT, void* dgi, void* dgh, float* dh0, int* flags, int T,
              int B, int H, int ldh, int ldw, int ldd, int units, int rows, int q, int g, int chunk,
              int row_base, int row_end, void* stream) {
  constexpr int EPC = 16 / (int)sizeof(E);
  if (bad_plan(units, rows, q, g, chunk) || T <= 0 || H <= 0 || ldh % EPC || ldw % EPC || ldd % EPC ||
      row_base < 0 || row_end > B || row_end <= row_base)
    return (int)cudaErrorInvalidValue;
  const SweepArgs<E> a{static_cast<const E*>(hseq), static_cast<const E*>(h0b), static_cast<const E*>(rzn),
                       static_cast<const E*>(ghn), ext, dhf, static_cast<const E*>(whhT),
                       static_cast<E*>(dgi), static_cast<E*>(dgh), dh0, flags, T, B, H, ldh, ldw, ldd,
                       units, rows, q, chunk, row_base, row_end};
  const size_t smem = sweep_smem<E>(H, units, rows, chunk);
  // the K split where an instance exists and the ring holds the 8 warps'
  // partial sums
  const size_t ring = smem - (size_t)units * (round16(3 * H) + SPAD<E>) * sizeof(E);
  auto ksplit = ksplit_sweep<E>(rows / 16, units / 8);
  if (ksplit && ring >= (size_t)8 * (rows / 16) * (units / 8) * 4 * 32 * sizeof(float))
    return launch_persistent(ksplit, a, g * q, 256, smem, stream);
  const int rt = warp_rows<E>(units, rows), threads = units / 8 * 32 * rt;
  switch (rows / 16 / rt) {
    case 1: return launch_persistent(gru_sweep_kernel<E, 1>, a, g * q, threads, smem, stream);
    case 2: return launch_persistent(gru_sweep_kernel<E, 2>, a, g * q, threads, smem, stream);
    case 3: return launch_persistent(gru_sweep_kernel<E, 3>, a, g * q, threads, smem, stream);
    default: return launch_persistent(gru_sweep_kernel<E, 4>, a, g * q, threads, smem, stream);
  }
}

}  // namespace

// Each entry point launches on `stream` and returns the launch's
// cudaError_t (0 = success).

// The products of csrc/gemm.cuh: kind 0 the input gates (EPI_BIAS, A and B
// K-major), 1 the cotangent passed down (EPI_OUT, B (K, N)), 2 dW and db
// (EPI_DW, A and B (K, .)), bf16 operands; kinds 3, 4, 5 the same in
// strict fp32; n jobs in one launch.
extern "C" int molvax_gemm(int kind, const void* jobs, int n, void* stream) {
  if (n <= 0 || n > GEMM_MAX_JOBS) return (int)cudaErrorInvalidValue;
  GemmJobs js;
  memcpy(js.job, jobs, n * sizeof(GemmJob));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return (int)launch_gemm<true, true, EPI_BIAS>(js, n, s);
    case 1: return (int)launch_gemm<true, false, EPI_OUT>(js, n, s);
    case 2: return (int)launch_gemm<false, false, EPI_DW>(js, n, s);
    case 3: return (int)launch_gemm<true, true, EPI_BIAS, float>(js, n, s);
    case 4: return (int)launch_gemm<true, false, EPI_OUT, float>(js, n, s);
    case 5: return (int)launch_gemm<false, false, EPI_DW, float>(js, n, s);
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

// The persistent recurrence and sweep of one layer: bf16 storage, and
// (_f32) strict fp32, the same arguments.
extern "C" int molvax_gru_rec(const float* gi, const void* whh, const float* bhh, const float* h0,
                              const void* h0b, void* hseq, void* rzn, void* ghn, int* flags, int T,
                              int B, int H, int ldw, int ldh, int units, int rows, int q, int g,
                              int chunk, int row_base, int row_end, void* stream) {
  return gru_rec<__nv_bfloat16>(gi, whh, bhh, h0, h0b, hseq, rzn, ghn, flags, T, B, H, ldw, ldh, units,
                                rows, q, g, chunk, row_base, row_end, stream);
}

extern "C" int molvax_gru_rec_f32(const float* gi, const void* whh, const float* bhh, const float* h0,
                                  const void* h0b, void* hseq, void* rzn, void* ghn, int* flags, int T,
                                  int B, int H, int ldw, int ldh, int units, int rows, int q, int g,
                                  int chunk, int row_base, int row_end, void* stream) {
  return gru_rec<float>(gi, whh, bhh, h0, h0b, hseq, rzn, ghn, flags, T, B, H, ldw, ldh, units, rows, q,
                        g, chunk, row_base, row_end, stream);
}

extern "C" int molvax_gru_sweep(const void* hseq, const void* h0b, const void* rzn, const void* ghn,
                                const float* ext, const float* dhf, const void* whhT, void* dgi,
                                void* dgh, float* dh0, int* flags, int T, int B, int H, int ldh,
                                int ldw, int ldd, int units, int rows, int q, int g, int chunk,
                                int row_base, int row_end, void* stream) {
  return gru_sweep<__nv_bfloat16>(hseq, h0b, rzn, ghn, ext, dhf, whhT, dgi, dgh, dh0, flags, T, B, H, ldh,
                                  ldw, ldd, units, rows, q, g, chunk, row_base, row_end, stream);
}

extern "C" int molvax_gru_sweep_f32(const void* hseq, const void* h0b, const void* rzn, const void* ghn,
                                    const float* ext, const float* dhf, const void* whhT, void* dgi,
                                    void* dgh, float* dh0, int* flags, int T, int B, int H, int ldh,
                                    int ldw, int ldd, int units, int rows, int q, int g, int chunk,
                                    int row_base, int row_end, void* stream) {
  return gru_sweep<float>(hseq, h0b, rzn, ghn, ext, dhf, whhT, dgi, dgh, dh0, flags, T, B, H, ldh, ldw,
                          ldd, units, rows, q, g, chunk, row_base, row_end, stream);
}
