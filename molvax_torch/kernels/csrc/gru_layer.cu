// One GRU layer's recurrence for training, persistent on the card's SMs:
// the forward with the input gates computed inside it (or read, hoisted),
// and the reverse sweep.
//
// Replaces the per-layer Pallas TPU kernels and computes what they compute,
// with the same rounding points:
//   gru_layer_scan_x (molvax/kernels/gru.py _fwd_kernel_x, _bwd_kernel_x;
//     the fwd_gi probe of bench/proto_gi_kernel.py): the input gates
//     x[t] @ W_ih + b_ih are computed in the kernel from x; operand and
//     storage type E is bf16, or fp32 in the strict-fp32 mode
//     (matmul_dtype='float32');
//   gru_layer_scan (_fwd_kernel, _bwd_kernel): the input gates gi are read
//     from device memory, rounded to bf16 at the boundary; bf16 only.
//
// forward, per step t and batch row b (torch gate order r|z|n):
//   gi  = x[t] @ W_ih + b_ih            E operands, fp32 sum, never stored
//         (gru_layer_scan: fp32(gi[t]) of the bf16 input)
//   gh  = E(h) @ W_hh + b_hh
//   r = sigmoid(gi_r + gh_r), z = sigmoid(gi_z + gh_z), n = tanh(gi_n + r gh_n)
//   h = (1 - z) n + z h                 fp32 carry
//   stores hseq = E(h), rzn = E(r|z|n), ghn = E(gh_n)
// backward, t = T-1 .. 0 (dY[t] is the cotangent of hseq[t]):
//   dout = dh + dY[t]
//   dz = dout (hprev - n) z (1 - z), dn = dout (1 - z)(1 - n^2),
//   dr = dn gh_n r (1 - r)
//   dgi = E(dr | dz | dn), dgh = E(dr | dz | dn r)
//   dh = dout z + dgh @ W_hh^T
// with hprev = hseq[t-1] (E(h0) at t = 0). dx = E(dgi @ W_ih^T) (scan_x
// only) is csrc/gemm.cuh's dx GEMM after the sweep, dW and db its dW GEMM
// over the dgi / dgh the sweep writes (kernels/gru.py): on an H100 the
// reference's dx inside the sweep (_bwd_call_x) took twice the GEMM's time
// (PERF.md). Every
// product accumulates in fp32; in the fp32 mode every operand is fp32 and
// the products are 3xTF32 split products of fp32 accuracy (gemm.cuh
// fp32_k8), never a single-pass TF32 or bf16 product.
//
// What bounds it on an H100. A step's products are small (zinc250k width,
// B=256: ~0.2 GFLOP of x @ W_ih and h @ W_hh), so latency bounds the T
// serial steps: reading h (dgh backward) from the other blocks, the
// products' dependent chains, and the barrier that publishes a step. At
// widths where the weights do not fit in the SMs' shared memory (bf16
// H = 2,304: W_hh is 31.8 MB; H = 4,096: 100 MB) each step also reads them
// from L2 or device memory, and those bytes bound the step.
//
// Design (the layout of csrc/gru_stack.cu's recurrence). One cooperative
// launch per layer and pass (per batch slice), one block per SM, laid out by
// kernels/gru.py::layer_plan: g row groups x q blocks; block (group, j) owns
// `units` hidden units, all three gate columns of each, for the group's
// `rows` batch rows, split over units / 8 x rt warps (MT m16 row tiles a
// warp). Its slices of W_hh (3 units x H forward; W_hh[:, units], 3H x
// units, backward) and of W_ih (3 units x I, forward) stay resident in
// shared memory where the plan fits them, read once from the tensors as torch stores them and rounded to
// E there; a slice that does not fit is streamed, chunk by chunk of K, from
// an E copy through the same double-buffered cp.async ring as the row
// block it multiplies. Products run on mma.sync (bf16 m16n8k16, or fp32
// through fp32_k8); each thread's accumulator fragment is its set of (row,
// unit) pairs, so the fp32 carry (h, dh) lives in registers and the gate
// math runs on the fragments. A step publishes its h (dgh) through L2 and
// the group meets at a barrier in two halves (persist.cuh): between
// group_arrive and group_wait, a block does the work that needs no other
// block's part of the step:
//   forward, in-kernel: gi[t+1] = x[t+1] @ W_ih[:, units] + b_ih, x's row
//     block (zero-padded to a multiple of 16 columns) streamed through the
//     ring;
//   forward, hoisted: the loads of gi[t+1];
//   sweep: phase A's operands of step t-1.
// The sweep's phase A (gate cotangents of the block's own units, from dh,
// which only it holds) writes dgi / dgh before the barrier; phase B after it
// adds dgh[t] @ W_hh[:, units] to dh. Every sum runs in a fixed order: two
// runs are bit for bit the same. The cooperative launch fails, and the
// wrapper raises, unless every block is resident.
//
// Probe modes (molvax_gru_layer_fwd, mode). The hoisted-gi forward also runs
// as the two design probes of bench/gru_experiments.py::run_variant
// (_kernel_variant), each the production kernel less what the TPU probe
// took out, so their times decompose this kernel's step:
//   GATES_NOSTORE: the full gate math, hseq stored, no r|z|n or gh_n;
//   MATMUL_ONLY:   h = gh_r + b_hh_r (the reference's gh[:, :Hp]): the serial
//                  h @ W_hh chain and the carry, gi never read.
// MATMUL_ONLY's output reads only the r third of gh, so the z and n products
// would be dead code; their sum goes to `sink` when it is not null (it is
// null in every probe run), which keeps all 3H columns of the product live.

#include "common.cuh"
#include "gemm.cuh"
#include "persist.cuh"

namespace {

enum FwdMode { FULL = 0, GATES_NOSTORE = 1, MATMUL_ONLY = 2 };

// elements of padding per row of the sweep's [k][unit] weight tiles: keeps
// ldmatrix.trans (bf16) free of bank conflicts
constexpr int TPAD = 8;

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t r[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// element o of a weight tensor of fp32 (f32) or of E, as fp32
template <typename E>
__device__ __forceinline__ float weight_at(const void* w, int f32, size_t o) {
  return f32 ? static_cast<const float*>(w)[o] : to_f(static_cast<const E*>(w)[o]);
}

// Runs body(c, buf) on chunks c = 0 .. nch - 1 of a product as they land
// in a ring of `stages` buffers, issue(c, buf) copying chunk c into buffer
// buf with cp.async: with two buffers the next chunk is copied while one is
// multiplied; one buffer holds the product's one chunk, all of K. Ends with
// the ring free again.
template <typename Issue, typename Body>
__device__ __forceinline__ void pipeline(int nch, int stages, Issue issue, Body body) {
  issue(0, 0);
  cp_async_commit();
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<0>();
    __syncthreads();
    if (c + 1 < nch) {  // into the buffer that chunk c - 1 used
      issue(c + 1, (c + 1) % stages);
      cp_async_commit();
    }
    body(c, c % stages);
  }
  __syncthreads();
}

// The forward's resident slice: shared row gate * U + u is W row gate * H +
// u0 + u of a (3H, ld) tensor, K valid columns of Kp, E-rounded; rows past H
// and columns past K are zeros.
template <typename E>
__device__ void load_gate_rows(E* s, const void* w, int f32, int ld, int U, int u0, int H, int K, int Kp) {
  for (int i = threadIdx.x; i < 3 * U * Kp; i += blockDim.x) {
    const int row = i / Kp, k = i % Kp, u = u0 + row % U;
    const float v = u < H && k < K ? weight_at<E>(w, f32, (size_t)(row / U * H + u) * ld + k) : 0.0f;
    s[(size_t)row * (Kp + SPAD<E>) + k] = from_f<E>(v);
  }
}

// The sweep's resident slice: shared row k (of Kp) holds columns c0 .. c0 +
// n of row k of a (K, ld) tensor, E-rounded; zeros past K rows or C columns.
template <typename E>
__device__ void load_columns(E* s, const void* w, int f32, int ld, int n, int c0, int C, int K, int Kp) {
  for (int i = threadIdx.x; i < Kp * n; i += blockDim.x) {
    const int k = i / n, c = i % n;
    const float v = k < K && c0 + c < C ? weight_at<E>(w, f32, (size_t)k * ld + c0 + c) : 0.0f;
    s[(size_t)k * (n + TPAD) + c] = from_f<E>(v);
  }
}

template <typename E>
struct FwdArgs {
  const E* x;                      // (T, B, ldx) in-kernel; null for the hoisted gi
  const __nv_bfloat16* gi;         // (T, B, 3H) hoisted, bias included
  const void* wih;                 // (3H, ldwi): fp32 or E resident, E streamed
  const float* bih;                // (3H)
  const void* whh;                 // (3H, ldwh)
  const float* bhh;                // (3H)
  const float* h0;                 // (B, H) fp32
  const E* h0b;                    // (B, ldh) h0 in E
  E* hseq;                         // (T, B, ldh)
  E* rzn;                          // (T, B, 3H), FULL
  E* ghn;                          // (T, B, H), FULL
  float* sink;                     // (B, H), MATMUL_ONLY, null
  int* flags;                      // (g) zeros
  int T, B, I, H, ldx, ldwi, ldwh, ldh, wih_f32, whh_f32;
  int units, rows, q, chunk, stages, res_ih, res_hh;  // the plan
  int row_base, row_end;           // the batch rows of this launch
};

template <typename E>
struct SweepArgs {
  const E* hseq;                   // (T, B, ldh)
  const E* h0b;                    // (B, ldh)
  const E* rzn;                    // (T, B, 3H)
  const E* ghn;                    // (T, B, H)
  const float* dY;                 // (T, B, H) fp32
  const void* whh;                 // (3H, ldwh): fp32 or E resident, E streamed
  float* dh0;                      // (B, H)
  E* dgi;                          // (T, B, ldd)
  E* dgh;                          // (T, B, ldd)
  int* flags;
  int T, B, H, ldh, ldwh, ldd, whh_f32;
  int units, rows, q, chunk, stages, res_hh;  // the plan
  int row_base, row_end;
};

// Forward, MT m16 row tiles a warp: warp w owns 8 units of the block's
// slice (their r, z and n columns) for MT row tiles from row wr.
template <typename E, bool IN_X, int MODE, int MT>
__global__ void __launch_bounds__(256) layer_fwd_kernel(const FwdArgs<E> a) {
  static_assert(MODE == FULL || (!IN_X && sizeof(E) == 2), "the probe modes are of the hoisted-gi forward");
  constexpr int EPC = 16 / (int)sizeof(E);  // elements per 16-byte chunk
  extern __shared__ __align__(16) unsigned char fsmem[];
  const int H = a.H, G = 3 * H, U = a.units, Kh = round16(H), Kx = IN_X ? round16(a.I) : 0;
  const int grp = blockIdx.x / a.q, u0 = (blockIdx.x % a.q) * U;
  const int r0 = a.row_base + grp * a.rows, rend = a.row_end;
  const int cs = a.chunk + SPAD<E>;
  const bool streams = !a.res_hh || (IN_X && !a.res_ih);
  const size_t stage = (size_t)(a.rows + (streams ? 3 * U : 0)) * cs;
  E* sWh = reinterpret_cast<E*>(fsmem);
  E* sWi = sWh + (a.res_hh ? (size_t)3 * U * (Kh + SPAD<E>) : 0);
  E* ring = sWi + (IN_X && a.res_ih ? (size_t)3 * U * (Kx + SPAD<E>) : 0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wu = warp % (U / 8), wr = warp / (U / 8) * 16 * MT;

  // resident slices; the first product's barrier orders them before any read
  if (a.res_hh) load_gate_rows<E>(sWh, a.whh, a.whh_f32, a.ldwh, U, u0, H, H, Kh);
  if (IN_X && a.res_ih) load_gate_rows<E>(sWi, a.wih, a.wih_f32, a.ldwi, U, u0, H, a.I, Kx);

  // ac (+ co: fp32's cross terms) += the group's rows of src (ld, K columns
  // valid below klim) . the slice's rows of W: resident in sW, or (sW null)
  // streamed with them from gW (E, (3H, ldw))
  auto product = [&](float (&ac)[MT][3][4], float (&co)[MT][3][4], const E* src, int ld, int K, int klim,
                     const E* sW, const E* gW, int ldw) {
    const int nch = (K + a.chunk - 1) / a.chunk, cpr = a.chunk / EPC;
    auto issue = [&](int c, int buf) {
      E* st = ring + (size_t)buf * stage;
      const int k0 = c * a.chunk;
      for (int i = threadIdx.x; i < a.rows * cpr; i += blockDim.x) {
        const int row = i / cpr, kc = (i % cpr) * EPC, r = r0 + row, k = k0 + kc;
        const int bytes = r < rend ? chunk_bytes<E>(k, klim) : 0;
        cp_async16(st + (size_t)row * cs + kc, bytes ? src + (size_t)r * ld + k : src, bytes);
      }
      if (sW == nullptr) {
        E* sw = st + (size_t)a.rows * cs;
        for (int i = threadIdx.x; i < 3 * U * cpr; i += blockDim.x) {
          const int row = i / cpr, kc = (i % cpr) * EPC, u = u0 + row % U, k = k0 + kc;
          const int bytes = u < H ? chunk_bytes<E>(k, klim) : 0;
          cp_async16(sw + (size_t)row * cs + kc, bytes ? gW + (size_t)(row / U * H + u) * ldw + k : gW, bytes);
        }
      }
    };
    pipeline(nch, a.stages, issue, [&](int c, int buf) {
      const E* A = ring + (size_t)buf * stage;
      const E* W = sW ? sW + c * a.chunk : A + (size_t)a.rows * cs;
      const int wst = sW ? K + SPAD<E> : cs, wg = U * wst;  // a row, a gate's rows
      const int klen = min(a.chunk, K - c * a.chunk);
      if constexpr (sizeof(E) == 2) {
        const E* wrow = W + (wu * 8 + (lane & 7)) * wst + ((lane >> 3) & 1) * 8;
#pragma unroll 2
        for (int kk = 0; kk < klen; kk += 16) {
          uint32_t bw[3][2];
#pragma unroll
          for (int gte = 0; gte < 3; ++gte) ldmatrix_x2(bw[gte], wrow + gte * wg + kk);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t af[4];
            ldmatrix_x4(af, A + (size_t)(wr + mt * 16 + (lane & 15)) * cs + kk + (lane >> 4) * 8);
#pragma unroll
            for (int gte = 0; gte < 3; ++gte) mma_bf16(ac[mt][gte], af, bw[gte]);
          }
        }
      } else {  // column n of the warp's tile: gate n / 8, unit n % 8
        const E* w = W + wu * 8 * wst;
        auto k8 = [&](int kk) {
          fp32_k8(ac, co, [&](int m, int k) { return A[(size_t)(wr + m) * cs + kk + k]; },
                  [&](int k, int n) { return w[(n >> 3) * wg + (n & 7) * wst + kk + k]; }, lane);
        };
        int kk = 0;
        for (; kk + 32 <= klen; kk += 32) {  // no branch inside: loads run ahead
#pragma unroll
          for (int s = 0; s < 4; ++s) k8(kk + 8 * s);
        }
        for (; kk < klen; kk += 8) k8(kk);
      }
    });
  };

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
      ok[mt][e] = rowof[mt][e] < rend && unit[e] < H;
      h[mt][e] = ok[mt][e] ? a.h0[(size_t)rowof[mt][e] * H + unit[e]] : 0.0f;
    }
  float bh[3][4], bi[3][4];
#pragma unroll
  for (int gte = 0; gte < 3; ++gte)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bh[gte][e] = unit[e] < H ? a.bhh[gte * H + unit[e]] : 0.0f;
      bi[gte][e] = IN_X && unit[e] < H ? a.bih[gte * H + unit[e]] : 0.0f;
    }

  // the input gates of step t: computed from x[t], or loaded
  float gi[MT][4][3];
  auto input_gates = [&](int t) {
    if constexpr (IN_X) {
      float ga[MT][3][4] = {}, gc[MT][3][4] = {};
      product(ga, gc, a.x + (size_t)t * a.B * a.ldx, a.ldx, Kx, a.I, a.res_ih ? sWi : nullptr,
              static_cast<const E*>(a.wih), a.ldwi);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int gte = 0; gte < 3; ++gte) gi[mt][e][gte] = (ga[mt][gte][e] + gc[mt][gte][e]) + bi[gte][e];
    } else if constexpr (MODE != MATMUL_ONLY) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat16* p = a.gi + ((size_t)t * a.B + rowof[mt][e]) * G + unit[e];
#pragma unroll
          for (int gte = 0; gte < 3; ++gte) gi[mt][e][gte] = ok[mt][e] ? __bfloat162float(p[gte * H]) : 0.0f;
        }
    }
  };
  input_gates(0);

  for (int t = 0; t < a.T; ++t) {
    float acc[MT][3][4] = {}, corr[MT][3][4] = {};
    product(acc, corr, t == 0 ? a.h0b : a.hseq + (size_t)(t - 1) * a.B * a.ldh, a.ldh, Kh, H,
            a.res_hh ? sWh : nullptr, static_cast<const E*>(a.whh), a.ldwh);
    // the gate math on the fragments
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float gr = acc[mt][0][e] + corr[mt][0][e], gz = acc[mt][1][e] + corr[mt][1][e];
        const float gnn = acc[mt][2][e] + corr[mt][2][e];
        const size_t o = (size_t)t * a.B + rowof[mt][e];
        const int j = unit[e];
        if constexpr (MODE == MATMUL_ONLY) {
          const float hv = gr + bh[0][e];
          h[mt][e] = hv;
          if (ok[mt][e]) {
            a.hseq[o * a.ldh + j] = from_f<E>(hv);
            if (a.sink != nullptr) a.sink[(size_t)rowof[mt][e] * H + j] = gz + gnn;
          }
        } else {
          const float rg = sigmoid_f(gi[mt][e][0] + (gr + bh[0][e]));
          const float zg = sigmoid_f(gi[mt][e][1] + (gz + bh[1][e]));
          const float gn = gnn + bh[2][e];
          const float n = tanhf(gi[mt][e][2] + rg * gn);
          const float hv = (1.0f - zg) * n + zg * h[mt][e];
          h[mt][e] = hv;
          if (ok[mt][e]) {
            a.hseq[o * a.ldh + j] = from_f<E>(hv);
            if constexpr (MODE == FULL) {
              a.rzn[o * G + j] = from_f<E>(rg);
              a.rzn[o * G + H + j] = from_f<E>(zg);
              a.rzn[o * G + 2 * H + j] = from_f<E>(n);
              a.ghn[o * H + j] = from_f<E>(gn);
            }
          }
        }
      }
    if (t + 1 < a.T) {
      group_arrive(a.flags + grp);
      input_gates(t + 1);  // needs no other block's h: runs in the barrier's shadow
      group_wait(a.flags + grp, a.q * (t + 1));
    }
  }
}

// Reverse sweep, MT m16 row tiles a warp: warp w owns 8 units of the slice
// for MT row tiles from row wr: phase A's gate cotangents and dh for them,
// and their columns of phase B's product (two accumulator sets over
// alternate k steps, for chains in flight).
template <typename E, int MT>
__global__ void __launch_bounds__(256) layer_sweep_kernel(const SweepArgs<E> a) {
  constexpr int EPC = 16 / (int)sizeof(E);
  extern __shared__ __align__(16) unsigned char ssmem[];
  const int H = a.H, G = 3 * H, U = a.units, Kb = round16(G);
  const int grp = blockIdx.x / a.q, u0 = (blockIdx.x % a.q) * U;
  const int r0 = a.row_base + grp * a.rows, rend = a.row_end;
  const int cs = a.chunk + SPAD<E>, wcs = U + TPAD;
  const size_t stage = (size_t)a.rows * cs + (a.res_hh ? 0 : (size_t)a.chunk * wcs);
  E* sW = reinterpret_cast<E*>(ssmem);
  E* ring = sW + (a.res_hh ? (size_t)Kb * wcs : 0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wu = warp % (U / 8), wr = warp / (U / 8) * 16 * MT;

  if (a.res_hh) load_columns<E>(sW, a.whh, a.whh_f32, a.ldwh, U, u0, H, G, Kb);

  // ac (+ co) += the group's rows of src (dgh of a step: ld ldd, G valid
  // columns) . W_hh[:, units]: resident in sw, or (sw null) streamed with
  // them
  auto product = [&](float (&ac)[2][MT][4], float (&co)[2][MT][4], const E* src) {
    const E* sw = a.res_hh ? sW : nullptr;
    const int nch = (Kb + a.chunk - 1) / a.chunk, cpr = a.chunk / EPC, cpw = U / EPC;
    const E* gW = static_cast<const E*>(a.whh);
    auto issue = [&](int c, int buf) {
      E* st = ring + (size_t)buf * stage;
      const int k0 = c * a.chunk;
      for (int i = threadIdx.x; i < a.rows * cpr; i += blockDim.x) {
        const int row = i / cpr, kc = (i % cpr) * EPC, r = r0 + row, k = k0 + kc;
        const int bytes = r < rend ? chunk_bytes<E>(k, G) : 0;
        cp_async16(st + (size_t)row * cs + kc, bytes ? src + (size_t)r * a.ldd + k : src, bytes);
      }
      if (sw == nullptr) {
        E* wb = st + (size_t)a.rows * cs;
        for (int i = threadIdx.x; i < a.chunk * cpw; i += blockDim.x) {
          const int kr = i / cpw, uc = (i % cpw) * EPC, k = k0 + kr, u = u0 + uc;
          const int bytes = k < G ? chunk_bytes<E>(u, H) : 0;
          cp_async16(wb + (size_t)kr * wcs + uc, bytes ? gW + (size_t)k * a.ldwh + u : gW, bytes);
        }
      }
    };
    pipeline(nch, a.stages, issue, [&](int c, int buf) {
      const E* A = ring + (size_t)buf * stage;
      const E* W = sw ? sw + (size_t)c * a.chunk * wcs : A + (size_t)a.rows * cs;
      const int klen = min(a.chunk, Kb - c * a.chunk);
      if constexpr (sizeof(E) == 2) {
        const E* wcol = W + (size_t)(lane & 15) * wcs + wu * 8;
#pragma unroll 2
        for (int kk = 0; kk < klen; kk += 32) {
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            if (kk + 16 * p >= klen) break;
            uint32_t bw[2];
            ldmatrix_x2_trans(bw, wcol + (size_t)(kk + 16 * p) * wcs);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              uint32_t af[4];
              ldmatrix_x4(af, A + (size_t)(wr + mt * 16 + (lane & 15)) * cs + kk + 16 * p + (lane >> 4) * 8);
              mma_bf16(ac[p][mt], af, bw);
            }
          }
        }
      } else {  // the warp's 8 columns are the tile's
        const E* w = W + wu * 8;
        auto k8 = [&](float(&cc)[MT][4], float(&rr)[MT][4], int kk) {
          using Tile = float(&)[MT][1][4];
          fp32_k8(reinterpret_cast<Tile>(cc), reinterpret_cast<Tile>(rr),
                  [&](int m, int k) { return A[(size_t)(wr + m) * cs + kk + k]; },
                  [&](int k, int n) { return w[(size_t)(kk + k) * wcs + n]; }, lane);
        };
        int kk = 0;
        for (; kk + 16 <= klen; kk += 16) {  // no branch inside: loads run ahead
          k8(ac[0], co[0], kk);
          k8(ac[1], co[1], kk + 8);
        }
        if (kk < klen) k8(ac[0], co[0], kk);
      }
    });
  };

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
      ok[mt][e] = rowof[mt][e] < rend && unit[e] < H;
      dh[mt][e] = 0.0f;
    }

  // phase A's operands of step t (r, z, n, gh_n, hprev, dY): they do not
  // wait for dh, so step t-1's are loaded in the barrier's shadow
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
        in[mt][e][5] = a.dY[o * H + j];
      }
  };
  load_in(a.T - 1);

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
    group_arrive(a.flags + grp);
    if (t > 0) load_in(t - 1);
    group_wait(a.flags + grp, a.q * s);

    // phase B: dh[:, units] += dgh[t] @ W_hh[:, units]
    float acc[2][MT][4] = {}, corr[2][MT][4] = {};
    product(acc, corr, a.dgh + (size_t)t * a.B * a.ldd);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dh[mt][e] += (acc[0][mt][e] + corr[0][mt][e]) + (acc[1][mt][e] + corr[1][mt][e]);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (ok[mt][e]) a.dh0[(size_t)rowof[mt][e] * H + unit[e]] = dh[mt][e];
}

// -- the plans the kernels take, and their shared memory ----------------------

// units a multiple of 8 (one warp a unit tile) up to 64, units / 8 x rt
// warps, at most 8; rows = 16 mt rt, mt 1, 2 or 4 (fp32: 1 or 2);
// chunk a multiple of 16; 1 or 2 ring buffers (one: each product whole)
template <typename E>
bool bad_plan(int units, int rows, int rt, int q, int g, int chunk, int stages) {
  if (units <= 0 || units % 8 || units > 64 || rt <= 0 || units / 8 * rt > 8 || q <= 0 || g <= 0 ||
      chunk <= 0 || chunk % 16 || rows <= 0 || rows % (16 * rt) || stages < 1 || stages > 2)
    return true;
  const int mt = rows / 16 / rt;
  return !(mt == 1 || mt == 2 || (mt == 4 && sizeof(E) == 2));
}

template <typename E>
size_t fwd_smem(int I, int H, int units, int rows, int chunk, int stages, bool in_x, bool res_ih, bool res_hh) {
  const int Kh = round16(H), Kx = in_x ? round16(I) : 0;
  const bool streams = !res_hh || (in_x && !res_ih);
  return ((res_hh ? (size_t)3 * units * (Kh + SPAD<E>) : 0) +
          (in_x && res_ih ? (size_t)3 * units * (Kx + SPAD<E>) : 0) +
          (size_t)stages * (rows + (streams ? 3 * units : 0)) * (chunk + SPAD<E>)) *
         sizeof(E);
}

template <typename E>
size_t sweep_smem(int H, int units, int rows, int chunk, int stages, bool res_hh) {
  const int Kb = round16(3 * H);
  return ((res_hh ? (size_t)Kb * (units + TPAD) : 0) +
          (size_t)stages * ((size_t)rows * (chunk + SPAD<E>) + (res_hh ? 0 : (size_t)chunk * (units + TPAD)))) *
         sizeof(E);
}

template <typename E, bool IN_X, int MODE>
int launch_fwd_mode(const FwdArgs<E>& a, int mt, int blocks, int threads, size_t smem, void* stream) {
  if constexpr (sizeof(E) == 4) {
    if (mt == 1) return launch_persistent(layer_fwd_kernel<E, IN_X, MODE, 1>, a, blocks, threads, smem, stream);
    return launch_persistent(layer_fwd_kernel<E, IN_X, MODE, 2>, a, blocks, threads, smem, stream);
  } else {
    switch (mt) {
      case 1: return launch_persistent(layer_fwd_kernel<E, IN_X, MODE, 1>, a, blocks, threads, smem, stream);
      case 2: return launch_persistent(layer_fwd_kernel<E, IN_X, MODE, 2>, a, blocks, threads, smem, stream);
      default: return launch_persistent(layer_fwd_kernel<E, IN_X, MODE, 4>, a, blocks, threads, smem, stream);
    }
  }
}

template <typename E>
int layer_fwd(const FwdArgs<E>& a, int mode, int rt, int g, void* stream) {
  constexpr int EPC = 16 / (int)sizeof(E);
  const bool in_x = a.x != nullptr;
  const bool single = a.stages == 1 && (a.chunk < max(round16(a.H), in_x ? round16(a.I) : 0) || !a.res_hh ||
                                        (in_x && !a.res_ih));  // one buffer: all of K, nothing streamed
  if (bad_plan<E>(a.units, a.rows, rt, a.q, g, a.chunk, a.stages) || single || a.T <= 0 || a.B <= 0 ||
      a.H <= 0 || a.ldh % EPC || a.row_base < 0 || a.row_end > a.B || a.row_end <= a.row_base ||
      (in_x && (a.I <= 0 || a.ldx % EPC)) || (!in_x && a.gi == nullptr) ||
      (!a.res_hh && (a.whh_f32 || a.ldwh % EPC)) || (in_x && !a.res_ih && (a.wih_f32 || a.ldwi % EPC)) ||
      (mode != FULL && (in_x || sizeof(E) != 2)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem<E>(a.I, a.H, a.units, a.rows, a.chunk, a.stages, in_x, a.res_ih, a.res_hh);
  const int mt = a.rows / 16 / rt, blocks = g * a.q, threads = a.units / 8 * rt * 32;
  if (in_x) return launch_fwd_mode<E, true, FULL>(a, mt, blocks, threads, smem, stream);
  if constexpr (sizeof(E) == 2) {
    if (mode == GATES_NOSTORE) return launch_fwd_mode<E, false, GATES_NOSTORE>(a, mt, blocks, threads, smem, stream);
    if (mode == MATMUL_ONLY) return launch_fwd_mode<E, false, MATMUL_ONLY>(a, mt, blocks, threads, smem, stream);
    return launch_fwd_mode<E, false, FULL>(a, mt, blocks, threads, smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename E>
int layer_sweep(const SweepArgs<E>& a, int rt, int g, void* stream) {
  constexpr int EPC = 16 / (int)sizeof(E);
  const bool single = a.stages == 1 && (a.chunk < round16(3 * a.H) || !a.res_hh);
  if (bad_plan<E>(a.units, a.rows, rt, a.q, g, a.chunk, a.stages) || single || a.T <= 0 || a.B <= 0 ||
      a.H <= 0 || a.ldh % EPC || a.ldd % EPC || a.row_base < 0 || a.row_end > a.B || a.row_end <= a.row_base ||
      (!a.res_hh && (a.whh_f32 || a.ldwh % EPC)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sweep_smem<E>(a.H, a.units, a.rows, a.chunk, a.stages, a.res_hh);
  const int mt = a.rows / 16 / rt, blocks = g * a.q, threads = a.units / 8 * rt * 32;
  if constexpr (sizeof(E) == 4) {
    if (mt == 1) return launch_persistent(layer_sweep_kernel<E, 1>, a, blocks, threads, smem, stream);
    return launch_persistent(layer_sweep_kernel<E, 2>, a, blocks, threads, smem, stream);
  } else {
    switch (mt) {
      case 1: return launch_persistent(layer_sweep_kernel<E, 1>, a, blocks, threads, smem, stream);
      case 2: return launch_persistent(layer_sweep_kernel<E, 2>, a, blocks, threads, smem, stream);
      default: return launch_persistent(layer_sweep_kernel<E, 4>, a, blocks, threads, smem, stream);
    }
  }
}

}  // namespace

// Each entry point launches on `stream` and returns the launch's
// cudaError_t (0 = success); `fp32` selects the strict-fp32 instance (every
// E operand fp32) over the bf16 one.

// The forward of one layer, one launch for the batch rows [row_base,
// row_end): in-kernel input gates from x (x not null), or hoisted from gi
// (bf16; x null), where `mode` may also name a probe mode (1 GATES_NOSTORE,
// 2 MATMUL_ONLY). The plan: units, rows (= 16 mt rt), rt, q, g, chunk, and
// which weight slices stay resident (res_ih, res_hh).
extern "C" int molvax_layer_fwd(const void* x, const void* gi, const void* wih, const float* bih, const void* whh,
                                const float* bhh, const float* h0, const void* h0b, void* hseq, void* rzn,
                                void* ghn, float* sink, int* flags, int T, int B, int I, int H, int ldx, int ldwi,
                                int ldwh, int ldh, int wih_f32, int whh_f32, int units, int rows, int rt, int q,
                                int g, int chunk, int stages, int res_ih, int res_hh, int row_base, int row_end,
                                int fp32, int mode, void* stream) {
  if (fp32) {
    const FwdArgs<float> a{static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(gi), wih, bih, whh,
                           bhh, h0, static_cast<const float*>(h0b), static_cast<float*>(hseq),
                           static_cast<float*>(rzn), static_cast<float*>(ghn), sink, flags, T, B, I, H, ldx, ldwi,
                           ldwh, ldh, wih_f32, whh_f32, units, rows, q, chunk, stages, res_ih, res_hh, row_base,
                           row_end};
    return layer_fwd(a, mode, rt, g, stream);
  }
  typedef __nv_bfloat16 bf;
  const FwdArgs<bf> a{static_cast<const bf*>(x), static_cast<const bf*>(gi), wih, bih, whh, bhh, h0,
                      static_cast<const bf*>(h0b), static_cast<bf*>(hseq), static_cast<bf*>(rzn),
                      static_cast<bf*>(ghn), sink, flags, T, B, I, H, ldx, ldwi, ldwh, ldh, wih_f32, whh_f32,
                      units, rows, q, chunk, stages, res_ih, res_hh, row_base, row_end};
  return layer_fwd(a, mode, rt, g, stream);
}

// The reverse sweep of one layer, one launch for the batch rows [row_base,
// row_end): dgi, dgh (T, B, ldd) and dh0.
extern "C" int molvax_layer_sweep(const void* hseq, const void* h0b, const void* rzn, const void* ghn,
                                  const float* dY, const void* whh, float* dh0, void* dgi, void* dgh, int* flags,
                                  int T, int B, int H, int ldh, int ldwh, int ldd, int whh_f32, int units, int rows,
                                  int rt, int q, int g, int chunk, int stages, int res_hh, int row_base, int row_end,
                                  int fp32, void* stream) {
  if (fp32) {
    typedef const float* cf;
    const SweepArgs<float> a{static_cast<cf>(hseq), static_cast<cf>(h0b), static_cast<cf>(rzn),
                             static_cast<cf>(ghn), dY, whh, dh0, static_cast<float*>(dgi), static_cast<float*>(dgh),
                             flags, T, B, H, ldh, ldwh, ldd, whh_f32, units, rows, q, chunk, stages, res_hh,
                             row_base, row_end};
    return layer_sweep(a, rt, g, stream);
  }
  typedef __nv_bfloat16 bf;
  typedef const bf* cb;
  const SweepArgs<bf> a{static_cast<cb>(hseq), static_cast<cb>(h0b), static_cast<cb>(rzn), static_cast<cb>(ghn),
                        dY, whh, dh0, static_cast<bf*>(dgi), static_cast<bf*>(dgh), flags, T, B, H, ldh, ldwh, ldd,
                        whh_f32, units, rows, q, chunk, stages, res_hh, row_base, row_end};
  return layer_sweep(a, rt, g, stream);
}
