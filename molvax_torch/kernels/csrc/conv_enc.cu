// Fused conv encoder: charset codes -> (mu, logvar) in one cooperative launch.
//
// Replaces molvax/kernels/conv_enc.py::fused_encode (the Pallas TPU kernel)
// and computes what it computes, per batch row:
//   x      = one_hot(codes): 'seq' convolves along the T positions with the
//            charset as channels, 'charset' along the charset with the
//            positions as channels; a code outside [0, C) is a zero row
//   h_i    = bf16(relu(conv_i(h_{i-1}) + b_i))   VALID convs, torch layout
//   h2     = act(flatten(h_N) @ W_0^T + b_0)      channel-major flatten; act
//            SELU, or ReLU (relu != 0: the Grammar VAE)
//   mu     = h2 @ W_mu^T + b_mu, logvar = h2 @ W_lv^T + b_lv  (fp32 heads)
// Conv and dense products take bf16 operands and sum in fp32; the heads are
// fp32, as in the TPU kernel. The backward is not a kernel: the wrapper
// differentiates the plain encoder, as the TPU package does.
//
// It reads the module's own parameters (fp32, torch layout) and the codes
// in their own integer type, and rounds the weights to bf16 as it stages
// them: the wrapper prepares nothing. One block per SM, 8 warps, three
// phases with a grid barrier between them; every operand from device
// memory comes by bulk copy (the tensor memory accelerator, an mbarrier a
// copy group):
//   A. the conv stack, a team of warps per batch row (csrc/conv_enc.cuh;
//      4 warps at B=256 on 132 blocks): the convs' weights laid out in
//      shared memory as bf16 (the first conv's as a gather table); the
//      first conv a gather by the codes, the later ones on the tensor cores
//      (ldmatrix, mma.sync m16n8k16) from shared memory; h3 written as bf16
//      (B, Fp), NCH order, to scratch in device memory (L2). The block's
//      first dense tile's W_0 is copied meanwhile;
//   B. the dense layer on the tensor cores: tiles of 32 rows x 32 units, so
//      a W_0 element is read once per row tile, not once per row, rounded
//      to bf16 as its fragment is built; the 8 warps split K and sum their
//      partial tiles in a fixed order; + b_0, SELU (or ReLU); h2 fp32 (B, Ep)
//      to scratch. The block's first head tile's W is copied as it ends.
//      Where a tile's W_0 rows do not fit beside its h3 rows (a long
//      sequence: F = 2,510 at T = 277), W_0 comes in chunks of kc columns,
//      a multiple of WARPS x 16, so each warp takes the k16 steps it takes
//      on whole rows, in the same order: the sums are the same;
//   C. the heads as 3xTF32 split products (csrc/gemm.cuh fp32_k8): tiles of
//      32 rows x 40 outputs of [mu | logvar], K split over the warps, the
//      partial tiles summed in a fixed order; + bias.
// The result does not depend on the grid: every output is summed in one
// fixed order.
//
// What bounds it on an H100. At zinc250k width, B=256: ~0.3 G multiply-adds
// and 2.8 MB of fp32 parameters read once from device memory: about a
// microsecond either way. In practice each block runs a chain of short
// dependent steps with 8 warps to hide their latency (probes/stack_probe.py
// --encode-timeline: block 0's clock at each step): laying out the conv
// weights ~3 us, the row's conv stack ~7 us, each grid barrier ~1-1.5 us,
// the dense and head tiles ~5 us each, their copies from L2 half of it.

#include <cooperative_groups.h>

#include "gemm.cuh"
#include "conv_enc.cuh"

namespace {

using namespace conv_enc;

constexpr int ENC_NO_LAYOUT = 1000;  // returned where no layout fits the card

struct EncArgs {
  EncDims d;
  EncLayout L;
  const void* codes;
  int code_kind;
  int team;          // warps a row in phase A (team_warps)
  int relu;          // the dense layer's activation: ReLU, else SELU
  const float* conv_w[MAX_CONV];
  const float* conv_b[MAX_CONV];
  const float* w0;   // (E, F)
  const float* b0;   // (E)
  const float* wmu;  // (Lz, E)
  const float* bmu;
  const float* wlv;  // (Lz, E)
  const float* blv;
  uint16_t* h3;      // (B, Fp) bf16, scratch
  float* h2;         // (B, Ep) fp32, scratch
  float* mu;         // (B, Lz)
  float* logvar;     // (B, Lz)
};

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float relu_f(float x) { return x > 0.0f ? x : 0.0f; }

__device__ __forceinline__ float selu_f(float x) {
  const float alpha = 1.6732632423543772f;
  const float scale = 1.0507009873554805f;
  return x > 0.0f ? scale * x : scale * (alpha * expm1f(x));
}

// -- bulk copies (the tensor memory accelerator) and their mbarriers ----------
//
// Every operand a phase reads from device memory is one bulk copy or a few:
// one thread arms the phase's mbarrier with the bytes it expects and issues
// the copies, and no thread spends an instruction a 16-byte chunk. A span
// copy takes the 16-byte-aligned bytes around its source, so a tensor at any
// 4-byte address copies whole; its first element lies at the span's offset.
// Waits give up (trap) after about a second rather than hang.

enum { BAR_CONV = 0, BAR_DW = 1, BAR_H3 = 2, BAR_HW = 3, BAR_H2 = 4 };

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (long long spin = 0; !done; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (spin > (1LL << 22)) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// shared memory last touched by threads, about to be written by bulk copies
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
// device memory written by threads (this launch's scratch) and read by bulk copies
__device__ __forceinline__ void fence_async_global() { asm volatile("fence.proxy.async.global;\n" ::: "memory"); }

struct Span {
  uintptr_t lo;
  uint32_t bytes, offset;  // bytes copied; src's first byte at dst + offset
};

__device__ __forceinline__ Span span_of(const void* src, size_t bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src), lo = a & ~(uintptr_t)15;
  const uintptr_t hi = (a + bytes + 15) & ~(uintptr_t)15;
  return {lo, (uint32_t)(hi - lo), (uint32_t)(a - lo)};
}

__device__ __forceinline__ void span_copy(unsigned char* dst, const Span& sp, uint64_t* bar) {
  bulk_copy(dst, reinterpret_cast<const void*>(sp.lo), sp.bytes, bar);
}

// the phases' waits, each mbarrier's next parity in a bit
struct Bars {
  uint64_t* bar;
  uint32_t parity;
  __device__ __forceinline__ void wait(int i) {
    mbar_wait(bar + i, (parity >> i) & 1u);
    parity ^= 1u << i;
  }
};

// W_0's rows of dense tile `tile` (those below E), one span: by one thread
__device__ __forceinline__ const float* dense_w_rows(const EncArgs& a, int tile) {
  const int n0 = tile % ((a.d.E + TN_DENSE - 1) / TN_DENSE) * TN_DENSE;
  return a.w0 + (size_t)n0 * a.d.F();
}

__device__ __forceinline__ void dense_w_copy(const EncArgs& a, unsigned char* smem, uint64_t* bar, int tile) {
  const int n0 = tile % ((a.d.E + TN_DENSE - 1) / TN_DENSE) * TN_DENSE, rows = min(TN_DENSE, a.d.E - n0);
  const Span sp = span_of(dense_w_rows(a, tile), (size_t)rows * a.d.F() * 4);
  fence_async_shared();
  mbar_expect(bar, sp.bytes);
  span_copy(smem + a.L.dw_off, sp, bar);
}

// The heads' rows of head tile `tile`: column n of the tile is row n of W_mu
// (n < Lz), of W_lv after; a span each for the mu_rows and lv_rows of them,
// the second after the first's region. By one thread.
struct HeadRows {
  Span mu, lv;
  int mu_rows, lv_rows;
};

__device__ __forceinline__ HeadRows head_w_rows(const EncArgs& a, int tile) {
  const int E = a.d.E, Lz = a.d.Lz, n0 = tile % ((2 * Lz + TN_HEAD - 1) / TN_HEAD) * TN_HEAD;
  const int n1 = min(n0 + TN_HEAD, 2 * Lz), lv0 = max(n0, Lz) - Lz;
  HeadRows h;
  h.mu_rows = n0 < Lz ? min(n1, Lz) - n0 : 0;
  h.lv_rows = n1 > Lz ? n1 - Lz - lv0 : 0;
  h.mu = span_of(a.wmu + (size_t)n0 * E, (size_t)h.mu_rows * E * 4);
  h.lv = span_of(a.wlv + (size_t)lv0 * E, (size_t)h.lv_rows * E * 4);
  return h;
}

__device__ __forceinline__ size_t lv_region(const EncArgs& a, const HeadRows& h) {
  return a.L.hw_off + up16((size_t)h.mu_rows * a.d.E * 4) + 16;
}

__device__ __forceinline__ void head_w_copy(const EncArgs& a, unsigned char* smem, uint64_t* bar, int tile) {
  const HeadRows h = head_w_rows(a, tile);
  fence_async_shared();
  mbar_expect(bar, (h.mu_rows ? h.mu.bytes : 0) + (h.lv_rows ? h.lv.bytes : 0));
  if (h.mu_rows) span_copy(smem + a.L.hw_off, h.mu, bar);
  if (h.lv_rows) span_copy(smem + lv_region(a, h), h.lv, bar);
}

// columns k0 .. k0 + kn - 1 of W_0's rows n0 .. n0 + rows - 1, a span a row
// of L.wpitch bytes from dw_off: by warp 0, a lane a row
__device__ __forceinline__ void dense_w_chunk_copy(const EncArgs& a, unsigned char* smem, uint64_t* bar, int n0,
                                                   int rows, int k0, int kn) {
  const int lane = threadIdx.x & 31;
  const Span sp = lane < rows ? span_of(a.w0 + (size_t)(n0 + lane) * a.d.F() + k0, (size_t)kn * 4)
                              : Span{0, 0u, 0u};
  const uint32_t total = __reduce_add_sync(0xffffffffu, sp.bytes);
  if (lane == 0) {
    fence_async_shared();
    mbar_expect(bar, total);
  }
  __syncwarp();
  if (sp.bytes) span_copy(smem + a.L.dw_off + lane * a.L.wpitch, sp, bar);
}

// rows m0 .. m0 + TM - 1 (those below B) of a (B, ld) scratch array of
// `esize`-byte elements into shared memory rows of `pitch` bytes: a row a
// copy, by warp 0 (rows 16-byte aligned by construction)
__device__ __forceinline__ void tile_rows_copy(unsigned char* dst, int pitch, const void* src, int ld, int esize,
                                               int m0, int B, uint64_t* bar) {
  const int rows = min(TM, B - m0), lane = threadIdx.x & 31;
  if (lane == 0) {
    fence_async_shared();
    fence_async_global();
    mbar_expect(bar, (uint32_t)rows * ld * esize);
  }
  __syncwarp();
  if (lane < rows)
    bulk_copy(dst + lane * pitch, static_cast<const unsigned char*>(src) + (size_t)(m0 + lane) * ld * esize,
              ld * esize, bar);
}

// A. the conv stack, a team of a.team warps per row. Thread 0 first copies
// every conv's weights and biases and each team's first row of codes, then
// the block's first dense tile's W_0, which lands while the stack runs.
__device__ void phase_conv(const EncArgs& a, unsigned char* smem, Bars& bars) {
  const EncDims& d = a.d;
  const EncLayout& L = a.L;
  const int warp = threadIdx.x >> 5;
  const bool rows = (int)blockIdx.x < d.B;
  const int ts = a.team, team = warp / ts, esize = code_bytes(a.code_kind);
  if (warp == 0) {  // a lane a copy: conv s's weights (lane s) and biases (8 + s), team t's codes (16 + t)
    const int lane = threadIdx.x & 31;
    const void* src = nullptr;
    size_t bytes = 0, off = 0;
    if (rows && lane < d.n) {
      src = a.conv_w[lane], bytes = (size_t)d.cout[lane] * d.cin(lane) * d.k[lane] * 4, off = L.raw_off[lane];
    } else if (rows && lane >= 8 && lane < 8 + d.n) {
      src = a.conv_b[lane - 8], bytes = (size_t)d.cout[lane - 8] * 4, off = L.b_off[lane - 8];
    } else if (rows && lane >= 16 && lane < 16 + L.teams && (int)blockIdx.x + (int)gridDim.x * (lane - 16) < d.B) {
      src = static_cast<const unsigned char*>(a.codes) + (size_t)(blockIdx.x + gridDim.x * (lane - 16)) * d.T * esize;
      bytes = (size_t)d.T * esize, off = L.codes_off + (lane - 16) * L.codes_bytes;
    }
    const Span sp = src ? span_of(src, bytes) : Span{0, 0u, 0u};
    const uint32_t total = __reduce_add_sync(0xffffffffu, sp.bytes);
    if (lane == 0 && rows) mbar_expect(bars.bar + BAR_CONV, total);
    __syncwarp();
    if (sp.bytes) span_copy(smem + off, sp, bars.bar + BAR_CONV);
    if (lane == 0 && L.pre_dense && (int)blockIdx.x < L.tiles_dense) dense_w_copy(a, smem, bars.bar + BAR_DW, blockIdx.x);
  }
  if (!rows) return;
  bars.wait(BAR_CONV);
  auto at = [&](size_t off, const void* src) {  // a span's first element in shared memory
    return smem + off + (reinterpret_cast<uintptr_t>(src) & 15);
  };
  stage_conv_weights(d, L, [&](int s) { return reinterpret_cast<const float*>(at(L.raw_off[s], a.conv_w[s])); },
                     smem);
  __syncthreads();
  // the teams' buffers (over the weights' copies) start zeroed: a padded
  // channel that no stage writes meets a zero weight, and must not be NaN
  uint4* z = reinterpret_cast<uint4*>(smem + L.warp_off);
  const int nz = (int)(L.teams * L.warp_bytes / 16);
  for (int i = threadIdx.x; i < nz; i += THREADS) z[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  unsigned char* mine = smem + L.warp_off + team * L.warp_bytes;
  int* code_s = reinterpret_cast<int*>(mine);
  uint16_t* buf0 = reinterpret_cast<uint16_t*>(mine + up16((size_t)d.T * 4));
  uint16_t* buf1 = buf0 + L.buf_elems;
  for (int row = blockIdx.x + gridDim.x * team; row < d.B; row += gridDim.x * L.teams) {
    const unsigned char* codes = static_cast<const unsigned char*>(a.codes) + (size_t)row * d.T * esize;
    if (row < (int)gridDim.x * L.teams) codes = at(L.codes_off + team * L.codes_bytes, codes);  // copied above
    conv_row(d, L, smem, [&](int s) { return reinterpret_cast<const float*>(at(L.b_off[s], a.conv_b[s])); }, codes,
             a.code_kind, code_s, buf0, buf1, a.h3 + (size_t)row * d.Fp(), warp % ts, team, ts);
  }
  fence_async_global();  // h3 is read by the dense phase's bulk copies
}

// B. h2 = act(h3 . W_0^T + b_0), tiles of TM x TN_DENSE. The block's last
// dense tile, once its products are done, starts the copy of its first
// head tile's W. W_0 whole rows (kc = F) or in chunks of kc columns.
__device__ void phase_dense(const EncArgs& a, unsigned char* smem, Bars& bars) {
  const EncDims& d = a.d;
  const EncLayout& L = a.L;
  const int F = d.F(), Fp = d.Fp(), Ep = d.Ep(), E = d.E;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int sa = Fp + L.pad_a;
  const uint16_t* sA = reinterpret_cast<const uint16_t*>(smem);
  float* part = reinterpret_cast<float*>(smem);  // the warps' partial tiles, over the h3 tile
  const int tiles_n = (E + TN_DENSE - 1) / TN_DENSE;
  if (tid == 0 && (int)blockIdx.x >= L.tiles_dense && (int)blockIdx.x < L.tiles_head)
    head_w_copy(a, smem, bars.bar + BAR_HW, blockIdx.x);
  for (int tile = blockIdx.x; tile < L.tiles_dense; tile += gridDim.x) {
    const int m0 = tile / tiles_n * TM, n0 = tile % tiles_n * TN_DENSE;
    const int nb = n0 + tid % TN_DENSE;  // the unit of this thread's outputs below
    const float bias = nb < E ? a.b0[nb] : 0.0f;
    if (warp == 0) tile_rows_copy(smem, sa * 2, a.h3, Fp, 2, m0, d.B, bars.bar + BAR_H3);
    float acc[2][4][4] = {};
    const int rows_n = min(TN_DENSE, E - n0);
    for (int c0 = 0; c0 < F; c0 += L.kc) {  // one pass over whole rows (kc = F), or a pass a chunk
      const int kn = min(L.kc, F - c0);
      if (L.kc >= F) {
        if (tid == 0 && !(L.pre_dense && tile == (int)blockIdx.x)) dense_w_copy(a, smem, bars.bar + BAR_DW, tile);
      } else if (warp == 0) {
        dense_w_chunk_copy(a, smem, bars.bar + BAR_DW, n0, rows_n, c0, kn);
      }
      if (c0 == 0) bars.wait(BAR_H3);
      bars.wait(BAR_DW);
      // W_0's rows (fp32, unpadded), each rounded to bf16 as its fragment is
      // built; wrow[j] is at column c0 + 2t (a row past the tile's: row 0's)
      const float* wrow[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = j * 8 + g;
        if (L.kc >= F) {
          const float* w = reinterpret_cast<const float*>(
              smem + L.dw_off + (reinterpret_cast<uintptr_t>(dense_w_rows(a, tile)) & 15));
          wrow[j] = w + (size_t)n * F + 2 * t;
        } else {
          const int r = n < rows_n ? n : 0;
          const float* src = a.w0 + (size_t)(n0 + r) * F + c0;
          wrow[j] = reinterpret_cast<const float*>(smem + L.dw_off + r * L.wpitch +
                                                   (reinterpret_cast<uintptr_t>(src) & 15)) + 2 * t;
        }
      }
      const int s_end = c0 + kn >= F ? Fp / 16 : (c0 + kn) / 16;
      for (int s = c0 / 16 + warp; s < s_end; s += WARPS) {
        const int kk = s * 16;
        uint32_t af[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) ldmatrix_x4(af[i], sA + (i * 16 + (lane & 15)) * sa + kk + (lane >> 4) * 8);
        // W_0 has no padding column: its columns from F on are read as 0
        const int k0 = kk + 2 * t;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* q = wrow[j] + (kk - c0);
          const uint32_t bfr[2] = {bf16x2(k0 < F ? q[0] : 0.0f, k0 + 1 < F ? q[1] : 0.0f),
                                   bf16x2(k0 + 8 < F ? q[8] : 0.0f, k0 + 9 < F ? q[9] : 0.0f)};
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_bf16(acc[i][j], af[i], bfr);
        }
      }
      __syncthreads();  // every warp done with this chunk of W_0 before the next lands over it
    }
    if (tid == 0 && tile + (int)gridDim.x >= L.tiles_dense && (int)blockIdx.x < L.tiles_head)
      head_w_copy(a, smem, bars.bar + BAR_HW, blockIdx.x);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(&part[(warp * TM + i * 16 + g + 8 * h) * PART_D + j * 8 + 2 * t]) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < TM * TN_DENSE / THREADS; ++r) {
      const int o = tid + r * THREADS, m = o / TN_DENSE, n = o % TN_DENSE;
      float s = part[m * PART_D + n];
      for (int w = 1; w < WARPS; ++w) s += part[(w * TM + m) * PART_D + n];
      if (m0 + m < d.B && n0 + n < Ep)  // h2's padding columns zero: the heads read them
        a.h2[(size_t)(m0 + m) * Ep + n0 + n] = n0 + n < E ? (a.relu ? relu_f(s + bias) : selu_f(s + bias)) : 0.0f;
    }
    __syncthreads();
  }
  fence_async_global();  // h2 is read by the heads' bulk copies
}

// C. [mu | logvar] = h2 . [W_mu; W_lv]^T + [b_mu; b_lv], tiles of TM x TN_HEAD
__device__ void phase_heads(const EncArgs& a, unsigned char* smem, Bars& bars) {
  const EncDims& d = a.d;
  const EncLayout& L = a.L;
  const int E = d.E, Ep = d.Ep(), Lz = d.Lz, N = 2 * Lz, E8 = up(E, 8);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int sh = E8 + L.pad_h;
  const float* sH = reinterpret_cast<const float*>(smem);
  float* part = reinterpret_cast<float*>(smem);  // the warps' partial tiles, over the h2 tile
  constexpr int NT = TN_HEAD / 8, RED = TM * TN_HEAD / THREADS;
  const int tiles_n = (N + TN_HEAD - 1) / TN_HEAD;
  for (int tile = blockIdx.x; tile < L.tiles_head; tile += gridDim.x) {
    const int m0 = tile / tiles_n * TM, n0 = tile % tiles_n * TN_HEAD;
    float bias[RED];  // of this thread's outputs below
#pragma unroll
    for (int r = 0; r < RED; ++r) {
      const int n = n0 + (tid + r * THREADS) % TN_HEAD;
      bias[r] = n < Lz ? a.bmu[n] : (n < N ? a.blv[n - Lz] : 0.0f);
    }
    if (warp == 0) tile_rows_copy(smem, sh * 4, a.h2, Ep, 4, m0, d.B, bars.bar + BAR_H2);
    if (tid == 0 && tile != (int)blockIdx.x) head_w_copy(a, smem, bars.bar + BAR_HW, tile);  // else copied in B
    bars.wait(BAR_H2);
    bars.wait(BAR_HW);
    // the tile's rows of W (fp32, unpadded): this lane's row of each n8 tile
    const HeadRows hr = head_w_rows(a, tile);
    const float* brow[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = j * 8 + g;
      brow[j] = n < hr.mu_rows
                    ? reinterpret_cast<const float*>(smem + L.hw_off + hr.mu.offset) + (size_t)n * E
                    : reinterpret_cast<const float*>(smem + lv_region(a, hr) + hr.lv.offset) + (size_t)(n - hr.mu_rows) * E;
    }
    float acc[2][NT][4] = {}, corr[2][NT][4] = {};
    for (int s = warp; s < E8 / 8; s += WARPS) {
      const int kk = s * 8;
      // W has no padding column: its columns from E on are read as 0
      fp32_k8(acc, corr, [&](int m, int k) { return sH[m * sh + kk + k]; },
              [&](int k, int n) { return kk + k < E ? brow[n >> 3][kk + k] : 0.0f; }, lane);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(&part[(warp * TM + i * 16 + g + 8 * h) * PART_H + j * 8 + 2 * t]) =
              make_float2(acc[i][j][2 * h] + corr[i][j][2 * h], acc[i][j][2 * h + 1] + corr[i][j][2 * h + 1]);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RED; ++r) {
      const int o = tid + r * THREADS, m = o / TN_HEAD, c = o % TN_HEAD, n = n0 + c;
      float s = part[m * PART_H + c];
      for (int w = 1; w < WARPS; ++w) s += part[(w * TM + m) * PART_H + c];
      if (m0 + m < d.B && n < N) {
        if (n < Lz)
          a.mu[(size_t)(m0 + m) * Lz + n] = s + bias[r];
        else
          a.logvar[(size_t)(m0 + m) * Lz + n - Lz] = s + bias[r];
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS, 1) fused_encode_kernel(const __grid_constant__ EncArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  Bars bars{reinterpret_cast<uint64_t*>(smem + a.L.bar_off), 0u};
  if (threadIdx.x == 0) {
    for (int i = 0; i < NBAR; ++i) mbar_init(bars.bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  phase_conv(a, smem, bars);
  grid.sync();  // h3 complete
  phase_dense(a, smem, bars);
  grid.sync();  // h2 complete
  phase_heads(a, smem, bars);
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 = success),
// or ENC_NO_LAYOUT where the shape has no layout within smem_limit bytes of
// shared memory a block. conv_w / conv_b / cout / ksize: n_conv entries
// each, the convs' fp32 weights (Cout, Cin, K) and biases; w0 (E, F), the
// heads (Lz, E), all fp32 in torch layout; codes (B, T) of code_kind
// (conv_enc.cuh CodeKind); scratch holds ceil16(B * Fp * 2) + B * Ep * 4
// bytes. `grid` blocks, one per SM, all resident (a cooperative launch).
extern "C" int molvax_fused_encode(const void* codes, int code_kind, const void* const* conv_w,
                                   const void* const* conv_b, int n_conv, const int* cout, const int* ksize,
                                   const float* w0, const float* b0, const float* wmu, const float* bmu,
                                   const float* wlv, const float* blv, float* mu, float* logvar, void* scratch,
                                   int B, int T, int C, int seq, int E, int Lz, int relu, int grid,
                                   int smem_limit, void* stream) {
  if (n_conv < 1 || n_conv > MAX_CONV || grid < 1 || code_kind < CODE_U8 || code_kind > CODE_I64)
    return (int)cudaErrorInvalidValue;
  EncArgs a;
  memset(&a, 0, sizeof(a));
  a.d.n = n_conv;
  for (int i = 0; i < n_conv; ++i) {
    a.d.cout[i] = cout[i];
    a.d.k[i] = ksize[i];
    a.conv_w[i] = static_cast<const float*>(conv_w[i]);
    a.conv_b[i] = static_cast<const float*>(conv_b[i]);
  }
  a.d.T = T;
  a.d.C = C;
  a.d.seq = seq;
  a.d.B = B;
  a.d.E = E;
  a.d.Lz = Lz;
  a.relu = relu;
  // the warps a row that the batch gives, or more where its teams' buffers
  // do not fit (a long sequence at a large batch): fewer rows at once, the
  // same sums
  for (a.team = team_warps(B, grid);; a.team *= 2) {
    a.L = enc_layout(a.d, a.team, code_bytes(code_kind), (size_t)smem_limit);
    if (a.L.ok || a.team >= WARPS) break;
  }
  if (!a.L.ok) return ENC_NO_LAYOUT;
  a.codes = codes;
  a.code_kind = code_kind;
  a.w0 = w0;
  a.b0 = b0;
  a.wmu = wmu;
  a.bmu = bmu;
  a.wlv = wlv;
  a.blv = blv;
  a.h3 = static_cast<uint16_t*>(scratch);
  a.h2 = reinterpret_cast<float*>(static_cast<unsigned char*>(scratch) + up16((size_t)B * a.d.Fp() * 2));
  a.mu = mu;
  a.logvar = logvar;
  cudaError_t err = cudaFuncSetAttribute(fused_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)a.L.smem);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_encode_kernel), dim3(grid), dim3(THREADS), params,
                                    a.L.smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
