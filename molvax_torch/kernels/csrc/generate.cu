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
// What bounds it on an H100. At zinc250k width (3 x GRU-501, C=37) a step
// is ~0.6 GFLOP at B=256 (2.4 us of the tensor cores' peak over 120 steps
// is the whole decode's 0.24 ms bound), but the steps are serial: each
// layer waits for the one below, each step for the code of the one before.
// The decoder's bf16 weights are 7.7 MB. The TPU kernel kept all of them in
// VMEM for the whole loop.
//
// Two instances. The persistent decode (gen_persistent_kernel, chosen by
// generate_plan in kernels/generate.py wherever a layout fits) keeps every
// decoder weight in shared memory, as the TPU kept them in VMEM: one
// cooperative launch, one block per SM, g row groups of `rows` batch rows x
// q blocks; block j of a group owns GEN_UNITS = 8 hidden units of every
// layer, and holds for the whole decode its slices (the r|z|n columns of
// its units) of W_hh of every layer, of W_ih of every layer above the
// first, and of W_c, plus all of W_out (7.7 MB over 63 blocks at zinc250k
// width: ~164 KB a block). Warp w takes m16 tile w of the group's rows, so
// each thread's mma.sync accumulator fragment is its set of (row, unit)
// pairs: gate math and the fp32 carry stay in registers. A step is L
// phases, each closed by a barrier of the group (a global counter):
//   phase 1: gi_1 = giz1 + W_c[code] (prev is one-hot, so bf16(prev) @ W_c
//            is row `code` of W_c, exactly; only t = 0's start token is a
//            product), the gate with gh_1 from the step before; store
//            bf16 h_1;
//   phase l: the warp reads its rows of the group's bf16 h_{l-1} from L2
//            once and multiplies them by both W_ih_l (gi_l, now) and
//            W_hh_{l-1} (gh_{l-1} of the next step, kept in registers);
//            the gate; store bf16 h_l;
//   head:    every block reads h_L and computes gh_L of the next step and
//            the logits of all the group's rows (N = 40 padded classes),
//            then the first maximum (with the noise) of every row: all
//            blocks run the same instructions on the same operands, so all
//            hold the same codes, and phase 1 of the next step needs no
//            barrier: L barriers a step, not L + 1.
// The h row block goes from L2 straight into registers (16-byte ld.cg, 3
// blocks of 32 columns in flight a thread): a warp's rows are its own, so a
// ring in shared memory would share nothing. For that a thread's 16 bytes,
// columns [8 tq, 8 tq + 8) of a 32-column block, are the A fragments of two
// k16 steps; the packed weights hold K in the matching order (k_order in
// kernels/generate.py), so the sum runs over the same pairs of columns.
// bf16 h of every layer lies in device memory by step parity (a buffer is
// written again two steps later, after the barriers between). Every sum
// has a fixed order: two decodes give identical codes.
//
// The row-block decode (fused_generate_kernel) is the instance for widths
// no plan takes (moses_scaled's 4 x GRU-1024, whose ~44 MB of weights
// exceed the card's ~30 MB of shared memory). Rows are independent, so the
// grid runs over blocks of RB batch rows and each block loops over T and
// over the L layers by itself: no grid-wide synchronisation. Thread j of
// the block owns hidden unit j (and j + THREADS, ...) of every layer for
// its RB rows: it computes the six dot products (gi and gh, gates r|z|n) of
// that unit in registers, applies the gate, and keeps the fp32 h carry of
// its own units in shared memory. The bf16 operand copy of each layer's h,
// which every thread reads, is double buffered by step parity and stored
// row-interleaved ([k][RB]), so one 8-byte shared load gives the operand
// of all RB rows. Weights are bf16 in (in, 3H) layout, re-read from L2
// every step by every block, and the products run on the FMA pipes.
//
// Sampling noise is a counter-based 32-bit hash of (seed, t, row, class),
// lowbias32 rounds; molvax_torch/kernels/generate.py computes the same bits
// with torch integer ops, so kernel and plain version see identical noise.
// The row is global: noise_row + the batch row, so a data-parallel rank
// that decodes its share of a global batch draws that batch's noise.

#include "common.cuh"
#include "gemm.cuh"

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
                      uint32_t seed, float temperature, uint32_t noise_row) {
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
          const uint32_t bits = noise_bits(seed, (uint32_t)t, noise_row + (uint32_t)(row0 + r), (uint32_t)c);
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


// -- the persistent decode ----------------------------------------------------

constexpr int GEN_UNITS = 8;      // hidden units a block owns in every layer: one n8 tile a gate
constexpr int GEN_GATES = 3 * GEN_UNITS;
constexpr int GEN_LAYERS = 4;     // instances L = 1 .. 4
constexpr int GEN_NOUT = 40;      // the head's columns: the classes, padded to 5 n8 tiles
constexpr int GEN_NT_OUT = GEN_NOUT / 8;
constexpr int GEN_MAX_ROWS = 128; // one m16 tile a warp, at most 8 warps
constexpr int GEN_PF = 3;         // 32-column blocks of the h row block in flight a thread
constexpr int GEN_KPAD = 8;       // bf16 padding of a shared-memory weight row (16 bytes)

struct GenArgs {
  const float* giz1;              // (B, 3H) fp32
  const float* start;             // (C) fp32, the start token (zeros if none)
  const __nv_bfloat16* w;         // (q, gen_block_elems) the blocks' packed weights
  const float* bias;              // [b_hh_l (3H), l < L | b_ih_l (3H), 1 <= l < L | b_out (C)]
  __nv_bfloat16* hbuf;            // (L, 2, Bp, K) bf16 h by layer and step parity, zeros
  int* flags;                     // (g) zeros: the groups' barrier counters
  int* codes;                     // (B, T)
  int B, T, C, H, K, Bp, q, rows; // K = H rounded up to 32; Bp >= row_base + g rows
  int row_base, row_end, greedy;  // the batch rows of this launch
  uint32_t seed;
  float temperature;
  uint32_t noise_row;             // the global index of batch row 0 (the noise's row)
};

// A block's packed weights, in bf16 elements, rows of K + GEN_KPAD (the
// shared-memory layout, copied as it lies):
//   slot s < L:       W_hh_s, rows gate * 8 + u = column gate * H + 8 j + u
//   slot L - 1 + l:   W_ih_l for 1 <= l < L, the same rows
//   then W_out:       GEN_NOUT rows, one per class (zero rows past C)
//   then W_c:         GEN_GATES rows of round8(C) columns (no K order)
// Each row of a product's weight holds K in the packed order.
__host__ __device__ inline size_t gen_block_elems(int C, int K, int L) {
  return (size_t)((2 * L - 1) * GEN_GATES + GEN_NOUT) * (K + GEN_KPAD) +
         (size_t)GEN_GATES * ((C + 7) / 8 * 8);
}

// The row groups' barrier, as csrc/gru_stack.cu's: every block of the group
// has stored its part of the phase (count reaches `target`) before any
// reads it.
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

// 16 bytes of the h row block, from L2 (another block wrote them in this
// launch: never through L1). This and gen_mma are functions of their own
// so that probes/generate_probe.py can take the reads or the products out.
__device__ __forceinline__ uint4 load_h16(const uint4* p) { return __ldcg(p); }

__device__ __forceinline__ void gen_mma(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  mma_bf16(d, a, b);
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// acc[n] += x . W_n for the warp's m16 tile of rows and NB weight tiles of
// 8 columns each: x the bf16 rows gq (xa) and gq + 8 (xb) of the h row
// block in device memory, both already at column 8 tq; tile[n] the
// shared-memory address of this lane's ldmatrix row of W_n; kb blocks of
// 32 columns. Block c's 16 bytes of a row hold columns 8 tq .. 8 tq + 7:
// words 0, 1 are the A fragment's k-pairs (2 tq, 2 tq + 8) of the block's
// first k16 step, words 2, 3 those of its second; the packed W rows hold K
// in the same order (kernels/generate.py::k_order), so one ldmatrix.x4 a
// tile gives the B fragments of both steps. A block's fragments of every
// tile are loaded before its products, and its first step's NB products
// go before its second's: NB independent chains in flight, not one.
template <int NB>
__device__ __forceinline__ void warp_product(const uint4* xa, const uint4* xb, int kb,
                                             const uint32_t (&tile)[NB], float (&acc)[NB][4]) {
  uint4 ra[GEN_PF], rb[GEN_PF];
#pragma unroll
  for (int i = 0; i < GEN_PF; ++i)
    if (i < kb) {
      ra[i] = load_h16(xa + 4 * i);
      rb[i] = load_h16(xb + 4 * i);
    }
  for (int c0 = 0; c0 < kb; c0 += GEN_PF) {
#pragma unroll
    for (int i = 0; i < GEN_PF; ++i) {
      const int c = c0 + i;
      if (c < kb) {
        uint32_t bw[NB][4];
#pragma unroll
        for (int n = 0; n < NB; ++n) ldsm_x4(bw[n], tile[n] + c * 64);
        const uint32_t a0[4] = {ra[i].x, rb[i].x, ra[i].y, rb[i].y};
        const uint32_t a1[4] = {ra[i].z, rb[i].z, ra[i].w, rb[i].w};
        if (c + GEN_PF < kb) {
          ra[i] = load_h16(xa + 4 * (c + GEN_PF));
          rb[i] = load_h16(xb + 4 * (c + GEN_PF));
        }
#pragma unroll
        for (int n = 0; n < NB; ++n) gen_mma(acc[n], a0, &bw[n][0]);
#pragma unroll
        for (int n = 0; n < NB; ++n) gen_mma(acc[n], a1, &bw[n][2]);
      }
    }
  }
}

// Whether (v, i) comes first in torch.argmax's order: a NaN above every
// number (the first NaN wins), then the larger value, then the lower index.
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  const bool vn = v != v, bn = bv != bv;
  if (vn != bn) return vn;
  if (!vn && v != bv) return v > bv;
  return i < bi;
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

// The codes of step t of the thread's rows row[0] (code[0]) and row[2]
// (code[1]) from its quad's logits, the head's GEN_NT_OUT tiles after the
// 3 of gh_L in acc: the first maximum of logits + b_out (over the
// temperature, with the noise, when sampled).
__device__ __forceinline__ void head_codes(const GenArgs& a, const float (&acc)[3 + GEN_NT_OUT][4],
                                           const float* b_out, int t, const int (&row)[4], int tq,
                                           int (&code)[2]) {
  float bv[2] = {-__int_as_float(0x7f800000), -__int_as_float(0x7f800000)};
  int bi[2] = {0x7fffffff, 0x7fffffff};
#pragma unroll
  for (int n = 0; n < GEN_NT_OUT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cls = n * 8 + 2 * tq + (e & 1);
      if (cls < a.C) {
        float v = acc[3 + n][e] + __ldg(b_out + cls);
        if (!a.greedy) {
          const uint32_t bits = noise_bits(a.seed, (uint32_t)t, a.noise_row + (uint32_t)row[e], (uint32_t)cls);
          const float u = ((float)(bits >> 8) + 1.0f) * (1.0f / 16777216.0f);
          v = v / a.temperature + (-logf(-logf(u)));
        }
        if (before(v, cls, bv[e >> 1], bi[e >> 1])) {
          bv[e >> 1] = v;
          bi[e >> 1] = cls;
        }
      }
    }
  // the row's 40 scores lie in the 4 lanes of a quad
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv[r], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[r], off);
      if (before(ov, oi, bv[r], bi[r])) {
        bv[r] = ov;
        bi[r] = oi;
      }
    }
  code[0] = bi[0];
  code[1] = bi[1];
}

template <int L>
__global__ void __launch_bounds__(GEN_MAX_ROWS / 16 * 32, 1) gen_persistent_kernel(const GenArgs a) {
  extern __shared__ __align__(16) unsigned char gsmem[];
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(gsmem);
  const int H = a.H, G = 3 * H, KS = a.K + GEN_KPAD, CS = (a.C + 7) / 8 * 8, kb = a.K / 32;
  const int grp = blockIdx.x / a.q, jb = blockIdx.x % a.q, u0 = jb * GEN_UNITS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gq = lane >> 2, tq = lane & 3;

  // the block's weights, resident for the whole decode
  const size_t nel = gen_block_elems(a.C, a.K, L);
  const __nv_bfloat16* src = a.w + (size_t)jb * nel;
  for (size_t i = threadIdx.x; i < nel / 8; i += blockDim.x) cp_async16(sw + i * 8, src + i * 8, 16);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this thread's (row, unit) pairs: fragment element e
  const int rowA = a.row_base + grp * a.rows + warp * 16 + gq, rowB = rowA + 8;
  int row[4], ul[4], unit[4];
  bool rok[4], uok[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    row[e] = e < 2 ? rowA : rowB;
    ul[e] = 2 * tq + (e & 1);
    unit[e] = u0 + ul[e];
    rok[e] = row[e] < a.row_end;
    uok[e] = unit[e] < H;
  }
  const float* b_out = a.bias + (size_t)(2 * L - 1) * G;
  // this lane's ldmatrix.x4 row: row lane % 8 of a tile, columns 8 (lane / 8) of a block
  const uint32_t sbase = smem_addr(sw) + (uint32_t)(((lane & 7) * KS + (lane >> 3) * 8) * 2);
  auto tile_of = [&](int slot, int gate) {
    return sbase + (uint32_t)((slot * GEN_GATES + gate * GEN_UNITS) * KS * 2);
  };
  const __nv_bfloat16* swc = sw + (size_t)((2 * L - 1) * GEN_GATES + GEN_NOUT) * KS;
  const size_t hstride = (size_t)a.Bp * a.K;  // one (layer, parity) buffer
  const int xoff_a = rowA * a.K + 8 * tq, xoff_b = rowB * a.K + 8 * tq;

  // t = 0 feeds the start token: a product, the same for every row
  float sgi[3][2];
#pragma unroll
  for (int gate = 0; gate < 3; ++gate)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const __nv_bfloat16* wc = swc + (gate * GEN_UNITS + 2 * tq + u) * CS;
      float s = 0.0f;
      for (int c = 0; c < a.C; ++c)
        s = fmaf(__bfloat162float(__float2bfloat16_rn(a.start[c])), __bfloat162float(wc[c]), s);
      sgi[gate][u] = s;
    }

  float h[L][4], gh[L][3][4];  // the fp32 carry; gh_l of the coming step (no bias)
#pragma unroll
  for (int l = 0; l < L; ++l)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[l][e] = 0.0f;
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) gh[l][gate][e] = 0.0f;
    }
  int code[2] = {0, 0};  // the codes of the step before, rows gq and gq + 8 of the warp's tile

  for (int t = 0; t < a.T; ++t) {
    const int par = t & 1;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      float gi[3][4];
      if (l == 0) {
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float gz = rok[e] && uok[e] ? __ldg(a.giz1 + (size_t)row[e] * G + gate * H + unit[e]) : 0.0f;
            const float wx = t == 0 ? sgi[gate][e & 1]
                                    : __bfloat162float(swc[(gate * GEN_UNITS + ul[e]) * CS + code[e >> 1]]);
            gi[gate][e] = gz + wx;
          }
      } else {
        // one read of h_{l-1}: gi_l now, gh_{l-1} of the next step
        float acc[6][4];
        uint32_t tiles[6];
#pragma unroll
        for (int n = 0; n < 6; ++n) {
          tiles[n] = tile_of(n < 3 ? L - 1 + l : l - 1, n % 3);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
        }
        const __nv_bfloat16* x = a.hbuf + ((size_t)(l - 1) * 2 + par) * hstride;
        warp_product<6>(reinterpret_cast<const uint4*>(x + xoff_a), reinterpret_cast<const uint4*>(x + xoff_b),
                        kb, tiles, acc);
        const float* b_ih = a.bias + (size_t)(L - 1 + l) * G;
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            gi[gate][e] = acc[gate][e] + (uok[e] ? __ldg(b_ih + gate * H + unit[e]) : 0.0f);
            gh[l - 1][gate][e] = acc[3 + gate][e];
          }
      }
      // the gate on the fragments, then bf16 h_l for the phases after
      const float* b_hh = a.bias + (size_t)l * G;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float b0 = uok[e] ? __ldg(b_hh + unit[e]) : 0.0f;
        const float b1 = uok[e] ? __ldg(b_hh + H + unit[e]) : 0.0f;
        const float b2 = uok[e] ? __ldg(b_hh + 2 * H + unit[e]) : 0.0f;
        const float rg = sigmoid_f(gi[0][e] + (gh[l][0][e] + b0));
        const float zg = sigmoid_f(gi[1][e] + (gh[l][1][e] + b1));
        const float n = tanhf(gi[2][e] + rg * (gh[l][2][e] + b2));
        const float hv = n + zg * (h[l][e] - n);
        h[l][e] = uok[e] ? hv : 0.0f;  // a unit past H stays 0: K's padding
      }
      __nv_bfloat16* hout = a.hbuf + ((size_t)l * 2 + par) * hstride + u0 + 2 * tq;
      if (rok[0]) *reinterpret_cast<uint32_t*>(hout + (size_t)rowA * a.K) = bf16_pair(h[l][0], h[l][1]);
      if (rok[2]) *reinterpret_cast<uint32_t*>(hout + (size_t)rowB * a.K) = bf16_pair(h[l][2], h[l][3]);
      group_barrier(a.flags + grp, a.q * (t * L + l + 1));
    }

    // the head: gh_L of the next step, the logits and each row's code
    float acc[3 + GEN_NT_OUT][4];
    uint32_t tiles[3 + GEN_NT_OUT];
#pragma unroll
    for (int n = 0; n < 3 + GEN_NT_OUT; ++n) {
      tiles[n] = n < 3 ? tile_of(L - 1, n) : tile_of(2 * L - 1, 0) + (uint32_t)((n - 3) * 8 * KS * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    }
    const __nv_bfloat16* x = a.hbuf + ((size_t)(L - 1) * 2 + par) * hstride;
    const uint4* xa = reinterpret_cast<const uint4*>(x + xoff_a);
    const uint4* xb = reinterpret_cast<const uint4*>(x + xoff_b);
    warp_product<3 + GEN_NT_OUT>(xa, xb, kb, tiles, acc);
#pragma unroll
    for (int gate = 0; gate < 3; ++gate)
#pragma unroll
      for (int e = 0; e < 4; ++e) gh[L - 1][gate][e] = acc[gate][e];
    head_codes(a, acc, b_out, t, row, tq, code);
    if (jb == 0 && tq == 0) {
      if (rok[0]) a.codes[(size_t)rowA * a.T + t] = code[0];
      if (rok[2]) a.codes[(size_t)rowB * a.T + t] = code[1];
    }
  }
}

template <int L>
int launch_gen(const GenArgs& a, int blocks, int threads, size_t smem, void* stream) {
  auto kernel = gen_persistent_kernel<L>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {const_cast<GenArgs*>(&a)};
  // cooperative: the launch fails unless every block is resident, which the
  // group barriers need
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(blocks), dim3(threads), params,
                                    smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" size_t molvax_fused_generate_smem(int C, int H, int L) {
  return (size_t)L * RB * H * sizeof(float) +
         (size_t)2 * L * H * RB * sizeof(__nv_bfloat16) +
         (size_t)C * RB * sizeof(__nv_bfloat16) + (size_t)RB * C * sizeof(float) +
         RB * sizeof(int);
}

// Launches on `stream` and returns the launch's cudaError_t (0 = success).
// Batch row r draws the sampling noise of global row noise_row + r.
extern "C" int molvax_fused_generate(const float* giz1, const float* start,
                                     const void* w, const float* bias,
                                     int* codes, int B, int T, int C, int H,
                                     int L, int greedy, unsigned int seed,
                                     float temperature, unsigned int noise_row, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || H <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = molvax_fused_generate_smem(C, H, L);
  cudaError_t err = cudaFuncSetAttribute(
      fused_generate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + RB - 1) / RB);
  fused_generate_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      giz1, start, static_cast<const __nv_bfloat16*>(w), bias, codes, B, T, C, H, L,
      greedy, seed, temperature, noise_row);
  return (int)cudaGetLastError();
}

// The persistent decode of batch rows [row_base, row_end) (one launch of a
// plan's slices; kernels/generate.py::generate_plan): g groups of `rows`
// rows, q = ceil(H / 8) blocks a group. hbuf (L, 2, Bp, K) and flags (g)
// come zeroed. Batch row r draws the sampling noise of global row
// noise_row + r. Returns the launch's cudaError_t.
extern "C" int molvax_generate_persistent(const float* giz1, const float* start, const void* w,
                                          const float* bias, void* hbuf, int* flags, int* codes, int B,
                                          int T, int C, int H, int L, int K, int Bp, int q, int g, int rows,
                                          int row_base, int row_end, int greedy, unsigned int seed,
                                          float temperature, unsigned int noise_row, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || C > GEN_NOUT || H <= 0 || L < 1 || L > GEN_LAYERS || K % 32 ||
      K < H || q != (H + GEN_UNITS - 1) / GEN_UNITS || g <= 0 || rows <= 0 || rows % 16 ||
      rows > GEN_MAX_ROWS || row_base < 0 || row_end > B || row_end <= row_base ||
      row_base + g * rows > Bp)
    return (int)cudaErrorInvalidValue;
  const GenArgs a{giz1, start, static_cast<const __nv_bfloat16*>(w), bias, static_cast<__nv_bfloat16*>(hbuf),
                  flags, codes, B, T, C, H, K, Bp, q, rows, row_base, row_end, greedy, seed, temperature,
                  noise_row};
  const size_t smem = gen_block_elems(C, K, L) * sizeof(__nv_bfloat16);
  const int blocks = g * q, threads = rows / 16 * 32;
  switch (L) {
    case 1: return launch_gen<1>(a, blocks, threads, smem, stream);
    case 2: return launch_gen<2>(a, blocks, threads, smem, stream);
    case 3: return launch_gen<3>(a, blocks, threads, smem, stream);
    default: return launch_gen<4>(a, blocks, threads, smem, stream);
  }
}

// The SMs of CUDA device `device` and the shared memory a block may opt in
// to, which generate_plan lays the persistent decode out by. Returns the
// query's cudaError_t.
extern "C" int molvax_card_limits(int device, int* sms, int* smem) {
  cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}
