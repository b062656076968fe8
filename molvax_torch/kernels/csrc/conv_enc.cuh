// The fused encoder's conv stages and shared-memory layout, written once
// for csrc/conv_enc.cu and, as host C++, for the CPU tests
// (csrc/conv_enc_host.cpp, built by tests/test_torch_encode_design.py).
//
// A team of warps runs the whole conv stack of one batch row, in shared
// memory (conv_row; the team's size below):
//   stage 0  the first conv over the one-hot, as the gather it is:
//            'seq'     out[o][w] = sum_k W1[o][code[w+k]][k]
//            'charset' out[o][w] = sum_t W1[o][t][code[t]-w], 0 <= code[t]-w < K
//            (a code outside [0, C) adds nothing: a zero one-hot row), a
//            lane a position and 8 channels, from a table of W1 staged as
//            [input channel][shift][output channel]
//   stage s  the later convs on the tensor cores (mma.sync m16n8k16, bf16
//            operands, fp32 sums): positions are the M axis, output
//            channels the N axis, and (shift k, input channel c) the K
//            axis, one k16 step per shift and block of 16 channels. The
//            input lies position-major, [w][c] with the channels padded
//            to 16 and each row to 16 + 8 elements, so the A tile of
//            shift k is the 16 x 16 block at row w0 + k, and every
//            fragment word (two neighbouring channels) is one 32-bit load,
//            free of bank conflicts.
//   each stage: + bias, ReLU, rounded to bf16 (the reference rounds the
//   conv operands to bf16; fp32 sums)
//   flush    the last stage's output as bf16 in channel-major (NCH) order,
//            the order of W_0's columns, zero-padded to Fp = ceil16(F)
//
// A warp's values are written as PerLane<T>: on the card a lane's own T,
// in host C++ 32 of them. ENC_LANES(l) runs its body for each lane l (on
// the card once, for the lane's own); warp_mma and warp_ldmatrix_x4 are
// mma.sync and ldmatrix on the card and their emulation over the 32 lanes'
// fragments on the host (the m16n8k16 and m8n8 fragment layouts of the PTX
// ISA). No collective sits under a branch that differs between lanes.

#pragma once

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_bf16.h>
#define ENC_FN __device__ __forceinline__
#define ENC_HD __host__ __device__ __forceinline__
#else
#define ENC_FN inline
#define ENC_HD inline
#endif

namespace conv_enc {

constexpr int MAX_CONV = 8;
constexpr int WARPS = 8;                 // warps a block, in every phase
constexpr int THREADS = WARPS * 32;
constexpr int WS_STRIDE = 24;            // a staged conv weight row: 16 channels + 8
constexpr int TM = 32;                   // rows of a dense or head tile
constexpr int TN_DENSE = 32;             // columns of a dense tile (4 n8 tiles)
constexpr int TN_HEAD = 40;              // columns of a head tile (5 n8 tiles)
constexpr int PART_D = TN_DENSE + 12;    // a row of a warp's partial dense tile (fp32)
constexpr int PART_H = TN_HEAD + 12;     // a row of a warp's partial head tile

// codes' element types (the wrapper passes the tensor's own)
enum CodeKind { CODE_U8 = 0, CODE_I8 = 1, CODE_I16 = 2, CODE_I32 = 3, CODE_I64 = 4 };

ENC_HD int code_bytes(int kind) { return kind <= CODE_I8 ? 1 : kind == CODE_I16 ? 2 : kind == CODE_I32 ? 4 : 8; }

ENC_HD int up(int x, int m) { return (x + m - 1) / m * m; }

// i / d and i % d for 0 <= i < 2^16, 1 <= d < 2^12, without a division or
// a conversion (both slow on the card): q = the high word of i * ceil(2^32
// / d), exact in that range (the product's error stays below 1 / d); d = 1
// apart
struct FastDiv {
  int d;
  uint32_t m;
  ENC_HD explicit FastDiv(int d_) : d(d_), m(d_ > 1 ? (uint32_t)(0xffffffffu / (uint32_t)d_) + 1u : 0u) {}
  ENC_HD int div(int i, int& r) const {
#ifdef __CUDA_ARCH__
    const int q = d > 1 ? (int)__umulhi((uint32_t)i, m) : i;
#else
    const int q = d > 1 ? (int)(((uint64_t)(uint32_t)i * m) >> 32) : i;
#endif
    r = i - q * d;
    return q;
  }
};

// -- bf16 ---------------------------------------------------------------------

ENC_HD uint16_t bf16_bits(float x) {  // the host's rounding (the card's is __floats2bfloat162_rn)
  uint32_t u;
  memcpy(&u, &x, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (uint16_t)((u >> 16) | 0x40u);  // NaN stays NaN
  u += 0x7fffu + ((u >> 16) & 1u);                                             // to nearest, ties to even
  return (uint16_t)(u >> 16);
}

ENC_HD float bf16_float(uint16_t b) {
  const uint32_t u = (uint32_t)b << 16;
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float x;
  memcpy(&x, &u, 4);
  return x;
#endif
}

ENC_HD uint32_t pack2(float lo, float hi) {
#ifdef __CUDA_ARCH__
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // one conversion for the pair
  return *reinterpret_cast<const uint32_t*>(&v);
#else
  return (uint32_t)bf16_bits(lo) | ((uint32_t)bf16_bits(hi) << 16);
#endif
}

ENC_HD uint32_t ld32(const uint16_t* p) { return *reinterpret_cast<const uint32_t*>(p); }
ENC_HD void st32(uint16_t* p, uint32_t v) { *reinterpret_cast<uint32_t*>(p) = v; }

// A code as an int; one outside the int range as -1 (outside [0, C) too)
ENC_HD int load_code(const void* codes, size_t i, int kind) {
  switch (kind) {
    case CODE_U8: return static_cast<const uint8_t*>(codes)[i];
    case CODE_I8: return static_cast<const int8_t*>(codes)[i];
    case CODE_I16: return static_cast<const int16_t*>(codes)[i];
    case CODE_I32: return static_cast<const int32_t*>(codes)[i];
    default: {
      const long long c = static_cast<const long long*>(codes)[i];
      return (c < 0 || c > 0x7fffffffLL) ? -1 : (int)c;
    }
  }
}

// -- the warp: lanes and the product ------------------------------------------

#ifdef __CUDACC__
template <typename T>
struct PerLane {
  T v;
  __device__ __forceinline__ T& operator[](int) { return v; }
  __device__ __forceinline__ const T& operator[](int) const { return v; }
};
#define ENC_LANES(l) for (int l = threadIdx.x & 31, l##_once = 1; l##_once; l##_once = 0)
#else
template <typename T>
struct PerLane {
  T v[32];
  T& operator[](int l) { return v[l]; }
  const T& operator[](int l) const { return v[l]; }
};
#define ENC_LANES(l) for (int l = 0; l < 32; ++l)
#endif

struct FragA { uint32_t r[4]; };
struct FragB { uint32_t r[2]; };
struct Acc { float v[4]; };

// d += a . b, one m16n8k16 tile: bf16 operands, fp32 sums. Lane l = 4 g + t
// holds a = A[g][2t..], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..],
// b = B[2t..][g], B[2t+8..][g], and d = D[g][2t], D[g][2t+1], D[g+8][2t],
// D[g+8][2t+1]; each 32-bit word two bf16, the lower index in the low half.
ENC_FN void warp_mma(PerLane<Acc>& d, const PerLane<FragA>& a, const PerLane<FragB>& b) {
#ifdef __CUDACC__
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d.v.v[0]), "+f"(d.v.v[1]), "+f"(d.v.v[2]), "+f"(d.v.v[3])
      : "r"(a.v.r[0]), "r"(a.v.r[1]), "r"(a.v.r[2]), "r"(a.v.r[3]), "r"(b.v.r[0]), "r"(b.v.r[1]));
#else
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, t = l & 3;
    const int ar[4] = {g, g + 8, g, g + 8}, ac[4] = {2 * t, 2 * t, 2 * t + 8, 2 * t + 8};
    for (int r = 0; r < 4; ++r) {
      A[ar[r]][ac[r]] = bf16_float((uint16_t)(a[l].r[r] & 0xffffu));
      A[ar[r]][ac[r] + 1] = bf16_float((uint16_t)(a[l].r[r] >> 16));
    }
    for (int r = 0; r < 2; ++r) {
      B[2 * t + 8 * r][g] = bf16_float((uint16_t)(b[l].r[r] & 0xffffu));
      B[2 * t + 8 * r + 1][g] = bf16_float((uint16_t)(b[l].r[r] >> 16));
    }
  }
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, t = l & 3;
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
      float s = 0.0f;
      for (int k = 0; k < 16; ++k) s += A[row][k] * B[k][col];
      d[l].v[e] += s;
    }
  }
#endif
}

// Four 8 x 8 bf16 matrices from shared memory, ldmatrix.x4: lane j gives
// the address of row j % 8 of matrix j / 8 (16 bytes, 16-byte aligned);
// lane l receives, in word q, row l / 4, columns 2 (l % 4) and + 1 of
// matrix q.
ENC_FN void warp_ldmatrix_x4(PerLane<FragA>& out, const PerLane<const uint16_t*>& row) {
#ifdef __CUDACC__
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row.v));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(out.v.r[0]), "=r"(out.v.r[1]), "=r"(out.v.r[2]), "=r"(out.v.r[3])
               : "r"(a));
#else
  for (int l = 0; l < 32; ++l)
    for (int q = 0; q < 4; ++q) out[l].r[q] = ld32(row[8 * q + (l >> 2)] + 2 * (l & 3));
#endif
}

// -- dimensions and shared-memory layout --------------------------------------

struct EncDims {
  int n;               // convs, 1 .. MAX_CONV
  int cout[MAX_CONV];
  int k[MAX_CONV];
  int T, C, seq, B, E, Lz;

  ENC_HD int cin(int s) const { return s == 0 ? (seq ? C : T) : cout[s - 1]; }
  ENC_HD int wout(int s) const {
    int w = seq ? T : C;
    for (int i = 0; i <= s; ++i) w -= k[i] - 1;
    return w;
  }
  ENC_HD int cpad(int s) const { return up(cout[s], 16); }    // output channels, padded
  ENC_HD int stride(int s) const { return cpad(s) + 8; }      // a row of stage s's output
  ENC_HD int F() const { return cout[n - 1] * wout(n - 1); }
  ENC_HD int Fp() const { return up(F(), 16); }
  ENC_HD int Ep() const { return up(E, 8); }
  // rows of stage s's output buffer: its positions, and every row the next
  // stage's A tiles reach (its m16 tiles shifted by up to K - 1)
  ENC_HD int rows(int s) const {
    int r = wout(s);
    if (s + 1 < n) {
      const int reach = up(wout(s + 1), 16) + k[s + 1] - 1;
      r = reach > r ? reach : r;
    }
    return r;
  }
  // bytes of stage s's staged weights: stage 0 as [cin][K][cpad(0)] and a
  // zero row, a later stage as [K][cin / 16][n8-padded cout][WS_STRIDE]
  ENC_HD size_t wbytes(int s) const {
    if (s == 0) return ((size_t)cin(0) * k[0] + 1) * cpad(0) * 2;
    return (size_t)k[s] * (up(cin(s), 16) / 16) * up(cout[s], 8) * WS_STRIDE * 2;
  }
};

ENC_HD size_t up16(size_t x) { return (x + 15) / 16 * 16; }

// elements of padding to a row of `k` elements of `esize` bytes so that the
// row's stride in 32-bit words is 4 mod 32: the A-fragment loads of the
// dense and head phases are free of bank conflicts
ENC_HD int row_pad(int k, int esize) {
  const int per_word = 4 / esize;  // elements per 32-bit word
  const int words = k / per_word;
  return ((4 - words % 32) + 32) % 32 * per_word;
}

// bytes of a copy of `bytes` bytes of device memory made 16 bytes at a time
// from the 16-byte boundary below it (a bulk copy's unit)
ENC_HD size_t span_bytes(size_t bytes) { return up16(bytes) + 16; }

constexpr int NBAR = 5;  // the mbarriers of the bulk copies (conv_enc.cu)

struct EncLayout {
  int ok;
  int teams;                 // teams a block in phase A (WARPS / warps a row)
  size_t w_off[MAX_CONV];    // staged conv weights (bf16)
  size_t b_off[MAX_CONV];    // the convs' biases as they lie (fp32, a span each)
  size_t codes_off;          // each team's first row of codes as they lie (a span each)
  size_t codes_bytes;
  size_t raw_off[MAX_CONV];  // the convs' weights as they lie (fp32, a span each), over the teams'
                             // region before it is zeroed
  size_t warp_off;           // first team's region: codes, then two buffers
  size_t warp_bytes;         // a team's region
  size_t buf_elems;          // bf16 elements of one activation buffer
  size_t smem_conv;
  int pad_a;                 // dense: padding of the h3 rows
  size_t dw_off;             // dense: h3 tile (then the partial tiles) at 0, W_0's rows at dw_off
  int pre_dense;             // W_0's first tile copied during phase A (dw_off above phase A's region)
  int kc;                    // dense: W_0's columns a copy (F: whole rows, one span; else chunks of kc
                             // columns, a multiple of WARPS * 16, a span a row of wpitch bytes)
  size_t wpitch;
  int pad_h;                 // heads: padding of the h2 rows
  size_t hw_off;             // heads: h2 tile (then the partial tiles) at 0, the heads' rows at hw_off
  size_t bar_off;            // the mbarriers
  size_t smem_dense, smem_head, smem;
  int tiles_m, tiles_dense, tiles_head;
};

ENC_HD size_t max_z(size_t a, size_t b) { return a > b ? a : b; }

// The layout of one block's shared memory, and the phases' tiles, for
// teams of ts warps a row and `code_size`-byte codes; ok = 0 where a shape
// has no layout within `smem_limit`. The dense and head phases stage whole
// rows. Where it fits, phase A's region lies below the dense W region, so
// the first dense tile's W_0 is copied while the conv stack runs; the dense
// phase's partial tiles lie below the heads' W region, so the first head
// tile's W is copied while the dense phase ends.
ENC_HD EncLayout enc_layout(const EncDims& d, int ts, int code_size, size_t smem_limit) {
  EncLayout L;
  memset(&L, 0, sizeof(L));
  if (d.n < 1 || d.n > MAX_CONV || d.T < 1 || d.C < 1 || d.B < 1 || d.E < 1 || d.Lz < 1 || ts < 1 ||
      ts > WARPS || WARPS % ts || code_size < 1 || code_size > 8)
    return L;
  for (int s = 0; s < d.n; ++s)
    if (d.cout[s] < 1 || d.k[s] < 1 || d.wout(s) < 1) return L;
  L.teams = WARPS / ts;
  size_t off = 0;
  for (int s = 0; s < d.n; ++s) {
    L.w_off[s] = off;
    off += up16(d.wbytes(s));
  }
  for (int s = 0; s < d.n; ++s) {
    L.b_off[s] = off;
    off += span_bytes((size_t)d.cout[s] * 4);
  }
  L.codes_off = off;
  L.codes_bytes = span_bytes((size_t)d.T * code_size);
  off += L.teams * L.codes_bytes;
  size_t buf = 0;
  for (int s = 0; s < d.n; ++s) buf = max_z(buf, (size_t)d.rows(s) * d.stride(s));
  L.buf_elems = (buf + 7) / 8 * 8;
  L.warp_off = off;
  L.warp_bytes = up16((size_t)d.T * 4) + 2 * L.buf_elems * 2;
  L.smem_conv = off + L.teams * L.warp_bytes;
  for (int s = 0; s < d.n; ++s) {
    L.raw_off[s] = off;
    off += span_bytes((size_t)d.cout[s] * d.cin(s) * d.k[s] * 4);
  }
  L.smem_conv = max_z(L.smem_conv, off);

  const size_t part_d = (size_t)WARPS * TM * PART_D * 4, part_h = (size_t)WARPS * TM * PART_H * 4;
  const int e8 = up(d.E, 8);
  L.pad_a = row_pad(d.Fp(), 2);
  const size_t a_bytes = up16(max_z((size_t)TM * (d.Fp() + L.pad_a) * 2, part_d));
  const size_t wspan_d = span_bytes((size_t)TN_DENSE * d.F() * 4);
  L.pre_dense = max_z(L.smem_conv, a_bytes) + wspan_d <= smem_limit;
  L.dw_off = L.pre_dense ? up16(max_z(L.smem_conv, a_bytes)) : a_bytes;
  L.smem_dense = L.dw_off + wspan_d;
  L.kc = d.F();
  // rows too long for a tile's W_0 beside its h3 rows (a long sequence):
  // W_0 in chunks of columns, the widest that fits
  for (int kc = (d.F() - 1) / (WARPS * 16) * (WARPS * 16); kc > 0 && L.dw_off + wspan_d > smem_limit;
       kc -= WARPS * 16) {
    const size_t pitch = up16((size_t)kc * 4) + 16;
    if (up16(a_bytes + TN_DENSE * pitch) + NBAR * 8 <= smem_limit) {
      L.kc = kc;
      L.wpitch = pitch;
      L.smem_dense = a_bytes + TN_DENSE * pitch;
      break;
    }
  }
  L.pad_h = row_pad(e8, 4);
  L.hw_off = up16(max_z(part_d, max_z((size_t)TM * (e8 + L.pad_h) * 4, part_h)));
  L.smem_head = L.hw_off + span_bytes((size_t)TN_HEAD * d.E * 4) + 32;  // W_mu's and W_lv's spans
  L.bar_off = up16(max_z(L.smem_conv, max_z(L.smem_dense, L.smem_head)));
  L.smem = L.bar_off + NBAR * 8;
  L.tiles_m = (d.B + TM - 1) / TM;
  L.tiles_dense = L.tiles_m * ((d.E + TN_DENSE - 1) / TN_DENSE);
  L.tiles_head = L.tiles_m * ((2 * d.Lz + TN_HEAD - 1) / TN_HEAD);
  L.ok = L.smem <= smem_limit;
  return L;
}

// -- the conv stages -----------------------------------------------------------
//
// A team of `ts` warps (1, 2, 4 or 8; team_warps) runs a row: each stage's
// work is split over the team's warps, and the team meets at a barrier
// between stages. FOR_TEAM(w) runs its body as warp w of the team: on the
// card once, as the warp's own; in host C++ for each of the ts warps one
// after another, which is what the barriers between stages allow.

#ifdef __CUDACC__
#define ENC_BLOCK_LOOP(i, n) for (int i = threadIdx.x; i < (n); i += blockDim.x)
#else
#define ENC_BLOCK_LOOP(i, n) for (int i = 0; i < (n); ++i)
#endif

#ifdef __CUDACC__
#define FOR_TEAM(w, wit, ts) for (int w = (wit), w##_once = 1; w##_once; w##_once = 0)
#else
#define FOR_TEAM(w, wit, ts) for (int w = 0; w < (ts); ++w)
#endif

// warps a row takes: as many as the block's share of the batch leaves
ENC_HD int team_warps(int B, int grid) {
  const int per_block = (B + grid - 1) / grid;
  int ts = WARPS;
  while (ts > 1 && ts * (per_block < WARPS ? per_block : WARPS) > WARPS) ts /= 2;
  return ts;
}

// the team's barrier (named barrier 1 + team; a warp alone: __syncwarp)
ENC_FN void team_sync(int team, int ts) {
#ifdef __CUDACC__
  if (ts == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "r"(ts * 32) : "memory");
#endif
}

// n items, item i computed by get(i, v) (its loads) and stored by
// put(i, v), v two floats: by the whole block, four items a thread at a
// time with every load before any store, so a thread waits on shared
// memory once a batch, not once an item
template <typename Get, typename Put>
ENC_FN void block_items(int n, Get get, Put put) {
#ifdef __CUDACC__
  constexpr int U = 4;
  for (int base = threadIdx.x; base < n; base += U * blockDim.x) {
    float v[U][2];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * (int)blockDim.x < n) get(base + u * (int)blockDim.x, v[u]);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * (int)blockDim.x < n) put(base + u * (int)blockDim.x, v[u]);
  }
#else
  for (int i = 0; i < n; ++i) {
    float v[2];
    get(i, v);
    put(i, v);
  }
#endif
}

// Lay every conv's weights (fp32, torch layout (Cout, Cin, K), raw(s))
// out in shared memory as bf16, their padding zero: the first conv as the
// gather table [cin][K][cpad(0)] (a row of output channels for each input
// channel and shift) and a zero row, each later one in its B-operand layout
// [K][cin / 16][n8-padded cout][WS_STRIDE]. Every element of a layout is
// written, two neighbours an item, in target order; raw(s) is, on the
// card, the weights' copy in shared memory. Run by the whole block.
template <typename Raw>
ENC_FN void stage_conv_weights(const EncDims& d, const EncLayout& L, Raw raw, unsigned char* smem) {
  {
    uint16_t* w1 = reinterpret_cast<uint16_t*>(smem + L.w_off[0]);
    const int cin = d.cin(0), K = d.k[0], cp = d.cpad(0), cout = d.cout[0], rows = cin * K;
    const float* src = raw(0);
    const FastDiv by_cp(cp), by_k(K);
    block_items(
        (rows + 1) * cp / 2,
        [&](int pr, float* v) {
          int o, k;
          const int row = by_cp.div(2 * pr, o), j = by_k.div(row, k);
          for (int h = 0; h < 2; ++h)
            v[h] = row < rows && o + h < cout ? src[((size_t)(o + h) * cin + j) * K + k] : 0.0f;
        },
        [&](int pr, const float* v) { st32(w1 + 2 * pr, pack2(v[0], v[1])); });
  }
  for (int s = 1; s < d.n; ++s) {
    uint16_t* ws = reinterpret_cast<uint16_t*>(smem + L.w_off[s]);
    const int cin = d.cin(s), cb_n = up(cin, 16) / 16, no = up(d.cout[s], 8), K = d.k[s], cout = d.cout[s];
    const float* src = raw(s);
    const FastDiv by_no(no), by_cb(cb_n);
    block_items(
        K * cb_n * no * WS_STRIDE / 2,
        [&](int pr, float* v) {
          const int c = 2 * pr % WS_STRIDE, rest = 2 * pr / WS_STRIDE;
          int o, cb;
          const int kcb = by_no.div(rest, o), k = by_cb.div(kcb, cb);
          for (int h = 0; h < 2; ++h) {
            const int cc = cb * 16 + c + h;
            v[h] = c + h < 16 && cc < cin && o < cout ? src[((size_t)o * cin + cc) * K + k] : 0.0f;
          }
        },
        [&](int pr, const float* v) { st32(ws + 2 * pr, pack2(v[0], v[1])); });
  }
}

// acc[e] += the 8 bf16 at p (16-byte aligned)
ENC_FN void add8(float acc[8], const uint16_t* p) {
  uint32_t v[4];
#ifdef __CUDACC__
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
#else
  memcpy(v, p, 16);
#endif
  for (int e = 0; e < 4; ++e) {
    acc[2 * e] += bf16_float((uint16_t)(v[e] & 0xffffu));
    acc[2 * e + 1] += bf16_float((uint16_t)(v[e] >> 16));
  }
}

ENC_FN float relu_bias(float acc, const float* bias, int o, int cout) {
  if (o >= cout) return 0.0f;
  const float v = acc + bias[o];
  return v > 0.0f ? v : 0.0f;
}

// stage 0 of one row into `out` ([w][stride(0)] bf16), warp w of a team of
// ts: each lane a position and 8 output channels, summed from the gather
// table in shift order ('seq') or input-channel order ('charset'); the
// padded channels written as zeros
ENC_FN void conv_first(const EncDims& d, const uint16_t* w1, const float* bias, const int* code, uint16_t* out,
                       int w, int ts) {
  const int K = d.k[0], cp = d.cpad(0), chunks = cp / 8, n = d.wout(0) * chunks, S = d.stride(0);
  const FastDiv by_chunks(chunks);
  for (int base = 32 * w; base < n; base += 32 * ts) {
    ENC_LANES(l) {
      const int i = base + l;
      if (i < n) {
        int oc;
        const int pos = by_chunks.div(i, oc);
        oc *= 8;
        float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        const int zero = d.cin(0) * K;  // the table's zero row
        if (d.seq) {
          for (int k = 0; k < K; ++k) {
            const int c = code[pos + k];
            add8(acc, w1 + (size_t)(c >= 0 && c < d.C ? c * K + k : zero) * cp + oc);
          }
        } else {
          for (int t = 0; t < d.T; ++t) {
            const int k = code[t] - pos;  // a code outside [0, C) gives k outside [0, K)
            add8(acc, w1 + (size_t)(k >= 0 && k < K ? t * K + k : zero) * cp + oc);
          }
        }
        uint16_t* o = out + (size_t)pos * S + oc;
        for (int e = 0; e < 4; ++e)
          st32(o + 2 * e, pack2(relu_bias(acc[2 * e], bias, oc + 2 * e, d.cout[0]),
                                relu_bias(acc[2 * e + 1], bias, oc + 2 * e + 1, d.cout[0])));
      }
    }
  }
}

// stage s >= 1 of one row, `in` (stage s - 1's layout) into `out`, warp w
// of a team of ts, on the tensor cores: a work unit is two m16 tiles of
// positions and two n8 tiles of output channels (four independent sums;
// a missing second tile repeats the first and is not stored), K steps
// over (shift, block of 16 input channels)
ENC_FN void conv_mma(const EncDims& d, int s, const uint16_t* ws, const float* bias, const uint16_t* in,
                     uint16_t* out, int w, int ts) {
  const int K = d.k[s], cb_n = up(d.cin(s), 16) / 16, no = up(d.cout[s], 8), nt = no / 8;
  const int wout = d.wout(s), mt_n = (wout + 15) / 16, S_in = d.stride(s - 1), S_out = d.stride(s);
  const int cout = d.cout[s], units_n = (nt + 1) / 2, units = (mt_n + 1) / 2 * units_n;
  for (int u = w; u < units; u += ts) {
    const int mt = u / units_n * 2, np = u % units_n * 2;
    const bool two_m = mt + 1 < mt_n, two_n = np + 1 < nt;
    PerLane<Acc> acc[2][2];
    ENC_LANES(l) {
      for (int e = 0; e < 4; ++e) acc[0][0][l].v[e] = acc[0][1][l].v[e] = acc[1][0][l].v[e] = acc[1][1][l].v[e] = 0.0f;
    }
    for (int k = 0; k < K; ++k) {
      for (int cb = 0; cb < cb_n; ++cb) {
        // three ldmatrix.x4: the A tiles of both position tiles, the B
        // fragments of both channel tiles (a missing second tile repeats
        // the first, or reads rows past the first: not stored)
        PerLane<FragA> a0, a1, b;
        PerLane<const uint16_t*> ra0, ra1, rb;
        ENC_LANES(l) {
          const uint16_t* p = in + (size_t)(mt * 16 + k + (l & 15)) * S_in + cb * 16 + (l >> 4) * 8;
          ra0[l] = p;
          ra1[l] = two_m ? p + 16 * S_in : p;
          rb[l] = ws + (((size_t)k * cb_n + cb) * no + np * 8 + (l & 7) + (l >> 4) * 8) * WS_STRIDE + ((l >> 3) & 1) * 8;
        }
        warp_ldmatrix_x4(a0, ra0);
        warp_ldmatrix_x4(a1, ra1);
        warp_ldmatrix_x4(b, rb);
        PerLane<FragB> b0, b1;
        ENC_LANES(l) {
          b0[l].r[0] = b[l].r[0];
          b0[l].r[1] = b[l].r[1];
          b1[l].r[0] = b[l].r[2];
          b1[l].r[1] = b[l].r[3];
        }
        // four products whatever the tile counts: an mma.sync under a branch
        // costs the warp a reconvergence each
        warp_mma(acc[0][0], a0, b0);
        warp_mma(acc[0][1], a0, b1);
        warp_mma(acc[1][0], a1, b0);
        warp_mma(acc[1][1], a1, b1);
      }
    }
    ENC_LANES(l) {
      const int g = l >> 2, t = l & 3;
      for (int i = 0; i < 2; ++i) {
        for (int j = 0; j < 2; ++j) {
          if ((i == 1 && !two_m) || (j == 1 && !two_n)) continue;
          const int o = (np + j) * 8 + 2 * t;
          for (int h = 0; h < 2; ++h) {
            const int m = (mt + i) * 16 + g + 8 * h;
            if (m < wout)
              st32(out + (size_t)m * S_out + o, pack2(relu_bias(acc[i][j][l].v[2 * h], bias, o, cout),
                                                      relu_bias(acc[i][j][l].v[2 * h + 1], bias, o + 1, cout)));
          }
        }
      }
    }
  }
}

// The last stage's output ([w][c]) as one row of h3, warp w of a team of
// ts: bf16, channel-major (f = c * W + w), zero from F to Fp; a lane a pair
ENC_FN void flush_row(const EncDims& d, const uint16_t* last, uint16_t* h3row, int w, int ts) {
  const int W = d.wout(d.n - 1), S = d.stride(d.n - 1), F = d.F(), pairs = d.Fp() / 2;
  const FastDiv by_w(W);
  for (int base = 32 * w; base < pairs; base += 32 * ts) {
    ENC_LANES(l) {
      const int f = 2 * (base + l);
      if (f < 2 * pairs) {
        int p0, p1;
        const int c0 = by_w.div(f, p0), c1 = by_w.div(f + 1, p1);
        const uint16_t lo = f < F ? last[(size_t)p0 * S + c0] : (uint16_t)0;
        const uint16_t hi = f + 1 < F ? last[(size_t)p1 * S + c1] : (uint16_t)0;
        st32(h3row + f, (uint32_t)lo | ((uint32_t)hi << 16));
      }
    }
  }
}

// The conv stack of one batch row, by warp `wit` of team `team` of ts
// warps: its codes (`codes`, T of code_kind) into `code_s`, the stages
// through the team's two buffers, the flush into h3row. The staged weights
// lie at smem + L.w_off[s]; bias(s) gives conv s's biases (fp32).
template <typename Bias>
ENC_FN void conv_row(const EncDims& d, const EncLayout& L, const unsigned char* smem, Bias bias,
                     const void* codes, int code_kind, int* code_s, uint16_t* buf0, uint16_t* buf1,
                     uint16_t* h3row, int wit, int team, int ts) {
  FOR_TEAM(w, wit, ts) {
    for (int base = 32 * w; base < d.T; base += 32 * ts) {
      ENC_LANES(l) {
        const int t = base + l;
        if (t < d.T) code_s[t] = load_code(codes, t, code_kind);
      }
    }
  }
  team_sync(team, ts);
  FOR_TEAM(w, wit, ts)
  conv_first(d, reinterpret_cast<const uint16_t*>(smem + L.w_off[0]), bias(0), code_s, buf0, w, ts);
  team_sync(team, ts);
  uint16_t* cur = buf0;
  uint16_t* nxt = buf1;
  for (int s = 1; s < d.n; ++s) {
    FOR_TEAM(w, wit, ts)
    conv_mma(d, s, reinterpret_cast<const uint16_t*>(smem + L.w_off[s]), bias(s), cur, nxt, w, ts);
    team_sync(team, ts);
    uint16_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  FOR_TEAM(w, wit, ts) flush_row(d, cur, h3row, w, ts);
  team_sync(team, ts);  // the buffers are the next row's
}

}  // namespace conv_enc
