// A tensor-core GEMM with fp32 accumulation, in bf16 and in strict fp32,
// and the PTX helpers the persistent GRU recurrences share with it.
//
// C (M, N) = A (M, K) . B (K, N), fp32 sums, operands of type E: bf16 on
// mma.sync.m16n8k16; or fp32 (the strict mode), as 3xTF32 split products
// on mma.sync.m16n8k8.tf32 (fp32_k8 below). Each operand lies in device
// memory in one of two layouts, a template flag each:
//   A_KMAJOR: A[m][k] at a[m * lda + k] (else A[m][k] at a[k * lda + m])
//   B_KMAJOR: B[k][n] at b[n * ldb + k] (else B[k][n] at b[k * ldb + n])
// Leading dimensions are multiples of 16 bytes (8 bf16, 4 fp32) and bases
// 16-byte aligned, so every tile row is copied in 16-byte cp.async chunks; a
// chunk that crosses the ragged edge of M, N or K copies only its valid
// bytes and zero-fills the rest (cp.async's src-size), so padding columns
// are never read. Tiles of 128 x 128 x 32 pass through a 3-stage ring in
// shared memory. bf16 rows are padded by 16 bytes so that ldmatrix reads
// are free of bank conflicts; ldmatrix.trans turns an M- or N-contiguous
// tile into the fragment mma.sync expects. fp32 fragments are read one
// 32-bit word a thread, K-contiguous rows padded by 4 words and M- or
// N-contiguous ones by 8, which keeps those reads free of conflicts too.
// 8 warps, 64 x 32 outputs each.
//
// Epilogues (GemmEpi):
//   EPI_BIAS: C fp32 = acc + bias[n]              the hoisted input gates
//   EPI_OUT:  C = acc, fp32 or bf16 (out_bf16)    the cotangent of the input
//   EPI_DW:   dW (M, N) fp32 = acc, db[m] = the sum over k of A[m][k]:
//             the GEMM runs over N + 1 columns, column N of B being ones
//             (written into shared memory after each tile lands), so the
//             bias sums ride the same contraction.
// Every output is summed by one thread in a fixed order over K: the result
// is deterministic (no atomics). Up to GEMM_MAX_JOBS independent products
// share one launch (blockIdx.z = job). A caller that splits K into parts,
// one job each with its own output, sums the parts in a fixed order with
// sum_parts_kernel, a second pass: deterministic too.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// -- PTX helpers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, the first `bytes` (0..16) copied, the rest
// zeroed. The .cg variant caches in L2 only: data another block wrote
// during this kernel is never read stale from L1.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a . b on one 16 x 8 x 16 tile: bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Bytes of a 16-byte chunk at element `at` of a row of E whose valid
// elements end at `limit`: 16, a partial count, or 0.
template <typename E = __nv_bfloat16>
__device__ __forceinline__ int chunk_bytes(int at, int limit) {
  const int n = limit - at;
  return n >= 16 / (int)sizeof(E) ? 16 : (n > 0 ? (int)sizeof(E) * n : 0);
}

// -- strict fp32 products ----------------------------------------------------
//
// The fp32 kernels (this GEMM's fp32 instance, the persistent recurrence
// and sweep's) multiply as 3xTF32: each fp32 operand x is split on the fly
// into hi = tf32(x) and lo = tf32(x - hi), and lo.hi + hi.lo + hi.hi run on
// mma.sync.m16n8k8.tf32 with fp32 sums. Nothing is rounded to TF32 or bf16
// alone: the dropped lo.lo term lies below fp32's last bit. The tensor core
// truncates as it adds a product into its fp32 accumulator, so a long chain
// of products into one accumulator drifts toward zero by up to an ulp a
// product; the GEMM therefore sums each k-tile apart and adds it to its
// total in fp32 registers (round to nearest), as the FMA pipes would.
// (probes/stack_probe.py --steps times this form against FFMA, the cvt
// split and the GEMM without that flush, and measures each one's error.)

// hi: x rounded to TF32, to nearest with ties away from zero (the rounding
// of cvt.rna.tf32.f32, here on the integer pipe: cvt is the slower path);
// lo = x - hi, exact in fp32, of which the tensor core reads the TF32 part
// (its top 19 bits)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a . b on one 16 x 8 x 8 tile: tf32 operands, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[i][j] + corr[i][j] += A (16 MT x 8) . B (8 x 8 NT) of fp32 operands
// read as a(m, k) and b(k, n), in the accumulator layout of mma.sync:
// element e of tile (i, j) is (row 16 i + lane / 4 + 8 (e / 2), column 8 j +
// 2 (lane % 4) + e % 2), so the epilogues and the gate math read the same
// registers in bf16 and fp32. hi.hi sums into acc and the cross terms into
// corr: two chains of dependent products where the caller keeps corr apart
// (and adds it to acc at the end), one where it passes acc twice.
template <int MT, int NT, typename AF, typename BF>
__device__ __forceinline__ void fp32_k8(float (&acc)[MT][NT][4], float (&corr)[MT][NT][4], AF a, BF b,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split_tf32(b(t, 8 * j + g), bh[j][0], bl[j][0]);
    split_tf32(b(t + 4, 8 * j + g), bh[j][1], bl[j][1]);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) split_tf32(a(16 * i + g + 8 * (r & 1), t + 4 * (r >> 1)), ah[r], al[r]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mma_tf32(corr[i][j], al, bh[j]);
      mma_tf32(corr[i][j], ah, bl[j]);
      mma_tf32(acc[i][j], ah, bh[j]);
    }
  }
}

// -- the GEMM ----------------------------------------------------------------

enum GemmEpi { EPI_BIAS = 0, EPI_OUT = 1, EPI_DW = 2 };

// One product. For B in (K, N) layout (!B_KMAJOR), rows k < b_nfirst come
// from b_first (ld ldb) and rows k >= b_nfirst from b[k - b_nfirst]: the
// GRU's "h one step behind" with h0 as its first rows.
struct GemmJob {
  const void* a;
  const void* b;
  const void* b_first;
  void* c;            // (M, N), ldc
  float* bias;        // EPI_BIAS: bias (N); EPI_DW: db (M)
  int M, N, K;        // N excludes EPI_DW's column of ones
  int lda, ldb, ldc;
  int b_nfirst;
  int out_bf16;       // EPI_OUT: store bf16 (bf16 operands only)
};

constexpr int GEMM_MAX_JOBS = 16;

struct GemmJobs {
  GemmJob job[GEMM_MAX_JOBS];
};

constexpr int GBM = 128, GBN = 128, GBK = 32, GSTAGES = 3, GTHREADS = 256;
constexpr int GPAD = 8;  // elements of padding per shared-memory row

// elements of padding per shared-memory row of a tile of E
template <bool KMAJOR, typename E>
__host__ __device__ constexpr int gpad() {
  return sizeof(E) == 2 ? GPAD : (KMAJOR ? 4 : 8);
}

// shared-memory elements of one stage of an operand tile
template <bool KMAJOR, typename E = __nv_bfloat16>
__host__ __device__ constexpr int tile_elems(int rows) {
  return KMAJOR ? rows * (GBK + gpad<KMAJOR, E>()) : GBK * (rows + gpad<KMAJOR, E>());
}

template <typename E = __nv_bfloat16>
constexpr size_t gemm_smem_bytes() {
  if constexpr (sizeof(E) == 2)
    return (size_t)GSTAGES * (tile_elems<true>(GBM) + tile_elems<true>(GBN)) *
           sizeof(__nv_bfloat16);
  else  // the larger of the two layouts, for either operand
    return (size_t)GSTAGES * 2 * tile_elems<true, E>(GBM) * sizeof(E);
}

// Copy one BK-deep tile of an operand into shared memory. `rows` is the
// tile's extent along M (or N) from `r0`, valid below `rlim`; k from k0,
// valid below klim.
template <bool KMAJOR, typename E = __nv_bfloat16>
__device__ __forceinline__ void load_tile(E* s, const E* g, const E* g_first, int nfirst, int ld,
                                          int r0, int rlim, int k0, int klim, int tid) {
  constexpr int EPC = 16 / sizeof(E);  // elements per 16-byte chunk
  if constexpr (KMAJOR) {  // GBM rows of GBK: 4 (bf16) or 8 (fp32) chunks a row
    constexpr int CH = GBK / EPC;
#pragma unroll
    for (int i = 0; i < GBM * CH / GTHREADS; ++i) {
      const int c = tid + i * GTHREADS;
      const int row = c / CH, kc = (c % CH) * EPC;
      const int r = r0 + row, k = k0 + kc;
      const int bytes = r < rlim ? chunk_bytes<E>(k, klim) : 0;
      const E* src = bytes ? g + (size_t)r * ld + k : g;
      cp_async16(s + row * (GBK + gpad<KMAJOR, E>()) + kc, src, bytes);
    }
  } else {  // GBK rows (k) of GBM: 16 (bf16) or 32 (fp32) chunks a row
    constexpr int CH = GBM / EPC;
#pragma unroll
    for (int i = 0; i < GBK * CH / GTHREADS; ++i) {
      const int c = tid + i * GTHREADS;
      const int row = c / CH, mc = (c % CH) * EPC;
      const int k = k0 + row, r = r0 + mc;
      const int bytes = k < klim ? chunk_bytes<E>(r, rlim) : 0;
      const E* src = g;
      if (bytes) src = k < nfirst ? g_first + (size_t)k * ld + r : g + (size_t)(k - nfirst) * ld + r;
      cp_async16(s + row * (GBM + gpad<KMAJOR, E>()) + mc, src, bytes);
    }
  }
}

// Element (r, k) of an fp32 operand tile in shared memory, r along M (or N)
template <bool KMAJOR>
__device__ __forceinline__ float tile_at(const float* s, int r, int k) {
  return KMAJOR ? s[r * (GBK + gpad<true, float>()) + k] : s[k * (GBM + gpad<false, float>()) + r];
}

// A fragment of the 16 x 16 tile at (m, kk) of an A tile in shared memory
template <bool KMAJOR>
__device__ __forceinline__ void frag_a(uint32_t a[4], const __nv_bfloat16* s, int m, int kk,
                                       int lane) {
  if constexpr (KMAJOR) {
    ldmatrix_x4(a, s + (m + (lane & 15)) * (GBK + GPAD) + kk + (lane >> 4) * 8);
  } else {
    const int j = lane >> 3, i = lane & 7;
    ldmatrix_x4_trans(a, s + (kk + i + (j >> 1) * 8) * (GBM + GPAD) + m + (j & 1) * 8);
  }
}

// B fragments of two 8-column tiles at (kk, n) and (kk, n + 8): b[0..1],
// b[2..3]
template <bool KMAJOR>
__device__ __forceinline__ void frag_b2(uint32_t b[4], const __nv_bfloat16* s, int n, int kk,
                                        int lane) {
  const int j = lane >> 3, i = lane & 7;
  if constexpr (KMAJOR) {
    ldmatrix_x4(b, s + (n + i + (j >> 1) * 8) * (GBK + GPAD) + kk + (j & 1) * 8);
  } else {
    ldmatrix_x4_trans(b, s + (kk + i + (j & 1) * 8) * (GBN + GPAD) + n + (j >> 1) * 8);
  }
}

template <bool A_KMAJOR, bool B_KMAJOR, int EPI, typename E = __nv_bfloat16>
__global__ void __launch_bounds__(GTHREADS)
gemm_kernel(GemmJobs jobs) {
  const GemmJob& jb = jobs.job[blockIdx.z];
  const int Nc = EPI == EPI_DW ? jb.N + 1 : jb.N;  // columns of the product
  const int tiles_n = (Nc + GBN - 1) / GBN;
  const int tiles_m = (jb.M + GBM - 1) / GBM;
  if ((int)blockIdx.x >= tiles_m * tiles_n) return;
  const int m0 = (blockIdx.x / tiles_n) * GBM;
  const int n0 = (blockIdx.x % tiles_n) * GBN;

  extern __shared__ __align__(16) unsigned char gsmem[];
  constexpr int A_ST = tile_elems<A_KMAJOR, E>(GBM), B_ST = tile_elems<B_KMAJOR, E>(GBN);
  E* sA = reinterpret_cast<E*>(gsmem);
  E* sB = sA + GSTAGES * A_ST;
  const E* ga = static_cast<const E*>(jb.a);
  const E* gb = static_cast<const E*>(jb.b);
  const E* gbf = static_cast<const E*>(jb.b_first);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int KT = (jb.K + GBK - 1) / GBK;
  auto issue = [&](int kt) {
    if (kt < KT) {
      const int st = kt % GSTAGES;
      load_tile<A_KMAJOR, E>(sA + st * A_ST, ga, ga, 0, jb.lda, m0, jb.M, kt * GBK, jb.K, tid);
      load_tile<B_KMAJOR, E>(sB + st * B_ST, gb, gbf, jb.b_nfirst, jb.ldb, n0, jb.N, kt * GBK,
                             jb.K, tid);
    }
    cp_async_commit();  // empty groups keep the count uniform
  };
#pragma unroll
  for (int s = 0; s < GSTAGES - 1; ++s) issue(s);

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<GSTAGES - 2>();
    const int st = kt % GSTAGES;
    if constexpr (EPI == EPI_DW) {
      // column N of B is ones: written by the thread that copied its chunk,
      // after that copy landed, for the rows k < K
      static_assert(!B_KMAJOR, "the column of ones needs B in (K, N) layout");
      const int cn = jb.N - n0;
      if (cn >= 0 && cn < GBN) {
        constexpr int EPC = 16 / sizeof(E);
        constexpr int CH = GBN / EPC;
#pragma unroll
        for (int i = 0; i < GBK * CH / GTHREADS; ++i) {
          const int c = tid + i * GTHREADS;
          const int row = c / CH;
          if ((c % CH) == cn / EPC && kt * GBK + row < jb.K)
            sB[st * B_ST + row * (GBN + gpad<false, E>()) + cn] = from_f<E>(1.0f);
        }
      }
    }
    __syncthreads();
    issue(kt + GSTAGES - 1);
    const E* a_s = sA + st * A_ST;
    const E* b_s = sB + st * B_ST;
    if constexpr (sizeof(E) == 2) {
#pragma unroll
      for (int kk = 0; kk < GBK; kk += 16) {
        uint32_t af[4][4], bfr[2][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) frag_a<A_KMAJOR>(af[mi], a_s, wm + mi * 16, kk, lane);
#pragma unroll
        for (int np = 0; np < 2; ++np) frag_b2<B_KMAJOR>(bfr[np], b_s, wn + np * 16, kk, lane);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], &bfr[ni >> 1][(ni & 1) * 2]);
      }
    } else {  // the k-tile sums apart, then adds to acc in fp32 (see fp32_k8)
      float part[4][4][4] = {};
#pragma unroll
      for (int kk = 0; kk < GBK; kk += 8)
        fp32_k8(part, part, [&](int m, int k) { return tile_at<A_KMAJOR>(a_s, wm + m, kk + k); },
                [&](int k, int n) { return tile_at<B_KMAJOR>(b_s, wn + n, kk + k); }, lane);
#pragma unroll
      for (int i = 0; i < 64; ++i) (&acc[0][0][0])[i] += (&part[0][0][0])[i];
    }
  }
  cp_async_wait<0>();

  // epilogue: acc[mi][ni][e] is (m, n) = (row + 8 (e >> 1), col + (e & 1))
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + mi * 16 + (lane >> 2) + (e >> 1) * 8;
        const int n = n0 + wn + ni * 8 + (lane & 3) * 2 + (e & 1);
        if (m >= jb.M) continue;
        const float v = acc[mi][ni][e];
        if constexpr (EPI == EPI_BIAS) {
          if (n < jb.N) static_cast<float*>(jb.c)[(size_t)m * jb.ldc + n] = v + jb.bias[n];
        } else if constexpr (EPI == EPI_OUT) {
          if (n < jb.N) {
            if (sizeof(E) == 2 && jb.out_bf16)
              static_cast<__nv_bfloat16*>(jb.c)[(size_t)m * jb.ldc + n] = __float2bfloat16_rn(v);
            else
              static_cast<float*>(jb.c)[(size_t)m * jb.ldc + n] = v;
          }
        } else {
          if (n < jb.N)
            static_cast<float*>(jb.c)[(size_t)m * jb.ldc + n] = v;
          else if (n == jb.N)
            jb.bias[m] = v;
        }
      }
    }
  }
}

// out[i] = parts[0][i] + parts[1][i] + ... + parts[k-1][i], in that order:
// the second pass of a product whose K was split into k parts of n outputs.
__global__ void sum_parts_kernel(const float* __restrict__ parts, int k, long long n,
                                 float* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = parts[i];
    for (int p = 1; p < k; ++p) s += parts[(size_t)p * n + i];
    out[i] = s;
  }
}

// Launch n jobs of one product kind in one grid.
template <bool A_KMAJOR, bool B_KMAJOR, int EPI, typename E = __nv_bfloat16>
cudaError_t launch_gemm(const GemmJobs& jobs, int n, cudaStream_t stream) {
  if (n <= 0 || n > GEMM_MAX_JOBS) return cudaErrorInvalidValue;
  constexpr int EPC = 16 / sizeof(E);
  int max_tiles = 0;
  for (int i = 0; i < n; ++i) {
    const GemmJob& j = jobs.job[i];
    if (j.M <= 0 || j.N <= 0 || j.K <= 0 || j.lda % EPC || j.ldb % EPC) return cudaErrorInvalidValue;
    const int Nc = EPI == EPI_DW ? j.N + 1 : j.N;
    const int tiles = ((j.M + GBM - 1) / GBM) * ((Nc + GBN - 1) / GBN);
    if (tiles > max_tiles) max_tiles = tiles;
  }
  auto kernel = gemm_kernel<A_KMAJOR, B_KMAJOR, EPI, E>;
  const size_t smem = gemm_smem_bytes<E>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(max_tiles, 1, n), GTHREADS, smem, stream>>>(jobs);
  return cudaGetLastError();
}

}  // namespace
