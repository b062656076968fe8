// Fused stacked-GRU recurrence for training: forward, reverse sweep, dW.
//
// Replaces molvax/kernels/gru_stack.py::gru_stack_scan, the Pallas TPU
// kernel pair _fused_fwd_kernel (forward) and _fused_bwd_kernel (backward),
// and computes what they compute, with the same rounding points:
//
// forward, per time step t, layer l, batch row b (torch gate order r|z|n):
//   gi  = x_l @ W_ih_l + b_ih_l        x_0 = bf16 x0[t], x_l = hseq[l-1][t]
//   gh  = bf16(h_l) @ W_hh_l + b_hh_l
//   r = sigmoid(gi_r + gh_r), z = sigmoid(gi_z + gh_z), n = tanh(gi_n + r gh_n)
//   h_l = (1 - z) n + z h_l            fp32 carry
//   stores hseq = bf16(h_l), rzn = bf16(r|z|n), ghn = bf16(gh_n)
// backward, t = T-1 .. 0 and l = L-1 .. 0 inside each step:
//   dout = dh_l + (l == L-1 ? dY[t] : dx staged by layer l+1 at t)
//   dz = dout (hprev - n) z (1 - z), dn = dout (1 - z)(1 - n^2),
//   dr = dn gh_n r (1 - r)
//   dgi = bf16(dr | dz | dn), dgh = bf16(dr | dz | dn r)
//   dh_l = dout z + dgh @ W_hh_l^T
//   dx staged for layer l-1 = dgi @ W_ih_l^T (fp32); dx0 = bf16(dgi @ W_ih0^T)
// dW (a third kernel, gru_dw_kernel of common.cuh, over the dgi / dgh the
// sweep wrote):
//   dW_hh_l = sum_{t,b} dgh^T hprev, dW_ih_l = sum dgi^T x_l, db = sum dgi|dgh
// with hprev = hseq[l][t-1] (bf16(h0) at t = 0). Products take bf16
// operands and accumulate in fp32, as in the TPU kernels. Rows are
// independent, so each block runs time outer, layers inner for its rows:
// the same math as the TPU's layer-sequential order.
//
// Design. The recurrent kernels follow csrc/generate.cu: a block owns RB
// batch rows, thread j owns hidden unit j (and j + THREADS, ...), carries
// are fp32 in shared memory and the bf16 operand copies row-interleaved.
// The forward reads weights in (in, 3H) layout and the backward in torch's
// (3H, in) layout (the transposed copies of the TPU wrapper), so that a
// warp always reads 32 neighbouring columns of one weight row. The sweep
// writes dgi / dgh (bf16, 2 x L*T*B*3H) to device memory, and the dW kernel
// contracts them with the inputs in 64 x 64 output tiles, each output
// summed in a fixed order by one thread: deterministic, no atomics. The
// bias sums ride the same contraction as a column of ones.
//
// What bounds it on an H100. Forward and sweep re-read every weight of the
// stack each step from L2 (~10 MB bf16 at zinc250k width, 3 x GRU-501 with
// a 329-wide layer-0 input), ~2 bytes per 2*RB FLOPs, with products on the
// fp32 FMA pipes: per-block instruction issue, not bandwidth, sets the
// step time (PERF.md, PR 1). The dW contraction is ~280 GFLOP of fp32 FMA
// at B=256: bound by FMA issue from shared memory. Tensor cores (mma /
// wgmma) and weight residency across a cluster are work for later.

#include "common.cuh"

namespace {

constexpr int THREADS = 512;  // one hidden unit per thread at H <= 512

// shared memory: h32 fp32 [L][RB][H], hb bf16 [2][L][H][RB], xb bf16 [I0][RB]
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
                     __nv_bfloat16* __restrict__ rzn,         // (L, T, B, 3H)
                     __nv_bfloat16* __restrict__ ghn,         // (L, T, B, H)
                     int T, int B, int I0, int H, int L) {
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
        gate_products(x_in, w_in, K, H, j, gi);
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
            rzn[o * G + j] = __float2bfloat16_rn(rg);
            rzn[o * G + H + j] = __float2bfloat16_rn(zg);
            rzn[o * G + 2 * H + j] = __float2bfloat16_rn(n);
            ghn[o * H + j] = __float2bfloat16_rn(gn);
          }
        }
        store_rows(h_new, j, hv);
      }
      __syncthreads();  // layer l's new h is the next layer's input
    }
  }
}

// shared memory: dh32 fp32 [L][RB][H], dxs fp32 [RB][H],
//                sgi bf16 [3H][RB], sgh bf16 [3H][RB]
__global__ void __launch_bounds__(THREADS)
gru_stack_bwd_kernel(const __nv_bfloat16* __restrict__ hseq,  // (L, T, B, H)
                     const __nv_bfloat16* __restrict__ h0b,   // (L, B, H)
                     const __nv_bfloat16* __restrict__ rzn,   // (L, T, B, 3H)
                     const __nv_bfloat16* __restrict__ ghn,   // (L, T, B, H)
                     const float* __restrict__ dY,            // (T, B, H)
                     const float* __restrict__ dhf,           // (L, B, H)
                     const __nv_bfloat16* __restrict__ wih0,  // (3H, I0)
                     const __nv_bfloat16* __restrict__ wih,   // (L-1, 3H, H)
                     const __nv_bfloat16* __restrict__ whh,   // (L, 3H, H)
                     __nv_bfloat16* __restrict__ dx0,         // (T, B, I0)
                     float* __restrict__ dh0,                 // (L, B, H)
                     __nv_bfloat16* __restrict__ dgi,         // (L, T, B, 3H)
                     __nv_bfloat16* __restrict__ dgh,         // (L, T, B, 3H)
                     int T, int B, int I0, int H, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t G = 3 * (size_t)H;
  float* dh32 = reinterpret_cast<float*>(smem);
  float* dxs = dh32 + (size_t)L * RB * H;
  __nv_bfloat16* sgi = reinterpret_cast<__nv_bfloat16*>(dxs + (size_t)RB * H);
  __nv_bfloat16* sgh = sgi + G * RB;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * RB;

  for (int i = tid; i < L * RB * H; i += THREADS) {
    const int l = i / (RB * H), r = (i / H) % RB, j = i % H;
    const int row = row0 + r;
    dh32[i] = row < B ? dhf[((size_t)l * B + row) * H + j] : 0.0f;
  }
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    for (int l = L - 1; l >= 0; --l) {
      float* dh_l = dh32 + (size_t)l * RB * H;
      // phase 1: the gate cotangents of unit j, from the stored residuals
      for (int j = tid; j < H; j += THREADS) {
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const int row = row0 + r;
          float rg = 0.0f, zg = 0.0f, n = 0.0f, gn = 0.0f, hp = 0.0f, ext = 0.0f;
          if (row < B) {
            const size_t o = ((size_t)l * T + t) * B + row;
            rg = __bfloat162float(rzn[o * G + j]);
            zg = __bfloat162float(rzn[o * G + H + j]);
            n = __bfloat162float(rzn[o * G + 2 * H + j]);
            gn = __bfloat162float(ghn[o * H + j]);
            hp = __bfloat162float(t > 0 ? hseq[(o - B) * H + j]
                                        : h0b[((size_t)l * B + row) * H + j]);
            ext = l == L - 1 ? dY[((size_t)t * B + row) * H + j] : dxs[r * H + j];
          }
          const float dout = dh_l[r * H + j] + ext;
          const float dz = dout * (hp - n) * zg * (1.0f - zg);
          const float dn = dout * (1.0f - zg) * (1.0f - n * n);
          const float dghn = dn * rg;
          const float dr = dn * gn * rg * (1.0f - rg);
          const __nv_bfloat16 b_r = __float2bfloat16_rn(dr);
          const __nv_bfloat16 b_z = __float2bfloat16_rn(dz);
          const __nv_bfloat16 b_n = __float2bfloat16_rn(dn);
          const __nv_bfloat16 b_hn = __float2bfloat16_rn(dghn);
          sgi[(size_t)j * RB + r] = b_r;
          sgi[((size_t)H + j) * RB + r] = b_z;
          sgi[((size_t)2 * H + j) * RB + r] = b_n;
          sgh[(size_t)j * RB + r] = b_r;
          sgh[((size_t)H + j) * RB + r] = b_z;
          sgh[((size_t)2 * H + j) * RB + r] = b_hn;
          if (row < B) {
            const size_t o = (((size_t)l * T + t) * B + row) * G;
            dgi[o + j] = b_r;
            dgi[o + H + j] = b_z;
            dgi[o + 2 * H + j] = b_n;
            dgh[o + j] = b_r;
            dgh[o + H + j] = b_z;
            dgh[o + 2 * H + j] = b_hn;
          }
          dh_l[r * H + j] = dout * zg;  // the product below adds to it
        }
      }
      __syncthreads();

      // phase 2: dh_l += dgh @ W_hh^T, and the cotangent of the layer below
      const __nv_bfloat16* w_h = whh + (size_t)l * G * H;
      for (int k = tid; k < H; k += THREADS) {
        float acc[RB] = {0.0f, 0.0f, 0.0f, 0.0f};
        column_product(sgh, w_h, (int)G, H, k, acc);
#pragma unroll
        for (int r = 0; r < RB; ++r) dh_l[r * H + k] += acc[r];
        if (l > 0) {
          float dx[RB] = {0.0f, 0.0f, 0.0f, 0.0f};
          column_product(sgi, wih + (size_t)(l - 1) * G * H, (int)G, H, k, dx);
#pragma unroll
          for (int r = 0; r < RB; ++r) dxs[r * H + k] = dx[r];
        }
      }
      if (l == 0) {
        for (int i = tid; i < I0; i += THREADS) {
          float dx[RB] = {0.0f, 0.0f, 0.0f, 0.0f};
          column_product(sgi, wih0, (int)G, I0, i, dx);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const int row = row0 + r;
            if (row < B) dx0[((size_t)t * B + row) * I0 + i] = __float2bfloat16_rn(dx[r]);
          }
        }
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < L * RB * H; i += THREADS) {
    const int l = i / (RB * H), r = (i / H) % RB, j = i % H;
    const int row = row0 + r;
    if (row < B) dh0[((size_t)l * B + row) * H + j] = dh32[i];
  }
}

size_t fwd_smem(int I0, int H, int L) {
  return (size_t)L * RB * H * sizeof(float) +
         (size_t)2 * L * H * RB * sizeof(__nv_bfloat16) +
         (size_t)I0 * RB * sizeof(__nv_bfloat16);
}

size_t bwd_smem(int H, int L) {
  return (size_t)L * RB * H * sizeof(float) + (size_t)RB * H * sizeof(float) +
         (size_t)2 * 3 * H * RB * sizeof(__nv_bfloat16);
}

bool bad_shape(int T, int B, int I0, int H, int L) {
  return T <= 0 || B <= 0 || I0 <= 0 || H <= 0 || L < 2 || 2 * L > MAX_JOBS;
}

}  // namespace

// Each entry point launches on `stream` and returns the launch's
// cudaError_t (0 = success).
extern "C" int molvax_gru_stack_fwd(const void* x0, const void* wih0, const float* bih0,
                                    const void* wih, const float* bih, const void* whh,
                                    const float* bhh, const float* h0, void* hseq,
                                    void* rzn, void* ghn, int T, int B, int I0, int H,
                                    int L, void* stream) {
  if (bad_shape(T, B, I0, H, L)) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(I0, H, L);
  cudaError_t err = cudaFuncSetAttribute(
      gru_stack_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  typedef const __nv_bfloat16* cbf;
  gru_stack_fwd_kernel<<<(B + RB - 1) / RB, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<cbf>(x0), static_cast<cbf>(wih0), bih0, static_cast<cbf>(wih), bih,
      static_cast<cbf>(whh), bhh, h0, static_cast<__nv_bfloat16*>(hseq),
      static_cast<__nv_bfloat16*>(rzn), static_cast<__nv_bfloat16*>(ghn), T, B, I0, H, L);
  return (int)cudaGetLastError();
}

extern "C" int molvax_gru_stack_bwd(const void* hseq, const void* h0b, const void* rzn,
                                    const void* ghn, const float* dY, const float* dhf,
                                    const void* wih0, const void* wih, const void* whh,
                                    void* dx0, float* dh0, void* dgi, void* dgh, int T,
                                    int B, int I0, int H, int L, void* stream) {
  if (bad_shape(T, B, I0, H, L)) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(H, L);
  cudaError_t err = cudaFuncSetAttribute(
      gru_stack_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  typedef const __nv_bfloat16* cbf;
  gru_stack_bwd_kernel<<<(B + RB - 1) / RB, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<cbf>(hseq), static_cast<cbf>(h0b), static_cast<cbf>(rzn),
      static_cast<cbf>(ghn), dY, dhf, static_cast<cbf>(wih0), static_cast<cbf>(wih),
      static_cast<cbf>(whh), static_cast<__nv_bfloat16*>(dx0), dh0,
      static_cast<__nv_bfloat16*>(dgi), static_cast<__nv_bfloat16*>(dgh), T, B, I0, H, L);
  return (int)cudaGetLastError();
}

extern "C" int molvax_gru_stack_dw(const void* x0, const void* h0b, const void* hseq,
                                   const void* dgi, const void* dgh, float* dwih0,
                                   float* dbih0, float* dwih, float* dbih, float* dwhh,
                                   float* dbhh, int T, int B, int I0, int H, int L,
                                   void* stream) {
  if (bad_shape(T, B, I0, H, L)) return (int)cudaErrorInvalidValue;
  typedef const __nv_bfloat16* cbf;
  const size_t G = 3 * (size_t)H, TB = (size_t)T * B;
  cbf x0_ = static_cast<cbf>(x0);
  cbf h0b_ = static_cast<cbf>(h0b);
  cbf hseq_ = static_cast<cbf>(hseq);
  cbf dgi_ = static_cast<cbf>(dgi);
  cbf dgh_ = static_cast<cbf>(dgh);
  typedef DwJob<__nv_bfloat16> Job;
  DwJobs<__nv_bfloat16> jobs;
  int n = 0;
  for (int l = 0; l < L; ++l) {
    // W_hh_l: hprev = bf16(h0) for the first B rows, then hseq[l] one step behind
    jobs.job[n++] = Job{dgh_ + l * TB * G, hseq_ + l * TB * H, h0b_ + (size_t)l * B * H,
                        dwhh + l * G * H, dbhh + l * G, H, B};
    if (l == 0) {
      jobs.job[n++] = Job{dgi_, x0_, x0_, dwih0, dbih0, I0, 0};
    } else {
      jobs.job[n++] = Job{dgi_ + l * TB * G, hseq_ + (l - 1) * TB * H,
                          hseq_ + (l - 1) * TB * H, dwih + (l - 1) * G * H,
                          dbih + (l - 1) * G, H, 0};
    }
  }
  return (int)launch_dw(jobs, n, (int)TB, (int)G, static_cast<cudaStream_t>(stream));
}
