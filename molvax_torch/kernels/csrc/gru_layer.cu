// One GRU layer's recurrence for training: forward, reverse sweep, dW.
//
// Replaces the per-layer Pallas TPU kernels of molvax/kernels/gru.py and
// computes what they compute, with the same rounding points:
//   gru_layer_scan_x (_fwd_kernel_x, _bwd_kernel_x): the input gates are
//     computed in the kernel from x; operand and storage type S is bf16, or
//     fp32 in the strict-fp32 mode (matmul_dtype='float32');
//   gru_layer_scan (_fwd_kernel, _bwd_kernel): the input gates gi are read
//     from device memory, rounded to bf16 at the boundary; bf16 only.
//
// forward, per step t and batch row b (torch gate order r|z|n):
//   gi  = x[t] @ W_ih + b_ih            S operands, fp32 sum, never stored
//         (gru_layer_scan: fp32(gi[t]) of the bf16 input)
//   gh  = S(h) @ W_hh + b_hh
//   r = sigmoid(gi_r + gh_r), z = sigmoid(gi_z + gh_z), n = tanh(gi_n + r gh_n)
//   h = (1 - z) n + z h                 fp32 carry
//   stores hseq = S(h), rzn = S(r|z|n), ghn = S(gh_n)
// backward, t = T-1 .. 0 (dY[t] is the cotangent of hseq[t]):
//   dout = dh + dY[t]
//   dz = dout (hprev - n) z (1 - z), dn = dout (1 - z)(1 - n^2),
//   dr = dn gh_n r (1 - r)
//   dgi = S(dr | dz | dn), dgh = S(dr | dz | dn r)
//   dh = dout z + dgh @ W_hh^T,  dx[t] = S(dgi @ W_ih^T)   (scan_x only)
// dW (gru_dw_kernel of common.cuh, over the dgi / dgh the sweep wrote):
//   dW_hh = sum_{t,b} hprev^T dgh, dW_ih = sum x^T dgi, db = sum dgi | dgh
// with hprev = hseq[t-1] (S(h0) at t = 0). Every product accumulates in
// fp32; in the fp32 mode every operand is fp32 and the products run on the
// FMA pipes in full fp32 (no TF32, no bf16 anywhere).
//
// Design. The structure of csrc/gru_stack.cu with one layer: a block owns
// RB batch rows, thread j owns hidden unit j (and j + THREADS, ...), the h
// carry is fp32 in shared memory and its S copy row-interleaved ([k][RB],
// double-buffered by step parity), and x[t] is staged the same way. The
// forward reads weights in (in, 3H) layout and the sweep in torch's
// (3H, in) layout, so a warp always reads 32 neighbouring columns of one
// weight row. The TPU kernel accumulates dW in VMEM across its sequential
// grid; on the H100 blocks run in parallel with nothing carried between
// them, so the sweep writes dgi / dgh to device memory and a second,
// deterministic contraction kernel sums them. The TPU's per-gate padding of
// H to 128 has no counterpart: any H, I and B are taken.
//
// What bounds it on an H100. Each step of a block re-reads both weight
// matrices from L2 (~2.5 MB bf16 per layer at zinc250k width, I = 329 or
// 501, H = 501; twice that in fp32), ~2 or 4 bytes per 2*RB FLOPs on the
// fp32 FMA pipes: per-block instruction issue sets the step time, as for
// the stack kernels (PERF.md). The contraction is fp32 FMA from shared
// memory. Tensor cores and weight residency are later work.

#include "common.cuh"

namespace {

constexpr int THREADS = 512;  // one hidden unit per thread at H <= 512
constexpr size_t MAX_SMEM = 232448;  // an H100 block's dynamic shared memory

// shared memory: h32 fp32 [RB][H], hb S [2][H][RB], xb S [I][RB] (!HOISTED)
template <typename S, bool HOISTED>
__global__ void __launch_bounds__(THREADS)
gru_layer_fwd_kernel(const S* __restrict__ x,               // (T, B, I)
                     const __nv_bfloat16* __restrict__ gi,  // (T, B, 3H), HOISTED
                     const S* __restrict__ wih,             // (I, 3H)
                     const float* __restrict__ bih,         // (3H)
                     const S* __restrict__ whh,             // (H, 3H)
                     const float* __restrict__ bhh,         // (3H)
                     const float* __restrict__ h0,          // (B, H)
                     S* __restrict__ hseq,                  // (T, B, H)
                     S* __restrict__ rzn,                   // (T, B, 3H)
                     S* __restrict__ ghn,                   // (T, B, H)
                     int T, int B, int I, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t G = 3 * (size_t)H;
  float* h32 = reinterpret_cast<float*>(smem);
  S* hb = reinterpret_cast<S*>(h32 + (size_t)RB * H);
  S* xb = hb + (size_t)2 * H * RB;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * RB;

  // rows past B run on zeros and store nothing
  for (int i = tid; i < RB * H; i += THREADS) {
    const int r = i / H, j = i % H;
    const int row = row0 + r;
    const float v = row < B ? h0[(size_t)row * H + j] : 0.0f;
    h32[i] = v;
    hb[(size_t)j * RB + r] = from_f<S>(v);  // step parity 0
  }

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    if (!HOISTED) {
      for (int i = tid; i < RB * I; i += THREADS) {
        const int r = i / I, k = i % I;
        const int row = row0 + r;
        xb[(size_t)k * RB + r] = row < B ? x[((size_t)t * B + row) * I + k] : from_f<S>(0.0f);
      }
    }
    __syncthreads();
    const S* h_old = hb + (size_t)cur * H * RB;
    S* h_new = hb + (size_t)nxt * H * RB;

    for (int j = tid; j < H; j += THREADS) {
      float ig[3][RB], gh[3][RB];
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int r = 0; r < RB; ++r) ig[g][r] = gh[g][r] = 0.0f;
      if (HOISTED) {
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const int row = row0 + r;
          if (row < B) {
            const __nv_bfloat16* gr = gi + ((size_t)t * B + row) * G + j;
            ig[0][r] = __bfloat162float(gr[0]);
            ig[1][r] = __bfloat162float(gr[H]);
            ig[2][r] = __bfloat162float(gr[2 * H]);
          }
        }
      } else {
        gate_products(xb, wih, I, H, j, ig);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          ig[0][r] += bih[j];
          ig[1][r] += bih[H + j];
          ig[2][r] += bih[2 * H + j];
        }
      }
      gate_products(h_old, whh, H, H, j, gh);
      float hv[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float rg = sigmoid_f(ig[0][r] + (gh[0][r] + bhh[j]));
        const float zg = sigmoid_f(ig[1][r] + (gh[1][r] + bhh[H + j]));
        const float gn = gh[2][r] + bhh[2 * H + j];
        const float n = tanhf(ig[2][r] + rg * gn);
        const float h = (1.0f - zg) * n + zg * h32[r * H + j];
        h32[r * H + j] = h;  // only this thread touches unit j's carry
        hv[r] = h;
        const int row = row0 + r;
        if (row < B) {
          const size_t o = (size_t)t * B + row;
          hseq[o * H + j] = from_f<S>(h);
          rzn[o * G + j] = from_f<S>(rg);
          rzn[o * G + H + j] = from_f<S>(zg);
          rzn[o * G + 2 * H + j] = from_f<S>(n);
          ghn[o * H + j] = from_f<S>(gn);
        }
      }
      store_rows(h_new, j, hv);
    }
    __syncthreads();  // this step's h is the next step's operand
  }
}

// shared memory: dh32 fp32 [RB][H], sgi S [3H][RB], sgh S [3H][RB]
template <typename S, bool WITH_DX>
__global__ void __launch_bounds__(THREADS)
gru_layer_bwd_kernel(const S* __restrict__ hseq,   // (T, B, H)
                     const S* __restrict__ h0s,    // (B, H), h0 rounded to S
                     const S* __restrict__ rzn,    // (T, B, 3H)
                     const S* __restrict__ ghn,    // (T, B, H)
                     const float* __restrict__ dY, // (T, B, H)
                     const S* __restrict__ wih,    // (3H, I), WITH_DX
                     const S* __restrict__ whh,    // (3H, H)
                     S* __restrict__ dx,           // (T, B, I), WITH_DX
                     float* __restrict__ dh0,      // (B, H)
                     S* __restrict__ dgi,          // (T, B, 3H)
                     S* __restrict__ dgh,          // (T, B, 3H)
                     int T, int B, int I, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t G = 3 * (size_t)H;
  float* dh32 = reinterpret_cast<float*>(smem);
  S* sgi = reinterpret_cast<S*>(dh32 + (size_t)RB * H);
  S* sgh = sgi + G * RB;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * RB;

  for (int i = tid; i < RB * H; i += THREADS) dh32[i] = 0.0f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    // phase 1: the gate cotangents of unit j, from the stored residuals
    for (int j = tid; j < H; j += THREADS) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int row = row0 + r;
        float rg = 0.0f, zg = 0.0f, n = 0.0f, gn = 0.0f, hp = 0.0f, ext = 0.0f;
        if (row < B) {
          const size_t o = (size_t)t * B + row;
          rg = to_f(rzn[o * G + j]);
          zg = to_f(rzn[o * G + H + j]);
          n = to_f(rzn[o * G + 2 * H + j]);
          gn = to_f(ghn[o * H + j]);
          hp = to_f(t > 0 ? hseq[(o - B) * H + j] : h0s[(size_t)row * H + j]);
          ext = dY[o * H + j];
        }
        const float dout = dh32[r * H + j] + ext;
        const float dz = dout * (hp - n) * zg * (1.0f - zg);
        const float dn = dout * (1.0f - zg) * (1.0f - n * n);
        const float dghn = dn * rg;
        const float dr = dn * gn * rg * (1.0f - rg);
        const S s_r = from_f<S>(dr);
        const S s_z = from_f<S>(dz);
        const S s_n = from_f<S>(dn);
        const S s_hn = from_f<S>(dghn);
        sgi[(size_t)j * RB + r] = s_r;
        sgi[((size_t)H + j) * RB + r] = s_z;
        sgi[((size_t)2 * H + j) * RB + r] = s_n;
        sgh[(size_t)j * RB + r] = s_r;
        sgh[((size_t)H + j) * RB + r] = s_z;
        sgh[((size_t)2 * H + j) * RB + r] = s_hn;
        if (row < B) {
          const size_t o = ((size_t)t * B + row) * G;
          dgi[o + j] = s_r;
          dgi[o + H + j] = s_z;
          dgi[o + 2 * H + j] = s_n;
          dgh[o + j] = s_r;
          dgh[o + H + j] = s_z;
          dgh[o + 2 * H + j] = s_hn;
        }
        dh32[r * H + j] = dout * zg;  // the product below adds to it
      }
    }
    __syncthreads();

    // phase 2: dh += dgh @ W_hh^T, and dx[t] = S(dgi @ W_ih^T)
    for (int k = tid; k < H; k += THREADS) {
      float acc[RB] = {0.0f, 0.0f, 0.0f, 0.0f};
      column_product(sgh, whh, (int)G, H, k, acc);
#pragma unroll
      for (int r = 0; r < RB; ++r) dh32[r * H + k] += acc[r];
    }
    if (WITH_DX) {
      for (int i = tid; i < I; i += THREADS) {
        float acc[RB] = {0.0f, 0.0f, 0.0f, 0.0f};
        column_product(sgi, wih, (int)G, I, i, acc);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const int row = row0 + r;
          if (row < B) dx[((size_t)t * B + row) * I + i] = from_f<S>(acc[r]);
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < RB * H; i += THREADS) {
    const int r = i / H, j = i % H;
    const int row = row0 + r;
    if (row < B) dh0[(size_t)row * H + j] = dh32[i];
  }
}

template <typename S>
size_t fwd_smem(int I, int H, bool hoisted) {
  return (size_t)RB * H * sizeof(float) + (size_t)2 * H * RB * sizeof(S) +
         (hoisted ? 0 : (size_t)I * RB * sizeof(S));
}

template <typename S>
size_t bwd_smem(int H) {
  return (size_t)RB * H * sizeof(float) + (size_t)2 * 3 * H * RB * sizeof(S);
}

bool bad_shape(int T, int B, int I, int H) { return T <= 0 || B <= 0 || I <= 0 || H <= 0; }

template <typename S, bool HOISTED>
cudaError_t launch_fwd(const void* x, const void* gi, const void* wih, const float* bih,
                       const void* whh, const float* bhh, const float* h0, void* hseq,
                       void* rzn, void* ghn, int T, int B, int I, int H, void* stream) {
  const size_t smem = fwd_smem<S>(I, H, HOISTED);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto kernel = gru_layer_fwd_kernel<S, HOISTED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(B + RB - 1) / RB, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(x), static_cast<const __nv_bfloat16*>(gi),
      static_cast<const S*>(wih), bih, static_cast<const S*>(whh), bhh, h0,
      static_cast<S*>(hseq), static_cast<S*>(rzn), static_cast<S*>(ghn), T, B, I, H);
  return cudaGetLastError();
}

template <typename S, bool WITH_DX>
cudaError_t launch_bwd(const void* hseq, const void* h0s, const void* rzn, const void* ghn,
                       const float* dY, const void* wih, const void* whh, void* dx,
                       float* dh0, void* dgi, void* dgh, int T, int B, int I, int H,
                       void* stream) {
  const size_t smem = bwd_smem<S>(H);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto kernel = gru_layer_bwd_kernel<S, WITH_DX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(B + RB - 1) / RB, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(hseq), static_cast<const S*>(h0s), static_cast<const S*>(rzn),
      static_cast<const S*>(ghn), dY, static_cast<const S*>(wih),
      static_cast<const S*>(whh), static_cast<S*>(dx), dh0, static_cast<S*>(dgi),
      static_cast<S*>(dgh), T, B, I, H);
  return cudaGetLastError();
}

template <typename S>
cudaError_t launch_layer_dw(const void* x, const void* h0s, const void* hseq, const void* dgi,
                            const void* dgh, float* dwih, float* dbih, float* dwhh,
                            float* dbhh, int T, int B, int I, int H, bool with_ih,
                            void* stream) {
  const S* x_ = static_cast<const S*>(x);
  const S* hseq_ = static_cast<const S*>(hseq);
  DwJobs<S> jobs;
  // W_hh: hprev = S(h0) for the first B rows, then hseq one step behind
  jobs.job[0] = DwJob<S>{static_cast<const S*>(dgh), hseq_, static_cast<const S*>(h0s),
                         dwhh, dbhh, H, B};
  jobs.job[1] = DwJob<S>{static_cast<const S*>(dgi), x_, x_, dwih, dbih, I, 0};
  return launch_dw(jobs, with_ih ? 2 : 1, T * B, 3 * H, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Each entry point launches on `stream` and returns the launch's
// cudaError_t (0 = success). `fp32` selects the strict-fp32 instance of
// gru_layer_scan_x (every S operand fp32) over the bf16 one.
extern "C" int molvax_gru_layer_x_fwd(const void* x, const void* wih, const float* bih,
                                      const void* whh, const float* bhh, const float* h0,
                                      void* hseq, void* rzn, void* ghn, int T, int B, int I,
                                      int H, int fp32, void* stream) {
  if (bad_shape(T, B, I, H)) return (int)cudaErrorInvalidValue;
  if (fp32)
    return (int)launch_fwd<float, false>(x, nullptr, wih, bih, whh, bhh, h0, hseq, rzn, ghn,
                                         T, B, I, H, stream);
  return (int)launch_fwd<__nv_bfloat16, false>(x, nullptr, wih, bih, whh, bhh, h0, hseq, rzn,
                                               ghn, T, B, I, H, stream);
}

extern "C" int molvax_gru_layer_x_bwd(const void* hseq, const void* h0s, const void* rzn,
                                      const void* ghn, const float* dY, const void* wih,
                                      const void* whh, void* dx, float* dh0, void* dgi,
                                      void* dgh, int T, int B, int I, int H, int fp32,
                                      void* stream) {
  if (bad_shape(T, B, I, H)) return (int)cudaErrorInvalidValue;
  if (fp32)
    return (int)launch_bwd<float, true>(hseq, h0s, rzn, ghn, dY, wih, whh, dx, dh0, dgi, dgh,
                                        T, B, I, H, stream);
  return (int)launch_bwd<__nv_bfloat16, true>(hseq, h0s, rzn, ghn, dY, wih, whh, dx, dh0, dgi,
                                              dgh, T, B, I, H, stream);
}

extern "C" int molvax_gru_layer_scan_fwd(const void* gi, const void* whh, const float* bhh,
                                         const float* h0, void* hseq, void* rzn, void* ghn,
                                         int T, int B, int H, void* stream) {
  if (bad_shape(T, B, 1, H)) return (int)cudaErrorInvalidValue;
  return (int)launch_fwd<__nv_bfloat16, true>(nullptr, gi, nullptr, nullptr, whh, bhh, h0,
                                              hseq, rzn, ghn, T, B, 0, H, stream);
}

extern "C" int molvax_gru_layer_scan_bwd(const void* hseq, const void* h0s, const void* rzn,
                                         const void* ghn, const float* dY, const void* whh,
                                         float* dh0, void* dgi, void* dgh, int T, int B, int H,
                                         void* stream) {
  if (bad_shape(T, B, 1, H)) return (int)cudaErrorInvalidValue;
  return (int)launch_bwd<__nv_bfloat16, false>(hseq, h0s, rzn, ghn, dY, nullptr, whh, nullptr,
                                               dh0, dgi, dgh, T, B, 0, H, stream);
}

// dW_hh, db_hh from dgh and hprev; with `with_ih`, dW_ih, db_ih from dgi and x
extern "C" int molvax_gru_layer_dw(const void* x, const void* h0s, const void* hseq,
                                   const void* dgi, const void* dgh, float* dwih, float* dbih,
                                   float* dwhh, float* dbhh, int T, int B, int I, int H,
                                   int fp32, int with_ih, void* stream) {
  if (bad_shape(T, B, with_ih ? I : 1, H)) return (int)cudaErrorInvalidValue;
  if (fp32)
    return (int)launch_layer_dw<float>(x, h0s, hseq, dgi, dgh, dwih, dbih, dwhh, dbhh, T, B, I,
                                       H, with_ih, stream);
  return (int)launch_layer_dw<__nv_bfloat16>(x, h0s, hseq, dgi, dgh, dwih, dbih, dwhh, dbhh, T,
                                             B, I, H, with_ih, stream);
}
