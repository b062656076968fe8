// Fused conv encoder: charset codes -> (mu, logvar) in one launch.
//
// Replaces molvax/kernels/conv_enc.py::fused_encode (the Pallas TPU kernel)
// and computes what it computes, per batch row:
//   x      = one_hot(codes), built in shared memory: 'seq' orientation
//            convolves along the T positions with the charset as channels
//            (x[c][t]), 'charset' along the charset with the positions as
//            channels (x[t][c])
//   h_i    = bf16(relu(conv_i(h_{i-1}) + b_i))   VALID convs, torch layout
//   h2     = selu(flatten(h_N) @ W_0 + b_0)       channel-major flatten
//   mu     = h2 @ W_mu + b_mu, logvar = h2 @ W_lv + b_lv  (fp32 heads)
// Conv and dense products take bf16 operands and accumulate in fp32; the
// heads are fp32, as in the TPU kernel. The backward is not a kernel: the
// wrapper differentiates the plain encoder, as the TPU package does.
//
// Design. One block per batch row: codes are read as ints, the one-hot and
// every activation stay in shared memory, never in device memory. Thread o
// of a stage owns output o (channel and position for a conv, unit for the
// dense layer and the heads). The dense weight is read as (F, E) and the
// heads as (E, L), so a warp reads neighbouring columns of one row.
//
// What bounds it on an H100. ~1.2 M multiply-adds per row at zinc250k
// width, most of them the 940 x 435 dense layer; each block streams the
// dense and head weights (~1.8 MB) from L2. At B=256 that is ~0.5 GB of
// L2 reads against ~0.3 G FMAs: a fraction of a millisecond either way,
// ~1% of a training step. Several rows per block would share the weight
// stream; not needed yet.

#include "common.cuh"

namespace {

constexpr int ENC_THREADS = 256;
constexpr int MAX_CONV = 8;

struct ConvSpec {
  int n;
  int cout[MAX_CONV];
  int k[MAX_CONV];
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float selu_f(float x) {
  const float alpha = 1.6732632423543772f;
  const float scale = 1.0507009873554805f;
  return x > 0.0f ? scale * x : scale * (alpha * expm1f(x));
}

// shared memory: buf[2][max_act] fp32, h2 fp32 [E]
__global__ void __launch_bounds__(ENC_THREADS)
fused_encode_kernel(const int* __restrict__ codes,            // (B, T)
                    const __nv_bfloat16* __restrict__ wconv,  // conv weights, (Cout, Cin, K) each
                    const float* __restrict__ bconv,          // conv biases
                    ConvSpec spec,
                    const __nv_bfloat16* __restrict__ w0,     // (F, E)
                    const float* __restrict__ b0,             // (E)
                    const float* __restrict__ wmu,            // (E, Lz)
                    const float* __restrict__ bmu,
                    const float* __restrict__ wlv,            // (E, Lz)
                    const float* __restrict__ blv,
                    float* __restrict__ mu, float* __restrict__ logvar,  // (B, Lz)
                    int T, int C, int seq, int E, int Lz, int max_act) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf0 = reinterpret_cast<float*>(smem);
  float* buf1 = buf0 + max_act;
  float* h2 = buf1 + max_act;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int* code = codes + (size_t)b * T;

  // one-hot in shared memory; a code outside [0, C) gives a zero row
  int cin = seq ? C : T;
  int width = seq ? T : C;
  for (int i = tid; i < cin * width; i += ENC_THREADS) {
    const int ch = i / width, w = i % width;
    const int t = seq ? w : ch, c = seq ? ch : w;
    buf0[i] = code[t] == c ? 1.0f : 0.0f;
  }
  __syncthreads();

  float* in = buf0;
  float* out = buf1;
  const __nv_bfloat16* wl = wconv;
  const float* bl = bconv;
  for (int s = 0; s < spec.n; ++s) {
    const int cout = spec.cout[s], K = spec.k[s];
    const int wout = width - K + 1;
    for (int i = tid; i < cout * wout; i += ENC_THREADS) {
      const int o = i / wout, w = i % wout;
      float acc = 0.0f;
      for (int c = 0; c < cin; ++c) {
        const __nv_bfloat16* wk = wl + ((size_t)o * cin + c) * K;
        const float* xc = in + (size_t)c * width + w;
        for (int k = 0; k < K; ++k) acc = fmaf(__bfloat162float(wk[k]), xc[k], acc);
      }
      out[i] = round_bf16(fmaxf(acc + bl[o], 0.0f));  // bf16 between stages
    }
    __syncthreads();
    wl += (size_t)cout * cin * K;
    bl += cout;
    cin = cout;
    width = wout;
    float* tmp = in;
    in = out;
    out = tmp;
  }

  const int F = cin * width;  // flatten (channel, position), channel-major
  for (int e = tid; e < E; e += ENC_THREADS) {
    float acc = 0.0f;
    for (int f = 0; f < F; ++f) acc = fmaf(in[f], __bfloat162float(w0[(size_t)f * E + e]), acc);
    h2[e] = selu_f(acc + b0[e]);
  }
  __syncthreads();

  for (int u = tid; u < Lz; u += ENC_THREADS) {
    float am = 0.0f, al = 0.0f;
    for (int e = 0; e < E; ++e) {
      am = fmaf(h2[e], wmu[(size_t)e * Lz + u], am);
      al = fmaf(h2[e], wlv[(size_t)e * Lz + u], al);
    }
    mu[(size_t)b * Lz + u] = am + bmu[u];
    logvar[(size_t)b * Lz + u] = al + blv[u];
  }
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 = success).
// cout / ksize: n_conv entries each; max_act: the largest activation
// (channels x width) of the one-hot and the conv stages.
extern "C" int molvax_fused_encode(const int* codes, const void* wconv, const float* bconv,
                                   int n_conv, const int* cout, const int* ksize,
                                   const void* w0, const float* b0, const float* wmu,
                                   const float* bmu, const float* wlv, const float* blv,
                                   float* mu, float* logvar, int B, int T, int C, int seq,
                                   int E, int Lz, int max_act, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || E <= 0 || Lz <= 0 || n_conv <= 0 || n_conv > MAX_CONV)
    return (int)cudaErrorInvalidValue;
  ConvSpec spec;
  spec.n = n_conv;
  for (int i = 0; i < n_conv; ++i) {
    spec.cout[i] = cout[i];
    spec.k[i] = ksize[i];
  }
  const size_t smem = ((size_t)2 * max_act + E) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_encode_kernel<<<B, ENC_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      codes, static_cast<const __nv_bfloat16*>(wconv), bconv, spec,
      static_cast<const __nv_bfloat16*>(w0), b0, wmu, bmu, wlv, blv, mu, logvar, T, C,
      seq, E, Lz, max_act);
  return (int)cudaGetLastError();
}
