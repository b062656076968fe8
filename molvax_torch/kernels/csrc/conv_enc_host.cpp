// The fused encoder's conv stages (conv_enc.cuh) as host C++: the same row
// function as csrc/conv_enc.cu's phase A, each warp's lanes run one after
// another and warp_mma emulated over their fragments, row after row. Built
// with g++ by tests/test_torch_encode_design.py, which holds it to the
// plain encoder's conv stages; nvcc never compiles it (kernels/_build.py
// builds csrc/*.cu).
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libconv_enc_host.so conv_enc_host.cpp
//
// Each entry returns 0, or 1 for a shape the kernel refuses.

#include <stdlib.h>

#include "conv_enc.cuh"

using namespace conv_enc;

namespace {

EncDims dims(int n, const int* cout, const int* ksize, int T, int C, int seq, int B, int E, int Lz) {
  EncDims d;
  memset(&d, 0, sizeof(d));
  d.n = n;
  for (int i = 0; i < n && i < MAX_CONV; ++i) {
    d.cout[i] = cout[i];
    d.k[i] = ksize[i];
  }
  d.T = T;
  d.C = C;
  d.seq = seq;
  d.B = B;
  d.E = E;
  d.Lz = Lz;
  return d;
}

}  // namespace

// The kernel's layout within smem_limit bytes a block, codes of code_size
// bytes: out = ok, smem, smem_conv, smem_dense, smem_head, whether W_0 is
// copied during phase A, F, Fp, Ep, tiles_dense, tiles_head, and the warps
// a row on `grid` blocks
extern "C" int molvax_encode_layout_host(int n, const int* cout, const int* ksize, int T, int C, int seq, int B,
                                         int E, int Lz, int grid, int code_size, long long smem_limit,
                                         long long* out) {
  if (n < 1 || n > MAX_CONV || grid < 1) return 1;
  const EncDims d = dims(n, cout, ksize, T, C, seq, B, E, Lz);
  const EncLayout L = enc_layout(d, team_warps(B, grid), code_size, (size_t)smem_limit);
  const long long v[12] = {L.ok, (long long)L.smem, (long long)L.smem_conv, (long long)L.smem_dense,
                           (long long)L.smem_head, L.pre_dense, L.ok ? d.F() : 0, L.ok ? d.Fp() : 0, d.Ep(),
                           L.tiles_dense, L.tiles_head, team_warps(B, grid)};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}

// Phase A over B rows by teams of `team` warps (1, 2, 4 or 8): the first n
// convs of the stack (weights and biases fp32, torch layout) on codes
// (B, T) of code_kind, flushed to h3 (B, Fp) as bf16 bits in NCH order.
extern "C" int molvax_encode_conv_host(const void* codes, int code_kind, const float* const* conv_w,
                                       const float* const* conv_b, int n, const int* cout, const int* ksize, int T,
                                       int C, int seq, int B, int team, uint16_t* h3) {
  if (n < 1 || n > MAX_CONV || code_kind < CODE_U8 || code_kind > CODE_I64 || team < 1 || team > WARPS ||
      WARPS % team)
    return 1;
  const EncDims d = dims(n, cout, ksize, T, C, seq, B, 1, 1);
  const EncLayout L = enc_layout(d, team, 8, (size_t)1 << 40);
  if (!L.ok) return 1;
  unsigned char* smem = static_cast<unsigned char*>(calloc(L.smem_conv, 1));
  if (!smem) return 1;
  stage_conv_weights(d, L, [&](int s) { return conv_w[s]; }, smem);
  unsigned char* mine = smem + L.warp_off;
  int* code_s = reinterpret_cast<int*>(mine);
  uint16_t* buf0 = reinterpret_cast<uint16_t*>(mine + up16((size_t)T * 4));
  uint16_t* buf1 = buf0 + L.buf_elems;
  for (int row = 0; row < B; ++row)
    conv_row(d, L, smem, [&](int s) { return conv_b[s]; },
             static_cast<const unsigned char*>(codes) + (size_t)row * T * code_bytes(code_kind), code_kind, code_s, buf0,
             buf1, h3 + (size_t)row * d.Fp(), 0, 0, team);
  free(smem);
  return 0;
}
