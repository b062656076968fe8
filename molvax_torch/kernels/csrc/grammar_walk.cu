// The Grammar VAE's pushdown walk: one non-autoregressive pass of logits
// (B, T, R) over the R production rules -> each row's derivation and its
// SMILES' terminals.
//
// Computes what molvax_torch/kernels/grammar_walk.py::walk_ref computes, bit
// for bit, and what the published _sample_using_masks computes: per row and
// step, emit the terminals on top of the row's stack, pop the nonterminal
// under them (Nothing where the stack is empty), score its rules (the logit,
// or logit / temperature + Gumbel noise of (seed, step, global row, rule)
// from the counter hash of common.cuh), take the first maximum, push the
// rule's right-hand side in reverse. A nonterminal without a rule ends the
// row as incomplete (its step and every later one take the padding rule), as
// does a nonterminal left on the stack after the last step; an incomplete
// row's terminals are all 0.
//
// What bounds it on an H100: not bytes. A request of B = 10,000 rows at
// T = 277, R = 76 reads 84 MB of fp32 logits (25 us at 3.35 TB/s); each row
// is a chain of T dependent steps, each a load, a hash, a warp reduction and
// a few stack operations: latency. So a warp owns a row, a lane a rule of
// the popped nonterminal (the rules of a nonterminal are contiguous and at
// most 32), and the row's stack lives in shared memory, written by every
// lane alike (each lane reads back only what it wrote itself, so the warp
// needs no barrier). The lanes' loads of a step are one coalesced segment.
//
// Table (int32, walk_table of data/grammar.py): lo (NT) | hi (NT) | rhs
// (R x 4): nonterminal j's rules are [lo[j], hi[j]); a right-hand side's
// symbol s is nonterminal s where s < NT, terminal code s - NT + 1 else, -1
// after the last. Output (B, 3T) uint8: T rule codes, then 2T terminal
// codes (0 after the last).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int WALK_WARPS = 4;  // rows (warps) a block
constexpr int WALK_THREADS = WALK_WARPS * 32;
constexpr int WALK_RHS = 4;  // data/grammar.py MAX_RHS

struct WalkArgs {
  const float* logits;
  int B, T, R;
  const int* tab;
  int NT, start, nothing, pad_rule;
  uint32_t seed;
  int greedy;
  float temperature;
  int row_base;
  int depth;  // 1 + 3T
  uint8_t* out;
};

__global__ void __launch_bounds__(WALK_THREADS) grammar_walk_kernel(const WalkArgs a) {
  extern __shared__ int16_t stacks[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * WALK_WARPS + warp;
  if (row >= a.B) return;  // a whole warp
  int16_t* stack = stacks + (size_t)warp * a.depth;
  const int T = a.T, R = a.R, NT = a.NT, W = 2 * T;
  const int* lo_of = a.tab;
  const int* hi_of = a.tab + NT;
  const int* rhs = a.tab + 2 * NT;
  uint8_t* prods = a.out + (size_t)row * 3 * T;
  uint8_t* terms = prods + T;
  const float* lrow = a.logits + (size_t)row * T * R;
  const uint32_t grow = (uint32_t)(a.row_base + row);
  int sp = 1, nterm = 0;
  bool incomplete = false;
  stack[0] = (int16_t)a.start;
  for (int t = 0; t < T; ++t) {
    while (sp > 0 && stack[sp - 1] >= NT) {  // the terminals on top
      if (lane == 0) terms[nterm] = (uint8_t)(stack[sp - 1] - NT + 1);
      ++nterm;
      --sp;
    }
    int nt = a.nothing;
    if (sp > 0) nt = stack[--sp];
    const int lo = lo_of[nt], hi = hi_of[nt];
    int rule;
    if (lo >= hi) {  // a nonterminal without a rule: the derivation ends here
      incomplete = true;
      sp = 0;
      rule = a.pad_rule;
    } else {
      const int r = lo + lane;
      const bool legal = r < hi;
      float v = -INFINITY;
      if (legal) {
        v = lrow[(size_t)t * R + r];
        if (!a.greedy) {
          const uint32_t bits = noise_bits(a.seed, (uint32_t)t, grow, (uint32_t)r);
          const float u = ((float)(bits >> 8) + 1.0f) * (1.0f / 16777216.0f);
          v = v / a.temperature + (-logf(-logf(u)));
        }
      }
      // the maximum over the lanes, a NaN winning as torch's amax has it
      float m = v;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float o = __shfl_xor_sync(0xffffffffu, m, off);
        m = (isnan(m) || isnan(o)) ? NAN : fmaxf(m, o);
      }
      const unsigned hit = __ballot_sync(0xffffffffu, legal && v == m);
      rule = hit ? lo + __ffs(hit) - 1 : lo;
      for (int k = WALK_RHS - 1; k >= 0; --k) {
        const int s = rhs[rule * WALK_RHS + k];
        if (s >= 0) stack[sp++] = (int16_t)s;
      }
    }
    if (lane == 0) prods[t] = (uint8_t)rule;
  }
  while (sp > 0 && stack[sp - 1] >= NT) {
    if (lane == 0) terms[nterm] = (uint8_t)(stack[sp - 1] - NT + 1);
    ++nterm;
    --sp;
  }
  if (sp > 0) incomplete = true;
  __syncwarp();  // lane 0's terminal writes before the other lanes' zeros
  for (int i = (incomplete ? 0 : nterm) + lane; i < W; i += 32) terms[i] = 0;
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 = success).
// logits (B, T, R) fp32, tab the walk table, out (B, 3T) uint8.
extern "C" int molvax_grammar_walk(const float* logits, int B, int T, int R, const int* tab, int NT, int start,
                                   int nothing, int pad_rule, uint32_t seed, int greedy, float temperature,
                                   int row_base, uint8_t* out, void* stream) {
  if (B < 1 || T < 1 || R < 1 || R > 256 || NT < 1 || NT > R + 256) return (int)cudaErrorInvalidValue;
  WalkArgs a{logits, B, T, R, tab, NT, start, nothing, pad_rule, seed, greedy, temperature, row_base, 1 + 3 * T,
             out};
  const size_t smem = sizeof(int16_t) * (size_t)WALK_WARPS * a.depth;
  if (smem > 48 * 1024) {
    int dev = 0, optin = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
        smem > (size_t)optin ||
        cudaFuncSetAttribute(grammar_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
            cudaSuccess)
      return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((B + WALK_WARPS - 1) / WALK_WARPS);
  grammar_walk_kernel<<<grid, WALK_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
