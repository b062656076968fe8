// Helpers of the persistent cooperative kernels (csrc/gru_stack.cu's
// recurrence and sweep, csrc/gru_layer.cu's layer kernels): one block per
// SM for the whole sequence, the blocks of a row group meeting at a barrier
// on a global counter once a step.

#pragma once

#include <cuda_runtime.h>

namespace {

// elements of padding per shared-memory row: 16 bytes (8 bf16, 4 fp32), which
// keeps ldmatrix (bf16) and the fp32 word reads of fp32_k8 free of conflicts
template <typename E>
constexpr int SPAD = 16 / (int)sizeof(E);

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// The row groups' barrier in its two halves, so that work which reads no
// other block's part of the step runs between them: group_arrive once the
// block's stores of the step are issued, group_wait (until the count
// reaches `target`) before the next read of the others' stores.
__device__ __forceinline__ void group_arrive(int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(flag, 1);
  }
}

__device__ __forceinline__ void group_wait(int* flag, int target) {
  if (threadIdx.x == 0) {
    int v;
    do {
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(flag) : "memory");
    } while (v < target);
    __threadfence();
  }
  __syncthreads();
}

// The whole barrier: every block of the group has stored its part of step t
// (count reaches `target`) before any reads it.
__device__ __forceinline__ void group_barrier(int* flag, int target) {
  group_arrive(flag);
  group_wait(flag, target);
}

// One cooperative launch of `kernel` over `blocks` blocks; every block must
// be resident (one per SM) or the launch fails.
template <typename Args>
int launch_persistent(void (*kernel)(Args), const Args& args, int blocks, int threads,
                      size_t smem, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {const_cast<Args*>(&args)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(blocks), dim3(threads),
                                    params, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
