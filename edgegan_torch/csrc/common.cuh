// Helpers shared by the port's kernels: float32 loads and stores of the
// two element types (float32, bfloat16) and block-wide reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace edgegan {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Sum {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return a + b;
  }
};
struct Min {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return fminf(a, b);
  }
};
struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return fmaxf(a, b);
  }
};

// Reduce over the block (blockDim.x a multiple of 32, at most 1024); every
// thread gets the result, combined in the same order on every run.
// `scratch` holds one float per warp and is reused, so the block
// synchronises before return.
template <typename Op>
__device__ __forceinline__ float block_reduce(float v, float* scratch,
                                             Op op) {
  for (int off = 16; off > 0; off >>= 1) {
    v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  float total = scratch[0];
  for (int i = 1; i < n_warps; ++i) total = op(total, scratch[i]);
  __syncthreads();
  return total;
}

__device__ __forceinline__ float block_sum(float v, float* scratch) {
  return block_reduce(v, scratch, Sum());
}

// 16 bytes of elements, loaded and stored as one vector access.
template <typename T>
struct alignas(16) Pack {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

}  // namespace edgegan
