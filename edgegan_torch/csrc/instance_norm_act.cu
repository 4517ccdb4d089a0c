// Fused instance norm + activation, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel edgegan_tpu/ops/pallas_kernels.py:105-114
// (`_fwd_kernel`, launched by `instance_norm_act`, l.152-160). Same
// function, per (batch, channel) plane of H*W elements, in float32:
//   mean = sum(x) / n
//   var  = sum((x - mean)^2) / n            (two passes, not E[x^2]-mean^2)
//   y    = act((x - mean) / (sqrt(var) + 1e-5)), denominator 1e-5 at var == 0
//   act in {none, relu, lrelu 0.2}; y stored in the input dtype.
//
// Layout: contiguous NCHW, so each plane is one run of H*W elements. The
// TPU kernel holds one batch row [H*W, C] in VMEM; here one thread block
// owns one plane and loops over it in strides of blockDim.x, which takes
// any H*W. Each pass re-reads the plane; a plane is at most 16 KB at the
// shapes of this model, so the second and third reads come from L1/L2.
//
// Bound: bytes (2 * B*C*H*W * itemsize over 3.35 TB/s). At serving sizes
// (at most 2 MB per call) launch latency, not bandwidth, sets the time.
//
// Plain C interface (loaded with ctypes): returns cudaGetLastError() after
// the launch. Launches on the caller's stream, allocates nothing and does
// not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Sum over the block; every thread gets the total. `scratch` holds one
// float per warp and is reused, so the block synchronises before return.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  float total = 0.f;
  for (int i = 0; i < n_warps; ++i) total += scratch[i];
  __syncthreads();
  return total;
}

template <typename T, int kAct>
__global__ void __launch_bounds__(kThreads)
instance_norm_act_fwd(const T* __restrict__ x, T* __restrict__ y,
                      int64_t hw) {
  __shared__ float scratch[kThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * hw;
  const T* xp = x + base;
  T* yp = y + base;
  const float n = static_cast<float>(hw);

  float s = 0.f;
  for (int64_t i = threadIdx.x; i < hw; i += blockDim.x) s += to_f32(xp[i]);
  const float mean = block_sum(s, scratch) / n;

  float ss = 0.f;
  for (int64_t i = threadIdx.x; i < hw; i += blockDim.x) {
    const float d = to_f32(xp[i]) - mean;
    ss += d * d;
  }
  const float var = block_sum(ss, scratch) / n;
  const float denom = var > 0.f ? sqrtf(var) + kEps : kEps;

  for (int64_t i = threadIdx.x; i < hw; i += blockDim.x) {
    float v = (to_f32(xp[i]) - mean) / denom;
    if (kAct == 1) v = fmaxf(v, 0.f);
    if (kAct == 2) v = fmaxf(v, 0.2f * v);
    store(yp + i, v);
  }
}

template <typename T>
void launch(const void* x, void* y, int64_t planes, int64_t hw, int act,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(planes));
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  switch (act) {
    case 0: instance_norm_act_fwd<T, 0><<<grid, kThreads, 0, stream>>>(xp, yp, hw); break;
    case 1: instance_norm_act_fwd<T, 1><<<grid, kThreads, 0, stream>>>(xp, yp, hw); break;
    case 2: instance_norm_act_fwd<T, 2><<<grid, kThreads, 0, stream>>>(xp, yp, hw); break;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. act: 0 none, 1 relu, 2 lrelu(0.2).
extern "C" int edgegan_instance_norm_act_fwd(const void* x, void* y,
                                             int64_t planes, int64_t hw,
                                             int dtype, int act,
                                             void* stream) {
  if (planes <= 0 || planes > 0x7fffffffLL || hw <= 0 || act < 0 ||
      act > 2 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, y, planes, hw, act, s);
  } else {
    launch<__nv_bfloat16>(x, y, planes, hw, act, s);
  }
  return static_cast<int>(cudaGetLastError());
}
