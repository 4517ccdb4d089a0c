// Fused instance norm + activation, forward (K1) and backward (K2), for
// Hopper (sm_90a).
//
// K1 replaces the Pallas TPU kernel edgegan_tpu/ops/pallas_kernels.py:
// 105-114 (`_fwd_kernel`, launched by `instance_norm_act`, l.152-160). Same
// function, per (batch, channel) plane of H*W elements, in float32:
//   mean = sum(x) / n
//   var  = sum((x - mean)^2) / n            (two passes, not E[x^2]-mean^2)
//   y    = act((x - mean) / (sqrt(var) + 1e-5)), denominator 1e-5 at var == 0
//   act in {none, relu, lrelu 0.2}; y stored in the input dtype.
//
// K2 replaces `_bwd_kernel` (l.117-135, launched by `_in_bwd`, l.167-172):
// K1's first-order VJP from x alone. It recomputes the statistics, then
//   s     = sqrt(var) (1 where var == 0),  d = s + 1e-5 (1e-5 where var == 0)
//   y_pre = (x - mean) / d,  g' = act'(y_pre) * g  (act' taken at y_pre > 0)
//   dx    = (g' - mean(g')) / d - y_pre * mean(g' * y_pre) / s
// A constant plane has y_pre == 0, so dx = (g' - mean(g')) / 1e-5 there,
// as in the TPU kernel (l.131-134).
//
// Layout: contiguous NCHW, so each plane is one run of H*W elements. The
// TPU kernels hold one batch row [H*W, C] in VMEM; here one thread block
// owns one plane and loops over it in strides of blockDim.x, which takes
// any H*W. Each pass re-reads the plane; a plane is at most 16 KB at the
// shapes of this model, so the later reads come from L1/L2.
//
// Bounds: bytes. K1 moves 2 * B*C*H*W * itemsize, K2 3 * B*C*H*W *
// itemsize (reads x and g, writes dx), over 3.35 TB/s. At serving sizes
// (at most 2 MB per call) launch latency, not bandwidth, sets K1's time.
// K2 at the training shapes in float32, batch 64: [64,256,8,8],
// [64,128,16,16] and [64,64,32,32] move 12.6, 25.2 and 50.3 MB, bounds of
// 3.76 + 7.51 + 15.02 us per generator backward, 105 us per training step
// (12 calls: two generator updates of two generators, three blocks each).
// Both kernels are simple and right first; none is tuned yet.
//
// Plain C interface (loaded with ctypes): each entry point returns
// cudaGetLastError() after the launch. Launches on the caller's stream,
// allocates nothing and does not synchronise.

#include "common.cuh"

namespace {

using edgegan::block_sum;
using edgegan::store;
using edgegan::to_f32;

constexpr int kThreads = 256;
constexpr float kEps = 1e-5f;

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

// K1's activation derivative at y_pre: the cotangent where y_pre > 0,
// 0 (relu) or 0.2 times it (lrelu) elsewhere (pallas_kernels.py:94-102).
template <int kAct>
__device__ __forceinline__ float act_bwd(float g, float y_pre) {
  if (kAct == 1) return y_pre > 0.f ? g : 0.f;
  if (kAct == 2) return y_pre > 0.f ? g : 0.2f * g;
  return g;
}

template <typename T, int kAct>
__global__ void __launch_bounds__(kThreads)
instance_norm_act_bwd(const T* __restrict__ x, const T* __restrict__ g,
                      T* __restrict__ dx, int64_t hw) {
  __shared__ float scratch[kThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * hw;
  const T* xp = x + base;
  const T* gp = g + base;
  T* dxp = dx + base;
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
  const bool nondeg = var > 0.f;
  const float sd = nondeg ? sqrtf(var) : 1.f;
  const float denom = nondeg ? sd + kEps : kEps;

  float sg = 0.f, sgy = 0.f;
  for (int64_t i = threadIdx.x; i < hw; i += blockDim.x) {
    const float y = (to_f32(xp[i]) - mean) / denom;
    const float gv = act_bwd<kAct>(to_f32(gp[i]), y);
    sg += gv;
    sgy += gv * y;
  }
  const float g_mean = block_sum(sg, scratch) / n;
  const float gy_mean = block_sum(sgy, scratch) / n;

  for (int64_t i = threadIdx.x; i < hw; i += blockDim.x) {
    const float y = (to_f32(xp[i]) - mean) / denom;
    const float gv = act_bwd<kAct>(to_f32(gp[i]), y);
    store(dxp + i, (gv - g_mean) / denom - y * gy_mean / sd);
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

template <typename T>
void launch_bwd(const void* x, const void* g, void* dx, int64_t planes,
                int64_t hw, int act, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(planes));
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  T* dxp = static_cast<T*>(dx);
  switch (act) {
    case 0: instance_norm_act_bwd<T, 0><<<grid, kThreads, 0, stream>>>(xp, gp, dxp, hw); break;
    case 1: instance_norm_act_bwd<T, 1><<<grid, kThreads, 0, stream>>>(xp, gp, dxp, hw); break;
    case 2: instance_norm_act_bwd<T, 2><<<grid, kThreads, 0, stream>>>(xp, gp, dxp, hw); break;
  }
}

bool bad_args(int64_t planes, int64_t hw, int dtype, int act) {
  return planes <= 0 || planes > 0x7fffffffLL || hw <= 0 || act < 0 ||
         act > 2 || (dtype != 0 && dtype != 1);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. act: 0 none, 1 relu, 2 lrelu(0.2).
extern "C" int edgegan_instance_norm_act_fwd(const void* x, void* y,
                                             int64_t planes, int64_t hw,
                                             int dtype, int act,
                                             void* stream) {
  if (bad_args(planes, hw, dtype, act)) {
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

// K2: dx from x and the cotangent g of K1's output, same shapes and dtype.
extern "C" int edgegan_instance_norm_act_bwd(const void* x, const void* g,
                                             void* dx, int64_t planes,
                                             int64_t hw, int dtype, int act,
                                             void* stream) {
  if (bad_args(planes, hw, dtype, act)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_bwd<float>(x, g, dx, planes, hw, act, s);
  } else {
    launch_bwd<__nv_bfloat16>(x, g, dx, planes, hw, act, s);
  }
  return static_cast<int>(cudaGetLastError());
}
