// The MRU unit's min-max gate and blend, forward (K3) and backward (K4),
// for Hopper (sm_90a).
//
// K3 replaces the Pallas TPU kernel edgegan_tpu/ops/pallas_kernels.py:
// 308-314 (`_gate_fwd_kernel`, launched by `mru_gate_blend`, l.367-381).
// Per (batch, channel) plane of H*W elements, in float32:
//   mn, mx = min, max of rg over the plane;  r = mx - mn
//   den    = r where r > 0, else 1 (a flat gate becomes a zero gate)
//   rgn    = (rg - mn) / den
//   out    = ht + rgn * img                          stored in rg's dtype
//
// K4 replaces `_gate_bwd_kernel` (l.317-343, launched by `_gate_bwd`,
// l.388-403): from rg, img and the cotangent g of out,
//   dimg  = g * rgn,  drgn = g * img
//   dmn   = sum(drgn * (rg - mx)) / r^2 where r > 0, else -sum(drgn)
//   dmx   = -sum(drgn * rgn) / den where r > 0, else 0
//   drg   = drgn / den + [rg == mn] * dmn / nmin + [rg == mx] * dmx / nmax
// with nmin, nmax the number of elements tied at the minimum and the
// maximum: the even split of jnp.min's and torch.amin's VJP. dht = g needs
// no kernel.
//
// Layout: contiguous NCHW, so each plane is one run of H*W elements. The
// TPU kernels hold one batch row [H*W, C] in VMEM; here one thread block
// owns one plane and loops over it, with 32 to 256 threads (about 8
// elements a thread), so the 64-element planes of the last unit do not
// leave 7 of 8 warps idle. The later passes re-read the plane, at most
// 16 KB, from L1/L2. Sums and products are rounded as the TPU kernel
// rounds them (`__fmul_rn`/`__fadd_rn` where a fused multiply-add would
// round once), and a division stays a division.
//
// Bounds: bytes. K3 reads rg, ht, img and writes out: 4 * n * itemsize;
// K4 reads rg, img, g and writes drg, dimg: 5 * n * itemsize. The
// classifier's four gates at batch 64 hold 16,777,216 elements, so a
// training step's 12 calls of each (3 classifier passes) move 0.81 GB
// (K3) and 1.01 GB (K4) in float32: 0.24 and 0.30 ms at 3.35 TB/s.
//
// Plain C interface (loaded with ctypes): each entry point returns
// cudaGetLastError() after the launch. Launches on the caller's stream,
// allocates nothing and does not synchronise.

#include <math.h>

#include "common.cuh"

namespace {

using edgegan::block_reduce;
using edgegan::block_sum;
using edgegan::Max;
using edgegan::Min;
using edgegan::store;
using edgegan::to_f32;

constexpr int kMaxThreads = 256;

template <typename T>
__device__ __forceinline__ void plane_min_max(const T* p, int64_t hw,
                                              float* scratch, float& mn,
                                              float& mx) {
  float lo = INFINITY, hi = -INFINITY;
  for (int64_t i = threadIdx.x; i < hw; i += blockDim.x) {
    const float v = to_f32(p[i]);
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }
  mn = block_reduce(lo, scratch, Min());
  mx = block_reduce(hi, scratch, Max());
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
mru_gate_fwd(const T* __restrict__ rg, const T* __restrict__ ht,
             const T* __restrict__ img, T* __restrict__ out, int64_t hw) {
  __shared__ float scratch[kMaxThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * hw;
  const T* rgp = rg + base;
  const T* htp = ht + base;
  const T* imgp = img + base;
  T* outp = out + base;
  float mn, mx;
  plane_min_max(rgp, hw, scratch, mn, mx);
  const float r = mx - mn;
  const float den = r > 0.f ? r : 1.f;
  for (int64_t i = threadIdx.x; i < hw; i += blockDim.x) {
    const float rgn = (to_f32(rgp[i]) - mn) / den;
    store(outp + i,
          __fadd_rn(to_f32(htp[i]), __fmul_rn(rgn, to_f32(imgp[i]))));
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
mru_gate_bwd(const T* __restrict__ rg, const T* __restrict__ img,
             const T* __restrict__ g, T* __restrict__ drg,
             T* __restrict__ dimg, int64_t hw) {
  __shared__ float scratch[kMaxThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * hw;
  const T* rgp = rg + base;
  const T* imgp = img + base;
  const T* gp = g + base;
  T* drgp = drg + base;
  T* dimgp = dimg + base;
  float mn, mx;
  plane_min_max(rgp, hw, scratch, mn, mx);
  const float r = mx - mn;
  const bool pos = r > 0.f;
  const float den = pos ? r : 1.f;

  // dimg, and the plane's sums for the min and max cotangents
  float s_lo = 0.f, s_rgn = 0.f, s_all = 0.f, n_min = 0.f, n_max = 0.f;
  for (int64_t i = threadIdx.x; i < hw; i += blockDim.x) {
    const float v = to_f32(rgp[i]);
    const float gv = to_f32(gp[i]);
    const float rgn = (v - mn) / den;
    store(dimgp + i, gv * rgn);
    const float drgn = gv * to_f32(imgp[i]);
    s_lo += drgn * (v - mx);
    s_rgn += drgn * rgn;
    s_all += drgn;
    n_min += v == mn ? 1.f : 0.f;
    n_max += v == mx ? 1.f : 0.f;
  }
  s_lo = block_sum(s_lo, scratch);
  s_rgn = block_sum(s_rgn, scratch);
  s_all = block_sum(s_all, scratch);
  n_min = block_sum(n_min, scratch);
  n_max = block_sum(n_max, scratch);
  const float d_min = pos ? s_lo / (r * r) : -s_all;
  const float d_max = pos ? -s_rgn / den : 0.f;
  const float q_min = d_min / n_min;
  const float q_max = d_max / n_max;

  for (int64_t i = threadIdx.x; i < hw; i += blockDim.x) {
    const float v = to_f32(rgp[i]);
    float d = __fmul_rn(to_f32(gp[i]), to_f32(imgp[i])) / den;
    if (v == mn) d = __fadd_rn(d, q_min);
    if (v == mx) d = __fadd_rn(d, q_max);
    store(drgp + i, d);
  }
}

// 32 to 256 threads a block, about 8 elements of the plane a thread
int threads_for(int64_t hw) {
  int threads = 32;
  while (threads < kMaxThreads && threads * 8 < hw) threads *= 2;
  return threads;
}

bool bad_args(int64_t planes, int64_t hw, int dtype) {
  return planes <= 0 || planes > 0x7fffffffLL || hw <= 0 ||
         (dtype != 0 && dtype != 1);
}

template <typename T>
void launch_fwd(const void* rg, const void* ht, const void* img, void* out,
                int64_t planes, int64_t hw, cudaStream_t stream) {
  mru_gate_fwd<T><<<static_cast<unsigned>(planes), threads_for(hw), 0,
                    stream>>>(
      static_cast<const T*>(rg), static_cast<const T*>(ht),
      static_cast<const T*>(img), static_cast<T*>(out), hw);
}

template <typename T>
void launch_bwd(const void* rg, const void* img, const void* g, void* drg,
                void* dimg, int64_t planes, int64_t hw, cudaStream_t stream) {
  mru_gate_bwd<T><<<static_cast<unsigned>(planes), threads_for(hw), 0,
                    stream>>>(
      static_cast<const T*>(rg), static_cast<const T*>(img),
      static_cast<const T*>(g), static_cast<T*>(drg), static_cast<T*>(dimg),
      hw);
}

}  // namespace

// K3. dtype: 0 float32, 1 bfloat16; rg, ht, img and out of one shape.
extern "C" int edgegan_mru_gate_fwd(const void* rg, const void* ht,
                                    const void* img, void* out,
                                    int64_t planes, int64_t hw, int dtype,
                                    void* stream) {
  if (bad_args(planes, hw, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_fwd<float>(rg, ht, img, out, planes, hw, s);
  } else {
    launch_fwd<__nv_bfloat16>(rg, ht, img, out, planes, hw, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4: drg and dimg from rg, img and the cotangent g of K3's output.
extern "C" int edgegan_mru_gate_bwd(const void* rg, const void* img,
                                    const void* g, void* drg, void* dimg,
                                    int64_t planes, int64_t hw, int dtype,
                                    void* stream) {
  if (bad_args(planes, hw, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_bwd<float>(rg, img, g, drg, dimg, planes, hw, s);
  } else {
    launch_bwd<__nv_bfloat16>(rg, img, g, drg, dimg, planes, hw, s);
  }
  return static_cast<int>(cudaGetLastError());
}
