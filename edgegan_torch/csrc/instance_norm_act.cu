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
// Bound: bytes. K1 reads x and writes y, 2 * B*C*H*W * itemsize; K2 reads
// x and g and writes dx, 3 * B*C*H*W * itemsize; over 3.35 TB/s. The
// generators' planes, [B,256,8,8], [B,128,16,16] and [B,64,32,32], hold 64,
// 256 and 1024 elements; at batch 64 in float32 K1's bounds are 2.50, 5.01
// and 10.0 us, K2's 3.76, 7.51 and 15.0 us. Recomputing the statistics in
// K2 costs no bytes: the plane is in registers.
//
// Layout: contiguous NCHW, so each plane is one run of H*W elements. The
// TPU kernels hold one batch row [H*W, C] in VMEM. Here the plane is held
// in registers, read from device memory once, and the sums are taken from
// there. Two variants, picked by the caller (`instance_norm_plan` in
// ops/kernels.py) and checked here:
//   1 lane group: a group of `lanes` threads (4 to 32, a power of two) owns
//     one plane, so a 256-thread block holds 256 / lanes planes and a
//     64-element plane does not leave most of a block idle. Each thread
//     loads `vectors` 16-byte vectors (1 to 8), every load issued before
//     the first use, neighbouring threads on neighbouring vectors. Sums go
//     through __shfl_xor_sync within the group: no shared memory, no
//     barrier. Up to 1024 float32 or 2048 bfloat16 elements a plane, which
//     holds every plane of the default configurations.
//   0 multi-pass: one block walks the plane in strides of 256 threads,
//     once per sum, re-reading it from L1/L2. It takes any H*W at any
//     alignment: planes beyond a lane group's reach, H*W not a multiple of
//     the vector width, and a base pointer not on 16 bytes.
// Every sum is taken in a fixed order (no atomics), so a run gives the
// same bits every time. Each element is divided by d, not multiplied by
// its reciprocal, as the plain version does.
//
// Plain C interface (loaded with ctypes): each entry point returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue, without
// launching, for a variant it has no kernel for or that cannot hold the
// plane. Launches on the caller's stream, allocates nothing and does not
// synchronise.

#include "common.cuh"

namespace {

using edgegan::addr_of;
using edgegan::block_sum;
using edgegan::group_sums;
using edgegan::kThreads;
using edgegan::load_plane;
using edgegan::mask;
using edgegan::Pack;
using edgegan::Slot;
using edgegan::store;
using edgegan::to_f32;
using edgegan::unpack;
constexpr float kEps = 1e-5f;
constexpr int kMultiPass = 0, kLaneGroup = 1;

// K1's activation at y, and its derivative at y_pre times the cotangent:
// the cotangent where y_pre > 0, 0 (relu) or 0.2 times it (lrelu)
// elsewhere (pallas_kernels.py:94-102).
template <int kAct>
__device__ __forceinline__ float act_fwd(float y) {
  if (kAct == 1) return fmaxf(y, 0.f);
  if (kAct == 2) return fmaxf(y, 0.2f * y);
  return y;
}

template <int kAct>
__device__ __forceinline__ float act_bwd(float g, float y_pre) {
  if (kAct == 1) return y_pre > 0.f ? g : 0.f;
  if (kAct == 2) return y_pre > 0.f ? g : 0.2f * g;
  return g;
}

// ---------------------------------------------------------------------------
// Variant 0: multi-pass, one block per plane
// ---------------------------------------------------------------------------

template <typename T, int kAct>
__global__ void __launch_bounds__(kThreads)
instance_norm_act_fwd_multipass(const T* __restrict__ x, T* __restrict__ y,
                                int64_t planes, int64_t hw) {
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
    store(yp + i, act_fwd<kAct>((to_f32(xp[i]) - mean) / denom));
  }
}

template <typename T, int kAct>
__global__ void __launch_bounds__(kThreads)
instance_norm_act_bwd_multipass(const T* __restrict__ x,
                                const T* __restrict__ g, T* __restrict__ dx,
                                int64_t planes, int64_t hw) {
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

// ---------------------------------------------------------------------------
// Variant 1: the plane in registers, a lane group per plane
// ---------------------------------------------------------------------------

// The plane's statistics from this thread's share `c` (x in float32, 0
// outside the plane), in place: c becomes x - mean (0 outside the plane).
// Returns var.
template <int kG, int kV, int kN>
__device__ __forceinline__ float centre(float (&c)[kV][kN],
                                        const bool (&in)[kV], float n) {
  float s[1] = {0.f};
#pragma unroll
  for (int v = 0; v < kV; ++v) {
#pragma unroll
    for (int e = 0; e < kN; ++e) s[0] += c[v][e];
  }
  group_sums<kG>(s);
  const float mean = s[0] / n;
  float ss[1] = {0.f};
#pragma unroll
  for (int v = 0; v < kV; ++v) {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const float d = in[v] ? c[v][e] - mean : 0.f;
      c[v][e] = d;
      ss[0] += d * d;
    }
  }
  group_sums<kG>(ss);
  return ss[0] / n;
}

template <typename T, int kAct, int kG, int kV>
__global__ void __launch_bounds__(kThreads)
instance_norm_act_fwd_resident(const T* __restrict__ x, T* __restrict__ y,
                               int64_t planes, int64_t hw) {
  constexpr int kN = Pack<T>::kN;
  const Slot<kG> at(planes, hw);
  bool in[kV];
  mask(at, static_cast<int>(hw / kN), in);
  Pack<T> raw[kV];
  load_plane(x, at, in, raw);
  float c[kV][kN];
  unpack(raw, in, c);

  const float n = static_cast<float>(hw);
  const float var = centre<kG>(c, in, n);
  const float denom = var > 0.f ? sqrtf(var) + kEps : kEps;

  Pack<T>* yp = reinterpret_cast<Pack<T>*>(y + at.base);
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    if (!in[v]) continue;
    Pack<T> out;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      store(&out.v[e], act_fwd<kAct>(c[v][e] / denom));
    }
    yp[v * kG + at.lane] = out;
  }
}

template <typename T, int kAct, int kG, int kV>
__global__ void __launch_bounds__(kThreads)
instance_norm_act_bwd_resident(const T* __restrict__ x,
                               const T* __restrict__ g, T* __restrict__ dx,
                               int64_t planes, int64_t hw) {
  constexpr int kN = Pack<T>::kN;
  const Slot<kG> at(planes, hw);
  bool in[kV];
  mask(at, static_cast<int>(hw / kN), in);
  Pack<T> raw_x[kV], raw_g[kV];
  load_plane(x, at, in, raw_x);
  load_plane(g, at, in, raw_g);
  float c[kV][kN];
  unpack(raw_x, in, c);

  const float n = static_cast<float>(hw);
  const float var = centre<kG>(c, in, n);
  const bool nondeg = var > 0.f;
  const float sd = nondeg ? sqrtf(var) : 1.f;
  const float denom = nondeg ? sd + kEps : kEps;

  // c becomes y_pre, gp g' (both 0 outside the plane)
  float gp[kV][kN];
  unpack(raw_g, in, gp);
  float sums[2] = {0.f, 0.f};
#pragma unroll
  for (int v = 0; v < kV; ++v) {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const float yv = c[v][e] / denom;
      const float gv = act_bwd<kAct>(gp[v][e], yv);
      c[v][e] = yv;
      gp[v][e] = gv;
      sums[0] += gv;
      sums[1] += gv * yv;
    }
  }
  group_sums<kG>(sums);
  const float g_mean = sums[0] / n;
  const float gy_mean = sums[1] / n;

  Pack<T>* dxp = reinterpret_cast<Pack<T>*>(dx + at.base);
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    if (!in[v]) continue;
    Pack<T> out;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      store(&out.v[e],
            (gp[v][e] - g_mean) / denom - c[v][e] * gy_mean / sd);
    }
    dxp[v * kG + at.lane] = out;
  }
}

// ---------------------------------------------------------------------------
// Dispatch
// ---------------------------------------------------------------------------

template <typename T>
using FwdKernel = void (*)(const T*, T*, int64_t, int64_t);
template <typename T>
using BwdKernel = void (*)(const T*, const T*, T*, int64_t, int64_t);

// The (lanes, vectors) built for the lane-group kernels.
#define EDGEGAN_LANE_GROUP_SHAPES(X)                                       \
  X(4, 1) X(8, 1) X(16, 1) X(32, 1) X(32, 2) X(32, 4) X(32, 8)

template <typename T, int kAct>
FwdKernel<T> fwd_kernel(int variant, int lanes, int vectors) {
  if (variant == kMultiPass && lanes == kThreads && vectors == 0) {
    return instance_norm_act_fwd_multipass<T, kAct>;
  }
#define EDGEGAN_PICK(G, V)                                                 \
  if (variant == kLaneGroup && lanes == G && vectors == V) {               \
    return instance_norm_act_fwd_resident<T, kAct, G, V>;                  \
  }
  EDGEGAN_LANE_GROUP_SHAPES(EDGEGAN_PICK)
#undef EDGEGAN_PICK
  return nullptr;
}

template <typename T, int kAct>
BwdKernel<T> bwd_kernel(int variant, int lanes, int vectors) {
  if (variant == kMultiPass && lanes == kThreads && vectors == 0) {
    return instance_norm_act_bwd_multipass<T, kAct>;
  }
#define EDGEGAN_PICK(G, V)                                                 \
  if (variant == kLaneGroup && lanes == G && vectors == V) {               \
    return instance_norm_act_bwd_resident<T, kAct, G, V>;                  \
  }
  EDGEGAN_LANE_GROUP_SHAPES(EDGEGAN_PICK)
#undef EDGEGAN_PICK
  return nullptr;
}

template <typename T>
FwdKernel<T> pick_fwd(int act, int variant, int lanes, int vectors) {
  switch (act) {
    case 0: return fwd_kernel<T, 0>(variant, lanes, vectors);
    case 1: return fwd_kernel<T, 1>(variant, lanes, vectors);
    case 2: return fwd_kernel<T, 2>(variant, lanes, vectors);
  }
  return nullptr;
}

template <typename T>
BwdKernel<T> pick_bwd(int act, int variant, int lanes, int vectors) {
  switch (act) {
    case 0: return bwd_kernel<T, 0>(variant, lanes, vectors);
    case 1: return bwd_kernel<T, 1>(variant, lanes, vectors);
    case 2: return bwd_kernel<T, 2>(variant, lanes, vectors);
  }
  return nullptr;
}

bool bad_args(int64_t planes, int64_t hw, int dtype, int act) {
  return planes <= 0 || planes > 0x7fffffffLL || hw <= 0 || act < 0 ||
         act > 2 || (dtype != 0 && dtype != 1);
}

// Whether the variant can hold planes of hw elements at these addresses.
bool holds(int variant, int lanes, int vectors, int64_t hw, int dtype,
           uintptr_t addr) {
  return variant == kMultiPass ||
         edgegan::resident_holds(lanes, vectors, hw, dtype, addr);
}

// Blocks of kThreads for `planes` planes: one per plane (multi-pass), or
// one per kThreads / lanes planes (lane group).
unsigned grid_for(int variant, int lanes, int64_t planes) {
  const int64_t per_block = variant == kLaneGroup ? kThreads / lanes : 1;
  return static_cast<unsigned>((planes + per_block - 1) / per_block);
}

template <typename T>
int launch_fwd(const void* x, void* y, int64_t planes, int64_t hw, int act,
               int variant, int lanes, int vectors, cudaStream_t stream) {
  const FwdKernel<T> kernel = pick_fwd<T>(act, variant, lanes, vectors);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid_for(variant, lanes, planes), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), planes, hw);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* g, void* dx, int64_t planes,
               int64_t hw, int act, int variant, int lanes, int vectors,
               cudaStream_t stream) {
  const BwdKernel<T> kernel = pick_bwd<T>(act, variant, lanes, vectors);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid_for(variant, lanes, planes), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<T*>(dx), planes, hw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. act: 0 none, 1 relu, 2 lrelu(0.2).
// variant: 0 multi-pass (lanes 256, vectors 0), 1 lane group.
extern "C" int edgegan_instance_norm_act_fwd(const void* x, void* y,
                                             int64_t planes, int64_t hw,
                                             int dtype, int act, int variant,
                                             int lanes, int vectors,
                                             void* stream) {
  if (bad_args(planes, hw, dtype, act) ||
      !holds(variant, lanes, vectors, hw, dtype, addr_of(x) | addr_of(y))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_fwd<float>(x, y, planes, hw, act, variant, lanes,
                                 vectors, s)
             : launch_fwd<__nv_bfloat16>(x, y, planes, hw, act, variant,
                                         lanes, vectors, s);
}

// K2: dx from x and the cotangent g of K1's output, same shapes and dtype.
extern "C" int edgegan_instance_norm_act_bwd(const void* x, const void* g,
                                             void* dx, int64_t planes,
                                             int64_t hw, int dtype, int act,
                                             int variant, int lanes,
                                             int vectors, void* stream) {
  if (bad_args(planes, hw, dtype, act) ||
      !holds(variant, lanes, vectors, hw, dtype,
             addr_of(x) | addr_of(g) | addr_of(dx))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_bwd<float>(x, g, dx, planes, hw, act, variant, lanes,
                                 vectors, s)
             : launch_bwd<__nv_bfloat16>(x, g, dx, planes, hw, act, variant,
                                         lanes, vectors, s);
}

// What the compiler gave one kernel: out[0] registers per thread, out[1]
// local memory per thread in bytes (spills). bwd: 0 K1, 1 K2.
extern "C" int edgegan_instance_norm_act_attrs(int bwd, int dtype, int act,
                                               int variant, int lanes,
                                               int vectors, int* out) {
  if (act < 0 || act > 2 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fn =
      bwd ? (dtype == 0
                 ? reinterpret_cast<const void*>(
                       pick_bwd<float>(act, variant, lanes, vectors))
                 : reinterpret_cast<const void*>(pick_bwd<__nv_bfloat16>(
                       act, variant, lanes, vectors)))
          : (dtype == 0
                 ? reinterpret_cast<const void*>(
                       pick_fwd<float>(act, variant, lanes, vectors))
                 : reinterpret_cast<const void*>(pick_fwd<__nv_bfloat16>(
                       act, variant, lanes, vectors)));
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
