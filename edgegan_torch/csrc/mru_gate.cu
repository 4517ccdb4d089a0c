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
// Bound: bytes. K3 reads rg, ht, img and writes out: 4 * n * itemsize;
// K4 reads rg, img, g and writes drg, dimg: 5 * n * itemsize. The
// classifier's four gates at batch 64 ([64,8,64,64], [64,128,32,32],
// [64,256,16,16], [64,512,8,8]: planes of 4096, 1024, 256 and 64
// elements) hold 16,777,216 elements, so a training step's 12 calls of
// each (3 classifier passes) move 0.81 GB (K3) and 1.01 GB (K4) in
// float32: 0.24 and 0.30 ms at 3.35 TB/s; half that in bfloat16.
//
// Layout: contiguous NCHW, so each plane is one run of H*W elements. The
// TPU kernels hold one batch row [H*W, C] in VMEM. Here the plane is held
// in registers, read from device memory once, and its min, max and sums
// are taken from there (common.cuh). Four variants, picked by the caller
// (`gate_plan` in ops/kernels.py) and checked here:
//   1 lane group: a group of `lanes` threads (4 to 32, a power of two)
//     owns one plane, several planes to a 256-thread block, so the
//     64-element planes of the last unit do not leave most of a block
//     idle. Each thread issues all its 16-byte vector loads (1 to 8 of
//     each input) before the first use. Min and max come in one round of
//     __shfl_xor_sync within the group (max as the min of -rg); K4 then
//     takes its five sums (sum(drgn*(rg - mx)), sum(drgn*rgn), sum(drgn),
//     nmin, nmax) in one more. No shared memory, no barrier. Up to 1024
//     float32 or 2048 bfloat16 elements a plane: units 2 to 4.
//   2 block: the whole block owns one plane, 2 or 4 vectors a thread, up
//     to 4096 float32 or 8192 bfloat16 elements: unit 1. Each round adds
//     one combine of the 8 warps' results through shared memory, behind
//     one barrier.
//   4 cluster: a thread-block cluster of kC = 2 to 8 blocks on
//     neighbouring SMs owns one plane, each block holding its share as
//     the block variant holds its largest planes (4 vectors a thread), up
//     to
//     8 x 256 x 4 vectors: 32768 float32 or 65536 bfloat16 elements; the
//     hires configuration's unit 1 (16384 elements). Each round adds a
//     combine of the kC blocks' results, read from their shared memory
//     (distributed shared memory) after a cluster barrier, in rank order;
//     a split cluster barrier around the last output stores keeps every
//     block resident until the others have read it. Launched with
//     cudaLaunchKernelEx and the cluster dimension.
//   0 multi-pass: one block of 32 to 256 threads walks the plane, once
//     for the min and max and once more for each output pass (K4 three),
//     re-reading it from L1/L2. It takes any H*W at any alignment: planes
//     beyond a cluster's reach, H*W not a multiple of the vector width,
//     and a base pointer not on 16 bytes.
// The min and max give NaN on a plane that holds one, as jnp.min does
// (min.NaN / max.NaN, not fminf): the output is then NaN over the plane,
// and drg, whose tie shares are added by selection (`if (x == mn)`), is
// what the Pallas kernel gives.
// Register pressure is the trap: at 32 lanes x 8 vectors a thread holds
// three inputs of 32 floats (K4: 128 registers, 2 blocks an SM). bfloat16
// inputs stay packed in their vectors and are widened on use (`widen`),
// and no variant spills or keeps a stack frame.
// Sums and products are rounded as the plain version rounds them
// (`__fmul_rn`/`__fadd_rn` where a fused multiply-add would round once),
// a division stays a division, and every sum is taken in a fixed order
// (no atomics), so a run gives the same bits every time.
//
// Plain C interface (loaded with ctypes): each entry point returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue, without
// launching, for a variant it has no kernel for or that cannot hold the
// plane. Launches on the caller's stream, allocates nothing and does not
// synchronise.

#include <math.h>

#include "common.cuh"

namespace {

using edgegan::addr_of;
using edgegan::block_reduce;
using edgegan::block_sum;
using edgegan::cluster_arrive;
using edgegan::cluster_wait;
using edgegan::group_reduce;
using edgegan::GroupScratch;
using edgegan::group_sums;
using edgegan::kThreads;
using edgegan::load_plane;
using edgegan::mask;
using edgegan::MaxNaN;
using edgegan::MinNaN;
using edgegan::Pack;
using edgegan::Slot;
using edgegan::store;
using edgegan::to_f32;

constexpr int kMultiPass = 0, kLaneGroup = 1, kBlock = 2, kCluster = 4;

// ---------------------------------------------------------------------------
// Variant 0: multi-pass, one block per plane
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void plane_min_max(const T* p, int64_t hw,
                                              float* scratch, float& mn,
                                              float& mx) {
  float lo = INFINITY, hi = -INFINITY;
  for (int64_t i = threadIdx.x; i < hw; i += blockDim.x) {
    const float v = to_f32(p[i]);
    lo = MinNaN()(lo, v);
    hi = MaxNaN()(hi, v);
  }
  mn = block_reduce(lo, scratch, MinNaN());
  mx = block_reduce(hi, scratch, MaxNaN());
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mru_gate_fwd_multipass(const T* __restrict__ rg, const T* __restrict__ ht,
                       const T* __restrict__ img, T* __restrict__ out,
                       int64_t planes, int64_t hw) {
  __shared__ float scratch[kThreads / 32];
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
__global__ void __launch_bounds__(kThreads)
mru_gate_bwd_multipass(const T* __restrict__ rg, const T* __restrict__ img,
                       const T* __restrict__ g, T* __restrict__ drg,
                       T* __restrict__ dimg, int64_t planes, int64_t hw) {
  __shared__ float scratch[kThreads / 32];
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
  while (threads < kThreads && threads * 8 < hw) threads *= 2;
  return threads;
}

// ---------------------------------------------------------------------------
// Variants 1 and 2: the plane in registers, kG threads per plane
// ---------------------------------------------------------------------------

// Element e of a held 16-byte vector of T, in float32. The vectors are
// held as raw words, and a bfloat16 word is widened at each use by a bit
// operation the compiler cannot hoist: left to itself it widens all three
// inputs as they land, and K4 at 32 lanes x 4 vectors then needs 128
// registers and spills; held packed it takes 82.
__device__ __forceinline__ uint32_t word(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

template <typename T>
__device__ __forceinline__ float widen(const uint4& q, int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(word(q, e));
  } else {
    const uint32_t w = word(q, e >> 1);
    uint32_t r;
    if (e & 1) {
      asm volatile("and.b32 %0, %1, 0xffff0000;" : "=r"(r) : "r"(w));
    } else {
      asm volatile("shl.b32 %0, %1, 16;" : "=r"(r) : "r"(w));
    }
    return __uint_as_float(r);
  }
}

// min and max of rg over the plane the group holds, every lane getting
// the same bits, NaN where the plane holds a NaN; vectors outside the
// plane take no part (+INF for the min, -INF for the max).
template <typename T, int kG, int kV>
__device__ __forceinline__ void group_min_max(const uint4 (&rg)[kV],
                                              const bool (&in)[kV],
                                              float* scratch, float& mn,
                                              float& mx) {
  float ext[2] = {INFINITY, INFINITY};  // min of rg, min of -rg
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    if (!in[v]) continue;
#pragma unroll
    for (int e = 0; e < Pack<T>::kN; ++e) {
      const float x = widen<T>(rg[v], e);
      ext[0] = MinNaN()(ext[0], x);
      ext[1] = MinNaN()(ext[1], -x);
    }
  }
  group_reduce<kG>(ext, MinNaN(), scratch);
  mn = ext[0];
  mx = -ext[1];
}

template <typename T, int kG, int kV>
__global__ void __launch_bounds__(kThreads)
mru_gate_fwd_resident(const T* __restrict__ rg, const T* __restrict__ ht,
                      const T* __restrict__ img, T* __restrict__ out,
                      int64_t planes, int64_t hw) {
  constexpr int kN = Pack<T>::kN;
  // shared memory only for the cross-warp (and cross-block) combines
  __shared__ float scratch[GroupScratch<kG, 2>::kSize];
  const Slot<kG> at(planes, hw);
  bool in[kV];
  mask(at, static_cast<int>(hw / kN), in);
  uint4 r_rg[kV], r_ht[kV], r_img[kV];
  load_plane(rg, at, in, r_rg);
  load_plane(ht, at, in, r_ht);
  load_plane(img, at, in, r_img);

  float mn, mx;
  group_min_max<T, kG>(r_rg, in, scratch, mn, mx);
  const float r = mx - mn;
  const float den = r > 0.f ? r : 1.f;
  cluster_arrive<kG>();

  Pack<T>* outp = reinterpret_cast<Pack<T>*>(out + at.base);
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    if (!in[v]) continue;
    Pack<T> o;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const float rgn = (widen<T>(r_rg[v], e) - mn) / den;
      store(&o.v[e], __fadd_rn(widen<T>(r_ht[v], e),
                               __fmul_rn(rgn, widen<T>(r_img[v], e))));
    }
    outp[v * kG + at.lane] = o;
  }
  cluster_wait<kG>();
}

// At least one block an SM, said outright: left to choose, ptxas holds
// K4 in bfloat16 at 32 lanes x 4 vectors to 80 registers (3 blocks an SM)
// with a 16-byte stack frame; told one block is enough, it takes 82 and
// none.
template <typename T, int kG, int kV>
__global__ void __launch_bounds__(kThreads, 1)
mru_gate_bwd_resident(const T* __restrict__ rg, const T* __restrict__ img,
                      const T* __restrict__ g, T* __restrict__ drg,
                      T* __restrict__ dimg, int64_t planes, int64_t hw) {
  constexpr int kN = Pack<T>::kN;
  __shared__ float scratch_mm[GroupScratch<kG, 2>::kSize];
  __shared__ float scratch_s[GroupScratch<kG, 5>::kSize];
  const Slot<kG> at(planes, hw);
  bool in[kV];
  mask(at, static_cast<int>(hw / kN), in);
  uint4 r_rg[kV], r_img[kV], r_g[kV];
  load_plane(rg, at, in, r_rg);
  load_plane(img, at, in, r_img);
  load_plane(g, at, in, r_g);

  float mn, mx;
  group_min_max<T, kG>(r_rg, in, scratch_mm, mn, mx);
  const float r = mx - mn;
  const bool pos = r > 0.f;
  const float den = pos ? r : 1.f;

  // dimg, written as soon as rgn is known (g is not needed after it), and
  // the plane's sums: sum(drgn*(rg - mx)), sum(drgn*rgn), sum(drgn), nmin,
  // nmax
  float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  Pack<T>* dimgp = reinterpret_cast<Pack<T>*>(dimg + at.base);
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    if (!in[v]) continue;
    Pack<T> o;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const float x = widen<T>(r_rg[v], e);
      const float gv = widen<T>(r_g[v], e);
      const float rgn = (x - mn) / den;
      store(&o.v[e], gv * rgn);
      const float drgn = gv * widen<T>(r_img[v], e);
      s[0] += drgn * (x - mx);
      s[1] += drgn * rgn;
      s[2] += drgn;
      s[3] += x == mn ? 1.f : 0.f;
      s[4] += x == mx ? 1.f : 0.f;
    }
    dimgp[v * kG + at.lane] = o;
  }
  group_sums<kG>(s, scratch_s);
  const float d_min = pos ? s[0] / (r * r) : -s[2];
  const float d_max = pos ? -s[1] / den : 0.f;
  const float q_min = d_min / s[3];
  const float q_max = d_max / s[4];
  cluster_arrive<kG>();

  Pack<T>* drgp = reinterpret_cast<Pack<T>*>(drg + at.base);
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    if (!in[v]) continue;
    Pack<T> o;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const float x = widen<T>(r_rg[v], e);
      float d =
          __fmul_rn(widen<T>(r_g[v], e), widen<T>(r_img[v], e)) / den;
      if (x == mn) d = __fadd_rn(d, q_min);
      if (x == mx) d = __fadd_rn(d, q_max);
      store(&o.v[e], d);
    }
    drgp[v * kG + at.lane] = o;
  }
  cluster_wait<kG>();
}

// ---------------------------------------------------------------------------
// Dispatch
// ---------------------------------------------------------------------------

template <typename T>
using FwdKernel = void (*)(const T*, const T*, const T*, T*, int64_t,
                           int64_t);
template <typename T>
using BwdKernel = void (*)(const T*, const T*, const T*, T*, T*, int64_t,
                           int64_t);

// The (variant, lanes, vectors) built for the register-resident kernels;
// a cluster's lanes are kC x kThreads.
#define EDGEGAN_GATE_SHAPES(X)                                             \
  X(kLaneGroup, 4, 1) X(kLaneGroup, 8, 1) X(kLaneGroup, 16, 1)             \
  X(kLaneGroup, 32, 1) X(kLaneGroup, 32, 2) X(kLaneGroup, 32, 4)           \
  X(kLaneGroup, 32, 8) X(kBlock, 256, 2) X(kBlock, 256, 4)                 \
  X(kCluster, 512, 4) X(kCluster, 1024, 4) X(kCluster, 2048, 4)

template <typename T>
FwdKernel<T> pick_fwd(int variant, int lanes, int vectors) {
  if (variant == kMultiPass && lanes == kThreads && vectors == 0) {
    return mru_gate_fwd_multipass<T>;
  }
#define EDGEGAN_PICK(P, G, V)                                              \
  if (variant == P && lanes == G && vectors == V) {                        \
    return mru_gate_fwd_resident<T, G, V>;                                 \
  }
  EDGEGAN_GATE_SHAPES(EDGEGAN_PICK)
#undef EDGEGAN_PICK
  return nullptr;
}

template <typename T>
BwdKernel<T> pick_bwd(int variant, int lanes, int vectors) {
  if (variant == kMultiPass && lanes == kThreads && vectors == 0) {
    return mru_gate_bwd_multipass<T>;
  }
#define EDGEGAN_PICK(P, G, V)                                              \
  if (variant == P && lanes == G && vectors == V) {                        \
    return mru_gate_bwd_resident<T, G, V>;                                 \
  }
  EDGEGAN_GATE_SHAPES(EDGEGAN_PICK)
#undef EDGEGAN_PICK
  return nullptr;
}

bool bad_args(int64_t planes, int64_t hw, int dtype) {
  return planes <= 0 || planes > 0x7fffffffLL || hw <= 0 ||
         (dtype != 0 && dtype != 1);
}

// Blocks in one cluster: lanes / kThreads for the cluster variant, else
// 1 (no cluster).
int cluster_blocks(int variant, int lanes) {
  return variant == kCluster ? lanes / kThreads : 1;
}

bool holds(int variant, int lanes, int vectors, int64_t hw, int dtype,
           int64_t planes, uintptr_t addr) {
  if (variant == kMultiPass) return true;
  // a cluster launches planes x kC blocks, at most 2^31 - 1 of them
  const int blocks = cluster_blocks(variant, lanes);
  return blocks > 0 && planes <= 0x7fffffffLL / blocks &&
         edgegan::resident_holds(lanes, vectors, hw, dtype, addr);
}

// (blocks, threads) for `planes` planes: one block of threads_for(hw)
// per plane (multi-pass), kC blocks of kThreads per plane (cluster), or
// blocks of kThreads holding kThreads / lanes planes each.
dim3 grid_for(int variant, int lanes, int64_t planes) {
  if (variant == kCluster) {
    return dim3(static_cast<unsigned>(planes * cluster_blocks(variant,
                                                              lanes)));
  }
  const int64_t per_block = variant == kMultiPass ? 1 : kThreads / lanes;
  return dim3(static_cast<unsigned>((planes + per_block - 1) / per_block));
}

int threads(int variant, int64_t hw) {
  return variant == kMultiPass ? threads_for(hw) : kThreads;
}

// The launch configuration of `planes` planes on `stream`, with the
// cluster dimension where the variant is a cluster; `attr` must outlive
// the launch call.
cudaLaunchConfig_t launch_config(int variant, int lanes, int64_t planes,
                                 int64_t hw, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid_for(variant, lanes, planes);
  config.blockDim = dim3(threads(variant, hw));
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster_blocks(variant, lanes);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = variant == kCluster ? 1 : 0;
  return config;
}

template <typename T>
int launch_fwd(const void* rg, const void* ht, const void* img, void* out,
               int64_t planes, int64_t hw, int variant, int lanes,
               int vectors, cudaStream_t stream) {
  const FwdKernel<T> kernel = pick_fwd<T>(variant, lanes, vectors);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config =
      launch_config(variant, lanes, planes, hw, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const T*>(rg), static_cast<const T*>(ht),
      static_cast<const T*>(img), static_cast<T*>(out), planes, hw);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* rg, const void* img, const void* g, void* drg,
               void* dimg, int64_t planes, int64_t hw, int variant,
               int lanes, int vectors, cudaStream_t stream) {
  const BwdKernel<T> kernel = pick_bwd<T>(variant, lanes, vectors);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config =
      launch_config(variant, lanes, planes, hw, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const T*>(rg), static_cast<const T*>(img),
      static_cast<const T*>(g), static_cast<T*>(drg), static_cast<T*>(dimg),
      planes, hw);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3. dtype: 0 float32, 1 bfloat16; rg, ht, img and out of one shape.
// variant: 0 multi-pass (lanes 256, vectors 0), 1 lane group, 2 block,
// 4 cluster (lanes kC x 256).
extern "C" int edgegan_mru_gate_fwd(const void* rg, const void* ht,
                                    const void* img, void* out,
                                    int64_t planes, int64_t hw, int dtype,
                                    int variant, int lanes, int vectors,
                                    void* stream) {
  if (bad_args(planes, hw, dtype) ||
      !holds(variant, lanes, vectors, hw, dtype, planes,
             addr_of(rg) | addr_of(ht) | addr_of(img) | addr_of(out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_fwd<float>(rg, ht, img, out, planes, hw, variant,
                                 lanes, vectors, s)
             : launch_fwd<__nv_bfloat16>(rg, ht, img, out, planes, hw,
                                         variant, lanes, vectors, s);
}

// K4: drg and dimg from rg, img and the cotangent g of K3's output.
extern "C" int edgegan_mru_gate_bwd(const void* rg, const void* img,
                                    const void* g, void* drg, void* dimg,
                                    int64_t planes, int64_t hw, int dtype,
                                    int variant, int lanes, int vectors,
                                    void* stream) {
  if (bad_args(planes, hw, dtype) ||
      !holds(variant, lanes, vectors, hw, dtype, planes,
             addr_of(rg) | addr_of(img) | addr_of(g) | addr_of(drg) |
                 addr_of(dimg))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_bwd<float>(rg, img, g, drg, dimg, planes, hw, variant,
                                 lanes, vectors, s)
             : launch_bwd<__nv_bfloat16>(rg, img, g, drg, dimg, planes, hw,
                                         variant, lanes, vectors, s);
}

// What the compiler gave one kernel: out[0] registers per thread, out[1]
// local memory per thread in bytes (spills), and out[2], for the cluster
// variant, the clusters of its size that can be resident on the card at
// once (cudaOccupancyMaxActiveClusters; 0 for the other variants).
// bwd: 0 K3, 1 K4.
extern "C" int edgegan_mru_gate_attrs(int bwd, int dtype, int variant,
                                      int lanes, int vectors, int* out) {
  if (dtype != 0 && dtype != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fn =
      bwd ? (dtype == 0 ? reinterpret_cast<const void*>(
                              pick_bwd<float>(variant, lanes, vectors))
                        : reinterpret_cast<const void*>(
                              pick_bwd<__nv_bfloat16>(variant, lanes,
                                                      vectors)))
          : (dtype == 0 ? reinterpret_cast<const void*>(
                              pick_fwd<float>(variant, lanes, vectors))
                        : reinterpret_cast<const void*>(
                              pick_fwd<__nv_bfloat16>(variant, lanes,
                                                      vectors)));
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = 0;
  if (variant == kCluster) {
    cudaLaunchAttribute cattr;
    const cudaLaunchConfig_t config =
        launch_config(variant, lanes, 1024, 1, nullptr, &cattr);
    const cudaError_t cerr =
        cudaOccupancyMaxActiveClusters(&out[2], fn, &config);
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
  }
  return 0;
}
