// Helpers shared by the port's kernels: float32 loads and stores of the
// two element types (float32, bfloat16), block-wide reductions, and the
// register-resident plane machinery of the lane-group and block variants
// (instance_norm_act.cu, mru_gate.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace edgegan {

// Threads in a block of the register-resident variants
constexpr int kThreads = 256;

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

// ---------------------------------------------------------------------------
// A plane held in registers by the kG threads that own it: a lane group
// (kG = 4 to 32, several planes to a block) or the whole block (kG =
// kThreads). Each thread holds kV 16-byte vectors of the plane,
// neighbouring threads on neighbouring vectors.
// ---------------------------------------------------------------------------

// Combines `v` over the kG threads that own one plane with `op`; every one
// of them gets the results, bitwise the same. Within a warp, a butterfly
// of shuffles (it combines the same two partials at each step, in either
// order). A group wider than a warp then combines its warps' results
// through `scratch` (kThreads / 32 * kK floats, written once: a second
// reduction needs its own) in warp order, behind one barrier, so the
// whole block must call it.
template <int kG, int kK, typename Op>
__device__ __forceinline__ void group_reduce(float (&v)[kK], Op op,
                                             float* scratch) {
  constexpr int kWidth = kG < 32 ? kG : 32;
#pragma unroll
  for (int off = kWidth / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      v[k] = op(v[k], __shfl_xor_sync(0xffffffffu, v[k], off, kWidth));
    }
  }
  if constexpr (kG > 32) {
    constexpr int kWarps = kG / 32;
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int k = 0; k < kK; ++k) scratch[warp * kK + k] = v[k];
    }
    __syncthreads();
    const float* first = scratch + (warp - warp % kWarps) * kK;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      float t = first[k];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) t = op(t, first[w * kK + k]);
      v[k] = t;
    }
  }
}

template <int kG, int kK>
__device__ __forceinline__ void group_sums(float (&v)[kK],
                                           float* scratch = nullptr) {
  group_reduce<kG>(v, Sum(), scratch);
}

// Where a thread's share of a plane lies: the plane's offset, the thread's
// place in its group, and whether the plane exists (the last block of the
// grid may hold fewer planes than it has room for).
template <int kG>
struct Slot {
  int64_t base;
  int lane;
  bool valid;

  __device__ __forceinline__ Slot(int64_t planes, int64_t hw) {
    const int64_t plane =
        static_cast<int64_t>(blockIdx.x) * (kThreads / kG) + threadIdx.x / kG;
    lane = threadIdx.x % kG;
    valid = plane < planes;
    base = valid ? plane * hw : 0;
  }
};

// Which of this thread's kV vectors lie in its plane of nvec vectors.
template <int kG, int kV>
__device__ __forceinline__ void mask(const Slot<kG>& at, int nvec,
                                     bool (&in)[kV]) {
#pragma unroll
  for (int v = 0; v < kV; ++v) in[v] = at.valid && v * kG + at.lane < nvec;
}

// Loads this thread's kV vectors of the plane at p into 16-byte registers
// of type R (a Pack<T>, or uint4 to hold them as raw words), all issued
// before any is used; vectors outside the plane are left unread.
template <typename T, typename R, int kG, int kV>
__device__ __forceinline__ void load_plane(const T* p, const Slot<kG>& at,
                                           const bool (&in)[kV],
                                           R (&r)[kV]) {
  static_assert(sizeof(R) == 16, "one 16-byte vector a register slot");
  const R* vp = reinterpret_cast<const R*>(p + at.base);
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    if (in[v]) r[v] = vp[v * kG + at.lane];
  }
}

template <typename T, int kV, int kN>
__device__ __forceinline__ void unpack(const Pack<T> (&r)[kV],
                                       const bool (&in)[kV],
                                       float (&f)[kV][kN]) {
#pragma unroll
  for (int v = 0; v < kV; ++v) {
#pragma unroll
    for (int e = 0; e < kN; ++e) f[v][e] = in[v] ? to_f32(r[v].v[e]) : 0.f;
  }
}

// Whether a register-resident variant of (lanes, vectors) holds planes of
// hw elements at these addresses (all pointers OR-ed together): whole
// 16-byte vectors, each plane starting on 16 bytes, at most lanes *
// vectors of them. dtype: 0 float32, 1 bfloat16.
inline bool resident_holds(int lanes, int vectors, int64_t hw, int dtype,
                           uintptr_t addr) {
  const int per_vector = dtype == 0 ? Pack<float>::kN
                                    : Pack<__nv_bfloat16>::kN;
  return addr % 16 == 0 && hw % per_vector == 0 &&
         hw / per_vector <= static_cast<int64_t>(lanes) * vectors;
}

inline uintptr_t addr_of(const void* p) {
  return reinterpret_cast<uintptr_t>(p);
}

}  // namespace edgegan
