// Helpers shared by the port's kernels: float32 loads and stores of the
// two element types (float32, bfloat16), block-wide reductions, and the
// register-resident plane machinery of the lane-group, block and cluster
// variants (instance_norm_act.cu, mru_gate.cu).
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
// min and max that give NaN where either operand is NaN, as jnp.min and
// torch.amin do (fminf and fmaxf return the other operand)
struct MinNaN {
  __device__ __forceinline__ float operator()(float a, float b) const {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
  }
};
struct MaxNaN {
  __device__ __forceinline__ float operator()(float a, float b) const {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
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
// (kG = 4 to 32, several planes to a block), the whole block (kG =
// kThreads) or a cluster of kG / kThreads blocks on neighbouring SMs (kG =
// 2 to 8 x kThreads; launched with that cluster dimension). Each thread
// holds kV 16-byte vectors of the plane, neighbouring threads on
// neighbouring vectors.
// ---------------------------------------------------------------------------

// Floats of shared scratch that group_reduce needs for one reduction of kK
// values over kG lanes: none below a warp (1, as an array needs one), one
// per warp of the block, and kK more for the block's result where a
// cluster combines its blocks. A constant, not a constexpr function: nvcc
// refuses a host function's call in a __shared__ array's bound.
template <int kG, int kK>
struct GroupScratch {
  static constexpr int kSize =
      kG <= 32 ? 1 : (kThreads / 32 + (kG > kThreads ? 1 : 0)) * kK;
};

// Thread-block clusters (sm_90), in PTX: a barrier over every thread of
// the cluster that orders the shared-memory writes before it with the
// reads after it, and a read of the float at shared-memory address
// `addr` (this block's layout) in the block of cluster rank `rank`.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n\t"
      "barrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ float cluster_load(uint32_t addr, int rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// Combines `v` over the kG threads that own one plane with `op`; every one
// of them gets the results, bitwise the same. Within a warp, a butterfly
// of shuffles (it combines the same two partials at each step, in either
// order). A group wider than a warp then combines its warps' results
// through `scratch` (GroupScratch<kG, kK>::kSize floats, written once: a
// second reduction needs its own) in warp order, behind one barrier, so
// the whole block must call it. A cluster then combines its blocks'
// results: thread 0 of each block writes its block's to the end of
// `scratch`, the cluster synchronises, and every thread reads the kG /
// kThreads results from the blocks' shared memory (distributed shared
// memory) in rank order, so every block gets the same bits. No block may
// exit while another reads its scratch: the kernel ends its last round
// with cluster_arrive and cluster_wait.
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
    constexpr int kWarps = (kG < kThreads ? kG : kThreads) / 32;
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
  if constexpr (kG > kThreads) {
    constexpr int kBlocks = kG / kThreads;
    float* mine = scratch + kThreads / 32 * kK;
    if (threadIdx.x == 0) {
#pragma unroll
      for (int k = 0; k < kK; ++k) mine[k] = v[k];
    }
    cluster_sync();
    const uint32_t at =
        static_cast<uint32_t>(__cvta_generic_to_shared(mine));
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      float t = cluster_load(at + 4 * k, 0);
#pragma unroll
      for (int b = 1; b < kBlocks; ++b) {
        t = op(t, cluster_load(at + 4 * k, b));
      }
      v[k] = t;
    }
  }
}

// The split cluster barrier that ends a cluster kernel's reductions: every
// thread arrives after its last read of another block's scratch and waits
// before the block exits, with the output stores between. No-ops below a
// cluster.
template <int kG>
__device__ __forceinline__ void cluster_arrive() {
  if constexpr (kG > kThreads) {
    asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
  }
}

template <int kG>
__device__ __forceinline__ void cluster_wait() {
  if constexpr (kG > kThreads) {
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  }
}

template <int kG, int kK>
__device__ __forceinline__ void group_sums(float (&v)[kK],
                                           float* scratch = nullptr) {
  group_reduce<kG>(v, Sum(), scratch);
}

// Where a thread's share of a plane lies: the plane's offset, the thread's
// place in its group, and whether the plane exists (the last block of the
// grid may hold fewer planes than it has room for). In a cluster, block b
// of the plane's kG / kThreads consecutive blocks holds lanes b * kThreads
// to b * kThreads + kThreads - 1.
template <int kG>
struct Slot {
  int64_t base;
  int lane;
  bool valid;

  __device__ __forceinline__ Slot(int64_t planes, int64_t hw) {
    int64_t plane;
    if constexpr (kG > kThreads) {
      constexpr int kBlocks = kG / kThreads;
      plane = blockIdx.x / kBlocks;
      lane = static_cast<int>(blockIdx.x % kBlocks) * kThreads + threadIdx.x;
    } else {
      plane = static_cast<int64_t>(blockIdx.x) * (kThreads / kG) +
              threadIdx.x / kG;
      lane = threadIdx.x % kG;
    }
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
