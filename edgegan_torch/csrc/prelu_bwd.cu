// PReLU backward in one pass (K5), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel edgegan_tpu/ops/pallas_kernels.py:196-209
// (`_prelu_bwd_kernel`, launched by `_prelu_bwd`, l.247-274). The forward
// is `max(leak*x, x)` with a learnable float32 scalar leak; its backward,
// for the cotangent g, in float32 with the float32 leak:
//   u     = leak * x
//   s_u   = 1 where u > x, 0.5 where u == x (the tie of jnp.maximum's and
//           torch.maximum's VJP), 0 elsewhere
//   dx    = g * (s_u * leak + (1 - s_u))           stored in x's dtype
//   dleak = sum over every element of g * s_u * x   (float32)
// In bfloat16 s_u is decided on f32(leak) * f32(x), as the TPU kernel does,
// while the forward multiplied by bf16(leak).
//
// Design: a grid-stride pass over the flat tensor, 16-byte vector loads
// where the three pointers allow it. Each block writes one float32 partial
// of dleak; a second launch of one block sums the partials in a fixed
// order. No float atomics, so dleak comes out the same on every run (the
// training step amplifies rounding). The grid is at most `partials_len`
// blocks (1056 = 8 per SM from the wrapper), fixed for a given size.
//
// Bound: bytes. Reads x and g, writes dx: 3 * n * itemsize over 3.35 TB/s.
// The classifier's 14 PReLUs at batch 64 hold 98,304,000 elements, so the
// 42 calls of a training step (3 classifier backwards) move 3.54 GB in
// float32 (1.06 ms) and 1.77 GB in bfloat16 (0.53 ms). About 8 float32
// operations per element put the operation bound 20x lower.
//
// Plain C interface (loaded with ctypes): returns cudaGetLastError() after
// the launches. Launches on the caller's stream, allocates nothing and does
// not synchronise.

#include "common.cuh"

namespace {

using edgegan::block_sum;
using edgegan::Pack;
using edgegan::store;
using edgegan::to_f32;

constexpr int kThreads = 256;

// dx of one element; adds its dleak term to `acc`.
__device__ __forceinline__ float prelu_dx(float x, float g, float leak,
                                          float& acc) {
  const float u = leak * x;
  const float s_u = u > x ? 1.f : (u == x ? 0.5f : 0.f);
  acc += g * s_u * x;
  return g * (s_u * leak + (1.f - s_u));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
prelu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 const float* __restrict__ leak_p, T* __restrict__ dx,
                 float* __restrict__ partials, int64_t n, bool vec) {
  __shared__ float scratch[kThreads / 32];
  const float leak = *leak_p;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  float acc = 0.f;
  int64_t tail = 0;
  if (vec) {
    constexpr int kN = Pack<T>::kN;
    const int64_t n_packs = n / kN;
    const Pack<T>* xp = reinterpret_cast<const Pack<T>*>(x);
    const Pack<T>* gp = reinterpret_cast<const Pack<T>*>(g);
    Pack<T>* dxp = reinterpret_cast<Pack<T>*>(dx);
    for (int64_t i = start; i < n_packs; i += stride) {
      const Pack<T> xv = xp[i];
      const Pack<T> gv = gp[i];
      Pack<T> out;
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        store(&out.v[k],
              prelu_dx(to_f32(xv.v[k]), to_f32(gv.v[k]), leak, acc));
      }
      dxp[i] = out;
    }
    tail = n_packs * kN;
  }
  for (int64_t i = tail + start; i < n; i += stride) {
    store(dx + i, prelu_dx(to_f32(x[i]), to_f32(g[i]), leak, acc));
  }
  const float total = block_sum(acc, scratch);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
sum_partials(const float* __restrict__ partials, int n,
             float* __restrict__ out) {
  __shared__ float scratch[kThreads / 32];
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s += partials[i];
  const float total = block_sum(s, scratch);
  if (threadIdx.x == 0) *out = total;
}

template <typename T>
void launch(const void* x, const void* g, const void* leak, void* dx,
            void* dleak, void* partials, int64_t n, int partials_len,
            cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(dx);
  const bool vec = addr % 16 == 0;
  // four 16-byte packs per thread before the grid is at its cap
  const int64_t per_block = static_cast<int64_t>(kThreads) * 4 *
                            Pack<T>::kN;
  int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks > partials_len) blocks = partials_len;
  const int grid = static_cast<int>(blocks);
  prelu_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const float*>(leak), static_cast<T*>(dx),
      static_cast<float*>(partials), n, vec);
  sum_partials<<<1, kThreads, 0, stream>>>(static_cast<float*>(partials),
                                           grid, static_cast<float*>(dleak));
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, g and dx); leak, dleak and the
// `partials_len` floats of scratch are float32.
extern "C" int edgegan_prelu_bwd(const void* x, const void* g,
                                 const void* leak, void* dx, void* dleak,
                                 void* partials, int64_t n, int partials_len,
                                 int dtype, void* stream) {
  if (n <= 0 || partials_len <= 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, g, leak, dx, dleak, partials, n, partials_len, s);
  } else {
    launch<__nv_bfloat16>(x, g, leak, dx, dleak, partials, n, partials_len,
                          s);
  }
  return static_cast<int>(cudaGetLastError());
}
