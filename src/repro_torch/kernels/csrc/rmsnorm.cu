// Row RMSNorm: out = x * rsqrt(mean(x^2) + eps) * gamma, each row read once
// and held in registers.
//
// Replaces: src/repro/kernels/rmsnorm.py, rmsnorm_kernel (body
// _rmsnorm_kernel), the fused TPU norm of the transformer stack.
//
// What it computes: x is (rows, D) float32 or bfloat16, gamma (D,)
// float32; the mean square, the rsqrt and the gain are taken in float32
// and the result is cast back to x's type, as the reference does.
//
// Design. The TPU kernel normalises a (256, D) block of rows per grid
// step, all of it in VMEM. Here a row is cut into units (16-byte vectors,
// 8 bf16 or 4 float32, or single values when D is not a multiple of the
// vector) and spread over a group of `wpr` warps; thread i of the group
// holds units i, i + 32 wpr, ... (VPT of them, a compile-time count, so
// neighbouring threads read neighbouring addresses). Each thread issues
// all of its loads before it uses any, keeps them in registers, takes its
// sum of squares, and the row's sum goes through a warp shuffle and, for
// a group of several warps, one shared-memory step. The same registers
// are then scaled by the gain (read in 16-byte loads) and written: x is
// read once, out written once. A block holds `rpb` rows; the host's plan
// (kernels/rmsnorm.py, rmsnorm_plan) picks VPT, wpr and rpb by shape so
// that the units divide evenly at the serve paths' widths (5120, 2560,
// 1536, 768): few rows spread each row over more threads (decode), many
// rows give each thread more units and put several rows in a block
// (prefill). Any other D takes the same kernel with the ragged units
// masked.
//
// What bounds it on this card: bytes. At the serve path's prefill shape
// (8192 rows of 5120 bf16) it reads and writes 168 MB for 4 float ops
// per element, so HBM at 3.35 TB/s sets ~50 us; at decode (8 rows) the
// latency of one load and one store per thread and the launch itself are
// the bound.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 bytes of T
template <typename T> struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

// One unit of a row: a 16-byte vector, or one value
template <typename T, bool kVec> struct UnitOf {
  using type = Vec<T>;
  static constexpr int N = Vec<T>::N;
  __device__ static float get(const type& u, int j) { return to_f32(u.v[j]); }
  __device__ static void set(type& u, int j, float f) {
    u.v[j] = from_f32<T>(f);
  }
};
template <typename T> struct UnitOf<T, false> {
  using type = T;
  static constexpr int N = 1;
  __device__ static float get(const type& u, int) { return to_f32(u); }
  __device__ static void set(type& u, int, float f) { u = from_f32<T>(f); }
};

// The gain of unit u's N values, from 16-byte loads where N is a multiple
// of 4 (gamma is 16-byte aligned on that path, which the wrapper checks)
template <int N>
__device__ __forceinline__ void load_gain(const float* __restrict__ gamma,
                                          int u, float (&g)[N]) {
  if constexpr (N % 4 == 0) {
    const float4* g4 = reinterpret_cast<const float4*>(gamma) + u * (N / 4);
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float4 q = __ldg(g4 + j);
      g[4 * j] = q.x;
      g[4 * j + 1] = q.y;
      g[4 * j + 2] = q.z;
      g[4 * j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) g[j] = __ldg(gamma + u * N + j);
  }
}

// Threads per block an instance takes: its units' registers (4 a vector,
// 1 a value) bound how many threads the register file holds
// (kernels/rmsnorm.py: max_threads)
__host__ __device__ constexpr int max_threads(bool vec, int vpt) {
  return (vec ? 4 : 1) * vpt <= 16 ? 1024
         : (vec ? 4 : 1) * vpt <= 40 ? 512 : 256;
}

template <typename T, bool kVec, int VPT>
__global__ void __launch_bounds__(max_threads(kVec, VPT))
rmsnorm_rows(const T* __restrict__ x, const float* __restrict__ gamma,
             T* __restrict__ out, int rows, int D, int wpr, float eps) {
  using Unit = UnitOf<T, kVec>;
  using U = typename Unit::type;
  constexpr int N = Unit::N;
  __shared__ float red[32];
  const int group_threads = 32 * wpr;
  const int group = threadIdx.x / group_threads;
  const int lane = threadIdx.x % group_threads;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / group_threads) + group;
  const bool live = row < rows;
  const int units = kVec ? D / N : D;
  const U* src = reinterpret_cast<const U*>(x + row * D);
  U* dst = reinterpret_cast<U*>(out + row * D);

  // the only read of x: every unit of this thread, all loads in flight
  U v[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int u = lane + k * group_threads;
    if (live && u < units) v[k] = src[u];
  }
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    if (live && lane + k * group_threads < units) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float f = Unit::get(v[k], j);
        ss = fmaf(f, f, ss);
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (wpr > 1) {  // the group's warps, summed in warp order
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = ss;
    __syncthreads();
    ss = 0.0f;
    for (int w = 0; w < wpr; ++w) ss += red[group * wpr + w];
  }
  if (!live) return;
  const float r = rsqrtf(ss / static_cast<float>(D) + eps);

  // scale the registers by r and the gain, write each unit once
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int u = lane + k * group_threads;
    if (u < units) {
      float g[N];
      load_gain<N>(gamma, u, g);
      U o;
#pragma unroll
      for (int j = 0; j < N; ++j)
        Unit::set(o, j, Unit::get(v[k], j) * r * g[j]);
      dst[u] = o;
    }
  }
}

template <typename T, bool kVec, int VPT>
int launch_one(const void* x, const void* gamma, void* out, int rows, int D,
               float eps, int wpr, int rpb, cudaStream_t stream) {
  if (32 * wpr * rpb > max_threads(kVec, VPT))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + rpb - 1) / rpb;
  rmsnorm_rows<T, kVec, VPT><<<blocks, 32 * wpr * rpb, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<T*>(out), rows, D, wpr, eps);
  return static_cast<int>(cudaGetLastError());
}

// The units per thread the plan may pick (kernels/rmsnorm.py: VEC_VPTS,
// SCALAR_VPTS); any other count is refused.
template <typename T, bool kVec>
int launch(const void* x, const void* gamma, void* out, int rows, int D,
           float eps, int vpt, int wpr, int rpb, cudaStream_t s) {
#define RMSNORM_VPT(V)                                                        \
  case V:                                                                     \
    return launch_one<T, kVec, V>(x, gamma, out, rows, D, eps, wpr, rpb, s)
  if constexpr (kVec) {
    switch (vpt) {
      RMSNORM_VPT(1); RMSNORM_VPT(2); RMSNORM_VPT(3); RMSNORM_VPT(4);
      RMSNORM_VPT(8);
    }
  } else {
    switch (vpt) {
      RMSNORM_VPT(1); RMSNORM_VPT(2); RMSNORM_VPT(4); RMSNORM_VPT(8);
      RMSNORM_VPT(16);
    }
  }
#undef RMSNORM_VPT
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, out: (rows, D) contiguous, dtype 0 = float32, 1 = bfloat16; gamma:
// (D,) float32. vec != 0 takes 16-byte units (D a multiple of the vector,
// x, out and gamma 16-byte aligned, which the wrapper checks). Each row
// goes to `wpr` warps holding `vpt` units per thread (32 wpr vpt units
// cover the row), `rpb` rows per block, within the instance's
// max_threads. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int rmsnorm(const void* x, const void* gamma, void* out, int rows,
                       int D, float eps, int dtype, int vec, int vpt, int wpr,
                       int rpb, void* stream) {
  if (rows <= 0) return 0;
  const int n = vec ? (dtype == 0 ? 4 : 8) : 1;
  if (D <= 0 || wpr < 1 || rpb < 1 || (vec && D % n) ||
      static_cast<int64_t>(32) * wpr * vpt < D / n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == 0)
    return vec ? launch<float, true>(x, gamma, out, rows, D, eps, vpt, wpr,
                                     rpb, s)
               : launch<float, false>(x, gamma, out, rows, D, eps, vpt, wpr,
                                      rpb, s);
  if (dtype == 1)
    return vec ? launch<bf16, true>(x, gamma, out, rows, D, eps, vpt, wpr,
                                    rpb, s)
               : launch<bf16, false>(x, gamma, out, rows, D, eps, vpt, wpr,
                                     rpb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
