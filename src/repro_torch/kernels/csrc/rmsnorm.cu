// Row RMSNorm: out = x * rsqrt(mean(x^2) + eps) * gamma, one block per row.
//
// Replaces: src/repro/kernels/rmsnorm.py, rmsnorm_kernel (body
// _rmsnorm_kernel), the fused TPU norm of the transformer stack.
//
// What it computes: x is (rows, D) float32 or bfloat16, gamma (D,)
// float32; the mean square, the rsqrt and the gain are taken in float32
// and the result is cast back to x's type, as the reference does.
//
// Design. The TPU kernel normalises a (256, D) block of rows per grid
// step because its grid runs in order on one core. Here rows are
// independent blocks on 132 SMs: one block per row, each thread loading
// 16 bytes at a time (8 bf16 or 4 f32) so that neighbouring threads read
// neighbouring addresses. Sums of squares go through a warp shuffle and
// one shared-memory step; the second pass reads the row again (from L1,
// where the first pass left it) and writes it scaled. Rows whose width is
// not a multiple of the vector fall back to scalar loads.
//
// What bounds it on this card: bytes. At the serve path's prefill shape
// (8192 rows of 5120 bf16) it reads and writes 168 MB for 4 float ops
// per element, so HBM at 3.35 TB/s sets ~50 us; at decode (8 rows) the
// launch itself is the bound.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

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

__device__ __forceinline__ float block_sum(float s, float* red) {
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = s;
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
  float t = lane < n_warps ? red[lane] : 0.0f;
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

template <typename T, bool kVec>
__global__ void rmsnorm_rows(const T* __restrict__ x,
                             const float* __restrict__ gamma,
                             T* __restrict__ out, int D, float eps) {
  __shared__ float red[32];
  const T* row = x + static_cast<int64_t>(blockIdx.x) * D;
  T* orow = out + static_cast<int64_t>(blockIdx.x) * D;
  float ss = 0.0f;
  if (kVec) {
    constexpr int N = Vec<T>::N;
    const Vec<T>* rv = reinterpret_cast<const Vec<T>*>(row);
    for (int i = threadIdx.x; i < D / N; i += blockDim.x) {
      const Vec<T> v = rv[i];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float f = to_f32(v.v[j]);
        ss = fmaf(f, f, ss);
      }
    }
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float f = to_f32(row[i]);
      ss = fmaf(f, f, ss);
    }
  }
  const float ms = block_sum(ss, red) / static_cast<float>(D);
  const float r = rsqrtf(ms + eps);
  if (kVec) {
    constexpr int N = Vec<T>::N;
    const Vec<T>* rv = reinterpret_cast<const Vec<T>*>(row);
    Vec<T>* ov = reinterpret_cast<Vec<T>*>(orow);
    for (int i = threadIdx.x; i < D / N; i += blockDim.x) {
      const Vec<T> v = rv[i];
      Vec<T> o;
#pragma unroll
      for (int j = 0; j < N; ++j)
        o.v[j] = from_f32<T>(to_f32(v.v[j]) * r * gamma[i * N + j]);
      ov[i] = o;
    }
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x)
      orow[i] = from_f32<T>(to_f32(row[i]) * r * gamma[i]);
  }
}

template <typename T>
int launch(const void* x, const void* gamma, void* out, int rows, int D,
           float eps, bool vec, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const int units = vec ? D / N : D;
  int threads = ((units + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  const T* xp = static_cast<const T*>(x);
  const float* gp = static_cast<const float*>(gamma);
  T* op = static_cast<T*>(out);
  if (vec)
    rmsnorm_rows<T, true><<<rows, threads, 0, stream>>>(xp, gp, op, D, eps);
  else
    rmsnorm_rows<T, false><<<rows, threads, 0, stream>>>(xp, gp, op, D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (rows, D) contiguous, dtype 0 = float32, 1 = bfloat16; gamma:
// (D,) float32. vec != 0 asks for 16-byte loads (D a multiple of the
// vector and x, out 16-byte aligned, which the wrapper checks). Launches
// on `stream` and returns cudaGetLastError().
extern "C" int rmsnorm(const void* x, const void* gamma, void* out, int rows,
                       int D, float eps, int dtype, int vec, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, gamma, out, rows, D, eps, vec, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, gamma, out, rows, D, eps, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
