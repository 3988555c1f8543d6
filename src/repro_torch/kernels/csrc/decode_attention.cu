// One-token GQA attention over a KV cache (decode), forward only.
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention_kernel
// (body _decode_kernel), the TPU flash-decoding kernel of the decode step.
//
// What it computes: for q (B, H, D) and caches k, v (B, Hkv, L, D) in
// float32 or bfloat16, out[b, h] = softmax(q k^T * D^-1/2) v over the
// cache positions pos < min(cache_len, L) of KV head h / (H / Hkv). The
// output has q's type. cache_len is read on the card from a device int32,
// so the host never waits for the card between decode steps; a ring
// cache passes cache_len > L, and then all L slots are valid.
//
// Design. The TPU kernel runs one grid program per (b, query head) and
// walks L along a sequential grid axis. Here one block of 128 threads
// owns one (b, KV head) and serves all H / Hkv query heads of that head
// at once (the reference's grouped decode layout), so each K and V row is
// read from device memory once per step, not once per query head. The
// block walks the valid prefix of the cache in tiles of 64 positions
// staged in shared memory (K padded to a stride of D + 1 so the
// thread-per-position dot products are conflict-free), and keeps the
// online-softmax state (m, l, acc) of every query head in shared memory,
// updated in the reference's order. Tiles past min(cache_len, L) are
// never loaded.
//
// What bounds it on this card: bytes. At the serve path's decode (B = 8,
// Hkv = 8, L = 1088, D = 128, bf16) it reads 35.6 MB of cache for 143
// MFLOP, ~11 us at 3.35 TB/s. With one block per (b, KV head) only 64 of
// the 132 SMs work; splitting L across blocks (a second pass) is later
// work.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int BL = 64;
constexpr float kMInit = -1e30f;

template <typename T> struct VecIO;

template <> struct VecIO<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* f) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  }
  __device__ static float get(float v) { return v; }
  __device__ static float put(float v) { return v; }
};

template <> struct VecIO<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* f) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static float get(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 put(float v) { return __float2bfloat16_rn(v); }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_fwd(const T* __restrict__ q, const T* __restrict__ kc,
           const T* __restrict__ vc, const int32_t* __restrict__ cache_len,
           T* __restrict__ out, int L, int D, int G, int64_t sqb,
           int64_t skb, int64_t skh, int64_t sks, int64_t svb, int64_t svh,
           int64_t svs, int64_t sob, float scale) {
  constexpr int N = VecIO<T>::N;
  extern __shared__ __align__(16) float smem[];
  const int KS = D + 1;                 // padded K row stride
  float* Ks = smem;                     // [BL][D + 1]
  float* Vs = Ks + BL * KS;             // [BL][D]
  float* Qs = Vs + BL * D;              // [G][D]
  float* Acc = Qs + G * D;              // [G][D]
  float* Ps = Acc + G * D;              // [G][BL]
  float* Mg = Ps + G * BL;              // [G]
  float* Lg = Mg + G;                   // [G]
  float* Ag = Lg + G;                   // [G]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int h0 = hk * G;
  const T* kb = kc + b * skb + hk * skh;
  const T* vb = vc + b * svb + hk * svh;
  const int nvec = D / N;
  int n = *cache_len;
  n = n < L ? n : L;

  for (int i = tid; i < G * D; i += kThreads) {
    Qs[i] = VecIO<T>::get(q[b * sqb + static_cast<int64_t>(h0) * D + i]);
    Acc[i] = 0.0f;
  }
  for (int g = tid; g < G; g += kThreads) {
    Mg[g] = kMInit;
    Lg[g] = 0.0f;
  }

  for (int t0 = 0; t0 < n; t0 += BL) {
    const int rows = n - t0 < BL ? n - t0 : BL;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BL * nvec; i += kThreads) {
      const int c = i / nvec, dv = i % nvec;
      float fk[N], fv[N];
      if (c < rows) {
        VecIO<T>::load(kb + (t0 + c) * sks + dv * N, fk);
        VecIO<T>::load(vb + (t0 + c) * svs + dv * N, fv);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) fk[e] = fv[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < N; ++e) {
        Ks[c * KS + dv * N + e] = fk[e];
        Vs[c * D + dv * N + e] = fv[e];
      }
    }
    __syncthreads();

    // scores: thread (position c, heads g = tid / BL + 2 j)
    {
      const int c = tid % BL;
      for (int g = tid / BL; g < G; g += kThreads / BL) {
        float s = 0.0f;
        for (int d = 0; d < D; ++d) s = fmaf(Qs[g * D + d], Ks[c * KS + d], s);
        Ps[g * BL + c] = c < rows ? s * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, one warp per query head
    for (int g = warp; g < G; g += kThreads / 32) {
      const float s0 = Ps[g * BL + lane], s1 = Ps[g * BL + lane + 32];
      float mx = fmaxf(s0, s1);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = Mg[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m_prev - m_new);
      Ps[g * BL + lane] = p0;
      Ps[g * BL + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        Lg[g] = alpha * Lg[g] + sum;
        Mg[g] = m_new;
        Ag[g] = alpha;
      }
    }
    __syncthreads();

    // acc = alpha acc + p v
    for (int d = tid; d < D; d += kThreads) {
      for (int g = 0; g < G; ++g) {
        float a = Acc[g * D + d] * Ag[g];
        for (int c = 0; c < rows; ++c)
          a = fmaf(Ps[g * BL + c], Vs[c * D + d], a);
        Acc[g * D + d] = a;
      }
    }
  }
  __syncthreads();

  T* ob = out + b * sob + static_cast<int64_t>(h0) * D;
  for (int i = tid; i < G * D; i += kThreads)
    ob[i] = VecIO<T>::put(Acc[i] / fmaxf(Lg[i / D], 1e-30f));
}

size_t smem_bytes(int D, int G) {
  return static_cast<size_t>(BL * (D + 1) + BL * D + 2 * G * D + G * BL +
                             3 * G) * sizeof(float);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* cache_len,
           void* out, int B, int H, int Hkv, int L, int D, const int64_t* st,
           float scale, cudaStream_t stream) {
  const int G = H / Hkv;
  const size_t smem = smem_bytes(D, G);
  static size_t configured = 48 * 1024;  // the largest size allowed so far
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  const dim3 grid(Hkv, B);
  decode_fwd<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(cache_len),
      static_cast<T*>(out), L, D, G, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one block needs for head dim D and group size G (bytes);
// the wrapper refuses a shape over the card's 227 KB.
extern "C" long long decode_attention_smem(int D, int G) {
  return static_cast<long long>(smem_bytes(D, G));
}

// q: (B, H, D) with batch stride st[0] and heads contiguous; k, v: (B,
// Hkv, L, D) with strides st[1..3] and st[4..6] (b, h, position); out:
// (B, H, D) with batch stride st[7]; all in elements, the head dim
// contiguous. cache_len: a device int32. dtype 0 = float32, 1 =
// bfloat16. D % 8 == 0, H % Hkv == 0, pointers and K/V strides 16-byte
// aligned (the wrapper checks). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* cache_len, void* out, int B,
                                int H, int Hkv, int L, int D,
                                const int64_t* strides, float scale, int dtype,
                                void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (D <= 0 || D % 8 || Hkv <= 0 || H % Hkv || L <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, cache_len, out, B, H, Hkv, L, D, strides,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, cache_len, out, B, H, Hkv, L, D,
                                 strides, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
