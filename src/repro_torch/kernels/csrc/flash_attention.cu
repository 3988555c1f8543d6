// Causal GQA flash attention (prefill), forward only.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_kernel
// (body _flash_kernel), the TPU flash schedule of the prefill path.
//
// What it computes: for q (B, S, H, D) and k, v (B, S, Hkv, D), in
// float32 or bfloat16 with any strides over (b, s, h) and a contiguous
// head dim, out[b, s, h] = softmax(q k^T * D^-1/2 + mask) v over the keys
// of KV head h / (H / Hkv), with the mask kpos <= qpos (causal) and
// kpos > qpos - window (a sliding window, window > 0). The output has
// q's type and the layout (B, S, H, D).
//
// Design. The TPU kernel walks k-blocks along a sequential grid axis and
// carries the online-softmax state in VMEM scratch. Here one block of
// 128 threads owns one (b, h, 64-row q tile) and walks the k tiles of 64
// keys in a loop, keeping the state in registers. The softmax runs in
// the reference's order: m_new = max(m, rowmax s), p = exp(s - m_new),
// alpha = exp(m - m_new), l = alpha l + sum p, acc = alpha acc + p v,
// and the output is acc / max(l, 1e-30). The loop bounds skip every k
// tile that lies wholly above the diagonal or outside the window, so
// those tiles are never loaded; the tails of S are masked (and
// zero-filled) in the last tile, so any S works. Two bodies:
//
// - bf16 with D = 64 or 128 (the serve path): the products run on the
//   tensor cores as mma.sync m16n8k16 (bf16 in, f32 accumulate), one
//   warp per 16 query rows; see flash_fwd_mma.
// - float32, and other head dims: scalar f32 FMAs from shared memory.
//   Each thread holds 4 query rows by 8 keys of the score tile and 4
//   rows by D/8 columns of the accumulator; Q and K are staged
//   transposed (d-major) and V row-major, in float32, so the inner
//   products read conflict-free 16-byte vectors.
//
// What bounds it on this card: at the serve path's prefill (B = 8,
// S = 1024, H = 32, Hkv = 8, D = 128, bf16) the causal triangle needs
// 69 GFLOP against 168 MB of q, k, v and output, so the bf16 tensor-core
// peak (989 TFLOP/s, 0.07 ms) is the bound. mma.sync reaches only part
// of that peak (wgmma, TMA and warp specialisation are later work).

#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr float kMInit = -1e30f;

template <typename T> struct VecIO;

template <> struct VecIO<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* f) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  }
  __device__ static void store4(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
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
  __device__ static void store4(__nv_bfloat16* p, const float* f) {
    uint2 x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
    h[0] = __floats2bfloat162_rn(f[0], f[1]);
    h[1] = __floats2bfloat162_rn(f[2], f[3]);
    *reinterpret_cast<uint2*>(p) = x;
  }
};

struct Strides {
  int64_t b, s, h;
};

// MAXD: the largest head dim this instance takes (64, 128 or 256); the
// accumulator holds 4 rows by MAXD / 8 columns per thread.
template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int S, int D,
          int group, Strides sq, Strides sk, Strides sv, Strides so,
          float scale, int causal, int window) {
  constexpr int N = VecIO<T>::N;
  constexpr int KD = MAXD / 32;  // float4 column groups per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;              // [D][BQ]
  float* Kt = Qt + D * BQ;       // [D][BK]
  float* Vs = Kt + D * BK;       // [BK][D]
  float* Pt = Vs + BK * D;       // [BK][BQ]

  const int tid = threadIdx.x;
  const int tx = tid & 7, ty = tid >> 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  const int nvec = D / N;

  // Q tile, transposed; rows past S are zero
  for (int i = tid; i < BQ * nvec; i += kThreads) {
    const int r = i % BQ, dv = i / BQ;
    float f[N];
    if (q0 + r < S) {
      VecIO<T>::load(qb + (q0 + r) * sq.s + dv * N, f);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) f[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) Qt[(dv * N + e) * BQ + r] = f[e];
  }

  float acc[4][KD * 4];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kMInit;
    l_i[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < KD * 4; ++j) acc[i][j] = 0.0f;
  }

  // k tiles [lo, hi): none wholly above the diagonal or outside the window
  const int n_k = (S + BK - 1) / BK;
  int hi = n_k, lo = 0;
  if (causal) {
    const int last = (q0 + BQ - 1 < S - 1 ? q0 + BQ - 1 : S - 1);
    hi = last / BK + 1;
  }
  if (window > 0) {
    const int first = q0 - window + 1;
    lo = first > 0 ? first / BK : 0;
  }

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * nvec; i += kThreads) {
      const int c = i % BK, dv = i / BK;
      float f[N];
      if (k0 + c < S) {
        VecIO<T>::load(kb + (k0 + c) * sk.s + dv * N, f);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) f[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < N; ++e) Kt[(dv * N + e) * BK + c] = f[e];
    }
    for (int i = tid; i < BK * nvec; i += kThreads) {
      const int c = i / nvec, dv = i % nvec;
      float f[N];
      if (k0 + c < S) {
        VecIO<T>::load(vb + (k0 + c) * sv.s + dv * N, f);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) f[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < N; ++e) Vs[c * D + dv * N + e] = f[e];
    }
    __syncthreads();

    // scores of rows ty*4 + i against keys tx*8 + j
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(Qt + d * BQ + ty * 4);
      const float4 ka = *reinterpret_cast<const float4*>(Kt + d * BK + tx * 8);
      const float4 kb4 =
          *reinterpret_cast<const float4*>(Kt + d * BK + tx * 8 + 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float kk[8] = {ka.x, ka.y, ka.z, ka.w, kb4.x, kb4.y, kb4.z, kb4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qa[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tx * 8 + j;
        bool ok = kpos < S;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_i[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m_i[i] - m_new);
      l_i[i] = alpha * l_i[i] + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < KD * 4; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) Pt[(tx * 8 + j) * BQ + ty * 4 + i] = s[i][j];
    }
    __syncthreads();

    // acc += p v over this tile's keys; columns tx*4 + 32*kd + e
    const int kmax = k0 + BK <= S ? BK : S - k0;
    for (int c = 0; c < kmax; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(Pt + c * BQ + ty * 4);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const int d = tx * 4 + 32 * kd;
        if (d < D) {
          const float4 vv = *reinterpret_cast<const float4*>(Vs + c * D + d);
          const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][kd * 4 + e] = fmaf(pa[i], va[e], acc[i][kd * 4 + e]);
        }
      }
    }
  }

  T* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const int d = tx * 4 + 32 * kd;
      if (d < D) {
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = acc[i][kd * 4 + e] / l;
        VecIO<T>::store4(ob + qpos * so.s + d, o);
      }
    }
  }
}

template <typename T, int MAXD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int Hkv, int D, const Strides* st, float scale,
           int causal, int window, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(3 * D * BQ + BK * BQ) * sizeof(float);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<T, MAXD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>((3 * MAXD * BQ + BK * BQ) * sizeof(float)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd<T, MAXD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, D, H / Hkv, st[0],
      st[1], st[2], st[3], scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 tensor-core path: mma.sync m16n8k16 (bf16 in, f32 accumulate)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One block of 4 warps owns a (b, h, 64-row q tile); warp w the rows
// 16 w .. 16 w + 15. Q (as A fragments) stays in registers; each k tile
// of 64 keys is staged in shared memory, K row-major and V transposed,
// both padded by 8 elements so the fragment loads are conflict-free.
// S = Q K^T and O += P V are m16n8k16 products; P is rounded to bf16
// for the second, as the plain version rounds the probabilities to the
// input type. The softmax runs on the S accumulators in registers: a
// thread holds 2 rows x 16 keys of a tile, and a row's 64 keys are
// spread over the 4 threads of a quad.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ out, int S, int group, Strides sq,
              Strides sk, Strides sv, Strides so, float scale, int causal,
              int window) {
  constexpr int DP = D + 8;     // padded row of Qs and Ks
  constexpr int KP = BK + 8;    // padded row of Vt
  constexpr int NV = D / 8;     // 16-byte vectors per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][DP]
  __nv_bfloat16* Ks = Qs + BQ * DP;                                 // [BK][DP]
  __nv_bfloat16* Vt = Ks + BK * DP;                                 // [D][KP]

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + hk * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + hk * sv.h;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int i = tid; i < BQ * NV; i += kThreads) {
    const int r = i / NV, dv = i % NV;
    *reinterpret_cast<uint4*>(Qs + r * DP + dv * 8) =
        q0 + r < S ? *reinterpret_cast<const uint4*>(qb + (q0 + r) * sq.s +
                                                     dv * 8)
                   : zero;
  }
  __syncthreads();
  uint32_t qa[D / 16][4];
  {
    const __nv_bfloat16* r0 = Qs + (w * 16 + g) * DP + t * 2;
    const __nv_bfloat16* r1 = r0 + 8 * DP;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = ld32(r0 + kk * 16);
      qa[kk][1] = ld32(r1 + kk * 16);
      qa[kk][2] = ld32(r0 + kk * 16 + 8);
      qa[kk][3] = ld32(r1 + kk * 16 + 8);
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m_i[2] = {kMInit, kMInit}, l_i[2] = {0.0f, 0.0f};
  const int qpos0 = q0 + w * 16 + g;   // row of c[0], c[1]; +8 for c[2], c[3]

  const int n_k = (S + BK - 1) / BK;
  int hi = n_k, lo = 0;
  if (causal) {
    const int last = (q0 + BQ - 1 < S - 1 ? q0 + BQ - 1 : S - 1);
    hi = last / BK + 1;
  }
  if (window > 0) {
    const int first = q0 - window + 1;
    lo = first > 0 ? first / BK : 0;
  }

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * NV; i += kThreads) {
      const int c = i / NV, dv = i % NV;
      *reinterpret_cast<uint4*>(Ks + c * DP + dv * 8) =
          k0 + c < S ? *reinterpret_cast<const uint4*>(kb + (k0 + c) * sk.s +
                                                       dv * 8)
                     : zero;
    }
    for (int i = tid; i < BK * NV; i += kThreads) {
      const int c = i % BK, dv = i / BK;
      uint4 x = k0 + c < S ? *reinterpret_cast<const uint4*>(
                                 vb + (k0 + c) * sv.s + dv * 8)
                           : zero;
      const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(dv * 8 + e) * KP + c] = e8[e];
    }
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
      const __nv_bfloat16* kr = Ks + (j * 8 + g) * DP + t * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16(s[j], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = qpos0 + (e >> 1) * 8;
        const int kpos = k0 + j * 8 + t * 2 + (e & 1);
        bool ok = kpos < S;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[j][e] = ok ? s[j][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      alpha[r] = expf(m_i[r] - m_new);
      m_i[r] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_i[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_i[r] = alpha[r] * l_i[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* vr = Vt + (n * 8 + g) * KP + kk * 16 + t * 2;
        mma_bf16(o[n], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  __nv_bfloat16* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qpos0 + r * 8;
    if (qpos >= S) continue;
    const float l = fmaxf(l_i[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(ob + qpos * so.s + n * 8 + t * 2) =
          pack_bf16(o[n][2 * r] / l, o[n][2 * r + 1] / l);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int S, int H, int Hkv, const Strides* st, float scale,
               int causal, int window, cudaStream_t stream) {
  const int smem = static_cast<int>(
      (2 * BQ * (D + 8) + D * (BK + 8)) * sizeof(__nv_bfloat16));
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_mma<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), S, H / Hkv, st[0], st[1], st[2],
      st[3], scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int H, int Hkv, int D, const Strides* st, float scale,
             int causal, int window, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (D == 128)
      return launch_mma<128>(q, k, v, out, B, S, H, Hkv, st, scale, causal,
                             window, stream);
    if (D == 64)
      return launch_mma<64>(q, k, v, out, B, S, H, Hkv, st, scale, causal,
                            window, stream);
  }
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, B, S, H, Hkv, D, st, scale, causal,
                         window, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, out, B, S, H, Hkv, D, st, scale, causal,
                          window, stream);
  return launch<T, 256>(q, k, v, out, B, S, H, Hkv, D, st, scale, causal,
                        window, stream);
}

}  // namespace

// q, out: (B, S, H, D); k, v: (B, S, Hkv, D); strides (in elements) of
// the b, s and h axes for q, k, v, out in that order (12 values); the
// head dim is contiguous. dtype 0 = float32, 1 = bfloat16. D % 8 == 0,
// D <= 256, H % Hkv == 0, and every pointer and stride 16-byte aligned
// (the wrapper checks). window <= 0 means no window. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int H, int Hkv, int D,
                               const int64_t* strides, float scale, int causal,
                               int window, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (D <= 0 || D > 256 || D % 8 || Hkv <= 0 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, S, H, Hkv, D, st, scale, causal,
                           window, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, S, H, Hkv, D, st, scale,
                                   causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
