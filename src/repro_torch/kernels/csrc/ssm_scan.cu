// Chunked Mamba2 SSD scan, forward only.
//
// Replaces: src/repro/kernels/ssm_scan.py, ssm_scan_kernel (body
// _ssd_kernel), the TPU schedule of the SSD scan on the Mamba2 prefill
// path (and its Triton twin ssm_scan_kernel_gpu).
//
// What it computes: for x (B, S, H, P), dt (B, S, H) float32 (after the
// softplus), A (H,) float32 and Bm, Cm (B, S, N), with x, Bm and Cm in
// float32 or bfloat16, any strides over (b, s, h) and a contiguous last
// axis, the recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
// y_t = h_t C_t per (b, h), from a zero state, in the chunked form of the
// reference: with L = min(chunk, S), S % L == 0, and per chunk
// cum = the inclusive sum of dt A within the chunk,
//   y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) C_i . h_prev,
//   h   = exp(cum_L) h_prev + sum_j exp(cum_L - cum_j) dt_j x_j B_j^T.
// y (B, S, H, P) takes x's type; the final state (B, H, P, N) is float32.
//
// Design. The TPU kernel walks the chunks along a sequential grid axis
// and carries the (P, N) state in VMEM scratch. Blocks on Hopper run in
// no order, so here one block of 256 threads owns one (h, b) and loops
// over the chunks, keeping the state in shared memory. Each chunk is
// loaded once into shared memory in float32 (x row-major, B row-major and
// transposed, C transposed), cum is summed sequentially by one thread as
// the reference sums it, and three register-tiled products follow, all
// float32 FMAs from shared memory:
//   1. W^T (L x L): each thread 8 rows j by 8 columns i of C B^T over N,
//      scaled by exp(cum_i - cum_j) dt_j where j <= i, else 0 (the
//      exponent is then <= 0: the decay never overflows);
//   2. y (L x P): 8 rows i by 4 columns p of W x over j <= i (the loop
//      stops at the thread's last row) plus exp(cum_i) C h_prev over N;
//   3. the state (N x P, kept transposed): 4 by 4 of B^T (sdec x) over j.
// Padded rows and columns of the tiles (L < 128, P < 64, N < 64) are
// zero, so one tiling serves every size up to those limits.
//
// What bounds it on this card: at zamba2-2.7b's prefill (B 8, S 1024,
// H 80, P 64, N 64, L 128, bf16) the causal chunk products need ~21.6
// GFLOP of float32 work against ~183 MB of inputs and outputs, so the
// float32 peak (67 TFLOP/s, ~0.32 ms) bounds it. The 214 KB of shared
// memory allow one block (8 warps) per SM, 640 blocks in ~5 waves. C B^T
// depends on (b, chunk) and not on h: this kernel recomputes it for each
// of the 80 heads, and tensor cores (tf32 or bf16 mma) are not used;
// both are later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int LMAX = 128;       // chunk length
constexpr int PMAX = 64;        // channels per head
constexpr int NMAX = 64;        // state size
constexpr int LP = LMAX + 4;    // padded row of the transposed tiles
constexpr int kSmemFloats =
    2 * NMAX * LP + LMAX * LP + LMAX * NMAX + LMAX * PMAX + NMAX * PMAX
    + 4 * LMAX;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void ld4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

struct Strides {
  int64_t b, s, h;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan(const T* __restrict__ x, const float* __restrict__ dt,
         const float* __restrict__ A, const T* __restrict__ Bm,
         const T* __restrict__ Cm, T* __restrict__ y,
         float* __restrict__ state, int S, int H, int P, int N, int L,
         Strides sx, Strides sdt, Strides sb, Strides sc) {
  extern __shared__ __align__(16) float smem[];
  float* Ct = smem;                  // [NMAX][LP]   C transposed
  float* Bt = Ct + NMAX * LP;        // [NMAX][LP]   B transposed
  float* Wt = Bt + NMAX * LP;        // [LMAX][LP]   W transposed: [j][i]
  float* Bs = Wt + LMAX * LP;        // [LMAX][NMAX] B
  float* Xs = Bs + LMAX * NMAX;      // [LMAX][PMAX] x
  float* Ht = Xs + LMAX * PMAX;      // [NMAX][PMAX] state transposed
  float* cum = Ht + NMAX * PMAX;     // [LMAX]
  float* dts = cum + LMAX;           // [LMAX]
  float* ecum = dts + LMAX;          // [LMAX] exp(cum_i)
  float* sdec = ecum + LMAX;         // [LMAX] exp(cum_L - cum_j) dt_j

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const float a_h = A[h];
  const T* xb = x + b * sx.b + h * sx.h;
  const float* dtb = dt + b * sdt.b + h * sdt.h;
  const T* Bb = Bm + b * sb.b;
  const T* Cb = Cm + b * sc.b;
  T* yb = y + (static_cast<int64_t>(b) * S * H + h) * P;

  // padding stays zero; the state starts at zero
  for (int i = tid; i < kSmemFloats; i += kThreads) smem[i] = 0.0f;
  __syncthreads();

  const int n_chunks = S / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    for (int i = tid; i < L * P; i += kThreads) {
      const int r = i / P, p = i % P;
      Xs[r * PMAX + p] = to_f(xb[(t0 + r) * sx.s + p]);
    }
    for (int i = tid; i < L * N; i += kThreads) {
      const int r = i / N, n = i % N;
      const float bv = to_f(Bb[(t0 + r) * sb.s + n]);
      Bs[r * NMAX + n] = bv;
      Bt[n * LP + r] = bv;
      Ct[n * LP + r] = to_f(Cb[(t0 + r) * sc.s + n]);
    }
    for (int i = tid; i < L; i += kThreads) dts[i] = dtb[(t0 + i) * sdt.s];
    __syncthreads();
    if (tid == 0) {  // the inclusive sum, in order
      float s = 0.0f;
      for (int i = 0; i < L; ++i) {
        s += dts[i] * a_h;
        cum[i] = s;
      }
    }
    __syncthreads();
    const float total = cum[L - 1];
    for (int i = tid; i < L; i += kThreads) {
      ecum[i] = expf(cum[i]);
      sdec[i] = expf(total - cum[i]) * dts[i];
    }

    // 1. W^T[j][i] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i < L
    {
      const int j0 = ty * 8;
      const int ic[2] = {tx * 4, 64 + tx * 4};
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int s = 0; s < 8; ++s) acc[r][s] = 0.0f;
      if (j0 < L && j0 <= ic[1] + 3) {
        for (int n = 0; n < N; ++n) {
          float bv[8], cv[8];
          ld4(Bt + n * LP + j0, bv);
          ld4(Bt + n * LP + j0 + 4, bv + 4);
          ld4(Ct + n * LP + ic[0], cv);
          ld4(Ct + n * LP + ic[1], cv + 4);
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int s = 0; s < 8; ++s) acc[r][s] += cv[s] * bv[r];
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int j = j0 + r;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float o[4];
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int i = ic[half] + s;
            o[s] = (j <= i && i < L)
                       ? acc[r][half * 4 + s] * expf(cum[i] - cum[j]) * dts[j]
                       : 0.0f;
          }
          *reinterpret_cast<float4*>(Wt + j * LP + ic[half]) =
              make_float4(o[0], o[1], o[2], o[3]);
        }
      }
    }
    __syncthreads();

    // 2. y_i = sum_{j <= i} W[i][j] x_j + exp(cum_i) C_i . h_prev
    {
      const int i0 = ty * 8, p0 = tx * 4;
      if (i0 < L && p0 < P) {
        float acc[8][4], crs[8][4];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[r][s] = crs[r][s] = 0.0f;
        const int jend = min(L, i0 + 8);
        for (int j = 0; j < jend; ++j) {
          float wv[8], xv[4];
          ld4(Wt + j * LP + i0, wv);
          ld4(Wt + j * LP + i0 + 4, wv + 4);
          ld4(Xs + j * PMAX + p0, xv);
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int s = 0; s < 4; ++s) acc[r][s] += wv[r] * xv[s];
        }
        for (int n = 0; n < N; ++n) {
          float cv[8], hv[4];
          ld4(Ct + n * LP + i0, cv);
          ld4(Ct + n * LP + i0 + 4, cv + 4);
          ld4(Ht + n * PMAX + p0, hv);
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int s = 0; s < 4; ++s) crs[r][s] += cv[r] * hv[s];
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = i0 + r;
          if (i >= L) break;
          T* yr = yb + static_cast<int64_t>(t0 + i) * H * P;
#pragma unroll
          for (int s = 0; s < 4; ++s)
            if (p0 + s < P)
              yr[p0 + s] = from_f<T>(acc[r][s] + crs[r][s] * ecum[i]);
        }
      }
    }
    __syncthreads();  // step 3 overwrites the state that step 2 read

    // 3. h^T[n][p] = exp(cum_L) h^T[n][p] + sum_j B[j][n] (sdec_j x[j][p])
    {
      const int n0 = ty * 4, p0 = tx * 4;
      if (n0 < N && p0 < P) {
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[r][s] = 0.0f;
        for (int j = 0; j < L; ++j) {
          float bv[4], xv[4];
          ld4(Bs + j * NMAX + n0, bv);
          ld4(Xs + j * PMAX + p0, xv);
          const float sd = sdec[j];
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const float xs = xv[s] * sd;
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r][s] += bv[r] * xs;
          }
        }
        const float et = expf(total);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            float* hp = Ht + (n0 + r) * PMAX + p0 + s;
            *hp = *hp * et + acc[r][s];
          }
      }
    }
    __syncthreads();  // before the next chunk overwrites the tiles
  }

  float* st = state + (static_cast<int64_t>(b) * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i % N;
    st[i] = Ht[n * PMAX + p];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* state, int B, int S, int H, int P,
           int N, int L, const int64_t* st, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sx{st[0], st[1], st[2]}, sdt{st[3], st[4], st[5]};
  const Strides sb{st[6], st[7], 0}, sc{st[8], st[9], 0};
  const dim3 grid(H, B);
  ssd_scan<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(state), S, H, P, N, L, sx, sdt, sb, sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The limits of one block's tiles; the wrapper checks the shapes against
// them before it launches.
int ssm_scan_limits(int which) {
  return which == 0 ? LMAX : which == 1 ? PMAX : NMAX;
}

// strides (elements): x b, s, h; dt b, s, h; Bm b, s; Cm b, s.
// dtype: 0 float32, 1 bfloat16 (x, Bm, Cm and y). Returns a cudaError_t.
int ssm_scan(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, void* y, void* state, int B, int S, int H,
             int P, int N, int L, const int64_t* strides, int dtype,
             void* stream) {
  if (L <= 0 || L > LMAX || S % L || P > PMAX || N > NMAX || P <= 0 ||
      N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, y, state, B, S, H, P, N, L,
                         strides, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, B, S, H, P, N,
                                 L, strides, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
