// sLSTM recurrence with exp-gate stabilisation, forward only.
//
// Replaces: src/repro/kernels/slstm_scan.py, slstm_scan_kernel (body
// _slstm_kernel), the TPU schedule of the sLSTM scan on the xLSTM
// prefill path.
//
// What it computes: for the input contributions wx (B, S, 4d) (gates z,
// i, f, o, each d = H * Pd wide; float32 or bfloat16, any strides over
// (b, s), a contiguous last axis), the block-diagonal recurrent weights
// R (4, H, Pd, Pd) float32, the bias b (4d,) float32 and the state
// (c, n, h, m), each (B, d) float32, per step t:
//   pre = wx_t + h_{t-1} R + b        (R per head: pre[g, head, q] =
//                                      sum_p h[head, p] R[g, head, p, q])
//   m_t = max(log_sigmoid(f) + m, i);  i' = exp(i - m_t);
//   f' = exp(log_sigmoid(f) + m - m_t);
//   c_t = f' c + i' tanh(z);  n_t = f' n + i';
//   h_t = sigmoid(o) c_t / max(n_t, 1).
// hs (B, S, d) takes wx's type; the final state is float32. Any S.
//
// Design. The recurrence is sequential in t, but R is block-diagonal:
// heads are independent, and so are batch rows. One block owns one head
// and up to 8 batch rows and walks all S steps, with h, c, n and m in
// shared memory and only __syncthreads() between the two halves of a
// step. The TPU kernel keeps all of R resident in VMEM; one head's R is
// 4 x 192 x 192 float32 = 590 KB at xlstm-125m's width, more than the
// 227 KB of shared memory a block may have, so this kernel reads R from
// global memory (it stays in the 50 MB L2) at every step. Each thread
// takes 4 adjacent columns of one gate (16-byte loads of R) over a
// slice of the Pd rows (the sum is split over KS thread groups to keep
// more loads in flight), for all 8 batch rows at once, so each R element
// read serves 8 rows. The partial sums meet in shared memory, where the
// threads of the second half add wx and b in the reference's order and
// update the state.
//
// What bounds it on this card: at xlstm-125m's prefill (B 8, S 1024,
// d 768, H 4, Pd 192, bf16 wx) the function needs ~9.7 GFLOP of float32
// work against ~66 MB of inputs and outputs, so the float32 peak
// (~0.15 ms) bounds it; in practice the 1024 dependent steps, each of
// which streams 590 KB of R from L2 into one SM, set the time. Spreading
// a head's R over the shared memory of a thread-block cluster (DSMEM) is
// later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BT = 8;              // batch rows per block
constexpr int kMaxThreads = 768;
constexpr int kMaxKS = 8;

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

// jax.nn.log_sigmoid(x) = -softplus(-x), softplus(u) = max(u, 0) +
// log1p(exp(-|u|)) (jnp.logaddexp(u, 0))
__device__ __forceinline__ float log_sigmoid(float x) {
  return -(fmaxf(-x, 0.0f) + log1pf(expf(-fabsf(x))));
}

// threads per block = Pd * KS: Pd column quads (4 gates x Pd columns / 4)
// times KS groups that split the sum over the Pd rows of R
__host__ __device__ inline int split_of(int Pd) {
  int ks = kMaxThreads / Pd;
  return ks < 1 ? 1 : ks > kMaxKS ? kMaxKS : ks;
}

inline size_t smem_bytes(int Pd) {
  // partial sums [KS][BT][4 Pd], then h, c, n, m [BT][Pd] each
  return static_cast<size_t>(split_of(Pd) * BT * 4 * Pd + 4 * BT * Pd)
         * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
slstm_scan_kernel(const T* __restrict__ wx, const float* __restrict__ R,
                  const float* __restrict__ bias,
                  const float* __restrict__ c0, const float* __restrict__ n0,
                  const float* __restrict__ h0, const float* __restrict__ m0,
                  T* __restrict__ hs, float* __restrict__ cF,
                  float* __restrict__ nF, float* __restrict__ hF,
                  float* __restrict__ mF, int B, int S, int H, int Pd,
                  int64_t swx_b, int64_t swx_s) {
  extern __shared__ __align__(16) float smem[];
  const int KS = split_of(Pd);
  const int d = H * Pd, d4 = 4 * Pd;
  float* part = smem;                   // [KS][BT][4 Pd]
  float* hsm = part + KS * BT * d4;     // [BT][Pd]
  float* cs = hsm + BT * Pd;
  float* ns = cs + BT * Pd;
  float* ms = ns + BT * Pd;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int head = blockIdx.x, b0 = blockIdx.y * BT;
  const int bt = min(BT, B - b0);

  // rows past bt keep h = 0, so their (unused) partial sums stay finite
  for (int i = tid; i < BT * Pd; i += nt) {
    const int r = i / Pd, q = i % Pd;
    float hv = 0.0f, cv = 0.0f, nv = 0.0f, mv = 0.0f;
    if (r < bt) {
      const int64_t g = static_cast<int64_t>(b0 + r) * d + head * Pd + q;
      hv = h0[g]; cv = c0[g]; nv = n0[g]; mv = m0[g];
    }
    hsm[i] = hv; cs[i] = cv; ns[i] = nv; ms[i] = mv;
  }
  __syncthreads();

  // this thread's 4 columns (gate g, q0..q0+3) and its rows of R
  const int cq = tid % Pd, kg = tid / Pd;
  const int col = 4 * cq;
  const int g = col / Pd, q0 = col % Pd;
  const int p_lo = kg * Pd / KS, p_hi = (kg + 1) * Pd / KS;
  const float* rcol = R + (static_cast<int64_t>(g) * H + head) * Pd * Pd + q0;

  for (int t = 0; t < S; ++t) {
    // 1. partial sums of h_{t-1} R over rows [p_lo, p_hi)
    float acc[BT][4];
#pragma unroll
    for (int r = 0; r < BT; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[r][s] = 0.0f;
#pragma unroll 4
    for (int p = p_lo; p < p_hi; ++p) {
      const float4 rv = __ldg(reinterpret_cast<const float4*>(
          rcol + static_cast<int64_t>(p) * Pd));
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float hv = hsm[r * Pd + p];
        acc[r][0] += hv * rv.x;
        acc[r][1] += hv * rv.y;
        acc[r][2] += hv * rv.z;
        acc[r][3] += hv * rv.w;
      }
    }
#pragma unroll
    for (int r = 0; r < BT; ++r)
      *reinterpret_cast<float4*>(part + (kg * BT + r) * d4 + col) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    __syncthreads();

    // 2. gates and state update for (row r, unit q)
    for (int i = tid; i < bt * Pd; i += nt) {
      const int r = i / Pd, q = i % Pd;
      const T* w = wx + (b0 + r) * swx_b + t * swx_s + head * Pd + q;
      float pre[4];
#pragma unroll
      for (int gg = 0; gg < 4; ++gg) {
        float rec = 0.0f;
        for (int k = 0; k < KS; ++k)
          rec += part[(k * BT + r) * d4 + gg * Pd + q];
        pre[gg] = (to_f(w[gg * d]) + rec) + bias[gg * d + head * Pd + q];
      }
      const float f_log = log_sigmoid(pre[2]);
      const float m = ms[i];
      const float m_new = fmaxf(f_log + m, pre[1]);
      const float i_p = expf(pre[1] - m_new);
      const float f_p = expf(f_log + m - m_new);
      const float c = f_p * cs[i] + i_p * tanhf(pre[0]);
      const float n = f_p * ns[i] + i_p;
      const float o = 1.0f / (1.0f + expf(-pre[3]));
      const float hv = o * c / fmaxf(n, 1.0f);
      cs[i] = c; ns[i] = n; ms[i] = m_new; hsm[i] = hv;
      hs[(static_cast<int64_t>(b0 + r) * S + t) * d + head * Pd + q] =
          from_f<T>(hv);
    }
    __syncthreads();
  }

  for (int i = tid; i < bt * Pd; i += nt) {
    const int r = i / Pd, q = i % Pd;
    const int64_t gi = static_cast<int64_t>(b0 + r) * d + head * Pd + q;
    cF[gi] = cs[i]; nF[gi] = ns[i]; hF[gi] = hsm[i]; mF[gi] = ms[i];
  }
}

template <typename T>
int launch(const void* wx, const void* R, const void* b, const void* c0,
           const void* n0, const void* h0, const void* m0, void* hs,
           void* cF, void* nF, void* hF, void* mF, int B, int S, int H,
           int Pd, int64_t swx_b, int64_t swx_s, cudaStream_t stream) {
  const size_t smem = smem_bytes(Pd);
  cudaError_t err = cudaFuncSetAttribute(
      slstm_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, (B + BT - 1) / BT);
  slstm_scan_kernel<T><<<grid, Pd * split_of(Pd), smem, stream>>>(
      static_cast<const T*>(wx), static_cast<const float*>(R),
      static_cast<const float*>(b), static_cast<const float*>(c0),
      static_cast<const float*>(n0), static_cast<const float*>(h0),
      static_cast<const float*>(m0), static_cast<T*>(hs),
      static_cast<float*>(cF), static_cast<float*>(nF),
      static_cast<float*>(hF), static_cast<float*>(mF), B, S, H, Pd, swx_b,
      swx_s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one launch needs for head size Pd (the wrapper checks it
// against the card's 227 KB).
long long slstm_scan_smem(int Pd) {
  return static_cast<long long>(smem_bytes(Pd));
}

// dtype: 0 float32, 1 bfloat16 (wx and hs). Pd % 4 == 0 and Pd <= 768.
// Returns a cudaError_t.
int slstm_scan(const void* wx, const void* R, const void* b, const void* c0,
               const void* n0, const void* h0, const void* m0, void* hs,
               void* cF, void* nF, void* hF, void* mF, int B, int S, int H,
               int Pd, long long swx_b, long long swx_s, int dtype,
               void* stream) {
  if (Pd <= 0 || Pd % 4 || Pd > kMaxThreads || B <= 0 || S < 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(wx, R, b, c0, n0, h0, m0, hs, cF, nF, hF, mF, B, S,
                         H, Pd, swx_b, swx_s, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(wx, R, b, c0, n0, h0, m0, hs, cF, nF, hF,
                                 mF, B, S, H, Pd, swx_b, swx_s, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
