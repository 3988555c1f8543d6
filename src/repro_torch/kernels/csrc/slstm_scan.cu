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
// heads are independent, and so are batch rows. The TPU kernel keeps all
// of R resident in VMEM. One head's R is 4 x 192 x 192 float32 = 590 KB
// at xlstm-125m's width, more than the 227 KB of shared memory one block
// may have, so here it is spread over a thread-block cluster. Two bodies,
// chosen by the host's plan (kernels/slstm_scan.py, cluster_plan) from
// the shape:
//
// - slstm_scan_cluster, wherever a head's R fits the cluster's shared
//   memory in 16-byte columns (xlstm-125m: Pd 192). One cluster of C
//   blocks (ranks) per (head, tile of up to 8 batch rows). Rank r owns
//   units [r U, (r + 1) U), U = Pd / C, of all four gates: it loads its
//   4 U columns of R over all Pd rows into shared memory once (cp.async)
//   and keeps them for the whole scan, and it holds the state (c, n, m,
//   h) of its units in registers. Each rank keeps the tile's whole
//   h_{t-1} in its own shared memory, double-buffered by step parity.
//   Per step: (A) each thread sums h_{t-1} R for 8 rows x 4 adjacent
//   columns over its slice of the Pd rows (KS slices; float4 loads of R
//   and h), and the partial sums meet in shared memory; (B) one thread
//   per (row, unit) adds the slices in order, adds wx and b in the plain
//   version's order, updates its unit, stores its h_t into the other
//   buffer of every rank of the cluster (distributed shared memory,
//   st.shared::cluster, 16 bytes of 4 adjacent units at a time), and
//   arrives on the cluster barrier (release);
//   the next step starts by waiting on it (acquire). One cluster barrier
//   per step, one block barrier between (A) and (B). wx is copied by
//   cp.async into a ring of RING steps in shared memory, RING - 1 steps
//   ahead of its use, so its latency is off the dependent chain. Each
//   pre-activation is summed in a fixed order by fixed threads: no
//   atomics, and two launches give the same bits.
// - slstm_scan_stream, for the shapes the cluster does not take (a head's
//   R over ~200 KB per block, e.g. Pd 512 and 768, or units that do not
//   fall into 16-byte columns): one block owns one head and up to 8
//   batch rows and walks all S steps, with h, c, n and m in shared
//   memory, reading R from global memory (it stays in the 50 MB L2) at
//   every step: 4 adjacent columns of one gate per thread (16-byte loads
//   of R) over a slice of the Pd rows, for all 8 batch rows at once.
//
// What bounds it on this card: at xlstm-125m's prefill (B 8, S 1024,
// d 768, H 4, Pd 192, bf16 wx) the function needs ~9.7 GFLOP of float32
// work against ~66 MB of inputs and outputs, so the float32 peak
// (~0.15 ms) bounds it. A 1024-step recurrence cannot reach that: each
// step waits for the last one's h, so the floor is 1024 times one step's
// chain (the products of one rank's share, a block barrier, the DSMEM
// stores and one cluster barrier); slstm_exchange_floor times the last
// two alone. The stream body spends its steps streaming 590 KB of R from
// L2 into one SM.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BT = 8;              // batch rows per block (stream) or cluster
constexpr int kMaxThreads = 768;   // stream body
constexpr int kMaxKS = 8;          // stream body
constexpr int kClusterThreads = 384;  // cluster body, at most
constexpr int kRing = 4;           // steps of wx in the cluster body's ring

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

// The gate update of one (row, unit), pre = (z, i, f, o); c, n, m are
// updated in place and h_t is returned.
__device__ __forceinline__ float cell(const float (&pre)[4], float& c,
                                      float& n, float& m) {
  const float f_log = log_sigmoid(pre[2]);
  const float m_new = fmaxf(f_log + m, pre[1]);
  const float i_p = expf(pre[1] - m_new);
  const float f_p = expf(f_log + m - m_new);
  c = f_p * c + i_p * tanhf(pre[0]);
  n = f_p * n + i_p;
  m = m_new;
  const float o = 1.0f / (1.0f + expf(-pre[3]));
  return o * c / fmaxf(n, 1.0f);
}

// ---------------------------------------------------------------------------
// The stream body
// ---------------------------------------------------------------------------

// threads per block = Pd * KS: Pd column quads (4 gates x Pd columns / 4)
// times KS groups that split the sum over the Pd rows of R
__host__ __device__ inline int split_of(int Pd) {
  int ks = kMaxThreads / Pd;
  return ks < 1 ? 1 : ks > kMaxKS ? kMaxKS : ks;
}

inline size_t stream_smem_bytes(int Pd) {
  // partial sums [KS][BT][4 Pd], then h, c, n, m [BT][Pd] each
  return static_cast<size_t>(split_of(Pd) * BT * 4 * Pd + 4 * BT * Pd)
         * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
slstm_scan_stream(const T* __restrict__ wx, const float* __restrict__ R,
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
      float c = cs[i], n = ns[i], m = ms[i];
      const float hv = cell(pre, c, n, m);
      cs[i] = c; ns[i] = n; ms[i] = m; hsm[i] = hv;
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

// ---------------------------------------------------------------------------
// The cluster body
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "n"(kBytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// v into the same 16 bytes of shared memory of block `rank` of the cluster
__device__ __forceinline__ void store_to_rank(float* local, uint32_t rank,
                                              float4 v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_addr(local)), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   remote), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Row stride of the partial sums [KS][BT][4 U]: 4 U rounded up so that the
// (row, unit) threads of phase B, units fastest, read consecutive banks.
__host__ __device__ inline int part_stride(int U) {
  const int W = 4 * U;
  return W + (((U - W) % 32) + 32) % 32;
}

inline size_t cluster_smem_bytes(int Pd, int C, int KS, int itemsize) {
  const int U = Pd / C;
  // R's columns [Pd][4 U], h [2][BT][Pd], partials [KS][BT][part_stride],
  // float32; the wx ring [kRing][BT][4][U] in wx's type
  return (static_cast<size_t>(Pd) * 4 * U + 2 * BT * Pd
          + static_cast<size_t>(KS) * BT * part_stride(U)) * sizeof(float)
         + static_cast<size_t>(kRing) * BT * 4 * U * itemsize;
}

// Grid (C, H, tiles) in clusters of (C, 1, 1): blockIdx.x is the rank.
// blockDim.x = U KS, KS 8 or 16, U % 4 == 0; wx's strides and base are
// multiples of 4 elements (the wrapper checks).
template <typename T, int KS>
__global__ void __launch_bounds__(kClusterThreads)
slstm_scan_cluster(const T* __restrict__ wx, const float* __restrict__ R,
                   const float* __restrict__ bias,
                   const float* __restrict__ c0, const float* __restrict__ n0,
                   const float* __restrict__ h0, const float* __restrict__ m0,
                   T* __restrict__ hs, float* __restrict__ cF,
                   float* __restrict__ nF, float* __restrict__ hF,
                   float* __restrict__ mF, int B, int S, int H, int Pd,
                   int64_t swx_b, int64_t swx_s) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x;
  const int rank = blockIdx.x;
  const int U = Pd / C, W = 4 * U, PW = part_stride(U);
  const int head = blockIdx.y, b0 = blockIdx.z * BT;
  const int bt = min(BT, B - b0);
  const int d = H * Pd;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* Rs = smem;                      // [Pd][W], column g U + u
  float* hb = Rs + Pd * W;               // [2][BT][Pd]
  float* part = hb + 2 * BT * Pd;        // [KS][BT][PW]
  T* ring = reinterpret_cast<T*>(part + KS * BT * PW);  // [kRing][BT][4][U]

  // this rank's columns of R, all four gates, over all Pd rows: once
  for (int i = tid; i < Pd * U; i += nt) {
    const int p = i / U, j = i % U;  // 16-byte piece j of row p
    const int g = (4 * j) / U, u = (4 * j) % U;
    cp_async<16>(Rs + p * W + 4 * j,
                 R + ((static_cast<int64_t>(g) * H + head) * Pd + p) * Pd
                     + rank * U + u);
  }
  cp_async_commit();
  // h_{-1}: the tile's whole initial h, rows past bt zero
  for (int i = tid; i < BT * Pd; i += nt) {
    const int r = i / Pd, p = i % Pd;
    hb[i] = r < bt ? h0[static_cast<int64_t>(b0 + r) * d + head * Pd + p]
                   : 0.0f;
  }

  // phase B: thread (ur, uu), units fastest, for the first BT U threads
  const bool upd = tid < BT * U;
  const int ur = tid / U, uu = tid % U;
  const bool own = upd && ur < bt;
  const int unit = head * Pd + rank * U + uu;  // within d
  const int64_t gi = static_cast<int64_t>(b0 + ur) * d + unit;
  float c = 0.0f, n = 0.0f, hv = 0.0f, m = 0.0f, bg[4] = {};
  if (own) {
    c = c0[gi]; n = n0[gi]; hv = h0[gi]; m = m0[gi];
  }
  if (upd) {
#pragma unroll
    for (int g = 0; g < 4; ++g) bg[g] = bias[g * d + unit];
  }
  T* hrow = hs + static_cast<int64_t>(b0 + ur) * S * d + unit;
  // the ring's loads: chunk i < BT U of a step is 4 values of (row, gate)
  const int lr = tid / U, lg = (tid % U) / (U / 4), lj = tid % (U / 4);
  const bool loads = upd && lr < bt;
  const T* wsrc = wx + (b0 + lr) * swx_b + lg * d + head * Pd + rank * U
                  + 4 * lj;
  T* wdst = ring + (lr * 4 + lg) * U + 4 * lj;
  auto fetch = [&](int t) {  // wx of step t into its slot, one group
    if (loads && t < S)
      cp_async<4 * sizeof(T)>(wdst + (t % kRing) * BT * 4 * U,
                              wsrc + t * swx_s);
    cp_async_commit();
  };

  // phase A: thread (ks, qd) sums over p-quads [pq_lo, pq_hi) for the 4
  // columns 4 qd .. 4 qd + 3 (one gate) and all BT rows
  const int qd = tid % U, ks = tid / U;
  const int P4 = Pd / 4;
  const int pq_lo = ks * P4 / KS, pq_hi = (ks + 1) * P4 / KS;
  const float4* R4 = reinterpret_cast<const float4*>(Rs);

  cp_async_wait<0>();
  // every block of the cluster has started and holds R and h_{-1}
  cluster.sync();
  for (int t = 0; t < kRing - 1; ++t) fetch(t);

  for (int t = 0; t < S; ++t) {
    if (t > 0) cluster_wait();  // h_{t-1} from every rank is here
    fetch(t + kRing - 1);
    const float* hcur = hb + (t & 1) * BT * Pd;
    float* hnext = hb + ((t + 1) & 1) * BT * Pd;

    float acc[BT][4];
#pragma unroll
    for (int r = 0; r < BT; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[r][s] = 0.0f;
#pragma unroll 2
    for (int pq = pq_lo; pq < pq_hi; ++pq) {
      const int p = 4 * pq;
      const float4 ra = R4[(p + 0) * U + qd];
      const float4 rb = R4[(p + 1) * U + qd];
      const float4 rc = R4[(p + 2) * U + qd];
      const float4 rd = R4[(p + 3) * U + qd];
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float4 h4 = *reinterpret_cast<const float4*>(hcur + r * Pd + p);
        acc[r][0] = fmaf(h4.w, rd.x, fmaf(h4.z, rc.x, fmaf(
            h4.y, rb.x, fmaf(h4.x, ra.x, acc[r][0]))));
        acc[r][1] = fmaf(h4.w, rd.y, fmaf(h4.z, rc.y, fmaf(
            h4.y, rb.y, fmaf(h4.x, ra.y, acc[r][1]))));
        acc[r][2] = fmaf(h4.w, rd.z, fmaf(h4.z, rc.z, fmaf(
            h4.y, rb.z, fmaf(h4.x, ra.z, acc[r][2]))));
        acc[r][3] = fmaf(h4.w, rd.w, fmaf(h4.z, rc.w, fmaf(
            h4.y, rb.w, fmaf(h4.x, ra.w, acc[r][3]))));
      }
    }
#pragma unroll
    for (int r = 0; r < BT; ++r)
      *reinterpret_cast<float4*>(part + (ks * BT + r) * PW + 4 * qd) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    cp_async_wait<kRing - 1>();  // this thread's wx of step t has landed
    __syncthreads();

    if (upd) {
      const T* w = ring + ((t % kRing) * BT + ur) * 4 * U + uu;
      float pre[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float sl[KS];  // the gate's slices, loaded together, summed in order
#pragma unroll
        for (int k = 0; k < KS; ++k)
          sl[k] = part[(k * BT + ur) * PW + g * U + uu];
        float rec = 0.0f;
#pragma unroll
        for (int k = 0; k < KS; ++k) rec += sl[k];
        pre[g] = ((own ? to_f(w[g * U]) : 0.0f) + rec) + bg[g];
      }
      hv = cell(pre, c, n, m);
      if (!own) hv = 0.0f;  // rows past bt keep h = 0
      // the 4 units of this thread's aligned group (4 adjacent lanes, one
      // row) go to every rank as one 16-byte store; lane j of the group
      // serves ranks j, j + 4, ...
      const int lane = tid & 31, j = uu & 3;
      float4 h4;
      h4.x = __shfl_sync(0xffffffffu, hv, (lane & ~3) + 0);
      h4.y = __shfl_sync(0xffffffffu, hv, (lane & ~3) + 1);
      h4.z = __shfl_sync(0xffffffffu, hv, (lane & ~3) + 2);
      h4.w = __shfl_sync(0xffffffffu, hv, (lane & ~3) + 3);
      float* slot = hnext + ur * Pd + rank * U + (uu & ~3);
      for (int q = j; q < C; q += 4) store_to_rank(slot, q, h4);
    }
    cluster_arrive();
    if (own) hrow[static_cast<int64_t>(t) * d] = from_f<T>(hv);
  }
  if (S > 0) cluster_wait();  // no block leaves while others store into it
  cp_async_wait<0>();
  if (own) {
    cF[gi] = c; nF[gi] = n; hF[gi] = hv; mF[gi] = m;
  }
}

// The cluster body's serial floor: S steps of nothing but its exchange of
// h, each (row, unit) thread storing its value, in 16-byte pieces, into
// every rank's buffer and every thread passing one cluster barrier, with
// the grid, cluster and block of the cluster body. The value depends on
// another rank's last one, so the steps are a chain as the scan's are.
// Not on any path: chip_smoke.py times it beside the scan. Writes each
// thread's last value to out (tiles * BT, H * Pd).
__global__ void __launch_bounds__(kClusterThreads)
slstm_exchange_floor(float* __restrict__ out, int S, int H, int Pd) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x, rank = blockIdx.x, U = Pd / C;
  const int tid = threadIdx.x;
  const bool upd = tid < BT * U;
  const int ur = tid / U, uu = tid % U;
  for (int i = tid; i < 2 * BT * Pd; i += blockDim.x) smem[i] = 0.0f;
  cluster.sync();
  float hv = 0.0f;
  for (int t = 0; t < S; ++t) {
    if (t > 0) cluster_wait();
    const float* hcur = smem + (t & 1) * BT * Pd;
    float* hnext = smem + ((t + 1) & 1) * BT * Pd;
    if (upd) {
      hv = hcur[ur * Pd + (rank * U + uu + U) % Pd] + 1.0f;
      const int lane = tid & 31, j = uu & 3;
      float4 h4;
      h4.x = __shfl_sync(0xffffffffu, hv, (lane & ~3) + 0);
      h4.y = __shfl_sync(0xffffffffu, hv, (lane & ~3) + 1);
      h4.z = __shfl_sync(0xffffffffu, hv, (lane & ~3) + 2);
      h4.w = __shfl_sync(0xffffffffu, hv, (lane & ~3) + 3);
      float* slot = hnext + ur * Pd + rank * U + (uu & ~3);
      for (int q = j; q < C; q += 4) store_to_rank(slot, q, h4);
    }
    cluster_arrive();
  }
  if (S > 0) cluster_wait();
  if (upd)
    out[(static_cast<int64_t>(blockIdx.z) * BT + ur) * H * Pd
        + blockIdx.y * Pd + rank * U + uu] = hv;
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

enum Body { kStream = 0, kCluster = 1 };

// A cluster shape the body takes: C ranks of U = Pd / C units, U % 4 == 0,
// KS = 8 or 16 slices of at least one 4-row piece of R, U KS threads.
bool cluster_ok(int Pd, int C, int KS) {
  if (C < 1 || C > 16 || Pd % C || (KS != 8 && KS != 16)) return false;
  const int U = Pd / C;
  return U % 4 == 0 && KS <= Pd / 4 && U * KS <= kClusterThreads;
}

template <typename T>
int launch_stream(const void* wx, const void* R, const void* b,
                  const void* c0, const void* n0, const void* h0,
                  const void* m0, void* hs, void* cF, void* nF, void* hF,
                  void* mF, int B, int S, int H, int Pd, int64_t swx_b,
                  int64_t swx_s, cudaStream_t stream) {
  const size_t smem = stream_smem_bytes(Pd);
  cudaError_t err = cudaFuncSetAttribute(
      slstm_scan_stream<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, (B + BT - 1) / BT);
  slstm_scan_stream<T><<<grid, Pd * split_of(Pd), smem, stream>>>(
      static_cast<const T*>(wx), static_cast<const float*>(R),
      static_cast<const float*>(b), static_cast<const float*>(c0),
      static_cast<const float*>(n0), static_cast<const float*>(h0),
      static_cast<const float*>(m0), static_cast<T*>(hs),
      static_cast<float*>(cF), static_cast<float*>(nF),
      static_cast<float*>(hF), static_cast<float*>(mF), B, S, H, Pd, swx_b,
      swx_s);
  return static_cast<int>(cudaGetLastError());
}

// Launches the cluster body, or with `max_clusters` set fills it with
// cudaOccupancyMaxActiveClusters for this shape and launches nothing.
template <typename T, int KS>
int launch_cluster(const void* wx, const void* R, const void* b,
                   const void* c0, const void* n0, const void* h0,
                   const void* m0, void* hs, void* cF, void* nF, void* hF,
                   void* mF, int B, int S, int H, int Pd, int C,
                   int64_t swx_b, int64_t swx_s, cudaStream_t stream,
                   int* max_clusters) {
  auto K = slstm_scan_cluster<T, KS>;
  const size_t smem = cluster_smem_bytes(Pd, C, KS, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      K, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(
        K, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, H, (B + BT - 1) / BT);
  cfg.blockDim = dim3((Pd / C) * KS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr)
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(max_clusters, K, &cfg));
  e = cudaLaunchKernelEx(
      &cfg, K, static_cast<const T*>(wx), static_cast<const float*>(R),
      static_cast<const float*>(b), static_cast<const float*>(c0),
      static_cast<const float*>(n0), static_cast<const float*>(h0),
      static_cast<const float*>(m0), static_cast<T*>(hs),
      static_cast<float*>(cF), static_cast<float*>(nF),
      static_cast<float*>(hF), static_cast<float*>(mF), B, S, H, Pd, swx_b,
      swx_s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* wx, const void* R, const void* b, const void* c0,
             const void* n0, const void* h0, const void* m0, void* hs,
             void* cF, void* nF, void* hF, void* mF, int B, int S, int H,
             int Pd, int64_t swx_b, int64_t swx_s, int body, int C, int KS,
             int dtype, cudaStream_t s, int* max_clusters) {
  if (Pd <= 0 || Pd % 4 || B <= 0 || S < 0 || H <= 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  if (body == kCluster) {
    if (!cluster_ok(Pd, C, KS) || swx_b % 4 || swx_s % 4)
      return static_cast<int>(cudaErrorInvalidValue);
#define CLUSTER_LAUNCH(T, KS)                                                \
  return launch_cluster<T, KS>(wx, R, b, c0, n0, h0, m0, hs, cF, nF, hF, mF, \
                               B, S, H, Pd, C, swx_b, swx_s, s, max_clusters)
    if (dtype == 0 && KS == 8) CLUSTER_LAUNCH(float, 8);
    if (dtype == 0) CLUSTER_LAUNCH(float, 16);
    if (KS == 8) CLUSTER_LAUNCH(bf16, 8);
    CLUSTER_LAUNCH(bf16, 16);
#undef CLUSTER_LAUNCH
  }
  if (body != kStream || Pd > kMaxThreads || max_clusters != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_stream<float>(wx, R, b, c0, n0, h0, m0, hs, cF, nF, hF, mF,
                                B, S, H, Pd, swx_b, swx_s, s);
  return launch_stream<bf16>(wx, R, b, c0, n0, h0, m0, hs, cF, nF, hF, mF, B,
                             S, H, Pd, swx_b, swx_s, s);
}

int launch_floor(void* out, int B, int S, int H, int Pd, int C, int KS,
                 cudaStream_t stream) {
  if (!cluster_ok(Pd, C, KS) || S < 0 || B <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * BT * Pd * sizeof(float);
  cudaError_t e = cudaSuccess;
  if (C > 8)
    e = cudaFuncSetAttribute(slstm_exchange_floor,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, H, (B + BT - 1) / BT);
  cfg.blockDim = dim3((Pd / C) * KS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, slstm_exchange_floor, static_cast<float*>(out),
                         S, H, Pd);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The cluster body's serial floor at this shape (slstm_exchange_floor):
// S steps of its h exchange and cluster barrier alone. out: (tiles * 8,
// H * Pd) float32. Returns a cudaError_t.
int slstm_scan_floor(void* out, int B, int S, int H, int Pd, int C, int KS,
                     void* stream) {
  return launch_floor(out, B, S, H, Pd, C, KS,
                      static_cast<cudaStream_t>(stream));
}

// Shared memory per block of `body` (0 stream, 1 cluster of C ranks and
// KS slices) for head size Pd and wx's dtype (0 float32, 1 bfloat16); -1
// for a cluster shape the body does not take. The wrapper's plan holds
// the same formulas (kernels/slstm_scan.py).
long long slstm_scan_smem(int body, int Pd, int C, int KS, int dtype) {
  if (body == kCluster)
    return cluster_ok(Pd, C, KS)
               ? static_cast<long long>(
                     cluster_smem_bytes(Pd, C, KS, dtype == 0 ? 4 : 2))
               : -1;
  return static_cast<long long>(stream_smem_bytes(Pd));
}

// How many clusters of the cluster body (C ranks, KS slices, head size
// Pd, wx's dtype) the card holds at once (cudaOccupancyMaxActiveClusters),
// into *out. Returns a cudaError_t.
int slstm_scan_max_clusters(int Pd, int C, int KS, int dtype, int* out) {
  *out = 0;
  return dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, BT, 1,
                  1, Pd, 4, 4, kCluster, C, KS, dtype, nullptr, out);
}

// body: 0 stream (Pd % 4 == 0, Pd <= 768), 1 cluster (C, KS as the plan
// gives them; wx's strides and base in multiples of 4 elements). dtype: 0
// float32, 1 bfloat16 (wx and hs). Returns a cudaError_t.
int slstm_scan(const void* wx, const void* R, const void* b, const void* c0,
               const void* n0, const void* h0, const void* m0, void* hs,
               void* cF, void* nF, void* hF, void* mF, int B, int S, int H,
               int Pd, long long swx_b, long long swx_s, int body, int C,
               int KS, int dtype, void* stream) {
  return dispatch(wx, R, b, c0, n0, h0, m0, hs, cF, nF, hF, mF, B, S, H, Pd,
                  swx_b, swx_s, body, C, KS, dtype,
                  static_cast<cudaStream_t>(stream), nullptr);
}

}  // extern "C"
