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
// The TPU kernel walks the chunks along a sequential grid axis and carries
// the (P, N) state in VMEM scratch. Two bodies here, chosen by the host's
// plan (kernels/ssm_scan.py, ssd_plan):
//
// - ssd_scan_cluster, bf16 with P = N = 64 and L a multiple of 16 (the
//   serve path: zamba2-2.7b). Chunks run in parallel. One block of 8 warps
//   owns one (b, chunk, group of up to 16 heads); the blocks of one
//   (b, head group) over R consecutive chunks form a thread-block cluster
//   of R ranks (R a power of two up to 8, or 16 where the card holds every
//   cluster of the launch at once), and where S / L exceeds R, rank r
//   walks chunks r, r + R, ... The block loads its chunk's B and C tiles
//   once (cp.async) and computes G = C B^T on the tensor cores once for
//   all its heads, kept in registers as mma accumulators: warp w holds
//   one row tile of 16 rows over its causal columns (tiles w and 7 - w of
//   one SM sub-partition add up to the same 9 blocks). Per head, x
//   arrives by cp.async in a ring of 4 tiles, three heads ahead of its
//   use, and then
//     1. y_in = W x with W = G exp(cum_i - cum_j) dt_j over j <= i: W is
//        formed in float32 from G's accumulators and becomes the A
//        operand in registers (the accumulator layout of m16n8 is the A
//        layout of m16n8k16), x read with ldmatrix.trans. Off the
//        diagonal block the decay is exp(cum_i - cum_l) exp(cum_l - cum_j)
//        with l the block's last column (both factors <= 1, the second
//        kept per head), on it the exponent is masked to j <= i before
//        the exp, so nothing overflows;
//     2. h_in = (x exp(cum_L - cum_j) dt_j)^T B over the chunk, the scaled
//        x made once per head for all warps, one head ahead;
//     3. the chain: the rank takes h_{c-1} from the message slot that rank
//        c - 1 (the last rank, past the cluster: c - 1 mod R) filled
//        through distributed shared memory, forms h_c = exp(cum_L) h_{c-1}
//        + h_in in float32 and pushes h_c (16 KB, in the order of h_in's
//        fragments) into rank c + 1's slot with st.async, whose bytes
//        complete that rank's mbarrier: one (P x N) multiply-add and one
//        DSMEM hop per chunk on the serial chain. The rank holding the
//        last chunk writes the final state;
//     4. y += exp(cum_i) C h_{c-1}^T, h_{c-1}'s B fragments laid out once
//        by the receiving warps, and y goes out through a staging tile in
//        shared memory as whole rows (16-byte stores).
//   The products take bf16 operands with float32 accumulators. W, the
//   scaled x and h_{c-1} are float32 values; each goes in as a pair of
//   bf16 operands (hi, lo; split_bf16) in two products (C, B and x are
//   bf16 already): one bf16 rounding of them puts y outside 2e-2 of the
//   float32 recurrence at the serve path's size.
//   Each receiver has two message slots, each with a "full" mbarrier
//   (tracking the 16 KB of a message) and the sender has an "empty"
//   mbarrier per slot that the receiver arrives on (release, cluster
//   scope) once it has read a message, so a sender runs at most two heads
//   ahead; no cluster-wide barrier per hop. Two block barriers per head.
//   cum is summed by a warp scan in chunk order. All sums run in a fixed
//   order without atomics, so two launches give the same bits.
// - ssd_scan (scalar), float32 and the other bf16 shapes (P or N other
//   than 64, L no multiple of 16): one block of 256 threads owns one
//   (h, b) and loops over the chunks, keeping the state in shared memory.
//   Each chunk is loaded once into shared memory in float32 (x row-major,
//   B row-major and transposed, C transposed), cum is summed sequentially
//   by one thread as the reference sums it, and three register-tiled
//   products follow, all float32 FMAs from shared memory:
//     1. W^T (L x L): each thread 8 rows j by 8 columns i of C B^T over N,
//        scaled by exp(cum_i - cum_j) dt_j where j <= i, else 0;
//     2. y (L x P): 8 rows i by 4 columns p of W x over j <= i plus
//        exp(cum_i) C h_prev over N;
//     3. the state (N x P, kept transposed): 4 by 4 of B^T (sdec x) over j.
//   Padded rows and columns of the tiles (L < 128, P < 64, N < 64) are
//   zero, so one tiling serves every size up to those limits.
//
// What bounds it on this card: at zamba2-2.7b's prefill (B 8, S 1024,
// H 80, P 64, N 64, L 128, bf16) the chunked form needs ~16.2 GFLOP,
// 0.016 ms on the bf16 tensor cores (twice that with the split
// operands), against ~183 MB of inputs and outputs, 0.055 ms at
// 3.35 TB/s: the bytes bound it. The cluster body reads x, B, C and dt
// once and writes y and the final state once; no chunk state goes to
// device memory. Its 64 (b, chunk) pairs x 5 groups of 16 heads give 320
// blocks of 216 KB of shared memory, one per SM, with three heads' x in
// flight per block. The split operands double the products (~1600
// m16n8k16 per chunk and head) and cost float-to-bf16 conversions (a
// quarter-rate instruction); these and ~450 KB of shared-memory traffic
// per chunk and head, not the bytes, set the kernel's time (PERF.md).

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
int launch_scalar(const void* x, const void* dt, const void* A,
                  const void* Bm, const void* Cm, void* y, void* state, int B,
                  int S, int H, int P, int N, int L, const int64_t* st,
                  cudaStream_t stream) {
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

// ---------------------------------------------------------------------------
// The cluster body: bf16, P = N = 64, L % 16 == 0
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kCThreads = 256;            // 8 warps
constexpr int kCP = 64, kCN = 64;         // the head size and state it takes
constexpr int kRow = 72;                  // bf16 row of a tile: 144 bytes,
                                          // so ldmatrix reads no bank twice
constexpr int kTile = LMAX * kRow;        // elements of one (L, 64) tile
constexpr int kStages = 4;                // x tiles in the ring
constexpr int kMsgF32 = kCP * kCN;        // a message: the state, float32
constexpr int kMsgBytes = kMsgF32 * 4;
constexpr int kVecs = 3;                  // float32 vectors of LMAX per head
constexpr int kMaxHeads = 16;
constexpr int kMaxRanks = 16;
constexpr int kBarBytes = 64;             // full[2], empty[2]

// barriers | two message slots | x ring | B | C (then h_{c-1} as bf16
// pairs) | x sdec as bf16 pairs | y | per head [heads][LMAX]: cum, dt, the
// decay's column factor | cum_L and exp(cum_L) per head
inline size_t cluster_smem_bytes(int heads) {
  return kBarBytes + 2 * static_cast<size_t>(kMsgBytes)
         + static_cast<size_t>(kStages + 4) * kTile * sizeof(bf16)
         + static_cast<size_t>(LMAX) * kCP * sizeof(bf16)
         + kVecs * static_cast<size_t>(heads) * LMAX * sizeof(float)
         + 2 * ((heads * sizeof(float) + 15) / 16) * 16;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t a, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t a, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// c += a b, m16n8k16, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
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

// (v0, v1) as the sum of two bf16 pairs, so a product of bf16 operands
// keeps ~16 bits of v, not 8: hi = v cut to its top 16 bits (a byte
// permute; exact as a float), lo = bf16(v - hi) (v - hi is exact). One
// float-to-bf16 conversion per pair, the slow instruction here.
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t b0 = __float_as_uint(v0), b1 = __float_as_uint(v1);
  hi = __byte_perm(b0, b1, 0x7632);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      v0 - __uint_as_float(b0 & 0xffff0000u),
      v1 - __uint_as_float(b1 & 0xffff0000u));
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// two bf16 (low: the lower index) times two float32 scales, split
__device__ __forceinline__ void scale_split(uint32_t u, float2 s, uint32_t& hi,
                                            uint32_t& lo) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  split_bf16(f.x * s.x, f.y * s.y, hi, lo);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// waits for the phase of this parity to complete; acquire at cluster scope,
// so what another rank wrote (st.async) or read before arriving is ordered.
// A wait past ~10 s of clock traps (a launch error) rather than hang.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > 20000000000LL) __trap();
  } while (!done);
}
// arrive on an mbarrier of another rank (its shared::cluster address)
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          bar)
      : "memory");
}
__device__ __forceinline__ uint32_t map_rank(uint32_t local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  return remote;
}
// 16 bytes into another rank's shared memory, completing `bar` there by
// their count
__device__ __forceinline__ void st_async_f32x4(uint32_t dst, float a, float b,
                                               float c, float d,
                                               uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// exp(cum_i - cum_j) for j <= i, else 0 (the exponent masked first, so
// it never overflows)
__device__ __forceinline__ float decay(int i, int j, float ci, float cj) {
  return __expf(j <= i ? ci - cj : __int_as_float(0xff800000));
}

// Grid (R, head groups, B) in clusters of (R, 1, 1): blockIdx.x is the rank.
// x, Bm and Cm rows start on 16 bytes (the wrapper checks). The mma and
// ldmatrix statements issue in source order, so each product's operands
// are loaded ahead of it and a pair's two products on one accumulator are
// kept apart.
__global__ void __launch_bounds__(kCThreads, 1)
ssd_scan_cluster(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const bf16* __restrict__ Bm,
                 const bf16* __restrict__ Cm, bf16* __restrict__ y,
                 float* __restrict__ state, int S, int H, int L, int heads,
                 Strides sx, Strides sdt, Strides sb, Strides sc) {
  extern __shared__ __align__(128) unsigned char smem_c[];
  // full[s] at bar0 + 8 s, empty[s] at bar0 + 16 + 8 s
  const uint32_t bar0 = smem_u32(smem_c);
  unsigned char* slots = smem_c + kBarBytes;       // [2][kMsgBytes]
  bf16* xs = reinterpret_cast<bf16*>(slots + 2 * kMsgBytes);  // [kStages]
  bf16* Bs = xs + kStages * kTile;
  // C, then (once G and C's fragments are taken) h_{c-1} as bf16 pairs in
  // the cross term's B-fragment order: hi [16-column block of n][16-row
  // block of p][lane][4], then lo
  bf16* Cs = Bs + kTile;
  const uint4* hhi = reinterpret_cast<const uint4*>(Cs);
  const uint4* hlo = hhi + kMsgF32 / 8;
  // x sdec as bf16 pairs (hi, lo), rows as x's; y's tile: rows of 128
  // bytes whose 16-byte chunk c sits at c ^ (row & 7)
  bf16* xh = Cs + kTile;
  bf16* xl = xh + kTile;
  unsigned char* ys = reinterpret_cast<unsigned char*>(xl + kTile);
  float* cumv = reinterpret_cast<float*>(ys + LMAX * kCP * 2);  // [heads][LMAX]
  float* dtv = cumv + heads * LMAX;
  // exp(cum_l - cum_j) dt_j, l the last row of j's 16-row block
  float* cfv = dtv + heads * LMAX;
  float* tov = cfv + heads * LMAX;                     // cum_L
  float* etv = tov + (heads + 3) / 4 * 4;              // exp(cum_L)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;       // mma fragment coordinates
  const int mi = lane >> 3, r8 = lane & 7;     // ldmatrix row of this lane
  const int R = gridDim.x, rank = blockIdx.x;
  const int h0 = blockIdx.y * heads, nh = min(heads, H - h0);
  const int b = blockIdx.z;
  const int n_chunks = S / L, tiles = L / 16;
  const uint32_t next = (rank + 1) % R, prev = (rank + R - 1) % R;
  // warp w owns y rows [16 rt, 16 rt + 16): rt = w for w < 4, 11 - w
  // above, so warps w and w + 4 (one SM sub-partition) hold row tiles rt
  // and 7 - rt, whose causal products add up to the same 9 blocks
  const int rt = warp < 4 ? warp : 11 - warp;
  const bool rows = rt < tiles;
  const int mt = warp & 3, nq = warp >> 2;  // h_in rows 16 mt, cols 32 nq

  // messages this rank takes in over the whole scan
  int n_recv = 0;
  for (int c = rank; c < n_chunks; c += R) n_recv += c >= 1 ? nh : 0;

  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(bar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync_all();  // every rank's barriers exist before any message

  auto load_x = [&](int k, int t0) {  // head k's (L, 64) tile of x
    if (k < nh) {
      const bf16* src = x + b * sx.b + static_cast<int64_t>(t0) * sx.s
                        + (h0 + k) * sx.h;
      const uint32_t dst = smem_u32(xs + (k % kStages) * kTile);
#pragma unroll 4
      for (int i = tid; i < L * 8; i += kCThreads) {
        const int r = i >> 3, q = i & 7;
        cp_async16(dst + (r * kRow + q * 8) * 2, src + r * sx.s + q * 8);
      }
    }
    cp_async_commit();
  };

  int mr = 0, ms = 0;    // messages received and sent so far
  for (int c = rank; c < n_chunks; c += R) {
    const int t0 = c * L;
    const bool recv = c >= 1, send = c + 1 < n_chunks;
    __syncthreads();  // the last chunk is done with the tiles and vectors

    // the chunk's B and C tiles (one group), x of the first heads, dt
    {
      const bf16* bsrc = Bm + b * sb.b + static_cast<int64_t>(t0) * sb.s;
      const bf16* csrc = Cm + b * sc.b + static_cast<int64_t>(t0) * sc.s;
      const uint32_t bdst = smem_u32(Bs), cdst = smem_u32(Cs);
      for (int i = tid; i < L * 8; i += kCThreads) {
        const int r = i >> 3, q = i & 7;
        cp_async16(bdst + (r * kRow + q * 8) * 2, bsrc + r * sb.s + q * 8);
        cp_async16(cdst + (r * kRow + q * 8) * 2, csrc + r * sc.s + q * 8);
      }
      cp_async_commit();
    }
    for (int k = 0; k < kStages - 1; ++k) load_x(k, t0);
    for (int i = tid; i < nh * L; i += kCThreads) {  // heads fastest
      const int k = i % nh, r = i / nh;
      dtv[k * LMAX + r] =
          dt[b * sdt.b + static_cast<int64_t>(t0 + r) * sdt.s
             + (h0 + k) * sdt.h];
    }
    cp_async_wait<kStages - 2>();  // B, C and head 0's x are in
    __syncthreads();

    // cum per head, a warp per head: 4 steps per lane in order, then a
    // warp scan of the lanes' sums
    for (int k = warp; k < nh; k += kCThreads / 32) {
      const float a_h = A[h0 + k];
      float v[4], s = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * lane + e;
        s += i < L ? dtv[k * LMAX + i] * a_h : 0.0f;
        v[e] = s;
      }
      float inc = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, inc, 1);
      if (lane == 0) excl = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] += excl;
      const float total = __shfl_sync(0xffffffffu, v[3], L / 4 - 1);
      // the last row of this lane's 16-row block (lanes 4 q .. 4 q + 3)
      const float last = __shfl_sync(0xffffffffu, v[3], lane | 3);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * lane + e;
        if (i < L) {
          cumv[k * LMAX + i] = v[e];
          cfv[k * LMAX + i] = expf(last - v[e]) * dtv[k * LMAX + i];
        }
      }
      if (lane == 0) {
        tov[k] = total;
        etv[k] = expf(total);
      }
    }

    __syncthreads();  // cum and the rest are in

    // x sdec of head k as bf16 pairs, once for all warps (h_in's A
    // operand); sdec_j = exp(cum_L - cum_j) dt_j. Warp w takes rows w,
    // w + 8, ..., four at a step, a lane 16 bytes of one; lane m works out
    // row w + 8 m's scale, and the warp shares it.
    auto split_x = [&](int k) {
      const bf16* xt = xs + (k % kStages) * kTile;
      const int rm = warp + 8 * (lane & 15);
      const float sd_m = rm < L ? expf(tov[k] - cumv[k * LMAX + rm])
                                      * dtv[k * LMAX + rm]
                                : 0.0f;
      const int sub = lane >> 3, col = (lane & 7) * 8;
#pragma unroll 4
      for (int base = 0; base < L / 8; base += 4) {
        const int mm = base + sub, r = warp + 8 * mm;
        const float sd = __shfl_sync(0xffffffffu, sd_m, mm & 15);
        if (mm < L / 8) {
          const uint4 u = *reinterpret_cast<const uint4*>(xt + r * kRow + col);
          const float2 s2 = make_float2(sd, sd);
          uint4 hi, lo;
          scale_split(u.x, s2, hi.x, lo.x);
          scale_split(u.y, s2, hi.y, lo.y);
          scale_split(u.z, s2, hi.z, lo.z);
          scale_split(u.w, s2, hi.w, lo.w);
          *reinterpret_cast<uint4*>(xh + r * kRow + col) = hi;
          *reinterpret_cast<uint4*>(xl + r * kRow + col) = lo;
        }
      }
    };
    split_x(0);

    // G = C B^T, rows [16 rt, 16 rt + 16) over the columns j < 16 (rt + 1),
    // once for all heads; C's fragments stay for the cross term
    float gacc[16][4];
    uint32_t cfr[4][4];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[j][e] = 0.0f;
    if (rows) {
      const uint32_t cbase = smem_u32(Cs);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        ldsm_x4(cbase + ((16 * rt + r8 + 8 * (mi & 1)) * kRow + 16 * ks
                         + 8 * (mi >> 1)) * 2,
                cfr[ks]);
      const uint32_t bbase = smem_u32(Bs);
#pragma unroll
      for (int jp = 0; jp < 8; ++jp) {
        if (jp <= rt) {
          uint32_t bf[4][4];
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            ldsm_x4(bbase + ((16 * jp + r8 + 8 * (mi >> 1)) * kRow + 16 * ks
                             + 8 * (mi & 1)) * 2,
                    bf[ks]);
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            mma_bf16(gacc[2 * jp], cfr[ks], bf[ks][0], bf[ks][1]);
            mma_bf16(gacc[2 * jp + 1], cfr[ks], bf[ks][2], bf[ks][3]);
          }
        }
      }
    }

    __syncthreads();  // head 0's x sdec is in; C's tile is free

    // Per head two block barriers: after the chain (every warp is done
    // with x sdec and the message; h_{c-1}'s pairs and the next head's x
    // are in) and before y goes out (y's tile and the next head's x sdec
    // are in). Between them the warps run apart: those with few causal
    // blocks of W x go on to h_in and the chain while the others finish.
    for (int k = 0; k < nh; ++k) {
      // into the buffer of head k - 1, whose x every warp has used
      load_x(k + kStages - 1, t0);
      const uint32_t xb = smem_u32(xs + (k % kStages) * kTile);
      const float* cum = cumv + k * LMAX;
      const float* dtk = dtv + k * LMAX;
      const float* cfk = cfv + k * LMAX;

      // 1. y_in = W x over j <= i, W as a pair of bf16 operands. Off the
      // diagonal block the decay is exp(cum_i - cum_l) exp(cum_l - cum_j),
      // l the block's last column, both factors <= 1; on it the exponent
      // is masked to j <= i before the exp.
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
      if (rows) {
        const int i0 = 16 * rt + g, i1 = i0 + 8;
        const float ci0 = cum[i0], ci1 = cum[i1];
#pragma unroll
        for (int kb = 0; kb < 8; ++kb) {
          if (kb <= rt) {
            const int j0 = 16 * kb + 2 * t, j1 = j0 + 8;
            float w[8];  // (i0, j0), (i0, j0+1), (i1, j0), (i1, j0+1), then j1
            if (kb < rt) {
              const float cl = cum[16 * kb + 15];
              const float2 f0 = *reinterpret_cast<const float2*>(cfk + j0);
              const float2 f1 = *reinterpret_cast<const float2*>(cfk + j1);
              const float r0 = __expf(ci0 - cl), r1 = __expf(ci1 - cl);
              w[0] = gacc[2 * kb][0] * r0 * f0.x;
              w[1] = gacc[2 * kb][1] * r0 * f0.y;
              w[2] = gacc[2 * kb][2] * r1 * f0.x;
              w[3] = gacc[2 * kb][3] * r1 * f0.y;
              w[4] = gacc[2 * kb + 1][0] * r0 * f1.x;
              w[5] = gacc[2 * kb + 1][1] * r0 * f1.y;
              w[6] = gacc[2 * kb + 1][2] * r1 * f1.x;
              w[7] = gacc[2 * kb + 1][3] * r1 * f1.y;
            } else {
              const float2 c0 = *reinterpret_cast<const float2*>(cum + j0);
              const float2 c1 = *reinterpret_cast<const float2*>(cum + j1);
              const float2 d0 = *reinterpret_cast<const float2*>(dtk + j0);
              const float2 d1 = *reinterpret_cast<const float2*>(dtk + j1);
              w[0] = gacc[2 * kb][0] * decay(i0, j0, ci0, c0.x) * d0.x;
              w[1] = gacc[2 * kb][1] * decay(i0, j0 + 1, ci0, c0.y) * d0.y;
              w[2] = gacc[2 * kb][2] * decay(i1, j0, ci1, c0.x) * d0.x;
              w[3] = gacc[2 * kb][3] * decay(i1, j0 + 1, ci1, c0.y) * d0.y;
              w[4] = gacc[2 * kb + 1][0] * decay(i0, j1, ci0, c1.x) * d1.x;
              w[5] = gacc[2 * kb + 1][1] * decay(i0, j1 + 1, ci0, c1.y) * d1.y;
              w[6] = gacc[2 * kb + 1][2] * decay(i1, j1, ci1, c1.x) * d1.x;
              w[7] = gacc[2 * kb + 1][3] * decay(i1, j1 + 1, ci1, c1.y) * d1.y;
            }
            uint32_t bx[4][4];  // x's fragments
#pragma unroll
            for (int pp = 0; pp < 4; ++pp)
              ldsm_x4_t(xb + ((16 * kb + r8 + 8 * (mi & 1)) * kRow + 16 * pp
                              + 8 * (mi >> 1)) * 2,
                        bx[pp]);
            uint32_t ah[4], al[4];  // G's accumulators are W's A fragment
#pragma unroll
            for (int e = 0; e < 4; ++e)
              split_bf16(w[2 * e], w[2 * e + 1], ah[e], al[e]);
#pragma unroll
            for (int pp = 0; pp < 4; ++pp) {
              mma_bf16(acc[2 * pp], ah, bx[pp][0], bx[pp][1]);
              mma_bf16(acc[2 * pp + 1], ah, bx[pp][2], bx[pp][3]);
            }
#pragma unroll
            for (int pp = 0; pp < 4; ++pp) {
              mma_bf16(acc[2 * pp], al, bx[pp][0], bx[pp][1]);
              mma_bf16(acc[2 * pp + 1], al, bx[pp][2], bx[pp][3]);
            }
          }
        }
      }

      // 2. h_in = (x sdec)^T B: rows p in [16 mt, 16 mt + 16), columns n in
      // [32 nq, 32 nq + 32), over the chunk. The next 16 rows' fragments
      // load before this block's products.
      float hacc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[j][e] = 0.0f;
      {
        const uint32_t a_off = ((r8 + 8 * (mi >> 1)) * kRow + 16 * mt
                                + 8 * (mi & 1)) * 2;
        const uint32_t a_hi = smem_u32(xh) + a_off, a_lo = smem_u32(xl) + a_off;
        const uint32_t b_at = smem_u32(Bs) + ((r8 + 8 * (mi & 1)) * kRow
                                              + 32 * nq + 8 * (mi >> 1)) * 2;
        constexpr uint32_t kStep = 16 * kRow * 2;  // 16 rows
        uint32_t fh[4], fl[4], fb0[4], fb1[4];
        ldsm_x4_t(a_hi, fh);
        ldsm_x4_t(a_lo, fl);
        ldsm_x4_t(b_at, fb0);
        ldsm_x4_t(b_at + 32, fb1);
        for (int kb = 0; kb < tiles; ++kb) {
          const uint32_t ah[4] = {fh[0], fh[1], fh[2], fh[3]};
          const uint32_t al[4] = {fl[0], fl[1], fl[2], fl[3]};
          const uint32_t b0[4] = {fb0[0], fb0[1], fb0[2], fb0[3]};
          const uint32_t b1[4] = {fb1[0], fb1[1], fb1[2], fb1[3]};
          if (kb + 1 < tiles) {
            const uint32_t off = (kb + 1) * kStep;
            ldsm_x4_t(a_hi + off, fh);
            ldsm_x4_t(a_lo + off, fl);
            ldsm_x4_t(b_at + off, fb0);
            ldsm_x4_t(b_at + off + 32, fb1);
          }
          mma_bf16(hacc[0], ah, b0[0], b0[1]);
          mma_bf16(hacc[1], ah, b0[2], b0[3]);
          mma_bf16(hacc[2], ah, b1[0], b1[1]);
          mma_bf16(hacc[3], ah, b1[2], b1[3]);
          mma_bf16(hacc[0], al, b0[0], b0[1]);
          mma_bf16(hacc[1], al, b0[2], b0[3]);
          mma_bf16(hacc[2], al, b1[0], b1[1]);
          mma_bf16(hacc[3], al, b1[2], b1[3]);
        }
      }

      // 3. the chain. A message is the state in float32, in the order of
      // h_in's fragments: [warp][n tile][lane][4]. The receiver also lays
      // h_{c-1} out as bf16 pairs for the cross term (in C's tile).
      const int rs = mr & 1;
      if (recv) {
        const float4* in4 =
            reinterpret_cast<const float4*>(slots + rs * kMsgBytes);
        const uint32_t full = bar0 + 8 * rs;
        if (tid == 0) mbar_expect_tx(full, kMsgBytes);
        mbar_wait_cluster(full, (mr >> 1) & 1);
        const float et = etv[k];
        float4 hp[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) hp[nt] = in4[(warp * 4 + nt) * 32 + lane];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          hacc[nt][0] = hp[nt].x * et + hacc[nt][0];
          hacc[nt][1] = hp[nt].y * et + hacc[nt][1];
          hacc[nt][2] = hp[nt].z * et + hacc[nt][2];
          hacc[nt][3] = hp[nt].w * et + hacc[nt][3];
        }
        // this thread's values are h_{c-1}[p][n], p = 16 mt + g (+ 8),
        // n = 32 nq + 8 nt + 2 t (+ 1): in the B fragment of the 16-column
        // block 2 nq + nt / 2, p tiles 2 mt and 2 mt + 1, same lane
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          uint4 vh, vl;
          split_bf16(hp[2 * q].x, hp[2 * q].y, vh.x, vl.x);
          split_bf16(hp[2 * q + 1].x, hp[2 * q + 1].y, vh.y, vl.y);
          split_bf16(hp[2 * q].z, hp[2 * q].w, vh.z, vl.z);
          split_bf16(hp[2 * q + 1].z, hp[2 * q + 1].w, vh.w, vl.w);
          const int at = ((2 * nq + q) * 4 + mt) * 32 + lane;
          const_cast<uint4*>(hhi)[at] = vh;
          const_cast<uint4*>(hlo)[at] = vl;
        }
      }
      if (send) {
        const int ss = ms & 1;
        if (ms >= 2) mbar_wait_cluster(bar0 + 16 + 8 * ss, ((ms >> 1) + 1) & 1);
        const uint32_t dst = map_rank(smem_u32(slots + ss * kMsgBytes), next);
        const uint32_t full = map_rank(bar0 + 8 * ss, next);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          st_async_f32x4(dst + ((warp * 4 + nt) * 32 + lane) * 16,
                         hacc[nt][0], hacc[nt][1], hacc[nt][2], hacc[nt][3],
                         full);
        ++ms;
      } else {  // the last chunk: the final state
        float* st = state + (static_cast<int64_t>(b) * H + h0 + k) * kCP * kCN;
        const int p = 16 * mt + g;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = 32 * nq + 8 * nt + 2 * t;
          *reinterpret_cast<float2*>(st + p * kCN + n) =
              make_float2(hacc[nt][0], hacc[nt][1]);
          *reinterpret_cast<float2*>(st + (p + 8) * kCN + n) =
              make_float2(hacc[nt][2], hacc[nt][3]);
        }
      }
      cp_async_wait<kStages - 2>();  // head k + 1's x is in
      __syncthreads();  // the message is read, h_{c-1}'s pairs and head
                        // k + 1's x are in, every warp is done with x sdec
      if (recv) {
        // the sender waits on this only before its message after next;
        // the last two messages need no release
        if (tid == 0 && mr + 2 < n_recv)
          mbar_arrive_remote(map_rank(bar0 + 16 + 8 * rs, prev));
        ++mr;
      }

      // 4. y += exp(cum_i) C h_{c-1}^T
      if (recv && rows) {
        float cr[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) cr[j][e] = 0.0f;
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) {
          uint4 vh[4], vl[4];
#pragma unroll
          for (int pm = 0; pm < 4; ++pm) {
            vh[pm] = hhi[(kb * 4 + pm) * 32 + lane];
            vl[pm] = hlo[(kb * 4 + pm) * 32 + lane];
          }
#pragma unroll
          for (int pm = 0; pm < 4; ++pm) {
            mma_bf16(cr[2 * pm], cfr[kb], vh[pm].x, vh[pm].y);
            mma_bf16(cr[2 * pm + 1], cfr[kb], vh[pm].z, vh[pm].w);
          }
#pragma unroll
          for (int pm = 0; pm < 4; ++pm) {
            mma_bf16(cr[2 * pm], cfr[kb], vl[pm].x, vl[pm].y);
            mma_bf16(cr[2 * pm + 1], cfr[kb], vl[pm].z, vl[pm].w);
          }
        }
        const float e0 = expf(cum[16 * rt + g]);
        const float e1 = expf(cum[16 * rt + g + 8]);
#pragma unroll
        for (int pt = 0; pt < 8; ++pt) {
          acc[pt][0] += cr[pt][0] * e0;
          acc[pt][1] += cr[pt][1] * e0;
          acc[pt][2] += cr[pt][2] * e1;
          acc[pt][3] += cr[pt][3] * e1;
        }
      }

      // y in bf16: fragments into the staging tile, then whole 128-byte
      // rows out in 16-byte stores; meanwhile the next head's x sdec
      if (rows) {
        const int i0 = 16 * rt + g;
#pragma unroll
        for (int pt = 0; pt < 8; ++pt) {
          const int chunk = ((pt ^ g) << 4) + 4 * t;  // (i0 & 7) == g
          *reinterpret_cast<uint32_t*>(ys + i0 * 128 + chunk) =
              pack_bf16(acc[pt][0], acc[pt][1]);
          *reinterpret_cast<uint32_t*>(ys + (i0 + 8) * 128 + chunk) =
              pack_bf16(acc[pt][2], acc[pt][3]);
        }
      }
      if (k + 1 < nh) split_x(k + 1);
      __syncthreads();
      bf16* yh = y + ((static_cast<int64_t>(b) * S + t0) * H + h0 + k) * kCP;
#pragma unroll 4
      for (int i = tid; i < L * 8; i += kCThreads) {
        const int r = i >> 3, q = i & 7;
        *reinterpret_cast<uint4*>(yh + static_cast<int64_t>(r) * H * kCP
                                  + q * 8) =
            *reinterpret_cast<const uint4*>(ys + r * 128
                                            + ((q ^ (r & 7)) << 4));
      }
    }
  }
  cp_async_wait<0>();
}

bool takes_cluster(int P, int N, int L, int dtype) {
  return dtype == 1 && P == kCP && N == kCN && L % 16 == 0 && L >= 16 &&
         L <= LMAX;
}

// Launches the cluster body, or with `max_clusters` set fills it with
// cudaOccupancyMaxActiveClusters for this cluster and launches nothing.
int launch_cluster(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, void* state, int B,
                   int S, int H, int L, int ranks, int heads,
                   const int64_t* st, cudaStream_t stream,
                   int* max_clusters) {
  // one rank over several chunks would send to itself; where the chunks
  // wrap past the last rank, 2 x ranks heads or more would deadlock (each
  // rank runs at most two messages ahead, and rank 0 takes the last
  // rank's messages only after its own earlier chunk)
  if (ranks < 1 || ranks > kMaxRanks || (ranks & (ranks - 1)) ||
      (ranks == 1 && S > L) || heads < 1 || heads > kMaxHeads ||
      (S / L > ranks && heads >= 2 * ranks))
    return static_cast<int>(cudaErrorInvalidValue);
  // rows of x, Bm and Cm in 16-byte pieces (dt's strides are free; a
  // stride over an axis of one element is never used)
  const bool used[10] = {B > 1, true, H > 1, false, false, false,
                         B > 1, true, B > 1, true};
  for (int i = 0; i < 10; ++i)
    if (used[i] && st[i] % 8) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = cluster_smem_bytes(heads);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess && ranks > 8)
    e = cudaFuncSetAttribute(ssd_scan_cluster,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, (H + heads - 1) / heads, B);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr)
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(max_clusters, ssd_scan_cluster, &cfg));
  const Strides sx{st[0], st[1], st[2]}, sdt{st[3], st[4], st[5]};
  const Strides sb{st[6], st[7], 0}, sc{st[8], st[9], 0};
  e = cudaLaunchKernelEx(
      &cfg, ssd_scan_cluster, static_cast<const bf16*>(x),
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm),
      static_cast<bf16*>(y), static_cast<float*>(state), S, H, L, heads, sx,
      sdt, sb, sc);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

enum Body { kScalar = 0, kCluster = 1 };

}  // namespace

extern "C" {

// The limits of one block's tiles; the wrapper checks the shapes against
// them before it launches.
int ssm_scan_limits(int which) {
  return which == 0 ? LMAX : which == 1 ? PMAX : NMAX;
}

// Shared memory per block of `body` (0 scalar, 1 cluster with `heads`
// heads per block); -1 for a head count the cluster body does not take.
// The wrapper's plan holds the same formulas (kernels/ssm_scan.py).
long long ssm_scan_smem(int body, int heads) {
  if (body == kCluster)
    return heads >= 1 && heads <= kMaxHeads
               ? static_cast<long long>(cluster_smem_bytes(heads))
               : -1;
  return static_cast<long long>(kSmemBytes);
}

// How many clusters of the cluster body (`ranks` blocks of `heads` heads)
// the card holds at once (cudaOccupancyMaxActiveClusters), into *out.
// Returns a cudaError_t.
int ssm_scan_max_clusters(int ranks, int heads, int* out) {
  *out = 0;
  const int64_t st[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  return launch_cluster(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                        nullptr, 1, LMAX, heads, LMAX, ranks, heads, st,
                        nullptr, out);
}

// strides (elements): x b, s, h; dt b, s, h; Bm b, s; Cm b, s.
// dtype: 0 float32, 1 bfloat16 (x, Bm, Cm and y). body: 0 scalar (any
// L <= 128, P <= 64, N <= 64), 1 cluster (bf16, P = N = 64, L % 16 == 0;
// `ranks` blocks per cluster, a power of two up to 16, `heads` heads per
// block up to 16; x's, Bm's and Cm's rows on 16 bytes). Returns a
// cudaError_t.
int ssm_scan(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, void* y, void* state, int B, int S, int H,
             int P, int N, int L, const int64_t* strides, int dtype, int body,
             int ranks, int heads, void* stream) {
  if (L <= 0 || L > LMAX || S % L || P > PMAX || N > NMAX || P <= 0 ||
      N <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == kCluster) {
    if (!takes_cluster(P, N, L, dtype))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_cluster(x, dt, A, Bm, Cm, y, state, B, S, H, L, ranks,
                          heads, strides, s, nullptr);
  }
  if (body != kScalar) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_scalar<float>(x, dt, A, Bm, Cm, y, state, B, S, H, P, N,
                                L, strides, s);
  return launch_scalar<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, B, S, H, P,
                                      N, L, strides, s);
}

}  // extern "C"
