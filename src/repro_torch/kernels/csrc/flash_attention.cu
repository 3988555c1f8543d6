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
// carries the online-softmax state in VMEM scratch. Here one block owns
// one (b, h, q tile) and walks the k tiles in a loop, keeping the state
// in registers. The softmax runs in the reference's order: m_new =
// max(m, rowmax s), p = exp(s - m_new), alpha = exp(m - m_new), l =
// alpha l + sum p, acc = alpha acc + p v, and the output is acc /
// max(l, 1e-30). The loop bounds skip every k tile that lies wholly
// above the diagonal or outside the window, so those tiles are never
// loaded; the tails of S are masked (and zero-filled), so any S works.
// Two bodies, chosen by type and head dim:
//
// - bf16 with D % 16 == 0, D <= 256 (the serve path: D 128 and 80):
//   flash_fwd_wgmma, Hopper's warp-specialised form. One persistent
//   block of three warpgroups on each SM walks a share of the (b, h,
//   128-row q tile) work items, so one item's loads run under the last
//   one's products and no SM waits for a block to end and the next to
//   start. Warpgroup 0 is the producer: one thread loads each item's Q
//   tile (once its predecessor's scores are done with the buffer) and
//   the K and V tiles into a ring of 3
//   stages (2 above D 128's tile sizes, where 3 do not fit) in shared
//   memory with TMA (cp.async.bulk.tensor over a 4-d tensor map of the
//   (B, S, heads, D) strides, no copy of q, k or v), each stage guarded
//   by full and empty mbarriers, so the loads run ahead of the products.
//   Warpgroups 1 and 2 are the consumers, 64 query rows each. S = Q K^T
//   is wgmma m64nBKk16 with Q and K read from shared memory through
//   descriptors (D / 16 k-steps, 5 at D 80). The online softmax runs on
//   the accumulators in registers (exp2 with the scale and log2(e)
//   folded into one FMA), and only the tiles that hold a masked key (the
//   diagonal, the window's edge, the ragged end of S) are masked. P is
//   rounded to bf16, as the plain version rounds the probabilities to
//   q's type, and stays in registers as wgmma's A operand for O += P V,
//   with V read from shared memory as the MN-major B operand (the
//   descriptor's transpose bit), so V is never transposed by hand. Tile
//   i's scores are issued together with tile i - 1's PV product, so the
//   tensor cores run the one while the softmax waits on the other, and
//   two named barriers take the consumers in turns, so one issues its
//   products while the other runs its softmax. setmaxnreg moves
//   registers from the producer (40) to the consumers (232). A head's q
//   tiles are consecutive items, ordered last, first, last but one, ...,
//   and block c takes items c, c + P, c + 2 P, ... with P (at most the
//   SMs) coprime to the q tiles per head: the blocks at work together
//   share each head's K and V through L2, and every block steps through
//   long and short q tiles alike. The serve path's head dims (64, 80,
//   96, 128) are compiled as constants; the others read D at run time.
//   Shared-memory layout: the head dim is cut into 64-column slabs of
//   128-byte rows with the 128-byte swizzle, each slab one TMA box, and
//   a head dim that is not a multiple of 64 (80 = 64 + 16) reads its
//   last slab as a box whose columns past D the TMA fills with zeros.
//   The QK^T k-steps stop at D, so the zeros cost shared memory only;
//   the PV product runs one wgmma per slab at that slab's width (n64,
//   then n16 at D 80), so no instruction spans two slabs and none
//   computes a padded column. Tiles: 128 keys up to D 128 (two slabs),
//   64 keys above.
// - float32, and bf16 with D % 16 == 8: scalar f32 FMAs from shared
//   memory, flash_fwd. One block of 128 threads owns a 64-row q tile;
//   each thread holds 4 query rows by 8 keys of the score tile and 4
//   rows by D/8 columns of the accumulator; Q and K are staged
//   transposed (d-major) and V row-major, in float32, so the inner
//   products read conflict-free 16-byte vectors.
//
// What bounds it on this card: at the serve path's prefill (B = 8,
// S = 1024, H = 32, Hkv = 8, D = 128, bf16) the causal triangle needs
// 69 GFLOP against 168 MB of q, k, v and output, so the bf16 tensor-core
// peak (989 TFLOP/s, 0.07 ms) is the bound; at zamba2's (H = Hkv = 32,
// D = 80) 43 GFLOP against 168 MB, so the bytes (0.05 ms). The wgmma
// body keeps the tensor cores fed from shared memory while TMA streams
// the next tiles; what it still leaves on the table (the diagonal tile
// computing its masked half, the softmax's exp and rescale between
// products, a static split of uneven work items) is measured in
// PERF.md.
//
// The tensor maps are encoded on the host per call with
// cuTensorMapEncodeTiled, looked up in libcuda at run time, so the
// library links only the CUDA runtime, as the other kernels do.

#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda.h>
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
// bf16 on Hopper: TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;  // producer warpgroup + two consumers
constexpr int WBQ = 128;         // q rows per block, 64 per consumer
constexpr int kRowBytes = 128;   // one slab row: 64 bf16, the swizzle span

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          bar)
      : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA box of a 4-d tensor map into shared memory; completion (in
// bytes) is reported to `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Orders the compiler's uses of accumulator registers after the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared
// memory; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared
// memory; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 16] += A[64 x 16] B[16 x 16], A from registers, B MN-major
// in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// D[64 x 32] += A[64 x 16] B[16 x 32], A from registers, B MN-major
// in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// D[64 x 48] += A[64 x 16] B[16 x 48], A from registers, B MN-major
// in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n48(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers, B MN-major
// in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// Tile sizes of the wgmma body for NS slabs of 64 head-dim columns: a
// 3-stage K/V ring where it fits in the 227 KB, else 2 stages.
template <int NS>
struct WgTile {
  static constexpr int BKW = NS <= 2 ? 128 : 64;         // keys per k tile
  static constexpr int Q_BYTES = NS * WBQ * kRowBytes;
  static constexpr int KV_BYTES = NS * BKW * kRowBytes;  // K or V, one stage
  static constexpr int STAGES =
      Q_BYTES + 6 * KV_BYTES + 1024 + 128 <= 232448 ? 3 : 2;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
  // 1024 bytes of slack to align the base to the swizzle's 1024-byte
  // atom; 128 for the mbarriers (Q full and empty, 3 per stage)
  static constexpr int SMEM = 1024 + BAR_OFF + 128;
};

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One persistent block per SM: three warpgroups that walk their share
// of the (b, h, 128-row q tile) work items; see the header. tq, tk, tv
// map (D, S, heads, B) with box (64, rows, 1, 1). DX is the head dim
// when it is fixed at compile time (the serve path's), else 0 and D is
// read at run time.
template <int NS, int DX>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ out, Strides so, int B, int S,
                int H, int Drt, int group, float scale, int causal,
                int window) {
  using Tile = WgTile<NS>;
  constexpr int BKW = Tile::BKW;
  constexpr int ST = Tile::STAGES;
  const int D = DX > 0 ? DX : Drt;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t bars = base + Tile::BAR_OFF;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int st) { return bars + 16 + 8 * st; };
  auto v_full = [&](int st) { return bars + 16 + 8 * ST + 8 * st; };
  auto empty = [&](int st) { return bars + 16 + 16 * ST + 8 * st; };
  auto sK = [&](int st) {
    return base + Tile::Q_BYTES + st * 2 * Tile::KV_BYTES;
  };
  auto sV = [&](int st) { return sK(st) + Tile::KV_BYTES; };

  const int tid = threadIdx.x;
  // the warpgroup, broadcast so that the compiler sees it is uniform
  // across the warp (the softmax's shuffles then need no convergence code)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int n_q = (S + WBQ - 1) / WBQ;
  const int items = n_q * H * B;
  // work item i: its q tile, head and batch row, and its k tiles [lo, lo
  // + n): none wholly above the diagonal or outside the window. A
  // head's q tiles are consecutive items, in the order last, first, last
  // but one, second, ...; block c takes the items c, c + P, c + 2 P, ...
  // (P = gridDim.x). The blocks at work at one time thus hold all q
  // tiles of a few heads, which read each K and V tile from device
  // memory once and from L2 after; and as the host picks P coprime to
  // the q tiles per head, each block steps through every position of
  // that order in turn, long tiles and short ones alike.
  struct Item {
    int q0, h, b, lo, n;
  };
  auto item = [&](int i) {
    Item it;
    const int kq = i % n_q, hb = i / n_q;
    it.q0 = (kq % 2 == 0 ? n_q - 1 - kq / 2 : kq / 2) * WBQ;
    it.h = hb % H;
    it.b = hb / H;
    const int n_k = (S + BKW - 1) / BKW;
    int hi = n_k, lo = 0;
    if (causal) {
      const int last = (it.q0 + WBQ - 1 < S - 1 ? it.q0 + WBQ - 1 : S - 1);
      hi = last / BKW + 1;
    }
    if (window > 0) {
      const int first = it.q0 - window + 1;
      lo = first > 0 ? first / BKW : 0;
    }
    it.lo = lo;
    it.n = hi - lo;
    return it;
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2 * 128);
    for (int st = 0; st < ST; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int g = 0;  // k tiles loaded so far, over all items: the ring's clock
      for (int i = blockIdx.x, j = 0; i < items; i += gridDim.x, ++j) {
        const Item it = item(i);
        // the previous item's scores are done with Q
        if (j > 0) mbar_wait(q_empty, (j - 1) & 1);
        mbar_expect_tx(q_full, Tile::Q_BYTES);
#pragma unroll
        for (int s = 0; s < NS; ++s)
          tma_load_4d(sQ + s * WBQ * kRowBytes, &tq, q_full, s * 64, it.q0,
                      it.h, it.b);
        const int hk = it.h / group;
        for (int t = 0; t < it.n; ++t, ++g) {
          const int st = g % ST, round = g / ST;
          if (round > 0) mbar_wait(empty(st), (round - 1) & 1);
          const int k0 = (it.lo + t) * BKW;
          mbar_expect_tx(k_full(st), Tile::KV_BYTES);
#pragma unroll
          for (int s = 0; s < NS; ++s)
            tma_load_4d(sK(st) + s * BKW * kRowBytes, &tk, k_full(st),
                        s * 64, k0, hk, it.b);
          mbar_expect_tx(v_full(st), Tile::KV_BYTES);
#pragma unroll
          for (int s = 0; s < NS; ++s)
            tma_load_4d(sV(st) + s * BKW * kRowBytes, &tv, v_full(st),
                        s * 64, k0, hk, it.b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;              // rows cw * 64 .. cw * 64 + 63
    const int t = tid & 127, w = t >> 5, lane = t & 31;
    const int g = lane >> 2, tq4 = lane & 3;
    const int ksteps = D / 16;
    const int tail = D - (NS - 1) * 64;  // width of the last slab
    // exp(x * scale) = exp2(x * scale * log2(e))
    const float sl2 = scale * 1.4426950408889634f;
    // named barriers 1 and 2 take turns between the two consumers: one
    // issues its products while the other runs its softmax
    const int my_turn = 1 + cw, their_turn = 2 - cw;

    float o[NS * 8][4];
    float m_i[2], l_i[2];
    int row0 = 0, qpos0 = 0;  // this warpgroup's first row; this thread's
    float s[BKW / 8][4];
    uint32_t pa[BKW / 16][4];

    // S = Q K^T of the k tile in stage st (issued, not waited for)
    auto issue_qk = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < NS * 4; ++kk) {
        if (kk < ksteps) {
          const uint32_t slab = kk >> 2, col = (kk & 3) * 32;
          const uint64_t da = desc_sw128(
              sQ + slab * WBQ * kRowBytes + cw * 64 * kRowBytes + col, 16,
              1024);
          const uint64_t db =
              desc_sw128(sK(st) + slab * BKW * kRowBytes + col, 16, 1024);
          if constexpr (BKW == 128)
            wgmma_ss_n128(&s[0][0], da, db, kk > 0);
          else
            wgmma_ss_n64(&s[0][0], da, db, kk > 0);
        }
      }
      wgmma_commit();
    };
    // O += P V of the k tile in stage st, P from registers
    auto issue_pv = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < BKW / 16; ++kk) {
#pragma unroll
        for (int sl = 0; sl < NS; ++sl) {
          const uint64_t db = desc_sw128(
              sV(st) + sl * BKW * kRowBytes + kk * 16 * kRowBytes,
              BKW * kRowBytes, 1024);
          float* acc = &o[sl * 8][0];
          if (sl < NS - 1 || tail == 64)
            wgmma_rs_n64(acc, pa[kk], db);
          else if (tail == 48)
            wgmma_rs_n48(acc, pa[kk], db);
          else if (tail == 32)
            wgmma_rs_n32(acc, pa[kk], db);
          else
            wgmma_rs_n16(acc, pa[kk], db);
        }
      }
      wgmma_commit();
    };
    // the online softmax of tile k0's scores: s becomes p (unrounded),
    // and the factor the accumulator is to be rescaled by is returned
    auto softmax = [&](int k0, float* alpha) {
      const bool need_mask =
          k0 + BKW > S || (causal && k0 + BKW - 1 > row0) ||
          (window > 0 && k0 <= row0 + 63 - window);
      float mx[2] = {-INFINITY, -INFINITY};
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < BKW / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qpos = qpos0 + (e >> 1) * 8;
            const int kpos = k0 + j * 8 + tq4 * 2 + (e & 1);
            bool ok = kpos < S;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            if (!ok) s[j][e] = -INFINITY;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
      } else {
#pragma unroll
        for (int j = 0; j < BKW / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
      float mb[2];  // -m_new * scale * log2(e)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_i[r], mx[r]);
        alpha[r] = exp2_approx((m_i[r] - m_new) * sl2);
        m_i[r] = m_new;
        mb[r] = -m_new * sl2;
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < BKW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2_approx(fmaf(s[j][e], sl2, mb[e >> 1]));
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l_i[r] = alpha[r] * l_i[r] + sum[r];
      }
    };
    // acc *= alpha, and P (bf16) into wgmma's A fragments: the
    // accumulator layout of S is the A-fragment layout of a 16-key step
    auto rescale_and_pack = [&](const float* alpha) {
#pragma unroll
      for (int j = 0; j < NS * 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
#pragma unroll
      for (int kk = 0; kk < BKW / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
    };

    // Tile i's scores are issued together with tile i - 1's PV product,
    // so the tensor cores run the one while the softmax waits for the
    // other; the rescale by alpha_i still precedes P_i V_i. The ring's
    // clock runs on over the items, as the producer's does.
    float alpha[2];
    if (cw == 0) named_arrive(my_turn);  // the first consumer goes first
    int gt = 0;  // k tiles consumed so far, over all items
    for (int i = blockIdx.x, j = 0; i < items; i += gridDim.x, ++j) {
      const Item it = item(i);
      const bool last_item = i + static_cast<int>(gridDim.x) >= items;
      row0 = it.q0 + cw * 64;
      // s[j][0], s[j][1] hold row qpos0; s[j][2], s[j][3] row qpos0 + 8
      qpos0 = row0 + w * 16 + g;
#pragma unroll
      for (int jj = 0; jj < NS * 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[jj][e] = 0.0f;
      m_i[0] = m_i[1] = kMInit;
      l_i[0] = l_i[1] = 0.0f;
      const int n = it.n, lo = it.lo;
      mbar_wait(q_full, j & 1);
      mbar_wait(k_full(gt % ST), (gt / ST) & 1);
      named_sync(my_turn);
      wgmma_fence();
      issue_qk(gt % ST);
      named_arrive(their_turn);
      wgmma_wait_all();
      fence_regs<BKW / 2>(&s[0][0]);
      if (n == 1) mbar_arrive(q_empty);  // the item's scores are done
      softmax(lo * BKW, alpha);
      rescale_and_pack(alpha);
      for (int t = 1; t < n; ++t) {
        const int st = (gt + t) % ST, pst = (gt + t - 1) % ST;
        mbar_wait(k_full(st), ((gt + t) / ST) & 1);
        mbar_wait(v_full(pst), ((gt + t - 1) / ST) & 1);
        named_sync(my_turn);
        wgmma_fence();
        issue_qk(st);
        issue_pv(pst);
        named_arrive(their_turn);
        wgmma_wait_one();  // the scores; the PV product may still run
        fence_regs<BKW / 2>(&s[0][0]);
        if (t == n - 1) mbar_arrive(q_empty);  // the item's scores are done
        softmax((lo + t) * BKW, alpha);
        wgmma_wait_all();
        fence_regs<NS * 32>(&o[0][0]);
        mbar_arrive(empty(pst));
        rescale_and_pack(alpha);
      }
      const int pst = (gt + n - 1) % ST;
      mbar_wait(v_full(pst), ((gt + n - 1) / ST) & 1);
      named_sync(my_turn);
      wgmma_fence();
      issue_pv(pst);
      // the second consumer's last turn needs this arrival; the first's
      // would be left over, so the second gives none after its last item
      if (cw == 0 || !last_item) named_arrive(their_turn);
      wgmma_wait_all();
      fence_regs<NS * 32>(&o[0][0]);
      mbar_arrive(empty(pst));
      gt += n;

      __nv_bfloat16* ob = out + it.b * so.b + it.h * so.h;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qpos = qpos0 + r * 8;
        if (qpos >= S) continue;
        const float l = fmaxf(l_i[r], 1e-30f);
#pragma unroll
        for (int jj = 0; jj < NS * 8; ++jj) {
          const int d = jj * 8 + tq4 * 2;
          if (d < D)
            *reinterpret_cast<uint32_t*>(ob + qpos * so.s + d) =
                pack_bf16(o[jj][2 * r] / l, o[jj][2 * r + 1] / l);
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, or nullptr.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d map of a bf16 (B, S, heads, D) tensor with element strides st,
// read in boxes of (64 columns, rows, 1, 1) with the 128-byte swizzle;
// what lies past D or S reads as zeros. A stride of an axis of size 1 is
// never used and is replaced by one TMA accepts.
int make_map(EncodeTiled enc, CUtensorMap* map, const void* p, int B, int S,
             int heads, int D, Strides st, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const int64_t es = sizeof(__nv_bfloat16);
  int64_t sb[3] = {st.s * es, st.h * es, st.b * es};
  const int64_t extent[3] = {S, heads, B};
  int64_t prev = D * es;
  for (int i = 0; i < 3; ++i) {
    if (extent[i] == 1) sb[i] = (prev + 15) / 16 * 16;
    prev = sb[i] * extent[i];
  }
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sb[0]),
                                 static_cast<cuuint64_t>(sb[1]),
                                 static_cast<cuuint64_t>(sb[2])};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int NS, int DX>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int H, int Hkv, int D, const Strides* st,
                 float scale, int causal, int window, cudaStream_t stream) {
  using Tile = WgTile<NS>;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mq, mk, mv;
  int e = make_map(enc, &mq, q, B, S, H, D, st[0], WBQ);
  if (e == 0) e = make_map(enc, &mk, k, B, S, Hkv, D, st[1], Tile::BKW);
  if (e == 0) e = make_map(enc, &mv, v, B, S, Hkv, D, st[2], Tile::BKW);
  if (e != 0) return e;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma<NS, DX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  // one persistent block per SM, none without a work item, and their
  // number coprime to the q tiles per head (see the kernel)
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_q = (S + WBQ - 1) / WBQ;
  const int items = n_q * H * B;
  int grid = items < sms ? items : sms;
  auto coprime = [](int a, int b) {
    while (b != 0) {
      const int r = a % b;
      a = b;
      b = r;
    }
    return a == 1;
  };
  while (grid > 1 && !coprime(grid, n_q)) --grid;
  flash_fwd_wgmma<NS, DX><<<grid, kWgThreads, Tile::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), st[3], B, S, H, D,
      H / Hkv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int H, int Hkv, int D, const Strides* st, float scale,
             int causal, int window, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // the serve path's head dims are fixed at compile time; the others
    // read D at run time in the instance of their slab count
#define FLASH_WGMMA(NS, DX)                                                  \
  return launch_wgmma<NS, DX>(q, k, v, out, B, S, H, Hkv, D, st, scale,     \
                              causal, window, stream)
    if (D % 16 == 0) {
      switch (D) {
        case 64: FLASH_WGMMA(1, 64);
        case 80: FLASH_WGMMA(2, 80);
        case 96: FLASH_WGMMA(2, 96);
        case 128: FLASH_WGMMA(2, 128);
        default: break;
      }
      switch ((D + 63) / 64) {
        case 1: FLASH_WGMMA(1, 0);
        case 2: FLASH_WGMMA(2, 0);
        case 3: FLASH_WGMMA(3, 0);
        default: FLASH_WGMMA(4, 0);
      }
    }
#undef FLASH_WGMMA
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
