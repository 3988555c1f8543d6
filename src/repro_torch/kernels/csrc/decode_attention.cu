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
// Design (flash-decoding, split and combine in one launch). The TPU
// kernel runs one grid program per (b, query head) and walks L along a
// sequential grid axis. Here the grid is (splits, Hkv, B): the `splits`
// blocks of one (b, KV head) form one thread-block cluster, each taking a
// chunk of `chunk` positions of the cache. The host picks splits from
// the cache's capacity L and the grid's size, never from cache_len (which
// stays on the card): they double, up to 8, while each chunk keeps at
// least 64 positions and the whole grid still fits on the card at once
// (the SMs times the blocks one SM holds), so no block waits for another
// to end; the launch asks the scheduler to balance the clusters over the
// SMs. A block serves all G = H / Hkv query heads of its KV head, so
// each K and V row is read from device memory once per step. It streams
// its chunk through a ring of tiles in shared memory with 16-byte
// cp.async loads (bf16 stays bf16; rows padded by 16 bytes so the reads
// are conflict-free), the next tiles' loads in flight while one is
// computed; rows past min(cache_len, L) are filled with zeros and masked,
// and a chunk that starts past it loads nothing and leaves (m = -1e30,
// l = 0, acc = 0). Two bodies, chosen by type and shape:
//
// - bf16 with D % 16 == 0 and G <= 16 (the serve path: G 4 at D 128, G 1
//   at D 80): decode_fwd_mma. The G query heads are the rows of an
//   m16n8k16 tensor-core product (rows past G are zero). For each tile of
//   32 positions every warp computes S = Q K^T and the online softmax on
//   its accumulators, identically, then its quarter of the columns of
//   O += P V (P rounded to bf16, as the plain version rounds the
//   probabilities to q's type, and kept in registers; V read with
//   ldmatrix.trans). The products cost little next to the loads, so
//   all four warps keep working on every tile.
// - float32, and other bf16 shapes: decode_fwd_split, on the CUDA cores.
//   A tile is cut into 32-position subtiles, and each (subtile, query
//   head) pair is a work item of one warp with its own online-softmax
//   state in shared memory: the lanes take the positions for the scores
//   and the softmax (warp shuffles), then the head-dim columns for
//   acc = alpha acc + sum p v. Tiles hold 32 nsub positions (nsub = 4,
//   2 and 1 for G = 1, 2 and more), so any group keeps the warps busy,
//   halved where the ring would not fit in a block's shared memory
//   (float32 at D 128 and G 1 takes nsub = 2); each block merges its
//   subtiles' states per head, in order.
//
// The combine: after a cluster barrier the blocks of the cluster share
// the G D outputs, each reading every block's (m, l, acc) through
// distributed shared memory and combining them in split order: m* =
// max m_i, l = sum e^(m_i - m*) l_i, o = sum e^(m_i - m*) acc_i /
// max(l, 1e-30); on request also each row's log-sum-exp m* + log(l),
// which a caller that splits L across cards (flash-decoding over ranks)
// combines by. No second kernel, no atomics, no workspace: one launch
// per call, and the result is the same bits on every run.
//
// What bounds it on this card: bytes. At the serve path's decode (B = 8,
// Hkv = 8, L = 1088, D = 128, bf16) it reads 35.6 MB of cache for 143
// MFLOP, ~11 us at 3.35 TB/s; 8 splits make 512 blocks, four on each
// SM. What still holds it back is latency, not the products: a block's
// fixed chain (cache_len, q, the first tile, two cluster barriers and
// the combine) and a ring of three 32-position tiles that keeps only two
// loads ahead; PERF.md has the times.

#include <cmath>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 8;
constexpr int kScalarStages = 2;  // tiles in the scalar body's ring
constexpr int kMaxD = 256;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on the card
constexpr float kMInit = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16- and 8-byte shared-memory loads at a shared address
__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ uint2 lds64(uint32_t a) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(a)
               : "memory");
  return v;
}

template <typename T> struct Elem;

template <> struct Elem<float> {
  static constexpr int N = 4;  // elements per 16 bytes
  __device__ static void unpack(const uint4& x, float* f) {
    f[0] = __uint_as_float(x.x);
    f[1] = __uint_as_float(x.y);
    f[2] = __uint_as_float(x.z);
    f[3] = __uint_as_float(x.w);
  }
  __device__ static void load4(uint32_t addr, float* f) {
    const uint4 x = lds128(addr);
    f[0] = __uint_as_float(x.x);
    f[1] = __uint_as_float(x.y);
    f[2] = __uint_as_float(x.z);
    f[3] = __uint_as_float(x.w);
  }
  __device__ static float put(float v) { return v; }
};

template <> struct Elem<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& x, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static void load4(uint32_t addr, float* f) {
    const uint2 x = lds64(addr);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
  __device__ static __nv_bfloat16 put(float v) {
    return __float2bfloat16_rn(v);
  }
};

// How one call is cut: `splits` blocks per (b, KV head), each over
// `chunk` positions; `nsub` 32-position subtiles per tile.
struct Plan {
  int splits, chunk, nsub;
};

size_t smem_bytes(int D, int G, int es, size_t nsub) {
  const size_t tile = 32 * nsub;
  const size_t row = static_cast<size_t>(D) * es + 16;
  return kScalarStages * 2 * tile * row +
         sizeof(float) * (static_cast<size_t>(G) * D + 2 * nsub * G +
                          nsub * G * D + 2 * G +
                          static_cast<size_t>(G) * D);
}

// 4 subtiles for G = 1 and 2 for G = 2 keep all four warps busy on a
// tile; halved while the block would need more shared memory than the
// card has.
int subtiles(int D, int G, int es) {
  int nsub = G == 1 ? 4 : (G == 2 ? 2 : 1);
  while (nsub > 1 && smem_bytes(D, G, es, nsub) > kMaxSmem) nsub /= 2;
  return nsub;
}

// Splits double, up to 8, while each keeps at least 64 positions and
// the grid still fits on the card at once (`resident` blocks: the SMs
// times the blocks one SM holds), so no block waits for another to end.
Plan make_plan(int L, int pairs, int nsub, int resident) {
  Plan p;
  int s = 1;
  while (s < kMaxSplits && L / (2 * s) >= 64 && pairs * 2 * s <= resident)
    s *= 2;
  p.splits = s;
  p.chunk = ((L + s - 1) / s + 7) / 8 * 8;
  p.nsub = nsub;
  return p;
}

size_t smem_bytes(int D, int G, int es) {
  return smem_bytes(D, G, es, subtiles(D, G, es));
}

__device__ __forceinline__ void cp_async16(uint32_t d, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
               ::"r"(d), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `pending` groups are in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The cluster's combine: after a cluster barrier, the blocks of the
// cluster share the G D outputs, and each output reads every block's
// (m, l, acc) through distributed shared memory and combines them in
// split order. Where `lse` is not null, the thread of each head's first
// column also writes that head's log-sum-exp of the scaled scores, m* +
// log(l): -inf for a row with no valid position (every split's l is 0).
// A second barrier keeps every block's memory alive until all have read
// it.
template <typename T>
__device__ __forceinline__ void cluster_combine(cg::cluster_group& cluster,
                                                float* part_m, float* part_l,
                                                float* part_acc, T* ob,
                                                float* lse, int G, int D) {
  const int split = blockIdx.x, splits = gridDim.x, tid = threadIdx.x;
  cluster.sync();  // every block's result is in its shared memory
  for (int i = split * kThreads + tid; i < G * D; i += splits * kThreads) {
    const int g = i / D;
    float pm[kMaxSplits], pl[kMaxSplits], pacc[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < splits) {
        pm[r] = cluster.map_shared_rank(part_m, r)[g];
        pl[r] = cluster.map_shared_rank(part_l, r)[g];
        pacc[r] = cluster.map_shared_rank(part_acc, r)[i];
      }
    }
    float m = kMInit;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < splits) m = fmaxf(m, pm[r]);
    float l = 0.0f, o = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < splits) {
        const float w = expf(pm[r] - m);
        l += w * pl[r];
        o += w * pacc[r];
      }
    }
    ob[i] = Elem<T>::put(o / fmaxf(l, 1e-30f));
    if (lse != nullptr && i % D == 0) lse[g] = m + logf(l);
  }
  cluster.sync();  // no block leaves while another may read its memory
}

// The offset of batch row b's first head in a (B, H) array: H = G Hkv,
// and the grid's y dim runs over the KV heads.
__device__ __forceinline__ int64_t row_of(int b, int G) {
  return static_cast<int64_t>(b) * G * gridDim.y;
}

// The scalar body: float32, and the bf16 shapes the tensor-core body
// does not take (see the header).
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_fwd_split(const T* __restrict__ q, const T* __restrict__ kc,
                 const T* __restrict__ vc,
                 const int32_t* __restrict__ cache_len, T* __restrict__ out,
                 float* __restrict__ lse, int L, int D, int G, Plan plan,
                 int64_t sqb, int64_t skb,
                 int64_t skh, int64_t sks, int64_t svb, int64_t svh,
                 int64_t svs, int64_t sob, float scale) {
  constexpr int N = Elem<T>::N;
  const int nsub = plan.nsub, stages = kScalarStages;
  const int tile = 32 * nsub;
  const int RB = D * static_cast<int>(sizeof(T)) + 16;  // padded row bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t ring = smem_u32(smem);  // [stages][K, V][tile][RB]
  float* qs = reinterpret_cast<float*>(smem + stages * 2 * tile * RB);
  float* st_acc = qs + G * D;              // [G][nsub][D]
  float* part_acc = st_acc + nsub * G * D;  // [G][D]: this block's result
  float* st_m = part_acc + G * D;          // [G][nsub]
  float* st_l = st_m + nsub * G;           // [G][nsub]
  float* part_m = st_l + nsub * G;         // [G]
  float* part_l = part_m + G;              // [G]
  const uint32_t qs_s = smem_u32(qs);

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  // the warp index, broadcast so that the compiler sees it is uniform
  // across the warp (the shuffles below then need no convergence code)
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int h0 = hk * G;
  const int nvec = D / N;
  int n = *cache_len;
  n = n < L ? n : L;
  const int p_begin = split * plan.chunk;
  const int p_end = p_begin + plan.chunk < n ? p_begin + plan.chunk : n;
  const int count = p_end > p_begin ? p_end - p_begin : 0;
  const int n_tiles = (count + tile - 1) / tile;
  const T* kb = kc + b * skb + hk * skh;
  const T* vb = vc + b * svb + hk * svh;

  {
    // q in 16-byte vectors (G D is a multiple of N)
    const T* qb = q + b * sqb + static_cast<int64_t>(h0) * D;
    for (int i = tid; i < G * nvec; i += kThreads) {
      float f[N];
      Elem<T>::unpack(*reinterpret_cast<const uint4*>(qb + i * N), f);
#pragma unroll
      for (int e = 0; e < N; ++e) qs[i * N + e] = f[e];
    }
  }
  for (int i = tid; i < nsub * G; i += kThreads) {
    st_m[i] = kMInit;
    st_l[i] = 0.0f;
  }
  for (int i = tid; i < nsub * G * D; i += kThreads) st_acc[i] = 0.0f;

  // rows past the chunk are filled with zeros
  auto load_tile = [&](int t) {
    const uint32_t kd = ring + (t % stages) * 2 * tile * RB;
    const uint32_t vd = kd + tile * RB;
    const int r0 = p_begin + t * tile;
    for (int i = tid; i < tile * nvec; i += kThreads) {
      const int r = i / nvec, v = i % nvec;
      const bool ok = r0 + r < p_end;
      const int64_t pos = ok ? r0 + r : 0;
      cp_async16(kd + r * RB + v * 16, kb + pos * sks + v * N, ok);
      cp_async16(vd + r * RB + v * 16, vb + pos * svs + v * N, ok);
    }
  };

  for (int t = 0; t < stages - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    if (t + stages - 1 < n_tiles) load_tile(t + stages - 1);
    cp_async_commit();
    cp_async_wait<kScalarStages - 1>();
    __syncthreads();  // tile t (and, the first time, q and the states)
    const uint32_t kd = ring + (t % stages) * 2 * tile * RB;
    const uint32_t vd = kd + tile * RB;
    const int rows = count - t * tile < tile ? count - t * tile : tile;
    for (int item = warp; item < nsub * G; item += kWarps) {
      const int sub = item % nsub, g = item / nsub;
      const int valid = rows - sub * 32 < 32 ? rows - sub * 32 : 32;
      if (valid <= 0) continue;
      const uint32_t kt = kd + sub * 32 * RB, vt = vd + sub * 32 * RB;
      // scores: lane = position
      float s = -INFINITY;
      if (lane < valid) {
        const uint32_t kr = kt + lane * RB;
        const uint32_t qg = qs_s + g * D * 4;
        float a = 0.0f;
        for (int v = 0; v < nvec; ++v) {
          float f[N];
          Elem<T>::unpack(lds128(kr + v * 16), f);
#pragma unroll
          for (int e4 = 0; e4 < N / 4; ++e4) {
            const uint4 qv = lds128(qg + (v * N + 4 * e4) * 4);
            a = fmaf(__uint_as_float(qv.x), f[4 * e4], a);
            a = fmaf(__uint_as_float(qv.y), f[4 * e4 + 1], a);
            a = fmaf(__uint_as_float(qv.z), f[4 * e4 + 2], a);
            a = fmaf(__uint_as_float(qv.w), f[4 * e4 + 3], a);
          }
        }
        s = a * scale;
      }
      const float m_prev = st_m[item];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = expf(s - m_new);  // 0 past the valid rows
      const float sum = warp_sum(p);
      const float alpha = expf(m_prev - m_new);
      // acc = alpha acc + p v: lane = head-dim columns 4 lane + 128 j + e;
      // the rows past `valid` are zeros with p = 0, so all 32 are added
      float* acc = st_acc + item * D;
      float a[kMaxD / 128][4];
#pragma unroll
      for (int j = 0; j < kMaxD / 128; ++j) {
        const int d = 4 * lane + 128 * j;
        const float4 x = d < D ? *reinterpret_cast<const float4*>(acc + d)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        a[j][0] = x.x * alpha;
        a[j][1] = x.y * alpha;
        a[j][2] = x.z * alpha;
        a[j][3] = x.w * alpha;
      }
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const float pc = __shfl_sync(0xffffffffu, p, c);
#pragma unroll
        for (int j = 0; j < kMaxD / 128; ++j) {
          const int d = 4 * lane + 128 * j;
          if (d < D) {
            float f[4];
            Elem<T>::load4(vt + c * RB + d * static_cast<int>(sizeof(T)), f);
#pragma unroll
            for (int e = 0; e < 4; ++e) a[j][e] = fmaf(pc, f[e], a[j][e]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxD / 128; ++j) {
        const int d = 4 * lane + 128 * j;
        if (d < D)
          *reinterpret_cast<float4*>(acc + d) =
              make_float4(a[j][0], a[j][1], a[j][2], a[j][3]);
      }
      __syncwarp();
      if (lane == 0) {
        st_l[item] = alpha * st_l[item] + sum;
        st_m[item] = m_new;
      }
      __syncwarp();
    }
    __syncthreads();  // the tile's readers are done before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();

  // this block's (m, l, acc) per head: its subtiles' states, in order
  // (with one subtile, that state itself)
  if (nsub == 1) {
    part_acc = st_acc;
    part_m = st_m;
    part_l = st_l;
  }
  for (int i = tid; nsub > 1 && i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    const float* m_g = st_m + g * nsub;
    float m = kMInit;
    for (int sub = 0; sub < nsub; ++sub) m = fmaxf(m, m_g[sub]);
    float l = 0.0f, o = 0.0f;
    for (int sub = 0; sub < nsub; ++sub) {
      const float w = expf(m_g[sub] - m);
      l += w * st_l[g * nsub + sub];
      o += w * st_acc[(g * nsub + sub) * D + d];
    }
    part_acc[i] = o;
    if (d == 0) {
      part_m[g] = m;
      part_l[g] = l;
    }
  }
  cluster_combine(cluster, part_m, part_l, part_acc,
                  out + b * sob + static_cast<int64_t>(h0) * D,
                  lse == nullptr ? nullptr : lse + row_of(b, G) + h0, G, D);
}

// ---------------------------------------------------------------------------
// bf16 with D % 16 == 0 and G <= 16: the products on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaStages = 3;  // 32-position tiles in the ring
constexpr int kMaxGroup = 16;  // query heads per KV head: the mma's 16 rows

__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}

// Four 8x8 bf16 matrices, transposed: the B fragments of two n8 blocks
__device__ __forceinline__ void ldsm_x4_trans(uint32_t a, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

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

size_t smem_bytes_mma(int D, int G) {
  return static_cast<size_t>(kMmaStages) * 2 * 32 * (D * 2 + 16) +
         static_cast<size_t>(G) * D * 2 +
         sizeof(float) * (static_cast<size_t>(G) * D + 2 * G);
}

// The G query heads are the rows of an m16n8k16 product (zero rows past
// G): per 32-position tile, every warp computes S = Q K^T (4 n8 blocks,
// K read from shared memory as B fragments) and the online softmax on
// its accumulators, identically, and then its own quarter of the head
// dim's columns of O += P V (P rounded to bf16 and kept in registers as
// A fragments, V read with ldmatrix.trans). So all four warps work on
// every tile and none waits for another's columns; their (m, l) agree
// bit for bit, being the same instructions on the same data.
template <int DMAX>
__global__ void __launch_bounds__(kThreads, DMAX > 128 ? 1 : 4)
decode_fwd_mma(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ kc,
               const __nv_bfloat16* __restrict__ vc,
               const int32_t* __restrict__ cache_len,
               __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
               int L, int D, int G,
               Plan plan, int64_t sqb, int64_t skb, int64_t skh, int64_t sks,
               int64_t svb, int64_t svh, int64_t svs, int64_t sob,
               float scale) {
  constexpr int KS = DMAX / 16;   // k-steps of S, and 16-column pairs of O
  constexpr int PW = DMAX / 64;   // column pairs per warp
  const int RB = D * 2 + 16;      // padded row bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t ring = smem_u32(smem);  // [stages][K, V][32][RB]
  const uint32_t q_s = ring + kMmaStages * 2 * 32 * RB;  // [G][D] bf16
  float* part_acc =
      reinterpret_cast<float*>(smem + kMmaStages * 2 * 32 * RB + G * D * 2);
  float* part_m = part_acc + G * D;  // [G]
  float* part_l = part_m + G;        // [G]

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  // the warp index, broadcast so that the compiler sees it is uniform
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int g = lane >> 2, t4 = lane & 3;
  const int h0 = hk * G;
  const int ksteps = D / 16, nvec = D / 8;
  const int p_begin = split * plan.chunk;
  const __nv_bfloat16* kb = kc + b * skb + hk * skh;
  const __nv_bfloat16* vb = vc + b * svb + hk * svh;

  // The first tiles are loaded before cache_len arrives, up to the
  // chunk's end in the cache (rows there are memory of the cache, valid
  // or not); the rows past min(cache_len, L) are masked, and zeroed in V.
  const int p_lim = p_begin + plan.chunk < L ? p_begin + plan.chunk : L;
  auto load_tile = [&](int t) {
    const uint32_t kd = ring + (t % kMmaStages) * 2 * 32 * RB;
    const uint32_t vd = kd + 32 * RB;
    const int r0 = p_begin + t * 32;
    for (int i = tid; i < 32 * nvec; i += kThreads) {
      const int r = i / nvec, v = i % nvec;
      const bool ok = r0 + r < p_lim;
      const int64_t pos = ok ? r0 + r : 0;  // rows past the chunk: zeros
      cp_async16(kd + r * RB + v * 16, kb + pos * sks + v * 8, ok);
      cp_async16(vd + r * RB + v * 16, vb + pos * svs + v * 8, ok);
    }
  };
  {
    // q's G rows join the first group
    const __nv_bfloat16* qb = q + b * sqb + static_cast<int64_t>(h0) * D;
    for (int i = tid; i < G * nvec; i += kThreads)
      cp_async16(q_s + i * 16, qb + i * 8, true);
  }
  const int tiles_lim = (p_lim - p_begin + 31) / 32;
  for (int t = 0; t < kMmaStages - 1; ++t) {
    if (t < tiles_lim) load_tile(t);
    cp_async_commit();
  }
  int n = *cache_len;
  n = n < L ? n : L;
  const int p_end = p_begin + plan.chunk < n ? p_begin + plan.chunk : n;
  const int count = p_end > p_begin ? p_end - p_begin : 0;
  const int n_tiles = (count + 31) / 32;

  // Q as A fragments: rows g and g + 8 are query heads h0 + g, h0 + g + 8
  // (read from shared memory once the first group has landed)
  uint32_t qa[KS][4];
  float o[PW][2][4];
#pragma unroll
  for (int pi = 0; pi < PW; ++pi)
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[pi][nb][e] = 0.0f;
  float m_r[2] = {kMInit, kMInit}, l_r[2] = {0.0f, 0.0f};

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kMmaStages - 2>();
    // tile t is in shared memory, and every warp is done with tile t - 1,
    // whose stage the next load refills
    __syncthreads();
    if (t + kMmaStages - 1 < n_tiles) load_tile(t + kMmaStages - 1);
    cp_async_commit();
    const uint32_t kd = ring + (t % kMmaStages) * 2 * 32 * RB;
    const uint32_t vd = kd + 32 * RB;
    const int valid = count - t * 32 < 32 ? count - t * 32 : 32;
    if (t == 0) {
      auto q32 = [&](int row, int col) -> uint32_t {
        return row < G ? lds32(q_s + (row * D + col) * 2) : 0u;
      };
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if (kk < ksteps) {
          qa[kk][0] = q32(g, kk * 16 + 2 * t4);
          qa[kk][1] = q32(g + 8, kk * 16 + 2 * t4);
          qa[kk][2] = q32(g, kk * 16 + 8 + 2 * t4);
          qa[kk][3] = q32(g + 8, kk * 16 + 8 + 2 * t4);
        }
      }
    }
    if (valid < 32) {
      // V rows past the valid prefix may hold anything: p is 0 there,
      // and 0 times a NaN would not be
      for (int i = tid; i < (32 - valid) * nvec; i += kThreads) {
        const uint32_t a = vd + (valid + i / nvec) * RB + (i % nvec) * 16;
        asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(a),
                     "r"(0)
                     : "memory");
      }
      __syncthreads();
    }

    // S = Q K^T: s[j] holds positions j * 8 .. j * 8 + 7
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
      const uint32_t kr = kd + (j * 8 + g) * RB + 4 * t4;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        if (kk < ksteps)
          mma_bf16(s[j], qa[kk], lds32(kr + kk * 32), lds32(kr + kk * 32 + 16));
    }
    // online softmax of rows g (e < 2) and g + 8 (e >= 2)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t4 + (e & 1);
        s[j][e] = c < valid ? s[j][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = expf(m_r[r] - m_new);
      m_r[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_r[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_r[r] = alpha[r] * l_r[r] + sum[r];
    }
    uint32_t pa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    // O += P V on this warp's column pairs (16 columns each)
#pragma unroll
    for (int pi = 0; pi < PW; ++pi) {
      const int pair = warp + 4 * pi;
      if (pair < ksteps) {
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[pi][nb][e] *= alpha[e >> 1];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int col = pair * 16 + (lane >> 4) * 8;
          uint32_t bv[4];
          ldsm_x4_trans(vd + row * RB + col * 2, bv);
          mma_bf16(o[pi][0], pa[kk], bv[0], bv[1]);
          mma_bf16(o[pi][1], pa[kk], bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // this block's (m, l, acc): rows g and g + 8, this warp's columns
#pragma unroll
  for (int pi = 0; pi < PW; ++pi) {
    const int pair = warp + 4 * pi;
    if (pair < ksteps) {
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int col = pair * 16 + nb * 8 + 2 * t4;
        if (g < G)
          *reinterpret_cast<float2*>(part_acc + g * D + col) =
              make_float2(o[pi][nb][0], o[pi][nb][1]);
        if (g + 8 < G)
          *reinterpret_cast<float2*>(part_acc + (g + 8) * D + col) =
              make_float2(o[pi][nb][2], o[pi][nb][3]);
      }
    }
  }
  if (warp == 0 && t4 == 0) {
    if (g < G) {
      part_m[g] = m_r[0];
      part_l[g] = l_r[0];
    }
    if (g + 8 < G) {
      part_m[g + 8] = m_r[1];
      part_l[g + 8] = l_r[1];
    }
  }
  cluster_combine(cluster, part_m, part_l, part_acc,
                  out + b * sob + static_cast<int64_t>(h0) * D,
                  lse == nullptr ? nullptr : lse + row_of(b, G) + h0, G, D);
}

template <typename T>
using DecodeKernel = void (*)(const T*, const T*, const T*, const int32_t*,
                              T*, float*, int, int, int, Plan, int64_t,
                              int64_t, int64_t, int64_t, int64_t, int64_t,
                              int64_t, int64_t, float);

// Launches kernel K with `smem` bytes of shared memory per block, or with
// `plan_out` fills it with (splits, chunk) and launches nothing.
template <typename T, DecodeKernel<T> K>
int launch(const void* q, const void* k, const void* v, const void* cache_len,
           void* out, float* lse, int B, int H, int Hkv, int L, int D,
           const int64_t* st,
           float scale, size_t smem, cudaStream_t stream, int* plan_out) {
  const int G = H / Hkv;
  static size_t configured = 0;  // the largest size allowed so far
  static int resident = 0, resident_smem = -1;
  if (smem > configured) {
    // all of the SM's shared memory, so that several blocks fit on one SM
    cudaError_t e = cudaFuncSetAttribute(
        K, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  if (resident_smem != static_cast<int>(smem)) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, K, kThreads,
                                                        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    resident = sms * per_sm;
    resident_smem = static_cast<int>(smem);
  }
  const Plan plan = make_plan(L, B * Hkv, subtiles(D, G, sizeof(T)),
                              resident);
  if (plan_out != nullptr) {
    plan_out[0] = plan.splits;
    plan_out[1] = plan.chunk;
    return 0;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.splits, Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // let the scheduler place each cluster where SMs are free rather than
  // spread the clusters over the GPCs
  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference =
      cudaClusterSchedulingPolicyLoadBalancing;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, K, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(cache_len),
      static_cast<T*>(out), lse, L, D, G, plan, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// bf16 with D % 16 == 0 and G <= 16 takes the tensor-core body; float32
// and the other shapes take the scalar body.
bool takes_mma(int D, int G, int dtype) {
  return dtype == 1 && D % 16 == 0 && G <= kMaxGroup;
}

size_t smem_for(int D, int G, int dtype) {
  return takes_mma(D, G, dtype) ? smem_bytes_mma(D, G)
                                : smem_bytes(D, G, dtype == 1 ? 2 : 4);
}

int dispatch(const void* q, const void* k, const void* v,
             const void* cache_len, void* out, float* lse, int B, int H,
             int Hkv, int L,
             int D, const int64_t* strides, float scale, int dtype,
             cudaStream_t s, int* plan_out) {
  if (B <= 0 || H <= 0) return 0;
  if (D <= 0 || D % 8 || D > kMaxD || Hkv <= 0 || H % Hkv || L <= 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  const int G = H / Hkv;
  const size_t smem = smem_for(D, G, dtype);
#define DECODE_LAUNCH(T, KERNEL)                                             \
  return launch<T, KERNEL>(q, k, v, cache_len, out, lse, B, H, Hkv, L, D,   \
                           strides, scale, smem, s, plan_out)
  if (dtype == 0) DECODE_LAUNCH(float, decode_fwd_split<float>);
  if (takes_mma(D, G, dtype)) {
    if (D <= 64) DECODE_LAUNCH(bf16, decode_fwd_mma<64>);
    if (D <= 128) DECODE_LAUNCH(bf16, decode_fwd_mma<128>);
    DECODE_LAUNCH(bf16, decode_fwd_mma<256>);
  }
  DECODE_LAUNCH(bf16, decode_fwd_split<bf16>);
#undef DECODE_LAUNCH
}

}  // namespace

// Shared memory one block needs for head dim D, group size G and dtype
// (0 = float32, 1 = bfloat16), in bytes; the wrapper refuses a shape over
// the card's 227 KB.
extern "C" long long decode_attention_smem(int D, int G, int dtype) {
  return static_cast<long long>(smem_for(D, G, dtype));
}

// The split decode_attention picks for these shapes: `splits` blocks (a
// cluster) per (b, KV head), block i over positions [i chunk, (i + 1)
// chunk). Returns a CUDA error code.
extern "C" int decode_attention_split_plan(int B, int H, int Hkv, int L,
                                           int D, int dtype, int* splits,
                                           int* chunk) {
  int plan[2] = {1, L};
  const int e = dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                         B, H, Hkv, L, D, nullptr, 0.0f, dtype, nullptr, plan);
  *splits = plan[0];
  *chunk = plan[1];
  return e;
}

// q: (B, H, D) with batch stride st[0] and heads contiguous; k, v: (B,
// Hkv, L, D) with strides st[1..3] and st[4..6] (b, h, position); out:
// (B, H, D) with batch stride st[7]; all in elements, the head dim
// contiguous. lse: null, or a contiguous float32 (B, H) that receives
// each row's log-sum-exp of the scaled scores over the valid positions
// (-inf where there are none). cache_len: a device int32. dtype 0 =
// float32, 1 = bfloat16. D % 8 == 0, D <= 256, H % Hkv == 0, pointers
// and K/V strides 16-byte aligned (the wrapper checks). Launches on
// `stream` and returns the launch's error.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* cache_len, void* out, void* lse,
                                int B, int H, int Hkv, int L, int D,
                                const int64_t* strides, float scale, int dtype,
                                void* stream) {
  return dispatch(q, k, v, cache_len, out, static_cast<float*>(lse), B, H,
                  Hkv, L, D, strides, scale, dtype,
                  static_cast<cudaStream_t>(stream), nullptr);
}
