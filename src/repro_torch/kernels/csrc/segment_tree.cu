// Prioritized-replay sampling: the heap-layout sum-tree's build and its
// inverse-CDF descent.
//
// Replaces: src/repro/kernels/segment_tree.py, segment_tree_kernel
// (body _seg_kernel; twin segment_tree_kernel_gpu), the TPU Mosaic
// kernel of the PER sampling op, and the same file's tree_build, which
// the reference leaves to XLA outside any Pallas call.
//
// What they compute. tree_levels builds the (2P,) tree from the (P,)
// leaf masses, P a power of two: leaves at [P, 2P), node i the float32
// sum of its children 2i and 2i+1 (left + right, one rounding, as the
// plain version's two-element sums), tree[1] the total and tree[0] = 0.
// segment_tree_rounds answers a batch of targets: for each target t, the
// leaf whose inclusive prefix sum first exceeds t, clamped to the last
// leaf; out is (n,) int32. Both take R trees at once, one per replica of
// a population: (R, P) leaves build (R, 2P) trees, and (R, n) targets
// descend (R, 2P) trees, row r in tree r. The trees lie end to end, so a
// target or a block finds its tree at an offset of r 2P, and a call
// makes the launches of one tree whatever R is.
//
// What bounds them on this card. At the DQN path's shapes (P = 16384,
// n = 32) the descent moves about 2 KB and the build 192 KB: nanoseconds
// at the HBM rate. Both are latency-bound: the launch, then chains of
// dependent memory round trips. A thread per target walking down
// log2(P) levels would make each level a load from L2 that waits on the
// one before (14 at P = 16384, 20 at P = 2^20).
//
// Design of the descent. A warp per target. In one round the warp loads
// the left children of the kLevels levels below its current node v (the
// left children of level l below v are the even nodes of the run
// [v 2^l, v 2^l + 2^l)): 2^kLevels - 1 = 127 independent loads, 4 per
// lane, all in flight at once, into the warp's slice of shared memory.
// Then every lane walks those levels from shared memory with exactly
// the plain version's steps (t < left, else t = __fsub_rn(t, left)), so
// the result is bitwise equal to kernels/ref.py for any floats: ties on
// a prefix sum, targets at or beyond the total and zero-mass tails
// alike. A round costs one L2 round trip and
// kLevels shared-memory reads; log2(P) levels take ceil(log2(P) / 7)
// rounds: 2 at P = 16384, 3 at 2^20. kLevels = 7 keeps a round's loads
// at 4 per lane (8 would take 2 rounds at P = 16384 as well, with twice
// the loads); a warp per target keeps the walk free of divergence (all
// lanes take the same path, reading one shared word as a broadcast),
// and 4 warps per block spread n = 32 over 8 SMs. (Walking all 128 paths
// of a round in registers at once and keeping the one whose every step
// agrees was slower on the card.) The first round's loads do not depend
// on the target, so they overlap its load. Every
// output element is written: lane 0 of the warp of target i writes
// out[i], and a block has a warp for each of its targets.
//
// Design of the build. One launch per band of levels: a
// block takes a span of S consecutive nodes of one level (the leaves in
// the first launch, which it also copies to [P, 2P)), sums it up level
// by level in a heap in shared memory (2S floats, one barrier a level),
// and writes each level's nodes to the tree; the next launch starts from
// the spans' roots. With S = 2048 (tree_build_plan in segment_tree.py)
// P <= 2^22 takes at most two launches: P = 16384 is 8 blocks of 11
// levels, then one block of 3. Every element is written: the launches
// together write each level from the leaves to the root once, and the
// block that reaches the root writes tree[0]. With R trees a launch has
// R times the blocks, block b on tree b / (N / S): at P = 16384 and
// R = 16, 128 blocks then 16.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLevels = 7;
constexpr int kLeftNodes = (1 << kLevels) - 1;  // 127
constexpr int kLoadsPerLane = (kLeftNodes + 31) / 32;  // 4
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxSpan = 4096;  // 2 kMaxSpan floats of shared memory
constexpr int kBuildThreads = 1024;

// Target i of the total R n descends tree i / n (n targets per tree).
__global__ void segment_tree_rounds(const float* __restrict__ trees,
                                    const float* __restrict__ targets,
                                    int32_t* __restrict__ out, int n,
                                    int total, int P, int depth) {
  __shared__ float left_of[kWarpsPerBlock][kLeftNodes + 1];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * kWarpsPerBlock + warp;
  if (i >= total) return;  // uniform over the warp
  const float* tree = trees + static_cast<int64_t>(i / n) * (2 * P);
  float* s = left_of[warp];
  float t = targets[i];
  int v = 1;
  for (int done = 0; done < depth; done += kLevels) {
    const int k = min(kLevels, depth - done);
    // element e: level l = bit length of e + 1, the (e + 1 - 2^(l-1))-th
    // left child of that level. All of a lane's loads are issued before
    // any is stored, so they are in flight together.
    const int count = (1 << k) - 1;
    float got[kLoadsPerLane];
#pragma unroll
    for (int c = 0; c < kLoadsPerLane; ++c) {
      const int e = lane + 32 * c;
      if (e < count) {
        const int l = 32 - __clz(e + 1);
        const int m = e + 1 - (1 << (l - 1));
        got[c] = __ldg(tree + ((v << l) + 2 * m));
      }
    }
#pragma unroll
    for (int c = 0; c < kLoadsPerLane; ++c)
      if (lane + 32 * c < count) s[lane + 32 * c] = got[c];
    __syncwarp();
    int q = 0;  // the current node's offset in its level below v
    for (int l = 1; l <= k; ++l) {
      const float left = s[(1 << (l - 1)) - 1 + q];
      const bool go_left = t < left;
      q = go_left ? 2 * q : 2 * q + 1;
      t = go_left ? t : __fsub_rn(t, left);
    }
    v = (v << k) + q;
    __syncwarp();  // every lane has read s before the next round's loads
  }
  if (lane == 0) out[i] = v - P;
}

// Block b of a tree sums the span src[b S, (b + 1) S) of a level of N
// nodes up to one node. src is the leaf masses (leaves != nullptr; copied
// to tree[N, 2N)) or the level's nodes tree[N, 2N). Local node j of the
// heap (children 2j, 2j + 1, the span at [S, 2S)) in the level of n nodes
// per span is tree node (N / S) n + b n + (j - n). Block blockIdx.x works
// on tree blockIdx.x / (N / S) of the R trees of P leaves each.
__global__ void tree_levels(const float* __restrict__ all_leaves,
                            float* __restrict__ trees, int N, int S, int P) {
  extern __shared__ float heap[];
  const int spans = N / S;
  const int r = blockIdx.x / spans;
  const int b = blockIdx.x % spans;
  float* tree = trees + static_cast<int64_t>(r) * (2 * P);
  const float* leaves =
      all_leaves != nullptr ? all_leaves + static_cast<int64_t>(r) * P
                            : nullptr;
  const float* src = leaves != nullptr ? leaves : tree + N;
  float got[kMaxSpan / kBuildThreads];  // every load in flight at once
#pragma unroll
  for (int c = 0; c < kMaxSpan / kBuildThreads; ++c) {
    const int x = threadIdx.x + c * blockDim.x;
    if (x < S) got[c] = src[b * S + x];
  }
#pragma unroll
  for (int c = 0; c < kMaxSpan / kBuildThreads; ++c) {
    const int x = threadIdx.x + c * blockDim.x;
    if (x < S) {
      heap[S + x] = got[c];
      if (leaves != nullptr) tree[N + b * S + x] = got[c];
    }
  }
  __syncthreads();
  for (int n = S / 2; n >= 1; n /= 2) {
    for (int x = threadIdx.x; x < n; x += blockDim.x) {
      const float sum = __fadd_rn(heap[2 * (n + x)], heap[2 * (n + x) + 1]);
      heap[n + x] = sum;
      tree[spans * n + b * n + x] = sum;
    }
    __syncthreads();
  }
  if (spans == 1 && threadIdx.x == 0) tree[0] = 0.0f;
}

__global__ void noop() {}

}  // namespace

// trees: (R, 2P) float32 device pointer, the trees end to end; targets:
// (R, n) float32 with total = R n; out: (R, n) int32. R = 1 is a single
// (2P,) tree. Launches on `stream` and returns cudaGetLastError().
extern "C" int segment_tree_sample(const void* trees, const void* targets,
                                   void* out, int n, int total, int P,
                                   void* stream) {
  if (P < 1 || P > (1 << 30) || (P & (P - 1)) || n < 0 || total < 0
      || (n == 0 && total > 0) || (n > 0 && total % n))
    return static_cast<int>(cudaErrorInvalidValue);
  int depth = 0;
  while ((1 << depth) < P) ++depth;
  if (total > 0) {
    const int blocks = (total + kWarpsPerBlock - 1) / kWarpsPerBlock;
    segment_tree_rounds<<<blocks, 32 * kWarpsPerBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(trees), static_cast<const float*>(targets),
        static_cast<int32_t*>(out), n, total, P, depth);
  }
  return static_cast<int>(cudaGetLastError());
}

// One launch of the build over R trees of P leaves: in each tree, the
// N / S spans of S nodes of the level of N nodes, from `leaves` ((R, P)
// float32, the first launch, N = P) or, when leaves is null, from
// tree[N, 2N) (a later launch); trees is (R, 2P) float32. S is a power of
// two in [1, 4096] that divides N.
extern "C" int tree_build_levels(const void* leaves, void* trees, int N, int S,
                                 int R, int P, void* stream) {
  if (S < 1 || S > kMaxSpan || (S & (S - 1)) || N < S || N % S
      || N > P || P > (1 << 30) || R < 1
      || static_cast<int64_t>(R) * (N / S) > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = S < kBuildThreads ? S : kBuildThreads;
  tree_levels<<<R * (N / S), threads, 2 * S * sizeof(float),
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(leaves), static_cast<float*>(trees), N, S, P);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on `stream`: what any launch costs, the floor of the
// two latency-bound kernels above.
extern "C" int empty_launch(void* stream) {
  noop<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
