// Prioritized-replay sampling: inverse-CDF lookup over a heap-layout
// sum-tree, one thread per target.
//
// Replaces: src/repro/kernels/segment_tree.py, segment_tree_kernel
// (body _seg_kernel), the TPU Mosaic kernel of the PER sampling op.
//
// What it computes: for each target t, the leaf whose inclusive prefix
// sum first exceeds t, clamped to the last leaf. tree is (2P,) float32,
// P a power of two, tree[1] the total, node i's children 2i and 2i+1,
// leaves at [P, 2P); out is (n,) int32.
//
// Design. The TPU kernel compare-counts every target against the
// prefix sums of every leaf block, because per-lane gathers do not map
// onto the TPU's vector unit. Gathers are cheap on Hopper, so each
// thread here walks the tree from the root to a leaf: log2(P) dependent
// loads, the same steps, in the same float32 order, as the plain
// version (kernels/ref.py). The result is therefore bitwise equal to the
// plain version for any floats, including targets >= the total (they
// run down the right spine to the last leaf) and zero-mass padded
// leaves. The compare-count schedule is not carried over: it differs
// from the descent on float CDF boundaries.
//
// What bounds it on this card: at the slice's shapes (P = 16384,
// n = 32) the work is 32 threads times 14 dependent loads, about 2 KB
// of traffic, so the launch itself (a few microseconds) is the bound,
// not bytes or operations. One block of 32..256 threads per 256 targets;
// nothing to tune until n grows by orders of magnitude.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void segment_tree_descent(const float* __restrict__ tree,
                                     const float* __restrict__ targets,
                                     int32_t* __restrict__ out,
                                     int n, int P, int depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = targets[i];
  int idx = 1;
  for (int d = 0; d < depth; ++d) {
    const float left = __ldg(tree + 2 * idx);
    const bool go_left = t < left;
    idx = go_left ? 2 * idx : 2 * idx + 1;
    t = go_left ? t : __fsub_rn(t, left);
  }
  out[i] = idx - P;
}

}  // namespace

// tree: (2P,) float32 device pointer; targets: (n,) float32; out: (n,)
// int32. Launches on `stream` and returns cudaGetLastError().
extern "C" int segment_tree_sample(const void* tree, const void* targets,
                                   void* out, int n, int P, void* stream) {
  int depth = 0;
  while ((1 << depth) < P) ++depth;
  if (n > 0) {
    const int threads = n < kThreads ? ((n + 31) / 32) * 32 : kThreads;
    const int blocks = (n + threads - 1) / threads;
    segment_tree_descent<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(tree), static_cast<const float*>(targets),
        static_cast<int32_t*>(out), n, P, depth);
  }
  return static_cast<int>(cudaGetLastError());
}
