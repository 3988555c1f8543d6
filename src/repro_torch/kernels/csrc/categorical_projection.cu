// C51 Bellman projection onto the fixed support, one block per row.
//
// Replaces: src/repro/kernels/categorical_projection.py,
// categorical_projection_kernel (body _proj_kernel -> _hat_accumulate;
// twin categorical_projection_kernel_gpu), the TPU Mosaic kernel of the
// distributional target.
//
// What it computes: probs (B, K) float32 over the atoms
// z_j = v_min + j*delta, rewards and dones (B,) float32 -> (B, K)
// float32. Atom j moves to Tz_j = clip(r + gamma_n*(1-d)*z_j, v_min,
// v_max), at fractional position b_j = (Tz_j - v_min)/delta, and its
// mass spreads over the target atoms by the triangular hat:
//   m_i = sum_j p_j * max(0, 1 - |b_j - i|).
// For b_j inside [0, K-1] that is exactly the floor/ceil split of the
// classic scatter, integer b_j included. delta = 0 (K = 1 or
// v_min == v_max) divides by 1 instead, so every b_j is 0 and all mass
// lands on atom 0.
//
// Design. Threads of the block first compute b_j (one atom each) into
// shared memory with the row's masses, then thread i gathers its own
// m_i over all j. That is the gather form of the TPU kernel, with no
// atomics: each output is one thread's sum in j order, so the result is
// the same on every run (the cycle's bitwise determinism depends on
// it). b_j is formed with round-to-nearest intrinsics in the plain
// version's operation order, so the kernel and kernels/ref.py see the
// same b_j; the two then differ only in the order of the adds.
// projection_hat in categorical_projection.py replays this schedule on
// the CPU bit for bit. Every output element is written: block r has
// 32 ceil(K/32) >= K threads and thread i < K writes out[r][i], for
// every row r < B, so the wrapper takes its output from build.output,
// without deterministic mode's NaN-fill launch.
//
// What bounds it on this card: at the DQN path's shapes (B = 32,
// K = 51) the function reads 6.8 KB and writes 6.5 KB, about 4 ns at
// the HBM rate, and needs 23 kFLOP, less at the float32 peak. So it is
// latency-bound: the launch, one load, b_j's division, one barrier and
// each output's chain of K dependent adds, most of which add an exact
// zero. Summing only each output's window of reaching atoms (2-3 of 51
// at the DQN path's discount) was tried: finding the windows (a read of
// the neighbours, shared atomics, a second barrier) cost more than the
// ~50 adds it saved at K = 51, and it paid only at K = 512, which no
// spec uses. Packing several rows per block was tried only together
// with the window. K <= 512 keeps a row in one block of at most 512
// threads.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxAtoms = 512;

__global__ void projection_rows(const float* __restrict__ probs,
                                const float* __restrict__ rewards,
                                const float* __restrict__ dones,
                                float* __restrict__ out, int K, float v_min,
                                float v_max, float gamma_n, float delta,
                                float db) {
  __shared__ float p[kMaxAtoms];
  __shared__ float b[kMaxAtoms];
  const int row = blockIdx.x;
  const int i = threadIdx.x;
  const float r = rewards[row];
  const float g = __fmul_rn(gamma_n, __fsub_rn(1.0f, dones[row]));
  if (i < K) {
    p[i] = probs[row * K + i];
    const float z = __fadd_rn(v_min, __fmul_rn(delta, static_cast<float>(i)));
    const float tz = fminf(fmaxf(__fadd_rn(r, __fmul_rn(g, z)), v_min), v_max);
    b[i] = __fdiv_rn(__fsub_rn(tz, v_min), db);
  }
  __syncthreads();
  if (i >= K) return;
  const float fi = static_cast<float>(i);
  float acc = 0.0f;
  for (int j = 0; j < K; ++j) {
    const float w = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(b[j], fi))), 0.0f);
    acc = __fadd_rn(acc, __fmul_rn(p[j], w));
  }
  out[row * K + i] = acc;
}

}  // namespace

// probs, out: (B, K) float32 device pointers, row-major; rewards,
// dones: (B,) float32. Launches on `stream`, returns cudaGetLastError().
extern "C" int categorical_projection(const void* probs, const void* rewards,
                                      const void* dones, void* out, int B,
                                      int K, float v_min, float v_max,
                                      float gamma_n, float delta, float db,
                                      void* stream) {
  if (K < 1 || K > kMaxAtoms) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    const int threads = ((K + 31) / 32) * 32;
    projection_rows<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(probs), static_cast<const float*>(rewards),
        static_cast<const float*>(dones), static_cast<float*>(out), K, v_min,
        v_max, gamma_n, delta, db);
  }
  return static_cast<int>(cudaGetLastError());
}
