// fused_distro_stats for Hopper (sm_90a).
//
// Replaces the TPU kernel evergreen_tpu/ops/pallas_kernels.py:71
// fused_distro_stats (pl.pallas_call at :165): the seven per-distro queue
// statistics over each distro's contiguous range [offs[d], offs[d+1]) of
// the distro-major task columns.
//
//   stat 0 d_length          sum(valid)
//   stat 1 d_deps_met        sum(valid & deps)
//   stat 2 d_expected_dur_s  sum(dur  | valid & deps)
//   stat 3 d_over_count      sum(valid & deps & dur > thresh[d])
//   stat 4 d_over_dur_s      sum(dur  | valid & deps & dur > thresh[d])
//   stat 5 d_wait_over       sum(valid & deps & wait > thresh[d])
//   stat 6 d_merge           sum(valid & deps & merge)
//
// What bounds it: latency. It reads 11 bytes a task (three u8 flags in
// their packed dtype, two f32 columns) once and does a few compares and
// adds per byte: at the 200-distro x 50k-task configuration about 0.56 MB,
// 0.17 us of HBM time at 3.35 TB/s, well under the launch itself (a
// one-element add_ takes about 1.15 us). The first design gave each
// distro a block of 256 threads, so with 250 tasks a distro each thread
// loaded at most one task, and the block's time was fixed latency in
// series: the offsets, one round of loads, a 5-level shuffle tree over 7
// values, a shared-memory write, __syncthreads, a serial fold over 8
// warps, the store; the 24 padding distros each took a whole block. 2.27
// us on an H100 at 700 W.
//
// Design. One warp owns one distro, 2 distros to a 64-thread block: 112
// blocks at that configuration, one to an SM (8 distros to a 256-thread
// block measured slower: 28 SMs then carried every warp's loads and
// compares). Lane l takes tasks start + l + 32 j for j < kUnroll
// (coalesced across the warp) and issues all of their loads before any
// compare; a distro larger than 32 x kUnroll tasks is walked in strides
// of that. Counts are kept as integers (exact) and reduced with one
// warp-wide integer add each; the two duration sums are kept in f32 and
// reduced by shuffles in a fixed order. Lanes 0-6 store the seven results
// at once. No shared memory, no __syncthreads, no atomics, so a run
// repeats bit for bit; an empty distro costs one warp. The kernel
// allocates and synchronises nothing; the wrapper (ops/distro_stats.py)
// allocates the [D, 7] f32 output and checks the inputs.

#include <cuda_runtime.h>
#include <stdint.h>

// The design constants; ``chip_smoke.py --sweep`` rebuilds the file with
// other values (-D) and times them against these.
#ifndef DISTRO_STATS_THREADS
#define DISTRO_STATS_THREADS 64
#endif
#ifndef DISTRO_STATS_UNROLL
#define DISTRO_STATS_UNROLL 8
#endif

namespace {

constexpr int kThreads = DISTRO_STATS_THREADS;
constexpr int kWarps = kThreads / 32;  // distros per block
constexpr int kUnroll = DISTRO_STATS_UNROLL;  // tasks a lane loads at once
constexpr int kStats = 7;

__global__ void __launch_bounds__(kThreads) fused_distro_stats_kernel(
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ deps,
    const float* __restrict__ dur, const float* __restrict__ wait,
    const uint8_t* __restrict__ merge, const int32_t* __restrict__ offs,
    const float* __restrict__ thresh, int n, int n_distros,
    float* __restrict__ out) {
  const int d = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (d >= n_distros) return;  // d is uniform across the warp
  const int start = max(offs[d], 0);
  const int end = min(offs[d + 1], n);
  const float th = thresh[d];

  unsigned cnt[5] = {0, 0, 0, 0, 0};  // valid, deps, over, wait, merge
  float sum[2] = {0.f, 0.f};          // dur, over dur
  for (int base = start + lane; base < end; base += 32 * kUnroll) {
    uint8_t v[kUnroll], dp[kUnroll], mg[kUnroll];
    float du[kUnroll], wt[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int i = base + 32 * j;
      const bool in = i < end;
      v[j] = in ? valid[i] : 0;
      dp[j] = in ? deps[i] : 0;
      mg[j] = in ? merge[i] : 0;
      du[j] = in ? dur[i] : 0.f;
      wt[j] = in ? wait[i] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const bool dm = v[j] != 0 && dp[j] != 0;
      const bool over = dm && du[j] > th;
      cnt[0] += v[j] != 0;
      cnt[1] += dm;
      cnt[2] += over;
      cnt[3] += dm && wt[j] > th;
      cnt[4] += dm && mg[j] != 0;
      sum[0] += dm ? du[j] : 0.f;
      sum[1] += over ? du[j] : 0.f;
    }
  }

  // counts: one integer reduction each; sums: an xor butterfly, whose
  // adds are the same in every lane up to operand order (commutative), so
  // every lane holds the same bits
#pragma unroll
  for (int k = 0; k < 5; ++k) cnt[k] = __reduce_add_sync(0xffffffffu, cnt[k]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 2; ++k) sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], off);
  }
  if (lane < kStats) {  // lane k stores stat k: one 28-byte store
    const float r[kStats] = {
        static_cast<float>(cnt[0]), static_cast<float>(cnt[1]), sum[0],
        static_cast<float>(cnt[2]), sum[1], static_cast<float>(cnt[3]),
        static_cast<float>(cnt[4])};
    float v = r[0];
#pragma unroll
    for (int k = 1; k < kStats; ++k) v = lane == k ? r[k] : v;
    out[static_cast<int64_t>(d) * kStats + lane] = v;
  }
}

}  // namespace

extern "C" int fused_distro_stats_launch(
    const void* valid, const void* deps, const void* dur, const void* wait,
    const void* merge, const void* offs, const void* thresh, int n,
    int n_distros, void* out, void* stream) {
  if (n_distros > 0) {
    const int blocks = (n_distros + kWarps - 1) / kWarps;
    fused_distro_stats_kernel<<<blocks, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(valid), static_cast<const uint8_t*>(deps),
        static_cast<const float*>(dur), static_cast<const float*>(wait),
        static_cast<const uint8_t*>(merge), static_cast<const int32_t*>(offs),
        static_cast<const float*>(thresh), n, n_distros,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
