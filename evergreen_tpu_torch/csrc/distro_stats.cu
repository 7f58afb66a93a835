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
// one-element add_ takes about 1.15 us) and under the ordered fold of the
// longest distro's durations (below). The first design gave each
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
// compares). The warp walks its range in chunks of 32 x kUnroll tasks:
// lane l loads tasks base + l + 32 j for j < kUnroll (coalesced across
// the warp) and issues all of their loads before any compare. Counts are
// kept as integers (exact in any order) and reduced with one warp-wide
// integer add each. The two duration sums are the capacity demand, which
// is floored and rounded into host targets, so they must be the CPU's
// bit for bit: each is one left fold in element order over the distro's
// range, the order in which index_add_ adds on the CPU. Each lane writes
// its chunk's two masked durations (0 where the mask is off) to shared
// memory, and after a __syncwarp lane 0 folds the deps-met column and
// lane 1 the over-threshold column, in order, four floats to a
// shared-memory load; a masked or past-the-end task adds +0, which never
// changes a sum that started at +0. The fold is one dependent chain of
// f32 adds, so the longest distro bounds the kernel: its length x the
// FADD latency over the SM clock. (The design before this one reduced
// lane-strided partial sums with an xor butterfly: faster, and one
// rounding unit away from the CPU.) Lanes 0-6 store the seven results at once. No atomics
// and no __syncthreads, so a run repeats bit for bit; an empty distro
// costs one warp. The kernel allocates and synchronises nothing; the
// wrapper (ops/distro_stats.py) allocates the [D, 7] f32 output and
// checks the inputs.

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
constexpr int kChunk = 32 * kUnroll;  // tasks a warp stages at once
// a staged column's row; the 4 floats past the chunk put lane 1's float4
// reads 4 banks away from lane 0's
constexpr int kRow = kChunk + 4;
constexpr int kStats = 7;

// acc += col[0], col[1], ..., col[len - 1] one add at a time, reading
// four floats to a load; col holds zeros up to the next multiple of 4
__device__ __forceinline__ void fold(const float* col, int len, float& acc) {
  const float4* q = reinterpret_cast<const float4*>(col);
  const int n4 = (len + 3) >> 2;
#pragma unroll 4
  for (int k = 0; k < n4; ++k) {
    const float4 v = q[k];
    acc += v.x;
    acc += v.y;
    acc += v.z;
    acc += v.w;
  }
}

__global__ void __launch_bounds__(kThreads) fused_distro_stats_kernel(
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ deps,
    const float* __restrict__ dur, const float* __restrict__ wait,
    const uint8_t* __restrict__ merge, const int32_t* __restrict__ offs,
    const float* __restrict__ thresh, int n, int n_distros,
    float* __restrict__ out) {
  // each warp's chunk of the two masked duration columns
  __shared__ __align__(16) float stage[kWarps][2][kRow];
  const int w = threadIdx.x / 32;
  const int d = blockIdx.x * kWarps + w;
  const int lane = threadIdx.x % 32;
  if (d >= n_distros) return;  // d is uniform across the warp
  const int start = max(offs[d], 0);
  const int end = min(offs[d + 1], n);
  const float th = thresh[d];

  unsigned cnt[5] = {0, 0, 0, 0, 0};  // valid, deps, over, wait, merge
  // lane 0: the deps-met duration, lane 1: the over-threshold duration
  float acc = 0.f;
  for (int base = start; base < end; base += kChunk) {
    uint8_t v[kUnroll], dp[kUnroll], mg[kUnroll];
    float du[kUnroll], wt[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int i = base + lane + 32 * j;
      const bool in = i < end;
      v[j] = in ? valid[i] : 0;
      dp[j] = in ? deps[i] : 0;
      mg[j] = in ? merge[i] : 0;
      du[j] = in ? dur[i] : 0.f;
      wt[j] = in ? wait[i] : 0.f;
    }
    float m0[kUnroll], m1[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const bool dm = v[j] != 0 && dp[j] != 0;
      const bool over = dm && du[j] > th;
      cnt[0] += v[j] != 0;
      cnt[1] += dm;
      cnt[2] += over;
      cnt[3] += dm && wt[j] > th;
      cnt[4] += dm && mg[j] != 0;
      m0[j] = dm ? du[j] : 0.f;
      m1[j] = over ? du[j] : 0.f;
    }
    __syncwarp();  // lanes 0 and 1 are done with the previous chunk
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      stage[w][0][lane + 32 * j] = m0[j];
      stage[w][1][lane + 32 * j] = m1[j];
    }
    __syncwarp();
    if (lane < 2) fold(stage[w][lane], min(kChunk, end - base), acc);
  }

#pragma unroll
  for (int k = 0; k < 5; ++k) cnt[k] = __reduce_add_sync(0xffffffffu, cnt[k]);
  const float sum0 = __shfl_sync(0xffffffffu, acc, 0);
  const float sum1 = __shfl_sync(0xffffffffu, acc, 1);
  if (lane < kStats) {  // lane k stores stat k: one 28-byte store
    const float r[kStats] = {
        static_cast<float>(cnt[0]), static_cast<float>(cnt[1]), sum0,
        static_cast<float>(cnt[2]), sum1, static_cast<float>(cnt[3]),
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
