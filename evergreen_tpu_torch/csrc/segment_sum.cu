// Ordered segment sum for Hopper (sm_90a), over up to four columns at once.
//
// For each column c and segment g:
//   out[c, g] = ((0 + x[c, e0]) + x[c, e1]) + ... , added one at a time in
// f32, where e0 < e1 < ... are g's live elements: order[offs[g] ..
// offs[g+1]) lists them (a stable sort by segment id, padding rows left
// out) and offs holds each segment's [start, end) in ``order``.
//
// Stands in for the scatter-add (evergreen_tpu/ops/solve.py:71 _seg_sum)
// wherever the solve sums real-valued f32 terms per segment: queue and
// over-threshold seconds per task-group segment, soon-free host fractions,
// and the capacity program's per-pool sums. Those sums are floored or
// ceiled into host counts, so their rounding must not change from run to
// run, and it must equal the CPU's: index_add_ on the CPU adds in element
// order, while on the card it adds with atomics in an order that varies.
// Adding in element order gives the CPU's result bit for bit, every run.
// Leaving a padding row out is exact too: adding +-0 to a sum that started
// at +0 never changes it. (No a*b+c here, so no contraction to FMA.)
//
// What bounds it: latency. Each segment's adds form one dependent chain,
// so the least time is the longest live segment times the FADD latency
// (218 elements x 4 cycles at the 200-distro x 50k-task configuration,
// about 0.44 us), above the byte bound (0.13 us); on the card the launch
// itself (a one-element add_ takes about 1.15 us) and each round of
// dependent loads come on top. The first design gave one warp to each
// segment: 32 lanes gathered 32 elements through two
// dependent global loads (order[i], then x[order[i]]), then every lane
// added the 32 values in lane order through shuffles. Every add waited on
// a shuffle, the batches ran one after another with nothing overlapping
// the gathers, and each column was a launch of its own: 6.16 us on the
// task plan and 5.65 us per pool sum, on an H100 at 700 W.
//
// Design. Segments are not alike: at that configuration the first 200
// segment ids are the distros' ungrouped segments, about 200 tasks each,
// and most of the other 10,040 hold a few tasks or none, so a block of a
// fixed number of segment ids can get most of the elements. A block takes
// a piece bounded both ways: of window a (segments [256 a, 256 a + 256)),
// the segments whose first element lies in one 512-element stretch p of
// ``order``. Window a's pieces are blocks F(a) .. F(a+1) - 1, with
// F(a) = a + offs[256 a] / 512, so the grid (windows + n_elem / 512
// blocks, some of them idle) follows from the shapes, and a block finds
// its window, and the window's element range, with one round of loads
// and no plan of its own.
//
// Stage: before the offsets arrive, the 256 threads gather the stretch
// and 256 elements past it, clipped to the window's range, into shared
// memory: order[i] coalesced, then x[c, order[i]] for each column, each
// thread's three gathers in flight together. That holds the
// piece's whole range unless its last segment runs more than 256 elements
// past the stretch; such a range is staged again tile by tile, each chain
// carried across tiles in order. Sum: after one __syncthreads each thread
// whose segment starts in the piece walks it from shared memory in order,
// 16 bytes a load, into two register buffers used in turn, so the next
// loads are in flight while it adds and only the FADD is left in the
// chain. With K
// columns a thread carries K independent chains, so pairs of sums over one
// plan (the solve always asks for them together) cost one launch. No
// atomics: the result repeats bit for bit. The kernel allocates and
// synchronises nothing; the wrapper (ops/segment.py) builds the int32
// plan and allocates the [K, n_seg] output.

#include <cuda_runtime.h>
#include <stdint.h>

// The design constants; ``chip_smoke.py --sweep`` rebuilds the file with
// other values (-D) and times them against these.
#ifndef SEGMENT_SUM_THREADS
#define SEGMENT_SUM_THREADS 256
#endif
#ifndef SEGMENT_SUM_PIECE
#define SEGMENT_SUM_PIECE 512
#endif
#ifndef SEGMENT_SUM_STAGE_UNROLL
#define SEGMENT_SUM_STAGE_UNROLL 3
#endif
#ifndef SEGMENT_SUM_WALK_DEPTH
#define SEGMENT_SUM_WALK_DEPTH 2
#endif

namespace {

constexpr int kThreads = SEGMENT_SUM_THREADS;  // threads = segments per window
constexpr int kPiece = SEGMENT_SUM_PIECE;      // span of ``order`` one block's segments start in
constexpr int kTileFloats = 8192;              // 32 KB of staging, split among K columns
constexpr int kStageUnroll = SEGMENT_SUM_STAGE_UNROLL;  // gathers a thread has in flight
constexpr int kWalkDepth = SEGMENT_SUM_WALK_DEPTH;  // float4s a walk buffer holds a column
// a piece's stretch and the tail its last segment may add, staged before
// the offsets are known; a longer tail is staged again
constexpr int kSpec = kPiece + kThreads;
static_assert(kSpec <= kThreads * kStageUnroll && kSpec <= kTileFloats / 4,
              "staging sizes");

// v[c][u] = x[c, idx[u]] (0 where idx[u] < 0): every gather issued
// before any is used
template <int K>
__device__ __forceinline__ void gather(const float* __restrict__ x, int n,
                                       const int (&idx)[kStageUnroll],
                                       float (&v)[K][kStageUnroll]) {
#pragma unroll
  for (int u = 0; u < kStageUnroll; ++u)
#pragma unroll
    for (int c = 0; c < K; ++c)
      v[c][u] = idx[u] >= 0 ? x[static_cast<int64_t>(c) * n + idx[u]] : 0.f;
}

// tile[c][base + threadIdx.x + u kThreads] = v[c][u], below len
template <int K>
__device__ __forceinline__ void put(float* tile, int stride, int base, int len,
                                    const float (&v)[K][kStageUnroll]) {
#pragma unroll
  for (int u = 0; u < kStageUnroll; ++u) {
    const int i = base + threadIdx.x + u * kThreads;
    if (i < len) {
#pragma unroll
      for (int c = 0; c < K; ++c) tile[c * stride + i] = v[c][u];
    }
  }
}

__device__ __forceinline__ void add4(float& acc, const float4 v) {
  acc += v.x;
  acc += v.y;
  acc += v.z;
  acc += v.w;
}

// acc[c] += tile[c][lo], tile[c][lo + 1], ..., tile[c][hi - 1], one add at
// a time, for each column c (rows of ``stride`` floats, 16-byte aligned).
// The aligned middle is read as float4s into two register buffers used in
// turn: one buffer's adds run while the other's loads are in flight, and
// no add waits on a load or on a register copy.
template <int K>
__device__ __forceinline__ void walk(const float* tile, int stride, int lo, int hi,
                                     float (&acc)[K]) {
  // float4s per buffer and column; half as many at three or four columns
  constexpr int kQ = K <= 2 ? kWalkDepth : (kWalkDepth + 1) / 2;
  int i = lo;
  for (; i < hi && (i & 3); ++i)
#pragma unroll
    for (int c = 0; c < K; ++c) acc[c] += tile[c * stride + i];
  const int n4 = max(hi - i, 0) >> 2;
  const float4* q[K];
#pragma unroll
  for (int c = 0; c < K; ++c) q[c] = reinterpret_cast<const float4*>(tile + c * stride + i);
  float4 a[K][kQ], b[K][kQ];
  int j = 0;
  if (n4 >= kQ) {
#pragma unroll
    for (int c = 0; c < K; ++c)
#pragma unroll
      for (int u = 0; u < kQ; ++u) a[c][u] = q[c][u];
  }
  for (; j + 2 * kQ <= n4; j += 2 * kQ) {
#pragma unroll
    for (int c = 0; c < K; ++c)
#pragma unroll
      for (int u = 0; u < kQ; ++u) b[c][u] = q[c][j + kQ + u];
#pragma unroll
    for (int u = 0; u < kQ; ++u)
#pragma unroll
      for (int c = 0; c < K; ++c) add4(acc[c], a[c][u]);
    if (j + 3 * kQ <= n4) {
#pragma unroll
      for (int c = 0; c < K; ++c)
#pragma unroll
        for (int u = 0; u < kQ; ++u) a[c][u] = q[c][j + 2 * kQ + u];
    }
#pragma unroll
    for (int u = 0; u < kQ; ++u)
#pragma unroll
      for (int c = 0; c < K; ++c) add4(acc[c], b[c][u]);
  }
  if (j + kQ <= n4) {  // ``a`` holds q[j .. j + kQ)
#pragma unroll
    for (int u = 0; u < kQ; ++u)
#pragma unroll
      for (int c = 0; c < K; ++c) add4(acc[c], a[c][u]);
    j += kQ;
  }
  for (; j < n4; ++j)
#pragma unroll
    for (int c = 0; c < K; ++c) add4(acc[c], q[c][j]);
  for (i += 4 * n4; i < hi; ++i)
#pragma unroll
    for (int c = 0; c < K; ++c) acc[c] += tile[c * stride + i];
}

template <int K>
__global__ void __launch_bounds__(kThreads) segment_sum_kernel(
    const float* __restrict__ x, int n, const int32_t* __restrict__ order,
    const int32_t* __restrict__ offs, int n_seg, float* __restrict__ out) {
  constexpr int kTile = kTileFloats / K / 4 * 4;  // rows stay 16-byte aligned
  __shared__ __align__(16) float tile[K][kTile];
  __shared__ int start[kThreads + 1];
  __shared__ int window, win_lo, win_hi;  // window a and its element range
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const int n_win = (n_seg + kThreads - 1) / kThreads;

  // ---- this block's window: the last a with F(a) <= b, where
  // F(a) = a + offs[256 a] / kPiece is window a's first block (offs[0] is
  // 0; the last window ends at n at most). F(a) >= a, and
  // F(a) <= a + n / kPiece, so a lies in [a_lo, a_hi] ----
  const int a_lo = max(0, b - n / kPiece);
  const int a_hi = min(b, n_win - 1);
  for (int a0 = a_lo; a0 <= a_hi; a0 += kThreads) {
    const int a = a0 + t;
    if (a > a_hi) continue;
    const int lo = a == 0 ? 0 : offs[a * kThreads];
    const int hi = a == n_win - 1 ? n : offs[(a + 1) * kThreads];
    if (a + lo / kPiece <= b && (a == n_win - 1 || a + 1 + hi / kPiece > b)) {
      window = a;  // F is increasing: exactly one thread writes
      win_lo = lo;
      win_hi = hi;
    }
  }
  __syncthreads();
  const int g0 = window * kThreads;
  const int p = b - window;  // F(a) + j = a + offs[g0] / kPiece + j

  // ---- stage, before the offsets are known: the segments of piece p
  // start in [p kPiece, (p + 1) kPiece) and inside the window's range, so
  // gather that much and kSpec - kPiece elements past it (in flight
  // together with the offsets' loads) ----
  const int stage0 = max(p * kPiece, win_lo);
  const int spec = max(0, min(p * kPiece + kSpec, win_hi) - stage0);
  int idx[kStageUnroll];
#pragma unroll
  for (int u = 0; u < kStageUnroll; ++u) {
    const int i = t + u * kThreads;
    idx[u] = i < spec ? order[stage0 + i] : -1;
  }

  // ---- the window's segments that start in piece p: a contiguous run ----
  const int g = g0 + t;
  const bool real = g < n_seg;
  const int s = g <= n_seg ? offs[g] : 0;
  const int e = real ? offs[g + 1] : 0;
  float v[K][kStageUnroll];
  gather<K>(x, n, idx, v);
  if (g <= n_seg) start[t] = s;
  if (t == kThreads - 1 && real) start[kThreads] = e;
  const int n_before = __syncthreads_count(real && s / kPiece < p);
  const int n_upto = __syncthreads_count(real && s / kPiece <= p);
  if (n_upto == n_before) return;  // no segment starts in this piece
  const bool mine = real && s / kPiece == p;
  const int r0 = start[n_before];
  const int r1 = start[n_upto];
  put<K>(&tile[0][0], kTile, 0, spec, v);
  __syncthreads();

  float acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = 0.f;
  if (r1 - stage0 <= spec) {  // the gather above holds the whole range
    if (mine) walk<K>(&tile[0][0], kTile, s - stage0, e - stage0, acc);
  } else {  // a segment runs past it: stage [r0, r1) tile by tile
    for (int t0 = r0; t0 < r1; t0 += kTile) {
      const int len = min(kTile, r1 - t0);
      __syncthreads();  // nobody reads the previous tile any more
      for (int base = 0; base < len; base += kThreads * kStageUnroll) {
#pragma unroll
        for (int u = 0; u < kStageUnroll; ++u) {
          const int i = base + t + u * kThreads;
          idx[u] = i < len ? order[t0 + i] : -1;
        }
        gather<K>(x, n, idx, v);
        put<K>(&tile[0][0], kTile, base, len, v);
      }
      __syncthreads();
      if (mine) walk<K>(&tile[0][0], kTile, max(s, t0) - t0, min(e, t0 + len) - t0, acc);
    }
  }
  if (mine) {
#pragma unroll
    for (int c = 0; c < K; ++c) out[static_cast<int64_t>(c) * n_seg + g] = acc[c];
  }
}

template <int K>
void launch(const void* x, int n, const void* order, const void* offs,
            int n_seg, void* out, cudaStream_t stream) {
  const int blocks = (n_seg + kThreads - 1) / kThreads + n / kPiece;
  segment_sum_kernel<K><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(x), n, static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(offs), n_seg, static_cast<float*>(out));
}

}  // namespace

// x: [k, n] f32 contiguous; order: int32 live elements by segment; offs:
// int32 [n_seg + 1]; out: [k, n_seg] f32. Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for k outside 1..4).
extern "C" int segment_sum_launch(const void* x, int k, int n,
                                  const void* order, const void* offs,
                                  int n_seg, void* out, void* stream) {
  if (n_seg > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (k) {
      case 1: launch<1>(x, n, order, offs, n_seg, out, st); break;
      case 2: launch<2>(x, n, order, offs, n_seg, out, st); break;
      case 3: launch<3>(x, n, order, offs, n_seg, out, st); break;
      case 4: launch<4>(x, n, order, offs, n_seg, out, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
