// Threshold-estimate kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of gaussiank_sgd_tpu/ops/pallas_select.py:
//   * B3 `_stats_kernel` (launcher `fused_stats`): one pass over a flat f32
//     buffer -> (sum, sum of squares, max |x|);
//   * B4 `_count_kernel` (launcher `multi_threshold_counts`): one pass ->
//     counts[j] = |{ |x| > t[j] }| for 32 thresholds, in any order.
// The TPU kernels carried their sums in SMEM across a sequential grid. Here
// blocks run in no order, so each kernel reduces per block and combines the
// blocks in a way that does not depend on their order.
//
// Both walk the buffer with a grid-stride loop of 16-byte (float4) loads.
// A buffer that does not start on 16 bytes (a bucket's slice of the flat
// gradient) is read as a scalar head of at most 3 elements, the float4
// body, and a scalar tail of at most 3; nothing past n is read. The
// reference pads x with zeros to a multiple of 8192 instead. That changes
// nothing for B3, nor for B4 at a threshold t >= 0 (|0| > t is false), but
// at t < 0 the reference also counts its padding; the estimate never makes
// a negative candidate.
//
// B3. Each thread keeps an f32 sum, an f32 sum of squares and a max of |x|;
// warp shuffles and then shared memory reduce them per block in a fixed
// order into scratch[block][3], and a second one-block pass reduces the
// scratch rows in a fixed order. No float atomics: the sums depend only on n
// and the block count, so a run repeats bit for bit. The max is exact (and
// propagates NaN, as torch.amax does). Bound: bytes, 4n B read for ~4
// operations an element (add, multiply-add, max of the absolute value).
//
// B4. Comparing every |x| with all 32 thresholds costs ~65 instructions an
// element and 32 live counters a thread, which makes it bound by issue at
// several times the byte bound. Instead each block sorts the thresholds
// once, bins each element by a binary search and counts bins:
//   * sort: warp 0 loads t, and lane j takes the rank of t[j] (the number
//     of t[i] < t[j], or equal with i < j; NaN ranks last) by 32 shuffles;
//     ts[rank] = t[j], slot[rank] = j. With NaN last, ts[r] < a holds for a
//     prefix of r, for any a, so counts[slot[r]] = |{a : a > ts[r]}| is the
//     number of elements whose bin, b = |{r : ts[r] < a}|, exceeds r. Ties,
//     -0.0, +-inf and NaN in t or x then give what the plain compares give.
//   * bin: a = |x|; if !(a > ts[0]) (NaN, or at or below every threshold,
//     as for nearly every element against the linear candidates) the
//     element counts nowhere. Otherwise b - 1 in 0..31 by a 5-step
//     branchless search over ts[1..31]: the first two probes (ts[16], then
//     ts[8] or ts[24]) are registers, the last three read ts in shared
//     memory (32 floats in 32 banks, so no lane pattern conflicts). A
//     float4 whose four elements all fail ts[0] takes one branch around
//     all of it; otherwise its four searches run without branches and an
//     element that failed adds 0 to its bin.
//   * count: each thread owns one column of a shared int histogram,
//     hist[b - 1][thread], whose bank is the thread's lane: no conflicts
//     and no atomics, so the time does not depend on how the data fall
//     into bins. 32 x 256 x 4 B = 32 KB a block lets 6 blocks share an SM;
//     the grid is one wave of resident blocks.
//   * combine: each bin is summed over the block's threads, the suffix sums
//     c[r] = |{b > r}| taken by warp shuffles, and each nonzero c[r] added
//     with one integer atomicAdd into counts[slot[r]]: exact in any block
//     order.
//   * loads: one float4 a thread in flight while the previous one is
//     binned, the first issued before the sort.
// About 31 instructions an element against the log-spaced candidates and 7
// against the linear ones (cuobjdump -sass on sm_90a), which the H100
// issues in less time than it reads the 4n bytes: bound by bytes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;
constexpr int kNcand = 32;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The float4 body of x [0, n): its first element and its length in float4s.
struct Split {
  long long head;   // scalar elements before the body
  long long nvec;   // float4s in the body
  long long tail0;  // first scalar element after the body
};

__device__ __forceinline__ Split split(const float* x, long long n) {
  Split s;
  const long long mis = (reinterpret_cast<uintptr_t>(x) & 15) / 4;
  s.head = mis ? 4 - mis : 0;
  if (s.head > n) s.head = n;
  s.nvec = (n - s.head) / 4;
  s.tail0 = s.head + 4 * s.nvec;
  return s;
}

int blocks_for(long long n) {
  const long long b = (n + 4LL * kThreads - 1) / (4LL * kThreads);
  return static_cast<int>(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

// ------------------------------------------------------------------- B3

struct Stats {
  float s, ss, m;
};

__device__ __forceinline__ void add(Stats& st, float v) {
  st.s += v;
  st.ss = fmaf(v, v, st.ss);
  st.m = nan_max(fabsf(v), st.m);
}

// Reduce each thread's Stats over the block in a fixed order; thread 0
// returns the block's.
__device__ Stats block_reduce(Stats st) {
  __shared__ Stats warp_stats[kWarps];
  for (int off = 16; off > 0; off >>= 1) {
    st.s += __shfl_down_sync(0xffffffffu, st.s, off);
    st.ss += __shfl_down_sync(0xffffffffu, st.ss, off);
    st.m = nan_max(st.m, __shfl_down_sync(0xffffffffu, st.m, off));
  }
  const int lane = threadIdx.x & 31;
  if (lane == 0) warp_stats[threadIdx.x >> 5] = st;
  __syncthreads();
  if (threadIdx.x == 0) {
    st = warp_stats[0];
    for (int w = 1; w < kWarps; ++w) {
      st.s += warp_stats[w].s;
      st.ss += warp_stats[w].ss;
      st.m = nan_max(st.m, warp_stats[w].m);
    }
  }
  return st;
}

__global__ void __launch_bounds__(kThreads)
stats_partial_kernel(const float* __restrict__ x, long long n,
                     float* __restrict__ scratch) {
  const Split sp = split(x, n);
  const float4* __restrict__ body = reinterpret_cast<const float4*>(x + sp.head);
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  Stats st{0.0f, 0.0f, 0.0f};
  for (long long i = tid; i < sp.nvec; i += stride) {
    const float4 v = __ldg(body + i);
    add(st, v.x);
    add(st, v.y);
    add(st, v.z);
    add(st, v.w);
  }
  if (tid < sp.head) add(st, x[tid]);
  if (tid < n - sp.tail0) add(st, x[sp.tail0 + tid]);
  st = block_reduce(st);
  if (threadIdx.x == 0) {
    scratch[3 * blockIdx.x + 0] = st.s;
    scratch[3 * blockIdx.x + 1] = st.ss;
    scratch[3 * blockIdx.x + 2] = st.m;
  }
}

__global__ void __launch_bounds__(kThreads)
stats_final_kernel(const float* __restrict__ scratch, int blocks,
                   float* __restrict__ out) {
  Stats st{0.0f, 0.0f, 0.0f};
  for (int b = threadIdx.x; b < blocks; b += kThreads) {
    st.s += scratch[3 * b + 0];
    st.ss += scratch[3 * b + 1];
    st.m = nan_max(scratch[3 * b + 2], st.m);
  }
  st = block_reduce(st);
  if (threadIdx.x == 0) {
    out[0] = st.s;
    out[1] = st.ss;
    out[2] = st.m;
  }
}

// ------------------------------------------------------------------- B4

constexpr int kCountBlocksPerSM = 6;   // 6 x 33 KB of shared memory
static_assert(kNcand == 32 && kNcand % kWarps == 0, "one warp sorts t");

// The sorted thresholds and the histogram (hist[bin][thread]) at namespace
// scope, indexed directly: the probes then address shared memory as a
// fixed offset plus a register. (Through a generic pointer the compiler
// rebuilt the shared window's base for every element.)
__shared__ float b4_ts[kNcand];
__shared__ int b4_hist[kNcand * kThreads];

// The sorted thresholds a thread probes from registers.
struct Probes {
  float t0, t8, t16, t24;
};

// Bin b - 1 of a > ts[0], as a byte offset o = 4 (b - 1) into ts: five
// branchless probes (see the note at the top). o stays a multiple of 4, so
// ts[o >> 2] compiles to one shared load at o.
__device__ __forceinline__ int bin_offset(float a, const Probes& pr) {
  int o = a > pr.t16 ? 64 : 0;
  o += a > (o ? pr.t24 : pr.t8) ? 32 : 0;
  o += a > b4_ts[(o >> 2) + 4] ? 16 : 0;
  o += a > b4_ts[(o >> 2) + 2] ? 8 : 0;
  o += a > b4_ts[(o >> 2) + 1] ? 4 : 0;
  return o;
}

// hist[o / 4][thread] for the thread's column col = 4 * thread, in bytes
__device__ __forceinline__ int& hist_at(int col, int o) {
  return b4_hist[(col + o * kThreads) >> 2];
}

// Count the four elements of v in the thread's histogram column. One branch
// around the four, which the linear candidates almost never take; inside
// it, each element's search runs and adds a > ts[0] (0 or 1) to its bin.
__device__ __forceinline__ void bin4(const float4& v, const Probes& pr,
                                     int col) {
  const float a[4] = {fabsf(v.x), fabsf(v.y), fabsf(v.z), fabsf(v.w)};
  if (!(a[0] > pr.t0 || a[1] > pr.t0 || a[2] > pr.t0 || a[3] > pr.t0)) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    hist_at(col, bin_offset(a[k], pr)) += a[k] > pr.t0;
  }
}

__device__ __forceinline__ void bin1(float v, const Probes& pr, int col) {
  const float a = fabsf(v);
  if (a > pr.t0) hist_at(col, bin_offset(a, pr)) += 1;
}

__global__ void __launch_bounds__(kThreads, kCountBlocksPerSM)
count_kernel(const float* __restrict__ x, int n,
             const float* __restrict__ thresholds, int* __restrict__ counts) {
  __shared__ int slot[kNcand];
  __shared__ int bin_sum[kNcand];
  const Split sp = split(x, n);
  const float4* __restrict__ body = reinterpret_cast<const float4*>(x + sp.head);
  const float4* const end = body + sp.nvec;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  // the first load goes out before the sort, which it then overlaps
  const float4* p = body + tid;
  float4 v;
  if (p < end) v = __ldg(p);

  if (threadIdx.x < kNcand) {
    const int j = threadIdx.x;
    const float tj = thresholds[j];
    const bool nan_j = tj != tj;
    int rank = 0;
#pragma unroll
    for (int k = 0; k < kNcand; ++k) {
      const float tk = __shfl_sync(0xffffffffu, tj, k);
      const bool before = nan_j ? (tk == tk) | (k < j)
                                : (tk < tj) | ((tk == tj) & (k < j));
      rank += before;
    }
    b4_ts[rank] = tj;
    slot[rank] = j;
  }
  const int col = 4 * threadIdx.x;  // the thread's column, in bytes
#pragma unroll
  for (int b = 0; b < kNcand; ++b) hist_at(col, 4 * b) = 0;
  __syncthreads();

  const Probes pr{b4_ts[0], b4_ts[8], b4_ts[16], b4_ts[24]};
  for (; p < end; p += stride) {
    // the next float4 is in flight while this one is binned
    float4 w;
    if (p + stride < end) w = __ldg(p + stride);
    bin4(v, pr, col);
    v = w;
  }
  if (tid < sp.head) bin1(x[tid], pr, col);
  if (tid < n - sp.tail0) bin1(x[sp.tail0 + tid], pr, col);
  __syncthreads();

  // warp w sums bins 4w+1 .. 4w+4 over the block's columns
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kNcand / kWarps; ++q) {
    const int b = warp * (kNcand / kWarps) + q;
    int s = 0;
#pragma unroll
    for (int c = lane; c < kThreads; c += 32) s += b4_hist[b * kThreads + c];
    s = __reduce_add_sync(0xffffffffu, s);
    if (lane == 0) bin_sum[b] = s;
  }
  __syncthreads();
  if (warp == 0) {
    // the block's elements past ts[r]: the suffix sum of bins r+1 .. 32
    int c = bin_sum[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_down_sync(0xffffffffu, c, off);
      if (lane + off < 32) c += up;
    }
    if (c) atomicAdd(counts + slot[lane], c);
  }
}

// One wave: the blocks of count_kernel resident on the current device at
// once, found once per device (this reads no stream, so it is safe while a
// CUDA graph is captured).
int count_blocks(long long n, cudaError_t* err) {
  constexpr int kMaxDevices = 64;
  static int wave[kMaxDevices] = {};
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess || dev >= kMaxDevices) {
    if (*err == cudaSuccess) *err = cudaErrorInvalidDevice;
    return 0;
  }
  if (wave[dev] == 0) {
    int sms = 0, per_sm = 0;
    *err = cudaFuncSetAttribute(count_kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
    if (*err == cudaSuccess) {
      *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (*err == cudaSuccess) {
      *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, count_kernel, kThreads, 0);
    }
    if (*err != cudaSuccess) return 0;
    wave[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  // no more blocks than give each thread a float4
  const long long need = (n + 4LL * kThreads - 1) / (4LL * kThreads);
  return static_cast<int>(need < wave[dev] ? (need > 0 ? need : 1) : wave[dev]);
}

}  // namespace

// Rows of the [blocks, 3] scratch buffer gk_fused_stats needs for n elements.
extern "C" int gk_stats_blocks(long long n) { return blocks_for(n); }

// B3: (sum, sum of squares, max |x|) of x [n] into out [3]; scratch holds
// gk_stats_blocks(n) rows of 3 floats.
extern "C" int gk_fused_stats(const float* x, long long n, float* scratch,
                              int blocks, float* out, void* stream) {
  if (n <= 0 || blocks != blocks_for(n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  stats_partial_kernel<<<blocks, kThreads, 0, s>>>(x, n, scratch);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_final_kernel<<<1, kThreads, 0, s>>>(scratch, blocks, out);
  return static_cast<int>(cudaGetLastError());
}

// B4: counts[j] += |{ |x| > thresholds[j] }| for 32 thresholds over x [n],
// 0 < n < 2^31 (the counts are int32); the caller zeroes counts.
extern "C" int gk_multi_threshold_counts(const float* x, long long n,
                                         const float* thresholds, int* counts,
                                         void* stream) {
  if (n <= 0 || n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  const int blocks = count_blocks(n, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  count_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<int>(n), thresholds, counts);
  return static_cast<int>(cudaGetLastError());
}
