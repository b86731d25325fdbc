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
// body, and a scalar tail of at most 3; nothing past n is read, which is
// what the reference's zero padding to 8192 computes.
//
// B3. Each thread keeps an f32 sum, an f32 sum of squares and a max of |x|;
// warp shuffles and then shared memory reduce them per block in a fixed
// order into scratch[block][3], and a second one-block pass reduces the
// scratch rows in a fixed order. No float atomics: the sums depend only on n
// and the block count, so a run repeats bit for bit. The max is exact (and
// propagates NaN, as torch.amax does). Bound: bytes, 4n B read for ~4
// operations an element (add, multiply-add, max of the absolute value).
//
// B4. The 32 thresholds go to shared memory and then registers; each thread
// compares every |x| it reads with all 32 and adds to 32 integer counters.
// Each warp sums a counter with one __reduce_add_sync, lanes 0 add the warp
// sums into the block's shared counters, and the block adds each nonzero
// counter to the output with one integer atomicAdd: exact in any block
// order. Bound: near balance, 4n B read against ~65 operations an element
// (32 compares, 32 adds, one abs).

#include <cuda_runtime.h>
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

__device__ __forceinline__ void count(int (&c)[kNcand],
                                      const float (&t)[kNcand], float v) {
  const float a = fabsf(v);
#pragma unroll
  for (int j = 0; j < kNcand; ++j) c[j] += a > t[j] ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const float* __restrict__ x, long long n,
             const float* __restrict__ thresholds, int* __restrict__ counts) {
  __shared__ float t_shared[kNcand];
  __shared__ int block_counts[kNcand];
  if (threadIdx.x < kNcand) {
    t_shared[threadIdx.x] = thresholds[threadIdx.x];
    block_counts[threadIdx.x] = 0;
  }
  __syncthreads();
  float t[kNcand];
  int c[kNcand];
#pragma unroll
  for (int j = 0; j < kNcand; ++j) {
    t[j] = t_shared[j];
    c[j] = 0;
  }
  const Split sp = split(x, n);
  const float4* __restrict__ body = reinterpret_cast<const float4*>(x + sp.head);
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = tid; i < sp.nvec; i += stride) {
    const float4 v = __ldg(body + i);
    count(c, t, v.x);
    count(c, t, v.y);
    count(c, t, v.z);
    count(c, t, v.w);
  }
  if (tid < sp.head) count(c, t, x[tid]);
  if (tid < n - sp.tail0) count(c, t, x[sp.tail0 + tid]);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kNcand; ++j) {
    const int w = __reduce_add_sync(0xffffffffu, c[j]);
    if (lane == 0 && w) atomicAdd(block_counts + j, w);
  }
  __syncthreads();
  if (threadIdx.x < kNcand && block_counts[threadIdx.x]) {
    atomicAdd(counts + threadIdx.x, block_counts[threadIdx.x]);
  }
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

// B4: counts[j] += |{ |x| > thresholds[j] }| for 32 thresholds over x [n];
// the caller zeroes counts.
extern "C" int gk_multi_threshold_counts(const float* x, long long n,
                                         const float* thresholds, int* counts,
                                         void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  count_kernel<<<blocks_for(n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(x, n, thresholds,
                                                      counts);
  return static_cast<int>(cudaGetLastError());
}
