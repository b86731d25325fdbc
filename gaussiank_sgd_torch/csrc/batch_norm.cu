// Kernel B5: train-mode BatchNorm, forward and backward, for Hopper (sm_90a).
//
// B5 replaces no TPU kernel. The reference leaves BatchNorm to XLA, which
// fuses its reductions and its elementwise tail into a few passes; the
// port's eager form was ~20 PyTorch ops forward and as many in autograd's
// backward, each a full pass over the activation in f32. This file computes
// the same function, FlatModel._batch_norm in train mode, in a few passes.
//
// The tensor is seen as it lies in memory: [outer, C, inner], a matrix of
// `rows` = outer rows and `cols` = C * inner columns whose column j belongs
// to channel j / inner (channels-last activations: inner = 1; NCHW: inner =
// H * W). Forward, in f32 whatever the input's type:
//   1. bn_stats_kernel: per-column partial sums of x and x^2, a row of
//      partials per block row;
//   2. bn_forward_final_kernel: each channel's partials summed in a fixed
//      order; mean = Sx / M, var = max(Sx2 / M - mean^2, 0); the
//      running statistics m * ra + (1 - m) * batch, each operation rounded
//      as the eager code rounds it; rstd = rsqrt(var + eps), mul = rstd *
//      scale; saved: mean, rstd, mul and whether the clamp passed;
//   3. bn_apply_kernel: y = (x - mean) * mul + bias, written in f32.
// Backward, from the saved input (its own type), mean and rstd:
//   1. bn_grad_stats_kernel: per-column partial sums of dy and dy * (x -
//      mean);
//   2. bn_backward_final_kernel: d scale = S(dy d) * rstd, d bias = S dy,
//      and the two per-channel coefficients of dx;
//   3. bn_grad_apply_kernel: dx = dy * mul + A + B * (x - mean), with A =
//      -mul S dy / M and B = 2 dv / M, dv = -0.5 S(dy d) scale rstd^3 (0
//      where the clamp bound): what autograd of the eager formula gives,
//      written in the input's type.
// No float atomics: every sum is taken in an order fixed by the shape and
// the tiling alone, so a run repeats bit for bit.
//
// Bound: bytes. Per element a bf16 input reads x (2 B) and writes y (4 B)
// forward, reads dy (4 B) and x (2 B) and writes dx (2 B) backward: 14 B,
// for ~10 operations. Both directions need a per-channel reduction before
// their elementwise pass, so each reads its inputs twice (22 B an element).
// The design spends the rest of its effort on bandwidth:
//   * 16-byte loads and stores (8 bf16 or 4 f32 a thread), each warp on
//     contiguous bytes: a block is tc vector columns (at most 32) by tr =
//     256 / tc rows, so a channels-last row of 64 channels is one 128-byte
//     line and a warp reads four of them;
//   * each thread keeps its columns' sums in registers over its rows and
//     holds 4 loads in flight (2 in the elementwise passes, whose stores
//     take registers too); the block then adds its rows' sums per column in
//     shared memory, in a fixed order, and writes one row of partials.
//     Blocks take contiguous chunks of rows, at least 8 rows a thread, so
//     partials cost at most 1/16 of the bytes of x;
//   * small inner (4, 16, 49) and inner = 1 take the same path as large:
//     columns, not channels, are the unit of work. The final kernels read
//     the partials 32 neighbouring columns a warp and 32 block rows at once
//     (a block of 1,024 threads for 32 / inner channels, or for one channel
//     of inner >= 32 columns), then sum each channel's inner columns;
//   * the three kernels of a direction are launched as programmatic
//     dependents (sm_90), so each is scheduled while the one before it
//     drains and waits only before it reads that one's output;
//   * the elementwise passes walk the blocks and each chunk's rows in
//     reverse, so they start on the bytes the reduction read last, which
//     the 50 MB L2 may still hold.
// The tiling (tc, the number of block rows) comes from the wrapper
// (ops/batch_norm.py), which picks it from the shape alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kReduceUnroll = 4;   // loads in flight a thread, reductions
constexpr int kApplyUnroll = 2;    // and elementwise passes
constexpr int kFinalThreads = 1024;
constexpr int kFinalWarps = kFinalThreads / 32;

struct Tile {
  long long rows;   // outer
  long long cols;   // C * inner
  long long inner;  // columns a channel takes in a row
  int tc;           // vector columns a block
  int tr;           // thread rows a block (kThreads / tc)
};

struct Consts {
  float momentum;   // m
  float one_minus;  // 1 - m, rounded to f32 as the eager op rounds it
  float eps;
  float inv_m;      // 1 / (outer * inner)
};

// Programmatic dependent launch (sm_90): B5's kernels are launched so that
// each may be scheduled while the one before it in the stream drains. A
// kernel waits before it reads what the one before it wrote, and lets the
// next one be scheduled once its own loads are done.
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// ------------------------------------------------------- loads, stores

template <int V>
__device__ __forceinline__ void load(const float* __restrict__ p, float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + k);
      v[k] = q.x;
      v[k + 1] = q.y;
      v[k + 2] = q.z;
      v[k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = p[k];
  }
}

template <int V>
__device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ p,
                                     float (&v)[V]) {
  if constexpr (V % 8 == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(p + k);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        v[k + 2 * j] = f.x;
        v[k + 2 * j + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = __bfloat162float(p[k]);
  }
}

template <int V>
__device__ __forceinline__ void store(float* __restrict__ p, const float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      *reinterpret_cast<float4*>(p + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = v[k];
  }
}

template <int V>
__device__ __forceinline__ void store(__nv_bfloat16* __restrict__ p,
                                      const float (&v)[V]) {
  if constexpr (V % 8 == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 8) {
      uint4 q;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        h[j] = __floats2bfloat162_rn(v[k + 2 * j], v[k + 2 * j + 1]);
      }
      *reinterpret_cast<uint4*>(p + k) = q;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = __float2bfloat16_rn(v[k]);
  }
}

// ------------------------------------------------------------- a block

// This thread's place in the block's tile and the block's rows.
template <int V>
struct Place {
  int tx, ty;
  long long col;     // first of the thread's V columns
  bool active;       // a row of the tile and a column of the matrix
  long long r0, r1;  // the block's rows [r0, r1)

  __device__ Place(const Tile& t, int block_row) {
    tx = threadIdx.x % t.tc;
    ty = threadIdx.x / t.tc;
    col = (static_cast<long long>(blockIdx.x) * t.tc + tx) * V;
    active = ty < t.tr && col < t.cols;
    const long long chunk = (t.rows + gridDim.y - 1) / gridDim.y;
    r0 = block_row * chunk;
    r1 = r0 + chunk < t.rows ? r0 + chunk : t.rows;
  }

  // rows of this thread: r0 + ty + i * tr for i in [0, count())
  __device__ long long count(const Tile& t) const {
    return r1 - r0 > ty ? (r1 - r0 - ty + t.tr - 1) / t.tr : 0;
  }
  __device__ long long row(const Tile& t, long long i) const {
    return r0 + ty + i * t.tr;
  }
};

// Add the block's rows of a[V] and b[V] per column, in a fixed order, and
// write them to part[blockIdx.y][0][col] and part[blockIdx.y][1][col].
template <int V>
__device__ __forceinline__ void column_sums(const float (&a)[V],
                                            const float (&b)[V], const Tile& t,
                                            const Place<V>& at,
                                            float* __restrict__ part) {
  // [(k * tr + ty) * tc + tx]: a warp's threads write and read
  // neighbouring words
  __shared__ float sa[kThreads * V];
  __shared__ float sb[kThreads * V];
  if (at.ty < t.tr) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      sa[(k * t.tr + at.ty) * t.tc + at.tx] = a[k];
      sb[(k * t.tr + at.ty) * t.tc + at.tx] = b[k];
    }
  }
  __syncthreads();
  float* out = part + static_cast<long long>(blockIdx.y) * 2 * t.cols;
  for (int j = threadIdx.x; j < t.tc * V; j += kThreads) {
    const int k = j / t.tc, x = j % t.tc;
    const long long column = (static_cast<long long>(blockIdx.x) * t.tc + x) * V + k;
    if (column >= t.cols) continue;
    float sum_a = 0.0f, sum_b = 0.0f;
    for (int y = 0; y < t.tr; ++y) {
      sum_a += sa[(k * t.tr + y) * t.tc + x];
      sum_b += sb[(k * t.tr + y) * t.tc + x];
    }
    out[column] = sum_a;
    out[t.cols + column] = sum_b;
  }
}

// Channels a final block sums: 32 / inner channels of inner < 32 columns
// (a lane a column), or one channel of inner >= 32 columns.
__host__ __device__ __forceinline__ int channels_a_block(long long inner) {
  return inner < 32 ? static_cast<int>(32 / inner) : 1;
}

// The final kernels' block: channels [c0, c0 + cb), cb =
// channels_a_block(inner). Each warp reads rows of partials, 32
// neighbouring columns at a time (one channel's columns over all the
// threads where inner >= 32); the warps' sums meet in shared memory in a
// fixed order. Returns whether this thread holds channel c's sums (a, b):
// lane k of warp 0 for channel c0 + k.
__device__ __forceinline__ bool channel_sums(const float* __restrict__ part,
                                             int block_rows, const Tile& t,
                                             long long& c, float& a,
                                             float& b) {
  __shared__ float wa[kFinalWarps][32], wb[kFinalWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cb = channels_a_block(t.inner);
  const long long C = t.cols / t.inner;
  const long long c0 = static_cast<long long>(blockIdx.x) * cb;
  const long long n_ch = C - c0 < cb ? C - c0 : cb;
  const float* p0 = part + c0 * t.inner;
  a = 0.0f;
  b = 0.0f;
  if (t.inner >= 32) {   // one channel: its partials over every thread
    const long long n = block_rows * t.inner;
    for (long long k = threadIdx.x; k < n; k += kFinalThreads) {
      const long long g = k / t.inner;
      const float* p = p0 + g * 2 * t.cols + (k - g * t.inner);
      a += p[0];
      b += p[t.cols];
    }
  } else {               // a lane a column, a warp every 32nd block row
    for (long long j = lane; j < n_ch * t.inner; j += 32) {
#pragma unroll 4
      for (int g = warp; g < block_rows; g += kFinalWarps) {
        const float* p = p0 + static_cast<long long>(g) * 2 * t.cols + j;
        a += p[0];
        b += p[t.cols];
      }
    }
  }
  wa[warp][lane] = a;
  wb[warp][lane] = b;
  __syncthreads();
  if (warp != 0) return false;
  a = 0.0f;
  b = 0.0f;
  for (int w = 0; w < kFinalWarps; ++w) {
    a += wa[w][lane];
    b += wb[w][lane];
  }
  if (t.inner >= 32) {   // one channel: its parts on the 32 lanes
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      b += __shfl_down_sync(0xffffffffu, b, off);
    }
    c = c0;
    return lane == 0;
  }
  wa[0][lane] = a;       // a lane a column: channel k's are lanes
  wb[0][lane] = b;       // k * inner .. k * inner + inner - 1
  __syncwarp();
  if (lane >= n_ch) return false;
  a = 0.0f;
  b = 0.0f;
  for (long long i = lane * t.inner; i < (lane + 1) * t.inner; ++i) {
    a += wa[0][i];
    b += wb[0][i];
  }
  c = c0 + lane;
  return true;
}

// ------------------------------------------------------------- forward

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_stats_kernel(const T* __restrict__ x, Tile t, float* __restrict__ part) {
  const Place<V> at(t, blockIdx.y);
  wait_for_previous();
  float s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = q[k] = 0.0f;
  if (at.active) {
    const long long n = at.count(t);
    for (long long i = 0; i < n; i += kReduceUnroll) {
      float v[kReduceUnroll][V];
#pragma unroll
      for (int u = 0; u < kReduceUnroll; ++u) {
        if (i + u < n) {
          load(x + at.row(t, i + u) * t.cols + at.col, v[u]);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) v[u][k] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kReduceUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          s[k] += v[u][k];
          q[k] = fmaf(v[u][k], v[u][k], q[k]);
        }
      }
    }
  }
  let_next_start();
  column_sums(s, q, t, at, part);
}

// saved: [4][C] = mean, rstd, mul, 1 where the clamp passed (var >= 0)
__global__ void __launch_bounds__(kFinalThreads)
bn_forward_final_kernel(const float* __restrict__ part, int block_rows, Tile t,
                        const float* __restrict__ scale,
                        float* __restrict__ run_mean, float* __restrict__ run_var,
                        Consts k, float* __restrict__ saved) {
  const long long C = t.cols / t.inner;
  long long c;
  wait_for_previous();
  let_next_start();
  float s, q;
  if (!channel_sums(part, block_rows, t, c, s, q)) return;
  const float mean = __fmul_rn(s, k.inv_m);
  const float var_raw = __fsub_rn(__fmul_rn(q, k.inv_m), __fmul_rn(mean, mean));
  const float var = var_raw < 0.0f ? 0.0f : var_raw;   // a NaN stays
  run_mean[c] = __fadd_rn(__fmul_rn(k.momentum, run_mean[c]),
                          __fmul_rn(k.one_minus, mean));
  run_var[c] = __fadd_rn(__fmul_rn(k.momentum, run_var[c]),
                         __fmul_rn(k.one_minus, var));
  const float rstd = rsqrtf(__fadd_rn(var, k.eps));
  saved[c] = mean;
  saved[C + c] = rstd;
  saved[2 * C + c] = __fmul_rn(rstd, scale[c]);
  saved[3 * C + c] = var_raw >= 0.0f ? 1.0f : 0.0f;
}

// The per-channel values of the thread's V columns, from a [C] array.
template <int V>
__device__ __forceinline__ void per_column(const float* __restrict__ a,
                                           const Tile& t, long long col,
                                           float (&v)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = a[(col + k) / t.inner];
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const T* __restrict__ x, Tile t, const float* __restrict__ saved,
                const float* __restrict__ bias, long long C,
                float* __restrict__ y) {
  const Place<V> at(t, gridDim.y - 1 - blockIdx.y);   // the last rows first
  wait_for_previous();
  if (!at.active) return;
  float mean[V], mul[V], b[V];
  per_column(saved, t, at.col, mean);
  per_column(saved + 2 * C, t, at.col, mul);
  per_column(bias, t, at.col, b);
  for (long long i = at.count(t) - 1; i >= 0; i -= kApplyUnroll) {
    float v[kApplyUnroll][V];
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      if (i - u >= 0) load(x + at.row(t, i - u) * t.cols + at.col, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      if (i - u < 0) continue;
      float o[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        o[k] = __fadd_rn(__fmul_rn(__fsub_rn(v[u][k], mean[k]), mul[k]), b[k]);
      }
      store(y + at.row(t, i - u) * t.cols + at.col, o);
    }
  }
}

// ------------------------------------------------------------ backward

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_grad_stats_kernel(const float* __restrict__ dy, const T* __restrict__ x,
                     Tile t, const float* __restrict__ saved,
                     float* __restrict__ part) {
  const Place<V> at(t, blockIdx.y);
  wait_for_previous();
  float sg[V], sgd[V], mean[V];
#pragma unroll
  for (int k = 0; k < V; ++k) sg[k] = sgd[k] = 0.0f;
  if (at.active) {
    per_column(saved, t, at.col, mean);
    const long long n = at.count(t);
    for (long long i = 0; i < n; i += kReduceUnroll) {
      float g[kReduceUnroll][V], v[kReduceUnroll][V];
#pragma unroll
      for (int u = 0; u < kReduceUnroll; ++u) {
        if (i + u < n) {
          const long long off = at.row(t, i + u) * t.cols + at.col;
          load(dy + off, g[u]);
          load(x + off, v[u]);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) g[u][k] = v[u][k] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kReduceUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          sg[k] += g[u][k];
          sgd[k] = fmaf(g[u][k], __fsub_rn(v[u][k], mean[k]), sgd[k]);
        }
      }
    }
  }
  let_next_start();
  column_sums(sg, sgd, t, at, part);
}

// dparams: [2][C] = d scale, d bias; coef: [2][C] = A, B of dx
__global__ void __launch_bounds__(kFinalThreads)
bn_backward_final_kernel(const float* __restrict__ part, int block_rows, Tile t,
                         const float* __restrict__ scale,
                         const float* __restrict__ saved, Consts k,
                         float* __restrict__ dparams, float* __restrict__ coef) {
  const long long C = t.cols / t.inner;
  long long c;
  wait_for_previous();
  let_next_start();
  float sg, sgd;
  if (!channel_sums(part, block_rows, t, c, sg, sgd)) return;
  const float rstd = saved[C + c], mul = saved[2 * C + c];
  dparams[c] = __fmul_rn(sgd, rstd);
  dparams[C + c] = sg;
  // autograd: d rstd = S(dy d) * scale; d var = -0.5 d rstd rstd^3 where
  // the clamp passed; d mean = -mul S dy - 2 mean d var
  const float drstd = __fmul_rn(sgd, scale[c]);
  const float r3 = __fmul_rn(__fmul_rn(rstd, rstd), rstd);
  const float dvar = saved[3 * C + c] != 0.0f
                         ? __fmul_rn(__fmul_rn(-0.5f, drstd), r3) : 0.0f;
  coef[c] = -__fmul_rn(__fmul_rn(mul, sg), k.inv_m);
  coef[C + c] = __fmul_rn(__fmul_rn(2.0f, dvar), k.inv_m);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_grad_apply_kernel(const float* __restrict__ dy, const T* __restrict__ x,
                     Tile t, const float* __restrict__ saved,
                     const float* __restrict__ coef, long long C,
                     T* __restrict__ dx) {
  const Place<V> at(t, gridDim.y - 1 - blockIdx.y);   // the last rows first
  wait_for_previous();
  if (!at.active) return;
  float mean[V], mul[V], a[V], b[V];
  per_column(saved, t, at.col, mean);
  per_column(saved + 2 * C, t, at.col, mul);
  per_column(coef, t, at.col, a);
  per_column(coef + C, t, at.col, b);
  for (long long i = at.count(t) - 1; i >= 0; i -= kApplyUnroll) {
    float g[kApplyUnroll][V], v[kApplyUnroll][V];
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      if (i - u >= 0) {
        const long long off = at.row(t, i - u) * t.cols + at.col;
        load(dy + off, g[u]);
        load(x + off, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      if (i - u < 0) continue;
      float o[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        o[k] = __fadd_rn(__fadd_rn(__fmul_rn(g[u][k], mul[k]), a[k]),
                         __fmul_rn(b[k], __fsub_rn(v[u][k], mean[k])));
      }
      store(dx + at.row(t, i - u) * t.cols + at.col, o);
    }
  }
}

// ------------------------------------------------------------- launches

bool bad_tiling(long long rows, long long C, long long inner, int vec, int tc,
                int block_rows) {
  return rows <= 0 || C <= 0 || inner <= 0 || C > 0x7fffffffLL || tc <= 0 ||
         tc > kThreads || block_rows <= 0 || block_rows > 65535 ||
         (C * inner) % vec != 0 ||
         (C * inner / vec + tc - 1) / tc > 0x7fffffffLL;
}

Tile make_tile(long long rows, long long C, long long inner, int tc) {
  return Tile{rows, C * inner, inner, tc, kThreads / tc};
}

unsigned final_blocks(const Tile& t) {
  const long long cb = channels_a_block(t.inner);
  return static_cast<unsigned>((t.cols / t.inner + cb - 1) / cb);
}

dim3 grid_of(const Tile& t, int vec, int block_rows) {
  return dim3(static_cast<unsigned>((t.cols / vec + t.tc - 1) / t.tc),
              static_cast<unsigned>(block_rows));
}

// Launch with programmatic stream serialization (see wait_for_previous).
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), dim3 grid, int threads, cudaStream_t s,
           Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
}

template <typename T, int V>
int forward(const void* x, const Tile& t, int block_rows, const float* scale,
            const float* bias, float* run_mean, float* run_var, Consts k,
            float* y, float* part, float* saved, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const long long C = t.cols / t.inner;
  const dim3 grid = grid_of(t, V, block_rows);
  int err = launch(bn_stats_kernel<T, V>, grid, kThreads, s, xt, t, part);
  if (err == 0) {
    err = launch(bn_forward_final_kernel, dim3(final_blocks(t)), kFinalThreads,
                 s, static_cast<const float*>(part), block_rows, t, scale,
                 run_mean, run_var, k, saved);
  }
  if (err == 0) {
    err = launch(bn_apply_kernel<T, V>, grid, kThreads, s, xt, t,
                 static_cast<const float*>(saved), bias, C, y);
  }
  return err;
}

template <typename T, int V>
int backward(const float* dy, const void* x, const Tile& t, int block_rows,
             const float* scale, const float* saved, Consts k, void* dx,
             float* dparams, float* part, float* coef, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const long long C = t.cols / t.inner;
  const dim3 grid = grid_of(t, V, block_rows);
  int err = launch(bn_grad_stats_kernel<T, V>, grid, kThreads, s, dy, xt, t,
                   saved, part);
  if (err == 0) {
    err = launch(bn_backward_final_kernel, dim3(final_blocks(t)),
                 kFinalThreads, s, static_cast<const float*>(part), block_rows,
                 t, scale, saved, k, dparams, coef);
  }
  if (err == 0) {
    err = launch(bn_grad_apply_kernel<T, V>, grid, kThreads, s, dy, xt, t,
                 saved, static_cast<const float*>(coef), C,
                 static_cast<T*>(dx));
  }
  return err;
}

}  // namespace

// B5 forward. x: [rows, C, inner] in memory, f32 (bf16 = 0) or bf16
// (bf16 = 1); vec: 16 / element size, or 1 where a row or a pointer is not
// 16-byte aligned; tc and block_rows: the wrapper's tiling. Writes y (f32,
// x's layout), the running statistics in place, part [block_rows][2][C *
// inner] (scratch) and saved [4][C].
extern "C" int gk_bn_forward(const void* x, int bf16, long long rows,
                             long long C, long long inner, int vec, int tc,
                             int block_rows, const float* scale,
                             const float* bias, float* run_mean,
                             float* run_var, float momentum, float one_minus,
                             float eps, float inv_m, float* y, float* part,
                             float* saved, void* stream) {
  if (bad_tiling(rows, C, inner, vec, tc, block_rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tile t = make_tile(rows, C, inner, tc);
  const Consts k{momentum, one_minus, eps, inv_m};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && vec == 8) {
    return forward<__nv_bfloat16, 8>(x, t, block_rows, scale, bias, run_mean,
                                     run_var, k, y, part, saved, s);
  }
  if (bf16 && vec == 1) {
    return forward<__nv_bfloat16, 1>(x, t, block_rows, scale, bias, run_mean,
                                     run_var, k, y, part, saved, s);
  }
  if (!bf16 && vec == 4) {
    return forward<float, 4>(x, t, block_rows, scale, bias, run_mean, run_var,
                             k, y, part, saved, s);
  }
  if (!bf16 && vec == 1) {
    return forward<float, 1>(x, t, block_rows, scale, bias, run_mean, run_var,
                             k, y, part, saved, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// B5 backward. dy: f32 in x's layout; saved: the forward's [4][C]. Writes
// dx (x's type and layout), dparams [2][C] (d scale, d bias), part
// [block_rows][2][C * inner] and coef [2][C] (scratch).
extern "C" int gk_bn_backward(const float* dy, const void* x, int bf16,
                              long long rows, long long C, long long inner,
                              int vec, int tc, int block_rows,
                              const float* scale, const float* saved,
                              float inv_m, void* dx, float* dparams,
                              float* part, float* coef, void* stream) {
  if (bad_tiling(rows, C, inner, vec, tc, block_rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tile t = make_tile(rows, C, inner, tc);
  const Consts k{0.0f, 0.0f, 0.0f, inv_m};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && vec == 8) {
    return backward<__nv_bfloat16, 8>(dy, x, t, block_rows, scale, saved, k,
                                      dx, dparams, part, coef, s);
  }
  if (bf16 && vec == 1) {
    return backward<__nv_bfloat16, 1>(dy, x, t, block_rows, scale, saved, k,
                                      dx, dparams, part, coef, s);
  }
  if (!bf16 && vec == 4) {
    return backward<float, 4>(dy, x, t, block_rows, scale, saved, k, dx,
                              dparams, part, coef, s);
  }
  if (!bf16 && vec == 1) {
    return backward<float, 1>(dy, x, t, block_rows, scale, saved, k, dx,
                              dparams, part, coef, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
