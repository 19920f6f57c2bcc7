// Segmented sum / max / min over contiguous row spans, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/core/backend.py::_pallas_segment_reduce.
// That kernel walked 256-row blocks in a sequential grid, carried an
// (n_segments, C) accumulator in VMEM from step to step, and joined each
// row to its segment through a one-hot mask, O(block x n_segments x C)
// work per step.  Hopper runs blocks in parallel and in no order, so
// nothing can be carried between them.  The spans are contiguous, so here
// a thread block reduces one contiguous run of rows and there is no
// one-hot work at all:
//
//   * threads are laid out as (rows x column tile); a column tile is the
//     next power of two >= C, capped at 32, so neighbouring threads read
//     neighbouring columns of one row and the loads coalesce;
//   * each thread reduces its column over its share of the rows in a
//     register, then warp shuffles fold the rows of one warp and a small
//     shared-memory table folds the warps;
//   * the integer sums wrap like NumPy's (unsigned add), so integer results
//     are bit-identical whatever order the rows are combined in;
//   * max/min start from the type's limits, as _op_init does, and
//     propagate NaN as np.maximum / np.minimum do.
//
// What bounds it: memory.  It reads the N x C values once (N * C *
// sizeof(T) bytes) and writes n_spans x C results.  Each thread keeps
// kBatch loads in flight (loaded into registers first, then combined), so
// a block streams rather than waiting on one load at a time.
//
// One block per span put a span far longer than the rest on one SM (2^23
// of 2^24 rows: 64 MiB at ~10 GB/s while the other SMs idled).  So the
// rows are cut at every multiple of R = rows_per_piece (the cuts), and a
// span longer than R is reduced in pieces:
//
//   * block h < n_cuts is the helper of cut h + 1 (row (h + 1) R): a warp
//     search over the starts (the spans are in order) finds the span
//     holding that row past its first row; if that span is longer than R,
//     the helper reduces its rows from the cut to the next cut or the
//     span's end into partial[h], and otherwise it is idle.  The helpers
//     come first so that the longest pieces start first;
//   * block n_cuts + s owns span s: it reduces the whole span into out[s],
//     or, where the span is longer than R, its rows up to the first cut
//     above its start;
//   * a second launch, one warp a span, folds the partial rows of the cuts
//     inside each span longer than R (consecutive rows of `partial`) into
//     out[s]; the other spans' warps do nothing.
//
// A span of at most R rows is read by one block, as before, and nothing is
// planned on the host or by other launches: the pieces follow from the
// starts, the ends and R.  Where N <= R there is no cut and the second
// launch is skipped.
//
// Plain C interface, loaded with ctypes by
// repro_torch/kernels/segment_reduce.py; the launches go on the caller's
// stream and the function returns the CUDA error code (0 on success).

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

enum Op { kSum = 0, kMax = 1, kMin = 2 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxBlocks = 65535;
constexpr int kBatch = 8;  // loads in flight a thread

template <typename T>
struct Limits;
template <>
struct Limits<int32_t> {
  __device__ static int32_t lowest() { return INT32_MIN; }
  __device__ static int32_t highest() { return INT32_MAX; }
};
template <>
struct Limits<int64_t> {
  __device__ static int64_t lowest() { return INT64_MIN; }
  __device__ static int64_t highest() { return INT64_MAX; }
};
template <>
struct Limits<float> {
  __device__ static float lowest() { return -FLT_MAX; }
  __device__ static float highest() { return FLT_MAX; }
};
template <>
struct Limits<double> {
  __device__ static double lowest() { return -DBL_MAX; }
  __device__ static double highest() { return DBL_MAX; }
};

template <typename T, int OP>
__device__ __forceinline__ T init_value() {
  if constexpr (OP == kSum) {
    return T(0);
  } else if constexpr (OP == kMax) {
    return Limits<T>::lowest();
  } else {
    return Limits<T>::highest();
  }
}

template <typename T>
__device__ __forceinline__ T wrapping_add(T a, T b) {
  return a + b;
}
template <>
__device__ __forceinline__ int32_t wrapping_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
template <>
__device__ __forceinline__ int64_t wrapping_add(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) +
                              static_cast<uint64_t>(b));
}

template <typename T, int OP>
__device__ __forceinline__ T combine(T a, T b) {
  if constexpr (OP == kSum) {
    return wrapping_add(a, b);
  } else if constexpr (OP == kMax) {
    return (a > b || a != a) ? a : b;  // a != a only for a NaN
  } else {
    return (a < b || a != a) ? a : b;
  }
}

// The last s < n_spans with starts[s] < x, or -1 (starts are in order).
// Called by every lane of a warp: each round the 32 lanes probe 32 points
// of the range left and a ballot keeps the part between two of them, so
// 4096 spans take 3 rounds of one load a lane.
__device__ __forceinline__ int64_t last_below(const int64_t* __restrict__ starts,
                                              int64_t n_spans, int64_t x) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0;        // starts[i] < x for every i < lo
  int64_t hi = n_spans;  // starts[i] >= x for every i >= hi
  while (hi > lo) {
    const int64_t len = hi - lo;
    const int64_t q = len <= 32 ? lo + lane : lo + len * (lane + 1) / 33;
    const bool below = q < hi && starts[q] < x;
    const int k = __popc(__ballot_sync(0xffffffffu, below));  // a prefix
    if (len <= 32) {
      return lo + k - 1;
    }
    const int64_t q_lo = __shfl_sync(0xffffffffu, q, k > 0 ? k - 1 : 0);
    const int64_t q_hi = __shfl_sync(0xffffffffu, q, k < 32 ? k : 31);
    if (k > 0) {
      lo = q_lo + 1;
    }
    if (k < 32) {
      hi = q_hi;
    }
  }
  return lo - 1;
}

// A group of kGroup threads (the block, or one warp) reduces rows
// [lo, hi) of vals (n_cols columns) into dst[0 .. n_cols), starting from
// init[c] where init is given (it may be dst) and from the identity
// otherwise.  Threads are (rows x column tile); col_tile is a power of two
// <= 32.  Every thread of the group calls it.
template <typename T, int OP, int kGroup>
__device__ __forceinline__ void reduce_rows(const T* __restrict__ vals,
                                            int64_t lo, int64_t hi,
                                            int64_t n_cols, int col_tile,
                                            const T* init, T* dst,
                                            T (*red)[32]) {
  const int t = threadIdx.x % kGroup;
  const int lane = threadIdx.x & 31;
  const int col_in_tile = t % col_tile;
  const int64_t step = kGroup / col_tile;  // rows a pass of the group
  for (int64_t c0 = 0; c0 < n_cols; c0 += col_tile) {
    const int64_t c = c0 + col_in_tile;
    T acc = init_value<T, OP>();
    if (c < n_cols) {
      int64_t r = lo + t / col_tile;
      for (; r + (kBatch - 1) * step < hi; r += kBatch * step) {
        T x[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          x[u] = vals[(r + u * step) * n_cols + c];
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          acc = combine<T, OP>(acc, x[u]);
        }
      }
      if (r < hi) {  // under kBatch rows left: one batch, predicated
        T x[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          x[u] = r + u * step < hi ? vals[(r + u * step) * n_cols + c]
                                   : init_value<T, OP>();
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          acc = combine<T, OP>(acc, x[u]);
        }
      }
    }
    // Lanes l and l + off hold the same column when off >= col_tile.
    for (int off = 16; off >= col_tile; off >>= 1) {
      acc = combine<T, OP>(acc, __shfl_down_sync(0xffffffffu, acc, off));
    }
    if constexpr (kGroup == 32) {
      if (lane < col_tile && c < n_cols) {
        dst[c] = init == nullptr ? acc : combine<T, OP>(init[c], acc);
      }
    } else {
      if (lane < col_tile) {
        red[t >> 5][lane] = acc;
      }
      __syncthreads();
      if (t < col_tile && c < n_cols) {
        T v = red[0][t];
        for (int w = 1; w < kGroup / 32; ++w) {
          v = combine<T, OP>(v, red[w][t]);
        }
        dst[c] = init == nullptr ? v : combine<T, OP>(init[c], v);
      }
      __syncthreads();
    }
  }
}

// Blocks [0, n_cuts): the piece of cut h + 1 into partial[h] where that cut
// lies inside a span longer than R (above); they come first, so the
// longest pieces start first.  Blocks n_cuts + s: span s, up to the first
// cut above its start where it is longer than R, into out[s].  Grid-stride
// over the blocks.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    span_kernel(const T* __restrict__ vals, const int64_t* __restrict__ starts,
                const int64_t* __restrict__ ends, T* __restrict__ out,
                T* __restrict__ partial, int64_t n_spans, int64_t n_cuts,
                int64_t n_cols, int64_t rows, int col_tile) {
  __shared__ T red[kWarps][32];
  for (int64_t b = blockIdx.x; b < n_spans + n_cuts; b += gridDim.x) {
    if (b < n_cuts) {
      const int64_t x = (b + 1) * rows;
      const int64_t s = last_below(starts, n_spans, x);  // each warp alike
      if (s < 0 || ends[s] <= x || ends[s] - starts[s] <= rows) {
        continue;  // no span holds the cut past its first row, or its span
                   // is short and its owner reads it whole
      }
      const int64_t hi = x + rows < ends[s] ? x + rows : ends[s];
      reduce_rows<T, OP, kThreads>(vals, x, hi, n_cols, col_tile, nullptr,
                                   partial + b * n_cols, red);
    } else {
      const int64_t s = b - n_cuts;
      const int64_t lo = starts[s];
      int64_t hi = ends[s];
      if (hi - lo > rows) {
        hi = (lo / rows + 1) * rows;  // the first cut above lo
      }
      reduce_rows<T, OP, kThreads>(vals, lo, hi, n_cols, col_tile, nullptr,
                                   out + s * n_cols, red);
    }
  }
}

// One warp a span.  A span longer than R holds cuts first .. last (first =
// its start / R + 1): out[s] holds its rows up to cut `first` and
// partial[e - 1] those from cut e, so the warp folds partial rows
// first - 1 .. last - 1 into out[s].  Other spans are done.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const int64_t* __restrict__ starts,
                   const int64_t* __restrict__ ends, T* __restrict__ out,
                   const T* __restrict__ partial, int64_t n_spans,
                   int64_t n_cols, int64_t rows, int col_tile) {
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t s = blockIdx.x * kWarps + (threadIdx.x >> 5); s < n_spans;
       s += warps) {
    const int64_t lo = starts[s];
    const int64_t hi = ends[s];
    if (hi - lo > rows) {
      reduce_rows<T, OP, 32>(partial, lo / rows, (hi - 1) / rows, n_cols,
                             col_tile, out + s * n_cols, out + s * n_cols,
                             nullptr);
    }
  }
}

template <typename T, int OP>
cudaError_t launch_op(const T* vals, const int64_t* starts, const int64_t* ends,
                      T* out, T* partial, int64_t n_spans, int64_t n_cuts,
                      int64_t n_cols, int64_t rows, int col_tile,
                      cudaStream_t stream) {
  const int64_t blocks = n_spans + n_cuts;
  span_kernel<T, OP><<<static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks),
                       kThreads, 0, stream>>>(vals, starts, ends, out, partial,
                                              n_spans, n_cuts, n_cols, rows,
                                              col_tile);
  if (n_cuts > 0) {
    const int64_t warp_blocks = (n_spans + kWarps - 1) / kWarps;
    combine_kernel<T, OP>
        <<<static_cast<unsigned>(warp_blocks < kMaxBlocks ? warp_blocks : kMaxBlocks),
           kThreads, 0, stream>>>(starts, ends, out, partial, n_spans, n_cols,
                                  rows, col_tile);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* vals, const int64_t* starts,
                         const int64_t* ends, void* out, void* partial,
                         int64_t n_spans, int64_t n_cuts, int64_t n_cols,
                         int64_t rows, int op, cudaStream_t stream) {
  int col_tile = 1;
  while (col_tile < n_cols && col_tile < 32) {
    col_tile <<= 1;
  }
  const T* v = static_cast<const T*>(vals);
  T* o = static_cast<T*>(out);
  T* p = static_cast<T*>(partial);
  switch (op) {
    case kSum:
      return launch_op<T, kSum>(v, starts, ends, o, p, n_spans, n_cuts, n_cols,
                                rows, col_tile, stream);
    case kMax:
      return launch_op<T, kMax>(v, starts, ends, o, p, n_spans, n_cuts, n_cols,
                                rows, col_tile, stream);
    case kMin:
      return launch_op<T, kMin>(v, starts, ends, o, p, n_spans, n_cuts, n_cols,
                                rows, col_tile, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 int32, 1 int64, 2 float32, 3 float64.  op: 0 sum, 1 max, 2 min.
// vals is (N, n_cols) row-major; span s covers rows [starts[s], ends[s]),
// and the spans are in order (0 <= starts[s] <= ends[s] <= starts[s + 1],
// ends[-1] <= N).  out is (n_spans, n_cols).  rows is R, the rows between
// cuts; n_cuts = ceil(N / R) - 1 cuts (0 where N <= R), and partial is
// (n_cuts, n_cols) scratch (not read where n_cuts is 0).  All pointers are
// device pointers.
extern "C" int repro_segment_reduce(const void* vals, const void* starts,
                                    const void* ends, void* out, void* partial,
                                    int64_t n_spans, int64_t n_cuts,
                                    int64_t n_cols, int64_t rows, int dtype,
                                    int op, void* stream) {
  if (n_spans <= 0 || n_cols <= 0) {
    return 0;
  }
  if (rows <= 0 || n_cuts < 0 || (n_cuts > 0 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t* s = static_cast<const int64_t*>(starts);
  const int64_t* e = static_cast<const int64_t*>(ends);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_typed<int32_t>(vals, s, e, out, partial, n_spans, n_cuts,
                                   n_cols, rows, op, st);
    case 1:
      return launch_typed<int64_t>(vals, s, e, out, partial, n_spans, n_cuts,
                                   n_cols, rows, op, st);
    case 2:
      return launch_typed<float>(vals, s, e, out, partial, n_spans, n_cuts,
                                 n_cols, rows, op, st);
    case 3:
      return launch_typed<double>(vals, s, e, out, partial, n_spans, n_cuts,
                                  n_cols, rows, op, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
