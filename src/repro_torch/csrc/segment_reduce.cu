// Segmented sum / max / min over contiguous row spans, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/core/backend.py::_pallas_segment_reduce.
// That kernel walked 256-row blocks in a sequential grid, carried an
// (n_segments, C) accumulator in VMEM from step to step, and joined each
// row to its segment through a one-hot mask, O(block x n_segments x C)
// work per step.  Hopper runs blocks in parallel and in no order, so
// nothing can be carried between them.  The spans are contiguous and their
// starts and ends are known on the host (segment_spans), so here one thread
// block owns one span (grid-stride over spans) and there is no one-hot
// work at all:
//
//   * threads are laid out as (rows x column tile); a column tile is the
//     next power of two >= C, capped at 32, so neighbouring threads read
//     neighbouring columns of one row and the loads coalesce;
//   * each thread reduces its column over its share of the span's rows in
//     a register, then warp shuffles fold the rows of one warp and a small
//     shared-memory table folds the warps;
//   * the int64 sum wraps exactly like NumPy's (unsigned add), so integer
//     results are bit-identical whatever order the rows are combined in;
//   * max/min start from the type's limits, as _op_init does, and
//     propagate NaN as np.maximum / np.minimum do.
//
// The kernel is bound by memory: it reads the N x C values once
// (N * C * sizeof(T) bytes) and writes n_spans x C results.  Its known
// weakness: a span far longer than the rest leaves one block, on one SM,
// doing most of the work while the others idle.  Splitting long spans
// across blocks (a second pass over per-chunk partials) is later work.
//
// Plain C interface, loaded with ctypes by
// repro_torch/kernels/segment_reduce.py; the launch goes on the caller's
// stream and the function returns the CUDA error code (0 on success).

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

enum Op { kSum = 0, kMax = 1, kMin = 2 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxBlocks = 65535;

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

// One block per span (grid-stride).  col_tile is a power of two <= 32.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    segment_reduce_kernel(const T* __restrict__ vals,
                          const int64_t* __restrict__ starts,
                          const int64_t* __restrict__ ends,
                          T* __restrict__ out, int64_t n_spans,
                          int64_t n_cols, int col_tile) {
  __shared__ T partial[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col_in_tile = threadIdx.x % col_tile;
  const int row_lane = threadIdx.x / col_tile;
  const int rows_per_pass = kThreads / col_tile;

  for (int64_t s = blockIdx.x; s < n_spans; s += gridDim.x) {
    const int64_t lo = starts[s];
    const int64_t hi = ends[s];
    for (int64_t c0 = 0; c0 < n_cols; c0 += col_tile) {
      const int64_t c = c0 + col_in_tile;
      T acc = init_value<T, OP>();
      if (c < n_cols) {
#pragma unroll 4
        for (int64_t r = lo + row_lane; r < hi; r += rows_per_pass) {
          acc = combine<T, OP>(acc, vals[r * n_cols + c]);
        }
      }
      // Lanes l and l + off hold the same column when off >= col_tile.
      for (int off = 16; off >= col_tile; off >>= 1) {
        acc = combine<T, OP>(acc, __shfl_down_sync(0xffffffffu, acc, off));
      }
      if (lane < col_tile) {
        partial[warp][lane] = acc;
      }
      __syncthreads();
      if (threadIdx.x < col_tile && c < n_cols) {
        T v = partial[0][threadIdx.x];
        for (int w = 1; w < kWarps; ++w) {
          v = combine<T, OP>(v, partial[w][threadIdx.x]);
        }
        out[s * n_cols + c] = v;
      }
      __syncthreads();
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* vals, const int64_t* starts,
                         const int64_t* ends, void* out, int64_t n_spans,
                         int64_t n_cols, int op, cudaStream_t stream) {
  int col_tile = 1;
  while (col_tile < n_cols && col_tile < 32) {
    col_tile <<= 1;
  }
  const dim3 grid(static_cast<unsigned>(n_spans < kMaxBlocks ? n_spans
                                                               : kMaxBlocks));
  const dim3 block(kThreads);
  const T* v = static_cast<const T*>(vals);
  T* o = static_cast<T*>(out);
  switch (op) {
    case kSum:
      segment_reduce_kernel<T, kSum><<<grid, block, 0, stream>>>(
          v, starts, ends, o, n_spans, n_cols, col_tile);
      break;
    case kMax:
      segment_reduce_kernel<T, kMax><<<grid, block, 0, stream>>>(
          v, starts, ends, o, n_spans, n_cols, col_tile);
      break;
    case kMin:
      segment_reduce_kernel<T, kMin><<<grid, block, 0, stream>>>(
          v, starts, ends, o, n_spans, n_cols, col_tile);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 int32, 1 int64, 2 float32, 3 float64.  op: 0 sum, 1 max, 2 min.
// vals is (N, n_cols) row-major; span s covers rows [starts[s], ends[s]);
// out is (n_spans, n_cols) row-major.  All pointers are device pointers.
extern "C" int repro_segment_reduce(const void* vals, const void* starts,
                                    const void* ends, void* out,
                                    int64_t n_spans, int64_t n_cols, int dtype,
                                    int op, void* stream) {
  if (n_spans <= 0 || n_cols <= 0) {
    return 0;
  }
  const int64_t* s = static_cast<const int64_t*>(starts);
  const int64_t* e = static_cast<const int64_t*>(ends);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_typed<int32_t>(vals, s, e, out, n_spans, n_cols, op, st);
    case 1:
      return launch_typed<int64_t>(vals, s, e, out, n_spans, n_cols, op, st);
    case 2:
      return launch_typed<float>(vals, s, e, out, n_spans, n_cols, op, st);
    case 3:
      return launch_typed<double>(vals, s, e, out, n_spans, n_cols, op, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
