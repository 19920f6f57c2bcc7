// The Mamba-2 SSD chunked scan with its final state, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (_ssd_kernel).
// That kernel ran a (batch*heads, chunks) grid with the chunk axis innermost;
// TPU grid steps run in order on one core, so the (N, P) state sat in VMEM
// scratch from one chunk step to the next.  Here one thread block owns one
// (batch row, head) and the chunk axis is a loop inside it:
//
//   * the (P, N) state lives in shared memory in f32 across the loop and is
//     written out once, as h_final (B, H, P, N), after the last chunk;
//   * each chunk stages xh (Q, P), Bm and Cm (Q, N) as f32 in shared memory
//     and forms the prefix sums of the log decays;
//   * W = (C Bᵀ) ⊙ L with L[q, j] = exp(cum_q - cum_j) is formed for j <= q
//     only: above the diagonal the difference can be large and positive, and
//     exp there times a zero mask would give inf * 0 = NaN;
//   * y = W xh + exp(cum) ⊙ (C hᵀ) goes straight to y (B, S, H, P), and the
//     state becomes exp(cum_end) h + sum_j exp(cum_end - cum_j) xh_j ⊗ B_j;
//   * Bm and Cm are read at (b, s, :) with no head stride (the heads share
//     them) and may be strided along s; so may xh, la and y;
//   * positions past S read as zero input and zero log decay, so the state
//     after a ragged last chunk is the state after position S - 1, and no
//     padded copy is made;
//   * xh, Bm, Cm bf16 or f32; la f32; all sums in f32; y in xh's dtype.
//
// What bounds it: at zamba2-1.2b's prefill (B 4, S 1024, H 64, P = N = 64)
// the bytes of xh and y (about 73 MB in bf16) against about 9 GFLOP, so the
// memory; but this first version runs its products on the CUDA cores from
// shared memory, one block per (b, h) and one chunk after another, so it is
// bound by its own shared-memory traffic and the serial chunk loop, far
// from either limit.  The chunk-parallel three-pass form (chunk states in
// parallel, a short state-passing pass, then outputs), sharing C Bᵀ across
// the heads of a (b, chunk), and wgmma are later work.
//
// Plain C interface, loaded with ctypes by repro_torch/kernels/ssd_scan.py;
// the launch goes on the caller's stream and the function returns the CUDA
// error code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 128;    // longest chunk the tiles hold
constexpr int kWPitch = kMaxQ + 1;

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element strides; the P dim of xh / y and the N dim of Bm / Cm are unit.
struct Strides {
  int64_t x_b, x_s, x_h;
  int64_t l_b, l_s, l_h;
  int64_t b_b, b_s;
  int64_t c_b, c_s;
  int64_t y_b, y_s, y_h;
};

template <int P, int N>
constexpr int smem_floats() {
  return kMaxQ * P                // xh tile
         + 2 * kMaxQ * (N + 1)    // Bm and Cm tiles (odd pitch: no conflicts)
         + P * (N + 1)            // the state
         + kMaxQ * kWPitch        // W = C Bᵀ ⊙ L
         + 3 * kMaxQ;             // cum, exp(cum), exp(cum_end - cum)
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const T* __restrict__ xh, const float* __restrict__ la,
               const T* __restrict__ bm, const T* __restrict__ cm,
               const float* __restrict__ h0, T* __restrict__ y,
               float* __restrict__ h_final, Strides st, int seq, int heads,
               int chunk) {
  static_assert(P % 16 == 0 && P <= 64, "P must be 16, 32, 48 or 64");
  static_assert(N % 16 == 0 && N <= 64, "N must be 16, 32, 48 or 64");
  constexpr int kNP = N + 1;
  constexpr int kTileP = P / 16;  // y columns and state rows a thread owns
  constexpr int kTileN = N / 16;  // state columns a thread owns
  constexpr int kRows = kMaxQ / 16;  // y / W rows a thread owns

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* x_s = smem;
  float* b_s = x_s + kMaxQ * P;
  float* c_s = b_s + kMaxQ * kNP;
  float* h_s = c_s + kMaxQ * kNP;
  float* w_s = h_s + P * kNP;
  float* cum_s = w_s + kMaxQ * kWPitch;
  float* ecum_s = cum_s + kMaxQ;
  float* dte_s = ecum_s + kMaxQ;

  const int b = blockIdx.x / heads;
  const int hd = blockIdx.x % heads;
  const int tid = threadIdx.x;
  const int lo = tid % 16;  // fast index of the 16 x 16 thread grid
  const int hi = tid / 16;  // slow index

  const T* xp = xh + b * st.x_b + hd * st.x_h;
  const float* lp = la + b * st.l_b + hd * st.l_h;
  const T* bp = bm + b * st.b_b;
  const T* cp = cm + b * st.c_b;
  T* yp = y + b * st.y_b + hd * st.y_h;
  const int64_t state0 = static_cast<int64_t>(blockIdx.x) * P * N;

  for (int i = tid; i < P * N; i += kThreads) {
    h_s[(i / N) * kNP + i % N] = h0 == nullptr ? 0.f : h0[state0 + i];
  }

  for (int s0 = 0; s0 < seq; s0 += chunk) {
    // rows of this chunk that hold real positions; the rest read as zero
    const int n_rows = min(chunk, seq - s0);
    __syncthreads();  // the previous chunk is done with every tile
    for (int i = tid; i < kMaxQ * P; i += kThreads) {
      const int r = i / P;
      x_s[i] = r < n_rows ? to_float(xp[(s0 + r) * st.x_s + i % P]) : 0.f;
    }
    for (int i = tid; i < kMaxQ * N; i += kThreads) {
      const int r = i / N;
      const int n = i % N;
      const bool live = r < n_rows;
      b_s[r * kNP + n] = live ? to_float(bp[(s0 + r) * st.b_s + n]) : 0.f;
      c_s[r * kNP + n] = live ? to_float(cp[(s0 + r) * st.c_s + n]) : 0.f;
    }
    if (tid < 32) {
      // inclusive prefix sum of the log decays: 4 rows a lane, then a warp
      // scan of the lanes' totals
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = tid * 4 + k;
        run += r < n_rows ? lp[(s0 + r) * st.l_s] : 0.f;
        v[k] = run;
      }
      float offset = run;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, offset, d);
        if (tid >= d) {
          offset += up;
        }
      }
      offset -= run;  // exclusive: the sum of the lanes before this one
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        cum_s[tid * 4 + k] = v[k] + offset;
      }
      __syncwarp();
      const float cum_end = cum_s[chunk - 1];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = tid * 4 + k;
        ecum_s[r] = expf(cum_s[r]);
        dte_s[r] = expf(cum_end - cum_s[r]);
      }
    }
    __syncthreads();

    // W[q][j] = (C_q . B_j) exp(cum_q - cum_j) for j <= q, else 0.
    // Thread (hi, lo) owns rows q = hi + 16 i and columns j = lo + 16 k.
    {
      float acc[kRows][kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          acc[i][k] = 0.f;
        }
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[kRows];
        float bv[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          cv[i] = c_s[(hi + 16 * i) * kNP + n];
          bv[i] = b_s[(lo + 16 * i) * kNP + n];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            acc[i][k] = fmaf(cv[i], bv[k], acc[i][k]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int q = hi + 16 * i;
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const int j = lo + 16 * k;
          w_s[q * kWPitch + j] =
              j <= q ? acc[i][k] * expf(cum_s[q] - cum_s[j]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y[q][p] = sum_{j <= q} W[q][j] x[j][p] + exp(cum_q) sum_n C[q][n] h[p][n].
    // Thread (hi, lo) owns rows q = hi + 16 i and columns p = lo + 16 k.
    {
      float acc[kRows][kTileP];
      float off[kRows][kTileP];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int k = 0; k < kTileP; ++k) {
          acc[i][k] = 0.f;
          off[i][k] = 0.f;
        }
      }
      // W is zero above the diagonal: stop at the thread's last row
      const int j_end = min(n_rows, hi + 16 * (kRows - 1) + 1);
#pragma unroll 2
      for (int j = 0; j < j_end; ++j) {
        float wv[kRows];
        float xv[kTileP];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          wv[i] = w_s[(hi + 16 * i) * kWPitch + j];
        }
#pragma unroll
        for (int k = 0; k < kTileP; ++k) {
          xv[k] = x_s[j * P + lo + 16 * k];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
#pragma unroll
          for (int k = 0; k < kTileP; ++k) {
            acc[i][k] = fmaf(wv[i], xv[k], acc[i][k]);
          }
        }
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[kRows];
        float hv[kTileP];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          cv[i] = c_s[(hi + 16 * i) * kNP + n];
        }
#pragma unroll
        for (int k = 0; k < kTileP; ++k) {
          hv[k] = h_s[(lo + 16 * k) * kNP + n];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
#pragma unroll
          for (int k = 0; k < kTileP; ++k) {
            off[i][k] = fmaf(cv[i], hv[k], off[i][k]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int q = hi + 16 * i;
        if (q < n_rows) {
          const float e = ecum_s[q];
#pragma unroll
          for (int k = 0; k < kTileP; ++k) {
            yp[(s0 + q) * st.y_s + lo + 16 * k] =
                from_float<T>(acc[i][k] + e * off[i][k]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done reading the state

    // h[p][n] = exp(cum_end) h[p][n] + sum_j exp(cum_end - cum_j) x[j][p] B[j][n].
    // Thread (hi, lo) owns rows p = hi + 16 a and columns n = lo + 16 c.
    {
      float acc[kTileP][kTileN];
#pragma unroll
      for (int a = 0; a < kTileP; ++a) {
#pragma unroll
        for (int c = 0; c < kTileN; ++c) {
          acc[a][c] = 0.f;
        }
      }
#pragma unroll 4
      for (int j = 0; j < n_rows; ++j) {
        const float d = dte_s[j];
        float xv[kTileP];
        float bv[kTileN];
#pragma unroll
        for (int a = 0; a < kTileP; ++a) {
          xv[a] = d * x_s[j * P + hi + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < kTileN; ++c) {
          bv[c] = b_s[j * kNP + lo + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < kTileP; ++a) {
#pragma unroll
          for (int c = 0; c < kTileN; ++c) {
            acc[a][c] = fmaf(xv[a], bv[c], acc[a][c]);
          }
        }
      }
      const float decay = ecum_s[chunk - 1];
#pragma unroll
      for (int a = 0; a < kTileP; ++a) {
#pragma unroll
        for (int c = 0; c < kTileN; ++c) {
          float* h = &h_s[(hi + 16 * a) * kNP + lo + 16 * c];
          *h = *h * decay + acc[a][c];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads) {
    h_final[state0 + i] = h_s[(i / N) * kNP + i % N];
  }
}

template <typename T, int P, int N>
cudaError_t launch(const void* xh, const float* la, const void* bm,
                   const void* cm, const float* h0, void* y, float* h_final,
                   const Strides& st, int batch, int seq, int heads,
                   int chunk, cudaStream_t stream) {
  const size_t smem = smem_floats<P, N>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    return err;
  }
  ssd_kernel<T, P, N><<<batch * heads, kThreads, smem, stream>>>(
      static_cast<const T*>(xh), la, static_cast<const T*>(bm),
      static_cast<const T*>(cm), h0, static_cast<T*>(y), h_final, st, seq,
      heads, chunk);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t launch_state(const void* xh, const float* la, const void* bm,
                         const void* cm, const float* h0, void* y,
                         float* h_final, const Strides& st, int batch,
                         int seq, int heads, int state, int chunk,
                         cudaStream_t stream) {
  switch (state) {
    case 16:
      return launch<T, P, 16>(xh, la, bm, cm, h0, y, h_final, st, batch, seq,
                              heads, chunk, stream);
    case 32:
      return launch<T, P, 32>(xh, la, bm, cm, h0, y, h_final, st, batch, seq,
                              heads, chunk, stream);
    case 64:
      return launch<T, P, 64>(xh, la, bm, cm, h0, y, h_final, st, batch, seq,
                              heads, chunk, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_dims(const void* xh, const float* la, const void* bm,
                        const void* cm, const float* h0, void* y,
                        float* h_final, const Strides& st, int batch, int seq,
                        int heads, int headdim, int state, int chunk,
                        cudaStream_t stream) {
  switch (headdim) {
    case 32:
      return launch_state<T, 32>(xh, la, bm, cm, h0, y, h_final, st, batch,
                                 seq, heads, state, chunk, stream);
    case 64:
      return launch_state<T, 64>(xh, la, bm, cm, h0, y, h_final, st, batch,
                                 seq, heads, state, chunk, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// xh (B, S, H, P), la (B, S, H) f32, bm / cm (B, S, N), h0 (B, H, P, N) f32
// contiguous or null, y (B, S, H, P), h_final (B, H, P, N) f32 contiguous;
// device pointers.  strides: 13 element strides, (b, s, h) of xh, (b, s, h)
// of la, (b, s) of bm, (b, s) of cm, (b, s, h) of y; the P and N dims are
// unit.  dtype (of xh, bm, cm and y): 0 float32, 1 bfloat16.  Chunks hold
// `chunk` positions, 1 <= chunk <= 128.
extern "C" int repro_ssd_scan(const void* xh, const void* la, const void* bm,
                              const void* cm, const void* h0, void* y,
                              void* h_final, const int64_t* strides,
                              int batch, int seq, int heads, int headdim,
                              int state, int chunk, int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0) {
    return 0;
  }
  if (chunk < 1 || chunk > kMaxQ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t* s = strides;
  const Strides st{s[0], s[1], s[2],  s[3],  s[4],  s[5], s[6],
                   s[7], s[8], s[9], s[10], s[11], s[12]};
  const float* la_f = static_cast<const float*>(la);
  const float* h0_f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(h_final);
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dims<float>(xh, la_f, bm, cm, h0_f, y, hf, st, batch, seq,
                                heads, headdim, state, chunk, stream_);
    case 1:
      return launch_dims<__nv_bfloat16>(xh, la_f, bm, cm, h0_f, y, hf, st,
                                        batch, seq, heads, headdim, state,
                                        chunk, stream_);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
