// The xLSTM mLSTM chunked scan with its final state, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mlstm_scan.py::mlstm_scan
// (_mlstm_kernel).  That kernel ran a (batch*heads, chunks) grid with the
// chunk axis innermost and carried the stabilised state (C~ D x D, n~ D, m)
// in VMEM from one chunk step to the next; it returned h only.  At
// xlstm-1.3b's head dim of 1024, C~ is 4 MiB of f32 per (b, h), about 18
// times one SM's shared memory, and one block per (b, h) would give 16
// blocks for 132 SMs.  So the state is tiled across blocks, and one call
// runs three kernels on the caller's stream:
//
//   1. gate_kernel, one warp per (b, h), chunks in order: the prefix sum
//      cumF of the log forget gates, u = li - cumF, the stabiliser
//      g = max(m_prev, cummax(u)) and the m entering each chunk,
//      m_next = cumF[Q-1] + g[Q-1].  They depend on the gates only, so every
//      exponent of the later passes is known before any D-sized work.
//   2. w_kernel, one block per (chunk, b, h):
//      W[q][j] = (q_q . k_j) exp(u_j - g_q) for j <= q, else 0, and the row
//      sums of W.  The exponent is formed on the lower triangle only: above
//      it u_j - g_q may be large and positive.
//   3. state_kernel, one block per (32 value columns of C~, b, h).  The
//      block keeps its D x 32 slab of C~ and its own copy of n~ in shared
//      memory across the chunk loop; per chunk
//        h[:, slab] = (W v[:, slab] + e^{m_prev - g} (q C~[:, slab]))
//                     / max(|rowsum W + e^{m_prev - g} (q . n~)|, e^{-(cumF + g)})
//        C~[:, slab] = e^{m_prev - g_Q} C~[:, slab] + (k e^{u - g_Q})^T v[:, slab]
//      and n~ the same on k.  The two D^2 products split by value columns
//      with no work repeated; only the D-long q . n~ and n~ update and the
//      Q-long scalars are repeated per slab.  The products run on the
//      tensor cores (mma.sync, TF32) with every f32 operand split into two
//      TF32 parts, so they keep about f32 accuracy; q, k and v stream
//      through shared memory in 128 x 64 tiles, loaded as 16-byte vectors
//      one tile ahead.  At the end the block writes its 32 columns of the
//      final C~; the first slab writes n~.
//
// Positions past S read as the JAX code's padding (f = 1, i = 0: lf = 0,
// li = -1e30, zero q, k, v), so the final m is the value after a padded
// tail, as _chunked_mlstm returns it.  m starts at -1e30, a finite
// sentinel: exp(-1e30 - x) is a clean 0 where -inf - (-inf) would be NaN.
// Exponents use expf, not __expf: exp(-(cumF + g)) overflows to inf for
// cumF + g < -88, and h is then 0, as in the oracle.
//
// What bounds it: at xlstm-1.3b's prefill (B 4, S 1024, H 4, D 1024,
// chunks of 128, bf16) the two D^2 products are ~94% of 73 GFLOP, which
// at the bf16 tensor-core rate is 0.074 ms, just above the 0.070 ms the
// 235 MB of q, k, v, h and the final C~ need; so the operations.  This
// version is far from both: its 512 state blocks of 189 KB (one per SM,
// ~4 waves) walk their chunks in order with a shared-memory round trip and
// two barriers per 64-wide tile, the split doubles (f32 inputs: triples)
// the tensor-core work, mma.sync reaches a fraction of wgmma's rate, and
// the W pass runs on the CUDA cores.  wgmma with TMA-fed tiles, bf16 parts
// instead of TF32, and the chunk-parallel form (chunk states in parallel,
// then a short pass over chunks) are later work.
//
// Plain C interface, loaded with ctypes by repro_torch/kernels/mlstm_scan.py;
// the function returns the CUDA error code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's finite -inf
constexpr int kThreads = 256;
constexpr int kMaxQ = 128;     // longest chunk the tiles hold
constexpr int kEv = 32;        // value columns of C~ per state block
constexpr int kDt = 64;        // head-dim tile of the state pass
constexpr int kWDt = 32;       // head-dim tile of the W pass
constexpr int kWPitch = kWDt + 1;

// q, k and v are read as 16-byte vectors: 8 bf16 or 4 f32.  The wrapper
// hands over rows that are 16-byte aligned (a unit D stride and the other
// strides multiples of the vector).
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  using type = uint4;
  static constexpr int n = 8;
};

__device__ __forceinline__ void unpack(const float4& v, float (&f)[4]) {
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of an f32
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// A kRowsT x kColsT tile of a row-major source, held in registers as
// vectors: vector i of thread t covers row (t + i kBlock) / (kColsT / n)
// and n columns from n ((t + i kBlock) % (kColsT / n)).  All of a
// thread's loads are issued before any is used.
template <typename T, int kRowsT, int kColsT, int kBlock>
struct Tile {
  using V = typename Vec<T>::type;
  static constexpr int kN = Vec<T>::n;
  static constexpr int kPerRow = kColsT / kN;
  static constexpr int kPer = kRowsT * kPerRow / kBlock;
  V v[kPer];

  __device__ __forceinline__ static int row(int i) {
    return (static_cast<int>(threadIdx.x) + i * kBlock) / kPerRow;
  }
  __device__ __forceinline__ static int col(int i) {
    return (static_cast<int>(threadIdx.x) + i * kBlock) % kPerRow * kN;
  }
  // rows [0, n_rows) and columns [0, n_cols) of src; zero elsewhere
  __device__ __forceinline__ void fetch(const T* src, int64_t stride,
                                        int n_rows, int n_cols) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      v[i] = row(i) < n_rows && col(i) < n_cols
                 ? *reinterpret_cast<const V*>(src + row(i) * stride + col(i))
                 : V{};
    }
  }
  // f(row, column, value) for every element the thread holds
  template <class F>
  __device__ __forceinline__ void each(F&& f) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      float x[kN];
      unpack(v[i], x);
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        f(row(i), col(i) + e, x[e]);
      }
    }
  }
};

// Element strides of q, k, v (b, s, h; D is unit) and of lf, li (b, s, h).
struct Strides {
  int64_t q_b, q_s, q_h;
  int64_t k_b, k_s, k_h;
  int64_t v_b, v_s, v_h;
  int64_t f_b, f_s, f_h;
  int64_t i_b, i_s, i_h;
};

// The scratch `gates` holds four (B*H, Sp) planes: cumF, u, g, rowsum W.
struct Planes {
  const float* cum;
  const float* u;
  const float* g;
  float* rsum;
};

__device__ __forceinline__ Planes planes(float* gates, int bh, int64_t sp,
                                         int64_t plane) {
  float* base = gates + bh * sp;
  return {base, base + plane, base + 2 * plane, base + 3 * plane};
}

// 1. The gate pass: one warp per (b, h); lane l holds rows 4l .. 4l + 3.
__global__ void __launch_bounds__(32)
    gate_kernel(const float* __restrict__ lf, const float* __restrict__ li,
                const float* __restrict__ m0, float* __restrict__ gates,
                float* __restrict__ m_in, float* __restrict__ m_out,
                Strides st, int heads, int seq, int chunk, int n_chunks) {
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int hd = bh % heads;
  const int lane = threadIdx.x;
  const int64_t sp = static_cast<int64_t>(n_chunks) * chunk;
  const int64_t plane = static_cast<int64_t>(gridDim.x) * sp;
  float* cum_p = gates + bh * sp;
  float* u_p = cum_p + plane;
  float* g_p = u_p + plane;
  const float* fp = lf + b * st.f_b + hd * st.f_h;
  const float* ip = li + b * st.i_b + hd * st.i_h;
  float m = m0 == nullptr ? kNegInf : m0[bh];
  const int last = chunk - 1;
  for (int c = 0; c < n_chunks; ++c) {
    const int s0 = c * chunk;
    float cum[4], u[4], cmax[4];
    float run = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = lane * 4 + k;
      const bool live = r < chunk && s0 + r < seq;
      run += live ? fp[(s0 + r) * st.f_s] : 0.f;
      cum[k] = run;
      u[k] = live ? ip[(s0 + r) * st.i_s] : kNegInf;
    }
    // exclusive prefix of the lanes' sums
    float offset = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, offset, d);
      if (lane >= d) {
        offset += up;
      }
    }
    offset -= run;
    float mx = kNegInf;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      cum[k] += offset;
      u[k] -= cum[k];
      mx = fmaxf(mx, u[k]);
      cmax[k] = mx;
    }
    // exclusive running max over the lanes before this one
    float scan = mx;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, scan, d);
      if (lane >= d) {
        scan = fmaxf(scan, up);
      }
    }
    float before = __shfl_up_sync(0xffffffffu, scan, 1);
    if (lane == 0) {
      before = kNegInf;
    }
    float cum_last = 0.f;
    float g_last = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = lane * 4 + k;
      const float g = fmaxf(m, fmaxf(before, cmax[k]));
      if (r < chunk) {
        cum_p[s0 + r] = cum[k];
        u_p[s0 + r] = u[k];
        g_p[s0 + r] = g;
      }
      if (r == last) {
        cum_last = cum[k];
        g_last = g;
      }
    }
    cum_last = __shfl_sync(0xffffffffu, cum_last, last / 4);
    g_last = __shfl_sync(0xffffffffu, g_last, last / 4);
    if (lane == 0) {
      m_in[bh * n_chunks + c] = m;
    }
    m = cum_last + g_last;
  }
  if (lane == 0) {
    m_out[bh] = m;
  }
}

// 2. The W pass: one block per (chunk, b, h).  Thread (hi, lo) of a
// 16 x 16 grid owns rows q = hi + 16 i and columns j = lo + 16 k.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    w_kernel(const T* __restrict__ q, const T* __restrict__ k,
             float* __restrict__ gates, float* __restrict__ w, Strides st,
             int heads, int seq, int dim, int chunk, int n_chunks) {
  constexpr int kRows = kMaxQ / 16;
  __shared__ float q_s[kMaxQ * kWPitch];
  __shared__ float k_s[kMaxQ * kWPitch];
  __shared__ float u_s[kMaxQ];
  __shared__ float g_s[kMaxQ];

  const int c = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int hd = bh % heads;
  const int tid = threadIdx.x;
  const int lo = tid % 16;
  const int hi = tid / 16;
  const int s0 = c * chunk;
  const int n_rows = min(chunk, seq - s0);
  const int64_t sp = static_cast<int64_t>(n_chunks) * chunk;
  const Planes pl = planes(gates, bh, sp, static_cast<int64_t>(gridDim.y) * sp);
  for (int i = tid; i < kMaxQ; i += kThreads) {
    u_s[i] = i < chunk ? pl.u[s0 + i] : 0.f;
    g_s[i] = i < chunk ? pl.g[s0 + i] : 0.f;
  }
  const T* qp = q + b * st.q_b + hd * st.q_h + s0 * st.q_s;
  const T* kp = k + b * st.k_b + hd * st.k_h + s0 * st.k_s;

  float acc[kRows][kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      acc[i][j] = 0.f;
    }
  }
  for (int d0 = 0; d0 < dim; d0 += kWDt) {
    __syncthreads();  // the previous tile is read
    Tile<T, kMaxQ, kWDt, kThreads> qt;
    Tile<T, kMaxQ, kWDt, kThreads> kt;
    qt.fetch(qp + d0, st.q_s, n_rows, kWDt);
    kt.fetch(kp + d0, st.k_s, n_rows, kWDt);
    qt.each([&](int r, int dd, float x) { q_s[r * kWPitch + dd] = x; });
    kt.each([&](int r, int dd, float x) { k_s[r * kWPitch + dd] = x; });
    __syncthreads();
#pragma unroll 4
    for (int dd = 0; dd < kWDt; ++dd) {
      float qv[kRows];
      float kv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = q_s[(hi + 16 * i) * kWPitch + dd];
        kv[i] = k_s[(lo + 16 * i) * kWPitch + dd];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
        }
      }
    }
  }
  float* wp = w + (static_cast<int64_t>(bh) * n_chunks + c) * chunk * chunk;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = hi + 16 * i;
    float rsum = 0.f;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int col = lo + 16 * j;
      float val = 0.f;
      if (row < chunk && col <= row) {
        val = acc[i][j] * expf(u_s[col] - g_s[row]);
      }
      if (row < chunk && col < chunk) {
        wp[row * chunk + col] = val;
      }
      rsum += val;
    }
    // the 16 lanes that share `hi` hold the row's 128 columns
#pragma unroll
    for (int d = 1; d < 16; d <<= 1) {
      rsum += __shfl_xor_sync(0xffffffffu, rsum, d);
    }
    if (lo == 0 && row < chunk) {
      pl.rsum[s0 + row] = rsum;
    }
  }
}

// The tensor-core steps of the state pass.  A product of f32 operands runs
// as split TF32: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), and
// a b = a_hi b_hi + a_hi b_lo + a_lo b_hi, each term on the tensor cores
// with an f32 sum, which keeps about 21 bits of each operand.  An operand
// that is exact in TF32 (bf16 q, k, v widened to f32) is not split.  The
// rounding to TF32 (nearest, ties away from zero, as cvt.rna) is done with
// integer operations, which issue at the full rate of the ALUs.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// d += a b for one 16 x 8 x 8 tile (mma.sync m16n8k8, TF32 in, f32 out).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int N, bool kSplit>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (kSplit) {
      hi[i] = tf32_bits(x[i]);
      lo[i] = tf32_bits(x[i] - __uint_as_float(hi[i]));
    } else {
      hi[i] = __float_as_uint(x[i]);
      lo[i] = 0u;
    }
  }
}

// d += a b, a (16 x 8) and b (8 x 8) in mma.sync's fragment layout.
template <bool kSplitA, bool kSplitB>
__device__ __forceinline__ void mma_f32(float (&d)[4], const float (&a)[4],
                                        const float (&b)[2]) {
  uint32_t ah[4], al[4], bh[2], bl[2];
  split<4, kSplitA>(a, ah, al);
  split<2, kSplitB>(b, bh, bl);
  if (kSplitB) {
    mma_tf32(d, ah, bl);  // the small terms first
  }
  if (kSplitA) {
    mma_tf32(d, al, bh);
  }
  mma_tf32(d, ah, bh);
}

constexpr int kXPitch = kDt + 4;     // q and W tiles, [row][col]
constexpr int kKPitch = kMaxQ + 4;   // k * wgt tiles, transposed: [d][j]
constexpr int kVPitch = kEv + 8;     // the slab of v, [j][e]
constexpr int kXFloats = kMaxQ * kXPitch > kDt * kKPitch ? kMaxQ * kXPitch
                                                         : kDt * kKPitch;
constexpr int kSThreads = 512;  // threads of a state block: 16 warps
constexpr int kStage = kMaxQ * kDt / kSThreads;  // W tile elements a thread loads

// The slab of C~ is D x 32, its columns swizzled by row so that the 4 rows
// x 8 columns a warp reads for one fragment fall in 32 distinct banks.
__device__ __forceinline__ int cswz(int d, int e) {
  return d * kEv + (e ^ ((d & 3) << 3));
}

__host__ __device__ constexpr int state_smem_floats(int dim) {
  return dim * kEv          // the slab of C~
         + dim              // n~
         + kMaxQ * kVPitch  // the slab of v
         + kXFloats         // a tile of q, W or k * wgt
         + 5 * kMaxQ;       // carry, floor, wgt, rowsum W, q . n~
}

// 3. The state pass: one block per (slab of 32 value columns, b, h), 16
// warps.  For h, warp w owns rows 16 (w % 8) .. + 15 of the chunk and
// columns 16 (w / 8) .. + 15 of the slab (two 16 x 8 tiles); the warps of
// the first 16 columns also form a tile whose first column is q . n~.  For
// the update of a 64-row tile of C~, warp w owns rows 16 (w % 4) .. + 15
// and columns 8 (w / 4) .. + 7.  Tiles of the head dim are staged through
// registers: the next tile's loads are in flight while the tensor cores
// work on the current one.
template <typename T>
__global__ void __launch_bounds__(kSThreads)
    state_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ c0,
                 const float* __restrict__ n0, float* __restrict__ gates,
                 const float* __restrict__ m_in, const float* __restrict__ w,
                 float* __restrict__ out, float* __restrict__ c_out,
                 float* __restrict__ n_out, Strides st, int heads, int seq,
                 int dim, int chunk, int n_chunks) {
  // bf16 inputs are exact in TF32; f32 inputs are split like the state
  constexpr bool kSplitIn = !std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* c_s = smem;
  float* n_s = c_s + dim * kEv;
  float* v_s = n_s + dim;
  float* x_s = v_s + kMaxQ * kVPitch;
  float* carry_s = x_s + kXFloats;
  float* floor_s = carry_s + kMaxQ;
  float* wgt_s = floor_s + kMaxQ;
  float* rsum_s = wgt_s + kMaxQ;
  float* qn_s = rsum_s + kMaxQ;
  __shared__ float decay_s;

  const int e0 = blockIdx.x * kEv;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int hd = bh % heads;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int gid = (tid % 32) / 4;  // the fragment's row (and B's column)
  const int tig = tid % 4;         // the fragment's column (and B's row)
  const int r0 = 16 * (warp % 8);  // this warp's rows of h
  const int ht = 2 * (warp / 8);    // and its first column tile
  const int64_t sp = static_cast<int64_t>(n_chunks) * chunk;
  const Planes pl = planes(gates, bh, sp, static_cast<int64_t>(gridDim.y) * sp);
  const int64_t state0 = static_cast<int64_t>(bh) * dim * dim;
  const T* qp = q + b * st.q_b + hd * st.q_h;
  const T* kp = k + b * st.k_b + hd * st.k_h;
  const T* vp = v + b * st.v_b + hd * st.v_h + e0;
  const int64_t out_s = static_cast<int64_t>(heads) * dim;  // row stride of h
  float* op = out + static_cast<int64_t>(b) * seq * out_s + hd * dim + e0;
  // a thread loads column `sd` of rows sr + 8 i of a 128 x 64 tile of W
  const int sd = tid % kDt;
  const int sr = tid / kDt;

  // the initial slab, 16 loads a thread in flight at a time
  for (int base = 0; base < dim * kEv; base += 16 * kSThreads) {
    float t[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int i = base + u * kSThreads + tid;
      t[u] = c0 != nullptr && i < dim * kEv
                 ? c0[state0 + static_cast<int64_t>(i / kEv) * dim + e0 + i % kEv]
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int i = base + u * kSThreads + tid;
      if (i < dim * kEv) {
        c_s[cswz(i / kEv, i % kEv)] = t[u];
      }
    }
  }
  for (int i = tid; i < dim; i += kSThreads) {
    n_s[i] = n0 == nullptr ? 0.f : n0[static_cast<int64_t>(bh) * dim + i];
  }

  Tile<T, kMaxQ, kDt, kSThreads> stage;  // the next tile of q or k

  for (int c = 0; c < n_chunks; ++c) {
    const int s0 = c * chunk;
    const int n_rows = min(chunk, seq - s0);
    const int k_end = (n_rows + 7) & ~7;  // rows of the chunk, to whole k-steps
    __syncthreads();  // the previous chunk is done with every tile
    stage.fetch(qp + s0 * st.q_s, st.q_s, n_rows, min(kDt, dim));
    if (tid < kMaxQ) {
      const float mp = m_in[bh * n_chunks + c];
      const float gq = pl.g[s0 + chunk - 1];
      const int r = tid;
      if (r < chunk) {
        const float g = pl.g[s0 + r];
        carry_s[r] = expf(mp - g);
        floor_s[r] = expf(-(pl.cum[s0 + r] + g));
        wgt_s[r] = expf(pl.u[s0 + r] - gq);
        rsum_s[r] = pl.rsum[s0 + r];
      } else {
        carry_s[r] = 0.f;
        floor_s[r] = 1.f;
        wgt_s[r] = 0.f;
        rsum_s[r] = 0.f;
      }
      if (r == 0) {
        decay_s = expf(mp - gq);
      }
    }
    {
      Tile<T, kMaxQ, kEv, kSThreads> vt;
      vt.fetch(vp + s0 * st.v_s, st.v_s, n_rows, kEv);
      vt.each([&](int r, int e, float x) { v_s[r * kVPitch + e] = x; });
    }

    // q C~[:, slab] and q . n~, over tiles of the head dim
    float acc[2][4];
    float qn[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[t][i] = 0.f;
      }
    }
    for (int d0 = 0; d0 < dim; d0 += kDt) {
      const int tw = min(kDt, dim - d0);
      __syncthreads();  // x_s is free
      stage.each([&](int r, int dd, float x) { x_s[r * kXPitch + dd] = x; });
      __syncthreads();
      if (d0 + kDt < dim) {
        stage.fetch(qp + s0 * st.q_s + d0 + kDt, st.q_s, n_rows,
                    min(kDt, dim - d0 - kDt));
      }
      if (r0 < n_rows) {
        for (int kk = 0; kk < tw; kk += 8) {
          const float* xa = x_s + (r0 + gid) * kXPitch + kk + tig;
          const float a[4] = {xa[0], xa[8 * kXPitch], xa[4], xa[8 * kXPitch + 4]};
          const int d = d0 + kk + tig;
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const float bv[2] = {c_s[cswz(d, 8 * (ht + t) + gid)],
                                 c_s[cswz(d + 4, 8 * (ht + t) + gid)]};
            mma_f32<kSplitIn, true>(acc[t], a, bv);
          }
          if (ht == 0) {
            const float bn[2] = {gid == 0 ? n_s[d] : 0.f,
                                 gid == 0 ? n_s[d + 4] : 0.f};
            mma_f32<kSplitIn, true>(qn, a, bn);
          }
        }
      }
    }
    if (ht == 0 && tig == 0) {
      qn_s[r0 + gid] = qn[0];
      qn_s[r0 + gid + 8] = qn[2];
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      acc[t][0] *= carry_s[r0 + gid];
      acc[t][1] *= carry_s[r0 + gid];
      acc[t][2] *= carry_s[r0 + gid + 8];
      acc[t][3] *= carry_s[r0 + gid + 8];
    }

    // + W v[:, slab], over tiles of W's columns; W is zero above the
    // diagonal, so warp w stops at column r0 + 15
    const float* wp = w + (static_cast<int64_t>(bh) * n_chunks + c) * chunk * chunk;
    for (int j0 = 0; j0 < n_rows; j0 += kDt) {
      float wt[kStage];
#pragma unroll
      for (int i = 0; i < kStage; ++i) {
        const int r = sr + (kSThreads / kDt) * i;
        wt[i] = r < n_rows && j0 + sd < n_rows ? wp[r * chunk + j0 + sd] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kStage; ++i) {
        x_s[(sr + (kSThreads / kDt) * i) * kXPitch + sd] = wt[i];
      }
      __syncthreads();
      const int kk_end = min(min(kDt, k_end - j0), r0 + 16 - j0);
      for (int kk = 0; kk < kk_end; kk += 8) {
        const float* xa = x_s + (r0 + gid) * kXPitch + kk + tig;
        const float a[4] = {xa[0], xa[8 * kXPitch], xa[4], xa[8 * kXPitch + 4]};
        const float* vb = v_s + (j0 + kk + tig) * kVPitch + 8 * ht + gid;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const float bv[2] = {vb[8 * t], vb[4 * kVPitch + 8 * t]};
          mma_f32<true, kSplitIn>(acc[t], a, bv);
        }
      }
    }
    __syncthreads();  // qn_s is written
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + gid + 8 * half;
      if (r < n_rows) {
        // the combined (intra-chunk + carry) normaliser, then its floor
        const float den =
            fmaxf(fabsf(rsum_s[r] + carry_s[r] * qn_s[r]), floor_s[r]);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          float* o = op + (s0 + r) * out_s + 8 * (ht + t) + 2 * tig;
          o[0] = acc[t][2 * half] / den;
          o[1] = acc[t][2 * half + 1] / den;
        }
      }
    }

    // C~[:, slab] and n~ to the chunk's end, over 64-row tiles of the head
    // dim: C~ <- decay C~ + (k * wgt)^T v, n~ <- decay n~ + (k * wgt)^T 1
    const float decay = decay_s;
    const int um = 16 * (warp % 4);  // this warp's rows of the tile
    const int ut = warp / 4;         // and its column tile
    stage.fetch(kp + s0 * st.k_s, st.k_s, n_rows, min(kDt, dim));
    for (int d0 = 0; d0 < dim; d0 += kDt) {
      const int tw = min(kDt, dim - d0);
      __syncthreads();  // x_s is free
      stage.each([&](int r, int dd, float x) { x_s[dd * kKPitch + r] = x * wgt_s[r]; });
      __syncthreads();
      if (d0 + kDt < dim) {
        stage.fetch(kp + s0 * st.k_s + d0 + kDt, st.k_s, n_rows,
                    min(kDt, dim - d0 - kDt));
      }
      if (um < tw) {
        float up[4] = {0.f, 0.f, 0.f, 0.f};
        for (int kk = 0; kk < k_end; kk += 8) {
          const float* xa = x_s + (um + gid) * kKPitch + kk + tig;
          const float a[4] = {xa[0], xa[8 * kKPitch], xa[4], xa[8 * kKPitch + 4]};
          const float* vb = v_s + (kk + tig) * kVPitch + 8 * ut + gid;
          const float bv[2] = {vb[0], vb[4 * kVPitch]};
          mma_f32<true, kSplitIn>(up, a, bv);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = d0 + um + gid + 8 * (i / 2);
          float* cell = &c_s[cswz(d, 8 * ut + 2 * tig + i % 2)];
          *cell = decay * *cell + up[i];
        }
      }
      // n~: eight lanes a row of the tile, each summing every eighth j
      {
        const int dr = tid / 8;
        const int part = tid % 8;
        float sum = 0.f;
        if (dr < tw) {
          for (int j = part; j < n_rows; j += 8) {
            sum += x_s[dr * kKPitch + j];
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        if (dr < tw && part == 0) {
          n_s[d0 + dr] = decay * n_s[d0 + dr] + sum;
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < dim * kEv; i += kSThreads) {
    const int d = i / kEv;
    const int e = i % kEv;
    c_out[state0 + static_cast<int64_t>(d) * dim + e0 + e] = c_s[cswz(d, e)];
  }
  if (blockIdx.x == 0) {
    for (int i = tid; i < dim; i += kSThreads) {
      n_out[static_cast<int64_t>(bh) * dim + i] = n_s[i];
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* lf, const float* li, const float* c0,
                   const float* n0, const float* m0, float* out, float* c_out,
                   float* n_out, float* m_out, float* gates, float* m_in,
                   float* w, const Strides& st, int batch, int seq, int heads,
                   int dim, int chunk, cudaStream_t stream) {
  const int n_chunks = (seq + chunk - 1) / chunk;
  const int bh = batch * heads;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  gate_kernel<<<bh, 32, 0, stream>>>(lf, li, m0, gates, m_in, m_out, st,
                                     heads, seq, chunk, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return err;
  }
  w_kernel<T><<<dim3(n_chunks, bh), kThreads, 0, stream>>>(
      qt, kt, gates, w, st, heads, seq, dim, chunk, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) {
    return err;
  }
  const size_t smem = state_smem_floats(dim) * sizeof(float);
  err = cudaFuncSetAttribute(state_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) {
    return err;
  }
  state_kernel<T><<<dim3(dim / kEv, bh), kSThreads, smem, stream>>>(
      qt, kt, vt, c0, n0, gates, m_in, w, out, c_out, n_out, st, heads, seq,
      dim, chunk, n_chunks);
  return cudaGetLastError();
}

}  // namespace

// q, k, v (B, S, H, D) with a unit D stride; lf, li (B, S, H) f32; c0
// (B, H, D, D), n0 (B, H, D), m0 (B, H) f32 contiguous, or all null; out
// (B, S, H, D), c_out, n_out, m_out f32 contiguous; scratch: gates (4, B,
// H, Sp), m_in (B, H, n_chunks), w (B, H, n_chunks, chunk, chunk), f32,
// with Sp = n_chunks * chunk.  strides: 15 element strides, (b, s, h) of q,
// k, v, lf and li.  dtype (of q, k, v): 0 float32, 1 bfloat16.  D is a
// multiple of 32 up to 1024; 1 <= chunk <= 128.
extern "C" int repro_mlstm_scan(const void* q, const void* k, const void* v,
                                const void* lf, const void* li,
                                const void* c0, const void* n0,
                                const void* m0, void* out, void* c_out,
                                void* n_out, void* m_out, void* gates,
                                void* m_in, void* w, const int64_t* strides,
                                int batch, int seq, int heads, int dim,
                                int chunk, int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0) {
    return 0;
  }
  if (chunk < 1 || chunk > kMaxQ || dim <= 0 || dim % kEv || dim > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t* s = strides;
  const Strides st{s[0], s[1], s[2],  s[3],  s[4],  s[5],  s[6], s[7],
                   s[8], s[9], s[10], s[11], s[12], s[13], s[14]};
  const auto* lf_f = static_cast<const float*>(lf);
  const auto* li_f = static_cast<const float*>(li);
  const auto* c0_f = static_cast<const float*>(c0);
  const auto* n0_f = static_cast<const float*>(n0);
  const auto* m0_f = static_cast<const float*>(m0);
  auto* out_f = static_cast<float*>(out);
  auto* c_f = static_cast<float*>(c_out);
  auto* n_f = static_cast<float*>(n_out);
  auto* m_f = static_cast<float*>(m_out);
  auto* g_f = static_cast<float*>(gates);
  auto* mi_f = static_cast<float*>(m_in);
  auto* w_f = static_cast<float*>(w);
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, lf_f, li_f, c0_f, n0_f, m0_f, out_f, c_f,
                           n_f, m_f, g_f, mi_f, w_f, st, batch, seq, heads,
                           dim, chunk, stream_);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, lf_f, li_f, c0_f, n0_f, m0_f,
                                   out_f, c_f, n_f, m_f, g_f, mi_f, w_f, st,
                                   batch, seq, heads, dim, chunk, stream_);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
