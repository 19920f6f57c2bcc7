// The xLSTM mLSTM chunked scan with its final state, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mlstm_scan.py::mlstm_scan
// (_mlstm_kernel).  That kernel ran a (batch*heads, chunks) grid with the
// chunk axis innermost and carried the stabilised state (C~ D x D, n~ D, m)
// in VMEM from one chunk step to the next; it returned h only.  At
// xlstm-1.3b's head dim of 1024, C~ is 4 MiB of f32 per (b, h), about 18
// times one SM's shared memory, and one block per (b, h) would give 16
// blocks for 132 SMs.  So the state is tiled across blocks, and one call
// runs three kernels on the caller's stream, by one of two routes:
//
//   1. gate_kernel (both routes), one warp per (b, h), chunks in order: the
//      prefix sum cumF of the log forget gates, u = li - cumF, the
//      stabiliser g = max(m_prev, cummax(u)) and the m entering each chunk,
//      m_next = cumF[Q-1] + g[Q-1].  They depend on the gates only, so every
//      exponent of the later passes is known before any D-sized work.
//   2. the W pass, one block per (chunk, b, h):
//      W[q][j] = (q_q . k_j) exp(u_j - g_q) for j <= q, else 0, and the row
//      sums of W.  The exponent is formed on the lower triangle only: above
//      it u_j - g_q may be large and positive.
//   3. the state pass: per chunk
//        h = (W v + e^{m_prev - g} (q C~)) / max(|rowsum W + e^{m_prev - g} (q . n~)|, e^{-(cumF + g)})
//        C~ = e^{m_prev - g_Q} C~ + (k e^{u - g_Q})^T v,  n~ the same on k.
//
// Route "wgmma" (bf16 q, k, v; D a multiple of 128, or of 64 up to 512),
// namespace tc below.  The W pass is one wgmma m64n128k16 product over
// TMA-fed panels of q and k (both exact bf16).  The state pass tiles C~ in
// two dimensions: a thread-block cluster of D / 128 (or D / 64) blocks owns
// a 64-column tile of C~, each block 128 (64) of its rows in f32 wgmma
// accumulators.  q C~ and the update run as wgmma with the f32 operand
// (C~, and wgt v) split into two bf16 parts, hi = bf16(x), lo = bf16(x -
// hi), about 16 significant bits, side by side as one N = 128 operand; W v
// runs with W's parts in registers.  The partial products of h meet in
// distributed shared memory: each block stages its rows of P and of q . n~
// and bulk-copies each rank's share into that rank's inbox (an mbarrier
// counts the bytes), and the rank finishes its rows of h; a split cluster
// barrier keeps the stage and the inbox from being overwritten early.
// q, k (double buffered) and v tiles come by TMA with 128-byte swizzle.
//
// Route "mma.sync" (f32 q, k, v; bf16 at the other head dims): w_kernel on
// the CUDA cores, and state_kernel, one block of 16 warps per (32 value
// columns of C~, b, h), holding its D x 32 slab of C~ and a copy of n~ in
// shared memory; its products run on mma.sync m16n8k8 in TF32 with every
// f32 operand split into two TF32 parts (about f32 accuracy).
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
// 235 MB of q, k, v, h and the final C~ need; so the operations, doubled
// by the hi + lo split.  The wgmma route's state blocks hold one block an
// SM (~225 KB of shared memory) and walk their chunks in order; per chunk
// a block's time goes to barriers within the block and the cluster, the
// exchange of h's partials, the L2 reads of q, k and v tiles that every
// column tile repeats, and the CUDA-core work on n~ and the operand splits,
// more than to the products (PERF.md gives the measured split).
//
// Plain C interface, loaded with ctypes by repro_torch/kernels/mlstm_scan.py;
// the function returns the CUDA error code (0 on success).  Linked with
// -lcuda for cuTensorMapEncodeTiled.

#include <cooperative_groups.h>
#include <cuda.h>
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

// ---------------------------------------------------------------------------
// bf16, head dims that are multiples of 64 (cluster of D / 64 up to 448, or
// D / 128 from 128 to 1024): the W and state passes on wgmma, with q, k and
// v tiles brought by TMA
// ---------------------------------------------------------------------------

namespace tc {

// Cycle marks of the state pass's chunk loop, for tools/mlstm_cycles.py:
// built with -DMLSTM_CYCLES, thread 0 of block (0, 0) adds the cycles since
// the previous mark to g_cycles[i]; otherwise they are empty.
#ifdef MLSTM_CYCLES
__device__ unsigned long long g_cycles[32];
#define CYCLE_START() long long cycle_prev = clock64()
#define CYCLE_MARK(i)                                                  \
  do {                                                                 \
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {      \
      const long long cycle_now = clock64();                           \
      g_cycles[i] += cycle_now - cycle_prev;                           \
      cycle_prev = cycle_now;                                          \
    }                                                                  \
  } while (0)
#else
#define CYCLE_START() \
  do {                \
  } while (0)
#define CYCLE_MARK(i) \
  do {                \
  } while (0)
#endif


constexpr int kThreads = 256;                 // two warpgroups
constexpr int kRows = 128;                    // positions a tile holds
constexpr int kPanel = 64;                    // elements of a 128-byte row
constexpr int kPanelBytes = kRows * 128;      // a 128 x 64 bf16 panel
constexpr int kEc = 64;                       // value columns of a C~ tile
constexpr int kRedPitch = kEc + 4;            // floats a row of the partials
constexpr int kMaxCluster = 8;                // the portable cluster size

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.  A wait
// that lasts past ~2^34 cycles (seconds) traps: a fault, not a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) {
      return;
    }
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 34)) {
      __trap();
    }
  }
}

// One 64 x 128 box of a 4-D tensor map (coordinates d, s, h, b) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// The address of the same shared-memory location in block `rank` of the
// cluster.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// Copy `bytes` of this block's shared memory into a peer's (dst and bar are
// that peer's, from peer_addr); completion is counted in bytes on bar.
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, uint32_t src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Generic-proxy writes to shared memory, made visible to wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// Byte offset of element (row, col) of a 128-byte-row panel in TMA's
// 128-byte swizzle: 16-byte chunk c of row r sits at chunk c ^ (r % 8).
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ (row & 7))) << 4) + ((col & 7) << 1);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    asm volatile("" : "+f"(r[i])::"memory");
  }
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) B (16 x 64, shared,
// MN-major).
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 128, f32) (+)= A (64 x 16) B (16 x 128), bf16 in shared memory;
// TA / TB 0: K-major, 1: MN-major (the transpose bits).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
}

// x0, x1 -> bf16 hi = bf16(x), lo = bf16(x - hi), packed in pairs (the
// first value in the low half, as wgmma's fragments take them).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 2. The W pass on the tensor cores: one block per (chunk, b, h), two
// warpgroups of 64 query rows.  S = q k^T is wgmma m64n128k16 over panels
// of 64 head-dim elements that TMA brings through a ring of two stages;
// then W = S exp(u_j - g_q) on the lower triangle and the row sums, as
// w_kernel computes them.
__global__ void __launch_bounds__(kThreads, 1)
    w_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                float* __restrict__ gates, float* __restrict__ w, int heads,
                int dim, int chunk, int n_chunks) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ float u_s[kRows];
  __shared__ float g_s[kRows];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  auto q_at = [&](int s) { return base + s * 2 * kPanelBytes; };
  auto k_at = [&](int s) { return base + s * 2 * kPanelBytes + kPanelBytes; };
  const uint32_t bars = base + 4 * kPanelBytes;  // full[2], empty[2]
  auto bar_full = [&](int s) { return bars + 8 * s; };
  auto bar_empty = [&](int s) { return bars + 8 * (2 + s); };

  const int c = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int hd = bh % heads;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int s0 = c * chunk;
  const int n_panels = dim / kPanel;
  const int64_t sp = static_cast<int64_t>(n_chunks) * chunk;
  const Planes pl = planes(gates, bh, sp, static_cast<int64_t>(gridDim.y) * sp);
  for (int i = tid; i < kRows; i += kThreads) {
    u_s[i] = i < chunk ? pl.u[s0 + i] : 0.f;
    g_s[i] = i < chunk ? pl.g[s0 + i] : 0.f;
  }
  auto load = [&](int p, int s) {
    mbar_expect_tx(bar_full(s), 2 * kPanelBytes);
    tma_load(q_at(s), &map_q, bar_full(s), p * kPanel, s0, hd, b);
    tma_load(k_at(s), &map_k, bar_full(s), p * kPanel, s0, hd, b);
  };
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), 2);  // one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    load(0, 0);
    if (n_panels > 1) {
      load(1, 1);
    }
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0.f;
  }
  for (int p = 0; p < n_panels; ++p) {
    const int s = p & 1;
    const uint32_t parity = (p >> 1) & 1;
    mbar_wait(bar_full(s), parity);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = make_desc(q_at(s) + wg * 64 * 128 + kk * 32, 16, 1024);
      const uint64_t db = make_desc(k_at(s) + kk * 32, 16, 1024);
      wgmma_ss128<0, 0>(acc, da, db, p > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (tid % 128 == 0) {
      mbar_arrive(bar_empty(s));
    }
    if (tid == 0 && p + 2 < n_panels) {
      mbar_wait(bar_empty(s), parity);  // both warpgroups are done with it
      load(p + 2, s);
    }
    __syncwarp();  // wgmma's .aligned instructions need the warp converged
  }

  // rows 64 wg + 16 warp + lane / 4 (+ 8), columns 8 j + 2 (lane % 4) (+ 1)
  const int row0 = 64 * wg + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  float* wp = w + (static_cast<int64_t>(bh) * n_chunks + c) * chunk * chunk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    float rsum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + col0 + e;
        float val = 0.f;
        if (row < chunk && col <= row) {
          val = acc[4 * j + 2 * r + e] * expf(u_s[col] - g_s[row]);
        }
        if (row < chunk && col < chunk) {
          wp[row * chunk + col] = val;
        }
        rsum += val;
      }
    }
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
    if (lane % 4 == 0 && row < chunk) {
      pl.rsum[s0 + row] = rsum;
    }
  }
}

// Shared memory of the state pass: MT panels of q and of k, one of v, two
// B operands of two panels each ([hi | lo] of C~, and of wgt v), then
// (floats) this block's stage and its inbox of h's partials, the chunk's
// scalars in two buffers, n~, and four mbarriers.
template <int MT>
struct StateSmem {
  static constexpr int kTr = 64 * MT;
  static constexpr int kPanels = 2 * MT + 5;
  // a rank's rows of h, ceil(Q / cs), from each of cs blocks; a row holds
  // 64 columns of P and, in column 64, q . n~
  static constexpr int kInboxRows = kRows + kMaxCluster;
  static constexpr int kInbox = kInboxRows * kRedPitch;
  static constexpr int kFloats = 2 * kInbox + 2 * 4 * kRows + 4 + kTr;
  static constexpr int kBytes =
      1024 + kPanels * kPanelBytes + kFloats * 4 + 8 + 4 * 8;
};

// 3. The state pass on the tensor cores.  A cluster of cs = D / kTr blocks
// owns one 64-column tile of C~ for one (b, h); block `rank` owns rows
// rank kTr .. + kTr of it, in f32 wgmma accumulators across the chunk loop
// (warpgroup wg < MT owns 64 of the rows).  The accumulators hold two
// halves, the products with the hi and with the lo part of the other
// operand, which run as one m64n128k16 wgmma over [hi | lo] (A is read
// once for both); C~ is their sum.  Per chunk:
//   * the block writes C~ as bf16 hi + lo (B1), and each warpgroup computes
//     64 positions of P = q[:, rows] C~[rows, cols]; meanwhile the CUDA
//     cores compute q[:, rows] . n~[rows] and wgt v as bf16 hi + lo (B2).
//     P's rows are scaled by carry = e^{m_prev - g}, and the block adds its
//     share of W v[:, cols] (k16 steps rank, rank + cs, ...; W split into
//     bf16 hi + lo in registers);
//   * each block stages its rows of P (and q . n~) and bulk-copies rank i's
//     ceil(Q / cs) rows into rank i's inbox, where an mbarrier counts the
//     bytes;
//   * the update C~ <- e^{m_prev - g_Q} C~ + k[:, rows]^T [B2] (k read
//     MN-major, the transpose bit) runs on the tensor cores while the CUDA
//     cores update n~ <- decay n~ + k^T wgt, wait for the inbox and write
//     this rank's rows of h = P / max(|rowsum W + carry q . n~|,
//     e^{-(cumF + g)}).
// A split cluster barrier (arrive once the inbox is read, wait before the
// next stage is written) keeps the stage and the inbox from being reused
// early.  q, k and v tiles of the next chunk are loaded by TMA as soon as
// this chunk is done with each.
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
    state_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const float* __restrict__ c0, const float* __restrict__ n0,
                    float* __restrict__ gates, const float* __restrict__ m_in,
                    const float* __restrict__ w, float* __restrict__ out,
                    float* __restrict__ c_out, float* __restrict__ n_out,
                    int heads, int seq, int dim, int chunk, int n_chunks) {
  using L = StateSmem<MT>;
  constexpr int kTr = L::kTr;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());

  extern __shared__ unsigned char smem_raw[];
  unsigned char* gb = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_g = gb;
  unsigned char* k_g = q_g + MT * kPanelBytes;
  unsigned char* v_g = k_g + MT * kPanelBytes;
  unsigned char* b1_g = v_g + kPanelBytes;      // [C~ hi | C~ lo]
  unsigned char* b2_g = b1_g + 2 * kPanelBytes;  // [wgt v hi | wgt v lo]
  float* stage = reinterpret_cast<float*>(b2_g + 2 * kPanelBytes);  // this block's P
  float* inbox = stage + L::kInbox;  // [cs][rows_rank]: the rows this rank finishes
  float* scal = inbox + L::kInbox;   // [2][carry, floor, wgt, rowsum W][kRows]
  float* decay_s = scal + 2 * 4 * kRows;  // [2]
  float* n_s = decay_s + 4;
  const uint32_t q_s = smem_u32(q_g);
  const uint32_t k_s = smem_u32(k_g);
  const uint32_t v_s = smem_u32(v_g);
  const uint32_t bars = (smem_u32(n_s + kTr) + 7) & ~7u;
  const uint32_t bar_q = bars;
  const uint32_t bar_k = bars + 8;
  const uint32_t bar_v = bars + 16;
  const uint32_t bar_in = bars + 24;  // the inbox is full

  const int ct = blockIdx.x / cs;
  const int e0 = ct * kEc;
  const int r0 = rank * kTr;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int hd = bh % heads;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row0 = 16 * warp + lane / 4;  // accumulator rows (+ 8) of 64
  const int col0 = 2 * (lane % 4);        // and columns 8 j + col0 (+ 1)
  const int64_t sp = static_cast<int64_t>(n_chunks) * chunk;
  const Planes pl = planes(gates, bh, sp, static_cast<int64_t>(gridDim.y) * sp);
  const int64_t state0 = static_cast<int64_t>(bh) * dim * dim;
  const int64_t out_s = static_cast<int64_t>(heads) * dim;  // row stride of h
  const int n_steps = (chunk + 15) / 16;  // k16 steps over a chunk
  const int rows_rank = (chunk + cs - 1) / cs;  // rows of h a rank finishes
  const uint32_t slot_bytes = rows_rank * kRedPitch * 4;  // a block's rows for a rank
  // B of a product: two 64-column panels side by side, hi then lo
  auto desc_b = [&](const unsigned char* b_g, int kk) {
    return make_desc(smem_u32(b_g) + kk * 2048, kPanelBytes, 1024);
  };

  auto load_rows = [&](const CUtensorMap* map, uint32_t dst, uint32_t bar,
                       int s0) {
    mbar_expect_tx(bar, MT * kPanelBytes);
#pragma unroll
    for (int p = 0; p < MT; ++p) {
      tma_load(dst + p * kPanelBytes, map, bar, r0 + p * kPanel, s0, hd, b);
    }
  };
  auto load_v = [&](int s0) {
    mbar_expect_tx(bar_v, kPanelBytes);
    tma_load(v_s, &map_v, bar_v, e0, s0, hd, b);
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_k, 1);
    mbar_init(bar_v, 1);
    mbar_init(bar_in, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // C~ = cacc[i] + cacc[i + 32]: rows r0 + 64 wg + row0 (+ 8), columns
  // e0 + 8 j + col0 (+ 1), register 4 j + 2 r (+ 1)
  float cacc[64];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float2 x = make_float2(0.f, 0.f);
      if (c0 != nullptr && wg < MT) {
        const int d = r0 + 64 * wg + row0 + 8 * r;
        x = *reinterpret_cast<const float2*>(
            c0 + state0 + static_cast<int64_t>(d) * dim + e0 + 8 * j + col0);
      }
      cacc[4 * j + 2 * r] = x.x;
      cacc[4 * j + 2 * r + 1] = x.y;
      cacc[32 + 4 * j + 2 * r] = 0.f;
      cacc[32 + 4 * j + 2 * r + 1] = 0.f;
    }
  }
  for (int i = tid; i < kTr; i += kThreads) {
    n_s[i] = n0 == nullptr ? 0.f : n0[static_cast<int64_t>(bh) * dim + r0 + i];
  }
  cluster.sync();  // every block runs and its barriers are set up
  if (tid == 0) {
    load_rows(&map_q, q_s, bar_q, 0);
    load_rows(&map_k, k_s, bar_k, 0);
    load_v(0);
  }

  // the gate values a thread (tid < kRows) needs for a chunk's scalars,
  // loaded one chunk ahead so their latency hides behind a chunk's work
  float nx[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // m_prev, g_Q, g, cumF, u, rowsum W
  auto fetch_gates = [&](int c) {
    if (tid < kRows && c < n_chunks) {
      const int s0 = c * chunk;
      const int r = min(tid, chunk - 1);
      nx[0] = m_in[bh * n_chunks + c];
      nx[1] = pl.g[s0 + chunk - 1];
      nx[2] = pl.g[s0 + r];
      nx[3] = pl.cum[s0 + r];
      nx[4] = pl.u[s0 + r];
      nx[5] = pl.rsum[s0 + r];
    }
  };
  fetch_gates(0);

  CYCLE_START();
  for (int c = 0; c < n_chunks; ++c) {
    const int s0 = c * chunk;
    const int n_rows = min(chunk, seq - s0);
    const uint32_t parity = c & 1;
    const int buf = c & 1;
    float* carry_s = scal + buf * 4 * kRows;
    float* floor_s = carry_s + kRows;
    float* wgt_s = floor_s + kRows;
    float* rsum_s = wgt_s + kRows;
    if (tid < kRows) {
      const float mp = nx[0];
      const float gq = nx[1];
      const int r = tid;
      if (r < chunk) {
        const float g = nx[2];
        carry_s[r] = expf(mp - g);
        floor_s[r] = expf(-(nx[3] + g));
        wgt_s[r] = expf(nx[4] - gq);
        rsum_s[r] = nx[5];
      } else {
        carry_s[r] = 0.f;
        floor_s[r] = 1.f;
        wgt_s[r] = 0.f;
        rsum_s[r] = 0.f;
      }
      if (r == 0) {
        decay_s[buf] = expf(mp - gq);
      }
    }
    if (tid == 0) {
      mbar_expect_tx(bar_in, cs * slot_bytes);  // every block's rows for this rank
    }
    CYCLE_MARK(0);
    // B1: the state entering the chunk as bf16 hi + lo, [row][col]
    if (wg < MT) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r;
          uint32_t hi, lo;
          split2(cacc[i] + cacc[32 + i], cacc[i + 1] + cacc[33 + i], hi, lo);
          const uint32_t off = swz(64 * wg + row0 + 8 * r, 8 * j + col0);
          *reinterpret_cast<uint32_t*>(b1_g + off) = hi;
          *reinterpret_cast<uint32_t*>(b1_g + kPanelBytes + off) = lo;
        }
      }
    }
    fence_proxy_async();
    __syncthreads();

    CYCLE_MARK(1);
    // A of this rank's first k16 step of W v, fetched ahead of the products
    const float* wp = w + (static_cast<int64_t>(bh) * n_chunks + c) * chunk * chunk;
    float wx[8];
    auto fetch_w = [&](int kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 64 * wg + row0 + 8 * (i & 1);
        const int col = 16 * kk + col0 + 8 * (i >> 1);
        const bool live = row < chunk && kk < n_steps;
        wx[2 * i] = live && col < chunk ? wp[row * chunk + col] : 0.f;
        wx[2 * i + 1] = live && col + 1 < chunk ? wp[row * chunk + col + 1] : 0.f;
      }
    };
    fetch_w(rank);

    // [q C~hi | q C~lo] for this warpgroup's 64 positions
    float pacc[64];
    mbar_wait(bar_q, parity);
    CYCLE_MARK(2);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * MT; ++kk) {
      const uint64_t da = make_desc(
          q_s + (kk / 4) * kPanelBytes + wg * 64 * 128 + (kk % 4) * 32, 16, 1024);
      wgmma_ss128<0, 1>(pacc, da, desc_b(b1_g, kk), kk > 0);
    }
    wgmma_commit();
    CYCLE_MARK(3);
    // meanwhile, on the CUDA cores: q . n~ over this block's rows, two
    // threads a position, each half of the row (the even one keeps it) ...
    float qn_val;
    {
      const int j = tid >> 1;
      const int half = tid & 1;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 4 * MT; ++i) {
        const int cc = half * 4 * MT + i;  // 16-byte chunk of the row
        const int p = cc >> 3;
        const int ch = cc & 7;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            q_g + p * kPanelBytes + j * 128 + ((ch ^ (j & 7)) << 4));
        const float4 na = *reinterpret_cast<const float4*>(n_s + cc * 8);
        const float4 nb = *reinterpret_cast<const float4*>(n_s + cc * 8 + 4);
        float x[8];
        unpack(raw, x);
        sum = fmaf(x[0], na.x, sum);
        sum = fmaf(x[1], na.y, sum);
        sum = fmaf(x[2], na.z, sum);
        sum = fmaf(x[3], na.w, sum);
        sum = fmaf(x[4], nb.x, sum);
        sum = fmaf(x[5], nb.y, sum);
        sum = fmaf(x[6], nb.z, sum);
        sum = fmaf(x[7], nb.w, sum);
      }
      qn_val = sum + __shfl_xor_sync(0xffffffffu, sum, 1);
    }
    CYCLE_MARK(4);
    // ... and B2: wgt v as bf16 hi + lo, in v's own layout
    mbar_wait(bar_v, parity);
    for (int x = tid; x < kRows * 8; x += kThreads) {
      const float wj = wgt_s[x >> 3];
      const uint4 raw = *reinterpret_cast<const uint4*>(v_g + x * 16);
      float f[8];
      unpack(raw, f);
      uint4 h4, l4;
      split2(f[0] * wj, f[1] * wj, h4.x, l4.x);
      split2(f[2] * wj, f[3] * wj, h4.y, l4.y);
      split2(f[4] * wj, f[5] * wj, h4.z, l4.z);
      split2(f[6] * wj, f[7] * wj, h4.w, l4.w);
      *reinterpret_cast<uint4*>(b2_g + x * 16) = h4;
      *reinterpret_cast<uint4*>(b2_g + kPanelBytes + x * 16) = l4;
    }
    fence_proxy_async();
    __syncwarp();
    CYCLE_MARK(5);
    wgmma_wait_all();
    fence_regs(pacc);
    float ph[32];  // P = (q C~hi + q C~lo) carry
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      ph[i] = (pacc[i] + pacc[32 + i]) * carry_s[64 * wg + row0 + 8 * ((i >> 1) & 1)];
    }
    CYCLE_MARK(6);
    // + W v[:, cols], this rank's k16 steps, W in registers as hi + lo
    for (int kk = rank; kk < n_steps; kk += cs) {
      if (kk != rank) {
        fetch_w(kk);
      }
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        split2(wx[2 * i], wx[2 * i + 1], ah[i], al[i]);
      }
      wgmma_fence();
      const uint64_t db = make_desc(v_s + kk * 2048, kPanelBytes, 1024);
      wgmma_rs64(ph, ah, db);
      wgmma_rs64(ph, al, db);
      wgmma_commit();
      wgmma_wait_all();  // the A registers are rewritten next step
      fence_regs(ph);
    }
    CYCLE_MARK(7);
    if (c > 0) {
      cluster_wait();  // the last chunk's copies are in and read
    }
    CYCLE_MARK(8);
    // this block's rows of P, and q . n~ in column 64, to the stage
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* dst = stage + (64 * wg + row0 + 8 * r) * kRedPitch + col0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(ph[4 * j + 2 * r], ph[4 * j + 2 * r + 1]);
      }
    }
    if ((tid & 1) == 0) {
      stage[(tid >> 1) * kRedPitch + kEc] = qn_val;
    }
    fence_proxy_async();
    __syncthreads();  // q, v and B1 are read; the stage and B2 are written
    if (tid < cs) {  // lane i: rank i's rows of P to slot `rank` of its inbox
      bulk_to_peer(peer_addr(smem_u32(inbox) + rank * slot_bytes, tid),
                   smem_u32(stage) + tid * slot_bytes, slot_bytes,
                   peer_addr(bar_in, tid));
    }
    if (tid == 32 && c + 1 < n_chunks) {
      load_rows(&map_q, q_s, bar_q, s0 + chunk);
      load_v(s0 + chunk);
    }

    CYCLE_MARK(9);
    // C~ <- decay C~ + k[:, rows]^T [wgt v hi | wgt v lo], on the tensor
    // cores while the CUDA cores update n~ and finish h
    mbar_wait(bar_k, parity);
    __syncwarp();
    const float decay = decay_s[buf];
    CYCLE_MARK(10);
    if (wg < MT) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        cacc[i] *= decay;
      }
      wgmma_fence();
      for (int kk = 0; kk < n_steps; ++kk) {
        const uint64_t da = make_desc(k_s + wg * kPanelBytes + kk * 2048, kPanelBytes, 1024);
        wgmma_ss128<1, 1>(cacc, da, desc_b(b2_g, kk), 1);
      }
      wgmma_commit();
    }
    CYCLE_MARK(11);
    // n~ <- decay n~ + k^T wgt: a group of kLanes lanes owns 8 rows of
    // n~ (one 16-byte chunk of k's rows) and splits the positions
    {
      constexpr int kLanes = kThreads * 8 / kTr;  // 16, or 32 where kTr is 64
      const int dc = tid / kLanes;                // the chunk of 8 rows
      const int l = tid % kLanes;
      const unsigned char* kp = k_g + (dc >> 3) * kPanelBytes;
      float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int j = l; j < chunk; j += kLanes) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            kp + j * 128 + (((dc & 7) ^ (j & 7)) << 4));
        float x[8];
        unpack(raw, x);
        const float wj = wgt_s[j];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sum[e] = fmaf(wj, x[e], sum[e]);
        }
      }
#pragma unroll
      for (int off = 1; off < kLanes; off <<= 1) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], off);
        }
      }
      float mine = 0.f;  // lane l < 8 writes row 8 dc + l
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        mine = e == l ? sum[e] : mine;
      }
      if (l < 8) {
        n_s[dc * 8 + l] = decay * n_s[dc * 8 + l] + mine;
      }
    }
    CYCLE_MARK(12);
    fetch_gates(c + 1);
    // this rank's rows of h: its inbox summed over the cluster's blocks
    mbar_wait(bar_in, parity);
    CYCLE_MARK(13);
    {
      const int lo_row = rank * rows_rank;
      const int n_mine = max(0, min(lo_row + rows_rank, n_rows) - lo_row);
      float* op = out + (static_cast<int64_t>(b) * seq + s0 + lo_row) * out_s + hd * dim + e0;
      for (int i = tid; i < n_mine * (kEc / 4); i += kThreads) {
        const int row = i / (kEc / 4);
        const int col = (i % (kEc / 4)) * 4;
        float4 x[kMaxCluster];
        float xq[kMaxCluster];
#pragma unroll
        for (int src = 0; src < kMaxCluster; ++src) {
          if (src < cs) {
            const float* in = inbox + (src * rows_rank + row) * kRedPitch;
            x[src] = *reinterpret_cast<const float4*>(in + col);
            xq[src] = in[kEc];
          }
        }
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        float qn = 0.f;
#pragma unroll
        for (int src = 0; src < kMaxCluster; ++src) {
          if (src < cs) {
            s.x += x[src].x;
            s.y += x[src].y;
            s.z += x[src].z;
            s.w += x[src].w;
            qn += xq[src];
          }
        }
        const int r = lo_row + row;
        const float den = fmaxf(fabsf(rsum_s[r] + carry_s[r] * qn), floor_s[r]);
        *reinterpret_cast<float4*>(op + row * out_s + col) =
            make_float4(s.x / den, s.y / den, s.z / den, s.w / den);
      }
    }
    // this rank's inbox is read; once all have arrived, every copy of this
    // chunk is complete (each rank waited for its inbox)
    CYCLE_MARK(14);
    cluster_arrive();
    if (wg < MT) {
      wgmma_wait_all();
      fence_regs(cacc);
    }
    __syncthreads();  // k and B2 are read; n~ is written
    if (tid == 0 && c + 1 < n_chunks) {
      load_rows(&map_k, k_s, bar_k, s0 + chunk);
    }
    CYCLE_MARK(15);
  }
  cluster_wait();  // no block leaves while a copy may read its stage

  if (wg < MT) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r;
        const int d = r0 + 64 * wg + row0 + 8 * r;
        *reinterpret_cast<float2*>(c_out + state0 + static_cast<int64_t>(d) * dim +
                                   e0 + 8 * j + col0) =
            make_float2(cacc[i] + cacc[32 + i], cacc[i + 1] + cacc[33 + i]);
      }
    }
  }
  if (ct == 0 && tid < kTr) {
    n_out[static_cast<int64_t>(bh) * dim + r0 + tid] = n_s[tid];
  }
}

// The tensor map of a (B, S, H, D) bf16 tensor with element strides
// (b, s, h) and a unit D stride, read in boxes of 64 x 128 (d, s).
cudaError_t make_map(CUtensorMap* map, const void* ptr, int64_t st_b,
                     int64_t st_s, int64_t st_h, int batch, int seq,
                     int heads, int dim) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dim),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  // a dimension of size 1 is never stepped along; any legal stride does
  const int64_t sizes[3] = {seq, heads, batch};
  const int64_t elems[3] = {st_s, st_h, st_b};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    strides[i] = static_cast<cuuint64_t>(sizes[i] == 1 ? dim : elems[i]) * 2;
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kPanel),
                             static_cast<cuuint32_t>(kRows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int MT>
cudaError_t launch_state(const CUtensorMap& mq, const CUtensorMap& mk,
                         const CUtensorMap& mv, const float* c0,
                         const float* n0, float* gates, const float* m_in,
                         const float* w, float* out, float* c_out,
                         float* n_out, int bh, int heads, int seq, int dim,
                         int chunk, int n_chunks, cudaStream_t stream) {
  const int smem = StateSmem<MT>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      state_tc_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    return err;
  }
  const int cs = dim / (64 * MT);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cs * (dim / kEc)),
                     static_cast<unsigned>(bh));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, state_tc_kernel<MT>, mq, mk, mv, c0, n0,
                           gates, m_in, w, out, c_out, n_out, heads, seq, dim,
                           chunk, n_chunks);
  if (err != cudaSuccess) {
    return err;
  }
  return cudaGetLastError();
}

// Rows of C~ a block owns (64 MT): 128 where D is a multiple of 128, else
// 64; 0 where this route does not take D.
__host__ __device__ constexpr int tile_rows(int dim) {
  return dim % 128 == 0 && dim / 128 <= kMaxCluster
             ? 128
             : (dim % 64 == 0 && dim / 64 <= kMaxCluster ? 64 : 0);
}

cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* lf, const float* li, const float* c0,
                   const float* n0, const float* m0, float* out, float* c_out,
                   float* n_out, float* m_out, float* gates, float* m_in,
                   float* w, const Strides& st, int batch, int seq, int heads,
                   int dim, int chunk, cudaStream_t stream) {
  const int n_chunks = (seq + chunk - 1) / chunk;
  const int bh = batch * heads;
  gate_kernel<<<bh, 32, 0, stream>>>(lf, li, m0, gates, m_in, m_out, st,
                                     heads, seq, chunk, n_chunks);
  cudaError_t err = cudaGetLastError();
  CUtensorMap mq, mk, mv;
  if (err == cudaSuccess) {
    err = make_map(&mq, q, st.q_b, st.q_s, st.q_h, batch, seq, heads, dim);
  }
  if (err == cudaSuccess) {
    err = make_map(&mk, k, st.k_b, st.k_s, st.k_h, batch, seq, heads, dim);
  }
  if (err == cudaSuccess) {
    err = make_map(&mv, v, st.v_b, st.v_s, st.v_h, batch, seq, heads, dim);
  }
  constexpr int kWSmem = 1024 + 4 * kPanelBytes + 4 * 8;
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        w_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmem);
  }
  if (err != cudaSuccess) {
    return err;
  }
  w_tc_kernel<<<dim3(n_chunks, bh), kThreads, kWSmem, stream>>>(
      mq, mk, gates, w, heads, dim, chunk, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) {
    return err;
  }
  if (tile_rows(dim) == 128) {
    return launch_state<2>(mq, mk, mv, c0, n0, gates, m_in, w, out, c_out,
                           n_out, bh, heads, seq, dim, chunk, n_chunks,
                           stream);
  }
  return launch_state<1>(mq, mk, mv, c0, n0, gates, m_in, w, out, c_out,
                         n_out, bh, heads, seq, dim, chunk, n_chunks, stream);
}

}  // namespace tc

}  // namespace

// q, k, v (B, S, H, D) with a unit D stride; lf, li (B, S, H) f32; c0
// (B, H, D, D), n0 (B, H, D), m0 (B, H) f32 contiguous, or all null; out
// (B, S, H, D), c_out, n_out, m_out f32 contiguous; scratch: gates (4, B,
// H, Sp), m_in (B, H, n_chunks), w (B, H, n_chunks, chunk, chunk), f32,
// with Sp = n_chunks * chunk.  strides: 15 element strides, (b, s, h) of q,
// k, v, lf and li.  dtype (of q, k, v): 0 float32, 1 bfloat16.  D is a
// multiple of 32 up to 1024; 1 <= chunk <= 128.  route 0: the W and state
// passes of mma.sync (split TF32); route 1: those of wgmma (bf16 only, D a
// multiple of 64 with D / 64 <= 8 or of 128; q, k, v need 16-byte aligned
// bases and strides, as TMA reads them).
extern "C" int repro_mlstm_scan(const void* q, const void* k, const void* v,
                                const void* lf, const void* li,
                                const void* c0, const void* n0,
                                const void* m0, void* out, void* c_out,
                                void* n_out, void* m_out, void* gates,
                                void* m_in, void* w, const int64_t* strides,
                                int batch, int seq, int heads, int dim,
                                int chunk, int dtype, int route,
                                void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0) {
    return 0;
  }
  if (chunk < 1 || chunk > kMaxQ || dim <= 0 || dim % kEv || dim > 1024 ||
      (route == 1 && (dtype != 1 || tc::tile_rows(dim) == 0)) ||
      (route != 0 && route != 1)) {
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
  if (route == 1) {
    return tc::launch(q, k, v, lf_f, li_f, c0_f, n0_f, m0_f, out_f, c_f, n_f,
                      m_f, g_f, mi_f, w_f, st, batch, seq, heads, dim, chunk,
                      stream_);
  }
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

#ifdef MLSTM_CYCLES
// The state pass's cycles by mark since the library was loaded (32 counts).
extern "C" int repro_read_cycles(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, tc::g_cycles,
                                               sizeof(unsigned long long) * 32));
}
#endif
