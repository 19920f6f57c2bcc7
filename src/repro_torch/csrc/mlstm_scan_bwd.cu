// The gradient of the xLSTM mLSTM chunkwise scan, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's models never call its Pallas
// scan (repro/kernels/mlstm_scan.py::mlstm_scan), and jax.value_and_grad
// differentiates the plain chunked code (repro/models/xlstm.py::
// _chunked_mlstm) through XLA.  The port's train step runs the forward kernel
// (csrc/mlstm_scan.cu), so its gradient is a kernel too.
//
// The absolute stabilisers are held fixed (repro_torch/kernels/
// mlstm_scan_bwd.py says why that gives autograd's gradients): with M_q =
// cumF_q + g_q, every stabilised factor is exp(x - M) for a sum x of the
// inputs, so D[q, j] = exp(li_j + cumF_q - cumF_j - M_q) = exp(u_j - g_q),
// a_q = exp(m + cumF_q - M_q) = exp(m - g_q), and the chunk-end weights
// wgt_j = exp(u_j - g_end) and decay exp(m - g_end) take gradients through
// li and cumF only.  For position q of a chunk with entering (C~, n~, m),
// s_q = sum_j W_qj + a_q q_q . n~ (W = (q k^T) (.) D), dd_q = max(|s_q|,
// exp(-M_q)) and h_q = (W v + a_q q_q C~)_q / dd_q.  One call runs nine
// kernels on the caller's stream:
//
//   1. gates, one warp per (b, h): cumF, g and each chunk's entering m;
//   2. chunk updates, one block per (b, h, chunk, 128 x 128 tile of C~):
//      sum_j wgt_j k_j (x) v_j, and sum_j wgt_j k_j;
//   3. forward state pass, elementwise: the state entering each chunk,
//      written over its update, 1024 elements a block as float4s with the
//      next chunk's loaded ahead (one more block for n~); with the final
//      state's gradients, their dot with the final state by block;
//   4. Z = dh C~^T (the carry's share of dq, up to a_q / dd_q), one block
//      per (b, h, chunk, 128 columns), and q . Z by column tile;
//   5. rows, one block per (b, h, chunk): S = q k^T and dh v^T (128 x 128
//      register tiles), W, the denominators and ds = -(dh . num) / dd^2 *
//      sign(s) where |s| wins the max (zero where the floor does); then
//      dW = dh v^T / dd + ds, P = dW (.) W, dS = dW (.) D into shared
//      memory, dq = dS k + (a / dd) Z + a ds n~ (whole), dS^T q and
//      W^T (dh / dd) (the Q x Q shares of dk and dv, to scratch), and per
//      position the sums of P by row and column and d log a;
//   6. local state gradients (kernel 2's shape): sum_q (a_q / dd_q) q_q (x)
//      dh_q and sum_q a_q ds_q q_q;
//   7. reverse state pass, elementwise: the gradient of the state leaving
//      each chunk over kernel 6's output, the entering state's gradient,
//      and each chunk's <dC~', C~> + <dn~', n~> by block;
//   8. the state's shares, one block per (b, h, chunk, 128 columns): dk +=
//      wgt (v dC~'^T + dn~'), dv += wgt (k dC~'), and k . (v dC~'^T + dn~')
//      by column tile (the gradient of the chunk-end weights);
//   9. last gates, one warp per (b, h): dcumF and dli summed in a fixed
//      order, the final m's path back to the position (or the entering m)
//      that won its maxima, dlf as the reverse prefix sum of dcumF within
//      each chunk, and the entering m's gradient.
//
// Every product runs on the CUDA cores in f32, whatever the input dtype
// (bf16 q, k, v are widened as they are read), through one tiled routine:
// shared tiles of 16 values of k, register tiles of 8 x 8 outputs a thread,
// each thread's rows in groups of four read as float4s.  No kernel uses
// atomics: every sum across blocks is written by block and added in a fixed
// order, so two calls give equal bits.  Positions past S read as identity
// steps (lf 0, li -1e30, zero q, k, v, dh).
//
// What bounds it: at xlstm-1.3b's train shape (B 1, S 4096, H 4, D 1024,
// chunks of 128, bf16) the function needs 5 Q D^2 + 2.5 Q^2 D
// multiply-adds a (b, h, chunk) on its causal triangles, ~183 GFLOP, 0.185
// ms at the bf16 tensor-core rate; it reads and writes ~270 MB (0.08 ms):
// the operations.  This first version runs those products (Q x Q ones on
// full tiles) at the f32 rate of the CUDA cores (67 TFLOP/s at most) and
// moves the two 0.5 GiB slabs of states and their gradients through memory
// (the state passes as float4s, the next chunk loaded ahead); the product
// kernels keep two blocks an SM (at most 128 registers a thread).  The
// tensor cores are later work.  PERF.md gives the measured split by kernel.
//
// Plain C interface, loaded with ctypes by repro_torch/kernels/
// mlstm_scan_bwd.py; the function returns the CUDA error code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // every block kernel: 16 x 16 threads; the
                               // product kernels keep two blocks an SM (at
                               // most 128 registers a thread)
constexpr int kT = 128;        // chunk rows at most; tile of C~ and of D
constexpr int kKB = 16;        // values of k a shared tile holds
constexpr int kPassElems = 1024;  // state elements a block of the state passes
constexpr float kNegInf = -1e30f;
constexpr float kLowest = -3.0e38f;  // below every u, which is >= -1e30 - cumF
constexpr int kLd = kT + 1;    // leading dim of a Q x Q matrix in shared memory

// Element strides (b, s, h) of q, k, v, dh, lf, li; D is unit.
struct Strides {
  int64_t q[3], k[3], v[3], dh[3], lf[3], li[3];
};

struct Dims {
  int batch, seq, heads, hd, chunk, n_chunks, tiles, pass_blocks;
  bool bf;  // q, k, v, dq, dk, dv are bf16
};

// The scratch, f32 (repro_torch/kernels/mlstm_scan_bwd.py::scratch_floats).
struct Scratch {
  float* cst;   // (B H, chunks, D, D): updates, then the entering states
  float* gst;   // (B H, chunks, D, D): local gradients, then the leaving ones'
  float* nst;   // (B H, chunks, D): the same for n~
  float* gn;    // (B H, chunks, D)
  float* z;     // (B H, Sp, D): dh C~^T
  float* dkp;   // (B H, Sp, D): the rows pass's share of dk
  float* dvp;   // (B H, Sp, D): and of dv
  float* pos;   // (8, B H, Sp): cumF, g, a / dd, a ds, dcum, dli by row pass
  float* qzp;   // (B H, Sp, tiles): q . Z by column tile
  float* dwp;   // (B H, Sp, tiles): k . (v dC~'^T + dn~') by column tile
  float* m_in;  // (B H, chunks)
  float* ddp;   // (B H, chunks, pass blocks): <dC~', C~> + <dn~', n~> by block
  float* fin;   // (B H, pass blocks): <dC, C_final> + <dn, n_final> by block
  float* dm0p;  // (B H): sum of d log a over chunk 0
};

enum Pos { kCum = 0, kG, kCoefA, kCoefN, kDcum, kDli, kPosRows = 8 };

__device__ __forceinline__ float ld(const void* p, int64_t i, bool bf) {
  return bf ? __bfloat162float(static_cast<const bf16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, int64_t i, float v, bool bf) {
  if (bf) {
    static_cast<bf16*>(p)[i] = __float2bfloat16(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// Row of a tile held in register i of thread row ty of the 16 x 16
// threads: groups of four, 64 apart, so a thread reads its four A values as
// one float4 from shared memory.  Columns stay interleaved (tx + 16 j), so
// neighbouring threads store neighbouring columns.
__device__ __forceinline__ int tile_at(int t, int i) { return (i / 4) * 64 + t * 4 + i % 4; }

// acc[i][j] += sum_{k < K} A(tile_at(ty, i), k) B(k, tx + 16 j), ty =
// tid / 16, tx = tid % 16.  A and B come through loaders la(m, k) and
// lb(k, n), which return 0 outside their operand, into 16-byte aligned
// shared tiles of kKB values of k (As [kKB][BM + 4], Bs [kKB][BN + 4]).
// kAK / kBK: the loader walks k fastest (an operand contiguous along k),
// else m / n.
template <int BM, int BN, bool kAK, bool kBK, class LA, class LB>
__device__ __forceinline__ void gemm(float (&acc)[BM / 16][BN / 16], int K, LA la,
                                     LB lb, float* As, float* Bs) {
  constexpr int TM = BM / 16, TN = BN / 16, LA_ = BM + 4, LB_ = BN + 4;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  for (int k0 = 0; k0 < K; k0 += kKB) {
    for (int i = tid; i < kKB * BM; i += kThreads) {
      const int m = kAK ? i / kKB : i % BM;
      const int k = kAK ? i % kKB : i / BM;
      As[k * LA_ + m] = k0 + k < K ? la(m, k0 + k) : 0.f;
    }
    for (int i = tid; i < kKB * BN; i += kThreads) {
      const int n = kBK ? i / kKB : i % BN;
      const int k = kBK ? i % kKB : i / BN;
      Bs[k * LB_ + n] = k0 + k < K ? lb(k0 + k, n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kKB; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(As + k * LA_ + g * 64 + ty * 4);
        a[4 * g] = v.x;
        a[4 * g + 1] = v.y;
        a[4 * g + 2] = v.z;
        a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k * LB_ + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
}

// The sum over the 16 threads of a row of the 16 x 16 grid (one half-warp).
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int d = 8; d >= 1; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// The sum over a block of one value a thread, in a fixed order (the result
// on thread 0).  red: 8 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  }
  return s;
}

// Row r of chunk c of (b, h) = bh: its position and whether it lies in S.
struct Chunk {
  int bh, b, h, c, s0;
  int64_t bhc;   // (b h, chunk)
  int64_t row0;  // bh * Sp + s0: the chunk's first row in per-position scratch
};

__device__ __forceinline__ Chunk chunk_of(int64_t bhc, const Dims& d) {
  Chunk ch;
  ch.bhc = bhc;
  ch.bh = static_cast<int>(bhc / d.n_chunks);
  ch.c = static_cast<int>(bhc % d.n_chunks);
  ch.b = ch.bh / d.heads;
  ch.h = ch.bh % d.heads;
  ch.s0 = ch.c * d.chunk;
  ch.row0 = static_cast<int64_t>(ch.bh) * d.n_chunks * d.chunk + ch.s0;
  return ch;
}

__device__ __forceinline__ int64_t off(const int64_t* s, int b, int pos, int h) {
  return b * s[0] + static_cast<int64_t>(pos) * s[1] + h * s[2];
}

__device__ __forceinline__ float* pos_row(const Scratch& w, int which, const Dims& d) {
  return w.pos + which * static_cast<int64_t>(d.batch) * d.heads * d.n_chunks * d.chunk;
}

// u_r = li_r - cumF_r of chunk row r (li past S reads as -1e30).
__device__ __forceinline__ float u_of(const float* li, const Strides& st_,
                                      const Scratch& w, const Chunk& ch, int r,
                                      const Dims& d) {
  const int s = ch.s0 + r;
  const float l = s < d.seq ? li[off(st_.li, ch.b, s, ch.h)] : kNegInf;
  return l - pos_row(w, kCum, d)[ch.row0 + r];
}

// ---------------------------------------------------------------------------
// 1. Gates
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32)
gates_kernel(const float* __restrict__ lf, const float* __restrict__ li,
             const float* __restrict__ m0, Strides st_, Scratch w, Dims d) {
  const int bh = blockIdx.x, b = bh / d.heads, h = bh % d.heads;
  const int lane = threadIdx.x, Q = d.chunk;
  float* cum_out = pos_row(w, kCum, d);
  float* g_out = pos_row(w, kG, d);
  float m = m0 != nullptr ? m0[bh] : kNegInf;
  for (int c = 0; c < d.n_chunks; ++c) {
    const int s0 = c * Q;
    float cv[4], uv[4];
    float run = 0.f, mx = kLowest;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = lane * 4 + k, s = s0 + r;
      const bool in = s < d.seq;
      run += (r < Q && in) ? lf[off(st_.lf, b, s, h)] : 0.f;
      cv[k] = run;
      const float l = in ? li[off(st_.li, b, s, h)] : kNegInf;
      uv[k] = r < Q ? l - run : kLowest;  // the offset is added below
    }
    float offset = run;
#pragma unroll
    for (int dd = 1; dd < 32; dd <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, offset, dd);
      if (lane >= dd) offset += up;
    }
    offset -= run;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      cv[k] += offset;
      if (lane * 4 + k < Q) uv[k] -= offset;
      mx = fmaxf(mx, uv[k]);
      uv[k] = mx;  // the running max within the lane
    }
    float before = mx;  // the max over this lane and the ones before it
#pragma unroll
    for (int dd = 1; dd < 32; dd <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, before, dd);
      if (lane >= dd) before = fmaxf(before, up);
    }
    float prev = __shfl_up_sync(0xffffffffu, before, 1);
    if (lane == 0) prev = kLowest;
    float g_end = 0.f, cum_end = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = lane * 4 + k;
      const float g = fmaxf(m, fmaxf(prev, uv[k]));
      if (r < Q) {
        cum_out[(int64_t)bh * d.n_chunks * Q + s0 + r] = cv[k];
        g_out[(int64_t)bh * d.n_chunks * Q + s0 + r] = g;
      }
      if (r == Q - 1) {
        g_end = g;
        cum_end = cv[k];
      }
    }
    g_end = __shfl_sync(0xffffffffu, g_end, (Q - 1) / 4);
    cum_end = __shfl_sync(0xffffffffu, cum_end, (Q - 1) / 4);
    if (lane == 0) w.m_in[(int64_t)bh * d.n_chunks + c] = m;
    m = cum_end + g_end;
  }
}

// ---------------------------------------------------------------------------
// 2 and 6. Outer-product sums over a chunk's rows
// ---------------------------------------------------------------------------

// mode 0: out = sum_r wgt_r k_r (x) v_r, nout = sum_r wgt_r k_r (the chunk's
// update); mode 1: out = sum_r (a_r / dd_r) q_r (x) dh_r, nout = sum_r a_r
// ds_r q_r (the local gradient of the entering state).
__global__ void __launch_bounds__(kThreads, 2)
outer_kernel(int mode, const void* __restrict__ qp, const void* __restrict__ kp,
             const void* __restrict__ vp, const float* __restrict__ dh,
             const float* __restrict__ li, Strides st_, Scratch w, Dims d) {
  __shared__ __align__(16) float As[kKB * (kT + 4)];
  __shared__ __align__(16) float Bs[kKB * (kT + 4)];
  __shared__ float wt[kT], wn[kT];
  const Chunk ch = chunk_of(blockIdx.x, d);
  const int d0 = blockIdx.y * kT, e0 = blockIdx.z * kT;
  const int D = d.hd, Q = d.chunk;
  const int R = min(Q, d.seq - ch.s0);
  const bool bf = d.bf;
  if (threadIdx.x < Q) {
    const int r = threadIdx.x;
    if (mode == 0) {
      const float g_end = pos_row(w, kG, d)[ch.row0 + Q - 1];
      wt[r] = expf(u_of(li, st_, w, ch, r, d) - g_end);
      wn[r] = wt[r];
    } else {
      wt[r] = pos_row(w, kCoefA, d)[ch.row0 + r];
      wn[r] = pos_row(w, kCoefN, d)[ch.row0 + r];
    }
  }
  __syncthreads();
  const void* xp = mode == 0 ? kp : qp;
  const int64_t xo = mode == 0 ? off(st_.k, ch.b, ch.s0, ch.h) : off(st_.q, ch.b, ch.s0, ch.h);
  const int64_t xs = mode == 0 ? st_.k[1] : st_.q[1];
  float acc[8][8];
  zero(acc);
  if (mode == 0) {
    const int64_t vo = off(st_.v, ch.b, ch.s0, ch.h);
    gemm<kT, kT, false, false>(
        acc, R,
        [&](int i, int r) { return d0 + i < D ? wt[r] * ld(xp, xo + r * xs + d0 + i, bf) : 0.f; },
        [&](int r, int j) { return e0 + j < D ? ld(vp, vo + r * st_.v[1] + e0 + j, bf) : 0.f; },
        As, Bs);
  } else {
    const int64_t ho = off(st_.dh, ch.b, ch.s0, ch.h);
    gemm<kT, kT, false, false>(
        acc, R,
        [&](int i, int r) { return d0 + i < D ? wt[r] * ld(xp, xo + r * xs + d0 + i, bf) : 0.f; },
        [&](int r, int j) { return e0 + j < D ? dh[ho + r * st_.dh[1] + e0 + j] : 0.f; },
        As, Bs);
  }
  float* out = (mode == 0 ? w.cst : w.gst) + ch.bhc * D * D;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int dd = d0 + tile_at(ty, i), e = e0 + tx + 16 * j;
      if (dd < D && e < D) out[static_cast<int64_t>(dd) * D + e] = acc[i][j];
    }
  }
  if (blockIdx.z == 0 && threadIdx.x < kT && d0 + threadIdx.x < D) {
    const int dd = d0 + threadIdx.x;
    float s = 0.f;
    for (int r = 0; r < R; ++r) s = fmaf(wn[r], ld(xp, xo + r * xs + dd, bf), s);
    (mode == 0 ? w.nst : w.gn)[ch.bhc * D + dd] = s;
  }
}

// ---------------------------------------------------------------------------
// 3 and 7. State passes, elementwise
// ---------------------------------------------------------------------------

__device__ __forceinline__ float chunk_decay(const Scratch& w, int bh, int c, const Dims& d) {
  const float g_end = pos_row(w, kG, d)[(static_cast<int64_t>(bh) * d.n_chunks + c) * d.chunk +
                                        d.chunk - 1];
  return expf(w.m_in[static_cast<int64_t>(bh) * d.n_chunks + c] - g_end);
}

// Block x < pass_blocks - 1 owns elements [1024 x, 1024 x + 1024) of each
// chunk's D x D slab, the last block the D of n~; thread t the four elements
// from 4 t, as one float4 (D is a multiple of 32 and every slab starts 16
// bytes aligned), with the next chunk's loaded while this one's is used.
// forward: slab[c] <- the state entering chunk c (from init or 0), and
// fin = <dfinal, final state> by block.  reverse: slab[c] <- the gradient
// of the state leaving chunk c (from dfinal or 0), dot[c] = <that, the
// entering state> by block, and dinit = the entering state's gradient.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <bool kReverse>
__global__ void __launch_bounds__(kThreads)
pass_kernel(Scratch w, const float* __restrict__ c_init, const float* __restrict__ n_init,
            const float* __restrict__ dc_final, const float* __restrict__ dn_final,
            float* __restrict__ dc0, float* __restrict__ dn0, Dims d) {
  __shared__ float red[kThreads / 32];
  const int bh = blockIdx.y, nc = d.n_chunks;
  const bool is_n = blockIdx.x == d.pass_blocks - 1;
  const int64_t size = is_n ? d.hd : static_cast<int64_t>(d.hd) * d.hd;
  const int64_t e = (is_n ? 0 : static_cast<int64_t>(blockIdx.x) * kPassElems) + 4 * threadIdx.x;
  const bool own = e < size;
  float* slab = (kReverse ? (is_n ? w.gn : w.gst) : (is_n ? w.nst : w.cst)) +
                static_cast<int64_t>(bh) * nc * size + e;
  const float* other = (is_n ? w.nst : w.cst) + static_cast<int64_t>(bh) * nc * size + e;
  const float* init = kReverse ? (is_n ? dn_final : dc_final) : (is_n ? n_init : c_init);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float run[4] = {0.f, 0.f, 0.f, 0.f};
  if (init != nullptr && own) {
#pragma unroll
    for (int i = 0; i < 4; ++i) run[i] = init[bh * size + e + i];
  }
  const int c0 = kReverse ? nc - 1 : 0;
  float4 cur = own ? ld4(slab + c0 * size) : zero4;
  float4 ocur = (kReverse && own) ? ld4(other + c0 * size) : zero4;
  float dcur = chunk_decay(w, bh, c0, d);
  for (int t = 0; t < nc; ++t) {
    const int c = kReverse ? nc - 1 - t : t;
    float4 nxt = zero4, onxt = zero4;
    float dnxt = 0.f;
    if (t + 1 < nc) {
      const int cn = kReverse ? c - 1 : c + 1;
      if (own) {
        nxt = ld4(slab + cn * size);
        if (kReverse) onxt = ld4(other + cn * size);
      }
      dnxt = chunk_decay(w, bh, cn, d);
    }
    float dot = 0.f;
    if (own) {
      if (kReverse) {
        dot = fmaf(run[0], ocur.x, fmaf(run[1], ocur.y, fmaf(run[2], ocur.z, run[3] * ocur.w)));
      }
      *reinterpret_cast<float4*>(slab + c * size) = make_float4(run[0], run[1], run[2], run[3]);
      run[0] = fmaf(dcur, run[0], cur.x);
      run[1] = fmaf(dcur, run[1], cur.y);
      run[2] = fmaf(dcur, run[2], cur.z);
      run[3] = fmaf(dcur, run[3], cur.w);
    }
    if (kReverse) {
      const float total = block_sum(dot, red);
      if (threadIdx.x == 0) {
        w.ddp[(static_cast<int64_t>(bh) * nc + c) * d.pass_blocks + blockIdx.x] = total;
      }
    }
    cur = nxt;
    ocur = onxt;
    dcur = dnxt;
  }
  if (kReverse) {
    float* dinit = is_n ? dn0 : dc0;
    if (dinit != nullptr && own) {
#pragma unroll
      for (int i = 0; i < 4; ++i) dinit[bh * size + e + i] = run[i];
    }
  } else {
    const float* dfin = is_n ? dn_final : dc_final;
    float dot = 0.f;
    if (dfin != nullptr && own) {
#pragma unroll
      for (int i = 0; i < 4; ++i) dot = fmaf(dfin[bh * size + e + i], run[i], dot);
    }
    const float total = block_sum(dot, red);
    if (threadIdx.x == 0) w.fin[static_cast<int64_t>(bh) * d.pass_blocks + blockIdx.x] = total;
  }
}

// ---------------------------------------------------------------------------
// 4. Z = dh C~^T, and q . Z by column tile
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 2)
z_kernel(const void* __restrict__ qp, const float* __restrict__ dh, Strides st_,
         Scratch w, Dims d) {
  __shared__ __align__(16) float As[kKB * (kT + 4)];
  __shared__ __align__(16) float Bs[kKB * (kT + 4)];
  const Chunk ch = chunk_of(blockIdx.x, d);
  const int t = blockIdx.y, d0 = t * kT;
  const int D = d.hd;
  const int R = min(d.chunk, d.seq - ch.s0);
  const float* C = w.cst + ch.bhc * D * D;
  const int64_t ho = off(st_.dh, ch.b, ch.s0, ch.h);
  const int64_t qo = off(st_.q, ch.b, ch.s0, ch.h);
  float acc[8][8];
  zero(acc);
  gemm<kT, kT, true, true>(
      acc, D, [&](int r, int e) { return r < R ? dh[ho + r * st_.dh[1] + e] : 0.f; },
      [&](int e, int j) { return d0 + j < D ? C[static_cast<int64_t>(d0 + j) * D + e] : 0.f; },
      As, Bs);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tile_at(ty, i);
    float qz = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int dd = d0 + tx + 16 * j;
      if (r < d.chunk && dd < D) {
        w.z[(ch.row0 + r) * D + dd] = acc[i][j];
        if (r < R) qz = fmaf(ld(qp, qo + r * st_.q[1] + dd, d.bf), acc[i][j], qz);
      }
    }
    qz = row_sum(qz);
    if (tx == 0 && r < d.chunk) w.qzp[(ch.row0 + r) * d.tiles + t] = qz;
  }
}

// ---------------------------------------------------------------------------
// 5. Rows: the Q x Q matrices, the denominators, dq and the Q x Q shares of
//    dk and dv
// ---------------------------------------------------------------------------

constexpr int kRowsSmem =
    (2 * kT * kLd + kKB * (kT + 4) * 2 + 16 * kT + 12 * kT + kThreads / 32) * 4;

__global__ void __launch_bounds__(kThreads)
rows_kernel(const void* __restrict__ qp, const void* __restrict__ kp,
            const void* __restrict__ vp, const float* __restrict__ dh,
            const float* __restrict__ li, void* __restrict__ dq, Strides st_, Scratch w,
            Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* Ws = smem;              // W, then kept for W^T (dh / dd); every
                                 // array below starts 16 bytes aligned
  float* dSs = Ws + kT * kLd;    // dS = dW (.) D
  float* As = dSs + kT * kLd;
  float* Bs = As + kKB * (kT + 4);
  float* colp = Bs + kKB * (kT + 4);
  float* gv = colp + 16 * kT;    // g
  float* uv = gv + kT;           // u
  float* av = uv + kT;           // a
  float* flv = av + kT;          // the floor exp(-M)
  float* rsw = flv + kT;         // row sums of W
  float* hvv = rsw + kT;         // sum_j W_qj (dh v^T)_qj
  float* qnv = hvv + kT;         // q . n~
  float* qzv = qnv + kT;         // q . Z
  float* rinv = qzv + kT;        // 1 / dd
  float* dsv = rinv + kT;        // ds
  float* prow = dsv + kT;        // P by row
  float* dlv = prow + kT;        // d log a
  float* red = dlv + kT;
  const Chunk ch = chunk_of(blockIdx.x, d);
  const int D = d.hd, Q = d.chunk;
  const int R = min(Q, d.seq - ch.s0);
  const bool bf = d.bf;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float m_in = w.m_in[ch.bhc];
  const float* nin = w.nst + ch.bhc * D;
  const int64_t qo = off(st_.q, ch.b, ch.s0, ch.h);
  const int64_t ko = off(st_.k, ch.b, ch.s0, ch.h);
  const int64_t vo = off(st_.v, ch.b, ch.s0, ch.h);
  const int64_t ho = off(st_.dh, ch.b, ch.s0, ch.h);
  if (threadIdx.x < kT) {
    const int r = threadIdx.x;
    if (r < Q) {
      const float cum = pos_row(w, kCum, d)[ch.row0 + r];
      const float g = pos_row(w, kG, d)[ch.row0 + r];
      gv[r] = g;
      uv[r] = u_of(li, st_, w, ch, r, d);
      av[r] = expf(m_in - g);
      flv[r] = expf(-(cum + g));
      float qz = 0.f;
      for (int t = 0; t < d.tiles; ++t) qz += w.qzp[(ch.row0 + r) * d.tiles + t];
      qzv[r] = qz;
    } else {
      gv[r] = 0.f;
      uv[r] = kNegInf;
      av[r] = flv[r] = qzv[r] = 0.f;
    }
  }
  // q . n~, a warp a row
  for (int r = warp; r < kT; r += kThreads / 32) {
    float s = 0.f;
    if (r < R) {
      for (int e = lane; e < D; e += 32) s = fmaf(ld(qp, qo + r * st_.q[1] + e, bf), nin[e], s);
    }
    s = warp_sum(s);
    if (lane == 0) qnv[r] = s;
  }
  __syncthreads();
  float acc[8][8];
  // S = q k^T, then W = S (.) D into shared memory, and its row sums
  zero(acc);
  gemm<kT, kT, true, true>(
      acc, D, [&](int r, int e) { return r < R ? ld(qp, qo + r * st_.q[1] + e, bf) : 0.f; },
      [&](int e, int j) { return j < R ? ld(kp, ko + j * st_.k[1] + e, bf) : 0.f; }, As, Bs);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tile_at(ty, i);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int jj = tx + 16 * j;
      // exp(u_j - g_q) only for j <= q: above the diagonal it may overflow
      const float wv = jj <= r ? acc[i][j] * expf(uv[jj] - gv[r]) : 0.f;
      Ws[r * kLd + jj] = wv;
      rs += wv;
    }
    rs = row_sum(rs);
    if (tx == 0) rsw[r] = rs;
  }
  // dh v^T; sum_j W_qj (dh v^T)_qj
  zero(acc);
  gemm<kT, kT, true, true>(
      acc, D, [&](int r, int e) { return r < R ? dh[ho + r * st_.dh[1] + e] : 0.f; },
      [&](int e, int j) { return j < R ? ld(vp, vo + j * st_.v[1] + e, bf) : 0.f; }, As, Bs);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tile_at(ty, i);
    float hv = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) hv = fmaf(Ws[r * kLd + tx + 16 * j], acc[i][j], hv);
    hv = row_sum(hv);
    if (tx == 0) hvv[r] = hv;
  }
  __syncthreads();
  // the denominators: s = sum_j W + a q.n~, dd = max(|s|, floor); dh . num =
  // hv + a q.Z; ds = -(dh . num) / dd^2 sign(s) where |s| wins, else 0
  if (threadIdx.x < kT) {
    const int r = threadIdx.x;
    const float s = rsw[r] + av[r] * qnv[r];
    const float den = fabsf(s);
    const float dd = fmaxf(den, flv[r]);
    const float ri = r < Q ? 1.f / dd : 0.f;
    const float dnum = hvv[r] + av[r] * qzv[r];
    const float ds = (r < Q && den > flv[r]) ? -dnum * ri * ri * (s > 0.f ? 1.f : -1.f) : 0.f;
    rinv[r] = ri;
    dsv[r] = ds;
    const float ca = av[r] * ri, cn = av[r] * ds;
    dlv[r] = ca * qzv[r] + cn * qnv[r];
    if (r < Q) {
      pos_row(w, kCoefA, d)[ch.row0 + r] = ca;
      pos_row(w, kCoefN, d)[ch.row0 + r] = cn;
    }
  }
  __syncthreads();
  // dW = (dh v^T) / dd + ds (j <= q); P = dW (.) W; dS = dW (.) D
  float cols[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) cols[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tile_at(ty, i);
    float pr = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int jj = tx + 16 * j;
      float dS = 0.f;
      if (jj <= r) {
        const float dW = fmaf(acc[i][j], rinv[r], dsv[r]);
        const float p = dW * Ws[r * kLd + jj];
        pr += p;
        cols[j] += p;
        dS = dW * expf(uv[jj] - gv[r]);
      }
      dSs[r * kLd + jj] = dS;
    }
    pr = row_sum(pr);
    if (tx == 0) prow[r] = pr;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) colp[ty * kT + tx + 16 * j] = cols[j];
  __syncthreads();
  if (threadIdx.x < kT) {
    const int r = threadIdx.x;
    float pc = 0.f;
    for (int y = 0; y < 16; ++y) pc += colp[y * kT + r];
    if (r < Q) {
      pos_row(w, kDcum, d)[ch.row0 + r] = prow[r] - pc + dlv[r];
      pos_row(w, kDli, d)[ch.row0 + r] = pc;
    }
  }
  if (ch.c == 0 && warp == 0) {
    float s = 0.f;
    for (int r = lane; r < kT; r += 32) s += dlv[r];
    s = warp_sum(s);
    if (lane == 0) w.dm0p[ch.bh] = s;
  }
  // dq = dS k + (a / dd) Z + a ds n~; the shares dS^T q (dk) and
  // W^T (dh / dd) (dv); 128 columns at a time
  const int64_t out0 = ((static_cast<int64_t>(ch.b) * d.seq + ch.s0) * d.heads + ch.h) * D;
  const int64_t ostride = static_cast<int64_t>(d.heads) * D;
  for (int t = 0; t < d.tiles; ++t) {
    const int c0 = t * kT;
    zero(acc);
    gemm<kT, kT, true, false>(
        acc, R, [&](int r, int j) { return dSs[r * kLd + j]; },
        [&](int j, int e) { return c0 + e < D ? ld(kp, ko + j * st_.k[1] + c0 + e, bf) : 0.f; },
        As, Bs);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = tile_at(ty, i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = c0 + tx + 16 * j;
        if (r < R && e < D) {
          const float v = acc[i][j] + av[r] * rinv[r] * w.z[(ch.row0 + r) * D + e] +
                          av[r] * dsv[r] * nin[e];
          st(dq, out0 + r * ostride + e, v, bf);
        }
      }
    }
    zero(acc);
    gemm<kT, kT, false, false>(
        acc, R, [&](int j, int r) { return dSs[r * kLd + j]; },
        [&](int r, int e) { return c0 + e < D ? ld(qp, qo + r * st_.q[1] + c0 + e, bf) : 0.f; },
        As, Bs);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = tile_at(ty, i), e = c0 + tx + 16 * j;
        if (r < Q && e < D) w.dkp[(ch.row0 + r) * D + e] = acc[i][j];
      }
    }
    zero(acc);
    gemm<kT, kT, false, false>(
        acc, R, [&](int j, int r) { return Ws[r * kLd + j]; },
        [&](int r, int e) { return c0 + e < D ? rinv[r] * dh[ho + r * st_.dh[1] + c0 + e] : 0.f; },
        As, Bs);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = tile_at(ty, i), e = c0 + tx + 16 * j;
        if (r < Q && e < D) w.dvp[(ch.row0 + r) * D + e] = acc[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 8. The state's shares of dk and dv, and of the chunk-end weights
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 2)
dstate_kernel(const void* __restrict__ kp, const void* __restrict__ vp,
              const float* __restrict__ li, void* __restrict__ dk, void* __restrict__ dv,
              Strides st_, Scratch w, Dims d) {
  __shared__ __align__(16) float As[kKB * (kT + 4)];
  __shared__ __align__(16) float Bs[kKB * (kT + 4)];
  __shared__ float wt[kT];
  const Chunk ch = chunk_of(blockIdx.x, d);
  const int t = blockIdx.y, c0 = t * kT;
  const int D = d.hd, Q = d.chunk;
  const int R = min(Q, d.seq - ch.s0);
  const bool bf = d.bf;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  if (threadIdx.x < kT) {
    const int r = threadIdx.x;
    const float g_end = pos_row(w, kG, d)[ch.row0 + Q - 1];
    wt[r] = r < R ? expf(u_of(li, st_, w, ch, r, d) - g_end) : 0.f;
  }
  __syncthreads();
  const float* dC = w.gst + ch.bhc * D * D;  // the leaving state's gradient
  const float* dn = w.gn + ch.bhc * D;
  const int64_t ko = off(st_.k, ch.b, ch.s0, ch.h);
  const int64_t vo = off(st_.v, ch.b, ch.s0, ch.h);
  const int64_t out0 = ((static_cast<int64_t>(ch.b) * d.seq + ch.s0) * d.heads + ch.h) * D;
  const int64_t ostride = static_cast<int64_t>(d.heads) * D;
  float acc[8][8];
  // (v dC~'^T)[r, c] + dn~'[c]: dk += wgt_r times it; k . it by tile
  zero(acc);
  gemm<kT, kT, true, true>(
      acc, D, [&](int r, int e) { return r < R ? ld(vp, vo + r * st_.v[1] + e, bf) : 0.f; },
      [&](int e, int j) { return c0 + j < D ? dC[static_cast<int64_t>(c0 + j) * D + e] : 0.f; },
      As, Bs);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tile_at(ty, i);
    float kd = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = c0 + tx + 16 * j;
      if (r < R && e < D) {
        const float v = acc[i][j] + dn[e];
        kd = fmaf(ld(kp, ko + r * st_.k[1] + e, bf), v, kd);
        st(dk, out0 + r * ostride + e, w.dkp[(ch.row0 + r) * D + e] + wt[r] * v, bf);
      }
    }
    kd = row_sum(kd);
    if (tx == 0 && r < Q) w.dwp[(ch.row0 + r) * d.tiles + t] = kd;
  }
  // (k dC~')[r, c]: dv += wgt_r times it
  zero(acc);
  gemm<kT, kT, true, false>(
      acc, D, [&](int r, int e) { return r < R ? ld(kp, ko + r * st_.k[1] + e, bf) : 0.f; },
      [&](int e, int j) { return c0 + j < D ? dC[static_cast<int64_t>(e) * D + c0 + j] : 0.f; },
      As, Bs);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = tile_at(ty, i), e = c0 + tx + 16 * j;
      if (r < R && e < D) {
        st(dv, out0 + r * ostride + e, w.dvp[(ch.row0 + r) * D + e] + wt[r] * acc[i][j], bf);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 9. Last gates: dlf, dli, the final m's path, the entering m's gradient
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32)
final_kernel(const float* __restrict__ li, const float* __restrict__ dm_final,
             float* __restrict__ dlf, float* __restrict__ dli, float* __restrict__ dm0,
             Strides st_, Scratch w, Dims d) {
  const int bh = blockIdx.x, b = bh / d.heads, h = bh % d.heads;
  const int lane = threadIdx.x, Q = d.chunk, nc = d.n_chunks;
  // the final m's total gradient: asked, less <dC, C_final> + <dn, n_final>
  float fin = 0.f;
#pragma unroll 8
  for (int i = lane; i < d.pass_blocks; i += 32) {
    fin += w.fin[static_cast<int64_t>(bh) * d.pass_blocks + i];
  }
  fin = warp_sum(fin);
  float chain = (dm_final != nullptr ? dm_final[bh] : 0.f) - fin;
  for (int c = nc - 1; c >= 0; --c) {
    const Chunk ch = chunk_of(static_cast<int64_t>(bh) * nc + c, d);
    const float m_in = w.m_in[ch.bhc];
    const float g_end = pos_row(w, kG, d)[ch.row0 + Q - 1];
    const float decay = expf(m_in - g_end);
    float dot = 0.f;
#pragma unroll 8
    for (int i = lane; i < d.pass_blocks; i += 32) dot += w.ddp[ch.bhc * d.pass_blocks + i];
    const float dlogdecay = decay * warp_sum(dot);
    float dcum[4], dl[4];
    float wsum = 0.f, umax = kLowest;
    int jmax = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = lane * 4 + k;
      dcum[k] = dl[k] = 0.f;
      if (r < Q) {
        const float u = u_of(li, st_, w, ch, r, d);
        float dwg = 0.f;
        for (int t = 0; t < d.tiles; ++t) dwg += w.dwp[(ch.row0 + r) * d.tiles + t];
        const float dlw = expf(u - g_end) * dwg;
        dl[k] = pos_row(w, kDli, d)[ch.row0 + r] + dlw;
        dcum[k] = pos_row(w, kDcum, d)[ch.row0 + r] - dlw;
        wsum += dlw;
        if (u > umax) {
          umax = u;
          jmax = r;
        }
      }
    }
    wsum = warp_sum(wsum);
    // the first position that reaches the chunk's max of u
#pragma unroll
    for (int dd = 16; dd >= 1; dd >>= 1) {
      const float ou = __shfl_xor_sync(0xffffffffu, umax, dd);
      const int oj = __shfl_xor_sync(0xffffffffu, jmax, dd);
      if (ou > umax || (ou == umax && oj < jmax)) {
        umax = ou;
        jmax = oj;
      }
    }
    const bool won = umax > m_in;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = lane * 4 + k;
      if (r == Q - 1) dcum[k] += wsum + dlogdecay + chain;
      if (won && r == jmax) {
        dl[k] += chain;
        dcum[k] -= chain;
      }
    }
    if (won) chain = 0.f;
    // dlf = the reverse prefix sum of dcum within the chunk
    float run = 0.f;
#pragma unroll
    for (int k = 3; k >= 0; --k) {
      run += dcum[k];
      dcum[k] = run;
    }
    float offset = run;
#pragma unroll
    for (int dd = 1; dd < 32; dd <<= 1) {
      const float down = __shfl_down_sync(0xffffffffu, offset, dd);
      if (lane + dd < 32) offset += down;
    }
    offset -= run;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = lane * 4 + k, s = ch.s0 + r;
      if (r < Q && s < d.seq) {
        const int64_t o = (static_cast<int64_t>(b) * d.seq + s) * d.heads + h;
        dlf[o] = dcum[k] + offset;
        dli[o] = dl[k];
      }
    }
    if (c == 0 && dm0 != nullptr && lane == 0) dm0[bh] = w.dm0p[bh] + dlogdecay + chain;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// q, k, v (B, S, H, D) bf16 or f32 with unit D stride; lf, li (B, S, H) f32;
// c0 (B, H, D, D), n0 (B, H, D), m0 (B, H) f32 contiguous or all null; dh
// (B, S, H, D) f32 with unit D stride; dc, dn, dm: the final state's
// gradients, f32 contiguous or null.  out: dq, dk, dv (B, S, H, D) in q's
// dtype, dlf, dli (B, S, H) f32, dc0, dn0, dm0 f32 (null without c0), all
// contiguous; scratch: f32, as many elements as repro_torch/kernels/
// mlstm_scan_bwd.py::scratch_floats.  strides: 18 element strides, (b, s, h)
// of q, k, v, dh, lf, li.  dtype (q, k, v, dq, dk, dv): 0 float32, 1
// bfloat16.  D a multiple of 32 up to 1024; 1 <= chunk <= 128.
extern "C" int repro_mlstm_scan_bwd(
    const void* q, const void* k, const void* v, const void* lf, const void* li,
    const void* c0, const void* n0, const void* m0, const void* dh, const void* dc,
    const void* dn, const void* dm, void* dq, void* dk, void* dv, void* dlf, void* dli,
    void* dc0, void* dn0, void* dm0, void* scratch, const int64_t* strides, int batch,
    int seq, int heads, int hd, int chunk, int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0) return 0;
  const int n_chunks = (seq + chunk - 1) / chunk;
  const int64_t bhc = static_cast<int64_t>(batch) * heads * n_chunks;
  if (chunk < 1 || chunk > kT || hd < 32 || hd % 32 || hd > 1024 || bhc > (1LL << 31) - 1 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Strides st_;
  for (int i = 0; i < 3; ++i) {
    st_.q[i] = strides[i];
    st_.k[i] = strides[3 + i];
    st_.v[i] = strides[6 + i];
    st_.dh[i] = strides[9 + i];
    st_.lf[i] = strides[12 + i];
    st_.li[i] = strides[15 + i];
  }
  const int tiles = (hd + kT - 1) / kT;
  const int pass_blocks =
      static_cast<int>((static_cast<int64_t>(hd) * hd + kPassElems - 1) / kPassElems) + 1;
  const Dims d{batch, seq, heads, hd, chunk, n_chunks, tiles, pass_blocks, dtype == 1};
  const int64_t bh = static_cast<int64_t>(batch) * heads;
  const int64_t sp = static_cast<int64_t>(n_chunks) * chunk;
  const int64_t dd = static_cast<int64_t>(hd) * hd;
  Scratch w;
  float* p = static_cast<float*>(scratch);
  w.cst = p;
  p += bhc * dd;
  w.gst = p;
  p += bhc * dd;
  w.nst = p;
  p += bhc * hd;
  w.gn = p;
  p += bhc * hd;
  w.z = p;
  p += bh * sp * hd;
  w.dkp = p;
  p += bh * sp * hd;
  w.dvp = p;
  p += bh * sp * hd;
  w.pos = p;
  p += bh * sp * kPosRows;
  w.qzp = p;
  p += bh * sp * tiles;
  w.dwp = p;
  p += bh * sp * tiles;
  w.m_in = p;
  p += bhc;
  w.ddp = p;
  p += bhc * pass_blocks;
  w.fin = p;
  p += bh * pass_blocks;
  w.dm0p = p;
  const auto* lf_f = static_cast<const float*>(lf);
  const auto* li_f = static_cast<const float*>(li);
  const auto* dh_f = static_cast<const float*>(dh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static const cudaError_t attr = allow_smem(rows_kernel, kRowsSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 outer_grid(static_cast<unsigned>(bhc), tiles, tiles);
  const dim3 tile_grid(static_cast<unsigned>(bhc), tiles);
  const dim3 pass_grid(pass_blocks, static_cast<unsigned>(bh));
  cudaError_t err;
#define REPRO_CHECK()                          \
  err = cudaGetLastError();                    \
  if (err != cudaSuccess) return static_cast<int>(err)
  gates_kernel<<<static_cast<unsigned>(bh), 32, 0, s>>>(
      lf_f, li_f, static_cast<const float*>(m0), st_, w, d);
  REPRO_CHECK();
  outer_kernel<<<outer_grid, kThreads, 0, s>>>(0, q, k, v, dh_f, li_f, st_, w, d);
  REPRO_CHECK();
  pass_kernel<false><<<pass_grid, kThreads, 0, s>>>(
      w, static_cast<const float*>(c0), static_cast<const float*>(n0),
      static_cast<const float*>(dc), static_cast<const float*>(dn), nullptr, nullptr, d);
  REPRO_CHECK();
  z_kernel<<<tile_grid, kThreads, 0, s>>>(q, dh_f, st_, w, d);
  REPRO_CHECK();
  rows_kernel<<<static_cast<unsigned>(bhc), kThreads, kRowsSmem, s>>>(q, k, v, dh_f, li_f,
                                                                      dq, st_, w, d);
  REPRO_CHECK();
  outer_kernel<<<outer_grid, kThreads, 0, s>>>(1, q, k, v, dh_f, li_f, st_, w, d);
  REPRO_CHECK();
  pass_kernel<true><<<pass_grid, kThreads, 0, s>>>(
      w, nullptr, nullptr, static_cast<const float*>(dc), static_cast<const float*>(dn),
      static_cast<float*>(dc0), static_cast<float*>(dn0), d);
  REPRO_CHECK();
  dstate_kernel<<<tile_grid, kThreads, 0, s>>>(k, v, li_f, dk, dv, st_, w, d);
  REPRO_CHECK();
  final_kernel<<<static_cast<unsigned>(bh), 32, 0, s>>>(
      li_f, static_cast<const float*>(dm), static_cast<float*>(dlf),
      static_cast<float*>(dli), static_cast<float*>(dm0), st_, w, d);
#undef REPRO_CHECK
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
