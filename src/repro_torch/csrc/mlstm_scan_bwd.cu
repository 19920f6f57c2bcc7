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
// Two routes (repro_torch/kernels/mlstm_scan_bwd.py::kernel_route):
//
//   * bf16 at head dims that are multiples of 64, namespace tc: kernels 2,
//     4, 5, 6 and 8 run their products on wgmma (m64n128k16 and m64n64k16,
//     bf16 in, f32 accumulate), two warpgroups a block.  q, k, v are exact
//     bf16; every f32 operand is split into hi = bf16(x) and lo = bf16(x -
//     hi), about 16 significant bits, with its row scalar (wgt, a / dd,
//     1 / dd) applied before the split, so a product of an exact operand
//     and a split one takes two bf16 products and one of two split operands
//     three (hi hi, hi lo, lo hi): the update (wgt k) x v, the local state
//     gradient q x (a / dd) dh, dh v^T, dS k, dS^T q, v dC~'^T and k dC~'
//     take two; Z = dh C~^T and W^T (dh / dd) three.  The state passes
//     (pass_parts_kernel) write each entering state and each leaving
//     state's gradient as bf16 hi and lo images of 128 x 64 panels in the
//     128-byte swizzle that the consumers' wgmma read (K-major for Z and
//     v dC~'^T, MN-major for k dC~'), so no consumer splits a 4 MiB state
//     again for each tile; the updates' slab then holds the gradients'
//     images.  Tiles of q, k, v come by 16-byte cp.async copies into the
//     same swizzle (zeros past S and past D), those of dh are read as f32,
//     scaled and split by the block; a chunk-update or state's-shares
//     block holds its 128 x 128 tile of C~ in accumulators, and the K loops
//     of Z, rows and the state's shares run through two stages, the next
//     step's copies and splits under this step's products.  The rows block
//     keeps W and dS as bf16 parts in shared memory (dq reads dS K-major,
//     dS^T q and W^T (dh / dd) read them MN-major) and skips the k16 steps
//     the causal triangle zeroes.  The gate kernels and the state passes'
//     recurrences stay on the CUDA cores in f32;
//   * f32, and bf16 at the other head dims: every product on the CUDA cores
//     in f32 (bf16 q, k, v widened as they are read), through one tiled
//     routine: shared tiles of 16 values of k, register tiles of 8 x 8
//     outputs a thread, each thread's rows in groups of four read as
//     float4s.
//
// No kernel uses atomics: every sum across blocks is written by block and
// added in a fixed order, so two calls give equal bits.  Positions past S
// read as identity steps (lf 0, li -1e30, zero q, k, v, dh).
//
// What bounds it: at xlstm-1.3b's train shape (B 1, S 4096, H 4, D 1024,
// chunks of 128, bf16) the function needs 5 Q D^2 + 2.5 Q^2 D
// multiply-adds a (b, h, chunk) on its causal triangles, ~183 GFLOP, 0.185
// ms at the bf16 tensor-core rate; it reads and writes ~270 MB (0.08 ms):
// the operations.  The tensor-core route runs ~400 GFLOP of split bf16
// products but moves the states through memory: the updates and local
// gradients (0.5 GiB each, f32) and their images (0.5 GiB each), ~3.5 GB
// in all, which bounds it near 1 ms at 3.35 TB/s; the SIMT route runs the
// products at the f32 rate of the CUDA cores (67 TFLOP/s at most).
// PERF.md gives the measured split by kernel.
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
  // the tensor-core route's states as bf16 parts (tc::part_image):
  float* cpart;  // (B H, chunks): the entering states
  float* gpart;  // (B H, chunks): the leaving states' gradients, over cst
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
      // exp(u_j - g_q) only for j <= q < Q: above the diagonal, and in the
      // rows past a short chunk (g read as 0 there), it may overflow
      const float wv = jj <= r && r < Q ? acc[i][j] * expf(uv[jj] - gv[r]) : 0.f;
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
      if (jj <= r && r < Q) {
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

// ---------------------------------------------------------------------------
// bf16 at head dims that are multiples of 64: the products on wgmma
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kPanel = 128 * 128;  // bytes of a 128 x 64 bf16 panel (128-byte rows)
constexpr int kHalf = kPanel / 2;  // bytes of its first or last 64 rows

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global memory into shared memory, asynchronously; src-size 0
// fills them with zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Generic-proxy writes to shared memory (stores, cp.async), made visible to
// wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The copies and stores of a stage are in and visible to every warpgroup's
// wgmma; every thread is past the previous stage.
__device__ __forceinline__ void stage_ready() {
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}
// A panel read K-major (rows are M or N, its 64 columns K) from k16 step kk,
// or MN-major (rows are K, 16 a step; its 64 columns M or N, and for N = 128
// the next 64 columns `lbo` bytes on).
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return make_desc(tile + kk * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk, uint32_t lbo = kPanel) {
  return make_desc(tile + kk * 2048, lbo, 1024);
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
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 128, f32) (+)= A (64 x 16) B (16 x 128), bf16 in shared memory;
// TA / TB 0: K-major, 1: MN-major (the transpose bits).
template <int TA, int TB>
__device__ __forceinline__ void wgmma128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
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
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), bf16 in shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
}

// x0, x1 -> bf16 hi = bf16(x), lo = bf16(x - hi), packed in pairs (the
// first value in the low half, as wgmma's fragments take them).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// hi + lo of a packed pair, back in f32.
__device__ __forceinline__ float2 join2(uint32_t hi, uint32_t lo) {
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  const float2 l = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo));
  return make_float2(h.x + l.x, h.y + l.y);
}

// Byte offset of element (row, col) of a panel of 128-byte rows in the
// 128-byte swizzle: 16-byte chunk c of row r sits at chunk c ^ (r % 8).
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + (((col >> 3) ^ (row & 7)) << 4) + ((col & 7) << 1);
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of an f32
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// Rows [0, n_rows) and columns [c0, c0 + 64) of a bf16 source (row stride
// `stride` elements, 16-byte aligned rows) into the panel at dst; zeros past
// n_rows and past n_cols.  The block's 256 threads issue 16-byte copies.
__device__ __forceinline__ void load_bf16(uint32_t dst, const bf16* __restrict__ src,
                                          int64_t stride, int n_rows, int c0, int n_cols) {
  for (int i = threadIdx.x; i < 128 * 8; i += kThreads) {
    const int r = i >> 3, k = (i & 7) * 8;
    const bool ok = r < n_rows && c0 + k < n_cols;
    cp_async16(dst + swz(r, k), ok ? src + r * stride + c0 + k : src, ok);
  }
}

// The same rows and columns of an f32 (kF32) or bf16 source, each row times
// scale[r] (when given), as a bf16 hi panel and a lo panel.  All of a
// thread's loads are issued before any is used.
template <bool kF32>
__device__ __forceinline__ void load_split(unsigned char* hi, unsigned char* lo,
                                           const void* __restrict__ src, int64_t stride,
                                           int n_rows, int c0, int n_cols,
                                           const float* scale) {
  if constexpr (kF32) {
    constexpr int kPer = 128 * 16 / kThreads;  // float4s a thread
    float4 v[kPer];
    const float* s = static_cast<const float*>(src);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int x = threadIdx.x + kThreads * i, r = x >> 4, k = (x & 15) * 4;
      v[i] = r < n_rows && c0 + k < n_cols
                 ? *reinterpret_cast<const float4*>(s + r * stride + c0 + k)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int x = threadIdx.x + kThreads * i, r = x >> 4, k = (x & 15) * 4;
      const float m = scale != nullptr && r < n_rows ? scale[r] : 1.f;
      uint2 h, l;
      split2(v[i].x * m, v[i].y * m, h.x, l.x);
      split2(v[i].z * m, v[i].w * m, h.y, l.y);
      *reinterpret_cast<uint2*>(hi + swz(r, k)) = h;
      *reinterpret_cast<uint2*>(lo + swz(r, k)) = l;
    }
  } else {
    constexpr int kPer = 128 * 8 / kThreads;  // 8-value vectors a thread
    uint4 v[kPer];
    const bf16* s = static_cast<const bf16*>(src);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int x = threadIdx.x + kThreads * i, r = x >> 3, k = (x & 7) * 8;
      v[i] = r < n_rows && c0 + k < n_cols
                 ? *reinterpret_cast<const uint4*>(s + r * stride + c0 + k)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int x = threadIdx.x + kThreads * i, r = x >> 3, k = (x & 7) * 8;
      const float m = scale != nullptr && r < n_rows ? scale[r] : 1.f;
      float f[8];
      unpack8(v[i], f);
      uint4 h, l;
      split2(f[0] * m, f[1] * m, h.x, l.x);
      split2(f[2] * m, f[3] * m, h.y, l.y);
      split2(f[4] * m, f[5] * m, h.z, l.z);
      split2(f[6] * m, f[7] * m, h.w, l.w);
      *reinterpret_cast<uint4*>(hi + swz(r, k)) = h;
      *reinterpret_cast<uint4*>(lo + swz(r, k)) = l;
    }
  }
}

// `bytes` of a panel image in global memory (already swizzled) into shared
// memory; zeros where `valid` is false.
__device__ __forceinline__ void copy_image(uint32_t dst, const unsigned char* src, int bytes,
                                           bool valid) {
  for (int i = threadIdx.x; i < bytes / 16; i += kThreads) {
    cp_async16(dst + 16 * i, valid ? src + 16 * i : src, valid);
  }
}

// The first 64 B of dynamic shared memory at a 1024-byte boundary (the
// 128-byte swizzle repeats every 1024 bytes).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// A thread's place in a warpgroup's accumulator: rows row0 and row0 + 8 of
// the 64 (plus 64 wg), columns 8 j + col0 (+ 1); element 4 j + 2 h + e is
// row row0 + 8 h, column 8 j + col0 + e.
struct Frag {
  int wg, row0, col0;
};
__device__ __forceinline__ Frag frag() {
  const int t = threadIdx.x, warp = (t % 128) / 32, lane = t % 32;
  return Frag{t / 128, 64 * (t / 128) + 16 * warp + lane / 4, 2 * (lane % 4)};
}

// The sum over the four lanes that share a row of an accumulator.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// The D x D states as parts: per chunk a hi image then a lo image, each
// (Dp / 128) x (D / 64) panels of 128 rows (d) x 64 columns (e), panel
// (dt, et) at (dt (D / 64) + et) kPanel; Dp is D up to a multiple of 128,
// its rows past D zero.  A part image's bytes: Dp D 2, so a chunk's parts
// take Dp D floats.
__device__ __forceinline__ int padded(int D) { return (D + 127) / 128 * 128; }
__device__ __forceinline__ uint32_t part_off(int64_t e, int D) {
  const int dd = static_cast<int>(e / D), c = static_cast<int>(e % D);
  return static_cast<uint32_t>(((dd >> 7) * (D >> 6) + (c >> 6)) * kPanel) +
         swz(dd & 127, c & 63);
}
__device__ __forceinline__ const unsigned char* part_image(const float* parts, int64_t bhc,
                                                           int D, bool lo) {
  const int64_t slab = static_cast<int64_t>(padded(D)) * D;  // floats a chunk
  return reinterpret_cast<const unsigned char*>(parts + bhc * slab) + (lo ? slab * 2 : 0);
}

// ---------------------------------------------------------------------------
// 2 and 6 on wgmma: one block per (b, h, chunk, 128 x 128 tile of C~), each
// warpgroup 64 of its rows, K = the chunk's rows.  mode 0: A = (wgt (.) k)^T
// split into hi + lo, B = v; mode 1: A = q^T, B = (a / dd) (.) dh split.
// Both read MN-major (rows of the panels are the chunk's positions).
// Shared memory: six panels, 96 KB (two blocks an SM).
// ---------------------------------------------------------------------------

constexpr int kOuterSmem = 1024 + 6 * kPanel;

__global__ void __launch_bounds__(kThreads, 2)
outer_tc_kernel(int mode, const bf16* __restrict__ qp, const bf16* __restrict__ kp,
                const bf16* __restrict__ vp, const float* __restrict__ dh,
                const float* __restrict__ li, Strides st_, Scratch w, Dims d) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* gb = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(gb);
  __shared__ float wt[kT], wn[kT];
  const Chunk ch = chunk_of(blockIdx.x, d);
  const int d0 = blockIdx.y * kT, e0 = blockIdx.z * kT;
  const int D = d.hd, Q = d.chunk;
  const int R = min(Q, d.seq - ch.s0);
  const int tid = threadIdx.x;
  if (tid < Q) {
    const int r = tid;
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
  const int64_t qo = off(st_.q, ch.b, ch.s0, ch.h), ko = off(st_.k, ch.b, ch.s0, ch.h);
  const int64_t vo = off(st_.v, ch.b, ch.s0, ch.h), ho = off(st_.dh, ch.b, ch.s0, ch.h);
  // mode 0: A hi in panels 0-1, lo in 2-3 (panel h: columns d0 + 64 h ..),
  // B = v in 4-5; mode 1: A = q in 0-1, B hi in 2-3, lo in 4-5
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (mode == 0) {
      load_split<false>(gb + h * kPanel, gb + (2 + h) * kPanel, kp + ko, st_.k[1], R,
                        d0 + 64 * h, D, wt);
      load_bf16(base + (4 + h) * kPanel, vp + vo, st_.v[1], R, e0 + 64 * h, D);
    } else {
      load_bf16(base + h * kPanel, qp + qo, st_.q[1], R, d0 + 64 * h, D);
      load_split<true>(gb + (2 + h) * kPanel, gb + (4 + h) * kPanel, dh + ho, st_.dh[1], R,
                       e0 + 64 * h, D, wt);
    }
  }
  cp_async_commit();
  stage_ready();
  const Frag f = frag();
  const int n_steps = (R + 15) / 16;
  float acc[64];
  wgmma_fence();
  for (int kk = 0; kk < n_steps; ++kk) {
    if (mode == 0) {
      const uint64_t db = desc_mn(base + 4 * kPanel, kk);
      wgmma128<1, 1>(acc, desc_mn(base + f.wg * kPanel, kk), db, kk > 0);
      wgmma128<1, 1>(acc, desc_mn(base + (2 + f.wg) * kPanel, kk), db, 1);
    } else {
      const uint64_t da = desc_mn(base + f.wg * kPanel, kk);
      wgmma128<1, 1>(acc, da, desc_mn(base + 2 * kPanel, kk), kk > 0);
      wgmma128<1, 1>(acc, da, desc_mn(base + 4 * kPanel, kk), 1);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
  float* out = (mode == 0 ? w.cst : w.gst) + ch.bhc * D * D;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int dd = d0 + f.row0 + 8 * h, e = e0 + 8 * j + f.col0;
      if (dd < D && e < D) {
        *reinterpret_cast<float2*>(out + static_cast<int64_t>(dd) * D + e) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
  if (blockIdx.z == 0 && tid < kT && d0 + tid < D) {
    const int dd = d0 + tid;
    const bf16* xp = mode == 0 ? kp + ko : qp + qo;
    const int64_t xs = mode == 0 ? st_.k[1] : st_.q[1];
    float s = 0.f;
    for (int r = 0; r < R; ++r) s = fmaf(wn[r], __bfloat162float(xp[r * xs + dd]), s);
    (mode == 0 ? w.nst : w.gn)[ch.bhc * D + dd] = s;
  }
}

// ---------------------------------------------------------------------------
// 3 and 7 on the tensor-core route: pass_kernel's recurrences, the D x D
// states written as parts.  Block x < pass_blocks - 1 owns elements
// [1024 x, 1024 x + 1024) of a chunk's Dp x D grid (row-major, so the first
// D D are the f32 slab's own), thread t the four from 4 t; the last block
// owns n~ as pass_kernel does.  forward: the updates (cst, f32) in, each
// entering state's parts out (cpart); reverse: the local gradients (gst)
// and the entering states' parts in, each leaving gradient's parts out
// (gpart, over the spent updates), with <that, the entering state> by block.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store_parts(unsigned char* hi, unsigned char* lo, uint32_t o,
                                            const float (&v)[4]) {
  uint2 h, l;
  split2(v[0], v[1], h.x, l.x);
  split2(v[2], v[3], h.y, l.y);
  *reinterpret_cast<uint2*>(hi + o) = h;
  *reinterpret_cast<uint2*>(lo + o) = l;
}

__device__ __forceinline__ float4 load_parts(const unsigned char* hi, const unsigned char* lo,
                                             uint32_t o) {
  const uint2 h = *reinterpret_cast<const uint2*>(hi + o);
  const uint2 l = *reinterpret_cast<const uint2*>(lo + o);
  const float2 a = join2(h.x, l.x), b = join2(h.y, l.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <bool kReverse>
__global__ void __launch_bounds__(kThreads)
pass_parts_kernel(Scratch w, const float* __restrict__ c_init, const float* __restrict__ n_init,
                  const float* __restrict__ dc_final, const float* __restrict__ dn_final,
                  float* __restrict__ dc0, float* __restrict__ dn0, Dims d) {
  __shared__ float red[kThreads / 32];
  const int bh = blockIdx.y, nc = d.n_chunks, D = d.hd;
  const bool is_n = blockIdx.x == d.pass_blocks - 1;
  const int64_t size = is_n ? D : static_cast<int64_t>(D) * D;  // f32 elements a chunk
  const int64_t e = (is_n ? 0 : static_cast<int64_t>(blockIdx.x) * kPassElems) + 4 * threadIdx.x;
  const bool own = e < size;  // else a zero row of the parts (or past n~)
  const bool grid = !is_n;    // writes parts
  const int64_t pslab = static_cast<int64_t>(padded(D)) * D;
  const int64_t bhc0 = static_cast<int64_t>(bh) * nc;
  const float* src = (kReverse ? (is_n ? w.gn : w.gst) : (is_n ? w.nst : w.cst)) + bhc0 * size + e;
  float* nslab = (kReverse ? w.gn : w.nst) + bhc0 * size + e;  // n~: f32 in place
  float* out_parts = kReverse ? w.gpart : w.cpart;
  const uint32_t po = grid ? part_off(e, D) : 0;
  auto hi_of = [&](float* parts, int c) {
    return reinterpret_cast<unsigned char*>(parts + (bhc0 + c) * pslab);
  };
  const float* init = kReverse ? (is_n ? dn_final : dc_final) : (is_n ? n_init : c_init);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float run[4] = {0.f, 0.f, 0.f, 0.f};
  if (init != nullptr && own) {
#pragma unroll
    for (int i = 0; i < 4; ++i) run[i] = init[bh * size + e + i];
  }
  auto other_at = [&](int c) {  // the state entering chunk c (reverse only)
    if (!own) return zero4;
    if (is_n) return ld4(w.nst + (bhc0 + c) * size + e);
    const unsigned char* hi = hi_of(w.cpart, c);
    return load_parts(hi, hi + pslab * 2, po);
  };
  const int c0 = kReverse ? nc - 1 : 0;
  float4 cur = own ? ld4(src + c0 * size) : zero4;
  float4 ocur = kReverse ? other_at(c0) : zero4;
  float dcur = chunk_decay(w, bh, c0, d);
  for (int t = 0; t < nc; ++t) {
    const int c = kReverse ? nc - 1 - t : t;
    float4 nxt = zero4, onxt = zero4;
    float dnxt = 0.f;
    if (t + 1 < nc) {
      const int cn = kReverse ? c - 1 : c + 1;
      if (own) nxt = ld4(src + cn * size);
      if (kReverse) onxt = other_at(cn);
      dnxt = chunk_decay(w, bh, cn, d);
    }
    float dot = 0.f;
    if (kReverse && own) {
      dot = fmaf(run[0], ocur.x, fmaf(run[1], ocur.y, fmaf(run[2], ocur.z, run[3] * ocur.w)));
    }
    if (grid) {
      unsigned char* hi = hi_of(out_parts, c);
      store_parts(hi, hi + pslab * 2, po, run);
    } else if (own) {
      *reinterpret_cast<float4*>(nslab + c * size) = make_float4(run[0], run[1], run[2], run[3]);
    }
    if (own) {
      run[0] = fmaf(dcur, run[0], cur.x);
      run[1] = fmaf(dcur, run[1], cur.y);
      run[2] = fmaf(dcur, run[2], cur.z);
      run[3] = fmaf(dcur, run[3], cur.w);
    }
    if (kReverse) {
      const float total = block_sum(dot, red);
      if (threadIdx.x == 0) w.ddp[(bhc0 + c) * d.pass_blocks + blockIdx.x] = total;
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
// 4 on wgmma: Z = dh C~^T, one block per (b, h, chunk, 128 columns d), each
// warpgroup 64 of the chunk's rows; K = e in steps of 64: dh's columns as
// hi + lo (split here from f32), C~'s panels (dt, et) as the pass wrote them,
// three products (hi hi, hi lo, lo hi), both K-major.  Two stages of four
// panels, 128 KB: the next step's copies and split run under this step's
// products.  Then q . Z by column tile.
// ---------------------------------------------------------------------------

constexpr int kZSmem = 1024 + 8 * kPanel;

__global__ void __launch_bounds__(kThreads, 1)
z_tc_kernel(const bf16* __restrict__ qp, const float* __restrict__ dh, Strides st_, Scratch w,
            Dims d) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* gb = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(gb);
  const Chunk ch = chunk_of(blockIdx.x, d);
  const int dt = blockIdx.y;
  const int D = d.hd, n_k = D / 64;
  const int R = min(d.chunk, d.seq - ch.s0);
  const int64_t ho = off(st_.dh, ch.b, ch.s0, ch.h), qo = off(st_.q, ch.b, ch.s0, ch.h);
  const unsigned char* chi = part_image(w.cpart, ch.bhc, D, false);
  const unsigned char* clo = part_image(w.cpart, ch.bhc, D, true);
  // stage s: dh hi, dh lo, C~ hi, C~ lo
  auto load = [&](int et, int s) {
    const int p0 = 4 * s;
    load_split<true>(gb + p0 * kPanel, gb + (p0 + 1) * kPanel, dh + ho, st_.dh[1], R, 64 * et,
                     D, nullptr);
    const int64_t pan = static_cast<int64_t>(dt * n_k + et) * kPanel;
    copy_image(base + (p0 + 2) * kPanel, chi + pan, kPanel, true);
    copy_image(base + (p0 + 3) * kPanel, clo + pan, kPanel, true);
    cp_async_commit();
  };
  const Frag f = frag();
  float acc[64];
  load(0, 0);
  for (int et = 0; et < n_k; ++et) {
    const uint32_t st = base + 4 * (et & 1) * kPanel;
    stage_ready();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t ah = desc_k(st + f.wg * kHalf, kk), al = desc_k(st + kPanel + f.wg * kHalf, kk);
      const uint64_t bh = desc_k(st + 2 * kPanel, kk), bl = desc_k(st + 3 * kPanel, kk);
      wgmma128<0, 0>(acc, ah, bh, et > 0 || kk > 0);
      wgmma128<0, 0>(acc, ah, bl, 1);
      wgmma128<0, 0>(acc, al, bh, 1);
    }
    wgmma_commit();
    if (et + 1 < n_k) load(et + 1, (et + 1) & 1);
    wgmma_wait_all();
    fence_regs(acc);
  }
  // Z rows r = row0 (+ 8), columns 128 dt + 8 j + col0 (+ 1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = f.row0 + 8 * h;
    float qz = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int dd = dt * kT + 8 * j + f.col0;
      const float z0 = acc[4 * j + 2 * h], z1 = acc[4 * j + 2 * h + 1];
      if (r < d.chunk && dd < D) {
        *reinterpret_cast<float2*>(w.z + (ch.row0 + r) * D + dd) = make_float2(z0, z1);
        if (r < R) {
          const float2 qv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(qp + qo + r * st_.q[1] + dd));
          qz = fmaf(qv.x, z0, fmaf(qv.y, z1, qz));
        }
      }
    }
    qz = quad_sum(qz);
    if (f.col0 == 0 && r < d.chunk) w.qzp[(ch.row0 + r) * d.tiles + dt] = qz;
  }
}

// ---------------------------------------------------------------------------
// 5 on wgmma: one block per (b, h, chunk), two warpgroups of 64 rows.
//   1. S = q k^T (K = D in steps of 64, both K-major); W = S (.) D on the
//      lower triangle, its row sums, W as hi + lo parts in shared memory;
//   2. dh v^T (dh split, two products); sum_j W (dh v^T) by row, the
//      denominators and ds; dW, P (.) sums by row and column, dS = dW (.) D
//      as hi + lo parts;
//   3. per 64 columns e: dq = dS k (dS K-major, k MN-major) + (a / dd) Z +
//      a ds n~; the share dS^T q of dk (dS^T read MN-major: the parts'
//      rows are the chunk's positions); then the share W^T (dh / dd) of dv
//      (dh / dd split here, three products).  Each product of 2 and 3 skips
//      the k16 steps the causal triangle zeroes.
// Shared memory: W's parts (four panels), then either the two-stage ring of
// 1 and 2 (three panels a stage) or dS's parts and the two-stage ring of 3
// (two panels a stage): twelve panels, 193 KB, and the per-row scalars.
// ---------------------------------------------------------------------------

constexpr int kRowsTcSmem = 1024 + 12 * kPanel;

__global__ void __launch_bounds__(kThreads, 1)
rows_tc_kernel(const bf16* __restrict__ qp, const bf16* __restrict__ kp,
               const bf16* __restrict__ vp, const float* __restrict__ dh,
               const float* __restrict__ li, bf16* __restrict__ dq, Strides st_, Scratch w,
               Dims d) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* gb = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(gb);
  __shared__ float gv[kT], uv[kT], av[kT], flv[kT], rsw[kT], hvv[kT];
  __shared__ float qnv[kT], qzv[kT], rinv[kT], dsv[kT], prow[kT], dlv[kT];
  __shared__ float colp[kThreads / 32][kT];
  auto panel = [&](int i) { return base + i * kPanel; };
  const Chunk ch = chunk_of(blockIdx.x, d);
  const int D = d.hd, Q = d.chunk, n_k = D / 64;
  const int R = min(Q, d.seq - ch.s0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float m_in = w.m_in[ch.bhc];
  const float* nin = w.nst + ch.bhc * D;
  const int64_t qo = off(st_.q, ch.b, ch.s0, ch.h), ko = off(st_.k, ch.b, ch.s0, ch.h);
  const int64_t vo = off(st_.v, ch.b, ch.s0, ch.h), ho = off(st_.dh, ch.b, ch.s0, ch.h);
  if (tid < kT) {
    const int r = tid;
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
      for (int e = lane; e < D; e += 32) s = fmaf(__bfloat162float(qp[qo + r * st_.q[1] + e]), nin[e], s);
    }
    s = warp_sum(s);
    if (lane == 0) qnv[r] = s;
  }
  const Frag f = frag();
  // W's parts: hi in panels 0-1 (columns 0-63, 64-127), lo in 2-3; dS's
  // parts likewise in 4-7
  auto w_at = [&](bool lo, int c) { return gb + ((lo ? 2 : 0) + c / 64) * kPanel; };
  auto ds_at = [&](bool lo, int c) { return gb + ((lo ? 6 : 4) + c / 64) * kPanel; };
  float acc[64];

  // 1. S = q k^T
  auto load1 = [&](int et, int s) {
    const int p0 = 4 + 3 * s;
    load_bf16(panel(p0), qp + qo, st_.q[1], R, 64 * et, D);
    load_bf16(panel(p0 + 1), kp + ko, st_.k[1], R, 64 * et, D);
    cp_async_commit();
  };
  load1(0, 0);
  for (int et = 0; et < n_k; ++et) {
    const uint32_t st = panel(4 + 3 * (et & 1));
    stage_ready();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma128<0, 0>(acc, desc_k(st + f.wg * kHalf, kk), desc_k(st + kPanel, kk),
                     et > 0 || kk > 0);
    }
    wgmma_commit();
    if (et + 1 < n_k) load1(et + 1, (et + 1) & 1);
    wgmma_wait_all();
    fence_regs(acc);
  }
  // W = S (.) exp(u_j - g_q) for j <= q (above the diagonal the exponent
  // may overflow), its row sums, and its parts
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = f.row0 + 8 * h;
    const float g = gv[r];
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + f.col0;
      const float w0 = c <= r && r < Q ? acc[4 * j + 2 * h] * expf(uv[c] - g) : 0.f;
      const float w1 = c + 1 <= r && r < Q ? acc[4 * j + 2 * h + 1] * expf(uv[c + 1] - g) : 0.f;
      rs += w0 + w1;
      uint32_t hi, lo;
      split2(w0, w1, hi, lo);
      *reinterpret_cast<uint32_t*>(w_at(false, c) + swz(r, c & 63)) = hi;
      *reinterpret_cast<uint32_t*>(w_at(true, c) + swz(r, c & 63)) = lo;
    }
    rs = quad_sum(rs);
    if (f.col0 == 0) rsw[r] = rs;
  }
  __syncthreads();  // both warpgroups are past loop 1's stages

  // 2. dh v^T
  auto load2 = [&](int et, int s) {
    const int p0 = 4 + 3 * s;
    load_split<true>(gb + p0 * kPanel, gb + (p0 + 1) * kPanel, dh + ho, st_.dh[1], R, 64 * et,
                     D, nullptr);
    load_bf16(panel(p0 + 2), vp + vo, st_.v[1], R, 64 * et, D);
    cp_async_commit();
  };
  load2(0, 0);
  for (int et = 0; et < n_k; ++et) {
    const uint32_t st = panel(4 + 3 * (et & 1));
    stage_ready();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t b = desc_k(st + 2 * kPanel, kk);
      wgmma128<0, 0>(acc, desc_k(st + f.wg * kHalf, kk), b, et > 0 || kk > 0);
      wgmma128<0, 0>(acc, desc_k(st + kPanel + f.wg * kHalf, kk), b, 1);
    }
    wgmma_commit();
    if (et + 1 < n_k) load2(et + 1, (et + 1) & 1);
    wgmma_wait_all();
    fence_regs(acc);
  }
  // W from its parts at a thread's own places
  auto w_pair = [&](int r, int c) {
    const uint32_t o = swz(r, c & 63);
    return join2(*reinterpret_cast<const uint32_t*>(w_at(false, c) + o),
                 *reinterpret_cast<const uint32_t*>(w_at(true, c) + o));
  };
  // sum_j W_qj (dh v^T)_qj
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = f.row0 + 8 * h;
    float hv = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 wv = w_pair(r, 8 * j + f.col0);
      hv = fmaf(wv.x, acc[4 * j + 2 * h], fmaf(wv.y, acc[4 * j + 2 * h + 1], hv));
    }
    hv = quad_sum(hv);
    if (f.col0 == 0) hvv[r] = hv;
  }
  __syncthreads();
  // the denominators, ds, the coefficients (as rows_kernel)
  if (tid < kT) {
    const int r = tid;
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
  // dW = (dh v^T) / dd + ds (j <= q); P = dW (.) W; dS = dW (.) D as parts
  float cols[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) cols[i] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = f.row0 + 8 * h;
    const float ri = rinv[r], ds = dsv[r], g = gv[r];
    float pr = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + f.col0;
      const float2 wv = w_pair(r, c);
      float s2[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (c + e <= r && r < Q) {
          const float dW = fmaf(acc[4 * j + 2 * h + e], ri, ds);
          const float p = dW * (e ? wv.y : wv.x);
          pr += p;
          cols[2 * j + e] += p;
          s2[e] = dW * expf(uv[c + e] - g);
        }
      }
      uint32_t hi, lo;
      split2(s2[0], s2[1], hi, lo);
      *reinterpret_cast<uint32_t*>(ds_at(false, c) + swz(r, c & 63)) = hi;
      *reinterpret_cast<uint32_t*>(ds_at(true, c) + swz(r, c & 63)) = lo;
    }
    pr = quad_sum(pr);
    if (f.col0 == 0) prow[r] = pr;
  }
  // P by column: the warp's rows (lanes 4 apart), then the warps in order
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float v = cols[i];
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    if (lane < 4) colp[warp][8 * (i / 2) + f.col0 + i % 2] = v;
  }
  __syncthreads();
  if (tid < kT) {
    const int r = tid;
    float pc = 0.f;
    for (int y = 0; y < kThreads / 32; ++y) pc += colp[y][r];
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

  // 3. dq, and the Q x Q shares of dk and dv, 64 columns a step pair
  const int64_t out0 = ((static_cast<int64_t>(ch.b) * d.seq + ch.s0) * d.heads + ch.h) * D;
  const int64_t ostride = static_cast<int64_t>(d.heads) * D;
  auto load3 = [&](int i, int s) {
    const int et = i >> 1, p0 = 8 + 2 * s;
    if ((i & 1) == 0) {
      load_bf16(panel(p0), kp + ko, st_.k[1], R, 64 * et, D);
      load_bf16(panel(p0 + 1), qp + qo, st_.q[1], R, 64 * et, D);
    } else {
      load_split<true>(gb + p0 * kPanel, gb + (p0 + 1) * kPanel, dh + ho, st_.dh[1], R,
                       64 * et, D, rinv);
    }
    cp_async_commit();
  };
  const int kq = 4 * (f.wg + 1);  // k16 steps of j that reach this warpgroup's rows
  const int k0 = 4 * f.wg;        // the first step of q at or past its columns
  load3(0, 0);
  for (int i = 0; i < 2 * n_k; ++i) {
    const int e0 = 64 * (i >> 1);
    const uint32_t st = panel(8 + 2 * (i & 1));
    stage_ready();
    if ((i & 1) == 0) {
      float aq[32], ak[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk < kq) {
          const uint32_t a = panel(4 + kk / 4) + f.wg * kHalf;
          const uint64_t b = desc_mn(st, kk);
          wgmma64<0, 1>(aq, desc_k(a, kk & 3), b, kk > 0);
          wgmma64<0, 1>(aq, desc_k(a + 2 * kPanel, kk & 3), b, 1);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk >= k0) {
          const uint64_t b = desc_mn(st + kPanel, kk);
          wgmma64<1, 1>(ak, desc_mn(panel(4 + f.wg), kk), b, kk > k0);
          wgmma64<1, 1>(ak, desc_mn(panel(6 + f.wg), kk), b, 1);
        }
      }
      wgmma_commit();
      if (i + 1 < 2 * n_k) load3(i + 1, (i + 1) & 1);
      wgmma_wait_all();
      fence_regs(aq);
      fence_regs(ak);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = f.row0 + 8 * h;
        const float ca = av[r] * rinv[r], cn = av[r] * dsv[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int e = e0 + 8 * j + f.col0;
          if (r < R) {
            const float2 z = *reinterpret_cast<const float2*>(w.z + (ch.row0 + r) * D + e);
            const float2 n = *reinterpret_cast<const float2*>(nin + e);
            const float v0 = aq[4 * j + 2 * h] + ca * z.x + cn * n.x;
            const float v1 = aq[4 * j + 2 * h + 1] + ca * z.y + cn * n.y;
            *reinterpret_cast<__nv_bfloat162*>(dq + out0 + r * ostride + e) =
                __floats2bfloat162_rn(v0, v1);
          }
          if (r < Q) {
            *reinterpret_cast<float2*>(w.dkp + (ch.row0 + r) * D + e) =
                make_float2(ak[4 * j + 2 * h], ak[4 * j + 2 * h + 1]);
          }
        }
      }
    } else {
      float adv[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk >= k0) {
          const uint64_t whi = desc_mn(panel(f.wg), kk), bhi = desc_mn(st, kk);
          wgmma64<1, 1>(adv, whi, bhi, kk > k0);
          wgmma64<1, 1>(adv, whi, desc_mn(st + kPanel, kk), 1);
          wgmma64<1, 1>(adv, desc_mn(panel(2 + f.wg), kk), bhi, 1);
        }
      }
      wgmma_commit();
      if (i + 1 < 2 * n_k) load3(i + 1, (i + 1) & 1);
      wgmma_wait_all();
      fence_regs(adv);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = f.row0 + 8 * h;
        if (r < Q) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int e = e0 + 8 * j + f.col0;
            *reinterpret_cast<float2*>(w.dvp + (ch.row0 + r) * D + e) =
                make_float2(adv[4 * j + 2 * h], adv[4 * j + 2 * h + 1]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 8 on wgmma: one block per (b, h, chunk, 128 columns), two warpgroups of 64
// rows.  (v dC~'^T)[r, c] for the block's columns c: K = e in steps of 64,
// v K-major, the leaving gradient's panels (c's row tile, et) K-major, hi
// and lo; then (k dC~')[r, e] for the block's columns e: K = d in steps of
// 64, k K-major, the 64-row halves of panels (d's tile, 2 t) and (.., 2 t
// + 1) MN-major, hi and lo.  Two stages of three panels, 96 KB.
// ---------------------------------------------------------------------------

constexpr int kDstateSmem = 1024 + 6 * kPanel;

__global__ void __launch_bounds__(kThreads, 2)
dstate_tc_kernel(const bf16* __restrict__ kp, const bf16* __restrict__ vp,
                 const float* __restrict__ li, bf16* __restrict__ dk, bf16* __restrict__ dv,
                 Strides st_, Scratch w, Dims d) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* gb = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(gb);
  __shared__ float wt[kT];
  auto panel = [&](int i) { return base + i * kPanel; };
  const Chunk ch = chunk_of(blockIdx.x, d);
  const int t = blockIdx.y, c0 = t * kT;
  const int D = d.hd, Q = d.chunk, n_k = D / 64;
  const int R = min(Q, d.seq - ch.s0);
  const int tid = threadIdx.x;
  if (tid < kT) {
    const int r = tid;
    const float g_end = pos_row(w, kG, d)[ch.row0 + Q - 1];
    wt[r] = r < R ? expf(u_of(li, st_, w, ch, r, d) - g_end) : 0.f;
  }
  const unsigned char* ghi = part_image(w.gpart, ch.bhc, D, false);
  const unsigned char* glo = part_image(w.gpart, ch.bhc, D, true);
  const float* dn = w.gn + ch.bhc * D;
  const int64_t ko = off(st_.k, ch.b, ch.s0, ch.h), vo = off(st_.v, ch.b, ch.s0, ch.h);
  const int64_t out0 = ((static_cast<int64_t>(ch.b) * d.seq + ch.s0) * d.heads + ch.h) * D;
  const int64_t ostride = static_cast<int64_t>(d.heads) * D;
  const Frag f = frag();
  float acc[64];

  // (v dC~'^T) + dn~': dk += wgt times it; k . it by tile
  auto load_a = [&](int et, int s) {
    const int p0 = 3 * s;
    load_bf16(panel(p0), vp + vo, st_.v[1], R, 64 * et, D);
    const int64_t pan = static_cast<int64_t>(t * n_k + et) * kPanel;
    copy_image(panel(p0 + 1), ghi + pan, kPanel, true);
    copy_image(panel(p0 + 2), glo + pan, kPanel, true);
    cp_async_commit();
  };
  load_a(0, 0);
  for (int et = 0; et < n_k; ++et) {
    const uint32_t st = panel(3 * (et & 1));
    stage_ready();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t a = desc_k(st + f.wg * kHalf, kk);
      wgmma128<0, 0>(acc, a, desc_k(st + kPanel, kk), et > 0 || kk > 0);
      wgmma128<0, 0>(acc, a, desc_k(st + 2 * kPanel, kk), 1);
    }
    wgmma_commit();
    if (et + 1 < n_k) load_a(et + 1, (et + 1) & 1);
    wgmma_wait_all();
    fence_regs(acc);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = f.row0 + 8 * h;
    float kd = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + 8 * j + f.col0;
      if (r < R && c < D) {
        const float v0 = acc[4 * j + 2 * h] + dn[c], v1 = acc[4 * j + 2 * h + 1] + dn[c + 1];
        const float2 kv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(kp + ko + r * st_.k[1] + c));
        kd = fmaf(kv.x, v0, fmaf(kv.y, v1, kd));
        const float2 p = *reinterpret_cast<const float2*>(w.dkp + (ch.row0 + r) * D + c);
        *reinterpret_cast<__nv_bfloat162*>(dk + out0 + r * ostride + c) =
            __floats2bfloat162_rn(p.x + wt[r] * v0, p.y + wt[r] * v1);
      }
    }
    kd = quad_sum(kd);
    if (f.col0 == 0 && r < Q) w.dwp[(ch.row0 + r) * d.tiles + t] = kd;
  }
  __syncthreads();  // both warpgroups are past the first loop's stages

  // (k dC~'): dv += wgt times it
  const bool second = 2 * t + 1 < n_k;  // the block's columns 64-127 lie in D
  auto load_b = [&](int i, int s) {
    const int p0 = 3 * s;
    load_bf16(panel(p0), kp + ko, st_.k[1], R, 64 * i, D);
    const int64_t pan = static_cast<int64_t>((i / 2) * n_k + 2 * t) * kPanel + (i & 1) * kHalf;
    copy_image(panel(p0 + 1), ghi + pan, kHalf, true);
    copy_image(panel(p0 + 1) + kHalf, ghi + pan + kPanel, kHalf, second);
    copy_image(panel(p0 + 2), glo + pan, kHalf, true);
    copy_image(panel(p0 + 2) + kHalf, glo + pan + kPanel, kHalf, second);
    cp_async_commit();
  };
  load_b(0, 0);
  for (int i = 0; i < n_k; ++i) {
    const uint32_t st = panel(3 * (i & 1));
    stage_ready();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t a = desc_k(st + f.wg * kHalf, kk);
      wgmma128<0, 1>(acc, a, desc_mn(st + kPanel, kk, kHalf), i > 0 || kk > 0);
      wgmma128<0, 1>(acc, a, desc_mn(st + 2 * kPanel, kk, kHalf), 1);
    }
    wgmma_commit();
    if (i + 1 < n_k) load_b(i + 1, (i + 1) & 1);
    wgmma_wait_all();
    fence_regs(acc);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = f.row0 + 8 * h;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int e = c0 + 8 * j + f.col0;
      if (r < R && e < D) {
        const float2 p = *reinterpret_cast<const float2*>(w.dvp + (ch.row0 + r) * D + e);
        *reinterpret_cast<__nv_bfloat162*>(dv + out0 + r * ostride + e) =
            __floats2bfloat162_rn(p.x + wt[r] * acc[4 * j + 2 * h],
                                  p.y + wt[r] * acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

}  // namespace tc


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
  // bf16 at head dims that are multiples of 64 takes the tensor cores
  // (repro_torch/kernels/mlstm_scan_bwd.py::kernel_route)
  const bool tcr = dtype == 1 && hd % 64 == 0;
  const int64_t dd = static_cast<int64_t>(hd) * hd;
  const int64_t pslab = static_cast<int64_t>(tiles) * kT * hd;  // a chunk's parts
  const int pass_blocks = static_cast<int>(((tcr ? pslab : dd) + kPassElems - 1) / kPassElems) + 1;
  const Dims d{batch, seq, heads, hd, chunk, n_chunks, tiles, pass_blocks, dtype == 1};
  const int64_t bh = static_cast<int64_t>(batch) * heads;
  const int64_t sp = static_cast<int64_t>(n_chunks) * chunk;
  Scratch w;
  float* p = static_cast<float*>(scratch);
  w.cst = p;
  p += bhc * (tcr ? pslab : dd);
  w.gst = p;
  p += bhc * dd;
  w.cpart = tcr ? p : nullptr;
  w.gpart = tcr ? w.cst : nullptr;
  p += tcr ? bhc * pslab : 0;
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
  const auto* c0_f = static_cast<const float*>(c0);
  const auto* n0_f = static_cast<const float*>(n0);
  const auto* dc_f = static_cast<const float*>(dc);
  const auto* dn_f = static_cast<const float*>(dn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // set once: a call's host cost counts at S 1
  static const cudaError_t attr = [] {
    cudaError_t e = allow_smem(rows_kernel, kRowsSmem);
    if (e == cudaSuccess) e = allow_smem(tc::outer_tc_kernel, tc::kOuterSmem);
    if (e == cudaSuccess) e = allow_smem(tc::z_tc_kernel, tc::kZSmem);
    if (e == cudaSuccess) e = allow_smem(tc::rows_tc_kernel, tc::kRowsTcSmem);
    if (e == cudaSuccess) e = allow_smem(tc::dstate_tc_kernel, tc::kDstateSmem);
    return e;
  }();
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
  if (tcr) {
    const auto* qb = static_cast<const bf16*>(q);
    const auto* kb = static_cast<const bf16*>(k);
    const auto* vb = static_cast<const bf16*>(v);
    tc::outer_tc_kernel<<<outer_grid, kThreads, tc::kOuterSmem, s>>>(0, qb, kb, vb, dh_f, li_f,
                                                                     st_, w, d);
    REPRO_CHECK();
    tc::pass_parts_kernel<false><<<pass_grid, kThreads, 0, s>>>(w, c0_f, n0_f, dc_f, dn_f,
                                                                nullptr, nullptr, d);
    REPRO_CHECK();
    tc::z_tc_kernel<<<tile_grid, kThreads, tc::kZSmem, s>>>(qb, dh_f, st_, w, d);
    REPRO_CHECK();
    tc::rows_tc_kernel<<<static_cast<unsigned>(bhc), kThreads, tc::kRowsTcSmem, s>>>(
        qb, kb, vb, dh_f, li_f, static_cast<bf16*>(dq), st_, w, d);
    REPRO_CHECK();
    tc::outer_tc_kernel<<<outer_grid, kThreads, tc::kOuterSmem, s>>>(1, qb, kb, vb, dh_f, li_f,
                                                                     st_, w, d);
    REPRO_CHECK();
    tc::pass_parts_kernel<true><<<pass_grid, kThreads, 0, s>>>(
        w, nullptr, nullptr, dc_f, dn_f, static_cast<float*>(dc0), static_cast<float*>(dn0), d);
    REPRO_CHECK();
    tc::dstate_tc_kernel<<<tile_grid, kThreads, tc::kDstateSmem, s>>>(
        kb, vb, li_f, static_cast<bf16*>(dk), static_cast<bf16*>(dv), st_, w, d);
    REPRO_CHECK();
  } else {
    outer_kernel<<<outer_grid, kThreads, 0, s>>>(0, q, k, v, dh_f, li_f, st_, w, d);
    REPRO_CHECK();
    pass_kernel<false><<<pass_grid, kThreads, 0, s>>>(w, c0_f, n0_f, dc_f, dn_f, nullptr,
                                                      nullptr, d);
    REPRO_CHECK();
    z_kernel<<<tile_grid, kThreads, 0, s>>>(q, dh_f, st_, w, d);
    REPRO_CHECK();
    rows_kernel<<<static_cast<unsigned>(bhc), kThreads, kRowsSmem, s>>>(q, k, v, dh_f, li_f,
                                                                        dq, st_, w, d);
    REPRO_CHECK();
    outer_kernel<<<outer_grid, kThreads, 0, s>>>(1, q, k, v, dh_f, li_f, st_, w, d);
    REPRO_CHECK();
    pass_kernel<true><<<pass_grid, kThreads, 0, s>>>(w, nullptr, nullptr, dc_f, dn_f,
                                                     static_cast<float*>(dc0),
                                                     static_cast<float*>(dn0), d);
    REPRO_CHECK();
    dstate_kernel<<<tile_grid, kThreads, 0, s>>>(k, v, li_f, dk, dv, st_, w, d);
    REPRO_CHECK();
  }
  final_kernel<<<static_cast<unsigned>(bh), 32, 0, s>>>(
      li_f, static_cast<const float*>(dm), static_cast<float*>(dlf),
      static_cast<float*>(dli), static_cast<float*>(dm0), st_, w, d);
#undef REPRO_CHECK
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
