// The gradient of the Mamba-2 SSD chunked scan, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's models never call its Pallas
// scan (repro/kernels/ssd_scan.py::ssd_scan), and jax.value_and_grad
// differentiates the plain chunked code (repro/models/mamba.py::_ssd_chunked)
// through XLA.  The port's train step runs the forward kernel
// (csrc/ssd_scan.cu), so its gradient is a kernel too.
//
// For one chunk with prefix sums cum of the log decays, L[q, j] =
// exp(cum_q - cum_j) for j <= q, entering state h_c and dS = D_{c+1}, the
// gradient of the state leaving it, one call runs five kernels on the
// caller's stream:
//
//   1. chunk states, one block per (head, chunk, b): the chunk's own state
//      S_c = sum_j exp(cum_end - cum_j) x_j (x) B_j and its decay
//      exp(cum_end) (as the forward's pass 1), and G_c = sum_q exp(cum_q)
//      dy_q (x) C_q, the gradient its outputs send to h_c;
//   2. state passing, elementwise over the P x N state, 1024 elements a
//      block: in chunk order the entering states h_c (over S_c), then in
//      reverse D_c = G_c + exp(cum_end_c) D_{c+1} from dh_final or zero (dS
//      over G_c), dh0 = D_0, and <D_{c+1}, h_c> by block, in a fixed order;
//   3. chunk matrices, one block per (head, chunk, b): C B^T and dy x^T as
//      128 x 128 register tiles; W = C B^T (.) L and M = L (.) dy x^T go to
//      scratch, and the sums of T = W (.) dy x^T by row minus by column (the
//      gradient of cum through L);
//   4. chunk gradients, one block per (head, chunk, b): dx = W^T dy +
//      exp(cum_end - cum) (.) B dS^T; the head's dB = M^T C + exp(cum_end -
//      cum) (.) x dS and dC = M B + exp(cum) (.) dy h_c, to scratch; dcum
//      from T, the carry term, S_c and the decay, and dla its reverse prefix
//      sum in the chunk;
//   5. head sum: dBm and dCm, each the sum of the heads' dB / dC in head
//      order.  No kernel uses atomics, so two calls give equal bits.
//
// Every product runs on the CUDA cores in f32, whatever the input dtype
// (bf16 inputs are widened as they are read), through one tiled routine:
// shared tiles of 16 values of k, register tiles of 8 x 8 (or 8 x 4, 4 x 4)
// outputs a thread, each thread's rows in groups of four read as float4s.
// Operands are read element by element through their strides (Bm and Cm
// may be the model's strided views); positions past S read as zero, so a
// ragged tail contributes nothing and nothing is copied.
//
// What bounds it: at zamba2-1.2b's train shape (B 2, S 4096, H 64, P = N =
// 64, chunks of 128, bf16) the function reads and writes ~210 MB (0.063 ms
// at 3.35 TB/s) and needs ~39 GFLOP on its causal triangles (0.039 ms at
// the bf16 tensor-core rate): the bytes.  This first version runs ~61
// GFLOP (full 128 x 128 tiles, C B^T again a head) at the f32 rate of the
// CUDA cores and moves ~1.1 GB of scratch (W and M twice, the states), so it
// sits far above that bound: the products on the tensor cores and W, M kept
// on chip are later work.  The state passing moves float4s and loads the
// next chunk ahead; the gradients kernel keeps two blocks an SM (at most 128
// registers a thread).  PERF.md gives the measured split by kernel.
//
// Plain C interface, loaded with ctypes by repro_torch/kernels/ssd_scan_bwd.py;
// the function returns the CUDA error code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // every kernel: 16 x 16 threads
constexpr int kQ = 128;        // rows of a chunk, at most
constexpr int kTile = 64;      // P and N, at most
constexpr int kKB = 16;        // values of k a shared tile holds
constexpr int kPassBlock = 4 * kThreads;  // state elements a block of the state passing
constexpr int kMaxPassBlocks = kTile * kTile / kPassBlock;

// Element strides; the P dim of xh / dy and the N dim of Bm / Cm are unit.
struct Strides {
  int64_t x_b, x_s, x_h;
  int64_t l_b, l_s, l_h;
  int64_t b_b, b_s;
  int64_t c_b, c_s;
  int64_t y_b, y_s, y_h;
};

struct Dims {
  int seq, heads, headdim, state, chunk, n_chunks;
  bool bf;  // xh, Bm, Cm, dy (and dx, dBm, dCm) are bf16
};

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

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
}

// The sum over the 16 threads of a row of the 16 x 16 grid (one half-warp).
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int d = 8; d >= 1; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// One warp: the inclusive prefix sums of the block's head's log decays over
// rows [0, kQ) of the chunk (rows at or past n_rows read as 0), 4 rows a
// lane; exp(cum) and exp(cum_end - cum) too, cum_end = cum[chunk - 1].
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ lp,
                                             int64_t stride, int n_rows, int chunk,
                                             float* cum, float* ecum, float* eend) {
  const int lane = threadIdx.x % 32;
  float v[4];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = lane * 4 + k;
    run += r < n_rows ? lp[r * stride] : 0.f;
    v[k] = run;
  }
  float offset = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, offset, d);
    if (lane >= d) offset += up;
  }
  offset -= run;
  float mine = v[0];
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if ((chunk - 1) % 4 == k) mine = v[k];
  }
  const float end = __shfl_sync(0xffffffffu, mine + offset, (chunk - 1) / 4);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float c = v[k] + offset;
    cum[lane * 4 + k] = c;
    ecum[lane * 4 + k] = expf(c);
    eend[lane * 4 + k] = expf(end - c);
  }
}

// The sum over a block of one value a thread, in a fixed order (the result
// on thread 0).  red: 8 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  }
  return s;
}

struct Place {
  int h, c, b, s0, n_rows;
  int64_t blk;  // (b, chunk, head)
  int64_t bhc;  // (b, head, chunk)
};

__device__ __forceinline__ Place place(const Dims& d) {
  Place pl;
  pl.h = blockIdx.x;
  pl.c = blockIdx.y;
  pl.b = blockIdx.z;
  pl.s0 = pl.c * d.chunk;
  pl.n_rows = min(d.chunk, d.seq - pl.s0);
  pl.blk = (static_cast<int64_t>(pl.b) * d.n_chunks + pl.c) * d.heads + pl.h;
  pl.bhc = (static_cast<int64_t>(pl.b) * d.heads + pl.h) * d.n_chunks + pl.c;
  return pl;
}

// ---------------------------------------------------------------------------
// 1. Chunk states and the local state gradients
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
states_kernel(const void* __restrict__ x, const float* __restrict__ la,
              const void* __restrict__ bm, const void* __restrict__ cm,
              const void* __restrict__ dy, float* __restrict__ states,
              float* __restrict__ grads, float* __restrict__ decay, Strides st_,
              Dims d) {
  __shared__ __align__(16) float As[kKB * (kTile + 4)];
  __shared__ __align__(16) float Bs[kKB * (kTile + 4)];
  __shared__ float cum[kQ], ecum[kQ], eend[kQ];
  const Place pl = place(d);
  const int64_t xo = pl.b * st_.x_b + pl.s0 * st_.x_s + pl.h * st_.x_h;
  const int64_t yo = pl.b * st_.y_b + pl.s0 * st_.y_s + pl.h * st_.y_h;
  const int64_t bo = pl.b * st_.b_b + pl.s0 * st_.b_s;
  const int64_t co = pl.b * st_.c_b + pl.s0 * st_.c_s;
  if (threadIdx.x < 32) {
    chunk_cumsum(la + pl.b * st_.l_b + pl.s0 * st_.l_s + pl.h * st_.l_h, st_.l_s,
                 pl.n_rows, d.chunk, cum, ecum, eend);
  }
  __syncthreads();
  const int P = d.headdim, N = d.state, R = pl.n_rows;
  const bool bf = d.bf;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t so = pl.bhc * P * N;
  float acc[4][4];
  // S_c[p, n] = sum_r exp(cum_end - cum_r) x[r, p] B[r, n]
  zero(acc);
  gemm<kTile, kTile, false, false>(
      acc, R,
      [&](int p, int r) { return p < P ? eend[r] * ld(x, xo + r * st_.x_s + p, bf) : 0.f; },
      [&](int r, int n) { return n < N ? ld(bm, bo + r * st_.b_s + n, bf) : 0.f; }, As, Bs);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tile_at(ty, i), n = tx + 16 * j;
      if (p < P && n < N) states[so + p * N + n] = acc[i][j];
    }
  }
  // G_c[p, n] = sum_q exp(cum_q) dy[q, p] C[q, n]
  zero(acc);
  gemm<kTile, kTile, false, false>(
      acc, R,
      [&](int p, int r) { return p < P ? ecum[r] * ld(dy, yo + r * st_.y_s + p, bf) : 0.f; },
      [&](int r, int n) { return n < N ? ld(cm, co + r * st_.c_s + n, bf) : 0.f; }, As, Bs);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tile_at(ty, i), n = tx + 16 * j;
      if (p < P && n < N) grads[so + p * N + n] = acc[i][j];
    }
  }
  if (threadIdx.x == 0) decay[pl.bhc] = ecum[d.chunk - 1];
}

// ---------------------------------------------------------------------------
// 2. State passing, forward then reverse
// ---------------------------------------------------------------------------

// Block x owns elements [1024 x, 1024 x + 1024) of (b, head) y's P x N
// state, thread t the four from 4 t as one float4 (P N is a multiple of 256
// and every state starts 16 bytes aligned), with the next chunk's loaded
// while this one's is used.  ddecay gets the block's share of <D_{c+1}, h_c>.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(kThreads)
passing_kernel(float* __restrict__ states, float* __restrict__ grads,
               const float* __restrict__ decay, float* __restrict__ ddecay,
               const float* __restrict__ h0, const float* __restrict__ dh_final,
               float* __restrict__ dh0, Dims d) {
  __shared__ float red[kThreads / 32];
  const int64_t bh = blockIdx.y;
  const int PN = d.headdim * d.state, nc = d.n_chunks;
  const int e = blockIdx.x * kPassBlock + 4 * threadIdx.x;
  const bool own = e < PN;
  const int64_t base = bh * nc * PN + e;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float run[4] = {0.f, 0.f, 0.f, 0.f};
  if (h0 != nullptr && own) {
#pragma unroll
    for (int i = 0; i < 4; ++i) run[i] = h0[bh * PN + e + i];
  }
  float4 cur = own ? ld4(states + base) : zero4;
  for (int c = 0; c < nc; ++c) {
    const float4 nxt = (own && c + 1 < nc) ? ld4(states + base + (c + 1) * PN) : zero4;
    const float dc = decay[bh * nc + c];
    if (own) {
      *reinterpret_cast<float4*>(states + base + c * PN) =
          make_float4(run[0], run[1], run[2], run[3]);
      run[0] = fmaf(dc, run[0], cur.x);
      run[1] = fmaf(dc, run[1], cur.y);
      run[2] = fmaf(dc, run[2], cur.z);
      run[3] = fmaf(dc, run[3], cur.w);
    }
    cur = nxt;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) run[i] = (dh_final != nullptr && own) ? dh_final[bh * PN + e + i] : 0.f;
  cur = own ? ld4(grads + base + (nc - 1) * PN) : zero4;
  float4 hcur = own ? ld4(states + base + (nc - 1) * PN) : zero4;
  for (int c = nc - 1; c >= 0; --c) {
    float4 nxt = zero4, hnxt = zero4;
    if (own && c > 0) {
      nxt = ld4(grads + base + (c - 1) * PN);
      hnxt = ld4(states + base + (c - 1) * PN);
    }
    const float dc = decay[bh * nc + c];
    float dot = 0.f;
    if (own) {
      dot = fmaf(run[0], hcur.x, fmaf(run[1], hcur.y, fmaf(run[2], hcur.z, run[3] * hcur.w)));
      *reinterpret_cast<float4*>(grads + base + c * PN) =
          make_float4(run[0], run[1], run[2], run[3]);
      run[0] = fmaf(dc, run[0], cur.x);
      run[1] = fmaf(dc, run[1], cur.y);
      run[2] = fmaf(dc, run[2], cur.z);
      run[3] = fmaf(dc, run[3], cur.w);
    }
    const float total = block_sum(dot, red);
    if (threadIdx.x == 0) ddecay[(bh * nc + c) * kMaxPassBlocks + blockIdx.x] = total;
    cur = nxt;
    hcur = hnxt;
  }
  if (dh0 != nullptr && own) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dh0[bh * PN + e + i] = run[i];
  }
}

// ---------------------------------------------------------------------------
// 3. Chunk matrices: W, M and the sums of T by row and column
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
chunk_mats_kernel(const void* __restrict__ x, const float* __restrict__ la,
                  const void* __restrict__ bm, const void* __restrict__ cm,
                  const void* __restrict__ dy, float* __restrict__ wmat,
                  float* __restrict__ mmat, float* __restrict__ tsum, Strides st_,
                  Dims d) {
  __shared__ __align__(16) float As[kKB * (kQ + 4)];
  __shared__ __align__(16) float Bs[kKB * (kQ + 4)];
  __shared__ float cum[kQ], ecum[kQ], eend[kQ];
  __shared__ float colp[16 * kQ];
  const Place pl = place(d);
  const int64_t xo = pl.b * st_.x_b + pl.s0 * st_.x_s + pl.h * st_.x_h;
  const int64_t yo = pl.b * st_.y_b + pl.s0 * st_.y_s + pl.h * st_.y_h;
  const int64_t bo = pl.b * st_.b_b + pl.s0 * st_.b_s;
  const int64_t co = pl.b * st_.c_b + pl.s0 * st_.c_s;
  if (threadIdx.x < 32) {
    chunk_cumsum(la + pl.b * st_.l_b + pl.s0 * st_.l_s + pl.h * st_.l_h, st_.l_s,
                 pl.n_rows, d.chunk, cum, ecum, eend);
  }
  __syncthreads();
  const int P = d.headdim, N = d.state, R = pl.n_rows, Q = d.chunk;
  const bool bf = d.bf;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float w[8][8], m[8][8];
  // C B^T, then W = C B^T (.) L in place
  zero(w);
  gemm<kQ, kQ, true, true>(
      w, N,
      [&](int q, int n) { return q < R ? ld(cm, co + q * st_.c_s + n, bf) : 0.f; },
      [&](int n, int j) { return j < R ? ld(bm, bo + j * st_.b_s + n, bf) : 0.f; }, As, Bs);
  // dy x^T
  zero(m);
  gemm<kQ, kQ, true, true>(
      m, P,
      [&](int q, int p) { return q < R ? ld(dy, yo + q * st_.y_s + p, bf) : 0.f; },
      [&](int p, int j) { return j < R ? ld(x, xo + j * st_.x_s + p, bf) : 0.f; }, As, Bs);
  const int64_t mo = pl.blk * Q * Q;
  float rows[8], cols[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) cols[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = tile_at(ty, i);
    rows[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int jj = tx + 16 * j;
      // L = exp(cum_q - cum_j) only for j <= q: above the diagonal the
      // difference can be large and positive
      const float L = jj <= q ? expf(cum[q] - cum[jj]) : 0.f;
      const float wv = w[i][j] * L;
      const float t = wv * m[i][j];
      m[i][j] *= L;
      rows[i] += t;
      cols[j] += t;
      if (q < Q && jj < Q) {
        wmat[mo + q * Q + jj] = wv;
        mmat[mo + q * Q + jj] = m[i][j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) colp[ty * kQ + tx + 16 * j] = cols[j];
#pragma unroll
  for (int i = 0; i < 8; ++i) rows[i] = row_sum(rows[i]);
  __syncthreads();
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) cum[tile_at(ty, i)] = rows[i];  // cum is free now
  }
  __syncthreads();
  if (threadIdx.x < Q) {
    float col = 0.f;
    for (int r = 0; r < 16; ++r) col += colp[r * kQ + threadIdx.x];
    tsum[pl.blk * Q + threadIdx.x] = cum[threadIdx.x] - col;
  }
}

// ---------------------------------------------------------------------------
// 4. Chunk gradients: dx, the head's dB and dC, dla
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 2)
chunk_grads_kernel(const void* __restrict__ x, const float* __restrict__ la,
                   const void* __restrict__ bm, const void* __restrict__ cm,
                   const void* __restrict__ dy, const float* __restrict__ h_enter,
                   const float* __restrict__ dstate, const float* __restrict__ wmat,
                   const float* __restrict__ mmat, const float* __restrict__ tsum,
                   const float* __restrict__ ddecay, void* __restrict__ dx,
                   float* __restrict__ dbh, float* __restrict__ dch,
                   float* __restrict__ dla, Strides st_, Dims d) {
  __shared__ __align__(16) float As[kKB * (kQ + 4)];
  __shared__ __align__(16) float Bs[kKB * (kTile + 4)];
  __shared__ float cum[kQ], ecum[kQ], eend[kQ], ev[kQ], fv[kQ];
  const Place pl = place(d);
  const int64_t xo = pl.b * st_.x_b + pl.s0 * st_.x_s + pl.h * st_.x_h;
  const int64_t yo = pl.b * st_.y_b + pl.s0 * st_.y_s + pl.h * st_.y_h;
  const int64_t bo = pl.b * st_.b_b + pl.s0 * st_.b_s;
  const int64_t co = pl.b * st_.c_b + pl.s0 * st_.c_s;
  if (threadIdx.x < 32) {
    chunk_cumsum(la + pl.b * st_.l_b + pl.s0 * st_.l_s + pl.h * st_.l_h, st_.l_s,
                 pl.n_rows, d.chunk, cum, ecum, eend);
  }
  __syncthreads();
  const int P = d.headdim, N = d.state, R = pl.n_rows, Q = d.chunk;
  const bool bf = d.bf;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t so = pl.bhc * P * N;
  const int64_t mo = pl.blk * Q * Q;
  const float* W = wmat + mo;
  const float* M = mmat + mo;
  float acc[8][4];

  // dx[j, p] = exp(cum_end - cum_j) (B dS^T)[j, p] + (W^T dy)[j, p]
  zero(acc);
  gemm<kQ, kTile, true, true>(
      acc, N,
      [&](int j, int n) { return j < R ? ld(bm, bo + j * st_.b_s + n, bf) : 0.f; },
      [&](int n, int p) { return p < P ? dstate[so + p * N + n] : 0.f; }, As, Bs);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] *= eend[tile_at(ty, i)];
  }
  gemm<kQ, kTile, false, false>(
      acc, R, [&](int j, int q) { return j < R ? W[q * Q + j] : 0.f; },
      [&](int q, int p) { return p < P ? ld(dy, yo + q * st_.y_s + p, bf) : 0.f; }, As, Bs);
  {
    const int64_t out = ((static_cast<int64_t>(pl.b) * d.seq + pl.s0) * d.heads + pl.h) * P;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tile_at(ty, i), p = tx + 16 * j;
        if (r < R && p < P) st(dx, out + static_cast<int64_t>(r) * d.heads * P + p, acc[i][j], bf);
      }
    }
  }

  // dB[j, n] = exp(cum_end - cum_j) (x dS)[j, n] + (M^T C)[j, n]; F_j =
  // exp(cum_end - cum_j) sum_n (x dS)[j, n] B[j, n]
  const int64_t ho = pl.blk * Q * N;
  zero(acc);
  gemm<kQ, kTile, true, false>(
      acc, P,
      [&](int j, int p) { return j < R ? ld(x, xo + j * st_.x_s + p, bf) : 0.f; },
      [&](int p, int n) { return n < N ? dstate[so + p * N + n] : 0.f; }, As, Bs);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tile_at(ty, i);
    float f = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tx + 16 * j;
      if (r < R && n < N) f = fmaf(acc[i][j], ld(bm, bo + r * st_.b_s + n, bf), f);
      acc[i][j] *= eend[r];
    }
    f = row_sum(f);
    if (tx == 0) fv[r] = eend[r] * f;
  }
  gemm<kQ, kTile, false, false>(
      acc, R, [&](int j, int q) { return j < R ? M[q * Q + j] : 0.f; },
      [&](int q, int n) { return n < N ? ld(cm, co + q * st_.c_s + n, bf) : 0.f; }, As, Bs);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tile_at(ty, i), n = tx + 16 * j;
      if (r < Q && n < N) dbh[ho + r * N + n] = acc[i][j];
    }
  }

  // dC[q, n] = exp(cum_q) (dy h_c)[q, n] + (M B)[q, n]; E_q = exp(cum_q)
  // sum_n (dy h_c)[q, n] C[q, n]
  zero(acc);
  gemm<kQ, kTile, true, false>(
      acc, P,
      [&](int q, int p) { return q < R ? ld(dy, yo + q * st_.y_s + p, bf) : 0.f; },
      [&](int p, int n) { return n < N ? h_enter[so + p * N + n] : 0.f; }, As, Bs);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tile_at(ty, i);
    float e = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tx + 16 * j;
      if (r < R && n < N) e = fmaf(acc[i][j], ld(cm, co + r * st_.c_s + n, bf), e);
      acc[i][j] *= ecum[r];
    }
    e = row_sum(e);
    if (tx == 0) ev[r] = ecum[r] * e;
  }
  gemm<kQ, kTile, true, false>(
      acc, R, [&](int q, int j) { return q < R ? M[q * Q + j] : 0.f; },
      [&](int j, int n) { return n < N ? ld(bm, bo + j * st_.b_s + n, bf) : 0.f; }, As, Bs);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tile_at(ty, i), n = tx + 16 * j;
      if (r < Q && n < N) dch[ho + r * N + n] = acc[i][j];
    }
  }
  __syncthreads();

  // dcum, then dla = its reverse prefix sum in the chunk (one warp, 4 rows a
  // lane; rows at or past the chunk are 0)
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float v[4];
    float fsum = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = lane * 4 + k;
      const bool in = r < R;
      v[k] = in ? tsum[pl.blk * Q + r] + ev[r] - fv[r] : 0.f;
      fsum += in ? fv[r] : 0.f;
    }
#pragma unroll
    for (int dd = 16; dd >= 1; dd >>= 1) fsum += __shfl_xor_sync(0xffffffffu, fsum, dd);
    // cum_end is cum[Q - 1]: its gradient (the F terms and the decay's) lands
    // on row Q - 1, which a ragged chunk's dla never reads past R - 1 but
    // every earlier row sums
    // the decay's share: exp(cum_end) <D_{c+1}, h_c>, summed by block in order
    float dd = 0.f;
    for (int i = 0; i < (d.headdim * d.state + kPassBlock - 1) / kPassBlock; ++i) {
      dd += ddecay[pl.bhc * kMaxPassBlocks + i];
    }
    dd *= ecum[Q - 1];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (lane * 4 + k == Q - 1) v[k] += fsum + dd;
    }
    float run = 0.f;
#pragma unroll
    for (int k = 3; k >= 0; --k) {
      run += v[k];
      v[k] = run;
    }
    float offset = run;
#pragma unroll
    for (int dd = 1; dd < 32; dd <<= 1) {
      const float down = __shfl_down_sync(0xffffffffu, offset, dd);
      if (lane + dd < 32) offset += down;
    }
    offset -= run;  // the sum of the lanes after this one
    const int64_t out = (static_cast<int64_t>(pl.b) * d.seq + pl.s0) * d.heads + pl.h;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = lane * 4 + k;
      if (r < R) dla[out + static_cast<int64_t>(r) * d.heads] = v[k] + offset;
    }
  }
}

// ---------------------------------------------------------------------------
// 5. Head sum
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
head_sum_kernel(const float* __restrict__ dbh, const float* __restrict__ dch,
                void* __restrict__ dbm, void* __restrict__ dcm, Dims d, int batch) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int N = d.state, Q = d.chunk;
  if (i >= static_cast<int64_t>(batch) * d.seq * N) return;
  const int n = static_cast<int>(i % N);
  const int64_t bs = i / N;
  const int s = static_cast<int>(bs % d.seq);
  const int b = static_cast<int>(bs / d.seq);
  const int c = s / Q, r = s % Q;
  const int64_t blk0 = (static_cast<int64_t>(b) * d.n_chunks + c) * d.heads;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < d.heads; ++h) {
    const int64_t o = ((blk0 + h) * Q + r) * N + n;
    sb += dbh[o];
    sc += dch[o];
  }
  st(dbm, i, sb, d.bf);
  st(dcm, i, sc, d.bf);
}

}  // namespace

// xh (B, S, H, P), la (B, S, H) f32, bm / cm (B, S, N), h0 (B, H, P, N) f32
// contiguous or null, dy (B, S, H, P), dh_final (B, H, P, N) f32 contiguous
// or null; out: dxh (B, S, H, P), dla (B, S, H) f32, dbm / dcm (B, S, N),
// dh0 (B, H, P, N) f32 or null, all contiguous; scratch: f32, as many
// elements as repro_torch/kernels/ssd_scan_bwd.py::scratch_floats; device
// pointers.  strides: 13 element strides, (b, s, h) of xh, (b, s, h) of la,
// (b, s) of bm, (b, s) of cm, (b, s, h) of dy; the P and N dims are unit.
// dtype (of xh, bm, cm, dy and the gradients but dla and dh0): 0 float32,
// 1 bfloat16.  1 <= chunk <= 128; P and N at most 64, P N a multiple of 256.
extern "C" int repro_ssd_scan_bwd(const void* xh, const void* la, const void* bm,
                                  const void* cm, const void* h0, const void* dy,
                                  const void* dh_final, void* dxh, void* dla, void* dbm,
                                  void* dcm, void* dh0, void* scratch,
                                  const int64_t* strides, int batch, int seq, int heads,
                                  int headdim, int state, int chunk, int dtype,
                                  void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0) {
    return 0;
  }
  const int n_chunks = (seq + chunk - 1) / chunk;
  if (chunk < 1 || chunk > kQ || headdim < 1 || headdim > kTile || state < 1 ||
      state > kTile || (headdim * state) % 256 || n_chunks > 65535 || batch > 65535 ||
      heads > 65535 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t* s = strides;
  const Strides st_{s[0], s[1], s[2], s[3], s[4], s[5], s[6],
                    s[7], s[8], s[9], s[10], s[11], s[12]};
  const Dims d{seq, heads, headdim, state, chunk, n_chunks, dtype == 1};
  const int64_t blocks = static_cast<int64_t>(batch) * n_chunks * heads;
  const int64_t pn = static_cast<int64_t>(headdim) * state;
  float* states = static_cast<float*>(scratch);
  float* grads = states + blocks * pn;
  float* wmat = grads + blocks * pn;
  float* mmat = wmat + blocks * chunk * chunk;
  float* dbh = mmat + blocks * chunk * chunk;
  float* dch = dbh + blocks * chunk * state;
  float* tsum = dch + blocks * chunk * state;
  float* decay = tsum + blocks * chunk;
  float* ddecay = decay + blocks;  // (b, head, chunk, kMaxPassBlocks)
  const auto* la_f = static_cast<const float*>(la);
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  const dim3 grid(heads, n_chunks, batch);
  states_kernel<<<grid, kThreads, 0, stream_>>>(xh, la_f, bm, cm, dy, states, grads,
                                               decay, st_, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 pass_grid((headdim * state + kPassBlock - 1) / kPassBlock, batch * heads);
  passing_kernel<<<pass_grid, kThreads, 0, stream_>>>(
      states, grads, decay, ddecay, static_cast<const float*>(h0),
      static_cast<const float*>(dh_final), static_cast<float*>(dh0), d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_mats_kernel<<<grid, kThreads, 0, stream_>>>(xh, la_f, bm, cm, dy, wmat, mmat,
                                                   tsum, st_, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_grads_kernel<<<grid, kThreads, 0, stream_>>>(
      xh, la_f, bm, cm, dy, states, grads, wmat, mmat, tsum, ddecay, dxh, dbh, dch,
      static_cast<float*>(dla), st_, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t outs = static_cast<int64_t>(batch) * seq * state;
  head_sum_kernel<<<static_cast<unsigned>((outs + kThreads - 1) / kThreads), kThreads, 0,
                    stream_>>>(dbh, dch, dbm, dcm, d, batch);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
