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
// gradient of the state leaving it, one call runs four passes on the
// caller's stream, by one of two routes (repro_torch/kernels/
// ssd_scan_bwd.py::kernel_route):
//
//   1. chunk states: the chunk's own state S_c = sum_j exp(cum_end - cum_j)
//      x_j (x) B_j and its decay exp(cum_end) (as the forward's pass 1),
//      and G_c = sum_q exp(cum_q) dy_q (x) C_q, the gradient its outputs
//      send to h_c;
//   2. state passing, elementwise over the P x N state, 1024 elements a
//      block: in chunk order the entering states h_c, then in reverse D_c =
//      G_c + exp(cum_end_c) D_{c+1} from dh_final or zero, dh0 = D_0, and
//      <D_{c+1}, h_c> by block, in a fixed order;
//   3. chunk gradients: with W = C B^T (.) L and M = L (.) dy x^T, dx = W^T
//      dy + exp(cum_end - cum) (.) B dS^T; dB = M^T C + exp(cum_end - cum)
//      (.) x dS and dC = M B + exp(cum) (.) dy h_c; dcum from the sums of T
//      = W (.) dy x^T by row minus by column, the carry term, S_c and the
//      decay, and dla its reverse prefix sum in the chunk;
//   4. head sum: dBm and dCm, each the sum of the partials of dB / dC in
//      order (a head's, or on the bf16 route a group of heads').  No kernel uses atomics, so two calls give equal bits.
//
//   * bf16, namespace tc: the products on wgmma (bf16 in, f32 accumulate).
//     xh, Bm, Cm, dy are exact bf16, so C B^T and dy x^T are single bf16
//     products; every f32 operand is split into hi = bf16(x) and lo =
//     bf16(x - hi), about 16 significant bits, with its row scalar applied
//     first: the chunk states' exp(cum_end - cum) (.) Bm and exp(cum) (.) Cm
//     ([hi | lo] side by side as one N = 128 operand, as the forward's pass
//     1), W and M (in shared memory), h_c and dS (pass 2 writes them as a hi
//     and a lo tile in the layout pass 3's copies take), so W^T dy, M^T C,
//     M B, B dS^T, x dS and dy h_c each take two bf16 products.  Pass 1 is
//     one warpgroup a (b, chunk, group of heads) with Bm's and Cm's tiles
//     copied once; pass 3 is one kernel a (b, chunk, group of heads) that
//     keeps W and then M on chip (no scratch) and sums dB and dC over the
//     group's heads in registers, so pass 4 adds a group's partials, not a
//     head's.  A group is 8 heads, halved while the blocks would not fill
//     the card (the reduced zamba2's 32 (b, chunk) pairs take groups of 1).  Tiles are 128 positions x 64 columns of bf16 in 128-byte
//     swizzled rows, filled by 16-byte cp.async copies that read zeros past
//     S, past the chunk and past P or N (the wrapper copies rows that are
//     not 16-byte aligned); the next head's tiles are copied as soon as the
//     previous head is done with each;
//   * f32: every product on the CUDA cores in f32 through one tiled routine
//     (shared tiles of 16 values of k, register tiles of 8 x 8, 8 x 4 or
//     4 x 4 outputs a thread, each thread's rows in groups of four read as
//     float4s), pass 3 as two kernels a (b, chunk, head) with W and M in
//     scratch; operands read element by element through their strides.
//
// Positions past S read as zero, so a ragged tail contributes nothing and
// nothing is padded.
//
// What bounds it: at zamba2-1.2b's train shape (B 2, S 4096, H 64, P = N =
// 64, chunks of 128, bf16) the function reads and writes ~210 MB (0.063 ms
// at 3.35 TB/s) and needs ~39 GFLOP on its causal triangles (0.039 ms at
// the bf16 tensor-core rate): the bytes.  The tensor-core route moves ~0.2
// GB more (the states and their images, the groups' partials) and runs
// ~55 GFLOP of bf16 products; its time goes to pass 3, one block an SM
// (two warpgroups, 170 KB of shared memory) walking 8 heads with a wgmma
// wait between each of a head's products.  The f32 route runs ~61 GFLOP on
// the CUDA cores and ~1.1 GB of scratch.  PERF.md gives the measured split
// by kernel.
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

// dBm and dCm: the sums of `parts` partials of dB / dC a (b, chunk), in
// order: a head's (f32) or a group of heads' (bf16).
__global__ void __launch_bounds__(kThreads)
head_sum_kernel(const float* __restrict__ dbh, const float* __restrict__ dch,
                void* __restrict__ dbm, void* __restrict__ dcm, Dims d, int batch, int parts) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int N = d.state, Q = d.chunk;
  if (i >= static_cast<int64_t>(batch) * d.seq * N) return;
  const int n = static_cast<int>(i % N);
  const int64_t bs = i / N;
  const int s = static_cast<int>(bs % d.seq);
  const int b = static_cast<int>(bs / d.seq);
  const int c = s / Q, r = s % Q;
  const int64_t blk0 = (static_cast<int64_t>(b) * d.n_chunks + c) * parts;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < parts; ++h) {
    const int64_t o = ((blk0 + h) * Q + r) * N + n;
    sb += dbh[o];
    sc += dch[o];
  }
  st(dbm, i, sb, d.bf);
  st(dcm, i, sc, d.bf);
}

// ---------------------------------------------------------------------------
// bf16: the products on wgmma
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kPanel = kQ * 128;   // bytes of a 128 x 64 bf16 panel (128-byte rows)
constexpr int kHalf = kPanel / 2;  // bytes of its first or last 64 rows
constexpr int kMaxGroup = 8;       // heads a block takes, at most
constexpr int kImage = kPanel / 4;  // floats of a state image: hi rows 0-63, lo 64-127
constexpr int kPassBlocks = 4;     // blocks of the padded 64 x 64 state a (b, head)

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

// The block's copies and stores are in and visible to wgmma.
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
// A tile read K-major (rows are M or N, its 64 columns K) from k16 step kk,
// or MN-major (rows are K, 16 a step; its 64 columns M or N, and for N = 128
// the next 64 columns a panel on).
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return make_desc(tile + kk * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 2048, kPanel, 1024);
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

// Byte offset of element (row, col) of a tile of 128-byte rows in the
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

// Rows [0, n_rows) and columns [0, cols) of a (128, 64) bf16 tile of `src`
// (row stride `stride` elements, 16-byte aligned rows) into the tile at
// dst; zeros elsewhere.  The block's kThr threads issue 16-byte copies.
template <int kThr>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* __restrict__ src,
                                          int64_t stride, int n_rows, int cols) {
  for (int i = threadIdx.x; i < kQ * 8; i += kThr) {
    const int r = i >> 3, k = (i & 7) * 8;
    const bool ok = r < n_rows && k < cols;
    cp_async16(dst + swz(r, k), ok ? src + r * stride + k : src, ok);
  }
}

template <int kThr>
__device__ __forceinline__ void copy_image(uint32_t dst, const float* src) {
  for (int i = threadIdx.x; i < kPanel / 16; i += kThr) cp_async16(dst + 16 * i, src + 4 * i, true);
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// The sum over the four lanes that share a row of an accumulator.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// The block's place: batch row, chunk, first head and heads of its group.
struct Group {
  int b, c, s0, n_rows, h0, n_heads, grp;
};
__device__ __forceinline__ Group group_of(const Dims& d, int group) {
  Group g;
  g.grp = blockIdx.x;
  g.h0 = blockIdx.x * group;
  g.n_heads = min(group, d.heads - g.h0);
  g.c = blockIdx.y;
  g.b = blockIdx.z;
  g.s0 = g.c * d.chunk;
  g.n_rows = min(d.chunk, d.seq - g.s0);
  return g;
}

// One warp: the inclusive prefix sums of a head's log decays over rows
// [0, kQ) (rows at or past n_rows read as 0, so cum[kQ - 1] is the chunk's
// total), 4 rows a lane.
__device__ __forceinline__ void warp_cumsum(const float* __restrict__ lp, int64_t stride,
                                            int n_rows, float* cum) {
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
  for (int dd = 1; dd < 32; dd <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, offset, dd);
    if (lane >= dd) offset += up;
  }
  offset -= run;
#pragma unroll
  for (int k = 0; k < 4; ++k) cum[lane * 4 + k] = v[k] + offset;
}

// ---------------------------------------------------------------------------
// 1. Chunk states on wgmma, one warpgroup a (b, chunk, group of heads), as
// the forward's pass 1: per head S_c = xh^T [hi | lo] of exp(cum_end - cum)
// (.) Bm and G_c = dy^T [hi | lo] of exp(cum) (.) Cm, each one m64n128k16
// product a k16 step (xh, dy MN-major as A).  Bm's and Cm's tiles are copied
// once for the group.  Shared memory: Bm, Cm, xh, dy and the two [hi | lo]
// operands, eight tiles, 128 KB.
// ---------------------------------------------------------------------------

constexpr int kStatesThreads = 128;
constexpr int kStatesSmem = 1024 + 8 * kPanel + kMaxGroup * kQ * 4;

__global__ void __launch_bounds__(kStatesThreads, 1)
states_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ la,
                 const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                 const bf16* __restrict__ dy, float* __restrict__ states,
                 float* __restrict__ grads, float* __restrict__ decay, Strides st_, Dims d,
                 int group) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* gb = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(gb);
  auto tile = [&](int i) { return base + i * kPanel; };
  float* cum_s = reinterpret_cast<float*>(gb + 8 * kPanel);
  const Group pl = group_of(d, group);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = 16 * warp + lane / 4, col0 = 2 * (lane % 4);
  const int P = d.headdim, N = d.state, R = pl.n_rows;
  // tiles: 0 Bm, 1 Cm, 2 xh, 3 dy, 4-5 [hi | lo] of the Bm operand, 6-7 Cm's
  load_tile<kStatesThreads>(tile(0), bm + pl.b * st_.b_b + pl.s0 * st_.b_s, st_.b_s, R, N);
  load_tile<kStatesThreads>(tile(1), cm + pl.b * st_.c_b + pl.s0 * st_.c_s, st_.c_s, R, N);
  cp_async_commit();
  for (int g = warp; g < pl.n_heads; g += kStatesThreads / 32) {
    warp_cumsum(la + pl.b * st_.l_b + pl.s0 * st_.l_s + (pl.h0 + g) * st_.l_h, st_.l_s, R,
                cum_s + g * kQ);
  }
  const int n_steps = (R + 15) / 16;
  for (int g = 0; g < pl.n_heads; ++g) {
    const int h = pl.h0 + g;
    __syncthreads();  // the previous head is done with its tiles
    load_tile<kStatesThreads>(tile(2), x + pl.b * st_.x_b + pl.s0 * st_.x_s + h * st_.x_h,
                              st_.x_s, R, P);
    load_tile<kStatesThreads>(tile(3), dy + pl.b * st_.y_b + pl.s0 * st_.y_s + h * st_.y_h,
                              st_.y_s, R, P);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();  // Bm's and Cm's tiles and the prefix sums are in
    const float* cum = cum_s + g * kQ;
    const float cum_end = cum[kQ - 1];
    for (int i = tid; i < kQ * 8; i += kStatesThreads) {
      const int r = i >> 3, k = (i & 7) * 8;
      const uint32_t o = swz(r, k);
      const float sb = expf(cum_end - cum[r]), sc = expf(cum[r]);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        float f[8];
        unpack8(*reinterpret_cast<const uint4*>(gb + m * kPanel + o), f);
        const float s = m == 0 ? sb : sc;
        uint4 hv, lv;
        split2(f[0] * s, f[1] * s, hv.x, lv.x);
        split2(f[2] * s, f[3] * s, hv.y, lv.y);
        split2(f[4] * s, f[5] * s, hv.z, lv.z);
        split2(f[6] * s, f[7] * s, hv.w, lv.w);
        *reinterpret_cast<uint4*>(gb + (4 + 2 * m) * kPanel + o) = hv;
        *reinterpret_cast<uint4*>(gb + (5 + 2 * m) * kPanel + o) = lv;
      }
    }
    fence_proxy_async();
    __syncthreads();
    const int64_t so = ((static_cast<int64_t>(pl.b) * d.heads + h) * d.n_chunks + pl.c) * P * N;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      float acc[64];
      wgmma_fence();
      for (int kk = 0; kk < n_steps; ++kk) {
        wgmma128<1, 1>(acc, desc_mn(tile(2 + m), kk), desc_mn(tile(4 + 2 * m), kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      float* out = (m == 0 ? states : grads) + so;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * j + 2 * hh, p = row0 + 8 * hh, n = 8 * j + col0;
          if (p < P && n < N) {
            *reinterpret_cast<float2*>(out + p * N + n) =
                make_float2(acc[i] + acc[32 + i], acc[i + 1] + acc[33 + i]);
          }
        }
      }
    }
    if (tid == 0) {
      decay[(static_cast<int64_t>(pl.b) * d.heads + h) * d.n_chunks + pl.c] = expf(cum_end);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. State passing, both directions, over the padded 64 x 64 state: thread t
// of block x owns elements e .. e + 3, e = 4 (256 x + t), row p = e / 64,
// columns n = e % 64 .. + 3 (zero past P, N).  Forward: h_c from h0 or zero,
// written as an image (hi in rows 0-63, lo in rows 64-127 of a 128-row tile,
// swizzled); reverse: D_c = G_c + decay_c D_{c+1} from dh_final or zero,
// dS = D_{c+1} written as an image, decay_c <D_{c+1}, h_c> by block, dh0.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
passing_tc_kernel(const float* __restrict__ states, const float* __restrict__ grads,
                  const float* __restrict__ decay, float* __restrict__ ddecay,
                  float* __restrict__ himg, float* __restrict__ dimg,
                  const float* __restrict__ h0, const float* __restrict__ dh_final,
                  float* __restrict__ dh0, Dims d) {
  __shared__ float red[kThreads / 32];
  const int64_t bh = blockIdx.y;
  const int P = d.headdim, N = d.state, PN = P * N, nc = d.n_chunks;
  const int e = (blockIdx.x * kThreads + threadIdx.x) * 4;
  const int p = e / 64, n = e % 64;
  const bool live = p < P && n < N;
  const int64_t base = bh * nc * PN + p * N + n;
  const uint32_t o_hi = swz(p, n), o_lo = swz(64 + p, n);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  auto img = [&](float* im, int c) {
    return reinterpret_cast<unsigned char*>(im + (bh * nc + c) * kImage);
  };
  auto put = [&](float* im, int c, const float (&v)[4]) {
    uint2 hv, lv;
    split2(v[0], v[1], hv.x, lv.x);
    split2(v[2], v[3], hv.y, lv.y);
    *reinterpret_cast<uint2*>(img(im, c) + o_hi) = hv;
    *reinterpret_cast<uint2*>(img(im, c) + o_lo) = lv;
  };
  float run[4] = {0.f, 0.f, 0.f, 0.f};
  if (h0 != nullptr && live) {
#pragma unroll
    for (int i = 0; i < 4; ++i) run[i] = h0[bh * PN + p * N + n + i];
  }
  float4 cur = live ? ld4(states + base) : zero4;
  for (int c = 0; c < nc; ++c) {
    const float4 nxt = (live && c + 1 < nc) ? ld4(states + base + (c + 1) * PN) : zero4;
    const float dc = decay[bh * nc + c];
    put(himg, c, run);
    run[0] = fmaf(dc, run[0], cur.x);
    run[1] = fmaf(dc, run[1], cur.y);
    run[2] = fmaf(dc, run[2], cur.z);
    run[3] = fmaf(dc, run[3], cur.w);
    cur = nxt;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    run[i] = (dh_final != nullptr && live) ? dh_final[bh * PN + p * N + n + i] : 0.f;
  }
  cur = live ? ld4(grads + base + (nc - 1) * PN) : zero4;
  for (int c = nc - 1; c >= 0; --c) {
    const float4 nxt = (live && c > 0) ? ld4(grads + base + (c - 1) * PN) : zero4;
    const uint2 hh = *reinterpret_cast<const uint2*>(img(himg, c) + o_hi);
    const uint2 hl = *reinterpret_cast<const uint2*>(img(himg, c) + o_lo);
    const float2 a = join2(hh.x, hl.x), b = join2(hh.y, hl.y);
    const float dc = decay[bh * nc + c];
    const float dot = fmaf(run[0], a.x, fmaf(run[1], a.y, fmaf(run[2], b.x, run[3] * b.y)));
    put(dimg, c, run);
    run[0] = fmaf(dc, run[0], cur.x);
    run[1] = fmaf(dc, run[1], cur.y);
    run[2] = fmaf(dc, run[2], cur.z);
    run[3] = fmaf(dc, run[3], cur.w);
    const float total = block_sum(dot, red);
    if (threadIdx.x == 0) ddecay[(bh * nc + c) * kPassBlocks + blockIdx.x] = total;
    cur = nxt;
  }
  if (dh0 != nullptr && live) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dh0[bh * PN + p * N + n + i] = run[i];
  }
}

// ---------------------------------------------------------------------------
// 3. Chunk gradients on wgmma, one block a (b, chunk, group of heads), two
// warpgroups, warpgroup wg owning rows 64 wg .. + 63 of every Q x Q matrix
// and of dx, dB, dC.  dB and dC are summed over the group's heads in
// registers, in head order.  Per head, one Q x Q matrix at a time in
// shared memory as bf16 hi + lo parts (four tiles, 64 KB):
//   * W = C B^T (.) L, C B^T formed 64 columns at a time (m64n64k16, Cm's
//     and Bm's tiles K-major, four k16 steps), warpgroup 0's columns 64-127
//     skipped (above the diagonal); W serves dx = exp(cum_end - cum) (.)
//     B dS^T + W^T dy (dS's image K-major; W's parts MN-major, the k16 steps
//     above the diagonal skipped);
//   * dy x^T, also 64 columns at a time and skipped where the causal
//     triangle zeroes it (one bf16 product); T = W (.) dy x^T by row and
//     column; M = L (.) dy x^T as parts over W's, whose parts then serve
//     dC += exp(cum) (.) dy h_c + M B and dB += exp(cum_end - cum) (.) x dS
//     + M^T C (h_c's and dS's images MN-major);
//   * dcum from T, the carry term, S_c and the decay; dla its reverse prefix
//     sum in the chunk, by one warp while the next head's tiles are copied.
// C B^T is formed again a head, not held for the group, and the Q x Q
// products run in 64-column halves: holding C B^T (64 registers) and a
// whole dy x^T beside the group's sums took 255 registers and spilled 4 KB
// (PERF.md gives the variants measured).  Shared memory: Cm, Bm, xh, dy,
// the two state images, the four part tiles (160 KB), the prefix sums of
// the group's heads, and per-row sums.
// ---------------------------------------------------------------------------

constexpr int kChunkSmem = 1024 + 10 * kPanel;

__global__ void __launch_bounds__(kThreads, 1)
chunk_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ la,
                const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                const bf16* __restrict__ dy, const float* __restrict__ himg,
                const float* __restrict__ dimg, const float* __restrict__ ddecay,
                bf16* __restrict__ dx, float* __restrict__ dbg, float* __restrict__ dcg,
                float* __restrict__ dla, Strides st_, Dims d, int group) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* gb = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(gb);
  __shared__ float cum_s[kMaxGroup][kQ];
  __shared__ float ecum[kQ], eend[kQ], rowt[kQ], ev[kQ], fv[kQ];
  __shared__ float colp[kThreads / 32][kQ];
  auto tile = [&](int i) { return base + i * kPanel; };
  // tiles: 0 Cm, 1 Bm, 2 xh, 3 dy, 4 h_c's image, 5 dS's image, 6-9 the
  // parts of W, then of M: hi columns 0-63, 64-127, lo the same
  auto part = [&](bool lo, int c) { return gb + ((lo ? 8 : 6) + c / 64) * kPanel; };
  const Group pl = group_of(d, group);
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32, lane = tid % 32;
  const int row0 = 64 * wg + 16 * (warp % 4) + lane / 4, col0 = 2 * (lane % 4);
  const int P = d.headdim, N = d.state, R = pl.n_rows, Q = d.chunk;
  const int k_p = (P + 15) / 16, k_n = (N + 15) / 16;
  auto bhc_of = [&](int g) {
    return (static_cast<int64_t>(pl.b) * d.heads + pl.h0 + g) * d.n_chunks + pl.c;
  };
  // a head's xh and dS's image (the last read, by dB), and its dy and h_c's
  // image (by dC), each pair copied as soon as the previous head is done
  // with it
  auto load_x = [&](int g) {
    load_tile<kThreads>(tile(2), x + pl.b * st_.x_b + pl.s0 * st_.x_s + (pl.h0 + g) * st_.x_h,
                        st_.x_s, R, P);
    copy_image<kThreads>(tile(5), dimg + bhc_of(g) * kImage);
    cp_async_commit();
  };
  auto load_dy = [&](int g) {
    load_tile<kThreads>(tile(3), dy + pl.b * st_.y_b + pl.s0 * st_.y_s + (pl.h0 + g) * st_.y_h,
                        st_.y_s, R, P);
    copy_image<kThreads>(tile(4), himg + bhc_of(g) * kImage);
    cp_async_commit();
  };
  load_tile<kThreads>(tile(0), cm + pl.b * st_.c_b + pl.s0 * st_.c_s, st_.c_s, R, N);
  load_tile<kThreads>(tile(1), bm + pl.b * st_.b_b + pl.s0 * st_.b_s, st_.b_s, R, N);
  load_x(0);
  load_dy(0);
  for (int g = warp; g < pl.n_heads; g += kThreads / 32) {
    warp_cumsum(la + pl.b * st_.l_b + pl.s0 * st_.l_s + (pl.h0 + g) * st_.l_h, st_.l_s, R,
                cum_s[g]);
  }
  stage_ready();
  float dbs[32], dcs[32];  // the group's dB (rows j) and dC (rows q)
#pragma unroll
  for (int i = 0; i < 32; ++i) dbs[i] = dcs[i] = 0.f;
  const int k0 = 4 * wg;  // the first k16 step of q at or past this warpgroup's rows

  for (int g = 0; g < pl.n_heads; ++g) {
    const int h = pl.h0 + g;
    const float* cum = cum_s[g];
    if (tid < kQ) {
      ecum[tid] = expf(cum[tid]);
      eend[tid] = expf(cum[kQ - 1] - cum[tid]);
    }
    // W = C B^T (.) L, L[q][j] = exp(cum_q - cum_j) for j <= q (above the
    // diagonal the difference can be large and positive), as parts, 64
    // columns at a time (m64n64k16, rows q = row0 (+ 8), columns 64 jh +
    // 8 i + col0 (+ 1), register 4 i + 2 h (+ 1)); warpgroup 0's columns
    // 64-127 lie above the diagonal, and nothing reads their parts
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      if (jh > wg) continue;
      float cb[32];
      wgmma_fence();
      for (int kk = 0; kk < k_n; ++kk) {
        wgmma64<0, 0>(cb, desc_k(tile(0) + wg * kHalf, kk), desc_k(tile(1) + jh * kHalf, kk),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(cb);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int q = row0 + 8 * hh;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int j = 64 * jh + 8 * i + col0;
          const float w0 = j <= q ? cb[4 * i + 2 * hh] * expf(cum[q] - cum[j]) : 0.f;
          const float w1 = j + 1 <= q ? cb[4 * i + 2 * hh + 1] * expf(cum[q] - cum[j + 1]) : 0.f;
          uint32_t hv, lv;
          split2(w0, w1, hv, lv);
          *reinterpret_cast<uint32_t*>(part(false, j) + swz(q, j & 63)) = hv;
          *reinterpret_cast<uint32_t*>(part(true, j) + swz(q, j & 63)) = lv;
        }
      }
    }
    stage_ready();  // this head's tiles, W's parts, ecum and eend
    const int64_t out = ((static_cast<int64_t>(pl.b) * d.seq + pl.s0) * d.heads + h) * P;
    {
      // dx = exp(cum_end - cum_j) (.) (B dS^T) + W^T dy: rows j, columns p
      float a[32];
      wgmma_fence();
      for (int kk = 0; kk < k_n; ++kk) {
        const uint64_t da = desc_k(tile(1) + wg * kHalf, kk);
        wgmma64<0, 0>(a, da, desc_k(tile(5), kk), kk > 0);
        wgmma64<0, 0>(a, da, desc_k(tile(5) + kHalf, kk), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(a);
#pragma unroll
      for (int i = 0; i < 32; ++i) a[i] *= eend[row0 + 8 * ((i / 2) % 2)];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk >= k0) {
          const uint64_t db = desc_mn(tile(3), kk);
          wgmma64<1, 1>(a, desc_mn(tile(6 + wg), kk), db, 1);
          wgmma64<1, 1>(a, desc_mn(tile(8 + wg), kk), db, 1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(a);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = row0 + 8 * hh;
        if (j < R) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int p = 8 * i + col0;
            if (p < P) {
              *reinterpret_cast<__nv_bfloat162*>(dx + out + static_cast<int64_t>(j) * d.heads * P +
                                                 p) =
                  __floats2bfloat162_rn(a[4 * i + 2 * hh], a[4 * i + 2 * hh + 1]);
            }
          }
        }
      }
    }
    __syncthreads();  // both warpgroups' products are done with W's parts
    {
      // dy x^T, 64 columns at a time; T = W (.) dy x^T by row and column; M
      // = L (.) dy x^T as parts, in place of W's (each thread reads and
      // writes its own elements); warpgroup 0's columns 64-127 are zero.
      // A column's sum: this thread's two rows, the warp's rows (lanes 4
      // apart), then the warps in order (by the dla warp)
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int jh = 0; jh < 2; ++jh) {
        if (jh > wg) {
          if (lane < 4) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              colp[warp][64 * jh + 8 * i + col0] = 0.f;
              colp[warp][64 * jh + 8 * i + col0 + 1] = 0.f;
            }
          }
          continue;
        }
        float m[32];
        wgmma_fence();
        for (int kk = 0; kk < k_p; ++kk) {
          wgmma64<0, 0>(m, desc_k(tile(3) + wg * kHalf, kk), desc_k(tile(2) + jh * kHalf, kk),
                        kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(m);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int j = 64 * jh + 8 * i + col0;
          float c0 = 0.f, c1 = 0.f;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int q = row0 + 8 * hh;
            const uint32_t o = swz(q, j & 63);
            uint32_t* ph = reinterpret_cast<uint32_t*>(part(false, j) + o);
            uint32_t* pl_ = reinterpret_cast<uint32_t*>(part(true, j) + o);
            const float2 wv = join2(*ph, *pl_);
            const float t0 = wv.x * m[4 * i + 2 * hh], t1 = wv.y * m[4 * i + 2 * hh + 1];
            rs[hh] += t0 + t1;
            c0 += t0;
            c1 += t1;
            const float m0 = j <= q ? m[4 * i + 2 * hh] * expf(cum[q] - cum[j]) : 0.f;
            const float m1 = j + 1 <= q ? m[4 * i + 2 * hh + 1] * expf(cum[q] - cum[j + 1]) : 0.f;
            uint32_t hv, lv;
            split2(m0, m1, hv, lv);
            *ph = hv;
            *pl_ = lv;
          }
#pragma unroll
          for (int s = 4; s < 32; s <<= 1) {
            c0 += __shfl_xor_sync(0xffffffffu, c0, s);
            c1 += __shfl_xor_sync(0xffffffffu, c1, s);
          }
          if (lane < 4) {
            colp[warp][j] = c0;
            colp[warp][j + 1] = c1;
          }
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float r = quad_sum(rs[hh]);
        if (col0 == 0) rowt[row0 + 8 * hh] = r;
      }
    }
    fence_proxy_async();
    __syncthreads();  // M's parts
    {
      // dC += exp(cum_q) (.) (dy h_c) + M B: rows q, columns n; E_q
      float a[32];
      wgmma_fence();
      for (int kk = 0; kk < k_p; ++kk) {
        const uint64_t da = desc_k(tile(3) + wg * kHalf, kk);
        wgmma64<0, 1>(a, da, desc_mn(tile(4), kk), kk > 0);
        wgmma64<0, 1>(a, da, desc_mn(tile(4) + kHalf, kk), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(a);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int q = row0 + 8 * hh;
        float e = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int n = 8 * i + col0;
          const float2 c = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(gb + swz(q, n)));  // Cm's tile
          e = fmaf(a[4 * i + 2 * hh], c.x, fmaf(a[4 * i + 2 * hh + 1], c.y, e));
          dcs[4 * i + 2 * hh] = fmaf(ecum[q], a[4 * i + 2 * hh], dcs[4 * i + 2 * hh]);
          dcs[4 * i + 2 * hh + 1] = fmaf(ecum[q], a[4 * i + 2 * hh + 1], dcs[4 * i + 2 * hh + 1]);
        }
        e = quad_sum(e);
        if (col0 == 0) ev[q] = ecum[q] * e;
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk < k0 + 4) {
          const uint32_t pa = tile(6 + kk / 4) + wg * kHalf;
          const uint64_t db = desc_mn(tile(1), kk);
          wgmma64<0, 1>(dcs, desc_k(pa, kk & 3), db, 1);
          wgmma64<0, 1>(dcs, desc_k(pa + 2 * kPanel, kk & 3), db, 1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dcs);
    }
    __syncthreads();  // dy and h_c's image are free
    if (g + 1 < pl.n_heads) load_dy(g + 1);
    {
      // dB += exp(cum_end - cum_j) (.) (x dS) + M^T C: rows j, columns n; F_j
      float a[32];
      wgmma_fence();
      for (int kk = 0; kk < k_p; ++kk) {
        const uint64_t da = desc_k(tile(2) + wg * kHalf, kk);
        wgmma64<0, 1>(a, da, desc_mn(tile(5), kk), kk > 0);
        wgmma64<0, 1>(a, da, desc_mn(tile(5) + kHalf, kk), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(a);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = row0 + 8 * hh;
        float f = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int n = 8 * i + col0;
          const float2 bv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(gb + kPanel + swz(j, n)));  // Bm's tile
          f = fmaf(a[4 * i + 2 * hh], bv.x, fmaf(a[4 * i + 2 * hh + 1], bv.y, f));
          dbs[4 * i + 2 * hh] = fmaf(eend[j], a[4 * i + 2 * hh], dbs[4 * i + 2 * hh]);
          dbs[4 * i + 2 * hh + 1] = fmaf(eend[j], a[4 * i + 2 * hh + 1], dbs[4 * i + 2 * hh + 1]);
        }
        f = quad_sum(f);
        if (col0 == 0) fv[j] = eend[j] * f;
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk >= k0) {
          const uint64_t db = desc_mn(tile(0), kk);
          wgmma64<1, 1>(dbs, desc_mn(tile(6 + wg), kk), db, 1);
          wgmma64<1, 1>(dbs, desc_mn(tile(8 + wg), kk), db, 1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dbs);
    }
    __syncthreads();  // xh and dS's image are free
    if (g + 1 < pl.n_heads) load_x(g + 1);
    // dcum, then dla = its reverse prefix sum in the chunk (one warp, 4 rows
    // a lane; rows at or past the chunk are 0)
    if (tid < 32) {
      const int64_t bhc = (static_cast<int64_t>(pl.b) * d.heads + h) * d.n_chunks + pl.c;
      float v[4];
      float fsum = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = lane * 4 + k;
        const bool in = r < R;
        float colt = 0.f;
        for (int y = 0; y < kThreads / 32; ++y) colt += colp[y][r];
        v[k] = in ? rowt[r] - colt + ev[r] - fv[r] : 0.f;
        fsum += in ? fv[r] : 0.f;
      }
#pragma unroll
      for (int dd = 16; dd >= 1; dd >>= 1) fsum += __shfl_xor_sync(0xffffffffu, fsum, dd);
      float dd = 0.f;
      for (int i = 0; i < kPassBlocks; ++i) dd += ddecay[bhc * kPassBlocks + i];
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
      for (int s = 1; s < 32; s <<= 1) {
        const float down = __shfl_down_sync(0xffffffffu, offset, s);
        if (lane + s < 32) offset += down;
      }
      offset -= run;  // the sum of the lanes after this one
      const int64_t o = (static_cast<int64_t>(pl.b) * d.seq + pl.s0) * d.heads + h;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = lane * 4 + k;
        if (r < R) dla[o + static_cast<int64_t>(r) * d.heads] = v[k] + offset;
      }
    }
    __syncthreads();  // dla has read this head's sums
  }
  // the group's dB and dC: (b, chunk, group) x Q x N
  const int n_groups = (d.heads + group - 1) / group;
  const int64_t go = ((static_cast<int64_t>(pl.b) * d.n_chunks + pl.c) * n_groups + pl.grp) * Q * N;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    if (r < Q) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int n = 8 * i + col0;
        if (n < N) {
          *reinterpret_cast<float2*>(dbg + go + r * N + n) =
              make_float2(dbs[4 * i + 2 * hh], dbs[4 * i + 2 * hh + 1]);
          *reinterpret_cast<float2*>(dcg + go + r * N + n) =
              make_float2(dcs[4 * i + 2 * hh], dcs[4 * i + 2 * hh + 1]);
        }
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
  const auto* la_f = static_cast<const float*>(la);
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  const int64_t outs = static_cast<int64_t>(batch) * seq * state;
  const unsigned sum_blocks = static_cast<unsigned>((outs + kThreads - 1) / kThreads);
  cudaError_t err;
  if (dtype == 1) {
    // bf16: the tensor cores (repro_torch/kernels/ssd_scan_bwd.py::kernel_route)
    static const cudaError_t attr = [] {
      const cudaError_t e = allow_smem(tc::states_tc_kernel, tc::kStatesSmem);
      return e != cudaSuccess ? e : allow_smem(tc::chunk_tc_kernel, tc::kChunkSmem);
    }();
    if (attr != cudaSuccess) return static_cast<int>(attr);
    // heads a block of passes 1 and 3 takes: 8, halved while the (b, chunk)
    // pairs times the groups would give fewer blocks than the card has SMs
    // (the forward's heads_per_block)
    static const int sms = [] {
      int dev = 0, n = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
      return n;
    }();
    int group = heads < tc::kMaxGroup ? heads : tc::kMaxGroup;
    while (group > 1 &&
           static_cast<int64_t>(batch) * n_chunks * ((heads + group - 1) / group) < sms) {
      group /= 2;
    }
    const int n_groups = (heads + group - 1) / group;
    float* states = static_cast<float*>(scratch);
    float* grads = states + blocks * pn;
    float* himg = grads + blocks * pn;
    float* dimg = himg + blocks * tc::kImage;
    float* dbg = dimg + blocks * tc::kImage;
    float* dcg = dbg + static_cast<int64_t>(batch) * n_chunks * n_groups * chunk * state;
    float* decay = dcg + static_cast<int64_t>(batch) * n_chunks * n_groups * chunk * state;
    float* ddecay = decay + blocks;  // (b, head, chunk, tc::kPassBlocks)
    const auto* xb = static_cast<const bf16*>(xh);
    const auto* bb = static_cast<const bf16*>(bm);
    const auto* cb = static_cast<const bf16*>(cm);
    const auto* yb = static_cast<const bf16*>(dy);
    const dim3 grid(n_groups, n_chunks, batch);
    tc::states_tc_kernel<<<grid, tc::kStatesThreads, tc::kStatesSmem, stream_>>>(
        xb, la_f, bb, cb, yb, states, grads, decay, st_, d, group);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    tc::passing_tc_kernel<<<dim3(tc::kPassBlocks, batch * heads), kThreads, 0, stream_>>>(
        states, grads, decay, ddecay, himg, dimg, static_cast<const float*>(h0),
        static_cast<const float*>(dh_final), static_cast<float*>(dh0), d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    tc::chunk_tc_kernel<<<grid, kThreads, tc::kChunkSmem, stream_>>>(
        xb, la_f, bb, cb, yb, himg, dimg, ddecay, static_cast<bf16*>(dxh), dbg, dcg,
        static_cast<float*>(dla), st_, d, group);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    head_sum_kernel<<<sum_blocks, kThreads, 0, stream_>>>(dbg, dcg, dbm, dcm, d, batch,
                                                          n_groups);
    return static_cast<int>(cudaGetLastError());
  }
  float* states = static_cast<float*>(scratch);
  float* grads = states + blocks * pn;
  float* wmat = grads + blocks * pn;
  float* mmat = wmat + blocks * chunk * chunk;
  float* dbh = mmat + blocks * chunk * chunk;
  float* dch = dbh + blocks * chunk * state;
  float* tsum = dch + blocks * chunk * state;
  float* decay = tsum + blocks * chunk;
  float* ddecay = decay + blocks;  // (b, head, chunk, kMaxPassBlocks)
  const dim3 grid(heads, n_chunks, batch);
  states_kernel<<<grid, kThreads, 0, stream_>>>(xh, la_f, bm, cm, dy, states, grads,
                                               decay, st_, d);
  err = cudaGetLastError();
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
  head_sum_kernel<<<sum_blocks, kThreads, 0, stream_>>>(dbh, dch, dbm, dcm, d, batch, heads);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
