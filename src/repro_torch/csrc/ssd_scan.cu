// The Mamba-2 SSD chunked scan with its final state, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (_ssd_kernel).
// That kernel ran a (batch*heads, chunks) grid with the chunk axis innermost;
// TPU grid steps run in order on one core, so the (N, P) state sat in VMEM
// scratch from one chunk step to the next.  Here one call runs the Mamba-2
// decomposition as three kernels on the caller's stream, each parallel over
// the chunks:
//
//   1. chunk states, one block per (b, chunk, group of heads): the prefix
//      sums cum of the log decays (a warp scan per head), each head's own
//      chunk state S_c = sum_j exp(cum_end - cum_j) xh_j (x) B_j (P x N, f32,
//      from a zero entering state) and its decay exp(cum_end);
//   2. state passing, elementwise over the P x N state, four elements a
//      thread, each (b, head)'s chunks in order with the chunk states loaded
//      four chunks ahead: h_{c+1} = exp(cum_end_c) h_c + S_c from h0 or zero.
//      It writes the state entering each chunk and h_final (B, H, P, N);
//   3. chunk outputs, one block per (b, chunk, group of heads): C B^T once
//      for the group (the heads share Bm and Cm), then per head
//      W = C B^T (.) L with L[q, j] = exp(cum_q - cum_j) for j <= q only
//      (above the diagonal the difference can be large and positive, and exp
//      there times a zero mask would give inf * 0 = NaN), and
//      y = W xh + exp(cum) (.) (C h_c^T), written once.
//
// Two routes, by dtype:
//
//   * bf16, namespace tc: the products run on wgmma.  xh, Bm, Cm are exact
//     bf16; the f32 operands are split into bf16 hi = bf16(v) and lo =
//     bf16(v - hi), about 16 significant bits: exp(cum_end - cum_j) B_j (the
//     B of the state product, [hi | lo] side by side as one N = 128 operand),
//     h_c (pass 2 writes it as a hi and a lo tile in the layout pass 3's
//     copies take, the same bytes as f32) and W (in registers, from the
//     C B^T accumulators, as the flash kernel feeds P).  One bf16 part of W
//     or of h_c breaks y's tolerance at mild decays, where y is a small
//     difference of large terms (tests/test_torch_ssd.py emulates the
//     rounding).  Tiles are 128 positions x 64 columns of bf16 in 128-byte
//     swizzled rows, filled by 16-byte cp.async copies that read zeros past
//     S, past the chunk and past P or N; xh, Bm, Cm need 16-byte aligned rows
//     (the wrapper copies any other layout).  y goes out through a staged
//     tile as 16-byte stores;
//   * f32: the same three passes with the products on the CUDA cores, f32
//     tiles in shared memory and register tiles of 4 x 4 (state) or 8 x 4
//     (outputs); C B^T is held in registers across the group's heads.
//
// P and N are padded to 64 in the tiles and in the scratch chunk states
// (64 x 64 f32 each), and chunks to 128 rows, so one kernel serves every
// shape the wrapper takes (P 32 or 64; N 16, 32 or 64; chunks up to 128).
// Positions past S read as zero input and zero log decay, so the state after
// a ragged last chunk is the state after position S - 1, and no padded copy
// of an input is made.
//
// What bounds it: at zamba2-1.2b's prefill (B 4, S 1024, H 64, P = N = 64,
// chunks of 128, bf16) the function needs ~73 MB of xh, Bm, Cm, y, la and
// h_final (0.022 ms at 3.35 TB/s) and ~9 GFLOP (0.009 ms at the bf16
// tensor-core rate): the memory.  The passes move more, ~254 MB: xh twice,
// y once, and each chunk's 16 KB state written (pass 1), read and written
// again as the entering state (2) and read (3) -- 0.076 ms at 3.35 TB/s.
// Pass 2 runs near that rate.  Passes 1 and 3 take 8 heads a block (256
// blocks here, 1024 at S 16384 with B 1); pass 3 holds one block
// an SM (234 registers a thread: C B^T stays in registers for the group),
// and its time goes as much to forming W on the CUDA cores as to its
// copies.  A warp forms L = exp(cum_q - cum_j) directly only on the k16
// step that holds its rows' diagonal, from two factors of at most 1 left
// of it, and not at all right of it.  No instruction but a wgmma writes an
// accumulator inside a pipeline stage (the first product of each runs with
// scale-d 0): ptxas serializes the wgmmas otherwise.  PERF.md gives the
// measured split by pass.
//
// Plain C interface, loaded with ctypes by repro_torch/kernels/ssd_scan.py;
// the launches go on the caller's stream and the function returns the CUDA
// error code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQ = 128;                   // rows of a chunk tile
constexpr int kTile = 64;                 // P and N, padded
constexpr int kStateElems = kTile * kTile;  // a chunk state in the scratch
constexpr int kMaxGroup = 8;              // heads a block takes, at most
constexpr int kPassThreads = 256;         // state passing: 4 elements a thread
constexpr int kAhead = 4;                 // chunks state passing loads ahead
constexpr int kPanelBytes = kQ * 128;     // a 128 x 64 bf16 tile; also the
                                          // bytes of a 64 x 64 f32 state

// Element strides; the P dim of xh / y and the N dim of Bm / Cm are unit.
struct Strides {
  int64_t x_b, x_s, x_h;
  int64_t l_b, l_s, l_h;
  int64_t b_b, b_s;
  int64_t c_b, c_s;
  int64_t y_b, y_s, y_h;
};

// The block's place: batch row, chunk, first head and number of heads.
struct Place {
  int b, c, s0, n_rows, h0, n_heads;
};

__device__ __forceinline__ Place place(int seq, int heads, int chunk,
                                       int group) {
  Place pl;
  pl.h0 = blockIdx.x * group;
  pl.n_heads = min(group, heads - pl.h0);
  pl.c = blockIdx.y;
  pl.b = blockIdx.z;
  pl.s0 = pl.c * chunk;
  pl.n_rows = min(chunk, seq - pl.s0);  // rows past it read as zero
  return pl;
}

// One warp: the inclusive prefix sums of one head's log decays over the
// rows [0, kQ) of a chunk tile (rows at or past n_rows read as 0, so the
// sums stay flat there and cum[kQ - 1] is the chunk's total), 4 rows a lane
// and a warp scan of the lanes' totals; exp(cum) too where ecum is given.
__device__ __forceinline__ void warp_cumsum(const float* __restrict__ lp,
                                            int64_t stride, int n_rows,
                                            float* cum, float* ecum) {
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
    if (lane >= d) {
      offset += up;
    }
  }
  offset -= run;  // exclusive: the sum of the lanes before this one
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    cum[lane * 4 + k] = v[k] + offset;
    if (ecum != nullptr) {
      ecum[lane * 4 + k] = expf(v[k] + offset);
    }
  }
}

__device__ __forceinline__ float4 fma4(float4 h, float d, float4 s) {
  return make_float4(fmaf(h.x, d, s.x), fmaf(h.y, d, s.y), fmaf(h.z, d, s.z),
                     fmaf(h.w, d, s.w));
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

// Byte offset of element (row, col) of a tile of 128-byte rows in the
// 128-byte swizzle: 16-byte chunk c of row r sits at chunk c ^ (r % 8).
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + (((col >> 3) ^ (row & 7)) << 4) + ((col & 7) << 1);
}

// ---------------------------------------------------------------------------
// 2. State passing (both routes)
// ---------------------------------------------------------------------------

// Thread t of block (x, bh) owns elements e .. e + 3, e = 4 (256 x + t), of
// (b, head) bh's 64 x 64 state: row p = e / 64, columns n = e % 64 .. + 3.
// kParts: the entering states go out as a bf16 hi tile (rows 0-63) and a lo
// tile (rows 64-127) in the swizzled layout of the outputs pass, else as f32
// over the chunk states (each element is read before it is overwritten, by
// the same thread).
template <bool kParts>
__global__ void __launch_bounds__(kPassThreads)
    state_passing_kernel(const float* states, const float* __restrict__ decay,
                         const float* __restrict__ h0,
                         float* __restrict__ h_final, void* h_enter,
                         int headdim, int state, int n_chunks) {
  const int bh = blockIdx.y;
  const int e = (blockIdx.x * kPassThreads + threadIdx.x) * 4;
  const int p = e / kTile;
  const int n = e % kTile;
  const bool live = p < headdim && n < state;
  const int64_t hn = (static_cast<int64_t>(bh) * headdim + p) * state + n;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live && h0 != nullptr) {
    h = *reinterpret_cast<const float4*>(h0 + hn);
  }
  const float* sp = states + static_cast<int64_t>(bh) * n_chunks * kStateElems + e;
  const float* dp = decay + static_cast<int64_t>(bh) * n_chunks;
  float4 s[kAhead];
  float d[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    if (i < n_chunks) {
      s[i] = *reinterpret_cast<const float4*>(sp + i * kStateElems);
      d[i] = dp[i];
    }
  }
  for (int c0 = 0; c0 < n_chunks; c0 += kAhead) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int c = c0 + i;
      if (c < n_chunks) {
        const int64_t tile = static_cast<int64_t>(bh) * n_chunks + c;
        if constexpr (kParts) {
          unsigned char* img = static_cast<unsigned char*>(h_enter) + tile * kPanelBytes;
          uint2 hi, lo;
          split2(h.x, h.y, hi.x, lo.x);
          split2(h.z, h.w, hi.y, lo.y);
          *reinterpret_cast<uint2*>(img + swz(p, n)) = hi;
          *reinterpret_cast<uint2*>(img + swz(kTile + p, n)) = lo;
        } else {
          *reinterpret_cast<float4*>(static_cast<float*>(h_enter) +
                                     tile * kStateElems + e) = h;
        }
        h = fma4(h, d[i], s[i]);
        if (c + kAhead < n_chunks) {
          s[i] = *reinterpret_cast<const float4*>(sp + (c + kAhead) * kStateElems);
          d[i] = dp[c + kAhead];
        }
      }
    }
  }
  if (live) {
    *reinterpret_cast<float4*>(h_final + hn) = h;
  }
}

// ---------------------------------------------------------------------------
// f32: chunk states and outputs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kPitch = kTile + 1;  // odd pitch: no bank conflicts
constexpr int kWPitch = kQ + 1;

// rows [0, n_rows) and columns [0, cols) of a (rows, kTile) f32 tile into
// shared memory with row pitch `pitch`; zero elsewhere
__device__ __forceinline__ void load_tile(float* dst, int pitch, int rows,
                                          const float* __restrict__ src,
                                          int64_t stride, int n_rows,
                                          int cols) {
  for (int i = threadIdx.x; i < rows * kTile / 4; i += kThreads) {
    const int r = i / (kTile / 4);
    const int k = (i % (kTile / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_rows && k < cols) {
      v = *reinterpret_cast<const float4*>(src + r * stride + k);
    }
    float* o = dst + r * pitch + k;
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
}

constexpr int kStatesFloats = kQ * kTile + kQ * kPitch + kMaxGroup * kQ + kQ;

// 1. Chunk states, f32.  Thread (hi, lo) of the 16 x 16 grid owns state rows
// p = hi + 16 a and columns n = lo + 16 c.
__global__ void __launch_bounds__(kThreads)
    chunk_states_kernel(const float* __restrict__ xh, const float* __restrict__ la,
                        const float* __restrict__ bm, float* __restrict__ states,
                        float* __restrict__ decay, Strides st, int seq,
                        int heads, int headdim, int state, int chunk,
                        int n_chunks, int group) {
  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);
  float* b_s = x_s + kQ * kTile;
  float* cum_s = b_s + kQ * kPitch;
  float* dte_s = cum_s + kMaxGroup * kQ;
  const Place pl = place(seq, heads, chunk, group);
  const int tid = threadIdx.x;
  const int lo = tid % 16;
  const int hi = tid / 16;

  load_tile(b_s, kPitch, kQ, bm + pl.b * st.b_b + pl.s0 * st.b_s, st.b_s, pl.n_rows,
            state);
  for (int g = tid / 32; g < pl.n_heads; g += kThreads / 32) {
    warp_cumsum(la + pl.b * st.l_b + pl.s0 * st.l_s + (pl.h0 + g) * st.l_h,
                st.l_s, pl.n_rows, cum_s + g * kQ, nullptr);
  }
  for (int g = 0; g < pl.n_heads; ++g) {
    __syncthreads();  // the previous head is done with x_s and dte_s
    load_tile(x_s, kTile, kQ,
              xh + pl.b * st.x_b + pl.s0 * st.x_s + (pl.h0 + g) * st.x_h,
              st.x_s, pl.n_rows, headdim);
    const float* cum = cum_s + g * kQ;
    if (tid < kQ) {
      dte_s[tid] = expf(cum[kQ - 1] - cum[tid]);
    }
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[a][c] = 0.f;
      }
    }
#pragma unroll 4
    for (int j = 0; j < pl.n_rows; ++j) {
      const float d = dte_s[j];
      float xv[4];
      float bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        xv[a] = d * x_s[j * kTile + hi + 16 * a];
        bv[a] = b_s[j * kPitch + lo + 16 * a];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[a][c] = fmaf(xv[a], bv[c], acc[a][c]);
        }
      }
    }
    const int64_t tile = static_cast<int64_t>(pl.b * heads + pl.h0 + g) * n_chunks + pl.c;
    float* sp = states + tile * kStateElems;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sp[(hi + 16 * a) * kTile + lo + 16 * c] = acc[a][c];
      }
    }
    if (tid == 0) {
      decay[tile] = expf(cum[kQ - 1]);
    }
  }
}

constexpr int kOutputsFloats =
    kQ * kPitch + kQ * kWPitch + kQ * kTile + kTile * kPitch + 2 * kMaxGroup * kQ;

// 3. Chunk outputs, f32.  Thread (hi, lo) owns C B^T and W rows q = hi + 16 i
// and columns j = lo + 16 k, and y rows q = hi + 16 i and columns
// p = lo + 16 k.  Bm's tile lies where W goes: it is read only for C B^T.
__global__ void __launch_bounds__(kThreads)
    chunk_outputs_kernel(const float* __restrict__ xh,
                         const float* __restrict__ la,
                         const float* __restrict__ bm,
                         const float* __restrict__ cm,
                         const float* __restrict__ h_enter,
                         float* __restrict__ y, Strides st, int seq,
                         int heads, int headdim, int state, int chunk,
                         int n_chunks, int group) {
  extern __shared__ float4 smem4[];
  float* c_s = reinterpret_cast<float*>(smem4);
  float* w_s = c_s + kQ * kPitch;
  float* b_s = w_s;
  float* x_s = w_s + kQ * kWPitch;
  float* h_s = x_s + kQ * kTile;
  float* cum_s = h_s + kTile * kPitch;
  float* ecum_s = cum_s + kMaxGroup * kQ;
  const Place pl = place(seq, heads, chunk, group);
  const int tid = threadIdx.x;
  const int lo = tid % 16;
  const int hi = tid / 16;

  load_tile(c_s, kPitch, kQ, cm + pl.b * st.c_b + pl.s0 * st.c_s, st.c_s, pl.n_rows,
            state);
  load_tile(b_s, kPitch, kQ, bm + pl.b * st.b_b + pl.s0 * st.b_s, st.b_s, pl.n_rows,
            state);
  for (int g = tid / 32; g < pl.n_heads; g += kThreads / 32) {
    warp_cumsum(la + pl.b * st.l_b + pl.s0 * st.l_s + (pl.h0 + g) * st.l_h,
                st.l_s, pl.n_rows, cum_s + g * kQ, ecum_s + g * kQ);
  }
  __syncthreads();
  float cb[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      cb[i][k] = 0.f;
    }
  }
#pragma unroll 2
  for (int n = 0; n < state; ++n) {
    float cv[8];
    float bv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      cv[i] = c_s[(hi + 16 * i) * kPitch + n];
      bv[i] = b_s[(lo + 16 * i) * kPitch + n];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        cb[i][k] = fmaf(cv[i], bv[k], cb[i][k]);
      }
    }
  }
  // W is zero above the diagonal: a thread's y rows stop at its last row
  const int j_end = min(pl.n_rows, hi + 16 * 7 + 1);
  for (int g = 0; g < pl.n_heads; ++g) {
    __syncthreads();  // Bm's tile, or the previous head's tiles, are read
    const int hd = pl.h0 + g;
    load_tile(x_s, kTile, kQ, xh + pl.b * st.x_b + pl.s0 * st.x_s + hd * st.x_h,
              st.x_s, pl.n_rows, headdim);
    const int64_t tile = static_cast<int64_t>(pl.b * heads + hd) * n_chunks + pl.c;
    load_tile(h_s, kPitch, kTile, h_enter + tile * kStateElems, kTile, kTile, kTile);
    const float* cum = cum_s + g * kQ;
    const float* ecum = ecum_s + g * kQ;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = hi + 16 * i;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = lo + 16 * k;
        w_s[q * kWPitch + j] = j <= q ? cb[i][k] * expf(cum[q] - cum[j]) : 0.f;
      }
    }
    __syncthreads();
    // exp(cum_q) C_q . h_c, then + sum_{j <= q} W[q][j] x[j]
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[i][k] = 0.f;
      }
    }
#pragma unroll 4
    for (int n = 0; n < state; ++n) {
      float cv[8];
      float hv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        cv[i] = c_s[(hi + 16 * i) * kPitch + n];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        hv[k] = h_s[(lo + 16 * k) * kPitch + n];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[i][k] = fmaf(cv[i], hv[k], acc[i][k]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float e = ecum[hi + 16 * i];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[i][k] *= e;
      }
    }
#pragma unroll 2
    for (int j = 0; j < j_end; ++j) {
      float wv[8];
      float xv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        wv[i] = w_s[(hi + 16 * i) * kWPitch + j];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        xv[k] = x_s[j * kTile + lo + 16 * k];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[i][k] = fmaf(wv[i], xv[k], acc[i][k]);
        }
      }
    }
    float* yp = y + pl.b * st.y_b + pl.s0 * st.y_s + hd * st.y_h;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = hi + 16 * i;
      if (q < pl.n_rows) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = lo + 16 * k;
          if (p < headdim) {
            yp[q * st.y_s + p] = acc[i][k];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: chunk states and outputs on wgmma
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kStatesThreads = 128;  // one warpgroup
constexpr int kOutputsThreads = 256;  // two warpgroups of 64 rows

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global memory into shared memory, asynchronously; src-size 0
// fills them with zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy writes to shared memory (stores, cp.async), made visible to
// wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of the 128 threads of warpgroup `wg` (ids 1, 2; 0 is
// __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// A 128 x 64 tile read K-major (rows are M or N, the 64 columns are K) from
// k16 step kk, or MN-major (rows are K, the 64 columns M or N; a second tile
// kPanelBytes on holds columns 64-127 of an N = 128 operand).
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return make_desc(tile + kk * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 2048, kPanelBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    asm volatile("" : "+f"(r[i])::"memory");
  }
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    asm volatile("" : "+r"(r[i])::"memory");
  }
}

// D (64 x 64, f32) (+)= A (64 x 16, bf16 registers) B (16 x 64, shared,
// MN-major).
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t desc_b,
                                           int scale_d) {
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
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), bf16 in shared memory,
// both K-major.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
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

// Rows [0, n_rows) and columns [0, cols) of a (kQ, 64) bf16 tile of `src`
// (row stride `stride` elements) into the swizzled tile at `dst`; zeros
// elsewhere.  The block's kThr threads issue 16-byte copies.
template <int kThr>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const bf16* __restrict__ src,
                                          int64_t stride, int n_rows,
                                          int cols) {
  for (int i = threadIdx.x; i < kQ * 8; i += kThr) {
    const int r = i >> 3;
    const int k = i & 7;
    const bool ok = r < n_rows && 8 * k < cols;
    cp_async16(dst + swz(r, 8 * k), ok ? src + r * stride + 8 * k : src, ok);
  }
}

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of an f32
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Shared memory of the chunk-states pass: two xh tiles, the [hi | lo]
// operand, the prefix sums.
constexpr int kStatesSmem = 1024 + 4 * kPanelBytes + kMaxGroup * kQ * 4;

// 1. Chunk states on wgmma, one warpgroup a block.  Per head: the operand
// dte (.) Bm, dte_j = exp(cum_end - cum_j), as bf16 [hi | lo] (rows j,
// columns n: MN-major), from Bm held in registers for the group; then
// S = xh^T [hi | lo] as one m64n128k16 wgmma a k16 step, xh's tile read
// MN-major (rows j, columns p) as A; S = the two halves' sum.  The next
// head's xh tile is copied while this one's products run.
__global__ void __launch_bounds__(kStatesThreads)
    chunk_states_tc_kernel(const bf16* __restrict__ xh,
                           const float* __restrict__ la,
                           const bf16* __restrict__ bm,
                           float* __restrict__ states,
                           float* __restrict__ decay, Strides st, int seq,
                           int heads, int headdim, int state, int chunk,
                           int n_chunks, int group) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* gb = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(gb);
  auto x_at = [&](int buf) { return base + buf * kPanelBytes; };
  const uint32_t op = base + 2 * kPanelBytes;  // [hi | lo]
  unsigned char* op_g = gb + 2 * kPanelBytes;
  float* cum_s = reinterpret_cast<float*>(gb + 4 * kPanelBytes);
  const Place pl = place(seq, heads, chunk, group);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = 16 * warp + lane / 4;  // accumulator rows (+ 8) of 64
  const int col0 = 2 * (lane % 4);        // and columns 8 j + col0 (+ 1)

  auto load_x = [&](int g, int buf) {
    load_tile<kStatesThreads>(
        x_at(buf), xh + pl.b * st.x_b + pl.s0 * st.x_s + (pl.h0 + g) * st.x_h,
        st.x_s, pl.n_rows, headdim);
  };
  load_x(0, 0);
  cp_async_commit();
  // Bm of the chunk: vector i of thread t is row (t + 128 i) / 8, columns
  // 8 ((t + 128 i) % 8) .. + 7
  uint4 bv[8];
  const bf16* bp = bm + pl.b * st.b_b + pl.s0 * st.b_s;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int x = tid + kStatesThreads * i;
    const int r = x >> 3;
    const int k = (x & 7) * 8;
    bv[i] = r < pl.n_rows && k < state
                ? *reinterpret_cast<const uint4*>(bp + r * st.b_s + k)
                : make_uint4(0u, 0u, 0u, 0u);
  }
  for (int g = warp; g < pl.n_heads; g += kStatesThreads / 32) {
    warp_cumsum(la + pl.b * st.l_b + pl.s0 * st.l_s + (pl.h0 + g) * st.l_h,
                st.l_s, pl.n_rows, cum_s + g * kQ, nullptr);
  }
  __syncthreads();
  const int n_steps = (pl.n_rows + 15) / 16;  // k16 steps over the rows
  for (int g = 0; g < pl.n_heads; ++g) {
    if (g + 1 < pl.n_heads) {
      load_x(g + 1, (g + 1) & 1);
    }
    cp_async_commit();
    const float* cum = cum_s + g * kQ;
    const float cum_end = cum[kQ - 1];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int x = tid + kStatesThreads * i;
      const int r = x >> 3;
      const float d = expf(cum_end - cum[r]);
      float f[8];
      unpack(bv[i], f);
      uint4 h4, l4;
      split2(f[0] * d, f[1] * d, h4.x, l4.x);
      split2(f[2] * d, f[3] * d, h4.y, l4.y);
      split2(f[4] * d, f[5] * d, h4.z, l4.z);
      split2(f[6] * d, f[7] * d, h4.w, l4.w);
      const uint32_t off = swz(r, (x & 7) * 8);
      *reinterpret_cast<uint4*>(op_g + off) = h4;
      *reinterpret_cast<uint4*>(op_g + kPanelBytes + off) = l4;
    }
    cp_async_wait<1>();  // this head's xh tile is in
    fence_proxy_async();
    __syncthreads();
    // the first product writes the accumulators (scale-d 0): an instruction
    // of another kind writing them would serialize the wgmma pipeline
    float acc[64];
    wgmma_fence();
    for (int kk = 0; kk < n_steps; ++kk) {
      wgmma_ss128<1, 1>(acc, desc_mn(x_at(g & 1), kk), desc_mn(op, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    // S[p][n]: rows p = row0 (+ 8), columns n = 8 j + col0 (+ 1)
    const int64_t tile = static_cast<int64_t>(pl.b * heads + pl.h0 + g) * n_chunks + pl.c;
    float* sp = states + tile * kStateElems;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<float2*>(sp + (row0 + 8 * r) * kTile + 8 * j + col0) =
            make_float2(acc[i] + acc[32 + i], acc[i + 1] + acc[33 + i]);
      }
    }
    if (tid == 0) {
      decay[tile] = expf(cum_end);
    }
    __syncthreads();  // the operand and this xh tile are free
  }
}

// Per head, the factors of L left of a row's diagonal k16 step: A[q][k]
// (kQ x 8), then E[j] (kQ).
constexpr int kFac = 9 * kQ;

// What a thread needs to form its W fragments for one head: the prefix
// sums, its rows' A and the E of every column, its rows qa and qa + 8, its
// first column, and the k16 step holding its warp's rows.
struct WRows {
  const float* cum;
  const float* a_lo;
  const float* a_hi;
  const float* e;
  int qa, col0, diag;
};

// The factors of L a thread needs for k16 step kk left of its diagonal:
// A of its two rows, E of its four columns.  Loaded a step ahead, so their
// latency hides behind the previous step's products.
struct WFactors {
  float a0, a1;
  float2 e0, e1;
};

__device__ __forceinline__ WFactors w_factors(int kk, const WRows& w) {
  WFactors v{};
  if (kk < w.diag) {
    v.a0 = w.a_lo[kk];
    v.a1 = w.a_hi[kk];
    v.e0 = *reinterpret_cast<const float2*>(w.e + 16 * kk + w.col0);
    v.e1 = *reinterpret_cast<const float2*>(w.e + 16 * kk + 8 + w.col0);
  }
  return v;
}

// The A fragment of W = C B^T (.) L for k16 step kk (a constant once the
// caller's loop is unrolled) as bf16 hi (f[0..3]) + lo (f[4..7]): fragment
// i holds row qa (i even) or qa + 8 (i odd), columns 16 kk + 8 (i / 2) +
// col0 (+ 1), from C B^T's registers 4 (2 kk + i / 2) + 2 (i % 2) (+ 1).
// Left of the diagonal step L = A E (the factors v); on it,
// exp(cum_q - cum_j) masked to j <= q; right of it, zero.
__device__ __forceinline__ void w_fragment(const float (&cb)[64], int kk,
                                           const WRows& w, const WFactors& v,
                                           uint32_t (&f)[8]) {
  if (kk < w.diag) {
    const float* c = cb + 8 * kk;
    split2(c[0] * v.a0 * v.e0.x, c[1] * v.a0 * v.e0.y, f[0], f[4]);
    split2(c[2] * v.a1 * v.e0.x, c[3] * v.a1 * v.e0.y, f[1], f[5]);
    split2(c[4] * v.a0 * v.e1.x, c[5] * v.a0 * v.e1.y, f[2], f[6]);
    split2(c[6] * v.a1 * v.e1.x, c[7] * v.a1 * v.e1.y, f[3], f[7]);
  } else if (kk == w.diag) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = w.qa + 8 * (i & 1);
      const float cr = w.cum[row];
      const int col = 16 * kk + 8 * (i >> 1) + w.col0;
      const int idx = 8 * kk + 4 * (i >> 1) + 2 * (i & 1);
      const float w0 = col <= row ? cb[idx] * expf(cr - w.cum[col]) : 0.f;
      const float w1 = col + 1 <= row ? cb[idx + 1] * expf(cr - w.cum[col + 1]) : 0.f;
      split2(w0, w1, f[i], f[4 + i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      f[i] = 0u;
    }
  }
}

// Shared memory of the chunk-outputs pass: Cm, Bm, two xh tiles and two
// entering-state tiles ([hi rows | lo rows]), the y stage; per head the
// prefix sums, their exponentials and the factors of L.
constexpr int kOutputsSmem = 1024 + 7 * kPanelBytes + (2 * kQ + kFac) * kMaxGroup * 4;

// 3. Chunk outputs on wgmma, two warpgroups a block, warpgroup wg owning
// rows 64 wg .. 64 wg + 63 of the chunk.  Once for the group:
// C B^T = m64n128k16 over Cm's and Bm's tiles (both K-major), kept in
// registers.  Per head: C h_c^T (h_c's hi and lo tiles, K-major, into one
// accumulator) while the CUDA cores form W = C B^T (.) L a k16 step at a
// time from the accumulators, as bf16 hi + lo A fragments; W xh with xh's
// tile MN-major, the k16 steps right of the warpgroup's last row skipped.
// A warp forms L directly (exp, masked) only on the k16 step that holds its
// own rows' diagonal; right of it W is zero, and left of it
// L[q][j] = A[q][j / 16] E[j] with A[q][k] = exp(cum_q - cum_{16 k + 15})
// and E[j] = exp(cum_{j | 15} - cum_j), both at most 1 (no overflow), from
// tables made once per head;
// y = W xh + exp(cum) (.) C h_c^T through the stage to 16-byte stores.  The
// next head's xh and h_c tiles are copied while this head's run.
__global__ void __launch_bounds__(kOutputsThreads, 1)
    chunk_outputs_tc_kernel(const bf16* __restrict__ xh,
                            const float* __restrict__ la,
                            const bf16* __restrict__ bm,
                            const bf16* __restrict__ cm,
                            const unsigned char* __restrict__ h_enter,
                            bf16* __restrict__ y, Strides st, int seq,
                            int heads, int headdim, int state, int chunk,
                            int n_chunks, int group) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* gb = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(gb);
  const uint32_t c_tile = base;
  const uint32_t b_tile = base + kPanelBytes;
  auto x_at = [&](int buf) { return base + (2 + buf) * kPanelBytes; };
  auto h_at = [&](int buf) { return base + (4 + buf) * kPanelBytes; };
  unsigned char* stage = gb + 6 * kPanelBytes;
  float* cum_s = reinterpret_cast<float*>(gb + 7 * kPanelBytes);
  float* ecum_s = cum_s + kMaxGroup * kQ;
  float* fac_s = ecum_s + kMaxGroup * kQ;
  const Place pl = place(seq, heads, chunk, group);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int wtid = tid % 128;
  const int warp = wtid / 32;
  const int lane = tid % 32;
  const int qa = 64 * wg + 16 * warp + lane / 4;  // accumulator rows qa, qa + 8
  const int col0 = 2 * (lane % 4);  // and columns 8 j + col0 (+ 1)

  auto load_head = [&](int g, int buf) {
    const int hd = pl.h0 + g;
    load_tile<kOutputsThreads>(x_at(buf),
                               xh + pl.b * st.x_b + pl.s0 * st.x_s + hd * st.x_h,
                               st.x_s, pl.n_rows, headdim);
    const int64_t tile = static_cast<int64_t>(pl.b * heads + hd) * n_chunks + pl.c;
    const unsigned char* src = h_enter + tile * kPanelBytes;
    for (int i = tid; i < kPanelBytes / 16; i += kOutputsThreads) {
      cp_async16(h_at(buf) + 16 * i, src + 16 * i, true);
    }
  };
  load_tile<kOutputsThreads>(c_tile, cm + pl.b * st.c_b + pl.s0 * st.c_s, st.c_s,
                             pl.n_rows, state);
  load_tile<kOutputsThreads>(b_tile, bm + pl.b * st.b_b + pl.s0 * st.b_s, st.b_s,
                             pl.n_rows, state);
  load_head(0, 0);
  cp_async_commit();
  for (int g = tid / 32; g < pl.n_heads; g += kOutputsThreads / 32) {
    warp_cumsum(la + pl.b * st.l_b + pl.s0 * st.l_s + (pl.h0 + g) * st.l_h,
                st.l_s, pl.n_rows, cum_s + g * kQ, ecum_s + g * kQ);
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  for (int i = tid; i < pl.n_heads * kQ; i += kOutputsThreads) {
    const int q = i % kQ;
    const float* cum = cum_s + (i / kQ) * kQ;
    float* fac = fac_s + (i / kQ) * kFac;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      fac[q * 8 + k] = 16 * k + 15 < q ? expf(cum[q] - cum[16 * k + 15]) : 0.f;
    }
    fac[8 * kQ + q] = expf(cum[q | 15] - cum[q]);
  }

  // a warpgroup whose rows all lie past the chunk's last position idles
  const bool live = 64 * wg < pl.n_rows;
  const int k_state = (state + 15) / 16;  // k16 steps over N
  // W is zero right of the warpgroup's last row
  const int n_wsteps = min((pl.n_rows + 15) / 16, 4 * (wg + 1));
  // C B^T: rows qa (+ 8), columns 8 j + col0 (+ 1), register 4 j + 2 r (+ 1)
  // (each accumulator's first product writes it, scale-d 0: an instruction
  // of another kind writing it would serialize the wgmma pipeline)
  float cb[64];
  if (live) {
    wgmma_fence();
    for (int kk = 0; kk < k_state; ++kk) {
      wgmma_ss128<0, 0>(cb, desc_k(c_tile + wg * 64 * 128, kk), desc_k(b_tile, kk),
                        kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(cb);
  }

  for (int g = 0; g < pl.n_heads; ++g) {
    const int buf = g & 1;
    __syncthreads();  // the previous head's tiles and the stage are free
    if (g + 1 < pl.n_heads) {
      load_head(g + 1, buf ^ 1);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this head's tiles are in
    fence_proxy_async();
    __syncthreads();
    if (!live) {
      continue;
    }
    const float* cum = cum_s + g * kQ;
    const float* ecum = ecum_s + g * kQ;
    // acc = C h_c^T (h_c's hi and lo tiles), scaled by exp(cum_q) once it
    // is in, then + W xh; step 0's fragments are formed meanwhile
    float acc[32];
    wgmma_fence();
    for (int kk = 0; kk < k_state; ++kk) {
      const uint64_t da = desc_k(c_tile + wg * 64 * 128, kk);
      wgmma_ss64(acc, da, desc_k(h_at(buf), kk), kk > 0);
      wgmma_ss64(acc, da, desc_k(h_at(buf) + kTile * 128, kk), 1);
    }
    wgmma_commit();
    const float* fac = fac_s + g * kFac;
    const WRows wr{cum, fac + qa * 8, fac + (qa + 8) * 8, fac + 8 * kQ, qa, col0,
                   4 * wg + warp};
    uint32_t frag[2][8];
    WFactors fac_next = w_factors(1, wr);
    w_fragment(cb, 0, wr, w_factors(0, wr), frag[0]);
    wgmma_wait<0>();
    fence_regs(acc);
    const float ea = ecum[qa];
    const float eb = ecum[qa + 8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[4 * j] *= ea;
      acc[4 * j + 1] *= ea;
      acc[4 * j + 2] *= eb;
      acc[4 * j + 3] *= eb;
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (kk < n_wsteps) {
        uint32_t(&f)[8] = frag[kk & 1];
        if (kk > 0) {
          const WFactors v = fac_next;
          fac_next = w_factors(kk + 1, wr);
          w_fragment(cb, kk, wr, v, f);
        }
        wgmma_fence();
        const uint64_t db = desc_mn(x_at(buf), kk);
        wgmma_rs64(acc, f[0], f[1], f[2], f[3], db, 1);
        wgmma_rs64(acc, f[4], f[5], f[6], f[7], db, 1);
        wgmma_commit();
        wgmma_wait<1>();  // step kk - 1 is done: its fragments may go
        fence_regs(frag[(kk + 1) & 1]);
      }
    }
    wgmma_wait<0>();
    fence_regs(frag[0]);
    fence_regs(frag[1]);
    fence_regs(acc);
    // y, as bf16 rows of the stage
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(stage + swz(qa + 8 * r, 8 * j + col0)) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
      }
    }
    warpgroup_sync(wg);
    bf16* yp = y + pl.b * st.y_b + pl.s0 * st.y_s + (pl.h0 + g) * st.y_h;
    for (int i = wtid; i < 64 * 8; i += 128) {
      const int r = 64 * wg + (i >> 3);
      const int k = (i & 7) * 8;
      if (r < pl.n_rows && k < headdim) {
        *reinterpret_cast<uint4*>(yp + r * st.y_s + k) =
            *reinterpret_cast<const uint4*>(stage + swz(r, k));
      }
    }
  }
}

}  // namespace tc

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

cudaError_t launch_passing(const float* states, const float* decay,
                           const float* h0, float* h_final, void* h_enter,
                           bool parts, int bh, int headdim, int state,
                           int n_chunks, cudaStream_t stream) {
  const dim3 grid(kStateElems / 4 / kPassThreads, bh);
  if (parts) {
    state_passing_kernel<true><<<grid, kPassThreads, 0, stream>>>(
        states, decay, h0, h_final, h_enter, headdim, state, n_chunks);
  } else {
    state_passing_kernel<false><<<grid, kPassThreads, 0, stream>>>(
        states, decay, h0, h_final, h_enter, headdim, state, n_chunks);
  }
  return cudaGetLastError();
}

}  // namespace

// xh (B, S, H, P), la (B, S, H) f32, bm / cm (B, S, N), h0 (B, H, P, N) f32
// contiguous or null, y (B, S, H, P), h_final (B, H, P, N) f32 contiguous;
// scratch: states (B, H, chunks, 64, 64) f32, h_enter the same bytes (bf16;
// for f32 it may be `states` itself), decay (B, H, chunks) f32; device
// pointers.  strides: 13 element strides, (b, s, h) of xh, (b, s, h) of la,
// (b, s) of bm, (b, s) of cm, (b, s, h) of y; the P and N dims are unit, and
// the rows of xh, bm, cm start 16-byte aligned.  dtype (of xh, bm, cm and
// y): 0 float32, 1 bfloat16.  Chunks hold `chunk` positions, 1 <= chunk <=
// 128; P and N are multiples of 8 up to 64; group (1-8) is the heads a
// block of passes 1 and 3 takes.
extern "C" int repro_ssd_scan(const void* xh, const void* la, const void* bm,
                              const void* cm, const void* h0, void* y,
                              void* h_final, void* states, void* h_enter,
                              void* decay, const int64_t* strides, int batch,
                              int seq, int heads, int headdim, int state,
                              int chunk, int dtype, int group, void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0) {
    return 0;
  }
  const int n_chunks = (seq + chunk - 1) / chunk;
  if (chunk < 1 || chunk > kQ || headdim < 8 || headdim > kTile || headdim % 8 ||
      state < 8 || state > kTile || state % 8 || group < 1 || group > kMaxGroup ||
      n_chunks > 65535 || batch > 65535 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t* s = strides;
  const Strides st{s[0], s[1], s[2],  s[3],  s[4],  s[5], s[6],
                   s[7], s[8], s[9], s[10], s[11], s[12]};
  const auto* la_f = static_cast<const float*>(la);
  auto* states_f = static_cast<float*>(states);
  auto* decay_f = static_cast<float*>(decay);
  const auto* h0_f = static_cast<const float*>(h0);
  auto* hf = static_cast<float*>(h_final);
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  const dim3 grid((heads + group - 1) / group, n_chunks, batch);
  cudaError_t err;
  if (dtype == 1) {
    using tc::bf16;
    // set once: a call's host cost counts at S 1
    static const cudaError_t attr = [] {
      const cudaError_t e = allow_smem(tc::chunk_states_tc_kernel, tc::kStatesSmem);
      return e != cudaSuccess ? e
                              : allow_smem(tc::chunk_outputs_tc_kernel, tc::kOutputsSmem);
    }();
    err = attr;
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
    tc::chunk_states_tc_kernel<<<grid, tc::kStatesThreads, tc::kStatesSmem, stream_>>>(
        static_cast<const bf16*>(xh), la_f, static_cast<const bf16*>(bm), states_f,
        decay_f, st, seq, heads, headdim, state, chunk, n_chunks, group);
    err = cudaGetLastError();
    if (err == cudaSuccess) {
      err = launch_passing(states_f, decay_f, h0_f, hf, h_enter, true,
                           batch * heads, headdim, state, n_chunks, stream_);
    }
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
    tc::chunk_outputs_tc_kernel<<<grid, tc::kOutputsThreads, tc::kOutputsSmem,
                                  stream_>>>(
        static_cast<const bf16*>(xh), la_f, static_cast<const bf16*>(bm),
        static_cast<const bf16*>(cm), static_cast<const unsigned char*>(h_enter),
        static_cast<bf16*>(y), st, seq, heads, headdim, state, chunk, n_chunks, group);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int kStatesBytes = kStatesFloats * 4;
  constexpr int kOutputsBytes = kOutputsFloats * 4;
  static const cudaError_t attr = [] {
    const cudaError_t e = allow_smem(chunk_states_kernel, kStatesBytes);
    return e != cudaSuccess ? e : allow_smem(chunk_outputs_kernel, kOutputsBytes);
  }();
  err = attr;
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const auto* x_f = static_cast<const float*>(xh);
  const auto* b_f = static_cast<const float*>(bm);
  chunk_states_kernel<<<grid, kThreads, kStatesBytes, stream_>>>(
      x_f, la_f, b_f, states_f, decay_f, st, seq, heads, headdim, state, chunk,
      n_chunks, group);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    err = launch_passing(states_f, decay_f, h0_f, hf, h_enter, false,
                         batch * heads, headdim, state, n_chunks, stream_);
  }
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  chunk_outputs_kernel<<<grid, kThreads, kOutputsBytes, stream_>>>(
      x_f, la_f, b_f, static_cast<const float*>(cm),
      static_cast<const float*>(h_enter), static_cast<float*>(y), st, seq, heads,
      headdim, state, chunk, n_chunks, group);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
