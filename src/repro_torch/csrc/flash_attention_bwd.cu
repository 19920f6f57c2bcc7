// The backward pass of blocked attention, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package never differentiates through its
// Pallas kernels (its models call none of them; jax.value_and_grad takes
// the gradient of the plain attention through XLA).  The port's training
// step runs the forward kernel of csrc/flash_attention.cu, which defines no
// gradient, so this kernel gives it one: dQ, dK and dV of
//
//   O = softmax(Q K^T / sqrt(D) + mask) V
//
// for q (B, Hq, Sq, D) and k / v (B, Hkv, Sk, D), the kv head of query head
// h being h / (Hq / Hkv) (GQA and MQA without repeating K / V); causal with
// the queries at the end of the keys (query i sits at i + Sk - Sq, which
// sees keys <= it) or non-causal with any Sq and Sk; D in {32, 64, 128,
// 256}; the softmax in float32, the gradients written in the input's
// dtype.  With P = softmax(S), dP = dO V^T, Delta_i = sum_d dO_id O_id and
// dS = P * (dP - Delta): dV = P^T dO, dK = dS^T Q / sqrt(D),
// dQ = dS K / sqrt(D).  No kernel uses atomics, so two calls give equal
// bits.  The kernel is dispatched by dtype:
//
// bf16 (the training dtype): tensor cores and TMA, from the log-sum-exp
// that the forward kernel stores (lse = m + log l of each query row):
//   1. delta_kernel: Delta of every query row (a warp a row), into f32
//      scratch beside the lse;
//   2. dkv_tc_kernel, one block per (b * Hq + h, key tile), the first key
//      tiles (the longest causal loops) first: K and V (128 keys for
//      D <= 128, a warpgroup of 64 each) stay in shared memory while Q and
//      dO tiles of 64 queries, with their rows' lse and Delta, stream
//      through a TMA ring of two stages.  Each tile: S^T = K Q^T and
//      dP^T = V dO^T (wgmma, both operands in shared memory), P^T and
//      dS^T = P^T (dP^T - Delta) in f32 registers, then dV += P^T dO and
//      dK += dS^T Q with P^T and dS^T as bf16 A fragments from registers
//      and the tile as the MN-major B operand (the forward's trick for V).
//      Causal blocks start their query loop at the diagonal.  At D = 256
//      the block takes 64 keys: warpgroup 0 computes S^T, P^T and dV,
//      warpgroup 1 dP^T, dS^T and dK, P^T passing through shared memory
//      under two named barriers (dK and dV of 64 keys x 256 in f32 are 256
//      registers a thread together, 128 apart);
//   3. group_sum_kernel (GQA and MQA only): a group's query heads each
//      wrote their dK and dV to f32 scratch (B, Hq, Sk, D) in step 2, so
//      no block walks a group's heads one after another; this pass sums
//      each group in head order and writes the input's dtype.  With one
//      head a group, step 2 writes dK and dV directly;
//   4. dq_tc_kernel, one block per (b * Hq + h, 128-row query tile),
//      longest first, shaped like the forward: Q and dO loaded once, K and
//      V tiles (128 keys at D = 128, 32 at D = 256, else 64) through the
//      ring; S = Q K^T, dP = dO V^T, dQ += dS K with dS from registers.
//   Seven products of Sq x Sk x D a head against the work's five (S and
//   dP are computed by both kernels).  Tiles use the forward's 128-byte
//   swizzle (64-byte at D = 32); TMA zero-fills rows past the ends, and
//   those pairs are masked (P = 0) as the causal ones are.
//   Precision: P^T and dS^T enter their products as single bf16 values
//   (8 significant bits), the softmax, the sums and the scratch stay f32.
//
// f32: the SIMT kernels of the first version, the products on the CUDA
// cores in f32 (f32 is no training dtype, and its 1e-4 rule rules out bf16
// or TF32 products):
//   1. dq_kernel, one block per (b * Hq + h, 64-row query tile; 32 at
//      D = 256): first a pass over the key tiles that recomputes each query
//      row's log-sum-exp with an online max and Delta from O and dO, both
//      written to scratch for kernel 2; then a second pass that recomputes
//      S and dP a key tile at a time and accumulates dQ in registers.
//   2. dkv_kernel, one block per (b * Hkv + kv head, 64-key tile; 32 at
//      D = 256): K and V stay in shared memory while the block walks every
//      query tile of every query head of its group that can see the keys,
//      recomputes S^T and dP^T, and accumulates dK and dV in f32 registers.
//   Tiles are float32 in shared memory (a pitch of D + 4 floats, so the
//   float4 reads of 8 neighbouring rows hit distinct banks); each thread
//   of a 16 x 16 grid owns a few rows and columns of every product.
//
// What bounds it: the work is five products of Sq x Sk x D a head (S, dP,
// dV, dK, dQ; half of it when causal) against the bytes of q, k, v, o, dO
// and the three gradients, so on this card it is bound by operations by a
// wide margin; the bf16 route runs them on the tensor cores with the loads
// overlapped.  Warp specialisation, register reallocation and a persistent
// schedule are later work.
//
// Plain C interface, loaded with ctypes by
// repro_torch/kernels/flash_attention_bwd.py; the launches go on the
// caller's stream and the function returns the CUDA error code (0 on
// success).  Linked with -lcuda for cuTensorMapEncodeTiled.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;  // a 16 x 16 grid of threads

// Element strides of a (B, H, S, D) tensor; the D stride is 1.
struct Strides {
  int64_t b, h, s;
};

// Query rows (kQ) and key rows (kK) of a block's tiles, by head dim.
template <int D>
struct Tiles {
  static constexpr int kQ = D == 256 ? 32 : 64;
  static constexpr int kK = D == 256 ? 32 : 64;
  static constexpr int kPitch = D + 4;
  // q, dO, k and v tiles; two (kQ or kK) x (the other + 1) tiles of
  // probabilities / dS; the rows' log-sum-exp and Delta
  static constexpr size_t kSmem =
      sizeof(float) * ((2 * kQ + 2 * kK) * kPitch + 2 * kQ * (kK + 1) + 2 * kQ);
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Rows [row0, row0 + R) of a (S, D) slice with row stride `stride` into a
// float tile of pitch P; rows at or past n_rows are zero.
template <typename T, int R, int D, int P>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t stride, int row0,
                                          int n_rows) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    const int row = row0 + r;
    dst[r * P + d] =
        row < n_rows ? to_f32(src[static_cast<int64_t>(row) * stride + d]) : 0.f;
  }
}

// out[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over tiles of pitch P.
template <int RI, int CJ, int D, int P>
__device__ __forceinline__ void dot_tile(const float* a, const float* b,
                                         float (&out)[RI][CJ], int tx,
                                         int ty) {
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      out[i][j] = 0.f;
    }
  }
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[RI];
    float4 bv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      av[i] = *reinterpret_cast<const float4*>(&a[(ty + 16 * i) * P + d]);
    }
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      bv[j] = *reinterpret_cast<const float4*>(&b[(tx + 16 * j) * P + d]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        out[i][j] = fmaf(av[i].x, bv[j].x, out[i][j]);
        out[i][j] = fmaf(av[i].y, bv[j].y, out[i][j]);
        out[i][j] = fmaf(av[i].z, bv[j].z, out[i][j]);
        out[i][j] = fmaf(av[i].w, bv[j].w, out[i][j]);
      }
    }
  }
}

// acc[i][j] += sum_c w[ty + 16 i][c] * x[c][tx + 16 j], w of pitch WP and C
// columns, x of pitch XP.
template <int RI, int CJ, int C, int WP, int XP>
__device__ __forceinline__ void accumulate(const float* w, const float* x,
                                           float (&acc)[RI][CJ], int tx,
                                           int ty) {
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    float wv[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      wv[i] = w[(ty + 16 * i) * WP + c];
    }
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const float xv = x[c * XP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        acc[i][j] = fmaf(wv[i], xv, acc[i][j]);
      }
    }
  }
}

// The max and the sum of a row over the 16 threads of a half-warp that
// share it (lanes differing in their low four bits).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

struct Shape {
  int n_q_heads, group, seq_q, seq_k, kv_offset, causal;
  float scale;
};

// ---------------------------------------------------------------------------
// 1. log-sum-exp and Delta of each query row, then dQ
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const T* __restrict__ dout, T* __restrict__ dq,
              float* __restrict__ lse_out, float* __restrict__ delta_out,
              Strides qs, Strides ks, Strides vs, Strides os, Strides dos,
              Strides dqs, Shape sh) {
  using C = Tiles<D>;
  constexpr int kQ = C::kQ;
  constexpr int kK = C::kK;
  constexpr int kP = C::kPitch;
  constexpr int kSP = kK + 1;
  constexpr int kRI = kQ / 16;  // query rows a thread owns
  constexpr int kCJ = kK / 16;  // key columns a thread owns
  constexpr int kDJ = D / 16;   // head-dim columns a thread owns
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + kQ * kP;
  float* k_s = do_s + kQ * kP;
  float* v_s = k_s + kK * kP;
  float* ds_s = v_s + kK * kP;
  float* lse_s = ds_s + 2 * kQ * kSP;
  float* dlt_s = lse_s + kQ;

  const int bh = blockIdx.x;
  const int b = bh / sh.n_q_heads;
  const int h = bh % sh.n_q_heads;
  const int hk = h / sh.group;
  const int q0 = blockIdx.y * kQ;
  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;
  const T* op = o + b * os.b + h * os.h;
  const T* dop = dout + b * dos.b + h * dos.h;
  T* dqp = dq + b * dqs.b + h * dqs.h;
  const int64_t row_base = static_cast<int64_t>(bh) * sh.seq_q;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int warp = tid / 32;
  const int lane = tid % 32;

  load_tile<T, kQ, D, kP>(q_s, qp, qs.s, q0, sh.seq_q);
  load_tile<T, kQ, D, kP>(do_s, dop, dos.s, q0, sh.seq_q);
  __syncthreads();

  // Delta = rowsum(dO * O): a warp a row at a time
  for (int r = warp; r < kQ; r += kThreads / 32) {
    const int qi = q0 + r;
    float acc = 0.f;
    if (qi < sh.seq_q) {
      for (int d = lane; d < D; d += 32) {
        acc = fmaf(do_s[r * kP + d],
                   to_f32(op[static_cast<int64_t>(qi) * os.s + d]), acc);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) {
      dlt_s[r] = acc;
      if (qi < sh.seq_q) {
        delta_out[row_base + qi] = acc;
      }
    }
  }

  int n_kb = (sh.seq_k + kK - 1) / kK;
  if (sh.causal) {
    // the block's last real query row sees keys up to this position
    const int last_q = min(q0 + kQ, sh.seq_q) - 1 + sh.kv_offset;
    n_kb = min(n_kb, last_q / kK + 1);
  }

  // pass 1: the online max and sum of each row's scores
  float m[kRI];
  float l[kRI];
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  float s[kRI][kCJ];
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kK;
    __syncthreads();  // the previous tile's readers are done with k_s
    load_tile<T, kK, D, kP>(k_s, kp, ks.s, k0, sh.seq_k);
    __syncthreads();
    dot_tile<kRI, kCJ, D, kP>(q_s, k_s, s, tx, ty);
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      const int qpos = q0 + ty + 16 * i + sh.kv_offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * sh.scale;
        if (kpos >= sh.seq_k || (sh.causal && qpos < kpos)) {
          x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        sum += expf(s[i][j] - m_new);
      }
      l[i] = l[i] * expf(m[i] - m_new) + half_warp_sum(sum);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int r = ty + 16 * i;
    const float lse = m[i] + logf(l[i]);
    if (tx == 0) {
      lse_s[r] = lse;
      if (q0 + r < sh.seq_q) {
        lse_out[row_base + q0 + r] = lse;
      }
    }
  }

  // pass 2: dQ = dS K, a key tile at a time
  float acc[kRI][kDJ];
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
#pragma unroll
    for (int j = 0; j < kDJ; ++j) {
      acc[i][j] = 0.f;
    }
  }
  float dp[kRI][kCJ];
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kK;
    __syncthreads();  // k_s, v_s and ds_s are free; lse_s is written
    load_tile<T, kK, D, kP>(k_s, kp, ks.s, k0, sh.seq_k);
    load_tile<T, kK, D, kP>(v_s, vp, vs.s, k0, sh.seq_k);
    __syncthreads();
    dot_tile<kRI, kCJ, D, kP>(q_s, k_s, s, tx, ty);
    dot_tile<kRI, kCJ, D, kP>(do_s, v_s, dp, tx, ty);
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r + sh.kv_offset;
      const float lse = lse_s[r];
      const float dlt = dlt_s[r];
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        float ds = 0.f;
        if (kpos < sh.seq_k && !(sh.causal && qpos < kpos)) {
          const float p = expf(s[i][j] * sh.scale - lse);
          ds = p * (dp[i][j] - dlt);
        }
        ds_s[r * kSP + c] = ds;
      }
    }
    __syncthreads();
    accumulate<kRI, kDJ, kK, kSP, kP>(ds_s, k_s, acc, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi < sh.seq_q) {
#pragma unroll
      for (int j = 0; j < kDJ; ++j) {
        store(&dqp[static_cast<int64_t>(qi) * dqs.s + tx + 16 * j],
              acc[i][j] * sh.scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dK and dV of a key tile, over its group's query heads
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               T* __restrict__ dk, T* __restrict__ dv,
               const float* __restrict__ lse_in,
               const float* __restrict__ delta_in, Strides qs, Strides ks,
               Strides vs, Strides dos, Strides dks, Strides dvs,
               int n_kv_heads, Shape sh) {
  using C = Tiles<D>;
  constexpr int kQ = C::kQ;
  constexpr int kK = C::kK;
  constexpr int kP = C::kPitch;
  constexpr int kSP = kQ + 1;
  constexpr int kRK = kK / 16;  // key rows a thread owns
  constexpr int kCQ = kQ / 16;  // query columns a thread owns
  constexpr int kDJ = D / 16;   // head-dim columns a thread owns
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kK * kP;
  float* q_s = v_s + kK * kP;
  float* do_s = q_s + kQ * kP;
  float* p_s = do_s + kQ * kP;
  float* ds_s = p_s + kK * kSP;
  float* lse_s = ds_s + kK * kSP;
  float* dlt_s = lse_s + kQ;

  const int bh = blockIdx.x;
  const int b = bh / n_kv_heads;
  const int hk = bh % n_kv_heads;
  const int k0 = blockIdx.y * kK;
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;
  T* dkp = dk + b * dks.b + hk * dks.h;
  T* dvp = dv + b * dvs.b + hk * dvs.h;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  load_tile<T, kK, D, kP>(k_s, kp, ks.s, k0, sh.seq_k);
  load_tile<T, kK, D, kP>(v_s, vp, vs.s, k0, sh.seq_k);

  float acc_k[kRK][kDJ];
  float acc_v[kRK][kDJ];
#pragma unroll
  for (int i = 0; i < kRK; ++i) {
#pragma unroll
    for (int j = 0; j < kDJ; ++j) {
      acc_k[i][j] = 0.f;
      acc_v[i][j] = 0.f;
    }
  }

  // the first query row that sees key k0 (causal), as a query tile
  const int n_qb = (sh.seq_q + kQ - 1) / kQ;
  const int qb0 = sh.causal ? max(0, k0 - sh.kv_offset) / kQ : 0;
  float s[kRK][kCQ];
  float dp[kRK][kCQ];
  for (int g = 0; g < sh.group; ++g) {
    const int h = hk * sh.group + g;
    const T* qp = q + b * qs.b + h * qs.h;
    const T* dop = dout + b * dos.b + h * dos.h;
    const int64_t row_base =
        (static_cast<int64_t>(b) * sh.n_q_heads + h) * sh.seq_q;
    for (int qb = qb0; qb < n_qb; ++qb) {
      const int q0 = qb * kQ;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, kQ, D, kP>(q_s, qp, qs.s, q0, sh.seq_q);
      load_tile<T, kQ, D, kP>(do_s, dop, dos.s, q0, sh.seq_q);
      if (tid < kQ) {
        const int qi = q0 + tid;
        lse_s[tid] = qi < sh.seq_q ? lse_in[row_base + qi] : 0.f;
        dlt_s[tid] = qi < sh.seq_q ? delta_in[row_base + qi] : 0.f;
      }
      __syncthreads();
      // S^T and dP^T: rows are keys, columns queries
      dot_tile<kRK, kCQ, D, kP>(k_s, q_s, s, tx, ty);
      dot_tile<kRK, kCQ, D, kP>(v_s, do_s, dp, tx, ty);
#pragma unroll
      for (int i = 0; i < kRK; ++i) {
        const int r = ty + 16 * i;
        const int kpos = k0 + r;
#pragma unroll
        for (int j = 0; j < kCQ; ++j) {
          const int c = tx + 16 * j;
          const int qi = q0 + c;
          float p = 0.f;
          float ds = 0.f;
          if (kpos < sh.seq_k && qi < sh.seq_q &&
              !(sh.causal && qi + sh.kv_offset < kpos)) {
            p = expf(s[i][j] * sh.scale - lse_s[c]);
            ds = p * (dp[i][j] - dlt_s[c]);
          }
          p_s[r * kSP + c] = p;
          ds_s[r * kSP + c] = ds;
        }
      }
      __syncthreads();
      accumulate<kRK, kDJ, kQ, kSP, kP>(p_s, do_s, acc_v, tx, ty);
      accumulate<kRK, kDJ, kQ, kSP, kP>(ds_s, q_s, acc_k, tx, ty);
    }
  }

#pragma unroll
  for (int i = 0; i < kRK; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj < sh.seq_k) {
#pragma unroll
      for (int j = 0; j < kDJ; ++j) {
        const int d = tx + 16 * j;
        store(&dkp[static_cast<int64_t>(kj) * dks.s + d], acc_k[i][j] * sh.scale);
        store(&dvp[static_cast<int64_t>(kj) * dvs.s + d], acc_v[i][j]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, void* dq, void* dk,
                   void* dv, float* lse, float* delta, const int64_t* st,
                   int batch, int n_q_heads, int n_kv_heads, int seq_q,
                   int seq_k, int causal, cudaStream_t stream) {
  using C = Tiles<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(dkv_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(C::kSmem));
  }
  if (err != cudaSuccess) {
    return err;
  }
  auto at = [st](int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; };
  const Shape sh{n_q_heads,
                 n_q_heads / n_kv_heads,
                 seq_q,
                 seq_k,
                 causal ? seq_k - seq_q : 0,
                 causal,
                 1.0f / sqrtf(static_cast<float>(D))};
  const dim3 grid_q(static_cast<unsigned>(batch * n_q_heads),
                    static_cast<unsigned>((seq_q + C::kQ - 1) / C::kQ));
  dq_kernel<T, D><<<grid_q, kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<T*>(dq), lse, delta, at(0),
      at(1), at(2), at(3), at(4), at(5), sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) {
    return err;
  }
  const dim3 grid_k(static_cast<unsigned>(batch * n_kv_heads),
                    static_cast<unsigned>((seq_k + C::kK - 1) / C::kK));
  dkv_kernel<T, D><<<grid_k, kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dk), static_cast<T*>(dv), lse, delta, at(0), at(1),
      at(2), at(4), at(6), at(7), n_kv_heads, sh);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma on tiles that TMA brings into rings of stages
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kStages = 2;  // of each ring (three measured no faster)
constexpr float kLog2e = 1.4426950408889634f;

// The swizzled panels of a bf16 tile as TMA writes them and wgmma reads
// them: kPanel columns of every row, one panel after another.
template <int D>
struct Panels {
  static constexpr int kPanel = D >= 64 ? 64 : 32;  // elements a swizzle row
  static constexpr int kRowBytes = kPanel * 2;      // 128 or 64
  static constexpr int kCount = D / kPanel;
  static constexpr int kSteps = kPanel / 16;        // k16 steps in a row
  // 1 = 128-byte swizzle, 2 = 64-byte; the atom is 8 rows
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  static constexpr uint32_t kSbo = 8 * kRowBytes;   // next 8-row group
};

// dK, dV: a block's keys (two warpgroups of 64; at D = 256 both take the
// same 64) in shared memory, and a ring of query tiles (Q, dO and their
// rows' lse and Delta).
template <int D>
struct KvTile {
  static constexpr bool kSplit = D == 256;
  static constexpr int kKeys = kSplit ? 64 : 128;
  static constexpr int kM = 64;  // queries a ring tile
  static constexpr int kKBytes = kKeys * D * 2;
  static constexpr int kQBytes = kM * D * 2;
  static constexpr int kRowsBytes = kM * 4;
  // P^T of a tile in f32, handed from the dV warpgroup to the dK one
  static constexpr int kPBytes = kSplit ? 64 * kM * 4 : 0;
  static constexpr int kOffV = kKBytes;
  static constexpr int kOffQ = 2 * kKBytes;
  static constexpr int kOffDo = kOffQ + kStages * kQBytes;
  static constexpr int kOffLse = kOffDo + kStages * kQBytes;
  static constexpr int kOffDlt = kOffLse + kStages * kRowsBytes;
  static constexpr int kOffP = kOffDlt + kStages * kRowsBytes;
  static constexpr int kOffBar = kOffP + kPBytes;
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's atom;
  // barriers: kv, and q_full, do_full, empty a stage
  static constexpr int kSmem = 1024 + kOffBar + 8 * (1 + 3 * kStages);
};

// dQ: a block's 128 query rows (two warpgroups of 64) with their dO, and a
// ring of key tiles (K and V).
template <int D>
struct QTile {
  static constexpr int kM = 128;
  // keys a ring tile: 128 at D 128 (S and dP as m64n128 products); 64 at
  // D 32 and 64, where 128 measured slower on short and 16-key ranges; 32 at
  // D 256, where Q and dO take 128 KB of shared memory
  static constexpr int kN = D == 128 ? 128 : D == 256 ? 32 : 64;
  static constexpr int kQBytes = kM * D * 2;
  static constexpr int kKBytes = kN * D * 2;
  static constexpr int kOffDo = kQBytes;
  static constexpr int kOffK = 2 * kQBytes;
  static constexpr int kOffV = kOffK + kStages * kKBytes;
  static constexpr int kOffBar = kOffV + kStages * kKBytes;
  // barriers: q and dO, and k_full, v_full, empty a stage
  static constexpr int kSmem = 1024 + kOffBar + 8 * (1 + 3 * kStages);
};

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

// One box of a 4-D tensor map (coordinates innermost first) into shared
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

// One box of a 2-D f32 tensor map (a tile's lse or Delta row).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Named barriers between the two warpgroups (barrier 0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(kThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(kThreads) : "memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    asm volatile("" : "+f"(r[i])::"memory");
  }
}

// D (64 x N, f32) (+)= A (64 x 16, shared, K-major) B (16 x N, shared,
// K-major); scale_d 0 overwrites D.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d);
// D (64 x N, f32) (+)= A (64 x 16, bf16 registers) B (16 x N, shared,
// MN-major).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t desc_a,
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

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t desc_a,
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
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}


// The f32 registers of an m64nN accumulator as the A fragments of N / 16
// k16 steps, bf16 (for 16-bit types the two layouts line up): registers
// 8 kk + {0..7} are step kk's (r, c), (r + 8, c), (r, c + 8), (r + 8, c + 8).
template <int N>
__device__ __forceinline__ void to_a(const float (&x)[N / 2],
                                     uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    a[i / 8][(i % 8) / 2] = pack_bf16(x[i], x[i + 1]);
  }
}

// Rows r and r + 8 (r = row0 of the warpgroup's 64, from `row`) of an
// m64nD accumulator, times `mul`, to bf16 rows of `dst` (row stride
// `stride`) or to f32 rows of a contiguous (.., D) scratch; rows at or past
// n_rows are not written.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           float mul, int row, int n_rows,
                                           int col0, __nv_bfloat16* dst,
                                           int64_t stride, float* scratch) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row + 8 * r;
    if (i >= n_rows) {
      continue;
    }
    if (scratch != nullptr) {
      float* out = scratch + static_cast<int64_t>(i) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(out + 8 * j + col0) =
            make_float2(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
      }
    } else {
      __nv_bfloat16* out = dst + static_cast<int64_t>(i) * stride;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + col0) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul,
                                  acc[4 * j + 2 * r + 1] * mul);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 1. Delta = rowsum(dO * O), a warp a row
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const __nv_bfloat16* __restrict__ o,
                 const __nv_bfloat16* __restrict__ dout, Strides os,
                 Strides dos, float* __restrict__ delta, int64_t ld,
                 int n_q_heads, int seq_q, int64_t n_rows) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (row >= n_rows) {
    return;
  }
  const int lane = threadIdx.x % 32;
  const int64_t bh = row / seq_q;
  const int qi = static_cast<int>(row % seq_q);
  const int64_t b = bh / n_q_heads;
  const int64_t h = bh % n_q_heads;
  const __nv_bfloat16* op = o + b * os.b + h * os.h + qi * os.s;
  const __nv_bfloat16* dop = dout + b * dos.b + h * dos.h + qi * dos.s;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) {
    acc = fmaf(__bfloat162float(dop[d]), __bfloat162float(op[d]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    delta[bh * ld + qi] = acc;
  }
}

// ---------------------------------------------------------------------------
// 2. dK and dV of a key tile for one query head
// ---------------------------------------------------------------------------
//
// Block (b * Hq + h, key tile).  D <= 128: 128 keys, each warpgroup owns 64
// and runs all four products of a query tile on them.  D = 256: 64 keys;
// warpgroup 0 computes S^T, P^T and dV, warpgroup 1 dP^T, dS^T and dK, P^T
// passing through shared memory (dV and dK of 64 keys x 256 would not fit
// one thread's registers together).  dK and dV go to the kv head's rows
// in bf16 when the group is one head, else to this query head's rows of
// the f32 scratch that group_sum_kernel sums.

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const __grid_constant__ CUtensorMap map_do,
                  const __grid_constant__ CUtensorMap map_lse,
                  const __grid_constant__ CUtensorMap map_dlt,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, Strides dks, Strides dvs,
                  float* __restrict__ scratch, Shape sh, float scale_log2) {
  using C = KvTile<D>;
  using P = Panels<D>;
  constexpr int kM = C::kM;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - raw);
  const uint32_t k_s = base;
  const uint32_t v_s = base + C::kOffV;
  auto q_s = [&](int s) { return base + C::kOffQ + s * C::kQBytes; };
  auto do_s = [&](int s) { return base + C::kOffDo + s * C::kQBytes; };
  const float* lse_s = reinterpret_cast<const float*>(base_ptr + C::kOffLse);
  const float* dlt_s = reinterpret_cast<const float*>(base_ptr + C::kOffDlt);
  float* p_x = reinterpret_cast<float*>(base_ptr + C::kOffP);
  // bars: kv, q_full[kStages], do_full[kStages], empty[kStages]
  const uint32_t bars = base + C::kOffBar;
  const uint32_t bar_kv = bars;
  auto bar_q = [&](int s) { return bars + 8 * (1 + s); };
  auto bar_do = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto bar_empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };

  const int bh = blockIdx.x;
  const int b = bh / sh.n_q_heads;
  const int h = bh % sh.n_q_heads;
  const int hk = h / sh.group;
  // the first key tiles see the most query tiles: they start first
  const int k0 = blockIdx.y * C::kKeys;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;

  // the query tiles that see a key of this block (causal: from the diagonal)
  const int n_qt = (sh.seq_q + kM - 1) / kM;
  const int qt0 = sh.causal ? max(0, k0 - sh.kv_offset) / kM : 0;
  const int n = n_qt - qt0;

  auto load_q = [&](int j, int s) {
    const int q0 = (qt0 + j) * kM;
    mbar_expect_tx(bar_q(s), C::kQBytes + 2 * C::kRowsBytes);
#pragma unroll
    for (int p = 0; p < P::kCount; ++p) {
      tma_load(q_s(s) + p * kM * P::kRowBytes, &map_q, bar_q(s),
               p * P::kPanel, q0, h, b);
    }
    tma_load_2d(base + C::kOffLse + s * C::kRowsBytes, &map_lse, bar_q(s), q0,
                bh);
    tma_load_2d(base + C::kOffDlt + s * C::kRowsBytes, &map_dlt, bar_q(s), q0,
                bh);
    mbar_expect_tx(bar_do(s), C::kQBytes);
#pragma unroll
    for (int p = 0; p < P::kCount; ++p) {
      tma_load(do_s(s) + p * kM * P::kRowBytes, &map_do, bar_do(s),
               p * P::kPanel, q0, h, b);
    }
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_q(s), 1);
      mbar_init(bar_do(s), 1);
      mbar_init(bar_empty(s), 2);  // one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * C::kKBytes);
#pragma unroll
    for (int p = 0; p < P::kCount; ++p) {
      tma_load(k_s + p * C::kKeys * P::kRowBytes, &map_k, bar_kv,
               p * P::kPanel, k0, hk, b);
      tma_load(v_s + p * C::kKeys * P::kRowBytes, &map_v, bar_kv,
               p * P::kPanel, k0, hk, b);
    }
    load_q(0, 0);
  }

  // this thread's rows (keys) and columns (queries) in the accumulator
  // layout of m64nNk16: rows r and r + 8, columns 8 j + 2 (lane % 4) + {0, 1}
  const int row0 = 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  const int key_off = C::kSplit ? 0 : 64 * wg;  // the warpgroup's keys
  const int kw0 = k0 + key_off;
  // A operands: this warpgroup's 64 rows of K and of V
  const uint32_t k_wg = k_s + key_off * P::kRowBytes;
  const uint32_t v_wg = v_s + key_off * P::kRowBytes;

  // D <= 128: dV then dK; D = 256: warpgroup 0's dV or warpgroup 1's dK
  float acc[D / 2];
  float acc_k[C::kSplit ? 1 : D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    acc[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < (C::kSplit ? 1 : D / 2); ++i) {
    acc_k[i] = 0.f;
  }

  mbar_wait(bar_kv, 0);
  __syncwarp();
  for (int j = 0; j < n; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    if (tid == 0 && j + 1 < n) {
      const int sn = (j + 1) % kStages;
      if (j + 1 >= kStages) {
        // tile j + 1 - kStages used that stage; both warpgroups must be done
        mbar_wait(bar_empty(sn), ((j + 1 - kStages) / kStages) & 1);
      }
      load_q(j + 1, sn);
    }
    __syncwarp();  // wgmma's .aligned instructions need the warp converged
    const int q0 = (qt0 + j) * kM;
    // only tiles that cross the diagonal or the end of the queries mask
    const bool masked =
        q0 + kM > sh.seq_q || (sh.causal && kw0 + 63 > q0 + sh.kv_offset);
    const float* lse_t = lse_s + s * kM;
    const float* dlt_t = dlt_s + s * kM;

    // the f32 P^T of this tile's (key, query) pairs, masked pairs 0
    auto probs = [&](float (&st)[kM / 2]) {
#pragma unroll
      for (int i = 0; i < kM / 2; ++i) {
        const int c = 8 * (i / 4) + col0 + (i & 1);
        float p = exp2f(fmaf(st[i], scale_log2, -lse_t[c] * kLog2e));
        if (masked) {
          const int key = kw0 + row0 + ((i & 2) ? 8 : 0);
          const int qi = q0 + c;
          if (qi >= sh.seq_q || (sh.causal && key > qi + sh.kv_offset)) {
            p = 0.f;
          }
        }
        st[i] = p;
      }
    };
    // X^T = A B^T, A this warpgroup's 64 rows (K or V), B the tile (Q or dO)
    auto product_t = [&](float (&x)[kM / 2], uint32_t a_s, uint32_t b_s) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int p = kk / P::kSteps;
        const uint32_t off = (kk % P::kSteps) * 32;
        const uint64_t da = make_desc(a_s + p * C::kKeys * P::kRowBytes + off,
                                      16, P::kSbo, P::kLayout);
        const uint64_t db = make_desc(b_s + p * kM * P::kRowBytes + off, 16,
                                      P::kSbo, P::kLayout);
        wgmma_ss<kM>(x, da, db, kk > 0);
      }
    };
    // acc += A (64 x kM, bf16 registers) T, T the tile (kM x D, MN-major)
    auto accumulate = [&](float (&d)[D / 2], const uint32_t (&a)[kM / 16][4],
                          uint32_t t_s) {
#pragma unroll
      for (int kk = 0; kk < kM / 16; ++kk) {
        const uint64_t db = make_desc(t_s + kk * 16 * P::kRowBytes,
                                      kM * P::kRowBytes, P::kSbo, P::kLayout);
        wgmma_rs<D>(d, a[kk], db, 1);
      }
    };

    if constexpr (!C::kSplit) {
      float st[kM / 2];
      float dpt[kM / 2];
      mbar_wait(bar_q(s), parity);
      __syncwarp();
      wgmma_fence();
      product_t(st, k_wg, q_s(s));  // S^T = K Q^T
      wgmma_commit();
      mbar_wait(bar_do(s), parity);
      __syncwarp();
      product_t(dpt, v_wg, do_s(s));  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);
      probs(st);
      wgmma_wait<0>();
      fence_regs(dpt);
      // dS^T = P^T (dP^T - Delta); both enter their products as bf16
      uint32_t pa[kM / 16][4];
      uint32_t dsa[kM / 16][4];
#pragma unroll
      for (int i = 0; i < kM / 2; i += 2) {
        const int c = 8 * (i / 4) + col0;
        pa[i / 8][(i % 8) / 2] = pack_bf16(st[i], st[i + 1]);
        dsa[i / 8][(i % 8) / 2] = pack_bf16(st[i] * (dpt[i] - dlt_t[c]),
                                            st[i + 1] * (dpt[i + 1] - dlt_t[c + 1]));
      }
      fence_regs(acc);
      fence_regs(acc_k);
      wgmma_fence();
      accumulate(acc, pa, do_s(s));    // dV += P^T dO
      accumulate(acc_k, dsa, q_s(s));  // dK += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(acc_k);
    } else if (wg == 0) {
      float st[kM / 2];
      mbar_wait(bar_q(s), parity);
      __syncwarp();
      wgmma_fence();
      product_t(st, k_wg, q_s(s));  // S^T = K Q^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      probs(st);
      if (j > 0) {
        bar_sync(2);  // warpgroup 1 has read the last tile's P^T
      }
#pragma unroll
      for (int i = 0; i < kM / 2; ++i) {
        p_x[i * 128 + tid] = st[i];
      }
      bar_arrive(1);
      uint32_t pa[kM / 16][4];
      to_a<kM>(st, pa);
      mbar_wait(bar_do(s), parity);
      __syncwarp();
      fence_regs(acc);
      wgmma_fence();
      accumulate(acc, pa, do_s(s));  // dV += P^T dO
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    } else {
      float dpt[kM / 2];
      mbar_wait(bar_do(s), parity);
      __syncwarp();
      wgmma_fence();
      product_t(dpt, v_wg, do_s(s));  // dP^T = V dO^T
      wgmma_commit();
      mbar_wait(bar_q(s), parity);  // Q, and this tile's Delta
      __syncwarp();
      wgmma_wait<0>();
      fence_regs(dpt);
      bar_sync(1);  // warpgroup 0 has written this tile's P^T
#pragma unroll
      for (int i = 0; i < kM / 2; ++i) {
        const int c = 8 * (i / 4) + col0 + (i & 1);
        dpt[i] = p_x[i * 128 + tid - 128] * (dpt[i] - dlt_t[c]);
      }
      if (j + 1 < n) {
        bar_arrive(2);
      }
      uint32_t dsa[kM / 16][4];
      to_a<kM>(dpt, dsa);
      fence_regs(acc);
      wgmma_fence();
      accumulate(acc, dsa, q_s(s));  // dK += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    if (tid % 128 == 0) {
      mbar_arrive(bar_empty(s));
    }
  }

  // dK = scale dS^T Q; dV = P^T dO
  const bool direct = sh.group == 1;
  const int64_t head_rows =
      (static_cast<int64_t>(b) * sh.n_q_heads + h) * sh.seq_k;
  float* sk_rows = direct ? nullptr : scratch + head_rows * D;
  float* sv_rows =
      direct ? nullptr
             : scratch + static_cast<int64_t>(gridDim.x) * sh.seq_k * D +
                   head_rows * D;
  __nv_bfloat16* dk_rows = dk + b * dks.b + hk * dks.h;
  __nv_bfloat16* dv_rows = dv + b * dvs.b + hk * dvs.h;
  const int row = kw0 + row0;
  if constexpr (!C::kSplit) {
    store_rows<D>(acc, 1.f, row, sh.seq_k, col0, dv_rows, dvs.s, sv_rows);
    store_rows<D>(acc_k, sh.scale, row, sh.seq_k, col0, dk_rows, dks.s,
                  sk_rows);
  } else if (wg == 0) {
    store_rows<D>(acc, 1.f, row, sh.seq_k, col0, dv_rows, dvs.s, sv_rows);
  } else {
    store_rows<D>(acc, sh.scale, row, sh.seq_k, col0, dk_rows, dks.s,
                  sk_rows);
  }
}

// ---------------------------------------------------------------------------
// 3. GQA: dK and dV of a kv head, its query heads summed in head order
// ---------------------------------------------------------------------------

// scratch: dK then dV, each (B, Hq, Sk, D) f32; four head-dim columns a
// thread.
__global__ void __launch_bounds__(kThreads)
    group_sum_kernel(const float* __restrict__ scratch,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, Strides dks, Strides dvs,
                     int n_kv_heads, int group, int seq_k, int head_dim,
                     int64_t n_quads, int64_t half) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= n_quads) {
    return;
  }
  const int d = static_cast<int>(idx % (head_dim / 4)) * 4;
  int64_t rest = idx / (head_dim / 4);
  const int s = static_cast<int>(rest % seq_k);
  rest /= seq_k;
  const int hk = static_cast<int>(rest % n_kv_heads);
  const int64_t b = rest / n_kv_heads;
  const int64_t step = static_cast<int64_t>(seq_k) * head_dim;
  const int64_t first =
      ((b * n_kv_heads + hk) * group * seq_k + s) * head_dim + d;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 sv = sk;
  for (int g = 0; g < group; ++g) {
    const float4 a = *reinterpret_cast<const float4*>(scratch + first + g * step);
    const float4 c =
        *reinterpret_cast<const float4*>(scratch + half + first + g * step);
    sk = make_float4(sk.x + a.x, sk.y + a.y, sk.z + a.z, sk.w + a.w);
    sv = make_float4(sv.x + c.x, sv.y + c.y, sv.z + c.z, sv.w + c.w);
  }
  __nv_bfloat16* kp = dk + b * dks.b + hk * dks.h + s * dks.s + d;
  __nv_bfloat16* vp = dv + b * dvs.b + hk * dvs.h + s * dvs.s + d;
  reinterpret_cast<__nv_bfloat162*>(kp)[0] = __floats2bfloat162_rn(sk.x, sk.y);
  reinterpret_cast<__nv_bfloat162*>(kp)[1] = __floats2bfloat162_rn(sk.z, sk.w);
  reinterpret_cast<__nv_bfloat162*>(vp)[0] = __floats2bfloat162_rn(sv.x, sv.y);
  reinterpret_cast<__nv_bfloat162*>(vp)[1] = __floats2bfloat162_rn(sv.z, sv.w);
}

// ---------------------------------------------------------------------------
// 4. dQ of a query tile
// ---------------------------------------------------------------------------
//
// Block (b * Hq + h, 128-row query tile), longest first: Q and dO loaded
// once, K and V tiles through the ring; S = Q K^T and dP = dO V^T from
// shared memory, P and dS in registers, dQ += dS K with dS from registers
// and K as the MN-major operand.

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dq_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_do,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, int64_t ld,
                 __nv_bfloat16* __restrict__ dq, Strides dqs, Shape sh,
                 float scale_log2) {
  using C = QTile<D>;
  using P = Panels<D>;
  constexpr int kN = C::kN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t do_s = base + C::kOffDo;
  auto k_s = [&](int s) { return base + C::kOffK + s * C::kKBytes; };
  auto v_s = [&](int s) { return base + C::kOffV + s * C::kKBytes; };
  // bars: q and dO, k_full[kStages], v_full[kStages], empty[kStages]
  const uint32_t bars = base + C::kOffBar;
  const uint32_t bar_qdo = bars;
  auto bar_k = [&](int s) { return bars + 8 * (1 + s); };
  auto bar_v = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto bar_empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };

  const int bh = blockIdx.x;
  const int b = bh / sh.n_q_heads;
  const int h = bh % sh.n_q_heads;
  const int hk = h / sh.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kM;  // longest first
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;

  int n_tiles = (sh.seq_k + kN - 1) / kN;
  if (sh.causal) {
    const int last_q = min(q0 + C::kM, sh.seq_q) - 1 + sh.kv_offset;
    n_tiles = min(n_tiles, last_q / kN + 1);
  }

  auto load_kv = [&](int j, int s) {
    mbar_expect_tx(bar_k(s), C::kKBytes);
#pragma unroll
    for (int p = 0; p < P::kCount; ++p) {
      tma_load(k_s(s) + p * kN * P::kRowBytes, &map_k, bar_k(s),
               p * P::kPanel, j * kN, hk, b);
    }
    mbar_expect_tx(bar_v(s), C::kKBytes);
#pragma unroll
    for (int p = 0; p < P::kCount; ++p) {
      tma_load(v_s(s) + p * kN * P::kRowBytes, &map_v, bar_v(s),
               p * P::kPanel, j * kN, hk, b);
    }
  };

  if (tid == 0) {
    mbar_init(bar_qdo, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      mbar_init(bar_empty(s), 2);  // one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_qdo, 2 * C::kQBytes);
#pragma unroll
    for (int p = 0; p < P::kCount; ++p) {
      tma_load(q_s + p * C::kM * P::kRowBytes, &map_q, bar_qdo,
               p * P::kPanel, q0, h, b);
      tma_load(do_s + p * C::kM * P::kRowBytes, &map_do, bar_qdo,
               p * P::kPanel, q0, h, b);
    }
    load_kv(0, 0);
  }

  const int row0 = 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  const int qrow = q0 + 64 * wg + row0;  // and qrow + 8
  const int qpos0 = qrow + sh.kv_offset;
  // the rows' lse (in log2 units) and Delta
  float lse2[2];
  float dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qrow + 8 * r;
    const bool in = qi < sh.seq_q;
    lse2[r] = in ? lse[bh * ld + qi] * kLog2e : 0.f;
    dlt[r] = in ? delta[bh * ld + qi] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    acc[i] = 0.f;
  }
  const uint32_t q_wg = q_s + 64 * wg * P::kRowBytes;
  const uint32_t do_wg = do_s + 64 * wg * P::kRowBytes;
  // X = A B^T, A this warpgroup's 64 rows (Q or dO), B the tile (K or V)
  auto product = [&](float (&x)[kN / 2], uint32_t a_s, uint32_t b_s) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / P::kSteps;
      const uint32_t off = (kk % P::kSteps) * 32;
      const uint64_t da = make_desc(a_s + p * C::kM * P::kRowBytes + off, 16,
                                    P::kSbo, P::kLayout);
      const uint64_t db = make_desc(b_s + p * kN * P::kRowBytes + off, 16,
                                    P::kSbo, P::kLayout);
      wgmma_ss<kN>(x, da, db, kk > 0);
    }
  };

  mbar_wait(bar_qdo, 0);
  __syncwarp();
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    if (tid == 0 && j + 1 < n_tiles) {
      const int sn = (j + 1) % kStages;
      if (j + 1 >= kStages) {
        mbar_wait(bar_empty(sn), ((j + 1 - kStages) / kStages) & 1);
      }
      load_kv(j + 1, sn);
    }
    __syncwarp();
    const int k0 = j * kN;
    float sc[kN / 2];
    float dp[kN / 2];
    mbar_wait(bar_k(s), parity);
    __syncwarp();
    wgmma_fence();
    product(sc, q_wg, k_s(s));  // S = Q K^T
    wgmma_commit();
    mbar_wait(bar_v(s), parity);
    __syncwarp();
    product(dp, do_wg, v_s(s));  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
    const bool masked =
        k0 + kN > sh.seq_k ||
        (sh.causal && k0 + kN - 1 > q0 + 64 * wg + sh.kv_offset);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      const int r = (i >> 1) & 1;
      float p = exp2f(fmaf(sc[i], scale_log2, -lse2[r]));
      if (masked) {
        const int kpos = k0 + 8 * (i / 4) + col0 + (i & 1);
        if (kpos >= sh.seq_k || (sh.causal && kpos > qpos0 + 8 * r)) {
          p = 0.f;
        }
      }
      sc[i] = p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // dS = P (dP - Delta), bf16 as A
    uint32_t dsa[kN / 16][4];
#pragma unroll
    for (int i = 0; i < kN / 2; i += 2) {
      const int r = (i >> 1) & 1;
      dsa[i / 8][(i % 8) / 2] = pack_bf16(sc[i] * (dp[i] - dlt[r]),
                                          sc[i + 1] * (dp[i + 1] - dlt[r]));
    }
    fence_regs(acc);
    wgmma_fence();
    // dQ += dS K, K the MN-major operand
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      const uint64_t db = make_desc(k_s(s) + kk * 16 * P::kRowBytes,
                                    kN * P::kRowBytes, P::kSbo, P::kLayout);
      wgmma_rs<D>(acc, dsa[kk], db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (tid % 128 == 0) {
      mbar_arrive(bar_empty(s));
    }
  }

  store_rows<D>(acc, sh.scale, qrow, sh.seq_q, col0,
                dq + b * dqs.b + h * dqs.h, dqs.s, nullptr);
}

// The tensor map of a (B, H, S, D) bf16 tensor with element strides
// st = (b, h, s) and a unit D stride, read in boxes of `rows` x kPanel.
template <int D>
cudaError_t make_map(CUtensorMap* map, const void* ptr, const int64_t* st,
                     int batch, int heads, int seq, int rows) {
  using P = Panels<D>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  // a dimension of size 1 is never stepped along; any legal stride does
  const int64_t sizes[3] = {seq, heads, batch};
  const int64_t elems[3] = {st[2], st[1], st[0]};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    strides[i] = static_cast<cuuint64_t>(sizes[i] == 1 ? D : elems[i]) * 2;
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(P::kPanel),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      P::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of `n_rows` f32 rows of `seq` values, `ld` apart (lse or
// Delta of every (b, h)), read in boxes of `cols` values of one row.
cudaError_t make_rows_map(CUtensorMap* map, const float* ptr, int64_t n_rows,
                          int seq, int64_t ld, int cols) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(n_rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(cols), 1};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, void* dq, void* dk,
                      void* dv, const float* lse, float* delta, int64_t ld,
                      float* scratch, const int64_t* st, int batch,
                      int n_q_heads, int n_kv_heads, int seq_q, int seq_k,
                      int causal, cudaStream_t stream) {
  using KC = KvTile<D>;
  using QC = QTile<D>;
  const int64_t rows = static_cast<int64_t>(batch) * n_q_heads;
  // the dK / dV kernel's maps (key tiles of kKeys, query tiles of kM), then
  // the dQ kernel's (query tiles of 128, key tiles of kN)
  CUtensorMap kq, kk, kv, kdo, klse, kdlt, qq, qk, qv, qdo;
  cudaError_t err = make_map<D>(&kq, q, st, batch, n_q_heads, seq_q, KC::kM);
  if (err == cudaSuccess) {
    err = make_map<D>(&kk, k, st + 3, batch, n_kv_heads, seq_k, KC::kKeys);
  }
  if (err == cudaSuccess) {
    err = make_map<D>(&kv, v, st + 6, batch, n_kv_heads, seq_k, KC::kKeys);
  }
  if (err == cudaSuccess) {
    err = make_map<D>(&kdo, dout, st + 12, batch, n_q_heads, seq_q, KC::kM);
  }
  if (err == cudaSuccess) {
    err = make_rows_map(&klse, lse, rows, seq_q, ld, KC::kM);
  }
  if (err == cudaSuccess) {
    err = make_rows_map(&kdlt, delta, rows, seq_q, ld, KC::kM);
  }
  if (err == cudaSuccess) {
    err = make_map<D>(&qq, q, st, batch, n_q_heads, seq_q, QC::kM);
  }
  if (err == cudaSuccess) {
    err = make_map<D>(&qk, k, st + 3, batch, n_kv_heads, seq_k, QC::kN);
  }
  if (err == cudaSuccess) {
    err = make_map<D>(&qv, v, st + 6, batch, n_kv_heads, seq_k, QC::kN);
  }
  if (err == cudaSuccess) {
    err = make_map<D>(&qdo, dout, st + 12, batch, n_q_heads, seq_q, QC::kM);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(dkv_tc_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               KC::kSmem);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(dq_tc_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               QC::kSmem);
  }
  if (err != cudaSuccess) {
    return err;
  }
  auto at = [st](int i) {
    return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  };
  const int group = n_q_heads / n_kv_heads;
  const Shape sh{n_q_heads, group, seq_q, seq_k, causal ? seq_k - seq_q : 0,
                 causal, 1.0f / sqrtf(static_cast<float>(D))};
  const float scale_log2 = kLog2e * sh.scale;

  const int64_t n_rows = rows * seq_q;
  const int warps = kThreads / 32;
  delta_kernel<D><<<static_cast<unsigned>((n_rows + warps - 1) / warps),
                    kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), at(3), at(4), delta, ld,
      n_q_heads, seq_q, n_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) {
    return err;
  }
  const dim3 grid_k(static_cast<unsigned>(rows),
                    static_cast<unsigned>((seq_k + KC::kKeys - 1) / KC::kKeys));
  dkv_tc_kernel<D><<<grid_k, kThreads, KC::kSmem, stream>>>(
      kq, kk, kv, kdo, klse, kdlt, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), at(6), at(7), scratch, sh, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) {
    return err;
  }
  if (group > 1) {
    const int64_t n_quads =
        static_cast<int64_t>(batch) * n_kv_heads * seq_k * (D / 4);
    group_sum_kernel<<<static_cast<unsigned>((n_quads + kThreads - 1) / kThreads),
                       kThreads, 0, stream>>>(
        scratch, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), at(6), at(7), n_kv_heads, group,
        seq_k, D, n_quads, rows * seq_k * D);
    err = cudaGetLastError();
    if (err != cudaSuccess) {
      return err;
    }
  }
  const dim3 grid_q(static_cast<unsigned>(rows),
                    static_cast<unsigned>((seq_q + QC::kM - 1) / QC::kM));
  dq_tc_kernel<D><<<grid_q, kThreads, QC::kSmem, stream>>>(
      qq, qk, qv, qdo, lse, delta, ld, static_cast<__nv_bfloat16*>(dq),
      at(5), sh, scale_log2);
  return cudaGetLastError();
}

}  // namespace tc

cudaError_t launch_dim(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, void* dq, void* dk,
                       void* dv, float* lse, float* delta, float* scratch,
                       const int64_t* st, int batch, int n_q_heads,
                       int n_kv_heads, int seq_q, int seq_k, int head_dim,
                       int dtype, int causal, int64_t ld, cudaStream_t stream) {
#define REPRO_FLASH_BWD_CASE(DIM)                                            \
  case DIM:                                                                  \
    return dtype == 0                                                        \
               ? launch<float, DIM>(q, k, v, o, dout, dq, dk, dv, lse,       \
                                    delta, st, batch, n_q_heads, n_kv_heads, \
                                    seq_q, seq_k, causal, stream)            \
               : tc::launch_tc<DIM>(q, k, v, o, dout, dq, dk, dv, lse,       \
                                    delta, ld, scratch, st, batch,           \
                                    n_q_heads, n_kv_heads, seq_q, seq_k,     \
                                    causal, stream);
  switch (head_dim) {
    REPRO_FLASH_BWD_CASE(32)
    REPRO_FLASH_BWD_CASE(64)
    REPRO_FLASH_BWD_CASE(128)
    REPRO_FLASH_BWD_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_BWD_CASE
}

}  // namespace

// q, o, dout, dq (B, Hq, Sq, D); k, v, dk, dv (B, Hkv, Sk, D); device
// pointers.  strides: 24 element strides, (b, h, s) of q, k, v, o, dout,
// dq, dk and dv; the head dim is contiguous.  dtype: 0 float32, 1 bfloat16
// (every tensor but lse, delta and scratch).  causal: 0 or 1 (queries at
// the end of the keys; needs Sq <= Sk).
// float32: lse and delta are scratch of B * Hq * Sq each, written here;
// lse_stride and scratch are not read.
// bfloat16: lse holds the forward kernel's log-sum-exp of each query row,
// the row of (b, h) at lse + (b * Hq + h) * lse_stride; delta is scratch of
// the same layout; lse_stride >= Sq, a multiple of 4, and q, k, v and dout
// need 16-byte aligned bases and (b, h, s) strides (TMA).  scratch: f32 of
// 2 * B * Hq * Sk * D when Hq > Hkv, else unused.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    void* scratch, const int64_t* strides, int batch, int n_q_heads,
    int n_kv_heads, int seq_q, int seq_k, int head_dim, int dtype, int causal,
    int lse_stride, void* stream) {
  if (batch <= 0 || seq_q <= 0 || seq_k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_kv_heads <= 0 || n_q_heads % n_kv_heads != 0 ||
      (causal && seq_q > seq_k) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 1 && (lse_stride < seq_q || lse_stride % 4 != 0 ||
                     (n_q_heads > n_kv_heads && scratch == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_dim(
      q, k, v, o, dout, dq, dk, dv, static_cast<float*>(lse),
      static_cast<float*>(delta), static_cast<float*>(scratch), strides, batch,
      n_q_heads, n_kv_heads, seq_q, seq_k, head_dim, dtype, causal, lse_stride,
      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
