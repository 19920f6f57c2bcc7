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
// 256}; float32 or bfloat16 in, the softmax and every product in float32,
// the gradients written in the input's dtype.  With P = softmax(S),
// dP = dO V^T, Delta_i = sum_d dO_id O_id and dS = P * (dP - Delta):
// dV = P^T dO, dK = dS^T Q / sqrt(D), dQ = dS K / sqrt(D).
//
// Two CUDA kernels a call, neither with atomics, so two calls give equal
// bits:
//   1. dq_kernel, one block per (b * Hq + h, 64-row query tile; 32 at
//      D = 256): first a pass over the key tiles that recomputes each query
//      row's log-sum-exp with an online max (the forward kernel stores
//      none) and Delta from O and dO, both written to scratch for kernel 2;
//      then a second pass that recomputes S and dP a key tile at a time and
//      accumulates dQ in registers.
//   2. dkv_kernel, one block per (b * Hkv + kv head, 64-key tile; 32 at
//      D = 256): K and V stay in shared memory while the block walks every
//      query tile of every query head of its group that can see the keys,
//      recomputes S^T and dP^T, and accumulates dK and dV in f32 registers.
// Tiles are float32 in shared memory (a pitch of D + 4 floats, so the
// float4 reads of 8 neighbouring rows hit distinct banks); each thread of a
// 16 x 16 grid owns a few rows and columns of every product.  Causal blocks
// skip the tiles above the diagonal.
//
// What bounds it: the work is five products of Sq x Sk x D a head (S, dP,
// dV, dK, dQ; half of it when causal) against the bytes of q, k, v, o, dO
// and the three gradients, so on this card it is bound by operations by a
// wide margin.  This first version computes on the CUDA cores in f32 and
// recomputes S three times and dP twice; wgmma products from TMA tiles, as
// the forward kernel has, are the later speed work.
//
// Plain C interface, loaded with ctypes by
// repro_torch/kernels/flash_attention_bwd.py; the launches go on the
// caller's stream and the function returns the CUDA error code (0 on
// success).

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as Tensor.to does
}

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

cudaError_t launch_dim(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, void* dq, void* dk,
                       void* dv, float* lse, float* delta, const int64_t* st,
                       int batch, int n_q_heads, int n_kv_heads, int seq_q,
                       int seq_k, int head_dim, int dtype, int causal,
                       cudaStream_t stream) {
#define REPRO_FLASH_BWD_CASE(DIM)                                            \
  case DIM:                                                                  \
    return dtype == 0                                                        \
               ? launch<float, DIM>(q, k, v, o, dout, dq, dk, dv, lse,       \
                                    delta, st, batch, n_q_heads, n_kv_heads, \
                                    seq_q, seq_k, causal, stream)            \
               : launch<__nv_bfloat16, DIM>(                                 \
                     q, k, v, o, dout, dq, dk, dv, lse, delta, st, batch,    \
                     n_q_heads, n_kv_heads, seq_q, seq_k, causal, stream);
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
// pointers.  lse, delta: float32 scratch of B * Hq * Sq each.  strides: 24
// element strides, (b, h, s) of q, k, v, o, dout, dq, dk and dv; the head
// dim is contiguous.  dtype: 0 float32, 1 bfloat16 (every tensor but the
// scratch).  causal: 0 or 1 (queries at the end of the keys; needs
// Sq <= Sk).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    const int64_t* strides, int batch, int n_q_heads, int n_kv_heads,
    int seq_q, int seq_k, int head_dim, int dtype, int causal, void* stream) {
  if (batch <= 0 || seq_q <= 0 || seq_k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_kv_heads <= 0 || n_q_heads % n_kv_heads != 0 ||
      (causal && seq_q > seq_k) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_dim(
      q, k, v, o, dout, dq, dk, dv, static_cast<float*>(lse),
      static_cast<float*>(delta), strides, batch, n_q_heads, n_kv_heads,
      seq_q, seq_k, head_dim, dtype, causal,
      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
