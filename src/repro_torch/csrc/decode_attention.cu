// One query token over a preallocated KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention
// (_decode_kernel).  That kernel ran a (batch*q_heads, kv_blocks) grid with
// the filled length kv_len as a scalar-prefetch argument, skipped kv blocks
// past it, and carried the online-softmax statistics in VMEM scratch across
// the sequential kv steps.  Here the kv axis is a loop inside one thread
// block, and the loop stops at kv_len:
//
//   * one block per (b, kv head), serving up to 8 query heads of that kv
//     head's group at once (a further grid row for each further 8), so each
//     K/V row is read once per group and not once per query head;
//   * each step stages a 64-key K and V tile (converted to f32) in shared
//     memory; scores, the running max / sum and the accumulator are f32;
//   * keys [0, kv_len) are attended (kv_len exclusive, as in the TPU
//     kernel); tiles past kv_len are never loaded;
//   * bf16 or f32, D in {32, 64, 128, 256}, any strides with a unit stride
//     on the head dim.
//
// What bounds it: the bytes of K and V up to kv_len (one query row does 2
// operations per byte read).  With one block per (b, kv head) a small batch
// leaves most of the card's 132 SMs idle, so at batch 1 it is far from the
// memory rate; splitting the keys across blocks (split-K, with a combine
// pass) is later work.
//
// Plain C interface, loaded with ctypes by
// repro_torch/kernels/decode_attention.py; the launch goes on the caller's
// stream and the function returns the CUDA error code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kHeads = 8;  // query heads per block (one warp each in softmax)
constexpr int kBlockK = 64;
constexpr float kNegInf = -1e30f;

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

// Element strides of a (B, H, S, D) tensor; the D stride is 1.
struct Strides {
  int64_t b, h, s;
};

// Copy rows [row0, row0 + kRows) of a (rows x D) slab, row stride `stride`,
// into shared memory (row pitch kPitch) as f32; rows >= n_rows read as 0.
// The loads of a chunk go to registers first, so up to 16 of them are in
// flight per thread instead of one load waiting on the next store.
template <typename T, int D, int kRows, int kPitch>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          int64_t stride, int row0,
                                          int n_rows, float* dst) {
  constexpr int kLoads = kRows * D / kThreads;
  constexpr int kChunk = kLoads < 16 ? kLoads : 16;
  static_assert(kLoads % kChunk == 0, "tile does not split into chunks");
#pragma unroll
  for (int c = 0; c < kLoads; c += kChunk) {
    float reg[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int i = threadIdx.x + (c + j) * kThreads;
      const int row = row0 + i / D;
      reg[j] = row < n_rows
                   ? to_float(src[static_cast<int64_t>(row) * stride + i % D])
                   : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int i = threadIdx.x + (c + j) * kThreads;
      dst[(i / D) * kPitch + i % D] = reg[j];
    }
  }
}

template <int D>
constexpr int smem_floats() {
  return kHeads * D              // queries
         + kBlockK * (D + 4)     // k tile
         + kBlockK * D           // v tile
         + kHeads * kBlockK      // scores / probabilities
         + 3 * kHeads;           // running max, running sum, rescale
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, Strides qs,
                  Strides ks, Strides vs, Strides os, int n_kv_heads,
                  int group, int kv_len, float scale) {
  constexpr int kPitch = D + 4;
  constexpr int kPer = kHeads * D / kThreads;  // accumulator entries a thread
  constexpr int kHeadStep = kThreads / D > 0 ? kThreads / D : 1;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* q_s = smem;
  float* k_s = q_s + kHeads * D;
  float* v_s = k_s + kBlockK * kPitch;
  float* p_s = v_s + kBlockK * D;
  float* m_s = p_s + kHeads * kBlockK;
  float* l_s = m_s + kHeads;
  float* a_s = l_s + kHeads;

  const int b = blockIdx.x / n_kv_heads;
  const int hk = blockIdx.x % n_kv_heads;
  const int g0 = blockIdx.y * kHeads;
  const int n_g = min(kHeads, group - g0);
  const int h0 = hk * group + g0;  // first query head of this block
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // the block's query heads are rows of stride qs.h (the query's one row)
  load_tile<T, D, kHeads, D>(q + b * qs.b + h0 * qs.h, qs.h, 0, n_g, q_s);
  if (tid < kHeads) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // accumulator entries: column d = tid % D of heads tid / D + i * kHeadStep
  const int d_acc = tid % D;
  const int g_acc = tid / D;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    acc[i] = 0.f;
  }

  // scores: key c = tid % 64 against heads g_sc and g_sc + 4
  const int c_sc = tid % kBlockK;
  const int g_sc = tid / kBlockK;

  for (int k0 = 0; k0 < kv_len; k0 += kBlockK) {
    __syncthreads();  // the previous step is done with k_s, v_s and p_s
    load_tile<T, D, kBlockK, kPitch>(kp, ks.s, k0, kv_len, k_s);
    load_tile<T, D, kBlockK, D>(vp, vs.s, k0, kv_len, v_s);
    __syncthreads();

    float s0 = 0.f;
    float s1 = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(&k_s[c_sc * kPitch + d]);
      const float4 qa = *reinterpret_cast<const float4*>(&q_s[g_sc * D + d]);
      const float4 qb =
          *reinterpret_cast<const float4*>(&q_s[(g_sc + 4) * D + d]);
      s0 = fmaf(qa.x, kv.x, s0);
      s0 = fmaf(qa.y, kv.y, s0);
      s0 = fmaf(qa.z, kv.z, s0);
      s0 = fmaf(qa.w, kv.w, s0);
      s1 = fmaf(qb.x, kv.x, s1);
      s1 = fmaf(qb.y, kv.y, s1);
      s1 = fmaf(qb.z, kv.z, s1);
      s1 = fmaf(qb.w, kv.w, s1);
    }
    const bool live = k0 + c_sc < kv_len;
    p_s[g_sc * kBlockK + c_sc] = live ? s0 * scale : kNegInf;
    p_s[(g_sc + 4) * kBlockK + c_sc] = live ? s1 * scale : kNegInf;
    __syncthreads();

    // online softmax: warp g owns head g; each lane two keys of the tile
    {
      const int g = warp;
      const float x0 = p_s[g * kBlockK + lane];
      const float x1 = p_s[g * kBlockK + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_prev = m_s[g];
      const float m_cur = fmaxf(m_prev, mx);
      const float p0 = expf(x0 - m_cur);
      const float p1 = expf(x1 - m_cur);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      p_s[g * kBlockK + lane] = p0;
      p_s[g * kBlockK + lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_cur;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int g = g_acc + i * kHeadStep;
      float a = acc[i] * a_s[g];
#pragma unroll 8
      for (int c = 0; c < kBlockK; ++c) {
        a = fmaf(p_s[g * kBlockK + c], v_s[c * D + d_acc], a);
      }
      acc[i] = a;
    }
  }

  // l_s was last written before the barrier that precedes the P V step
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int g = g_acc + i * kHeadStep;
    if (g < n_g) {
      const float denom = fmaxf(l_s[g], 1e-30f);
      out[b * os.b + (h0 + g) * os.h + d_acc] = from_float<T>(acc[i] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const int64_t* st, int batch, int n_q_heads,
                   int n_kv_heads, int kv_len, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    return err;
  }
  const int group = n_q_heads / n_kv_heads;
  const dim3 grid(static_cast<unsigned>(batch * n_kv_heads),
                  static_cast<unsigned>((group + kHeads - 1) / kHeads));
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  decode_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      n_kv_heads, group, kv_len, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const void* q, const void* k, const void* v, void* out,
                       const int64_t* st, int batch, int n_q_heads,
                       int n_kv_heads, int kv_len, int head_dim,
                       cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, out, st, batch, n_q_heads, n_kv_heads,
                           kv_len, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, st, batch, n_q_heads, n_kv_heads,
                           kv_len, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, st, batch, n_q_heads, n_kv_heads,
                            kv_len, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, st, batch, n_q_heads, n_kv_heads,
                            kv_len, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, 1, D), k / v (B, Hkv, S, D), out (B, Hq, 1, D); device
// pointers.  strides: 12 element strides, (b, h, s) of q, k, v and out; the
// head dim is contiguous.  dtype: 0 float32, 1 bfloat16.  Keys [0, kv_len)
// are attended; 1 <= kv_len <= S.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, void* out,
                                      const int64_t* strides, int batch,
                                      int n_q_heads, int n_kv_heads,
                                      int kv_len, int head_dim, int dtype,
                                      void* stream) {
  if (batch <= 0) {
    return 0;
  }
  if (kv_len <= 0 || n_kv_heads <= 0 || n_q_heads % n_kv_heads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dim<float>(q, k, v, out, strides, batch, n_q_heads,
                               n_kv_heads, kv_len, head_dim, st);
    case 1:
      return launch_dim<__nv_bfloat16>(q, k, v, out, strides, batch,
                                       n_q_heads, n_kv_heads, kv_len,
                                       head_dim, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
