// Blocked attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel).  That kernel ran a (batch*q_heads, q_blocks, kv_blocks)
// grid with the kv axis innermost and kept the running row max, row sum and
// f32 accumulator in VMEM scratch from one kv step to the next.  Hopper runs
// blocks in parallel and in no order, so here the kv axis is a loop inside
// one thread block:
//
//   * one block per (b * Hq + h, 64-row query block); 256 threads;
//   * the query tile stays in shared memory in f32 for the whole loop; each
//     step stages a 32-key K and V tile (converted to f32) in shared memory;
//   * scores, the running max / sum and the output accumulator are f32; the
//     accumulator lives in registers (each thread owns 4 rows x D/16
//     columns); the finish is acc / max(l, 1e-30), as in the TPU kernel;
//   * the kv head is h / (Hq / Hkv): repeated K/V are never materialised;
//   * queries sit at the end of the keys (kv_offset = Sk - Sq when causal),
//     keys past Sk are masked to -1e30, and key tiles wholly above the
//     causal diagonal of the query block are never loaded;
//   * any Sq and Sk (ragged tiles are masked, nothing is padded on the
//     host), any strides with a unit stride on the head dim, bf16 or f32,
//     D in {32, 64, 128, 256}.
//
// What bounds it: the products run on the CUDA cores in f32 (no tensor
// cores yet), so at the model's shapes it is bound by operations, far from
// the card's bf16 tensor-core rate.  Shared-memory reads are vectorised
// (float4, a row pitch of D + 4 floats keeps them free of bank conflicts)
// so the FMA units, not shared memory, set the pace.  wgmma, TMA and warp
// specialisation are later work.
//
// Plain C interface, loaded with ctypes by
// repro_torch/kernels/flash_attention.py; the launch goes on the caller's
// stream and the function returns the CUDA error code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
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

template <int D>
constexpr int smem_floats() {
  return kBlockQ * (D + 4)        // q tile
         + kBlockK * (D + 4)      // k tile
         + kBlockK * D            // v tile
         + kBlockQ * (kBlockK + 1)  // scores / probabilities
         + 3 * kBlockQ;           // running max, running sum, rescale
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, Strides qs,
                 Strides ks, Strides vs, Strides os, int n_q_heads, int group,
                 int seq_q, int seq_k, int kv_offset, int causal,
                 float scale) {
  constexpr int kPitch = D + 4;
  constexpr int kPPitch = kBlockK + 1;
  constexpr int kDPer = D / 16;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* q_s = smem;
  float* k_s = q_s + kBlockQ * kPitch;
  float* v_s = k_s + kBlockK * kPitch;
  float* p_s = v_s + kBlockK * D;
  float* m_s = p_s + kBlockQ * kPPitch;
  float* l_s = m_s + kBlockQ;
  float* a_s = l_s + kBlockQ;

  const int bh = blockIdx.x;
  const int b = bh / n_q_heads;
  const int h = bh % n_q_heads;
  const int hk = h / group;
  const int q0 = blockIdx.y * kBlockQ;
  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;
  T* op = out + b * os.b + h * os.h;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    const int qi = q0 + r;
    q_s[r * kPitch + d] =
        qi < seq_q ? to_float(qp[static_cast<int64_t>(qi) * qs.s + d]) : 0.f;
  }
  if (tid < kBlockQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[4][kDPer];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < kDPer; ++j) {
      acc[i][j] = 0.f;
    }
  }

  int n_kb = (seq_k + kBlockK - 1) / kBlockK;
  if (causal) {
    // the block's last real query row sees keys up to this position
    const int last_q = min(q0 + kBlockQ, seq_q) - 1 + kv_offset;
    n_kb = min(n_kb, last_q / kBlockK + 1);
  }

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();  // the previous step is done with k_s, v_s and p_s
    // plain strided loops: staging these loads through registers (as the
    // decode kernel does) took the D = 128 build from 74 to 226 registers
    // and made it slower at every measured shape
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D;
      const int d = i % D;
      const int kj = k0 + r;
      float kv = 0.f;
      float vv = 0.f;
      if (kj < seq_k) {
        kv = to_float(kp[static_cast<int64_t>(kj) * ks.s + d]);
        vv = to_float(vp[static_cast<int64_t>(kj) * vs.s + d]);
      }
      k_s[r * kPitch + d] = kv;
      v_s[r * D + d] = vv;
    }
    __syncthreads();

    // scores for rows ty + 16 i and keys tx + 16 j
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i][0] = 0.f;
      s[i][1] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4];
      float4 kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(&q_s[(ty + 16 * i) * kPitch + d]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(&k_s[(tx + 16 * j) * kPitch + d]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r + kv_offset;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        float val = s[i][j] * scale;
        if (kpos >= seq_k || (causal && qpos < kpos)) {
          val = kNegInf;
        }
        p_s[r * kPPitch + c] = val;
      }
    }
    __syncthreads();

    // online softmax: each warp owns 8 rows, each lane one key of the tile
    for (int rr = 0; rr < kBlockQ / 8; ++rr) {
      const int r = warp * (kBlockQ / 8) + rr;
      const float x = p_s[r * kPPitch + lane];
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_prev = m_s[r];
      const float m_cur = fmaxf(m_prev, mx);
      const float p = expf(x - m_cur);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      p_s[r * kPPitch + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_cur;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V for rows ty + 16 i and columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kDPer; ++j) {
        acc[i][j] *= alpha;
      }
    }
#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = p_s[(ty + 16 * i) * kPPitch + c];
      }
#pragma unroll
      for (int j = 0; j < kDPer; ++j) {
        const float vv = v_s[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

  // l_s was last written before the barrier that precedes the P V step
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r;
    if (qi < seq_q) {
      const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < kDPer; ++j) {
        op[static_cast<int64_t>(qi) * os.s + tx + 16 * j] =
            from_float<T>(acc[i][j] / denom);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const int64_t* st, int batch, int n_q_heads,
                   int n_kv_heads, int seq_q, int seq_k, int causal,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    return err;
  }
  const dim3 grid(static_cast<unsigned>(batch * n_q_heads),
                  static_cast<unsigned>((seq_q + kBlockQ - 1) / kBlockQ));
  const int kv_offset = causal ? seq_k - seq_q : 0;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      n_q_heads, n_q_heads / n_kv_heads, seq_q, seq_k, kv_offset, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const void* q, const void* k, const void* v, void* out,
                       const int64_t* st, int batch, int n_q_heads,
                       int n_kv_heads, int seq_q, int seq_k, int head_dim,
                       int causal, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, out, st, batch, n_q_heads, n_kv_heads,
                           seq_q, seq_k, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, st, batch, n_q_heads, n_kv_heads,
                           seq_q, seq_k, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, st, batch, n_q_heads, n_kv_heads,
                            seq_q, seq_k, causal, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, st, batch, n_q_heads, n_kv_heads,
                            seq_q, seq_k, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, Sq, D), k / v (B, Hkv, Sk, D), out (B, Hq, Sq, D); device
// pointers.  strides: 12 element strides, (b, h, s) of q, k, v and out; the
// head dim is contiguous.  dtype: 0 float32, 1 bfloat16.  causal: 0 or 1
// (queries at the end of the keys; needs Sq <= Sk).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out,
                                     const int64_t* strides, int batch,
                                     int n_q_heads, int n_kv_heads, int seq_q,
                                     int seq_k, int head_dim, int dtype,
                                     int causal, void* stream) {
  if (batch <= 0 || seq_q <= 0) {
    return 0;
  }
  if (seq_k <= 0 || n_kv_heads <= 0 || n_q_heads % n_kv_heads != 0 ||
      (causal && seq_q > seq_k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dim<float>(q, k, v, out, strides, batch, n_q_heads,
                               n_kv_heads, seq_q, seq_k, head_dim, causal, st);
    case 1:
      return launch_dim<__nv_bfloat16>(q, k, v, out, strides, batch,
                                       n_q_heads, n_kv_heads, seq_q, seq_k,
                                       head_dim, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
