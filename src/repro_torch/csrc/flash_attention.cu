// Blocked attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel).  That kernel ran a (batch*q_heads, q_blocks, kv_blocks)
// grid with the kv axis innermost and kept the running row max, row sum and
// f32 accumulator in VMEM scratch from one kv step to the next.  Hopper runs
// blocks in parallel and in no order, so here the kv axis is a loop inside
// one thread block.  The kernel is dispatched by dtype:
//
// bf16 (the serving dtype): tensor cores and TMA.
//   * one block per (b * Hq + h, 128-row query block), two warpgroups of
//     128 threads, each owning 64 query rows (wgmma takes M = 64); query
//     blocks run longest first, so the causal tail does not idle SMs;
//   * the query tile is loaded once by TMA; K and V tiles (128 keys for
//     D <= 128, 64 for D = 256) go through a ring of two stages, each with
//     its own mbarrier for K and for V, so the copies of tile j + 1 are in
//     flight while tile j's products run.  Thread 0 issues every copy;
//     a stage is reused once both warpgroups have released it (an "empty"
//     mbarrier with two arrivals).  A 4-D tensor map (D, S, H, B) per
//     tensor, built on the host for each call from the tensor's strides,
//     takes any layout with a unit head-dim stride and 16-byte aligned
//     strides and base (the bsd,dhk->bhsk einsum views included);
//   * S = Q K^T is wgmma m64nNk16 with both operands in shared memory
//     (K-major, 128-byte swizzle, 64-byte for D = 32, matching the TMA
//     box); the f32 scores get the scale, the masks and the online softmax
//     in registers; P is split into two bf16 parts, hi = bf16(P) and
//     lo = bf16(P - hi), in the register layout of wgmma's A operand (for
//     16-bit types the accumulator and A fragments line up), and
//     O += P V is two wgmma products, hi V and lo V, with A from registers
//     and V (MN-major, the descriptor's transpose bit) from shared memory.
//     The running max, the running sum (over the f32 probabilities) and O
//     stay in f32 registers; the finish is O / max(l, 1e-30);
//   * only tiles that cross the causal diagonal or the end of the keys are
//     masked (-1e30); tiles wholly above the diagonal are never loaded.
//     TMA fills rows past the end of a tensor with zeros, which score 0,
//     so keys >= Sk are masked all the same.
//   * Precision: P enters P V with about 16 significant bits (hi + lo),
//     where the TPU kernel kept it in f32.  A single bf16 P, as fast flash
//     kernels and the JAX model's own sdpa use, broke the reduced olmo-1b's
//     end-to-end rule against the plain version on the card (chip_smoke.py
//     phase 8: max error 0.526, allowed 0.073), so P V costs two products.
//
// f32: a SIMT kernel, the products on the CUDA cores in f32 (f32 is no
// serving dtype, and its 2e-5 tolerance rules out bf16 or TF32 products).
// 64-row query blocks, 32-key tiles in shared memory, any strides with a
// unit head-dim stride.
//
// Both: the kv head is h / (Hq / Hkv), so repeated K/V are never
// materialised; queries sit at the end of the keys (kv_offset = Sk - Sq
// when causal); any Sq and Sk; D in {32, 64, 128, 256}.  Given an lse
// pointer (the training path's forward), each also writes every query
// row's natural log-sum-exp, lse = m + log l (the bf16 kernel keeps m in
// log2 units and converts), which the backward kernel reads instead of
// recomputing it; the output's bits do not depend on it.
//
// What bounds it: at the models' prefill shapes the bf16 work is balanced
// between the bytes of Q, K, V and O and the tensor cores' operations
// (e.g. olmo-1b: 17.2 GFLOP against 67 MB), so the products have to run on
// the tensor cores and the loads have to overlap them.  Warp
// specialisation, register reallocation, persistent blocks and ping-pong
// scheduling of the two warpgroups are later work.
//
// Plain C interface, loaded with ctypes by
// repro_torch/kernels/flash_attention.py; the launch goes on the caller's
// stream and the function returns the CUDA error code (0 on success).
// Linked with -lcuda for cuTensorMapEncodeTiled.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32: the SIMT kernel (products on the CUDA cores in f32)
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;

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

// kLse: also write each row's log-sum-exp (a separate instantiation, so
// the serving path's code is what it was without it)
template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, Strides qs, Strides ks, Strides vs,
                 Strides os, int n_q_heads, int group, int seq_q, int seq_k,
                 int kv_offset, int causal, float scale) {
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
  const float* qp = q + b * qs.b + h * qs.h;
  const float* kp = k + b * ks.b + hk * ks.h;
  const float* vp = v + b * vs.b + hk * vs.h;
  float* op = out + b * os.b + h * os.h;

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
        qi < seq_q ? qp[static_cast<int64_t>(qi) * qs.s + d] : 0.f;
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
        kv = kp[static_cast<int64_t>(kj) * ks.s + d];
        vv = vp[static_cast<int64_t>(kj) * vs.s + d];
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
        op[static_cast<int64_t>(qi) * os.s + tx + 16 * j] = acc[i][j] / denom;
      }
      if constexpr (kLse) {
        if (tx == 0) {
          lse[static_cast<int64_t>(bh) * seq_q + qi] = m_s[r] + logf(l_s[r]);
        }
      }
    }
  }
}

template <int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        void* out, float* lse, const int64_t* st, int batch,
                        int n_q_heads, int n_kv_heads, int seq_q, int seq_k,
                        int causal, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kernel = lse != nullptr ? flash_kernel<D, true> : flash_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    return err;
  }
  const dim3 grid(static_cast<unsigned>(batch * n_q_heads),
                  static_cast<unsigned>((seq_q + kBlockQ - 1) / kBlockQ));
  const int kv_offset = causal ? seq_k - seq_q : 0;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      n_q_heads, n_q_heads / n_kv_heads, seq_q, seq_k, kv_offset, causal,
      scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma on tiles that TMA brings into a ring of two stages
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kStages = 2;

template <int D>
struct Tile {
  static constexpr int kM = 128;                    // query rows a block
  static constexpr int kN = D <= 128 ? 128 : 64;    // keys a tile
  static constexpr int kPanel = D >= 64 ? 64 : 32;  // elements a swizzle row
  static constexpr int kRowBytes = kPanel * 2;      // 128 or 64
  static constexpr int kPanels = D / kPanel;
  static constexpr int kQBytes = kM * D * 2;
  static constexpr int kKVBytes = kN * D * 2;
  // the swizzle atom is 8 rows; 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  static constexpr int kBarBytes = 64;
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's atom
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + kBarBytes;
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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

// kLse as in flash_kernel
template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse, Strides os, int n_q_heads,
                    int group, int seq_q, int seq_k, int kv_offset,
                    int causal, float scale_log2) {
  using C = Tile<D>;
  constexpr int kN = C::kN;
  constexpr int kStepsPerRow = C::kPanel / 16;  // k16 steps in a swizzle row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;
  const uint32_t k_s = q_s + C::kQBytes;  // + stage * kKVBytes
  const uint32_t v_s = k_s + kStages * C::kKVBytes;
  const uint32_t bars = v_s + kStages * C::kKVBytes;
  // bars: q, k_full[2], v_full[2], empty[2]
  const uint32_t bar_q = bars;
  auto bar_k = [&](int s) { return bars + 8 * (1 + s); };
  auto bar_v = [&](int s) { return bars + 8 * (3 + s); };
  auto bar_empty = [&](int s) { return bars + 8 * (5 + s); };

  const int bh = blockIdx.x;
  const int b = bh / n_q_heads;
  const int h = bh % n_q_heads;
  const int hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kM;  // longest first
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;

  int n_tiles = (seq_k + kN - 1) / kN;
  if (causal) {
    const int last_q = min(q0 + C::kM, seq_q) - 1 + kv_offset;
    n_tiles = min(n_tiles, last_q / kN + 1);
  }

  auto load_kv = [&](int j, int s) {
    mbar_expect_tx(bar_k(s), C::kKVBytes);
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p) {
      tma_load(k_s + s * C::kKVBytes + p * kN * C::kRowBytes, &map_k,
               bar_k(s), p * C::kPanel, j * kN, hk, b);
    }
    mbar_expect_tx(bar_v(s), C::kKVBytes);
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p) {
      tma_load(v_s + s * C::kKVBytes + p * kN * C::kRowBytes, &map_v,
               bar_v(s), p * C::kPanel, j * kN, hk, b);
    }
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      mbar_init(bar_empty(s), 2);  // one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, C::kQBytes);
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p) {
      tma_load(q_s + p * C::kM * C::kRowBytes, &map_q, bar_q, p * C::kPanel,
               q0, h, b);
    }
    load_kv(0, 0);
  }

  // this thread's rows (of its warpgroup's 64) and columns in the
  // accumulator layout of m64nNk16: rows r and r + 8, columns
  // 8 j + 2 (lane % 4) + {0, 1}
  const int row0 = 16 * warp + lane / 4;
  const int qpos0 = q0 + 64 * wg + row0 + kv_offset;
  const int col0 = 2 * (lane % 4);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    o[i] = 0.f;
  }
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  // descriptors: Q rows of this warpgroup, K and V of a stage
  const uint32_t sbo = 8 * C::kRowBytes;  // next 8-row group
  const uint32_t q_wg = q_s + 64 * wg * C::kRowBytes;

  mbar_wait(bar_q, 0);
  __syncwarp();
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j & 1;
    const uint32_t parity = (j >> 1) & 1;
    if (tid == 0 && j + 1 < n_tiles) {
      if (j >= 1) {
        // tile j - 1 used the other stage; both warpgroups must be done
        mbar_wait(bar_empty(s ^ 1), ((j - 1) >> 1) & 1);
      }
      load_kv(j + 1, s ^ 1);
    }
    __syncwarp();  // wgmma's .aligned instructions need the warp converged
    const int k0 = j * kN;

    // S = Q K^T
    float sc[kN / 2];
    mbar_wait(bar_k(s), parity);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / kStepsPerRow;
      const uint32_t off = (kk % kStepsPerRow) * 32;
      const uint64_t da = make_desc(q_wg + p * C::kM * C::kRowBytes + off,
                                    16, sbo, C::kLayout);
      const uint64_t db =
          make_desc(k_s + s * C::kKVBytes + p * kN * C::kRowBytes + off, 16,
                    sbo, C::kLayout);
      wgmma_ss<kN>(sc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scale, mask, online softmax (base 2)
    const bool masked =
        k0 + kN > seq_k ||
        (causal && k0 + kN - 1 > q0 + 64 * wg + kv_offset);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      float x = sc[i] * scale_log2;
      if (masked) {
        const int kpos = k0 + 8 * (i / 4) + col0 + (i & 1);
        const int qpos = qpos0 + ((i & 2) ? 8 : 0);
        if (kpos >= seq_k || (causal && kpos > qpos)) {
          x = kNegInf;
        }
      }
      sc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
    // P = hi + lo, two bf16 parts: a single bf16 P (8 significant bits)
    // breaks the models' end-to-end rule, hi + lo keeps about 16
    uint32_t p_hi[kN / 16][4];
    uint32_t p_lo[kN / 16][4];
#pragma unroll
    for (int i = 0; i < kN / 2; i += 2) {
      const int r = (i >> 1) & 1;
      const float p0 = exp2f(sc[i] - m_run[r]);
      const float p1 = exp2f(sc[i + 1] - m_run[r]);
      l_run[r] += p0 + p1;
      // accumulator registers 8 kk + {0..7} are A's four registers of the
      // kk-th k16 step: (r, c), (r + 8, c), (r, c + 8), (r + 8, c + 8)
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      p_hi[i / 8][(i % 8) / 2] = *reinterpret_cast<const uint32_t*>(&hi);
      p_lo[i / 8][(i % 8) / 2] = pack_bf16(p0 - hf.x, p1 - hf.y);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      o[i] *= alpha[(i >> 1) & 1];
    }

    // O += P V
    mbar_wait(bar_v(s), parity);
    __syncwarp();
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      const uint64_t db =
          make_desc(v_s + s * C::kKVBytes + kk * 16 * C::kRowBytes,
                    kN * C::kRowBytes, sbo, C::kLayout);
      wgmma_rs<D>(o, p_hi[kk], db, 1);
      wgmma_rs<D>(o, p_lo[kk], db, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    if (tid % 128 == 0) {
      mbar_arrive(bar_empty(s));
    }
  }

  // finish: the row sums over the quad that shares a row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    if constexpr (kLse) {
      // the natural log-sum-exp of the row: m is in log2 units
      const int qi = q0 + 64 * wg + row0 + 8 * r;
      if (lane % 4 == 0 && qi < seq_q) {
        lse[static_cast<int64_t>(bh) * seq_q + qi] =
            m_run[r] * 0.6931471805599453f + logf(l_run[r]);
      }
    }
    l_run[r] = 1.f / fmaxf(l_run[r], 1e-30f);
  }
  __nv_bfloat16* op = out + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + 64 * wg + row0 + 8 * r;
    if (qi < seq_q) {
      __nv_bfloat16* row = op + static_cast<int64_t>(qi) * os.s;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + col0) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * l_run[r],
                                  o[4 * j + 2 * r + 1] * l_run[r]);
      }
    }
  }
}

// The tensor map of a (B, H, S, D) bf16 tensor with element strides
// st = (b, h, s) and a unit D stride, read in boxes of `rows` x kPanel.
template <int D>
cudaError_t make_map(CUtensorMap* map, const void* ptr, const int64_t* st,
                     int batch, int heads, int seq, int rows) {
  using C = Tile<D>;
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
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(C::kPanel),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      C::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      float* lse, const int64_t* st, int batch, int n_q_heads,
                      int n_kv_heads, int seq_q, int seq_k, int causal,
                      cudaStream_t stream) {
  using C = Tile<D>;
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err =
      make_map<D>(&map_q, q, st, batch, n_q_heads, seq_q, C::kM);
  if (err == cudaSuccess) {
    err = make_map<D>(&map_k, k, st + 3, batch, n_kv_heads, seq_k, C::kN);
  }
  if (err == cudaSuccess) {
    err = make_map<D>(&map_v, v, st + 6, batch, n_kv_heads, seq_k, C::kN);
  }
  auto kernel =
      lse != nullptr ? flash_tc_kernel<D, true> : flash_tc_kernel<D, false>;
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem);
  }
  if (err != cudaSuccess) {
    return err;
  }
  const dim3 grid(static_cast<unsigned>(batch * n_q_heads),
                  static_cast<unsigned>((seq_q + C::kM - 1) / C::kM));
  const int kv_offset = causal ? seq_k - seq_q : 0;
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(out), lse,
      Strides{st[9], st[10], st[11]}, n_q_heads, n_q_heads / n_kv_heads,
      seq_q, seq_k, kv_offset, causal, scale_log2);
  return cudaGetLastError();
}

}  // namespace tc

cudaError_t launch_dim(const void* q, const void* k, const void* v, void* out,
                       float* lse, const int64_t* st, int batch, int n_q_heads,
                       int n_kv_heads, int seq_q, int seq_k, int head_dim,
                       int dtype, int causal, cudaStream_t stream) {
#define REPRO_FLASH_CASE(DIM)                                               \
  case DIM:                                                                 \
    return dtype == 0                                                       \
               ? launch_simt<DIM>(q, k, v, out, lse, st, batch, n_q_heads,  \
                                  n_kv_heads, seq_q, seq_k, causal,         \
                                  stream)                                   \
               : tc::launch_tc<DIM>(q, k, v, out, lse, st, batch,           \
                                    n_q_heads, n_kv_heads, seq_q, seq_k,    \
                                    causal, stream);
  switch (head_dim) {
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(128)
    REPRO_FLASH_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_CASE
}

}  // namespace

// q (B, Hq, Sq, D), k / v (B, Hkv, Sk, D), out (B, Hq, Sq, D); device
// pointers.  lse: null, or f32 (B, Hq, Sq) contiguous, where each query
// row's natural log-sum-exp of its scaled, masked scores is written (the
// backward kernel's input; the output is the same bits either way).
// strides: 12 element strides, (b, h, s) of q, k, v and out; the head dim
// is contiguous.  dtype: 0 float32 (SIMT kernel), 1 bfloat16
// (tensor-core kernel: q, k, v need 16-byte aligned bases and strides).
// causal: 0 or 1 (queries at the end of the keys; needs Sq <= Sk).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     const int64_t* strides, int batch,
                                     int n_q_heads, int n_kv_heads, int seq_q,
                                     int seq_k, int head_dim, int dtype,
                                     int causal, void* stream) {
  if (batch <= 0 || seq_q <= 0) {
    return 0;
  }
  if (seq_k <= 0 || n_kv_heads <= 0 || n_q_heads % n_kv_heads != 0 ||
      (causal && seq_q > seq_k) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_dim(q, k, v, out, static_cast<float*>(lse),
                                     strides, batch, n_q_heads,
                                     n_kv_heads, seq_q, seq_k, head_dim,
                                     dtype, causal,
                                     static_cast<cudaStream_t>(stream)));
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
