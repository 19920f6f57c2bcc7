// One query token over a preallocated KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention
// (_decode_kernel).  That kernel ran a (batch*q_heads, kv_blocks) grid with
// the filled length kv_len as a scalar-prefetch argument, skipped kv blocks
// past it, and carried the online-softmax statistics in VMEM scratch across
// the sequential kv steps.  Hopper runs blocks in parallel and in no order,
// so here the keys [0, kv_len) are split across blocks (split-K) and a
// second pass combines the splits:
//
//   * kernel 1 (partials): one block per (b, kv head, group of up to 8 query
//     heads of that kv head, split of the keys), so each K/V row is read
//     once per group; the split plan (kernels/decode_attention.py::
//     split_plan) fills one wave of the blocks the card holds at once, as
//     repro_decode_blocks_per_sm reports them, even at batch 1;
//   * each block walks its key range in 64-key tiles (32 where a row holds
//     more than 256 bytes), staged in their own dtype in shared memory by
//     16-byte cp.async copies, double-buffered, so the copies of tile t + 1
//     are in flight while tile t is computed (two stages leave room for
//     three blocks an SM at bf16 and D <= 128, a third stage for two); keys
//     past the range read as zeros and are masked;
//   * scores: each warp takes 8 keys of a tile (4 for 32-key tiles) and its
//     lanes split the head dim into slices, summed with shuffles, so all
//     eight warps work whatever the group size (MHA has one head a block);
//   * scores, the running max / sum and the accumulator are f32; a block
//     writes its (m, l, acc[D]) to f32 scratch, or, when the plan has one
//     split, the finished row acc / max(l, 1e-30) to the output;
//   * kernel 2 (combine, launched only for more than one split): one block
//     per (b, q head) takes the max of the splits' m, rescales their l and
//     acc by exp(m_s - m) and writes sum(acc) / max(sum(l), 1e-30) in q's
//     dtype;
//   * asked for it (lse not null), the kernel that writes a row's output
//     also writes its log-sum-exp m + log(l) in f32: the outputs of several
//     slices of one cache merge by it (each slice's weight is
//     exp(lse_s - max lse));
//   * keys [0, kv_len) are attended (kv_len exclusive, as in the TPU
//     kernel); bf16 or f32; D in {32, 64, 128, 256}; any strides with a unit
//     stride on the head dim and 16-byte aligned K/V bases and strides.
//
// What bounds it: the bytes of K and V up to kv_len (one query row does 2
// operations per byte read for MHA, 14 for a 7-head group), so the CUDA
// cores are enough and the design's work is to read at the memory rate from
// enough SMs at once: split-K for the blocks, 16-byte copies kept in flight
// for the bytes.
//
// Plain C interface, loaded with ctypes by
// repro_torch/kernels/decode_attention.py; the launches go on the caller's
// stream and the function returns the CUDA error code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kHeads = 8;  // query heads per block (one warp each in softmax)
constexpr int kStages = 2;
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

template <typename T, int D>
struct Cfg {
  static constexpr int kBlockK = D * sizeof(T) <= 256 ? 64 : 32;
  static constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte copy
  static constexpr int kPitch = D + kVec;      // row pitch: 16 bytes padding
  static constexpr int kTile = kBlockK * kPitch;  // elements of one tile
  static constexpr int kSmem =
      kStages * 2 * kTile * sizeof(T)                      // K, V a stage
      + (kHeads * D + kHeads * kBlockK + 3 * kHeads) * sizeof(float);
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
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

// Issue the copies of keys [k0, k0 + kBlockK) of one (b, kv head) slab into
// a tile (row pitch kPitch); keys at or past `end` read as zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          int64_t stride, int k0, int end,
                                          T* dst) {
  using C = Cfg<T, D>;
  constexpr int kChunks = C::kBlockK * D / C::kVec;
  constexpr int kPerRow = D / C::kVec;
  static_assert(kChunks % kThreads == 0, "tile does not split over threads");
#pragma unroll
  for (int i = threadIdx.x; i < kChunks; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * C::kVec;
    const bool valid = k0 + r < end;
    const T* s = valid ? src + static_cast<int64_t>(k0 + r) * stride + c : src;
    cp_async16(dst + r * C::kPitch + c, s, valid);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ out,
                          float* __restrict__ part_acc,
                          float* __restrict__ part_ml,
                          float* __restrict__ lse, Strides qs, Strides ks,
                          Strides vs, Strides os, int n_q_heads,
                          int n_kv_heads, int group, int kv_len,
                          int keys_per_split, float scale) {
  using C = Cfg<T, D>;
  constexpr int kBlockK = C::kBlockK;
  constexpr int kPer = kHeads * D / kThreads;  // accumulator entries a thread
  constexpr int kHeadStep = kThreads / D > 0 ? kThreads / D : 1;
  // scores: warp w takes keys [w * kKeys, (w + 1) * kKeys) of a tile; its
  // lanes split the head dim into kParts slices (lane = part * kKeys + key)
  // and sum the slices with shuffles, so every warp works at any group size
  constexpr int kKeys = kBlockK / (kThreads / 32);  // 8 or 4
  constexpr int kParts = 32 / kKeys;                // 4 or 8
  constexpr int kCols = D / kParts;                 // head-dim slice
  static_assert(kCols % C::kVec == 0, "slice is not whole 16-byte copies");
  extern __shared__ float4 smem4[];
  T* kv_s = reinterpret_cast<T*>(smem4);  // [stage][K, V][kBlockK][kPitch]
  float* q_s = reinterpret_cast<float*>(kv_s + kStages * 2 * C::kTile);
  float* p_s = q_s + kHeads * D;
  float* m_s = p_s + kHeads * kBlockK;
  float* l_s = m_s + kHeads;
  float* a_s = l_s + kHeads;

  const int b = blockIdx.x / n_kv_heads;
  const int hk = blockIdx.x % n_kv_heads;
  const int g0 = blockIdx.y * kHeads;
  const int n_g = min(kHeads, group - g0);
  const int h0 = hk * group + g0;  // first query head of this block
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int s0 = split * keys_per_split;
  const int s1 = min(s0 + keys_per_split, kv_len);
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // one copy group per tile, committed even when empty, so that waiting
  // for all but the newest kStages - 1 groups always means tile t is in
  for (int t = 0; t < kStages - 1; ++t) {
    const int k0 = s0 + t * kBlockK;
    if (k0 < s1) {
      T* dst = kv_s + t * 2 * C::kTile;
      load_tile<T, D>(kp, ks.s, k0, s1, dst);
      load_tile<T, D>(vp, vs.s, k0, s1, dst + C::kTile);
    }
    cp_async_commit();
  }

  // the block's query heads, in f32 (zeros for heads past the group)
  for (int i = tid; i < kHeads * D; i += kThreads) {
    const int g = i / D;
    q_s[i] = g < n_g ? to_float(q[b * qs.b + (h0 + g) * qs.h + i % D]) : 0.f;
  }
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

  const int c_sc = warp * kKeys + lane % kKeys;  // this lane's key
  const int d_sc = (lane / kKeys) * kCols;       // and head-dim slice

  int stage = 0;
  for (int k0 = s0; k0 < s1; k0 += kBlockK) {
    __syncthreads();  // the previous step is done with the stage refilled
    const int k_next = k0 + (kStages - 1) * kBlockK;
    if (k_next < s1) {
      T* nxt = kv_s + (stage + kStages - 1) % kStages * 2 * C::kTile;
      load_tile<T, D>(kp, ks.s, k_next, s1, nxt);
      load_tile<T, D>(vp, vs.s, k_next, s1, nxt + C::kTile);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* k_t = kv_s + stage * 2 * C::kTile;
    const T* v_t = k_t + C::kTile;

    {
      float kf[kCols];
      const T* krow = k_t + c_sc * C::kPitch + d_sc;
#pragma unroll
      for (int d = 0; d < kCols; d += C::kVec) {
        const float4 raw = *reinterpret_cast<const float4*>(krow + d);
        const T* kt = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < C::kVec; ++e) {
          kf[d + e] = to_float(kt[e]);
        }
      }
      const bool live = k0 + c_sc < s1;
#pragma unroll
      for (int g = 0; g < kHeads; ++g) {
        if (g < n_g) {  // uniform across the block
          const float4* qr = reinterpret_cast<const float4*>(q_s + g * D + d_sc);
          float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int d = 0; d < kCols; d += 4) {
            const float4 qv = qr[d / 4];
            part[0] = fmaf(qv.x, kf[d], part[0]);
            part[1] = fmaf(qv.y, kf[d + 1], part[1]);
            part[2] = fmaf(qv.z, kf[d + 2], part[2]);
            part[3] = fmaf(qv.w, kf[d + 3], part[3]);
          }
          float sc = (part[0] + part[1]) + (part[2] + part[3]);
#pragma unroll
          for (int off = kKeys; off < 32; off <<= 1) {
            sc += __shfl_xor_sync(0xffffffffu, sc, off);
          }
          if (lane < kKeys) {
            p_s[g * kBlockK + c_sc] = live ? sc * scale : kNegInf;
          }
        }
      }
    }
    __syncthreads();

    // online softmax: warp g owns head g; each lane kBlockK / 32 keys
    if (warp < n_g) {
      const int g = warp;
      float x[kBlockK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < kBlockK / 32; ++i) {
        x[i] = p_s[g * kBlockK + lane + 32 * i];
        mx = fmaxf(mx, x[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_prev = m_s[g];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kBlockK / 32; ++i) {
        const float p = expf(x[i] - m_cur);
        p_s[g * kBlockK + lane + 32 * i] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_cur;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // P V: each V element is read once for all of this thread's heads, and
    // P four keys at a time; a head past the group is skipped (uniform
    // across each warp)
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      acc[i] *= a_s[g_acc + i * kHeadStep];
    }
#pragma unroll 2
    for (int c = 0; c < kBlockK; c += 4) {
      float vv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        vv[e] = to_float(v_t[(c + e) * C::kPitch + d_acc]);
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int g = g_acc + i * kHeadStep;
        if (g < n_g) {
          const float4 p = *reinterpret_cast<const float4*>(p_s + g * kBlockK + c);
          acc[i] = fmaf(p.x, vv[0], acc[i]);
          acc[i] = fmaf(p.y, vv[1], acc[i]);
          acc[i] = fmaf(p.z, vv[2], acc[i]);
          acc[i] = fmaf(p.w, vv[3], acc[i]);
        }
      }
    }
    stage = (stage + 1) % kStages;
  }

  // m_s and l_s were last written before the barrier that precedes P V
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int g = g_acc + i * kHeadStep;
    if (g < n_g) {
      const int h = h0 + g;
      if (n_split == 1) {
        const float denom = fmaxf(l_s[g], 1e-30f);
        out[b * os.b + h * os.h + d_acc] = from_float<T>(acc[i] / denom);
        if (lse != nullptr && d_acc == 0) {
          lse[static_cast<int64_t>(b) * n_q_heads + h] = m_s[g] + logf(l_s[g]);
        }
      } else {
        const int64_t row =
            (static_cast<int64_t>(b) * n_q_heads + h) * n_split + split;
        part_acc[row * D + d_acc] = acc[i];
        if (d_acc == 0) {
          part_ml[row * 2] = m_s[g];
          part_ml[row * 2 + 1] = l_s[g];
        }
      }
    }
  }
}

// One block of D threads per (b, q head): the splits' partials into the
// finished row.
template <typename T, int D>
__global__ void __launch_bounds__(D)
    decode_combine_kernel(const float* __restrict__ part_acc,
                          const float* __restrict__ part_ml,
                          T* __restrict__ out, float* __restrict__ lse,
                          Strides os, int n_q_heads, int n_split) {
  const int bh = blockIdx.x;
  const int b = bh / n_q_heads;
  const int h = bh % n_q_heads;
  const int d = threadIdx.x;
  const float* ml = part_ml + static_cast<int64_t>(bh) * n_split * 2;
  const float* acc = part_acc + static_cast<int64_t>(bh) * n_split * D;
  float m = kNegInf;
  for (int s = 0; s < n_split; ++s) {
    m = fmaxf(m, ml[2 * s]);
  }
  float l = 0.f;
  float o = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(ml[2 * s] - m);
    l = fmaf(ml[2 * s + 1], w, l);
    o = fmaf(acc[s * D + d], w, o);
  }
  out[b * os.b + h * os.h + d] = from_float<T>(o / fmaxf(l, 1e-30f));
  if (lse != nullptr && d == 0) {
    lse[bh] = m + logf(l);
  }
}

template <typename T, int D>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(decode_partial_kernel<T, D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Cfg<T, D>::kSmem);
}

// How many partial-kernel blocks one SM of the current device holds at once.
template <typename T, int D>
cudaError_t blocks_per_sm(int* blocks) {
  cudaError_t err = allow_smem<T, D>();
  if (err != cudaSuccess) {
    return err;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, decode_partial_kernel<T, D>, kThreads, Cfg<T, D>::kSmem);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const int64_t* st, float* part_acc, float* part_ml,
                   float* lse, int batch, int n_q_heads, int n_kv_heads,
                   int kv_len, int n_split, int keys_per_split,
                   cudaStream_t stream) {
  using C = Cfg<T, D>;
  cudaError_t err = allow_smem<T, D>();
  if (err != cudaSuccess) {
    return err;
  }
  const int group = n_q_heads / n_kv_heads;
  const dim3 grid(static_cast<unsigned>(batch * n_kv_heads),
                  static_cast<unsigned>((group + kHeads - 1) / kHeads),
                  static_cast<unsigned>(n_split));
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const Strides os{st[9], st[10], st[11]};
  decode_partial_kernel<T, D><<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), part_acc, part_ml, lse,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, os, n_q_heads, n_kv_heads, group, kv_len,
      keys_per_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) {
    return err;
  }
  decode_combine_kernel<T, D>
      <<<static_cast<unsigned>(batch * n_q_heads), D, 0, stream>>>(
          part_acc, part_ml, static_cast<T*>(out), lse, os, n_q_heads,
          n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const void* q, const void* k, const void* v, void* out,
                       const int64_t* st, float* part_acc, float* part_ml,
                       float* lse, int batch, int n_q_heads, int n_kv_heads,
                       int kv_len, int head_dim, int n_split,
                       int keys_per_split, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, out, st, part_acc, part_ml, lse, batch,
                           n_q_heads, n_kv_heads, kv_len, n_split,
                           keys_per_split, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, st, part_acc, part_ml, lse, batch,
                           n_q_heads, n_kv_heads, kv_len, n_split,
                           keys_per_split, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, st, part_acc, part_ml, lse, batch,
                            n_q_heads, n_kv_heads, kv_len, n_split,
                            keys_per_split, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, st, part_acc, part_ml, lse, batch,
                            n_q_heads, n_kv_heads, kv_len, n_split,
                            keys_per_split, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, 1, D), k / v (B, Hkv, S, D), out (B, Hq, 1, D); device
// pointers.  strides: 12 element strides, (b, h, s) of q, k, v and out; the
// head dim is contiguous, and K/V bases and strides are 16-byte aligned.
// dtype: 0 float32, 1 bfloat16.  Keys [0, kv_len) are attended;
// 1 <= kv_len <= S.  The keys are cut into n_split ranges of keys_per_split
// (the last range may be shorter, none is empty);
// part_acc (B, Hq, n_split, D) and part_ml (B, Hq, n_split, 2) are f32
// scratch, unused when n_split is 1.  lse, (B, Hq) f32 or null, receives
// each row's log-sum-exp.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, void* out,
                                      const int64_t* strides, void* part_acc,
                                      void* part_ml, void* lse, int batch,
                                      int n_q_heads,
                                      int n_kv_heads, int kv_len,
                                      int head_dim, int dtype, int n_split,
                                      int keys_per_split, void* stream) {
  if (batch <= 0) {
    return 0;
  }
  if (kv_len <= 0 || n_kv_heads <= 0 || n_q_heads % n_kv_heads != 0 ||
      n_split <= 0 || keys_per_split <= 0 ||
      static_cast<int64_t>(n_split - 1) * keys_per_split >= kv_len ||
      static_cast<int64_t>(n_split) * keys_per_split < kv_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(part_acc);
  float* ml = static_cast<float*>(part_ml);
  float* ls = static_cast<float*>(lse);
  switch (dtype) {
    case 0:
      return launch_dim<float>(q, k, v, out, strides, acc, ml, ls, batch,
                               n_q_heads, n_kv_heads, kv_len, head_dim,
                               n_split, keys_per_split, st);
    case 1:
      return launch_dim<__nv_bfloat16>(q, k, v, out, strides, acc, ml, ls,
                                       batch,
                                       n_q_heads, n_kv_heads, kv_len,
                                       head_dim, n_split, keys_per_split, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// *blocks: how many blocks of the partial kernel for (head_dim, dtype) one
// SM of the current device holds at once; the split plan fills one wave.
extern "C" int repro_decode_blocks_per_sm(int head_dim, int dtype,
                                          int* blocks) {
#define REPRO_DECODE_CASE(DIM)                                          \
  case DIM:                                                             \
    return static_cast<int>(dtype == 0                                  \
                                ? blocks_per_sm<float, DIM>(blocks)     \
                                : blocks_per_sm<__nv_bfloat16, DIM>(blocks));
  if (dtype != 0 && dtype != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (head_dim) {
    REPRO_DECODE_CASE(32)
    REPRO_DECODE_CASE(64)
    REPRO_DECODE_CASE(128)
    REPRO_DECODE_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_DECODE_CASE
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
