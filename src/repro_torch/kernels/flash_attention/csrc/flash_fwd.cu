// Flash-attention forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel_call
//   (body _kernel, pl.pallas_call at kernel.py:124).
//
// Computes GQA attention in the model's layout: q [B, Sq, Hq, hd] against
// k/v [B, Skv, Hkv, hd]; query head h reads KV head h / (Hq / Hkv).  Query
// row i sits at absolute position q_offset + i, key j at position j.  A pair
// is kept iff j < Skv, (causal) j <= q_offset + i and (window) j > q_offset
// + i - window.  Online softmax in f32 with scale hd^-0.5; the output has
// q's dtype and layout.
//
// What bounds it on an H100: at prefill sizes (Sq = Skv = 512, 8 heads,
// hd = 256) both sides are close: ~1.1 GFLOP of kept pairs (causal half)
// over the 989 TFLOP/s bf16 peak is ~1.1 us, and q + k + v + out are a few
// MB, ~1.3 us at 3.35 TB/s.  This kernel does its products on the f32 CUDA
// cores (no tensor cores), so it is bound by shared-memory reads and FMAs,
// far above either.
//
// Design (simple first):
//   * one CTA per (64-row query tile, query head, batch row), 256 threads;
//     the Q tile is staged once in shared memory as f32 (pre-scaled);
//   * the KV loop is bounded by the tile's causal and window limits, so a
//     fully masked KV tile is never loaded (the TPU kernel skips its math
//     but still issues its DMA, kernel.py:15-19);
//   * K and V tiles of 32 keys are staged in shared memory as f32, rows
//     padded by one word so neither the row-varying score reads nor the
//     column-varying P.V reads collide in a bank;
//   * each thread owns two query rows (ty, ty + 32) and a strided eighth of
//     the keys (scores) and of the head dimension (accumulator: 2 x hd/8
//     f32 registers); warp w runs the online softmax of rows 8w..8w+7 with
//     one key per lane (shuffle max and sum, fixed order);
//   * ragged Sq and Skv (wave prompts of 97 or 333 tokens tile nothing) are
//     masked inside the kernel: rows past Sq are computed but not stored,
//     keys past Skv are loaded as zeros and masked.
// A masked score contributes exactly 0 (the reference's exp(-1e30 - m)).
// Rows with no kept key write zeros.  What this leaves on the table: tensor
// cores (mma.sync / wgmma on bf16 tiles), cp.async / TMA double buffering of
// the K/V tiles, and the imbalance of causal tiles (the last query tile
// walks every KV tile).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 32;        // keys per KV tile (one per lane in the softmax)
constexpr int kThreads = 256;  // 8 warps
constexpr size_t kMaxSmem = 232448;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(kBQ) * (HD + 1) + 2 * size_t(kBK) * (HD + 1) + kBQ * (kBK + 1) + 3 * kBQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int Sq, int Skv, int Hq, int Hkv, int causal, int window,
                 int q_offset, float scale) {
  constexpr int LD = HD + 1;         // padded f32 row of a Q / K / V tile
  constexpr int LP = kBK + 1;        // padded row of the score tile
  constexpr int NC = HD / 8;         // accumulator columns per thread
  const int qt = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;   // ty: 0..31
  const int warp = tid >> 5, lane = tid & 31;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // [kBQ][LD]
  float* k_s = q_s + kBQ * LD;       // [kBK][LD]
  float* v_s = k_s + kBK * LD;       // [kBK][LD]
  float* p_s = v_s + kBK * LD;       // [kBQ][LP] scores, then probabilities
  float* m_s = p_s + kBQ * LP;       // [kBQ] running max
  float* l_s = m_s + kBQ;            // [kBQ] running denominator
  float* c_s = l_s + kBQ;            // [kBQ] this tile's rescale

  const int q0 = qt * kBQ;
  const long long q_row = (long long)Hq * HD;     // sequence stride of q / out
  const long long kv_row = (long long)Hkv * HD;   // sequence stride of k / v
  const T* qb = q + (long long)b * Sq * q_row + (long long)hq * HD;
  const T* kb = k + (long long)b * Skv * kv_row + (long long)hk * HD;
  const T* vb = v + (long long)b * Skv * kv_row + (long long)hk * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    q_s[r * LD + d] = q0 + r < Sq ? to_f32(qb[(q0 + r) * q_row + d]) * scale : 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // the keys any row of this tile can keep
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + kBQ, Sq) - 1;
  int k_end = Skv;
  if (causal) k_end = min(k_end, q_hi + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_lo - window + 1);
  k_begin = (k_begin / kBK) * kBK;

  float acc[2][NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[0][j] = acc[1][j] = 0.f;
  __syncthreads();

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i - r * HD;
      const bool in = k0 + r < Skv;
      k_s[r * LD + d] = in ? to_f32(kb[(k0 + r) * kv_row + d]) : 0.f;
      v_s[r * LD + d] = in ? to_f32(vb[(k0 + r) * kv_row + d]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty, ty+32 against keys tx + 8j
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[0][j] = s[1][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float a0 = q_s[ty * LD + d], a1 = q_s[(ty + 32) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kk = k_s[(tx + 8 * j) * LD + d];
        s[0][j] += a0 * kk;
        s[1][j] += a1 * kk;
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = ty + 32 * rr;
      const int qp = q_offset + q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 8 * j;
        const int kp = k0 + c;
        bool keep = kp < Skv && q0 + r < Sq;
        if (causal) keep = keep && kp <= qp;
        if (window > 0) keep = keep && kp > qp - window;
        p_s[r * LP + c] = keep ? s[rr][j] : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 8w..8w+7, lane = key
#pragma unroll
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      const float sv = p_s[r * LP + lane];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(sv));
      const float p = sv == kNegInf ? 0.f : expf(sv - m_new);
      const float sum = warp_sum(p);
      p_s[r * LP + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P . V
    const float c0 = c_s[ty], c1 = c_s[ty + 32];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      acc[0][j] *= c0;
      acc[1][j] *= c1;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float p0 = p_s[ty * LP + c], p1 = p_s[(ty + 32) * LP + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float vv = v_s[c * LD + tx + 8 * j];
        acc[0][j] += p0 * vv;
        acc[1][j] += p1 * vv;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = ty + 32 * rr;
    if (q0 + r >= Sq) continue;
    const float den = fmaxf(l_s[r], 1e-30f);
    T* o = out + ((long long)b * Sq + q0 + r) * q_row + (long long)hq * HD;
#pragma unroll
    for (int j = 0; j < NC; ++j) o[tx + 8 * j] = from_f32<T>(acc[rr][j] / den);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                   int Skv, int Hq, int Hkv, int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static_assert(smem <= kMaxSmem, "tiles do not fit in shared memory");
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Skv, Hq, Hkv, causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, void* out, int B,
                        int Sq, int Skv, int Hq, int Hkv, int causal, int window, int q_offset,
                        float scale, cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window, q_offset, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window, q_offset, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window, q_offset, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window, q_offset, scale,
                            s);
    case 256:
      return launch<T, 256>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window, q_offset, scale,
                            s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  hd in {16, 32, 64, 128,
// 256}.  q/out [B, Sq, Hq, hd], k/v [B, Skv, Hkv, hd], all contiguous.
// causal: 0 or 1; window <= 0: no window.  Returns the launch's cudaError_t
// (0 on success); launches on `stream` and does not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int dtype, int B, int Sq, int Skv, int Hq, int Hkv, int hd,
                                   int causal, int window, int q_offset, float scale,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Skv < 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || B > 65535 ||
      Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch_hd<float>(hd, q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window,
                                     q_offset, scale, s);
    case 1:
      return (int)dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, Sq, Skv, Hq, Hkv, causal,
                                             window, q_offset, scale, s);
    case 2:
      return (int)dispatch_hd<__half>(hd, q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window,
                                      q_offset, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
