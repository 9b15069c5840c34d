// Flash-attention backward, hand-written for Hopper (sm_90a).
//
// The gradient of the forward in flash_fwd.cu (kernel B3).  The JAX package
// has no backward kernel: it differentiates src/repro/models/layers.py::
// chunked_attention with XLA's autodiff.  On the card the forward is a
// kernel, so its gradient is one too.
//
// Computes, for GQA attention in the model's layout (q, out, dout
// [B, Sq, Hq, hd]; k, v [B, Skv, Hkv, hd]; query head h reads KV head
// h / G, G = Hq / Hkv), with the forward's mask (key j kept for query i iff
// j < Skv, (causal) j <= q_offset + i and (window) j > q_offset + i -
// window) and scale = hd^-0.5:
//   P[i, j]  = exp(scale q_i . k_j - lse_i)        (0 where masked)
//   D_i      = sum_d dout[i, d] out[i, d]
//   dP[i, j] = dout_i . v_j
//   dS[i, j] = P[i, j] (dP[i, j] - D_i)
//   dq_i = scale sum_j dS[i, j] k_j,  dk_j = scale sum_i dS[i, j] q_i,
//   dv_j = sum_i P[i, j] dout_i
// with lse (f32 [B, Hq, Sq]) the forward's log-sum-exp of each row.  dk and
// dv of a KV head sum over its G query heads.  All math in f32; dq, dk and
// dv are stored in the inputs' dtype.
//
// What bounds it on an H100: at gemma-2b's training shape (B = 4, S = 512,
// 8 / 1 heads of 256, causal) the kept pairs cost ~10 GFLOP (P recomputed,
// dP, dV, dK, dQ: five products over the kept half of the pairs; the
// forward's two are ~4.3), ~10 us at the 989 TFLOP/s bf16 tensor-core
// peak, against ~17 MB of q, k, v, out, dout, lse in and dq, dk, dv out
// (~5 us at 3.35 TB/s).  This first kernel does its products on the f32
// CUDA cores (67 TFLOP/s), reading its operands from shared memory, so it
// sits far from either bound; mma.sync or wgmma for the five products is
// later work.
//
// Three kernels, FlashAttention-2's shape, launched in order on one stream
// by the C entry point:
//   1. flash_bwd_dot: D_i, one warp a row (a lane sum and a warp shuffle).
//   2. flash_bwd_dkdv: one CTA per (16-key tile, KV head, batch row).  K
//      and V of its tile stay in shared memory; it walks the G query heads
//      of its KV head and, for each, the 32-row query tiles that can keep
//      one of its keys (the causal and window limits bound the walk), and
//      recomputes P and dS for the tile.  dK and dV sum in registers over
//      all G heads and all query tiles, inside the CTA: no atomics, so two
//      calls give the same bits.
//   3. flash_bwd_dq: one CTA per (32-row query tile, query head, batch
//      row); Q, dO, lse and D stay in shared memory, and it walks the
//      16-key tiles its rows can keep, recomputing P and dS; dQ sums in
//      registers.
// Both sum each tile's terms apart and then add them to the running sums:
// with one running f32 sum over all of them, the gradients at gemma's
// width (f32, S = 333) came 2.4e-5 from the f32 plain version on an H100,
// over the 2e-5 of the f32 checks.
// Tiles are f32 in shared memory, rows padded by one word so that the 16
// keys a warp reads at one column sit in 16 banks.  Rows past Sq and keys
// past Skv load as zeros and are masked; a masked pair contributes exactly
// 0 to every sum.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                  // 8 warps
constexpr int kBQ = 32;                        // query rows per tile
constexpr int kBK = 16;                        // keys per tile
constexpr int kPer = kBQ * kBK / kThreads;     // score entries per thread (2)
constexpr int kRowStep = kThreads / kBK;       // rows between a thread's entries (16)
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the forward's mask for query row i (absolute position q_offset + i), key j
__device__ __forceinline__ bool kept(int i, int j, int Sq, int Skv, int causal, int window,
                                     int q_offset) {
  if (i >= Sq || j >= Skv) return false;
  const int qp = q_offset + i;
  if (causal && j > qp) return false;
  if (window > 0 && j <= qp - window) return false;
  return true;
}

// rows r0 .. r0 + R - 1 of one head (base already points at it; row_stride
// elements between sequence positions) into f32 shared rows of HD + 1;
// zeros past S
template <typename T, int HD, int R>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ base,
                                          long long row_stride, int r0, int S) {
  for (int idx = threadIdx.x; idx < R * HD; idx += kThreads) {
    const int r = idx / HD, d = idx - r * HD;
    dst[r * (HD + 1) + d] =
        r0 + r < S ? to_f32(base[(long long)(r0 + r) * row_stride + d]) : 0.f;
  }
}

// this thread's kPer entries of S = Q K^T and dP = dO V^T: key tid % kBK,
// rows tid / kBK + kRowStep r
template <int HD>
__device__ __forceinline__ void score_tile(const float* q_s, const float* k_s, const float* do_s,
                                           const float* v_s, float (&s)[kPer],
                                           float (&dp)[kPer]) {
  constexpr int LD = HD + 1;
  const int j = threadIdx.x % kBK, i0 = threadIdx.x / kBK;
#pragma unroll
  for (int r = 0; r < kPer; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    const float kk = k_s[j * LD + d], vv = v_s[j * LD + d];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      s[r] += q_s[(i0 + kRowStep * r) * LD + d] * kk;
      dp[r] += do_s[(i0 + kRowStep * r) * LD + d] * vv;
    }
  }
}

// D[b, h, i] = sum_d dout[b, i, h, :] . out[b, i, h, :]; one warp a row,
// rows numbered (b Sq + i) Hq + h, as they lie in memory
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dot(const T* __restrict__ dout, const T* __restrict__ out, float* __restrict__ D,
              int Sq, int Hq, long long rows) {
  const long long w = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (w >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* a = dout + w * HD;
  const T* o = out + w * HD;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32) acc += to_f32(a[d]) * to_f32(o[d]);
  acc = warp_sum(acc);
  if (lane == 0) {
    const long long bi = w / Hq;                 // b Sq + i
    const int h = (int)(w - bi * Hq);
    const long long b = bi / Sq, i = bi - b * Sq;
    D[(b * Hq + h) * Sq + i] = acc;
  }
}

template <int HD>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (2 * size_t(kBK) * (HD + 1) + 2 * size_t(kBQ) * (HD + 1) +
                          2 * size_t(kBQ) * (kBK + 1) + 2 * kBQ);
}

template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * size_t(kBQ) * (HD + 1) + 2 * size_t(kBK) * (HD + 1) +
                          size_t(kBQ) * (kBK + 1) + 2 * kBQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ D, T* __restrict__ dk, T* __restrict__ dv, int Sq,
               int Skv, int Hq, int Hkv, int causal, int window, int q_offset, float scale) {
  constexpr int LD = HD + 1, LP = kBK + 1;
  constexpr int NA = kBK * HD / kThreads;        // dK and dV entries per thread
  static_assert(NA >= 1 && (kBK * HD) % kThreads == 0, "tile does not split over threads");
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                   // [kBK][LD]
  float* v_s = k_s + kBK * LD;         // [kBK][LD]
  float* q_s = v_s + kBK * LD;         // [kBQ][LD]
  float* do_s = q_s + kBQ * LD;        // [kBQ][LD]
  float* p_s = do_s + kBQ * LD;        // [kBQ][LP]
  float* ds_s = p_s + kBQ * LP;        // [kBQ][LP]
  float* lse_s = ds_s + kBQ * LP;      // [kBQ]
  float* d_s = lse_s + kBQ;            // [kBQ]

  const int k0 = kt * kBK;
  const long long q_row = (long long)Hq * HD, kv_row = (long long)Hkv * HD;
  load_rows<T, HD, kBK>(k_s, k + (long long)b * Skv * kv_row + (long long)hk * HD, kv_row, k0,
                        Skv);
  load_rows<T, HD, kBK>(v_s, v + (long long)b * Skv * kv_row + (long long)hk * HD, kv_row, k0,
                        Skv);

  // the query rows that can keep one of this tile's keys
  const int k_hi = min(k0 + kBK, Skv) - 1;
  int q_begin = 0, q_end = Sq;
  if (causal) q_begin = max(0, k0 - q_offset);
  if (window > 0) q_end = min(Sq, k_hi + window - q_offset);
  q_begin = (q_begin / kBQ) * kBQ;

  float acc_k[NA], acc_v[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) acc_k[a] = acc_v[a] = 0.f;
  const int j = tid % kBK, i0 = tid / kBK;

  for (int g = 0; g < G; ++g) {
    const int hq = hk * G + g;
    const long long head = (long long)b * Sq * q_row + (long long)hq * HD;
    const float* lse_b = lse + ((long long)b * Hq + hq) * Sq;
    const float* D_b = D + ((long long)b * Hq + hq) * Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += kBQ) {
      __syncthreads();               // every thread is done with the previous tile
      load_rows<T, HD, kBQ>(q_s, q + head, q_row, q0, Sq);
      load_rows<T, HD, kBQ>(do_s, dout + head, q_row, q0, Sq);
      for (int r = tid; r < kBQ; r += kThreads) {
        const bool in = q0 + r < Sq;
        lse_s[r] = in ? lse_b[q0 + r] : 0.f;
        d_s[r] = in ? D_b[q0 + r] : 0.f;
      }
      __syncthreads();

      float s[kPer], dp[kPer];
      score_tile<HD>(q_s, k_s, do_s, v_s, s, dp);
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int i = i0 + kRowStep * r;
        const float p = kept(q0 + i, k0 + j, Sq, Skv, causal, window, q_offset)
                            ? expf(s[r] * scale - lse_s[i])
                            : 0.f;
        p_s[i * LP + j] = p;
        ds_s[i * LP + j] = p * (dp[r] - d_s[i]);
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the tile's rows, summed per tile
      // first (a blocked sum: G x Sq terms in one running f32 sum would
      // lose digits the f32 checks need)
      float part_k[NA], part_v[NA];
#pragma unroll
      for (int a = 0; a < NA; ++a) part_k[a] = part_v[a] = 0.f;
#pragma unroll 2
      for (int i = 0; i < kBQ; ++i) {
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          const int e = tid + kThreads * a;
          const int jj = e / HD, d = e - jj * HD;
          part_v[a] += p_s[i * LP + jj] * do_s[i * LD + d];
          part_k[a] += ds_s[i * LP + jj] * q_s[i * LD + d];
        }
      }
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        acc_k[a] += part_k[a];
        acc_v[a] += part_v[a];
      }
    }
  }

#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const int e = tid + kThreads * a;
    const int jj = e / HD, d = e - jj * HD;
    if (k0 + jj < Skv) {
      const long long off = ((long long)b * Skv + k0 + jj) * kv_row + (long long)hk * HD + d;
      dk[off] = from_f32<T>(acc_k[a] * scale);
      dv[off] = from_f32<T>(acc_v[a]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ D, T* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv,
             int causal, int window, int q_offset, float scale) {
  constexpr int LD = HD + 1, LP = kBK + 1;
  constexpr int NA = kBQ * HD / kThreads;        // dQ entries per thread
  static_assert(NA >= 1 && (kBQ * HD) % kThreads == 0, "tile does not split over threads");
  const int qt = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                   // [kBQ][LD]
  float* do_s = q_s + kBQ * LD;        // [kBQ][LD]
  float* k_s = do_s + kBQ * LD;        // [kBK][LD]
  float* v_s = k_s + kBK * LD;         // [kBK][LD]
  float* ds_s = v_s + kBK * LD;        // [kBQ][LP]
  float* lse_s = ds_s + kBQ * LP;      // [kBQ]
  float* d_s = lse_s + kBQ;            // [kBQ]

  const int q0 = qt * kBQ;
  const long long q_row = (long long)Hq * HD, kv_row = (long long)Hkv * HD;
  const long long head = (long long)b * Sq * q_row + (long long)hq * HD;
  load_rows<T, HD, kBQ>(q_s, q + head, q_row, q0, Sq);
  load_rows<T, HD, kBQ>(do_s, dout + head, q_row, q0, Sq);
  const float* lse_b = lse + ((long long)b * Hq + hq) * Sq;
  const float* D_b = D + ((long long)b * Hq + hq) * Sq;
  for (int r = tid; r < kBQ; r += kThreads) {
    const bool in = q0 + r < Sq;
    lse_s[r] = in ? lse_b[q0 + r] : 0.f;
    d_s[r] = in ? D_b[q0 + r] : 0.f;
  }

  // the keys any row of this tile can keep
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + kBQ, Sq) - 1;
  int k_end = Skv;
  if (causal) k_end = min(k_end, q_hi + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_lo - window + 1);
  k_begin = (k_begin / kBK) * kBK;

  const T* kb = k + (long long)b * Skv * kv_row + (long long)hk * HD;
  const T* vb = v + (long long)b * Skv * kv_row + (long long)hk * HD;
  float acc[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) acc[a] = 0.f;
  const int j = tid % kBK, i0 = tid / kBK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();                 // every thread is done with the previous tile
    load_rows<T, HD, kBK>(k_s, kb, kv_row, k0, Skv);
    load_rows<T, HD, kBK>(v_s, vb, kv_row, k0, Skv);
    __syncthreads();

    float s[kPer], dp[kPer];
    score_tile<HD>(q_s, k_s, do_s, v_s, s, dp);
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = i0 + kRowStep * r;
      const float p = kept(q0 + i, k0 + j, Sq, Skv, causal, window, q_offset)
                          ? expf(s[r] * scale - lse_s[i])
                          : 0.f;
      ds_s[i * LP + j] = p * (dp[r] - d_s[i]);
    }
    __syncthreads();

    // dQ += dS K over the tile's keys, summed per tile first
    float part[NA];
#pragma unroll
    for (int a = 0; a < NA; ++a) part[a] = 0.f;
#pragma unroll 4
    for (int jj = 0; jj < kBK; ++jj) {
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const int e = tid + kThreads * a;
        const int i = e / HD, d = e - i * HD;
        part[a] += ds_s[i * LP + jj] * k_s[jj * LD + d];
      }
    }
#pragma unroll
    for (int a = 0; a < NA; ++a) acc[a] += part[a];
  }

#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const int e = tid + kThreads * a;
    const int i = e / HD, d = e - i * HD;
    if (q0 + i < Sq)
      dq[((long long)b * Sq + q0 + i) * q_row + (long long)hq * HD + d] =
          from_f32<T>(acc[a] * scale);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const float* lse, float* D, void* dq, void* dk, void* dv,
                   int B, int Sq, int Skv, int Hq, int Hkv, int causal, int window,
                   int q_offset, float scale, cudaStream_t s) {
  static_assert(dkdv_smem<HD>() <= kMaxSmem && dq_smem<HD>() <= kMaxSmem,
                "tiles do not fit in shared memory");
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* o_ = static_cast<const T*>(out);
  const T* do_ = static_cast<const T*>(dout);
  cudaError_t err = allow_smem(flash_bwd_dkdv<T, HD>, dkdv_smem<HD>());
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dq<T, HD>, dq_smem<HD>());
  if (err != cudaSuccess) return err;

  const long long rows = (long long)B * Sq * Hq;
  const long long dot_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (dot_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dot<T, HD><<<(unsigned)dot_blocks, kThreads, 0, s>>>(do_, o_, D, Sq, Hq, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (Skv > 0) {
    dim3 grid_kv((Skv + kBK - 1) / kBK, Hkv, B);
    flash_bwd_dkdv<T, HD><<<grid_kv, kThreads, dkdv_smem<HD>(), s>>>(
        q_, k_, v_, do_, lse, D, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, Hq, Hkv,
        causal, window, q_offset, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dim3 grid_q((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_bwd_dq<T, HD><<<grid_q, kThreads, dq_smem<HD>(), s>>>(
      q_, k_, v_, do_, lse, D, static_cast<T*>(dq), Sq, Skv, Hq, Hkv, causal, window, q_offset,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* out,
                        const void* dout, const float* lse, float* D, void* dq, void* dk,
                        void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                        int window, int q_offset, float scale, cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, out, dout, lse, D, dq, dk, dv, B, Sq, Skv, Hq, Hkv, causal,
                           window, q_offset, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, out, dout, lse, D, dq, dk, dv, B, Sq, Skv, Hq, Hkv, causal,
                           window, q_offset, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, dout, lse, D, dq, dk, dv, B, Sq, Skv, Hq, Hkv, causal,
                           window, q_offset, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, dout, lse, D, dq, dk, dv, B, Sq, Skv, Hq, Hkv, causal,
                            window, q_offset, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, out, dout, lse, D, dq, dk, dv, B, Sq, Skv, Hq, Hkv, causal,
                            window, q_offset, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  hd in {16, 32, 64, 128,
// 256}.  q, out, dout, dq [B, Sq, Hq, hd]; k, v, dk, dv [B, Skv, Hkv, hd];
// lse: the forward's f32 [B, Hq, Sq]; D: f32 scratch [B, Hq, Sq] the call
// overwrites; all contiguous.  causal: 0 or 1; window <= 0: no window.
// Launches three kernels on `stream` in order, does not synchronise, and
// returns the first failed launch's cudaError_t (0 when all three queued).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* lse, void* D, void* dq,
                                   void* dk, void* dv, int dtype, int B, int Sq, int Skv,
                                   int Hq, int Hkv, int hd, int causal, int window,
                                   int q_offset, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv < 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || B > 65535 ||
      Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
  switch (dtype) {
    case 0:
      return (int)dispatch_hd<float>(hd, q, k, v, out, dout, l, d, dq, dk, dv, B, Sq, Skv, Hq,
                                     Hkv, causal, window, q_offset, scale, s);
    case 1:
      return (int)dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, dout, l, d, dq, dk, dv, B, Sq,
                                             Skv, Hq, Hkv, causal, window, q_offset, scale, s);
    case 2:
      return (int)dispatch_hd<__half>(hd, q, k, v, out, dout, l, d, dq, dk, dv, B, Sq, Skv, Hq,
                                      Hkv, causal, window, q_offset, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
