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
// dv of a KV head sum over its G query heads.  Sums in f32; dq, dk and dv
// are stored in the inputs' dtype.  No atomics anywhere: every sum runs in
// a fixed order, so two calls give the same bits.
//
// What bounds it on an H100: at gemma-2b's training shape (B = 4, S = 512,
// 8 / 1 heads of 256, causal) the kept pairs cost ~10.8 GFLOP (P
// recomputed, dP, dV, dK, dQ: five products over the kept half of the
// pairs), ~10.9 us at the 989 TFLOP/s bf16 tensor-core peak, against ~38
// MB of q, k, v, out, dout, lse in and dq, dk, dv out (~11.3 us at 3.35
// TB/s, the bound chip_smoke.py reports).
//
// Three launches in order on one stream, chosen by dtype in the C entry
// point (never a fallback): the D pass (flash_bwd_dot, one warp a row, both
// forms), then dK / dV, then dQ.
//
// bf16 / fp16: tensor cores (flash_bwd_dkdv_mma, flash_bwd_dq_mma), FA2's
// split into a key-tile kernel and a query-tile kernel:
//   * every product runs on mma.sync.m16n8k16 (bf16 / fp16 in, f32
//     accumulate), operands by ldmatrix from tiles kept in the input dtype
//     in shared memory, rows padded by 16 bytes so the 8 row addresses of
//     every ldmatrix hit distinct banks, loaded by 16-byte cp.async in a
//     two-stage ring (the next tile lands while this one computes);
//   * P and dS enter the products P^T dO, dS^T Q and dS K as three operands
//     each (split3: hi = x rounded to the dtype, mid = (x - hi) rounded, lo
//     = the rest rounded; ~24 bits, an f32's worth), three mma per product.
//     Rounding them once, as the forward rounds P, costs ~16 bits: at
//     gemma's training shape dk and dv reach |7| to |12|, where one bf16
//     ulp is 0.03 to 0.06, and every output whose exact value sits near a
//     rounding midpoint flips by that ulp, past the 3e-2 bar.
//     scripts/torch_flash_bwd_rounding.py models it on the CPU (B = 4, S =
//     512, three seeds): rounded once, 0.0625 from the f64 gradient; two
//     terms, 0.03125 (50-70x the flips of f32 rounding); three terms,
//     9.8e-4, fewer flips than f32 rounding.  The price: 2 + 3 x 2 mma
//     in the dK / dV kernel and 2 + 3 in dQ per pair and head-dim step, 13
//     where the five products need 5;
//   * dK / dV: one CTA of 8 warps per (64-key tile, KV head, batch row,
//     split): the KV head's G query heads are cut into `splits` groups
//     (a divisor of G, at most 8, chosen in ops.py::flash_bwd_splits so the
//     grid fills the SMs: gemma has one KV head, and 8 key tiles x 4 rows
//     alone are 32 CTAs for 132 SMs).  The CTA keeps its K and V tile and
//     walks, for each of its heads, the 32-row query tiles that can keep
//     one of its keys (causal and window limits bound the walk; Q, dO, lse
//     and D through the ring).  Per query tile, phase 1: warp (key block
//     w % 4, query half w / 4) computes S^T = K Q^T and dP^T = V dO^T for
//     its 16 keys x 16 rows, then P^T and dS^T, and stages them (three
//     terms each) in shared memory; phase 2: warp (key block w % 4, column half
//     w / 4) adds P^T dO and dS^T Q into its 16 x hd/2 dV and dK
//     accumulators.  The staging is the price of the register cap: a warp
//     that owned 16 keys over the whole hd 256 would hold 256 f32
//     accumulators a thread; split over two warps it holds 128, and the
//     staging costs a shared-memory round trip of 6 x 64 x 32 16-bit values
//     a query tile (against a redundant S^T / dP^T per warp, +50% of phase
//     1's products, had each warp recomputed them);
//   * the splits of one key tile form a thread-block cluster (grid x).
//     After the walk each CTA leaves its f32 dK / dV in its shared memory
//     (the ring's space), the cluster syncs, and CTA r sums rows 64 r /
//     splits .. 64 (r + 1) / splits - 1 of every rank's partials, read
//     through distributed shared memory in rank order, scales dK, rounds
//     and stores; a last cluster sync keeps each CTA's shared memory alive
//     until its peers have read it.  One launch, no scratch in device
//     memory (the scratch route would move splits x B x Skv x Hkv x hd x 8
//     bytes through L2: 34 MB at gemma's shape), no atomics.  Key tiles run heaviest first (the
//     slowest grid dimension is the key tile, ascending: causal key tile 0
//     is kept by every query);
//   * dQ: one CTA of 4 warps per (32-row query tile, query head, batch
//     row), the forward's 32-row shape: warp w owns rows 16 (w % 2) .. + 15
//     and half the keys of each K / V tile, and the two halves' dQ are
//     summed once at the end in a fixed order.  (64-row tiles with a warp
//     on all of a tile's keys, the forward's other shape, ran slower at
//     every shape tried on an H100: half the CTAs, one an SM at hd 256.)
//     Q and dO are loaded once; K / V tiles of 64 keys (32 at hd
//     256) go through the ring.  S = Q K^T, dP = dO V^T, then dS in the
//     accumulator layout becomes the A operand of dS K straight from
//     registers, K read through ldmatrix.trans.  The query tiles run
//     heaviest first (the last causal tile first);
//   * sums: the tensor cores' f32 accumulation truncates, so no chain of
//     more than kKGroup (S^T, dP^T, S, dP) or 3 (the split3 terms) mma
//     runs into one accumulator; the groups add in f32 (acc_step);
//   * what holds it: latency, not a rate.  At gemma's training shape (H100,
//     scripts/torch_train_probe.py --splits) dK / dV takes two thirds of
//     the call, ~7 us per 64 x 32 step of its walk (18 steps on the
//     busiest SM) against ~1.8 us for that step's ~440 KB of ldmatrix
//     reads at 128 B a clock and ~1.1 us for its 8.4 MFLOP of mma at the
//     card's peak: one CTA of 8 warps an SM (166 KB of shared memory at hd
//     256), two barriers a step, and ldmatrix -> mma chains the warps
//     cannot hide.  wgmma with TMA (B read once per warpgroup, issue decoupled
//     from the math) and the splits' merge under the walk are the way on.
//
// f32: the SIMT kernels (flash_bwd_dkdv, flash_bwd_dq), unchanged from the
// first port: TF32 tensor cores keep ~3 digits, short of the 2e-5 bar of
// the f32 checks (the forward's ruling too).
//   * flash_bwd_dkdv: one CTA per (16-key tile, KV head, batch row).  K
//     and V of its tile stay in shared memory; it walks the G query heads
//     of its KV head and, for each, the 32-row query tiles that can keep
//     one of its keys, and recomputes P and dS for the tile.  dK and dV sum
//     in registers over all G heads and all query tiles, inside the CTA;
//   * flash_bwd_dq: one CTA per (32-row query tile, query head, batch
//     row); Q, dO, lse and D stay in shared memory, and it walks the
//     16-key tiles its rows can keep, recomputing P and dS; dQ sums in
//     registers.
//   Both sum each tile's terms apart and then add them to the running sums:
//   with one running f32 sum over all of them, the gradients at gemma's
//   width (f32, S = 333) came 2.4e-5 from the f32 plain version on an H100,
//   over the 2e-5 of the f32 checks.  Tiles are f32 in shared memory, rows
//   padded by one word so that the 16 keys a warp reads at one column sit
//   in 16 banks.
//
// Both forms: rows past Sq and keys past Skv load as zeros and are masked;
// a masked pair contributes exactly 0 to every sum.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

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

// ---------------------------------------------------------------------------
// bf16 / fp16: the tensor-core kernels
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTcPad = 8;          // elements (16 bytes) of padding per shared row
constexpr int kMaxSplits = 8;      // portable cluster size
constexpr int kKvThreads = 256;    // dK / dV: 8 warps, (key block, query / column half)
constexpr int kKT = 64;            // keys per dK / dV CTA
constexpr int kQT = 32;            // query rows per step of its walk
constexpr int kDqThreads = 128;    // dQ: 4 warps, (row block, key part)

// acc += (a[0] + a[1] + a[2]) b, the three terms of an operand (split3):
// their products sum in a fresh accumulator, smallest first, and that is
// added to acc in f32.  The tensor cores add a product into its
// accumulator through an alignment that truncates, so a chain of a hundred
// mma into one accumulator drifts by a hundred of its low bits (on an H100
// that flipped a bf16 dk of |4| .. |8| by its 0.03125 ulp at gemma-2b's
// training shape); a fresh accumulator per k-step keeps the drift to f32
// rounding.
template <typename T>
__device__ __forceinline__ void acc_step(float (&acc)[4], const uint32_t (&a)[3][4], uint32_t b0,
                                         uint32_t b1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma16816<T>(t, a[2], b0, b1);
  mma16816<T>(t, a[1], b0, b1);
  mma16816<T>(t, a[0], b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];
}

// S^T / dP^T over hd in groups of this many k-steps, each group in a fresh
// accumulator added in f32 (acc_step's reason)
constexpr int kKGroup = 4;

template <int HD> struct KvTile {
  static constexpr int LD = HD + kTcPad;          // shared row of K, V, Q, dO, elements
  static constexpr int LDP = kQT + kTcPad;        // shared row of a staged P^T / dS^T
  static constexpr int CPR = HD / 8;              // 16-byte chunks per row
  static constexpr int KV_ELEMS = kKT * LD;       // the K or the V tile
  static constexpr int Q_ELEMS = kQT * LD;        // one Q or dO tile
  static constexpr int P_ELEMS = kKT * LDP;       // one staged array
  static constexpr int LDR = HD + 4;              // f32 row of the splits' merge
  // K, V; 2 stages x (Q, dO); P^T and dS^T, three terms each; 2 stages x (lse, D)
  static constexpr size_t SMEM =
      size_t(2 * KV_ELEMS + 4 * Q_ELEMS + 6 * P_ELEMS) * 2 + sizeof(float) * 4 * kQT;
  static_assert(sizeof(float) * 2 * kKT * LDR <= SMEM, "the merge fits in the tiles' space");
};

// One CTA per (split, KV head, key tile x batch row); the splits of a key
// tile are one cluster.  Scores in the log2 domain: P = exp2(s scale log2e -
// lse log2e).
template <typename T, int HD>
__global__ void __launch_bounds__(kKvThreads, 1)
flash_bwd_dkdv_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ D, T* __restrict__ dk, T* __restrict__ dv, int B,
                   int Sq, int Skv, int Hq, int Hkv, int causal, int window, int q_offset,
                   float scale) {
  using TT = KvTile<HD>;
  constexpr int LD = TT::LD, LDP = TT::LDP, CPR = TT::CPR, LDR = TT::LDR;
  constexpr int NB = HD / 16;                   // 8-column blocks of a warp's half of hd
  constexpr int P_BYTES = TT::P_ELEMS * 2;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int hk = blockIdx.y;
  const int kt = blockIdx.z / B, b = blockIdx.z - kt * B;   // key tile 0 first
  const int G = Hq / Hkv, GS = G / n_c;          // this CTA's heads: hk G + rank GS ..
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kb = warp & 3, half = warp >> 2;     // key block; query half / column half
  const float sl2 = scale * kLog2e;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);      // [kKT][LD]
  T* v_s = k_s + TT::KV_ELEMS;                  // [kKT][LD]
  T* qd_s = v_s + TT::KV_ELEMS;                 // stage s: Q at 2s, dO at 2s + 1, [kQT][LD]
  T* pt_s = qd_s + 4 * TT::Q_ELEMS;             // P^T hi, mid, lo, dS^T hi, mid, lo [kKT][LDP]
  float* row_s = reinterpret_cast<float*>(pt_s + 6 * TT::P_ELEMS);  // stage s: lse, D [kQT]

  const int k0 = kt * kKT;
  const long long q_row = (long long)Hq * HD, kv_row = (long long)Hkv * HD;
  const T* kg = k + (long long)b * Skv * kv_row + (long long)hk * HD;
  const T* vg = v + (long long)b * Skv * kv_row + (long long)hk * HD;
  for (int i = tid; i < kKT * CPR; i += kKvThreads) {
    const int r = i / CPR, c = i - r * CPR;
    const bool ok = k0 + r < Skv;
    const long long off = (ok ? (k0 + r) * kv_row : 0) + c * 8;
    cp_async16(smem_u32(k_s + r * LD + c * 8), kg + off, ok);
    cp_async16(smem_u32(v_s + r * LD + c * 8), vg + off, ok);
  }

  // the query rows that can keep one of this tile's keys
  const int k_hi = min(k0 + kKT, Skv) - 1;
  int q_begin = 0, q_end = Sq;
  if (causal) q_begin = max(0, k0 - q_offset);
  if (window > 0) q_end = min(Sq, k_hi + window - q_offset);
  q_begin = (q_begin / kQT) * kQT;
  const int n_qt = q_end > q_begin ? (q_end - q_begin + kQT - 1) / kQT : 0;
  const int n_it = GS * n_qt;                   // (head, query tile), head-major

  auto load_q = [&](int it, int stage) {
    const int hq = hk * G + rank * GS + it / n_qt;
    const int q0 = q_begin + (it % n_qt) * kQT;
    const long long head = (long long)b * Sq * q_row + (long long)hq * HD;
    T* qs = qd_s + 2 * stage * TT::Q_ELEMS;
    T* os = qs + TT::Q_ELEMS;
    for (int i = tid; i < kQT * CPR; i += kKvThreads) {
      const int r = i / CPR, c = i - r * CPR;
      const bool ok = q0 + r < Sq;
      const long long off = head + (ok ? (q0 + r) * q_row : 0) + c * 8;
      cp_async16(smem_u32(qs + r * LD + c * 8), q + off, ok);
      cp_async16(smem_u32(os + r * LD + c * 8), dout + off, ok);
    }
    if (tid < 2 * kQT) {
      const int r = tid % kQT;
      const bool ok = q0 + r < Sq;
      const float* src = (tid < kQT ? lse : D) + ((long long)b * Hq + hq) * Sq + (ok ? q0 + r : 0);
      cp_async4(smem_u32(row_s + (2 * stage + tid / kQT) * kQT + r), src, ok);
    }
  };
  if (n_it > 0) load_q(0, 0);
  cp_async_commit();                            // K, V and the first query tile

  float acc_k[NB][4], acc_v[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  // ldmatrix row addresses of this lane.  Phase 1: K / V as A (key rows
  // 16 kb + lane % 16, column half lane / 16); Q / dO as B of two 8-row
  // blocks (row 16 half + lane % 8 + 8 (lane / 16), column half (lane / 8)
  // % 2).  Phase 2: staged P^T / dS^T as A (key rows as K); Q / dO as B
  // through .trans (row lane % 8 + 8 ((lane / 8) % 2), columns from
  // hd/2 half + 8 (lane / 16)).
  const uint32_t k_a = smem_u32(k_s + (kb * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  const uint32_t v_a = k_a + TT::KV_ELEMS * 2;
  const int qb_off = (half * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
  const uint32_t p_a = smem_u32(pt_s + (kb * 16 + (lane & 15)) * LDP + (lane >> 4) * 8);
  const int qt_off =
      ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + half * (HD / 2) + (lane >> 4) * 8;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait_all();
    __syncthreads();               // tile it has landed; every warp is done with it - 1
    if (it + 1 < n_it) load_q(it + 1, (it + 1) & 1);
    cp_async_commit();
    const int st = it & 1;
    const T* qs = qd_s + 2 * st * TT::Q_ELEMS;
    const T* os = qs + TT::Q_ELEMS;
    const float* lse_s = row_s + 2 * st * kQT;
    const float* d_s = lse_s + kQT;
    const int q0 = q_begin + (it % n_qt) * kQT;

    // phase 1: S^T = K Q^T, dP^T = V dO^T for keys 16 kb .., rows 16 half ..
    float s[2][4], dp[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    const uint32_t q_b = smem_u32(qs + qb_off), o_b = smem_u32(os + qb_off);
    constexpr int KG = HD / 16 < kKGroup ? HD / 16 : kKGroup;
#pragma unroll
    for (int k0g = 0; k0g < HD / 16; k0g += KG) {
      float ts[2][4] = {}, tdp[2][4] = {};
#pragma unroll
      for (int kk = k0g; kk < k0g + KG; ++kk) {
        uint32_t a[4], bf[4];
        ldsm_x4(a, k_a + kk * 32);
        ldsm_x4(bf, q_b + kk * 32);
        mma16816<T>(ts[0], a, bf[0], bf[1]);
        mma16816<T>(ts[1], a, bf[2], bf[3]);
        ldsm_x4(a, v_a + kk * 32);
        ldsm_x4(bf, o_b + kk * 32);
        mma16816<T>(tdp[0], a, bf[0], bf[1]);
        mma16816<T>(tdp[1], a, bf[2], bf[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] += ts[j][e];
          dp[j][e] += tdp[j][e];
        }
    }
    // P^T and dS^T (key row 16 kb + g (+ 8), query column 16 half + 8 j +
    // 2 t4 (+ 1)), staged as three terms each
    const int j0 = k0 + kb * 16 + g;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ic = half * 16 + j * 8 + 2 * t4;
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ic + (e & 1);
        const bool keep = kept(q0 + i, j0 + 8 * (e >> 1), Sq, Skv, causal, window, q_offset);
        p[e] = keep ? exp2f(s[j][e] * sl2 - lse_s[i] * kLog2e) : 0.f;
        ds[e] = p[e] * (dp[j][e] - d_s[i]);
      }
      // term t of P^T at word W[t] + w, of dS^T at W[3 + t] + w
      uint32_t* w = reinterpret_cast<uint32_t*>(pt_s + (kb * 16 + g) * LDP + ic);
      constexpr int PW = TT::P_ELEMS / 2, R8 = 8 * LDP / 2;   // an array, 8 rows: in words
      split3<T>(p[0], p[1], w[0], w[PW], w[2 * PW]);
      split3<T>(p[2], p[3], w[R8], w[PW + R8], w[2 * PW + R8]);
      split3<T>(ds[0], ds[1], w[3 * PW], w[4 * PW], w[5 * PW]);
      split3<T>(ds[2], ds[3], w[3 * PW + R8], w[4 * PW + R8], w[5 * PW + R8]);
    }
    __syncthreads();               // P^T and dS^T staged

    // phase 2: dV += P^T dO, dK += dS^T Q over the tile's rows, columns
    // hd/2 half .. of keys 16 kb ..
    const uint32_t q_t = smem_u32(qs + qt_off), o_t = smem_u32(os + qt_off);
#pragma unroll
    for (int kk = 0; kk < kQT / 16; ++kk) {
      uint32_t pa[3][4], da[3][4];             // the three terms of P^T and of dS^T
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        ldsm_x4(pa[t], p_a + t * P_BYTES + kk * 32);
        ldsm_x4(da[t], p_a + (3 + t) * P_BYTES + kk * 32);
      }
      const int row = kk * 16 * LD;
      if constexpr (NB == 1) {      // hd 16: one 8-column block a warp
        uint32_t bf[2];
        ldsm_x2_t(bf, o_t + row * 2);
        acc_step<T>(acc_v[0], pa, bf[0], bf[1]);
        ldsm_x2_t(bf, q_t + row * 2);
        acc_step<T>(acc_k[0], da, bf[0], bf[1]);
      } else {
#pragma unroll
        for (int nn = 0; nn < NB / 2; ++nn) {
          uint32_t bf[4];
          ldsm_x4_t(bf, o_t + (row + nn * 16) * 2);
          acc_step<T>(acc_v[2 * nn], pa, bf[0], bf[1]);
          acc_step<T>(acc_v[2 * nn + 1], pa, bf[2], bf[3]);
          ldsm_x4_t(bf, q_t + (row + nn * 16) * 2);
          acc_step<T>(acc_k[2 * nn], da, bf[0], bf[1]);
          acc_step<T>(acc_k[2 * nn + 1], da, bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();                 // no copy in flight (n_it may be 0); the tiles are free

  // this CTA's partial dK and dV, f32 [kKT][LDR] each, over the tiles
  float* red = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int off = (kb * 16 + g) * LDR + half * (HD / 2) + j * 8 + 2 * t4;
    *reinterpret_cast<float2*>(red + off) = make_float2(acc_k[j][0], acc_k[j][1]);
    *reinterpret_cast<float2*>(red + off + 8 * LDR) = make_float2(acc_k[j][2], acc_k[j][3]);
    *reinterpret_cast<float2*>(red + kKT * LDR + off) = make_float2(acc_v[j][0], acc_v[j][1]);
    *reinterpret_cast<float2*>(red + kKT * LDR + off + 8 * LDR) =
        make_float2(acc_v[j][2], acc_v[j][3]);
  }
  cluster.sync();

  // rank r: rows r R .. r R + R - 1 (R = kKT / n_c) of dK and dV, summed
  // over the ranks in rank order, 4 columns a thread
  const int R = kKT / n_c;
  constexpr int C4 = HD / 4;
  for (int i = tid; i < 2 * R * C4; i += kKvThreads) {
    const int which = i / (R * C4);             // 0: dK, 1: dV
    const int rem = i - which * R * C4;
    const int r = rank * R + rem / C4, c = (rem % C4) * 4;
    float4* src = reinterpret_cast<float4*>(red + which * kKT * LDR + r * LDR + c);
    float4 sum = *cluster.map_shared_rank(src, 0);
    for (int rr = 1; rr < n_c; ++rr) {
      const float4 x = *cluster.map_shared_rank(src, rr);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    if (k0 + r < Skv) {
      const float f = which == 0 ? scale : 1.f;
      T* dst = (which == 0 ? dk : dv) + ((long long)b * Skv + k0 + r) * kv_row +
               (long long)hk * HD + c;
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(pack2<T>(sum.x * f, sum.y * f), pack2<T>(sum.z * f, sum.w * f));
    }
  }
  cluster.sync();                  // peers may still read this CTA's shared memory until here
}

// 32 query rows per CTA in two row blocks of 16; the 4 warps split each K /
// V tile's KT keys into two parts of KW keys.
template <int HD> struct DqTile {
  static constexpr int BQ = 32;                          // query rows per CTA
  static constexpr int KT = HD == 256 ? 32 : 64;         // keys per K / V tile
  static constexpr int KW = KT / 2;                      // keys of a warp
  static constexpr int LD = HD + kTcPad;
  static constexpr int CPR = HD / 8;
  static constexpr int QELEMS = BQ * LD;                 // the Q or the dO tile
  static constexpr int ELEMS = KT * LD;                  // one K or V tile
  static constexpr size_t SMEM = size_t(2 * QELEMS + 4 * ELEMS) * 2;   // Q, dO + 2 x (K, V)
  static_assert(KW % 16 == 0, "a warp's keys are whole k-steps of dS K");
  static_assert(sizeof(float) * 2 * (HD / 8) * 4 * 32 <= 4 * ELEMS * 2,
                "the key parts' merge fits in the K / V area");
};

// One CTA per (query head, batch row, query tile), 4 warps: warp w owns
// rows 16 (w % 2) .. + 15 and keys KW (w / 2) .. of every K / V tile.
template <typename T, int HD>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_bwd_dq_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ D, T* __restrict__ dq, int Sq, int Skv, int Hq,
                 int Hkv, int causal, int window, int q_offset, float scale) {
  using TT = DqTile<HD>;
  constexpr int LD = TT::LD, CPR = TT::CPR, BQ = TT::BQ, KT = TT::KT, KW = TT::KW;
  constexpr int NS = KW / 8;         // 8-key blocks of a warp's scores
  constexpr int NO = HD / 8;         // 8-column blocks of dQ
  const int hq = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;          // heaviest causal tiles first
  const int hk = hq / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp & 1, kh = warp >> 1;           // row block, key part
  const int g = lane >> 2, t4 = lane & 3;
  const float sl2 = scale * kLog2e;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);           // [BQ][LD]
  T* do_s = q_s + TT::QELEMS;                        // [BQ][LD]
  T* kv_s = do_s + TT::QELEMS;                       // stage s: K at 2s, V at 2s + 1

  const int q0 = qt * BQ;
  const long long q_row = (long long)Hq * HD, kv_row = (long long)Hkv * HD;
  const long long head = (long long)b * Sq * q_row + (long long)hq * HD;
  const T* kg = k + (long long)b * Skv * kv_row + (long long)hk * HD;
  const T* vg = v + (long long)b * Skv * kv_row + (long long)hk * HD;
  for (int i = tid; i < BQ * CPR; i += kDqThreads) {
    const int r = i / CPR, c = i - r * CPR;
    const bool ok = q0 + r < Sq;
    const long long off = head + (ok ? (q0 + r) * q_row : 0) + c * 8;
    cp_async16(smem_u32(q_s + r * LD + c * 8), q + off, ok);
    cp_async16(smem_u32(do_s + r * LD + c * 8), dout + off, ok);
  }

  // the keys any row of this tile can keep
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + BQ, Sq) - 1;
  int k_end = Skv;
  if (causal) k_end = min(k_end, q_hi + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_lo - window + 1);
  k_begin = (k_begin / KT) * KT;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + KT - 1) / KT : 0;

  auto load_kv = [&](int tile, int stage) {
    const int kk0 = k_begin + tile * KT;
    T* ks = kv_s + 2 * stage * TT::ELEMS;
    T* vs = ks + TT::ELEMS;
    for (int i = tid; i < KT * CPR; i += kDqThreads) {
      const int r = i / CPR, c = i - r * CPR;
      const bool ok = kk0 + r < Skv;
      const long long off = (ok ? (kk0 + r) * kv_row : 0) + c * 8;
      cp_async16(smem_u32(ks + r * LD + c * 8), kg + off, ok);
      cp_async16(smem_u32(vs + r * LD + c * 8), vg + off, ok);
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  // this thread's rows 16 wr + g and + 8: lse (log2 domain) and D
  const int i0 = q0 + wr * 16 + g, i1 = i0 + 8;
  const float* lse_b = lse + ((long long)b * Hq + hq) * Sq;
  const float* D_b = D + ((long long)b * Hq + hq) * Sq;
  const float l2[2] = {i0 < Sq ? lse_b[i0] * kLog2e : 0.f, i1 < Sq ? lse_b[i1] * kLog2e : 0.f};
  const float dd[2] = {i0 < Sq ? D_b[i0] : 0.f, i1 < Sq ? D_b[i1] : 0.f};

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // ldmatrix row addresses of this lane: Q / dO as A (rows 16 wr + lane %
  // 16, column half lane / 16); K / V as B of two 8-key blocks (key lane % 8
  // + 8 (lane / 16), column half (lane / 8) % 2); K as B of dS K through
  // .trans (key lane % 8 + 8 ((lane / 8) % 2), column half lane / 16); keys
  // from the warp's part on
  const uint32_t q_a = smem_u32(q_s + (wr * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  const uint32_t o_a = q_a + TT::QELEMS * 2;
  const int k_off = (kh * KW + (lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
  const int kt_off = (kh * KW + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();               // tile it has landed; every warp is done with it - 1
    if (it + 1 < n_tiles) load_kv(it + 1, (it + 1) & 1);
    cp_async_commit();
    const T* ks = kv_s + 2 * (it & 1) * TT::ELEMS;
    const uint32_t k_b = smem_u32(ks + k_off);
    const uint32_t v_b = k_b + TT::ELEMS * 2;
    const uint32_t k_t = smem_u32(ks + kt_off);

    // S = Q K^T, dP = dO V^T, in groups of kKGroup k-steps
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    constexpr int KG = HD / 16 < kKGroup ? HD / 16 : kKGroup;
#pragma unroll
    for (int k0g = 0; k0g < HD / 16; k0g += KG) {
      float ts[NS][4] = {}, tdp[NS][4] = {};
#pragma unroll
      for (int kk = k0g; kk < k0g + KG; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, q_a + kk * 32);
#pragma unroll
        for (int nn = 0; nn < NS / 2; ++nn) {
          uint32_t bf[4];
          ldsm_x4(bf, k_b + (nn * 16 * LD + kk * 16) * 2);
          mma16816<T>(ts[2 * nn], a, bf[0], bf[1]);
          mma16816<T>(ts[2 * nn + 1], a, bf[2], bf[3]);
        }
        ldsm_x4(a, o_a + kk * 32);
#pragma unroll
        for (int nn = 0; nn < NS / 2; ++nn) {
          uint32_t bf[4];
          ldsm_x4(bf, v_b + (nn * 16 * LD + kk * 16) * 2);
          mma16816<T>(tdp[2 * nn], a, bf[0], bf[1]);
          mma16816<T>(tdp[2 * nn + 1], a, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] += ts[j][e];
          dp[j][e] += tdp[j][e];
        }
    }

    // dS = P (dP - D), in place of S
    const int kp0 = k_begin + it * KT + kh * KW + 2 * t4;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool keep = kept(r ? i1 : i0, kp0 + j * 8 + (e & 1), Sq, Skv, causal, window,
                               q_offset);
        const float p = keep ? exp2f(s[j][e] * sl2 - l2[r]) : 0.f;
        s[j][e] = p * (dp[j][e] - dd[r]);
      }
    }

    // dQ += dS K, dS as three A fragments straight from registers; each
    // k-step's three products sum in a fresh accumulator, added to dQ in
    // f32 (see acc_step)
#pragma unroll
    for (int kk = 0; kk < KW / 16; ++kk) {
      uint32_t a[3][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* x = s[2 * kk + (r >> 1)] + 2 * (r & 1);   // the A fragment's order
        split3<T>(x[0], x[1], a[0][r], a[1][r], a[2][r]);
      }
#pragma unroll
      for (int nn = 0; nn < NO / 2; ++nn) {
        uint32_t bf[4];
        ldsm_x4_t(bf, k_t + (kk * 16 * LD + nn * 16) * 2);
        acc_step<T>(acc[2 * nn], a, bf[0], bf[1]);
        acc_step<T>(acc[2 * nn + 1], a, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();                 // no copy in flight (n_tiles may be 0), K / V free

  // sum the key parts: the second part's warps leave dQ in the K / V area,
  // thread by thread, and the first part's add it
  float* xo = reinterpret_cast<float*>(kv_s);        // [2][NO][4][32]
  if (kh == 1) {
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) xo[((wr * NO + j) * 4 + e) * 32 + lane] = acc[j][e];
  }
  __syncthreads();
  if (kh == 1) return;
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += xo[((wr * NO + j) * 4 + e) * 32 + lane];

  // scale; stage the warp's 16 rows in its own Q rows (no other warp reads
  // them now), then write them as 16-byte vectors
  T* o_s = q_s + wr * 16 * LD;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = j * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(o_s + g * LD + c) = pack2<T>(acc[j][0] * scale, acc[j][1] * scale);
    *reinterpret_cast<uint32_t*>(o_s + (g + 8) * LD + c) =
        pack2<T>(acc[j][2] * scale, acc[j][3] * scale);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, c = i - r * CPR;
    const int row = q0 + wr * 16 + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(dq + ((long long)b * Sq + row) * q_row + (long long)hq * HD +
                                c * 8) = *reinterpret_cast<const uint4*>(o_s + r * LD + c * 8);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// the D pass, both forms
template <typename T, int HD>
cudaError_t launch_dot(const T* dout, const T* out, float* D, int B, int Sq, int Hq,
                       cudaStream_t s) {
  const long long rows = (long long)B * Sq * Hq;
  const long long dot_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (dot_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dot<T, HD><<<(unsigned)dot_blocks, kThreads, 0, s>>>(dout, out, D, Sq, Hq, rows);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_simt(const T* q, const T* k, const T* v, const T* out, const T* dout,
                        const float* lse, float* D, T* dq, T* dk, T* dv, int B, int Sq, int Skv,
                        int Hq, int Hkv, int causal, int window, int q_offset, float scale,
                        cudaStream_t s) {
  static_assert(dkdv_smem<HD>() <= kMaxSmem && dq_smem<HD>() <= kMaxSmem,
                "tiles do not fit in shared memory");
  cudaError_t err = allow_smem(flash_bwd_dkdv<T, HD>, dkdv_smem<HD>());
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dq<T, HD>, dq_smem<HD>());
  if (err == cudaSuccess) err = launch_dot<T, HD>(dout, out, D, B, Sq, Hq, s);
  if (err != cudaSuccess) return err;
  if (Skv > 0) {
    dim3 grid_kv((Skv + kBK - 1) / kBK, Hkv, B);
    flash_bwd_dkdv<T, HD><<<grid_kv, kThreads, dkdv_smem<HD>(), s>>>(
        q, k, v, dout, lse, D, dk, dv, Sq, Skv, Hq, Hkv, causal, window, q_offset, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dim3 grid_q((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_bwd_dq<T, HD><<<grid_q, kThreads, dq_smem<HD>(), s>>>(
      q, k, v, dout, lse, D, dq, Sq, Skv, Hq, Hkv, causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dq_mma(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                          const float* D, T* dq, int B, int Sq, int Skv, int Hq, int Hkv,
                          int causal, int window, int q_offset, float scale, cudaStream_t s) {
  using TT = DqTile<HD>;
  static_assert(TT::SMEM <= kMaxSmem, "tiles do not fit in shared memory");
  const cudaError_t err = allow_smem(flash_bwd_dq_mma<T, HD>, TT::SMEM);
  if (err != cudaSuccess) return err;
  const int n_qt = (Sq + TT::BQ - 1) / TT::BQ;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  flash_bwd_dq_mma<T, HD><<<dim3(Hq, B, n_qt), kDqThreads, TT::SMEM, s>>>(
      q, k, v, dout, lse, D, dq, Sq, Skv, Hq, Hkv, causal, window, q_offset, scale);
  return cudaGetLastError();
}

// splits: CTAs (one cluster) sharing a key tile's G query heads (from
// ops.py::flash_bwd_splits)
template <typename T, int HD>
cudaError_t launch_mma(const T* q, const T* k, const T* v, const T* out, const T* dout,
                       const float* lse, float* D, T* dq, T* dk, T* dv, int B, int Sq, int Skv,
                       int Hq, int Hkv, int causal, int window, int q_offset, float scale,
                       int splits, cudaStream_t s) {
  using TT = KvTile<HD>;
  static_assert(TT::SMEM <= kMaxSmem, "tiles do not fit in shared memory");
  const int n_kt = (Skv + kKT - 1) / kKT;
  if ((long long)n_kt * B > 65535) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_bwd_dkdv_mma<T, HD>, TT::SMEM);
  if (err == cudaSuccess) err = launch_dot<T, HD>(dout, out, D, B, Sq, Hq, s);
  if (err != cudaSuccess) return err;
  if (Skv > 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(splits, Hkv, n_kt * B);
    cfg.blockDim = dim3(kKvThreads);
    cfg.dynamicSmemBytes = TT::SMEM;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, flash_bwd_dkdv_mma<T, HD>, q, k, v, dout, lse,
                             static_cast<const float*>(D), dk, dv, B, Sq, Skv, Hq, Hkv, causal,
                             window, q_offset, scale);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_dq_mma<T, HD>(q, k, v, dout, lse, D, dq, B, Sq, Skv, Hq, Hkv, causal, window,
                              q_offset, scale, s);
}

// f32 -> the SIMT kernels; bf16 / fp16 -> the tensor-core kernels
template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const float* lse, float* D, void* dq, void* dk, void* dv,
                   int B, int Sq, int Skv, int Hq, int Hkv, int causal, int window,
                   int q_offset, float scale, int splits, cudaStream_t s) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* o_ = static_cast<const T*>(out);
  const T* do_ = static_cast<const T*>(dout);
  T* dq_ = static_cast<T*>(dq);
  T* dk_ = static_cast<T*>(dk);
  T* dv_ = static_cast<T*>(dv);
  if constexpr (sizeof(T) == 4)
    return launch_simt<T, HD>(q_, k_, v_, o_, do_, lse, D, dq_, dk_, dv_, B, Sq, Skv, Hq, Hkv,
                              causal, window, q_offset, scale, s);
  else
    return launch_mma<T, HD>(q_, k_, v_, o_, do_, lse, D, dq_, dk_, dv_, B, Sq, Skv, Hq, Hkv,
                             causal, window, q_offset, scale, splits, s);
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* out,
                        const void* dout, const float* lse, float* D, void* dq, void* dk,
                        void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                        int window, int q_offset, float scale, int splits, cudaStream_t s) {
#define FLASH_BWD_HD(HD)                                                                     \
  case HD:                                                                                   \
    return launch<T, HD>(q, k, v, out, dout, lse, D, dq, dk, dv, B, Sq, Skv, Hq, Hkv, causal, \
                         window, q_offset, scale, splits, s);
  switch (hd) {
    FLASH_BWD_HD(16)
    FLASH_BWD_HD(32)
    FLASH_BWD_HD(64)
    FLASH_BWD_HD(128)
    FLASH_BWD_HD(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_BWD_HD
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// dtype: 0 = float32 (SIMT kernels), 1 = bfloat16, 2 = float16 (tensor-core
// kernels; q, k, v, dout, dq, dk and dv 16-byte aligned).  hd in {16, 32,
// 64, 128, 256}.  q, out, dout, dq [B, Sq, Hq, hd]; k, v, dk, dv [B, Skv,
// Hkv, hd]; lse: the forward's f32 [B, Hq, Sq]; D: f32 scratch [B, Hq, Sq]
// the call overwrites; all contiguous.  causal: 0 or 1; window <= 0: no
// window.  splits (1, 2, 4 or 8, dividing Hq / Hkv): the tensor-core form's
// CTAs per key tile; the SIMT form ignores it.  Launches three
// kernels on `stream` in order, does not synchronise, and returns the first
// failed launch's cudaError_t (0 when all three queued).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* lse, void* D, void* dq,
                                   void* dk, void* dv, int dtype, int B, int Sq, int Skv,
                                   int Hq, int Hkv, int hd, int causal, int window,
                                   int q_offset, float scale, int splits, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv < 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || B > 65535 ||
      Hq > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0) {
    if (!(splits == 1 || splits == 2 || splits == 4 || splits == kMaxSplits) ||
        (Hq / Hkv) % splits != 0)
      return (int)cudaErrorInvalidValue;
    if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) && aligned16(dq) &&
          aligned16(dk) && aligned16(dv)))
      return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
  switch (dtype) {
    case 0:
      return (int)dispatch_hd<float>(hd, q, k, v, out, dout, l, d, dq, dk, dv, B, Sq, Skv, Hq,
                                     Hkv, causal, window, q_offset, scale, splits, s);
    case 1:
      return (int)dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, dout, l, d, dq, dk, dv, B, Sq,
                                             Skv, Hq, Hkv, causal, window, q_offset, scale,
                                             splits, s);
    case 2:
      return (int)dispatch_hd<__half>(hd, q, k, v, out, dout, l, d, dq, dk, dv, B, Sq, Skv, Hq,
                                      Hkv, causal, window, q_offset, scale, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
