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
// MB, ~1.3 us at 3.35 TB/s.  Neither is reachable at this size: 64 query
// tiles of 64 rows are too few to fill 132 SMs, so the heaviest tile's
// walk over its KV steps sets the time (what limits a step: below).
//
// Two kernels, chosen by dtype in the C entry point (never a fallback):
//
// bf16 / fp16: tensor cores (flash_fwd_mma).  FA2's shape with mma.sync:
//   * one CTA of 4 warps per (query tile, query head, batch row), in two
//     shapes chosen by the grid's size:
//       - 64-row tiles, warp w owning query rows 16w .. + 15 for the whole
//         walk, when 64-row tiles alone fill the SMs (long prompts);
//       - 32-row tiles otherwise (short prompts: 512 tokens of gemma give
//         only 64 tiles of 64 rows for 132 SMs): warp w owns rows
//         16 (w % 2) .. + 15 and, of every 64-key KV tile, the keys
//         32 (w / 2) .. + 31, and the two warps of a row block merge their
//         online-softmax states once at the end (through shared memory, in
//         a fixed order).  Twice the CTAs, each spending half the ldmatrix
//         reads per KV tile; on long prompts the doubled K / V copies per
//         query row cost more than that gains;
//   * tiles stay in the input dtype in shared memory, rows padded by 16
//     bytes so the 8 row addresses of every ldmatrix hit distinct banks.
//     Q is loaded once; K and V tiles of 64 keys go through a two-stage
//     cp.async ring, so tile j+1 loads while tile j computes.  At hd 256
//     that is 17 or 33 KB of Q plus 2 x 66 KB of K and V (dynamic shared
//     memory);
//   * S = Q K^T and O += P V on mma.sync.m16n8k16 (bf16 / fp16 in, f32
//     accumulate), operands by ldmatrix (V with .trans).  Q's fragments
//     are re-read from shared memory at every k-step instead of held in
//     registers: at hd 256 a warp's O accumulator alone is 128 registers a
//     thread;
//   * the online softmax runs in the mma's accumulator layout: a thread
//     holds two rows (g, g + 8) x 2 columns per 8-key block; the row max
//     is a quad shuffle, the row sum stays per thread until the end.  P is
//     rounded to the input dtype (as the plain version rounds it before
//     its P.V) and becomes the A fragment of P.V straight from registers;
//   * the grid's slowest dimension is the query tile, walked heaviest
//     first (tile = gridDim.z - 1 - blockIdx.z), so the long causal tiles
//     start before the short ones;
//   * the output is staged in the warp's own Q rows and written as 16-byte
//     vectors.
// mma.sync rather than wgmma: a wgmma consumer needs 64-row warpgroup
// tiles fed from shared memory through TMA descriptors and an mbarrier
// ring, far more to get right without a compiler at hand; mma.sync with
// cp.async is the simple tensor-core kernel, and wgmma is later work.
// What it leaves on the table: every operand passes through ldmatrix, so
// at hd 256 a 64-row tile's KV step costs its SM 576 ldmatrix.x4 (Q
// re-read, K and V by each of 4 warps: ~295 KB of shared-memory reads) for
// 4.2 MFLOP, which caps it near 44% of the tensor-core peak before any
// latency.  Measured on an H100: twice the warps on one 64-row tile left
// the time as it was; the 32-row form (half the reads per SM per KV step,
// twice the SMs) cut a 512-token prompt by a quarter.  wgmma, which reads
// its B operand from shared memory once per warpgroup, is the way past it.
//
// f32: the SIMT kernel (flash_fwd_simt), unchanged from the first port:
// TF32 tensor cores keep ~3 digits, short of the 2e-5 bar of the f32
// checks.  One CTA of 256 threads per (64-row query tile, query head, batch
// row); Q (pre-scaled) and 32-key K / V tiles in shared memory as f32,
// rows padded by one word; each thread owns two query rows and a strided
// eighth of the keys and of the head dimension; warp w runs the online
// softmax of rows 8w..8w+7 with one key per lane.
//
// Head dims: hd is any of 1 .. 256.  The template width HD is the least of
// 16, 32, 64, 128, 256 that holds hd (120 -> 128, h2o-danube3-4b's heads),
// and the true hd is the row stride of q, k, v and out in memory: rows are
// copied as hd elements, the tiles' columns hd .. HD - 1 are zero in shared
// memory (cp.async zero fill, or zero stores in the SIMT form), so the padded
// k-steps of Q K^T add exact zeros, and the padded output columns are never
// stored.  The scale stays the caller's hd^-0.5.  The tensor-core form needs
// 16-byte rows (hd a multiple of 8 in bf16 / fp16); any other hd in bf16 /
// fp16 takes the SIMT form, padded the same way.  The tensor-core kernel is
// instantiated twice per width: PAD = false when hd == HD (the row width a
// compile-time constant, no column predicates) and PAD = true otherwise.
//
// Latent attention (MLA, moonlight-16b-a3b): q and k heads of 192 (128 +
// 64 rope dims), v and output heads of 128.  The tensor-core kernel takes a
// second width DV for V and O (DV = HD for every other call, whose code is
// as before): it is instantiated at (HD, DV) = (192, 128), bf16 / fp16, with
// no padded width: Q K^T runs 12 k-steps, P V 16 output blocks, and V's
// shared rows are 128 + 8 wide (Q + 2 x (K, V) = 111 KB at 64-row tiles).
// The scale is the caller's, 192^-0.5.  No SIMT form: f32 and other pairs
// are refused.
//
// Both kernels optionally write each row's log-sum-exp, lse = m + log l
// (natural log, f32 [B, Hq, Sq]), for the backward pass (flash_bwd.cu): it
// recomputes the probabilities as exp(s - lse) without a second softmax.
// A null lse pointer (the serving call) writes nothing.
//
// Both kernels: the KV walk is bounded by the tile's causal and window
// limits, so a fully masked KV tile is never loaded (the TPU kernel skips
// its math but still issues its DMA, kernel.py:15-19); ragged Sq and Skv
// (wave prompts of 97 or 333 tokens tile nothing) are masked inside the
// kernel: rows past Sq are computed but not stored, keys past Skv are
// loaded as zeros and masked.  A masked score contributes exactly 0 (the
// reference's exp(-1e30 - m)).  Rows with no kept key write zeros; no
// ported path has such a row (a causal row with q_offset >= 0 keeps its
// own key).  No atomics: every output is summed by one thread in a fixed
// order, so every call gives the same bits.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

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
flash_fwd_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ out, float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv,
               int hd, int causal, int window, int q_offset, float scale) {
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
  const long long q_row = (long long)Hq * hd;     // sequence stride of q / out
  const long long kv_row = (long long)Hkv * hd;   // sequence stride of k / v
  const T* qb = q + (long long)b * Sq * q_row + (long long)hq * hd;
  const T* kb = k + (long long)b * Skv * kv_row + (long long)hk * hd;
  const T* vb = v + (long long)b * Skv * kv_row + (long long)hk * hd;

  // columns hd .. HD - 1 stay zero
  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    q_s[r * LD + d] = q0 + r < Sq && d < hd ? to_f32(qb[(q0 + r) * q_row + d]) * scale : 0.f;
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
      const bool in = k0 + r < Skv && d < hd;
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
    if (lse != nullptr && tx == 0)
      lse[((long long)b * Hq + hq) * Sq + q0 + r] = m_s[r] + logf(den);
    T* o = out + ((long long)b * Sq + q0 + r) * q_row + (long long)hq * hd;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      if (tx + 8 * j < hd) o[tx + 8 * j] = from_f32<T>(acc[rr][j] / den);
  }
}

template <typename T, int HD>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* out, float* lse,
                        int B, int Sq, int Skv, int Hq, int Hkv, int hd, int causal, int window,
                        int q_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static_assert(smem <= kMaxSmem, "tiles do not fit in shared memory");
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_simt<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_simt<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, Sq, Skv, Hq, Hkv, hd, causal, window, q_offset, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 / fp16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kTcBK = 64;        // keys per K / V tile
constexpr int kTcThreads = 128;  // 4 warps: (row block, key part)
constexpr int kTcPad = 8;        // elements (16 bytes) of padding per shared row

// RB row blocks of 16 query rows per CTA (4 or 2); the 4 warps split each
// KV tile's keys into KS = 4 / RB parts of KW keys.  HD is the width of q
// and k, DV that of v and the output (DV = HD but for latent attention).
template <int HD, int RB, int DV = HD> struct TcTile {
  static constexpr int BQ = 16 * RB;                           // query rows per CTA
  static constexpr int KS = 4 / RB, KW = kTcBK / KS;
  static constexpr int LD = HD + kTcPad;                       // shared row, elements
  static constexpr int LDV = DV + kTcPad;                      // shared row of V
  static constexpr int CPR = HD / 8;                           // 16-byte chunks per row
  static constexpr int CPRV = DV / 8;                          // the same of a V row
  static constexpr int QELEMS = BQ * LD;                       // the Q tile
  static constexpr int ELEMS = kTcBK * LD;                     // one K tile
  static constexpr int VELEMS = kTcBK * LDV;                   // one V tile
  static constexpr size_t SMEM = size_t(QELEMS + 2 * (ELEMS + VELEMS)) * 2;  // Q + 2 x (K, V)
  // the key parts' merge reuses the K / V area: O, m and l as f32
  static_assert(sizeof(float) * (RB * (DV / 8) * 4 * 32 + RB * 2 * 2 * 32) <=
                    2 * (ELEMS + VELEMS) * 2,
                "the merge fits in the K / V area");
};

// One CTA per (query head, batch row, query tile), 4 warps.  Scores are
// kept in the log2 domain: s * scale * log2(e), so exp2 gives the softmax.
// hd_arg is read only when PAD (hd < HD); else hd is the constant HD.  v and
// the output are DV wide (latent attention: DV < HD, and PAD is false).
template <typename T, int HD, int RB, bool PAD, int DV = HD>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ out, float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv,
              int hd_arg, int causal, int window, int q_offset, float scale_log2) {
  using TT = TcTile<HD, RB, DV>;
  static_assert(DV == HD || !PAD, "a narrower v is instantiated at exact widths only");
  const int hd = PAD ? hd_arg : HD;
  const int dv = DV == HD ? hd : DV;                 // width of a v / output row
  constexpr int LD = TT::LD, LDV = TT::LDV, CPR = TT::CPR, BQ = TT::BQ, KW = TT::KW;
  constexpr int NS = KW / 8;         // 8-key blocks of a warp's scores
  constexpr int NO = DV / 8;         // 8-column blocks of the output
  const int hq = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;          // heaviest causal tiles first
  const int hk = hq / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp % RB, kh = warp / RB;          // row block, key part
  const int g = lane >> 2, t4 = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);           // [BQ][LD]
  T* kv_s = q_s + TT::QELEMS;                        // stage s: K at 2s, V at 2s + 1

  const int q0 = qt * BQ;
  const int cpt = hd / 8;                            // 16-byte chunks of a true row
  const long long q_row = (long long)Hq * hd;        // sequence stride of q / out
  const long long kv_row = (long long)Hkv * hd;      // sequence stride of k / v
  const long long v_row = DV == HD ? kv_row : (long long)Hkv * DV;
  const long long o_row = DV == HD ? q_row : (long long)Hq * DV;
  const T* qb = q + (long long)b * Sq * q_row + (long long)hq * hd;
  const T* kb = k + (long long)b * Skv * kv_row + (long long)hk * hd;
  const T* vb = v + (long long)b * Skv * v_row + (long long)hk * dv;

  // chunks cpt .. CPR - 1 (the padded columns) are zero filled
  for (int i = tid; i < BQ * CPR; i += kTcThreads) {
    const int r = i / CPR, c = i - r * CPR;
    const bool ok = q0 + r < Sq && (!PAD || c < cpt);
    cp_async16(smem_u32(q_s + r * LD + c * 8), qb + chunk_off<PAD>(ok, (q0 + r) * q_row, c), ok);
  }

  // the keys any row of this tile can keep
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + BQ, Sq) - 1;
  int k_end = Skv;
  if (causal) k_end = min(k_end, q_hi + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_lo - window + 1);
  k_begin = (k_begin / kTcBK) * kTcBK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kTcBK - 1) / kTcBK : 0;

  auto load_kv = [&](int tile, int stage) {
    const int k0 = k_begin + tile * kTcBK;
    T* ks = kv_s + stage * (TT::ELEMS + TT::VELEMS);
    T* vs = ks + TT::ELEMS;
    for (int i = tid; i < kTcBK * CPR; i += kTcThreads) {
      const int r = i / CPR, c = i - r * CPR;
      const bool ok = k0 + r < Skv && (!PAD || c < cpt);
      const long long off = chunk_off<PAD>(ok, (k0 + r) * kv_row, c);
      cp_async16(smem_u32(ks + r * LD + c * 8), kb + off, ok);
      if constexpr (DV == HD) cp_async16(smem_u32(vs + r * LD + c * 8), vb + off, ok);
    }
    if constexpr (DV != HD) {
      for (int i = tid; i < kTcBK * TT::CPRV; i += kTcThreads) {
        const int r = i / TT::CPRV, c = i - r * TT::CPRV;
        const bool ok = k0 + r < Skv;
        cp_async16(smem_u32(vs + r * LDV + c * 8), vb + chunk_off<false>(ok, (k0 + r) * v_row, c),
                   ok);
      }
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int qp0 = q_offset + q0 + wr * 16 + g;       // positions of this thread's rows
  const int qp1 = qp0 + 8;

  // ldmatrix row addresses of this lane (see the fragment layouts of
  // mma.m16n8k16): Q as A (rows 16 wr + lane % 16, column half lane / 16);
  // K as B of two 8-key blocks (key lane % 8 + 8 (lane / 16), column half
  // (lane / 8) % 2); V as B of two 8-column blocks through .trans (key
  // lane % 8 + 8 ((lane / 8) % 2), column half lane / 16); keys from the
  // warp's part on
  const uint32_t q_addr = smem_u32(q_s + (wr * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  const int k_off = (kh * KW + (lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
  const int v_off = (kh * KW + (lane & 7) + (((lane >> 3) & 1) << 3)) * LDV + (lane >> 4) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();               // tile it has landed; every warp is done with it - 1
    if (it + 1 < n_tiles) load_kv(it + 1, (it + 1) & 1);
    cp_async_commit();
    const T* ks = kv_s + (it & 1) * (TT::ELEMS + TT::VELEMS);
    const uint32_t k_base = smem_u32(ks + k_off);
    const uint32_t v_base = smem_u32(ks + TT::ELEMS + v_off);

    // S = Q K^T
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, q_addr + kk * 32);
#pragma unroll
      for (int nn = 0; nn < NS / 2; ++nn) {
        uint32_t bf[4];
        ldsm_x4(bf, k_base + (nn * 16 * LD + kk * 16) * 2);
        mma16816<T>(s[2 * nn], a, bf[0], bf[1]);
        mma16816<T>(s[2 * nn + 1], a, bf[2], bf[3]);
      }
    }

    // mask, online softmax (row max over the quad that shares a row)
    const int k0 = k_begin + it * kTcBK + kh * KW;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + j * 8 + 2 * t4 + (e & 1);
        const int qp = e < 2 ? qp0 : qp1;
        bool keep = kp < Skv;
        if (causal) keep = keep && kp <= qp;
        if (window > 0) keep = keep && kp > qp - window;
        s[j][e] = keep ? s[j][e] * scale_log2 : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = s[j][e] == kNegInf ? 0.f : exp2f(s[j][e] - m[e >> 1]);
        s[j][e] = pe;
        l[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // O += P V, P rounded to T as the A fragment, straight from registers
#pragma unroll
    for (int kk = 0; kk < KW / 16; ++kk) {
      const uint32_t a[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                             pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                             pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nn = 0; nn < NO / 2; ++nn) {
        uint32_t bf[4];
        ldsm_x4_t(bf, v_base + (kk * 16 * LDV + nn * 16) * 2);
        mma16816<T>(o[2 * nn], a, bf[0], bf[1]);
        mma16816<T>(o[2 * nn + 1], a, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();                 // no copy in flight (n_tiles may be 0), K / V free

  // merge the key parts: the second part's warps leave (m, l, O) in the
  // K / V area, thread by thread, and the first part's add them in
  if constexpr (TT::KS == 2) {
    float* xo = reinterpret_cast<float*>(kv_s);        // [RB][NO][4][32]
    float* xm = xo + RB * NO * 4 * 32;                 // [RB][2 (m, l)][2][32]
    if (kh == 1) {
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) xo[((wr * NO + j) * 4 + e) * 32 + lane] = o[j][e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        xm[((wr * 2 + 0) * 2 + r) * 32 + lane] = m[r];
        xm[((wr * 2 + 1) * 2 + r) * 32 + lane] = l[r];
      }
    }
    __syncthreads();
    if (kh == 1) return;
    float c0[2], c1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = xm[((wr * 2 + 0) * 2 + r) * 32 + lane];
      const float l1 = xm[((wr * 2 + 1) * 2 + r) * 32 + lane];
      const float mt = fmaxf(m[r], m1);
      c0[r] = exp2f(m[r] - mt);
      c1[r] = exp2f(m1 - mt);
      l[r] = l[r] * c0[r] + l1 * c1[r];
      m[r] = mt;
    }
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[j][e] = o[j][e] * c0[e >> 1] + xo[((wr * NO + j) * 4 + e) * 32 + lane] * c1[e >> 1];
  }

  // normalise; stage the warp's 16 rows in its own Q rows (no other warp
  // reads them now), then write them as 16-byte vectors
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    inv[r] = 1.f / fmaxf(lr, 1e-30f);
    // m is in the log2 domain (scores times log2 e): lse = m ln 2 + ln l
    const int row = q0 + wr * 16 + g + 8 * r;
    if (lse != nullptr && t4 == 0 && row < Sq)
      lse[((long long)b * Hq + hq) * Sq + row] =
          m[r] * 0.6931471805599453f + logf(fmaxf(lr, 1e-30f));
  }
  __syncwarp();
  T* o_s = q_s + wr * 16 * LD;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = j * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(o_s + g * LD + c) = pack2<T>(o[j][0] * inv[0], o[j][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(o_s + (g + 8) * LD + c) =
        pack2<T>(o[j][2] * inv[1], o[j][3] * inv[1]);
  }
  __syncwarp();
  const int cpo = DV == HD ? cpt : DV / 8;           // 16-byte chunks of an output row
  for (int i = lane; i < 16 * cpo; i += 32) {
    const int r = i / cpo, c = i - r * cpo;
    const int row = q0 + wr * 16 + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(out + ((long long)b * Sq + row) * o_row + (long long)hq * dv +
                                c * 8) = *reinterpret_cast<const uint4*>(o_s + r * LD + c * 8);
  }
}

template <typename T, int HD, int RB, bool PAD, int DV = HD>
cudaError_t launch_mma_rb(const void* q, const void* k, const void* v, void* out, float* lse,
                          int B, int Sq, int Skv, int Hq, int Hkv, int hd, int causal, int window,
                          int q_offset, float scale, cudaStream_t stream) {
  using TT = TcTile<HD, RB, DV>;
  constexpr size_t smem = TT::SMEM;
  static_assert(smem <= kMaxSmem, "tiles do not fit in shared memory");
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma<T, HD, RB, PAD, DV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int n_qt = (Sq + TT::BQ - 1) / TT::BQ;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  dim3 grid(Hq, B, n_qt);
  flash_fwd_mma<T, HD, RB, PAD, DV><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, Sq, Skv, Hq, Hkv, hd, causal, window, q_offset,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// 64-row tiles when they alone fill the card's SMs, else 32-row tiles
template <typename T, int HD, bool PAD, int DV = HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, float* lse,
                       int B, int Sq, int Skv, int Hq, int Hkv, int hd, int causal, int window,
                       int q_offset, float scale, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if ((long long)((Sq + 63) / 64) * Hq * B >= sms)
    return launch_mma_rb<T, HD, 4, PAD, DV>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, hd, causal,
                                            window, q_offset, scale, stream);
  return launch_mma_rb<T, HD, 2, PAD, DV>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, hd, causal,
                                          window, q_offset, scale, stream);
}

// latent attention's widths: q / k of kMlaHD (128 + 64 rope), v of kMlaDV
constexpr int kMlaHD = 192, kMlaDV = 128;

// f32, or an hd that is not a multiple of 8 -> the SIMT kernel; bf16 /
// fp16 in 16-byte rows -> the tensor-core kernel (uses_mma)
bool uses_mma(int dtype, int hd) { return dtype != 0 && hd % 8 == 0; }

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                   int Sq, int Skv, int Hq, int Hkv, int hd, int causal, int window, int q_offset,
                   float scale, cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    if (hd == HD)
      return launch_mma<T, HD, false>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, hd, causal, window,
                                      q_offset, scale, s);
    if (hd % 8 == 0)
      return launch_mma<T, HD, true>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, hd, causal, window,
                                     q_offset, scale, s);
  }
  return launch_simt<T, HD>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, hd, causal, window, q_offset,
                            scale, s);
}

// the least instantiated width that holds hd
template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, void* out,
                        float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                        int window, int q_offset, float scale, cudaStream_t s) {
#define FLASH_FWD_HD(HD)                                                                       \
  if (hd <= HD)                                                                                \
    return launch<T, HD>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, hd, causal, window, q_offset, \
                         scale, s);
  if (hd < 1) return cudaErrorInvalidValue;
  FLASH_FWD_HD(16)
  FLASH_FWD_HD(32)
  FLASH_FWD_HD(64)
  FLASH_FWD_HD(128)
  FLASH_FWD_HD(256)
#undef FLASH_FWD_HD
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// v narrower than q / k: the tensor-core kernel at latent attention's widths
// alone (bf16 / fp16, hd = kMlaHD, dv = kMlaDV)
template <typename T>
cudaError_t dispatch_split(int hd, int dv, const void* q, const void* k, const void* v,
                           void* out, float* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                           int causal, int window, int q_offset, float scale, cudaStream_t s) {
  if (hd != kMlaHD || dv != kMlaDV) return cudaErrorInvalidValue;
  return launch_mma<T, kMlaHD, false, kMlaDV>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, hd, causal,
                                              window, q_offset, scale, s);
}

}  // namespace

// dtype: 0 = float32 (SIMT kernel), 1 = bfloat16, 2 = float16 (tensor-core
// kernel where hd is a multiple of 8, q, k, v and out then 16-byte aligned;
// else the SIMT kernel).  hd in 1 .. 256.  dv: the width of v and out, hd
// but for latent attention's (hd, dv) = (192, 128), bf16 / fp16 only.
// q [B, Sq, Hq, hd], k [B, Skv, Hkv, hd], v [B, Skv, Hkv, dv], out
// [B, Sq, Hq, dv], all contiguous.  lse: null,
// or f32 [B, Hq, Sq] that receives each row's log-sum-exp of its scaled
// scores (the training forward).  causal: 0 or 1; window <= 0: no window.
// Returns the launch's cudaError_t (0 on success); launches on `stream` and
// does not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int dtype, int B, int Sq, int Skv, int Hq,
                                   int Hkv, int hd, int dv, int causal, int window, int q_offset,
                                   float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv < 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || B > 65535 ||
      Hq > 65535 || (dv != hd && !uses_mma(dtype, hd)))
    return (int)cudaErrorInvalidValue;
  if (uses_mma(dtype, hd) && !(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out)))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dv != hd)
    return (int)(dtype == 1 ? dispatch_split<__nv_bfloat16>(hd, dv, q, k, v, out, l, B, Sq, Skv,
                                                            Hq, Hkv, causal, window, q_offset,
                                                            scale, s)
                            : dispatch_split<__half>(hd, dv, q, k, v, out, l, B, Sq, Skv, Hq,
                                                     Hkv, causal, window, q_offset, scale, s));
  switch (dtype) {
    case 0:
      return (int)dispatch_hd<float>(hd, q, k, v, out, l, B, Sq, Skv, Hq, Hkv, causal, window,
                                     q_offset, scale, s);
    case 1:
      return (int)dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, l, B, Sq, Skv, Hq, Hkv, causal,
                                             window, q_offset, scale, s);
    case 2:
      return (int)dispatch_hd<__half>(hd, q, k, v, out, l, B, Sq, Skv, Hq, Hkv, causal, window,
                                      q_offset, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
