// Paged decode attention, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/kernel.py::paged_decode_attention_kernel_call
//   (body _paged_kernel, pl.pallas_call at kernel.py:234).
//
// Computes single-token GQA attention for every batch row b: the query
// q [B, Hq, hd] against a global page pool k/v [P, ps, Hkv, hd] reached
// through a page table [B, n_pt] (int32, -1 = unmapped).  The logical
// position of table entry (j, t) is j*ps + t.  An entry is kept iff its page
// is mapped, pos <= q_pos[b] and, with a window, pos > q_pos[b] - window.
// Softmax in f32 with scale hd^-0.5; the output has q's dtype.
//
// What bounds it on an H100: bytes.  Each row reads its mapped K/V pages once
// (gemma-2b: Hkv = 1, hd = 256, so one page of one head is 16 x 256 x 2 B =
// 8 KB of K plus 8 KB of V) and does 4 flops per byte read, far below the
// ~295 flop/byte ridge of the card.  At serving sizes (B = 8) the call is
// launch-bound: it moves a few MB, which the card streams in microseconds.
//
// Design (simple first): one CTA per (kv-head, row).  The TPU kernel gets
// the table by scalar prefetch; Hopper has none, so the CTA reads its own
// table row and q_pos[b] from device memory and walks only the pages that
// can hold kept entries: those up to q_pos[b] / ps, from the window's first
// page on, skipping unmapped ones.  Skipping is exact for every live row:
// logical page 0 is always mapped for a live row, and the online softmax
// wipes a fully masked page with corr = exp(-1e30 - m) = 0 anyway.  Each
// page's K and V rows for this head are staged in shared memory, the
// G = Hq / Hkv query heads are scored by warps (one warp-reduced dot product
// per (head, token)), and the online softmax state and the [G, hd]
// accumulator stay in f32 in shared memory.  A row that visits no page (an
// idle serving slot: nothing mapped) keeps no entry, and the plain version's
// softmax over all-masked scores is then uniform over every entry its table
// gathers (unmapped pages read as page 0): the row writes that mean of V, so
// that what an idle row feeds the layers after attention is the plain
// version's.  A MoE FFN routes idle rows too, and they compete with the live
// rows for expert capacity.
//
// What this leaves on the table: only B * Hkv CTAs run (8 of 132 SMs at the
// serving shape), each walking its pages one after another with no overlap
// of the next page's load with this page's math.  Split-K over pages with a
// combine pass, cp.async / TMA double buffering and wgmma are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;     // 227 KB a block may opt in to
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

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Stage one page's rows of kv-head h (ps rows of hd elements, row stride
// Hkv * hd) into dst [ps, hd].  16-byte vectors when the caller proved the
// pool and the rows aligned.
template <typename T>
__device__ __forceinline__ void stage_page(T* __restrict__ dst, const T* __restrict__ pool,
                                           long long page, int h, int ps, int Hkv, int hd,
                                           bool vec) {
  const T* src = pool + (page * ps * Hkv + h) * (long long)hd;
  const long long row_stride = (long long)Hkv * hd;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int per_row = hd / V;
    for (int i = threadIdx.x; i < ps * per_row; i += blockDim.x) {
      const int t = i / per_row, c = i - t * per_row;
      reinterpret_cast<uint4*>(dst + t * hd)[c] =
          reinterpret_cast<const uint4*>(src + t * row_stride)[c];
    }
  } else {
    for (int i = threadIdx.x; i < ps * hd; i += blockDim.x) {
      const int t = i / hd, d = i - t * hd;
      dst[t * hd + d] = src[t * row_stride + d];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int32_t* __restrict__ table,
                    const int32_t* __restrict__ q_pos, T* __restrict__ out, int Hq, int Hkv,
                    int hd, int P, int ps, int n_pt, int window, float scale, bool vec) {
  const int h = blockIdx.x;   // kv head
  const int b = blockIdx.y;   // batch row
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);   // [G, hd], pre-scaled
  float* acc_s = q_s + G * hd;                   // [G, hd]
  float* s_s = acc_s + G * hd;                   // [G, ps] scores, then probabilities
  float* m_s = s_s + G * ps;                     // [G] running max
  float* l_s = m_s + G;                          // [G] running denominator
  float* corr_s = l_s + G;                       // [G] this page's rescale
  const size_t f32_bytes = align16(sizeof(float) * (2 * G * hd + G * ps + 3 * G));
  T* k_s = reinterpret_cast<T*>(smem + f32_bytes);                       // [ps, hd]
  T* v_s = reinterpret_cast<T*>(smem + f32_bytes + align16(sizeof(T) * ps * hd));

  const T* q_row = q + ((long long)b * Hq + (long long)h * G) * hd;
  for (int i = tid; i < G * hd; i += blockDim.x) {
    q_s[i] = to_f32(q_row[i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const int qp = q_pos[b];
  const int32_t* tbl = table + (long long)b * n_pt;
  int last = qp < 0 ? -1 : qp / ps;
  if (last > n_pt - 1) last = n_pt - 1;
  int first = 0;
  if (window > 0) {
    const int lo = qp - window + 1;   // oldest kept position
    first = lo > 0 ? lo / ps : 0;
  }
  __syncthreads();

  for (int j = first; j <= last; ++j) {
    const int page = tbl[j];
    if (page < 0 || page >= P) continue;   // uniform across the CTA
    stage_page(k_s, k_pages, page, h, ps, Hkv, hd, vec);
    stage_page(v_s, v_pages, page, h, ps, Hkv, hd, vec);
    __syncthreads();

    // scores: one warp-reduced dot product per (query head, token)
    for (int pair = warp; pair < G * ps; pair += n_warps) {
      const int g = pair / ps, t = pair - g * ps;
      const float* qg = q_s + g * hd;
      const T* kt = k_s + t * hd;
      float dot = 0.f;
      for (int d = lane; d < hd; d += 32) dot += qg[d] * to_f32(kt[d]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) {
        const int pos = j * ps + t;
        bool keep = pos <= qp;
        if (window > 0) keep = keep && pos > qp - window;
        s_s[pair] = keep ? dot : kNegInf;
      }
    }
    __syncthreads();

    // online softmax update, one thread per query head
    for (int g = tid; g < G; g += blockDim.x) {
      float* sg = s_s + g * ps;
      const float m_prev = m_s[g];
      float m_new = m_prev;
      for (int t = 0; t < ps; ++t) m_new = fmaxf(m_new, sg[t]);
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float p = expf(sg[t] - m_new);
        sg[t] = p;
        sum += p;
      }
      const float corr = expf(m_prev - m_new);
      corr_s[g] = corr;
      l_s[g] = l_s[g] * corr + sum;
      m_s[g] = m_new;
    }
    __syncthreads();

    // acc[g, d] = acc[g, d] * corr[g] + sum_t p[g, t] * v[t, d]
    for (int i = tid; i < G * hd; i += blockDim.x) {
      const int g = i / hd, d = i - g * hd;
      const float* pg = s_s + g * ps;
      float a = acc_s[i] * corr_s[g];
      for (int t = 0; t < ps; ++t) a += pg[t] * to_f32(v_s[t * hd + d]);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  T* o_row = out + ((long long)b * Hq + (long long)h * G) * hd;
  if (l_s[0] == 0.f) {
    // no page visited (a visited page adds at least exp(0) = 1 to l): the
    // mean of V over all n_pt * ps gathered entries, split over the threads
    __shared__ float red[kThreads];
    const int n = n_pt * ps;
    const int cols = hd < (int)blockDim.x ? hd : (int)blockDim.x;
    const int parts = blockDim.x / cols;
    const int c = tid % cols, part = tid / cols;
    for (int d0 = 0; d0 < hd; d0 += cols) {
      float a = 0.f;
      if (part < parts && d0 + c < hd) {
        for (int e = part; e < n; e += parts) {
          const int j = e / ps, t = e - j * ps;
          const long long page = tbl[j] < 0 ? 0 : tbl[j];
          if (page < P) a += to_f32(v_pages[((page * ps + t) * Hkv + h) * (long long)hd + d0 + c]);
        }
      }
      red[tid] = a;
      __syncthreads();
      if (part == 0 && d0 + c < hd) {
        float sum = 0.f;
        for (int p = 0; p < parts; ++p) sum += red[p * cols + c];
        const T val = from_f32<T>(sum / (float)n);
        for (int g = 0; g < G; ++g) o_row[g * hd + d0 + c] = val;
      }
      __syncthreads();
    }
    return;
  }
  for (int i = tid; i < G * hd; i += blockDim.x) {
    const float l = fmaxf(l_s[i / hd], 1e-30f);
    o_row[i] = from_f32<T>(acc_s[i] / l);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int32_t* table, const int32_t* q_pos, void* out, int B, int Hq,
                   int Hkv, int hd, int P, int ps, int n_pt, int window, float scale,
                   cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = align16(sizeof(float) * (2 * G * hd + G * ps + 3 * G)) +
                      2 * align16(sizeof(T) * ps * hd);
  if (smem + sizeof(float) * kThreads > kMaxSmem) return cudaErrorInvalidValue;
  if (smem + sizeof(float) * kThreads > kDefaultSmem) {   // the static red[] counts too
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  constexpr int V = 16 / sizeof(T);
  const bool vec = hd % V == 0 && reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
  dim3 grid(Hkv, B);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), table, q_pos, static_cast<T*>(out), Hq, Hkv, hd, P,
      ps, n_pt, window, scale, vec);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  window <= 0: no window.
// Returns the launch's cudaError_t (0 on success); launches on `stream` and
// does not synchronise.
extern "C" int paged_decode_attention(const void* q, const void* k_pages,
                                      const void* v_pages, const int32_t* table,
                                      const int32_t* q_pos, void* out, int dtype, int B,
                                      int Hq, int Hkv, int hd, int P, int ps, int n_pt,
                                      int window, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || hd <= 0 || ps <= 0 || n_pt <= 0 ||
      P <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(q, k_pages, v_pages, table, q_pos, out, B, Hq, Hkv, hd, P,
                                ps, n_pt, window, scale, s);
    case 1:
      return (int)launch<__nv_bfloat16>(q, k_pages, v_pages, table, q_pos, out, B, Hq, Hkv,
                                        hd, P, ps, n_pt, window, scale, s);
    case 2:
      return (int)launch<__half>(q, k_pages, v_pages, table, q_pos, out, B, Hq, Hkv, hd, P,
                                 ps, n_pt, window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
