// Dense-cache decode attention, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/kernel.py::decode_attention_kernel_call
//   (body _kernel, pl.pallas_call at kernel.py:106).
//
// Computes single-token GQA attention for every batch row b: the query
// q [B, Hq, hd] against a dense (linear or ring) cache k/v [B, S, Hkv, hd]
// whose entries carry absolute positions kv_pos.  Two forms, one kernel:
//   * shared:  kv_pos [S],    q_pos []   (the wave engine's cache);
//   * per-row: kv_pos [B, S], q_pos [B]  (the slot engine's cache);
// the shared form is the per-row one with a batch stride of 0.  An entry is
// kept iff kv_pos >= 0, kv_pos <= q_pos and, with a window, kv_pos >
// q_pos - window.  Softmax in f32 with scale hd^-0.5; the output has q's
// dtype.  A row with no kept entry over its whole cache writes what the
// plain version's softmax over all-masked scores gives it: the uniform mean
// of V over all S entries of its (row, KV head), shared by its G query
// heads (the repair B1 received for its unmapped rows).
//
// What bounds it on an H100: bytes.  Each row reads the K/V entries it keeps
// once (gemma-2b: Hkv = 1, hd = 256, so one entry is 512 B of K plus 512 B
// of V) and does 4 * G flops per K/V element pair, ~8 flop/byte at G = 8,
// far below the card's ~295 flop/byte ridge.  At serving sizes (B = 8,
// 1024 entries) the call moves a few MB and is bound by its launches.
//
// Design (simple first; each CTA makes as few dependent trips to device
// memory as it can, because a decode call is too small to hide them):
//   * split-K over the cache: grid (n_split, Hkv, B), one CTA per chunk of
//     kChunk entries of one (row, KV head), so B * Hkv * n_split CTAs fill
//     the card where one CTA per row would leave 124 of 132 SMs idle;
//   * a CTA reads its chunk's positions and the G query heads first; a chunk
//     with no kept entry (empty slots, the future, outside the window) stops
//     there.  Skipping is exact: the reference gives such entries
//     exp(-1e30 - m) = 0;
//   * otherwise the CTA stages the kept entries' K and V rows in shared
//     memory in one go (16-byte loads, all in flight together; rows padded
//     so the row-wise reads below do not collide in a bank);
//   * scores: warp w serves query heads w, w+8, ...; each lane owns whole
//     entries (lane and lane+32), so a dot product is a plain FMA loop, and
//     the chunk's softmax is one shuffle max and one shuffle sum per head;
//   * P.V: lanes own slices of the head dimension and walk the chunk's
//     entries, each probability broadcast by a shuffle;
//   * a second launch combines the splits in a fixed order (no atomics), so
//     the result is the same bit for bit on every run;
//   * a chunk that keeps nothing also reads the row's positions once more
//     (one trip, off the critical path of the chunks that do keep entries)
//     to learn whether the row keeps anything at all.  Only if it keeps
//     nothing does the chunk read its V rows and write their column sums in
//     place of its accumulator; the combine pass then adds those sums in
//     split order and divides by S.  Live rows take the path above
//     unchanged.
// What this leaves on the table: the two dependent trips (positions, then
// K/V) and the combine launch; the products run on the CUDA cores.  TMA
// staging, tensor-core dots and one launch are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kChunk = 64;     // cache entries per CTA (two per lane for the scores)
constexpr int kMaxWarps = 8;   // threads per CTA: 32 x min(G, 8)
constexpr int kPad = 16;       // bytes of padding per staged row
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// N consecutive values as one aligned load (16 bytes at most per access).
template <typename T, int N>
struct alignas((sizeof(T) * N) >= 16 ? 16 : (sizeof(T) * N)) Vec {
  T x[N];
};

// Values per lane and lanes in use for a head dimension in the P.V phase:
// hd / 32 values on all 32 lanes, or one value on each of the first hd lanes
// when hd < 32.
template <int HD> struct LaneMap {
  static constexpr int VPL = HD >= 32 ? HD / 32 : 1;
  static constexpr int LANES = HD / VPL;
};

template <typename T, int HD> struct Tile {
  static constexpr int EPV = 16 / sizeof(T);                 // elements per 16-byte vector
  static constexpr int VPR = HD / EPV;                       // vectors per row
  static constexpr int LD = HD + kPad / sizeof(T);           // staged row, in elements
};

template <typename T, int HD>
constexpr size_t smem_bytes(int G) {
  return 2 * size_t(kChunk) * Tile<T, HD>::LD * sizeof(T)    // K, V rows
         + sizeof(float) * size_t(G) * HD                    // scaled queries
         + sizeof(int) * kChunk;                             // keep flags
}

__device__ __forceinline__ bool keeps(int p, int qp, int window) {
  return p >= 0 && p <= qp && (window <= 0 || p > qp - window);
}

// Column sums of V over entries [s0, s1) of one (row, KV head), in entry
// order per warp and then in warp order, into vsum[HD] (shared, f32).  The
// K/V staging area `scratch` (>= n_warps * HD floats) holds the warps'
// partial sums.  Every thread of the CTA calls it.
template <typename T, int HD>
__device__ void v_column_sums(const T* __restrict__ vb, long long row_stride, int s0, int s1,
                              float* scratch, float* vsum) {
  constexpr int VPL = LaneMap<HD>::VPL;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  float a[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) a[i] = 0.f;
  if (lane < LaneMap<HD>::LANES) {
    for (int s = s0 + warp; s < s1; s += n_warps) {
      const T* vr = vb + s * row_stride + lane * VPL;
#pragma unroll
      for (int i = 0; i < VPL; ++i) a[i] += to_f32(vr[i]);
    }
#pragma unroll
    for (int i = 0; i < VPL; ++i) scratch[warp * HD + lane * VPL + i] = a[i];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float t = 0.f;
    for (int w = 0; w < n_warps; ++w) t += scratch[w * HD + d];
    vsum[d] = t;
  }
  __syncthreads();
}

// One CTA per (split, kv head h, row b).  Writes the split's (acc[hd], m, l)
// per query head to `part` [B, Hkv, n_split, G, hd+2], or, with one split,
// the normalised output straight to `out`.
template <typename T, int HD, bool VEC>
__global__ void __launch_bounds__(32 * kMaxWarps)
dense_decode_partial(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int32_t* __restrict__ kv_pos,
                     const int32_t* __restrict__ q_pos, float* __restrict__ part,
                     T* __restrict__ out, int S, int Hq, int Hkv, long long pos_stride,
                     int qpos_stride, int n_split, int window, float scale) {
  using TL = Tile<T, HD>;
  constexpr int VPL = LaneMap<HD>::VPL;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, n_warps = nthr >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                       // [kChunk][LD]
  T* v_s = k_s + kChunk * TL::LD;                            // [kChunk][LD]
  float* q_s = reinterpret_cast<float*>(v_s + kChunk * TL::LD);   // [G][HD]
  int* keep_s = reinterpret_cast<int*>(q_s + G * HD);        // [kChunk]

  const int s0 = split * kChunk;
  const int qp = q_pos[(long long)b * qpos_stride];
  const int32_t* pos = kv_pos + (long long)b * pos_stride;
  int kept = 0;
  for (int t = tid; t < kChunk; t += nthr) {
    const bool kp = s0 + t < S && keeps(pos[s0 + t], qp, window);
    keep_s[t] = kp;
    kept |= kp;
  }
  const T* qb = q + ((long long)b * Hq + (long long)h * G) * HD;
  for (int i = tid; i < G * HD; i += nthr) q_s[i] = to_f32(qb[i]) * scale;
  const bool any = __syncthreads_or(kept);
  const long long row_stride = (long long)Hkv * HD;
  const T* vb = v + ((long long)b * S * Hkv + h) * HD;

  // a chunk that keeps nothing: does the row keep anything elsewhere?  If
  // not (an idle row), this chunk's V column sums stand in for its
  // accumulator, so that the row's output becomes the mean of V over S.
  bool row_empty = false;
  if (!any) {
    int elsewhere = 0;
    if (n_split > 1)
      for (int t = tid; t < S; t += nthr) elsewhere |= keeps(pos[t], qp, window);
    row_empty = !__syncthreads_or(elsewhere);
  }
  float* vsum_s = q_s;             // [HD], the queries are not needed then
  if (row_empty)
    v_column_sums<T, HD>(vb, row_stride, s0, min(s0 + kChunk, S),
                         reinterpret_cast<float*>(k_s), vsum_s);

  if (any) {
    // stage the kept rows (zeros elsewhere: a masked row must not feed NaN
    // into 0 * v)
    const T* kb = k + ((long long)b * S * Hkv + h) * HD;
    for (int i = tid; i < kChunk * TL::VPR; i += nthr) {
      const int r = i / TL::VPR, c = i - r * TL::VPR;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (keep_s[r]) {
        const long long off = (s0 + r) * row_stride + c * TL::EPV;
        if constexpr (VEC) {
          kv = *reinterpret_cast<const uint4*>(kb + off);
          vv = *reinterpret_cast<const uint4*>(vb + off);
        } else {
          T* kt = reinterpret_cast<T*>(&kv);
          T* vt = reinterpret_cast<T*>(&vv);
#pragma unroll
          for (int e = 0; e < TL::EPV; ++e) {
            kt[e] = kb[off + e];
            vt[e] = vb[off + e];
          }
        }
      }
      *reinterpret_cast<uint4*>(k_s + r * TL::LD + c * TL::EPV) = kv;
      *reinterpret_cast<uint4*>(v_s + r * TL::LD + c * TL::EPV) = vv;
    }
    __syncthreads();
  }

  for (int g = warp; g < G; g += n_warps) {
    float m = kNegInf, l = 0.f, acc[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) acc[i] = 0.f;
    if (any) {
      // scores: lane owns entries lane and lane + 32
      const float* qg = q_s + g * HD;
      float sc[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = lane + 32 * e;
        const T* kr = k_s + r * TL::LD;
        float d = 0.f;
#pragma unroll 4
        for (int c = 0; c < TL::VPR; ++c) {
          const uint4 raw = *reinterpret_cast<const uint4*>(kr + c * TL::EPV);
          const T* kt = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int x = 0; x < TL::EPV; ++x) d += qg[c * TL::EPV + x] * to_f32(kt[x]);
        }
        sc[e] = keep_s[r] ? d : kNegInf;
      }
      m = warp_max(fmaxf(sc[0], sc[1]));
      const float p0 = sc[0] == kNegInf ? 0.f : expf(sc[0] - m);
      const float p1 = sc[1] == kNegInf ? 0.f : expf(sc[1] - m);
      l = warp_sum(p0 + p1);
      // P.V: lane owns VPL values of the head dimension (every lane takes
      // part in the shuffles; with hd < 32 only the first hd lanes add)
#pragma unroll 8
      for (int r = 0; r < kChunk; ++r) {
        const float p = __shfl_sync(0xffffffffu, r < 32 ? p0 : p1, r & 31);
        if (lane < LaneMap<HD>::LANES) {
          const Vec<T, VPL> vr =
              *reinterpret_cast<const Vec<T, VPL>*>(v_s + r * TL::LD + lane * VPL);
#pragma unroll
          for (int i = 0; i < VPL; ++i) acc[i] += p * to_f32(vr.x[i]);
        }
      }
    }
    if (lane >= LaneMap<HD>::LANES) continue;
    if (row_empty) {
#pragma unroll
      for (int i = 0; i < VPL; ++i) acc[i] = vsum_s[lane * VPL + i];
    }
    if (n_split == 1) {
      T* o = out + ((long long)b * Hq + (long long)h * G + g) * HD + lane * VPL;
      const float den = row_empty ? (float)S : l;
#pragma unroll
      for (int i = 0; i < VPL; ++i) o[i] = from_f32<T>(acc[i] / den);
      continue;
    }
    float* pp = part + ((((long long)b * Hkv + h) * n_split + split) * G + g) * (HD + 2);
#pragma unroll
    for (int i = 0; i < VPL; ++i) pp[lane * VPL + i] = acc[i];
    if (lane == 0) {
      pp[HD] = m;
      pp[HD + 1] = l;
    }
  }
}

// Merge the splits of one (kv head, row): the overall max from every split
// at once (lanes split the splits), then each split's state rescaled to it
// and added in split order.  A split without a kept entry has m = -1e30 and
// l = 0: in a row that keeps an entry elsewhere its weight exp(-1e30 - m)
// is 0 (and its acc is 0), so it adds nothing.  In a row that keeps no
// entry every split has m = -1e30, weight 1 and its V column sums as acc:
// l_tot is 0, and the output is their sum over S, the mean of V.
template <typename T, int HD>
__global__ void __launch_bounds__(32 * kMaxWarps)
dense_decode_combine(const float* __restrict__ part, T* __restrict__ out, int S, int Hq,
                     int Hkv, int n_split) {
  constexpr int VPL = LaneMap<HD>::VPL;
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  for (int g = warp; g < G; g += n_warps) {
    const float* base = part + (((long long)b * Hkv + h) * n_split * G + g) * (HD + 2);
    const long long step = (long long)G * (HD + 2);   // one split further
    float mloc = kNegInf;
    for (int sp = lane; sp < n_split; sp += 32) mloc = fmaxf(mloc, base[sp * step + HD]);
    const float m_tot = warp_max(mloc);
    if (lane >= LaneMap<HD>::LANES) continue;
    float l_tot = 0.f, acc[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) acc[i] = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < n_split; ++sp) {
      const float* pp = base + sp * step;
      const float w = expf(pp[HD] - m_tot);
      l_tot += pp[HD + 1] * w;
#pragma unroll
      for (int i = 0; i < VPL; ++i) acc[i] += pp[lane * VPL + i] * w;
    }
    T* o = out + ((long long)b * Hq + (long long)h * G + g) * HD + lane * VPL;
    const float den = l_tot > 0.f ? l_tot : (float)S;
#pragma unroll
    for (int i = 0; i < VPL; ++i) o[i] = from_f32<T>(acc[i] / den);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int32_t* kv_pos,
                   const int32_t* q_pos, void* out, float* part, int B, int S, int Hq,
                   int Hkv, int pos_per_row, int qpos_per_row, int window, float scale,
                   cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int n_split = (S + kChunk - 1) / kChunk;
  const bool vec = reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const long long pos_stride = pos_per_row ? (long long)S : 0;
  const int qpos_stride = qpos_per_row ? 1 : 0;
  const size_t smem = smem_bytes<T, HD>(G);
  auto kern = vec ? dense_decode_partial<T, HD, true> : dense_decode_partial<T, HD, false>;
  if (smem > kDefaultSmem) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int threads = 32 * (G < kMaxWarps ? G : kMaxWarps);
  kern<<<dim3(n_split, Hkv, B), threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv_pos,
      q_pos, part, static_cast<T*>(out), S, Hq, Hkv, pos_stride, qpos_stride, n_split, window,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  dense_decode_combine<T, HD><<<dim3(Hkv, B), threads, 0, stream>>>(
      part, static_cast<T*>(out), S, Hq, Hkv, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const int32_t* kv_pos, const int32_t* q_pos, void* out, float* part,
                        int B, int S, int Hq, int Hkv, int pos_per_row, int qpos_per_row,
                        int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, kv_pos, q_pos, out, part, B, S, Hq, Hkv, pos_per_row,
                           qpos_per_row, window, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, kv_pos, q_pos, out, part, B, S, Hq, Hkv, pos_per_row,
                           qpos_per_row, window, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, kv_pos, q_pos, out, part, B, S, Hq, Hkv, pos_per_row,
                           qpos_per_row, window, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, kv_pos, q_pos, out, part, B, S, Hq, Hkv, pos_per_row,
                            qpos_per_row, window, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, kv_pos, q_pos, out, part, B, S, Hq, Hkv, pos_per_row,
                            qpos_per_row, window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  hd in {16, 32, 64, 128,
// 256}.  pos_per_row / qpos_per_row: 1 for kv_pos [B, S] and q_pos [B], 0 for
// kv_pos [S] and q_pos [].  `chunk` must be the kernel's split size (64): the
// caller sizes `part`, f32 scratch of B * Hkv * ceil(S / chunk) * G * (hd + 2)
// values (unused with one split), by it.  window <= 0: no window.  Returns
// the first failing launch's cudaError_t (0 on success); launches on
// `stream` and does not synchronise.
extern "C" int dense_decode_attention(const void* q, const void* k, const void* v,
                                      const int32_t* kv_pos, const int32_t* q_pos, void* out,
                                      void* part, int dtype, int B, int S, int Hq, int Hkv,
                                      int hd, int pos_per_row, int qpos_per_row, int chunk,
                                      int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || chunk != kChunk ||
      B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  switch (dtype) {
    case 0:
      return (int)dispatch_hd<float>(hd, q, k, v, kv_pos, q_pos, out, p, B, S, Hq, Hkv,
                                     pos_per_row, qpos_per_row, window, scale, s);
    case 1:
      return (int)dispatch_hd<__nv_bfloat16>(hd, q, k, v, kv_pos, q_pos, out, p, B, S, Hq,
                                             Hkv, pos_per_row, qpos_per_row, window, scale, s);
    case 2:
      return (int)dispatch_hd<__half>(hd, q, k, v, kv_pos, q_pos, out, p, B, S, Hq, Hkv,
                                      pos_per_row, qpos_per_row, window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
