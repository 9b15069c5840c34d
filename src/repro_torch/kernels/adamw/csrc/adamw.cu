// Multi-tensor AdamW with global-norm clipping, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves its AdamW
// (src/repro/optim/adamw.py::adamw_update) to XLA, which fuses each leaf's
// elementwise chain inside the jitted step.  Run eagerly on the card, the
// same chain (src/repro_torch/optim/adamw.py, the per-leaf loop) is ~20
// launches a leaf, each writing an f32 temporary, and the clip four more.
//
// Three kernels over every leaf of a parameter tree at once:
//   adamw_sumsq   CTA b takes chunk b of the chunk list (leaf, chunk index;
//                 kChunk elements a chunk), squares its gradient elements in
//                 f32 (as the loop's torch.square(g.float())) and writes one
//                 f64 partial sum.
//   adamw_finish  one CTA sums the partials in a fixed order and writes
//                 gnorm = sqrt(sum) and scale = min(clip / max(gnorm, 1e-12), 1)
//                 on the device: nothing is read back to the host.
//   adamw_update  CTA b updates chunk b: each element reads p, g, m and v once
//                 and writes p, m and v once, with no temporaries.
// The leaf table (four pointers, numel, dtypes, decay flag; 48 B a leaf)
// travels in the launch's parameters (__grid_constant__; kMaxLeaves a
// launch, more leaves take more launches); the chunk list is built and
// cached on the host (ops.py::plan), since only the pointers change from
// step to step.
//
// What bounds it on an H100: bytes.  The update moves 22 B a bf16 element
// (p 2 + 2, g 2, m 4 + 4, v 4 + 4) and 28 B an f32 one, at a few dozen flops;
// the norm reads the gradient once more.  So the design is about full-width
// loads and every SM busy: a thread takes 8 consecutive elements at a time,
// each array loaded as 16-byte vectors where its pointer at the chunk is
// 16-byte aligned and one element at a time where it is not (a view at an
// unaligned offset), with the leaf's ragged end element by element; one CTA
// a 64K-element chunk gives tens of thousands of CTAs for a 4 B-parameter
// model, a few per SM in flight at once.  On an H100 (80GB HBM3, 700 W) the
// update of h2o-danube3-4b's 3.96 B parameters takes 29.6 ms, 88% of its
// 26.0 ms bound; CTAs of 128 or 512 threads, 4 elements a thread, two groups
// loaded before either is computed, or a register cap for more CTAs an SM
// were all as fast or slower (29.8-32.2 ms).  An element whose moments are
// zero (a gradient that was always zero) takes the slow path of IEEE
// division (0 / x): with every gradient zero the update takes 37 ms.
//
// Numerics.  The update follows the loop's operations in its order, each
// rounded once to nearest (the _rn intrinsics, which no FMA contraction
// touches): g' = g scale; m = b1 m + (1 - b1) g'; v = b2 v + ((1 - b2) g') g';
// delta = (m / b1c) / (sqrt(v / b2c) + eps), plus wd p where the leaf
// decays; p = p - lr delta, rounded back to bf16 / fp16 to nearest even.  So
// given the same scale the new p, m and v are bit for bit the loop's.  The
// norm sums in another order than torch.sum: f32 over a thread's 256
// elements of a chunk, f64 across threads, CTAs and chunks, always in the
// same order, so its bits repeat from run to run.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kChunk = 1 << 16;   // elements a chunk (ops.py's CHUNK)
constexpr int kThreads = 256;
constexpr int kVec = 8;           // consecutive elements a thread takes at a time
static_assert(kVec * 2 % 16 == 0, "kVec elements of 2 bytes fill whole 16-byte words");
constexpr int kFinishThreads = 1024;
// leaves a launch's table holds: 30 KB of the 32,764 bytes of kernel
// parameters Hopper takes (CUDA 12.1 on); ops.py's MAX_LEAVES
constexpr int kMaxLeaves = 640;

// dtype codes (ops.py's _CODES); a leaf's kind is p code * 3 + g code
constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;

struct Leaf {
  void* p;
  const void* g;
  float* m;
  float* v;
  long long n;
  int kind;
  int decay;
};
static_assert(sizeof(Leaf) == 48, "ops.py packs a leaf as 6 int64");

struct Table {
  Leaf leaf[kMaxLeaves];
};

struct F32 {
  using Raw = float;
  static __device__ __forceinline__ float load(Raw r) { return r; }
  static __device__ __forceinline__ Raw store(float x) { return x; }
};
struct BF16 {
  using Raw = unsigned short;
  static __device__ __forceinline__ float load(Raw r) {
    return __bfloat162float(__ushort_as_bfloat16(r));
  }
  static __device__ __forceinline__ Raw store(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};
struct F16 {
  using Raw = unsigned short;
  static __device__ __forceinline__ float load(Raw r) {
    return __half2float(__ushort_as_half(r));
  }
  static __device__ __forceinline__ Raw store(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// kVec elements of T at r in f32 (cnt of them valid): 16-byte words when vec
template <typename T>
__device__ __forceinline__ void load(const typename T::Raw* r, bool vec, int cnt,
                                     float (&x)[kVec]) {
  using Raw = typename T::Raw;
  constexpr int kWords = kVec * sizeof(Raw) / 16;
  if (vec && cnt == kVec) {
    uint4 w[kWords];
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = reinterpret_cast<const uint4*>(r)[i];
    Raw e[kVec];
    memcpy(e, w, sizeof w);
#pragma unroll
    for (int k = 0; k < kVec; ++k) x[k] = T::load(e[k]);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) x[k] = k < cnt ? T::load(r[k]) : 0.0f;
  }
}

template <typename T>
__device__ __forceinline__ void store(typename T::Raw* r, bool vec, int cnt,
                                      const float (&x)[kVec]) {
  using Raw = typename T::Raw;
  constexpr int kWords = kVec * sizeof(Raw) / 16;
  if (vec && cnt == kVec) {
    Raw e[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) e[k] = T::store(x[k]);
    uint4 w[kWords];
    memcpy(w, e, sizeof w);
#pragma unroll
    for (int i = 0; i < kWords; ++i) reinterpret_cast<uint4*>(r)[i] = w[i];
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      if (k < cnt) r[k] = T::store(x[k]);
  }
}

// the chunk this CTA owns: its leaf and its element range [s, e)
struct Span {
  const Leaf* leaf;
  long long s, e;
};

__device__ __forceinline__ Span chunk_of(const Table& tab, const int2* chunks) {
  const int2 c = chunks[blockIdx.x];
  const Leaf* L = &tab.leaf[c.x];
  const long long s = (long long)c.y * kChunk;
  const long long e = s + kChunk < L->n ? s + kChunk : L->n;
  return {L, s, e};
}

// the sum of a double over the CTA, in a fixed order; valid in thread 0
template <int kN>
__device__ __forceinline__ double cta_sum(double d) {
  __shared__ double warp_sums[kN / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) d += __shfl_down_sync(0xffffffffu, d, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = d;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kN / 32; ++w) t += warp_sums[w];
  return t;
}

template <typename G>
__device__ __forceinline__ float sumsq_range(const void* gp, long long s, long long e) {
  const typename G::Raw* g = static_cast<const typename G::Raw*>(gp);
  const bool vg = aligned16(g + s);
  float acc = 0.0f;
  for (long long i = s + (long long)threadIdx.x * kVec; i < e; i += (long long)kThreads * kVec) {
    const int cnt = e - i < kVec ? (int)(e - i) : kVec;
    float x[kVec];
    load<G>(g + i, vg, cnt, x);
    float q = 0.0f;
#pragma unroll
    for (int k = 0; k < kVec; ++k) q += __fmul_rn(x[k], x[k]);
    acc += q;
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
adamw_sumsq_kernel(const __grid_constant__ Table tab, const int2* __restrict__ chunks,
                   double* __restrict__ partials) {
  const Span c = chunk_of(tab, chunks);
  float acc = 0.0f;
  switch (c.leaf->kind % 3) {
    case kF32: acc = sumsq_range<F32>(c.leaf->g, c.s, c.e); break;
    case kBF16: acc = sumsq_range<BF16>(c.leaf->g, c.s, c.e); break;
    case kF16: acc = sumsq_range<F16>(c.leaf->g, c.s, c.e); break;
  }
  const double t = cta_sum<kThreads>((double)acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = t;
}

// torch.clamp's min / max: a NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) { return x != x ? x : fmaxf(x, lo); }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x != x ? x : fminf(x, hi); }

__global__ void __launch_bounds__(kFinishThreads)
adamw_finish_kernel(const double* __restrict__ partials, int n, float clip,
                    float* __restrict__ out) {
  double d = 0.0;
  for (int i = threadIdx.x; i < n; i += kFinishThreads) d += partials[i];
  const double t = cta_sum<kFinishThreads>(d);
  if (threadIdx.x == 0) {
    const float gnorm = __fsqrt_rn(__double2float_rn(t));
    // the loop's clip / clamp(gnorm, min=1e-12) is reciprocal(...) * clip
    const float scale = clamp_max(__fmul_rn(__frcp_rn(clamp_min(gnorm, 1e-12f)), clip), 1.0f);
    out[0] = gnorm;
    out[1] = scale;
  }
}

// the update's scalars: the host's constants and the device's
struct Coef {
  float b1, omb1, b2, omb2, eps, wd;   // b1, 1 - b1, b2, 1 - b2, eps, weight decay
};
struct Live {
  float scale, lr, b1c, b2c;           // clip scale, learning rate, 1 - b1^t, 1 - b2^t
};

// one element, in the loop's order (optim/adamw.py), each operation rounded once
__device__ __forceinline__ void adamw_element(float& p, float g, float& m, float& v, bool decay,
                                              const Coef& c, const Live& l) {
  const float gs = __fmul_rn(g, l.scale);
  m = __fadd_rn(__fmul_rn(m, c.b1), __fmul_rn(c.omb1, gs));
  v = __fadd_rn(__fmul_rn(v, c.b2), __fmul_rn(__fmul_rn(c.omb2, gs), gs));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, l.b2c)), c.eps);
  float delta = __fdiv_rn(__fdiv_rn(m, l.b1c), den);
  if (decay) delta = __fadd_rn(delta, __fmul_rn(c.wd, p));
  p = __fsub_rn(p, __fmul_rn(l.lr, delta));
}

template <typename P, typename G>
__device__ __forceinline__ void update_range(const Leaf& L, long long s, long long e,
                                             const Coef& c, const Live& l) {
  typename P::Raw* p = static_cast<typename P::Raw*>(L.p);
  const typename G::Raw* g = static_cast<const typename G::Raw*>(L.g);
  float* m = L.m;
  float* v = L.v;
  const bool vp = aligned16(p + s), vg = aligned16(g + s), vm = aligned16(m + s),
             vv = aligned16(v + s), decay = L.decay != 0;
  for (long long i = s + (long long)threadIdx.x * kVec; i < e; i += (long long)kThreads * kVec) {
    const int cnt = e - i < kVec ? (int)(e - i) : kVec;
    float pf[kVec], gf[kVec], mf[kVec], vf[kVec];
    load<P>(p + i, vp, cnt, pf);
    load<G>(g + i, vg, cnt, gf);
    load<F32>(m + i, vm, cnt, mf);
    load<F32>(v + i, vv, cnt, vf);
#pragma unroll
    for (int k = 0; k < kVec; ++k) adamw_element(pf[k], gf[k], mf[k], vf[k], decay, c, l);
    store<P>(p + i, vp, cnt, pf);
    store<F32>(m + i, vm, cnt, mf);
    store<F32>(v + i, vv, cnt, vf);
  }
}

__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const __grid_constant__ Table tab, const int2* __restrict__ chunks,
                    const float* __restrict__ scale, const float* __restrict__ lr,
                    const float* __restrict__ b1c, const float* __restrict__ b2c, Coef c) {
  const Span ch = chunk_of(tab, chunks);
  const Live l = {*scale, *lr, *b1c, *b2c};
  const Leaf& L = *ch.leaf;
  switch (L.kind) {
    case kF32 * 3 + kF32: update_range<F32, F32>(L, ch.s, ch.e, c, l); break;
    case kBF16 * 3 + kBF16: update_range<BF16, BF16>(L, ch.s, ch.e, c, l); break;
    case kBF16 * 3 + kF32: update_range<BF16, F32>(L, ch.s, ch.e, c, l); break;
    case kF16 * 3 + kF16: update_range<F16, F16>(L, ch.s, ch.e, c, l); break;
    case kF16 * 3 + kF32: update_range<F16, F32>(L, ch.s, ch.e, c, l); break;
  }
}

bool valid_kind(int kind) {
  return kind == kF32 * 3 + kF32 || kind == kBF16 * 3 + kBF16 || kind == kBF16 * 3 + kF32 ||
         kind == kF16 * 3 + kF16 || kind == kF16 * 3 + kF32;
}

// the host's copy of the table (a launch's parameters are copied at the launch)
bool fill(Table& tab, const void* table, int n_leaves) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves) return false;
  memcpy(tab.leaf, table, sizeof(Leaf) * n_leaves);
  for (int i = 0; i < n_leaves; ++i)
    if (!valid_kind(tab.leaf[i].kind) || tab.leaf[i].n < 0) return false;
  return true;
}

thread_local Table host_table;   // 30 KB: kept off the caller's stack

}  // namespace

// Leaves a launch's table holds, and elements a chunk (ops.py checks both).
extern "C" int adamw_max_leaves() { return kMaxLeaves; }
extern "C" int adamw_chunk() { return kChunk; }

// The global norm's partial sums.  table: n_leaves packed Leafs (host
// memory, copied before the call returns); chunks: n_chunks int2 (leaf in
// this table, chunk index in the leaf) on the device; partials: n_chunks
// doubles.  Launches on `stream`; returns the launch's cudaError_t.
extern "C" int adamw_sumsq(const void* table, int n_leaves, const int* chunks, int n_chunks,
                           double* partials, void* stream) {
  if (n_chunks < 0 || !fill(host_table, table, n_leaves)) return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return (int)cudaSuccess;
  adamw_sumsq_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      host_table, reinterpret_cast<const int2*>(chunks), partials);
  return (int)cudaGetLastError();
}

// gnorm and the clip scale from n partial sums, into out[0] and out[1] (f32).
extern "C" int adamw_finish(const double* partials, int n, float clip, float* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  adamw_finish_kernel<<<1, kFinishThreads, 0, static_cast<cudaStream_t>(stream)>>>(partials, n,
                                                                                   clip, out);
  return (int)cudaGetLastError();
}

// The update of every leaf in the table, in place.  scale, lr, b1c, b2c:
// one f32 each on the device; the rest as in adamw_sumsq.
extern "C" int adamw_update(const void* table, int n_leaves, const int* chunks, int n_chunks,
                            const float* scale, const float* lr, const float* b1c,
                            const float* b2c, float b1, float omb1, float b2, float omb2,
                            float eps, float wd, void* stream) {
  if (n_chunks < 0 || !fill(host_table, table, n_leaves)) return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return (int)cudaSuccess;
  const Coef c = {b1, omb1, b2, omb2, eps, wd};
  adamw_update_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      host_table, reinterpret_cast<const int2*>(chunks), scale, lr, b1c, b2c, c);
  return (int)cudaGetLastError();
}
