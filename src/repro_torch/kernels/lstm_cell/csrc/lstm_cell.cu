// Fused LSTM cell update, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/lstm_cell/kernel.py::lstm_cell_kernel_call
//   (body _kernel, pl.pallas_call at kernel.py:50).
//
// Computes, for every row n < N and column j < H, with gate order i|f|g|o
// along the 4H axis of gx and gh ([N, 4H], viewed [N, 4, H]):
//   a_k = (gx[n, kH + j] + gh[n, kH + j]) + b[kH + j]        k = 0..3
//   c'  = sigmoid(a_f + 1) * c[n, j] + sigmoid(a_i) * tanh(a_g)
//   h   = sigmoid(a_o) * tanh(c')
// all in f32; h is stored in the gates' dtype, c' in c's dtype.  Gates
// (with the bias) and state each take f32 or bf16 (a bf16 run keeps f32
// state).
//
// What bounds it on an H100: bytes.  Per element of h it does ~30 flops
// (four exponentials, two tanh) against 8 gate reads, a bias read, a state
// read and two writes; at N = 64, H = 1024, f32 that is 2.9 MB, ~0.87 us at
// 3.35 TB/s, while its flops would take a fraction of that even on the f32
// CUDA cores.  At that size one latency window and the launch (~1.1 us for
// a tiny kernel on this card) are the real floor, so the design is about
// how many loads are in flight at once, on how many SMs.
//
// Design: one thread owns kCols (1, 2 or 4) consecutive columns of one
// row, in CTAs of `threads` threads; the host picks both
// (ops.py::cell_tiles): one 4-byte word of each gate stream a thread, so
// a warp's load is 128 contiguous bytes, and enough CTAs to reach every
// SM.  At N = 64, H = 1024, f32 that is 256 CTAs of one column a thread,
// where 4 columns in CTAs of 256 gave 64 and left 68 SMs idle; wider
// vectors were slower at every CTA size.  When H is a multiple of kCols and
// every pointer is aligned to a vector, a thread reads each of the four
// gate slices of gx and gh, the bias and c as one vector each (4 x 4 B at
// most), so neighbouring threads read neighbouring addresses in all eight
// gate streams; otherwise (a ragged H or an unaligned view) it walks its
// columns one at a time.  gx and gh are read exactly once, so they are
// loaded with the streaming hint (ld.global.cs: evict first, they are
// dead after this kernel); the bias, which every row reads, through the
// read-only path.  h and c' get plain stores: the next GEMM
// (core/wavefront.py) reads h back at once, from L2.  The paper's stream
// stores (§6, named in the JAX kernel) save the Xeon Phi's
// read-for-ownership of the line being written; a GPU store does no such
// read, so they have no counterpart here.  A grid-stride loop covers any
// N >= 1 and any H.  No shared memory, no atomics: each output element is
// written by exactly one thread, so the result is the same on every run
// and on every stream.  expf / tanhf (no fast-math intrinsics) keep f32
// within 2e-5 of the plain version.  Left on the table: fusing this
// update into the epilogue of the two GEMMs that produce gx and gh (it
// would change the op and the graph the scheduler plans).
//
// Backward (lstm_cell_bwd): the gradient of the same update, for training.
// The JAX package differentiates lstm_cell (src/repro/core/wavefront.py)
// with XLA's autodiff and has no backward kernel; on the card the forward
// is a kernel, so its gradient is one too.  Per element it recomputes the
// gates and c' from gx, gh, b and c in f32 (forget bias +1, as above) and,
// from dh and dc' (the gradients of h and c'), writes
//   do = dh tanh(c') s_o (1 - s_o),  dc = dc' + dh s_o (1 - tanh(c')^2),
//   di = dc tanh(a_g) s_i (1 - s_i),  df = dc c s_f (1 - s_f),
//   dg = dc s_i (1 - tanh(a_g)^2),    dc_prev = dc s_f
// (s_i = sigmoid(a_i), s_f = sigmoid(a_f + 1), s_o = sigmoid(a_o)) as
// dgates [N, 4H] in the gates' dtype (gate order i|f|g|o: the gradient of
// both gx and gh) and dc_prev [N, H] in c's dtype.  Bytes bound it like the
// forward (ten reads and five writes an element); it is the simple form:
// one column of one row a thread, scalar loads, a grid-stride loop, each
// output written by one thread (the same bits on every run).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the machine word of K consecutive elements
template <int kBytes> struct Word;
template <> struct Word<2> { using T = unsigned short; };
template <> struct Word<4> { using T = unsigned int; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<16> { using T = uint4; };

enum class Hint { kStream, kReadOnly, kPlain };

// K consecutive elements at p (aligned to their size) as one load, in f32
template <typename E, int K, Hint kHint>
__device__ __forceinline__ void load(const E* p, float* out) {
  using W = typename Word<K * sizeof(E)>::T;
  const W* w = reinterpret_cast<const W*>(p);
  W raw;
  if constexpr (kHint == Hint::kStream) raw = __ldcs(w);
  else if constexpr (kHint == Hint::kReadOnly) raw = __ldg(w);
  else raw = *w;
  E e[K];
  memcpy(e, &raw, sizeof raw);
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = to_f32(e[k]);
}

template <typename E, int K>
__device__ __forceinline__ void store(E* p, const float* in) {
  using W = typename Word<K * sizeof(E)>::T;
  E e[K];
#pragma unroll
  for (int k = 0; k < K; ++k) e[k] = from_f32<E>(in[k]);
  W raw;
  memcpy(&raw, e, sizeof raw);
  *reinterpret_cast<W*>(p) = raw;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// the cell update of one element, gates already summed
__device__ __forceinline__ void cell(float ai, float af, float ag, float ao, float c,
                                     float* h_out, float* c_out) {
  const float cn = sigmoid(af + 1.0f) * c + sigmoid(ai) * tanhf(ag);
  *c_out = cn;
  *h_out = sigmoid(ao) * tanhf(cn);
}

// kCols columns of one row per thread; kVectorised: each of them one load
template <typename G, typename S, int kCols, bool kVectorised>
__global__ void __launch_bounds__(kMaxThreads)
lstm_cell_kernel(const G* __restrict__ gx, const G* __restrict__ gh, const G* __restrict__ b,
                 const S* __restrict__ c, G* __restrict__ h_out, S* __restrict__ c_out,
                 int64_t N, int64_t H) {
  const int64_t per_row = (H + kCols - 1) / kCols;
  const int64_t total = N * per_row;
  const int64_t H4 = 4 * H;
  for (int64_t v = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; v < total;
       v += (int64_t)gridDim.x * blockDim.x) {
    const int64_t n = v / per_row;
    const int64_t j0 = (v - n * per_row) * kCols;
    const G* gxr = gx + n * H4;
    const G* ghr = gh + n * H4;
    if constexpr (kVectorised) {
      float a[4][kCols], t[kCols], cs[kCols], hn[kCols], cn[kCols];
#pragma unroll
      for (int k = 0; k < 4; ++k) load<G, kCols, Hint::kStream>(gxr + k * H + j0, a[k]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        load<G, kCols, Hint::kStream>(ghr + k * H + j0, t);
#pragma unroll
        for (int e = 0; e < kCols; ++e) a[k][e] += t[e];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        load<G, kCols, Hint::kReadOnly>(b + k * H + j0, t);
#pragma unroll
        for (int e = 0; e < kCols; ++e) a[k][e] += t[e];
      }
      load<S, kCols, Hint::kPlain>(c + n * H + j0, cs);
#pragma unroll
      for (int e = 0; e < kCols; ++e)
        cell(a[0][e], a[1][e], a[2][e], a[3][e], cs[e], &hn[e], &cn[e]);
      store<G, kCols>(h_out + n * H + j0, hn);
      store<S, kCols>(c_out + n * H + j0, cn);
    } else {
      const int64_t j1 = j0 + kCols < H ? j0 + kCols : H;
      for (int64_t j = j0; j < j1; ++j) {
        float a[4], x, y, z, cs;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          load<G, 1, Hint::kStream>(gxr + k * H + j, &x);
          load<G, 1, Hint::kStream>(ghr + k * H + j, &y);
          load<G, 1, Hint::kReadOnly>(b + k * H + j, &z);
          a[k] = (x + y) + z;
        }
        load<S, 1, Hint::kPlain>(c + n * H + j, &cs);
        float hn, cn;
        cell(a[0], a[1], a[2], a[3], cs, &hn, &cn);
        store<G, 1>(h_out + n * H + j, &hn);
        store<S, 1>(c_out + n * H + j, &cn);
      }
    }
  }
}

bool aligned(const void* p, size_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename G, typename S, int kCols>
cudaError_t launch(const void* gx, const void* gh, const void* b, const void* c, void* h_out,
                   void* c_out, int64_t N, int64_t H, int threads, cudaStream_t stream) {
  const int64_t total = N * ((H + kCols - 1) / kCols);
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 blocks per SM
  const size_t gv = kCols * sizeof(G), sv = kCols * sizeof(S);
  const bool vec = H % kCols == 0 && aligned(gx, gv) && aligned(gh, gv) && aligned(b, gv) &&
                   aligned(h_out, gv) && aligned(c, sv) && aligned(c_out, sv);
  const G* gx_ = static_cast<const G*>(gx);
  const G* gh_ = static_cast<const G*>(gh);
  const G* b_ = static_cast<const G*>(b);
  const S* c_ = static_cast<const S*>(c);
  G* h_ = static_cast<G*>(h_out);
  S* cn_ = static_cast<S*>(c_out);
  if (vec)
    lstm_cell_kernel<G, S, kCols, true><<<(unsigned)blocks, threads, 0, stream>>>(
        gx_, gh_, b_, c_, h_, cn_, N, H);
  else
    lstm_cell_kernel<G, S, kCols, false><<<(unsigned)blocks, threads, 0, stream>>>(
        gx_, gh_, b_, c_, h_, cn_, N, H);
  return cudaGetLastError();
}

template <typename G, typename S>
cudaError_t dispatch_cols(int cols, const void* gx, const void* gh, const void* b,
                          const void* c, void* h_out, void* c_out, int64_t N, int64_t H,
                          int threads, cudaStream_t s) {
  switch (cols) {
    case 1: return launch<G, S, 1>(gx, gh, b, c, h_out, c_out, N, H, threads, s);
    case 2: return launch<G, S, 2>(gx, gh, b, c, h_out, c_out, N, H, threads, s);
    case 4: return launch<G, S, 4>(gx, gh, b, c, h_out, c_out, N, H, threads, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename G>
cudaError_t dispatch_state(int state_dtype, int cols, const void* gx, const void* gh,
                           const void* b, const void* c, void* h_out, void* c_out, int64_t N,
                           int64_t H, int threads, cudaStream_t s) {
  switch (state_dtype) {
    case 0: return dispatch_cols<G, float>(cols, gx, gh, b, c, h_out, c_out, N, H, threads, s);
    case 1:
      return dispatch_cols<G, __nv_bfloat16>(cols, gx, gh, b, c, h_out, c_out, N, H, threads,
                                             s);
    default: return cudaErrorInvalidValue;
  }
}

// the backward of one element: gates summed with the bias, c, dh, dc'
__device__ __forceinline__ void cell_bwd(float ai, float af, float ag, float ao, float c,
                                         float dh, float dcn, float* d_out, float* dc_prev) {
  const float si = sigmoid(ai), sf = sigmoid(af + 1.0f), so = sigmoid(ao);
  const float tg = tanhf(ag);
  const float cn = sf * c + si * tg;
  const float tc = tanhf(cn);
  const float dc = dcn + dh * so * (1.0f - tc * tc);
  d_out[0] = dc * tg * si * (1.0f - si);
  d_out[1] = dc * c * sf * (1.0f - sf);
  d_out[2] = dc * si * (1.0f - tg * tg);
  d_out[3] = dh * tc * so * (1.0f - so);
  *dc_prev = dc * sf;
}

template <typename G, typename S>
__global__ void __launch_bounds__(kMaxThreads)
lstm_cell_bwd_kernel(const G* __restrict__ gx, const G* __restrict__ gh,
                     const G* __restrict__ b, const S* __restrict__ c,
                     const G* __restrict__ dh, const S* __restrict__ dc,
                     G* __restrict__ dgates, S* __restrict__ dc_prev, int64_t N, int64_t H) {
  const int64_t total = N * H;
  for (int64_t v = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; v < total;
       v += (int64_t)gridDim.x * blockDim.x) {
    const int64_t n = v / H, j = v - n * H;
    const int64_t row = n * 4 * H;
    float a[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      a[k] = (to_f32(gx[row + k * H + j]) + to_f32(gh[row + k * H + j])) + to_f32(b[k * H + j]);
    float d[4], dcp;
    cell_bwd(a[0], a[1], a[2], a[3], to_f32(c[v]), to_f32(dh[v]), to_f32(dc[v]), d, &dcp);
#pragma unroll
    for (int k = 0; k < 4; ++k) dgates[row + k * H + j] = from_f32<G>(d[k]);
    dc_prev[v] = from_f32<S>(dcp);
  }
}

template <typename G, typename S>
cudaError_t launch_bwd(const void* gx, const void* gh, const void* b, const void* c,
                       const void* dh, const void* dc, void* dgates, void* dc_prev, int64_t N,
                       int64_t H, int threads, cudaStream_t stream) {
  int64_t blocks = (N * H + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 blocks per SM
  lstm_cell_bwd_kernel<G, S><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const G*>(gx), static_cast<const G*>(gh), static_cast<const G*>(b),
      static_cast<const S*>(c), static_cast<const G*>(dh), static_cast<const S*>(dc),
      static_cast<G*>(dgates), static_cast<S*>(dc_prev), N, H);
  return cudaGetLastError();
}

template <typename G>
cudaError_t dispatch_bwd(int state_dtype, const void* gx, const void* gh, const void* b,
                         const void* c, const void* dh, const void* dc, void* dgates,
                         void* dc_prev, int64_t N, int64_t H, int threads, cudaStream_t s) {
  switch (state_dtype) {
    case 0: return launch_bwd<G, float>(gx, gh, b, c, dh, dc, dgates, dc_prev, N, H, threads, s);
    case 1:
      return launch_bwd<G, __nv_bfloat16>(gx, gh, b, c, dh, dc, dgates, dc_prev, N, H, threads,
                                          s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  gx, gh: [N, 4H] and b: [4H] in
// gate_dtype; c: [N, H] in state_dtype; h_out: [N, H] in gate_dtype; c_out:
// [N, H] in state_dtype; all contiguous.  cols (1, 2 or 4) columns a
// thread and `threads` (a multiple of 32 up to 256) threads a CTA
// (ops.py::cell_tiles picks them).  Launches on `stream` and returns the
// launch's cudaError_t (0 = queued).
extern "C" int lstm_cell_fwd(const void* gx, const void* gh, const void* b, const void* c,
                             void* h_out, void* c_out, int gate_dtype, int state_dtype,
                             long long N, long long H, int cols, int threads, void* stream) {
  if (N <= 0 || H <= 0 || threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (gate_dtype) {
    case 0:
      return (int)dispatch_state<float>(state_dtype, cols, gx, gh, b, c, h_out, c_out, N, H,
                                        threads, s);
    case 1:
      return (int)dispatch_state<__nv_bfloat16>(state_dtype, cols, gx, gh, b, c, h_out, c_out,
                                                N, H, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward of lstm_cell_fwd.  gx, gh: [N, 4H] and b: [4H] in gate_dtype;
// c: [N, H] in state_dtype (the forward's inputs); dh: [N, H] in gate_dtype
// (the gradient of h); dc: [N, H] in state_dtype (the gradient of c');
// dgates: [N, 4H] in gate_dtype; dc_prev: [N, H] in state_dtype; all
// contiguous.  `threads` (a multiple of 32 up to 256) a CTA.  Launches on
// `stream` and returns the launch's cudaError_t (0 = queued).
extern "C" int lstm_cell_bwd(const void* gx, const void* gh, const void* b, const void* c,
                             const void* dh, const void* dc, void* dgates, void* dc_prev,
                             int gate_dtype, int state_dtype, long long N, long long H,
                             int threads, void* stream) {
  if (N <= 0 || H <= 0 || threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (gate_dtype) {
    case 0:
      return (int)dispatch_bwd<float>(state_dtype, gx, gh, b, c, dh, dc, dgates, dc_prev, N, H,
                                      threads, s);
    case 1:
      return (int)dispatch_bwd<__nv_bfloat16>(state_dtype, gx, gh, b, c, dh, dc, dgates,
                                              dc_prev, N, H, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
