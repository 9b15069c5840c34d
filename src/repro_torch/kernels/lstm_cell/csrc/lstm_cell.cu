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
// CUDA cores.  At that size the launch itself (a few us) is the real floor.
//
// Design (simple first): one thread owns kVec = 4 consecutive columns of
// one row.  When H is a multiple of 4 and every pointer is 16-byte aligned,
// it reads each of the four gate slices of gx and gh, the bias and c as one
// vector each (16 B in f32, 8 B in bf16), so neighbouring threads read
// neighbouring addresses in all eight gate streams; otherwise (a ragged H)
// it walks its columns one at a time.  A grid-stride loop covers any N >= 1
// and any H.  No shared memory, no atomics: each output element is written
// by exactly one thread, so the result is the same on every run and on
// every stream.  expf / tanhf (no fast-math intrinsics) keep f32 within
// 2e-5 of the plain version.  Left on the table: fusing this update into
// the epilogue of the two GEMMs that produce gx and gh (which would drop
// the 2 x N x 4H gate round trip through memory), and TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 4;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// kVec consecutive elements as one aligned vector load / store
template <typename T> struct Vec;
template <> struct Vec<float> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    out[0] = __low2float(lo); out[1] = __high2float(lo);
    out[2] = __low2float(hi); out[3] = __high2float(hi);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* in) {
    uint2 raw;
    *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(in[0], in[1]);
    *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(in[2], in[3]);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// the cell update of one element, gates already summed
__device__ __forceinline__ void cell(float ai, float af, float ag, float ao, float c,
                                     float* h_out, float* c_out) {
  const float cn = sigmoid(af + 1.0f) * c + sigmoid(ai) * tanhf(ag);
  *c_out = cn;
  *h_out = sigmoid(ao) * tanhf(cn);
}

template <typename G, typename S, bool kVectorised>
__global__ void __launch_bounds__(kThreads)
lstm_cell_kernel(const G* __restrict__ gx, const G* __restrict__ gh, const G* __restrict__ b,
                 const S* __restrict__ c, G* __restrict__ h_out, S* __restrict__ c_out,
                 int64_t N, int64_t H) {
  const int64_t per_row = (H + kVec - 1) / kVec;
  const int64_t total = N * per_row;
  const int64_t H4 = 4 * H;
  for (int64_t v = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; v < total;
       v += (int64_t)gridDim.x * blockDim.x) {
    const int64_t n = v / per_row;
    const int64_t j0 = (v - n * per_row) * kVec;
    const G* gxr = gx + n * H4;
    const G* ghr = gh + n * H4;
    if constexpr (kVectorised) {
      float a[4][kVec], t[kVec], cs[kVec], hn[kVec], cn[kVec];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        Vec<G>::load(gxr + k * H + j0, a[k]);
        Vec<G>::load(ghr + k * H + j0, t);
#pragma unroll
        for (int e = 0; e < kVec; ++e) a[k][e] += t[e];
        Vec<G>::load(b + k * H + j0, t);
#pragma unroll
        for (int e = 0; e < kVec; ++e) a[k][e] += t[e];
      }
      Vec<S>::load(c + n * H + j0, cs);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        cell(a[0][e], a[1][e], a[2][e], a[3][e], cs[e], &hn[e], &cn[e]);
      Vec<G>::store(h_out + n * H + j0, hn);
      Vec<S>::store(c_out + n * H + j0, cn);
    } else {
      const int64_t j1 = j0 + kVec < H ? j0 + kVec : H;
      for (int64_t j = j0; j < j1; ++j) {
        float a[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          a[k] = (to_f32(gxr[k * H + j]) + to_f32(ghr[k * H + j])) + to_f32(b[k * H + j]);
        float hn, cn;
        cell(a[0], a[1], a[2], a[3], to_f32(c[n * H + j]), &hn, &cn);
        h_out[n * H + j] = from_f32<G>(hn);
        c_out[n * H + j] = from_f32<S>(cn);
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename G, typename S>
cudaError_t launch(const void* gx, const void* gh, const void* b, const void* c, void* h_out,
                   void* c_out, int64_t N, int64_t H, cudaStream_t stream) {
  const int64_t total = N * ((H + kVec - 1) / kVec);
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 blocks per SM
  const bool vec = H % kVec == 0 && aligned16(gx) && aligned16(gh) && aligned16(b) &&
                   aligned16(c) && aligned16(h_out) && aligned16(c_out);
  const G* gx_ = static_cast<const G*>(gx);
  const G* gh_ = static_cast<const G*>(gh);
  const G* b_ = static_cast<const G*>(b);
  const S* c_ = static_cast<const S*>(c);
  G* h_ = static_cast<G*>(h_out);
  S* cn_ = static_cast<S*>(c_out);
  if (vec)
    lstm_cell_kernel<G, S, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        gx_, gh_, b_, c_, h_, cn_, N, H);
  else
    lstm_cell_kernel<G, S, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        gx_, gh_, b_, c_, h_, cn_, N, H);
  return cudaGetLastError();
}

template <typename G>
cudaError_t dispatch_state(int state_dtype, const void* gx, const void* gh, const void* b,
                           const void* c, void* h_out, void* c_out, int64_t N, int64_t H,
                           cudaStream_t s) {
  switch (state_dtype) {
    case 0: return launch<G, float>(gx, gh, b, c, h_out, c_out, N, H, s);
    case 1: return launch<G, __nv_bfloat16>(gx, gh, b, c, h_out, c_out, N, H, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  gx, gh: [N, 4H] and b: [4H] in
// gate_dtype; c: [N, H] in state_dtype; h_out: [N, H] in gate_dtype; c_out:
// [N, H] in state_dtype; all contiguous.  Launches on `stream` and returns
// the launch's cudaError_t (0 = queued).
extern "C" int lstm_cell_fwd(const void* gx, const void* gh, const void* b, const void* c,
                             void* h_out, void* c_out, int gate_dtype, int state_dtype,
                             long long N, long long H, void* stream) {
  if (N <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (gate_dtype) {
    case 0: return (int)dispatch_state<float>(state_dtype, gx, gh, b, c, h_out, c_out, N, H, s);
    case 1:
      return (int)dispatch_state<__nv_bfloat16>(state_dtype, gx, gh, b, c, h_out, c_out, N, H,
                                                s);
    default: return (int)cudaErrorInvalidValue;
  }
}
