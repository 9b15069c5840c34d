// Mamba selective scan, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/ssm_scan/kernel.py::ssm_scan_kernel_call
//   (body _kernel, pl.pallas_call at kernel.py:71).
//
// Computes, for every batch row b < B, channel d < D and state s < St,
// walking t = 0 .. S-1 in order from h_{-1} = h0[b, d, s] (0 when no h0):
//   h_t[s] = a[b, t, d, s] * h_{t-1}[s] + b[b, t, d, s]
//   y[b, t, d] = sum_s h_t[s] * c[b, t, s]
//   h_last[b, d, s] = h_{S-1}[s]
// a, b, h0, y and h_last are f32; c is f32 or bf16 (upcast).  The product
// and the sum of the recurrence are rounded separately (__fmul_rn then
// __fadd_rn, no fused multiply-add), as the plain version's `a * h + b`
// rounds them, so h and h_last are bit-identical to the plain version's;
// only y's sum over the states runs in another order.
//
// What bounds it on an H100: bytes.  Per element of a it does four flops
// (the recurrence and its share of y) against 8 bytes of a and b, so at
// the prefill shape B = 1, S = 333, D = 8192, St = 16 it must move 350 MB
// (~0.105 ms at 3.35 TB/s); at decode (S = 1, B = 8) 8.4 MB (~2.5 us),
// where the launch itself is the floor.
//
// Design (simple first).  The TPU kernel replaces the per-step chain with
// an associative scan inside each VMEM chunk because its vector unit
// cannot vectorise a chain; on Hopper the chain is a register per thread.
// G lanes (St rounded up to a power of two, at most 32) own one (b, d):
// lane s keeps h[s] in a register and walks S in order.  A warp covers
// 32 / G consecutive channels, so each step's loads of a and b are one
// contiguous 128-byte line per warp; the c row of a step is the same for
// every channel of a batch row (a broadcast read).  Loads do not depend on
// h, so the walk loads U = 8 steps of a, b and c into registers before it
// runs their recurrences, keeping that many loads in flight per lane.  A
// decode step (S = 1) has nothing to prefetch and takes U = 1, which needs
// fewer registers, so more blocks share an SM (with U = 8 the one-step
// launch over B·D·G = 1M lanes ran 2x slower than the plain version's
// three kernels).
// y_t is a shuffle reduction inside the G lanes; lane 0 of the group
// stores it.  Lanes past St or past B * D keep the warp's shuffles whole
// and load and store nothing.  No shared memory, no atomics: every output
// is written by exactly one lane in a fixed order, so the result is the
// same on every run and every stream.  Left on the table: a deeper
// pipeline (cp.async / TMA into shared memory) and fusing the
// discretisation exp(dt * A), dt * B * x into the kernel so a and b never
// reach device memory (the reference's ssm_scan_fused does that in jnp).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int G, int U, typename C>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const C* __restrict__ c, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_last,
                int64_t B, int64_t S, int64_t D, int St) {
  const int64_t tid = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  const int64_t pair = tid / G;              // (b, d) of this lane's group
  const int s = (int)(tid % G);              // the state this lane owns
  const bool live = pair < B * D && s < St;
  const int64_t bb = live ? pair / D : 0;
  const int64_t d = live ? pair - bb * D : 0;
  const int64_t step_ad = D * St;            // a, b: one t step
  const int64_t step_y = D;                  // y: one t step
  const float* ap = a + (bb * S * D + d) * St + s;
  const float* bp = b + (bb * S * D + d) * St + s;
  const C* cp = c + bb * S * St + s;
  float* yp = y + bb * S * D + d;

  float h = (live && h0 != nullptr) ? h0[(bb * D + d) * St + s] : 0.0f;
  for (int64_t t0 = 0; t0 < S; t0 += U) {
    float av[U], bv[U], cv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t t = t0 + u;
      const bool in = live && t < S;
      av[u] = in ? ap[t * step_ad] : 0.0f;
      bv[u] = in ? bp[t * step_ad] : 0.0f;
      cv[u] = in ? to_f32(cp[t * St]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t t = t0 + u;
      if (t >= S) break;                      // uniform across the warp
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      float p = h * cv[u];
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off, G);
      if (live && s == 0) yp[t * step_y] = p;
    }
  }
  if (live) h_last[(bb * D + d) * St + s] = h;
}

template <int G, int U, typename C>
cudaError_t run(dim3 grid, const float* a, const float* b, const C* c, const float* h0,
                float* y, float* h_last, int64_t B, int64_t S, int64_t D, int St,
                cudaStream_t stream) {
  ssm_scan_kernel<G, U, C><<<grid, kThreads, 0, stream>>>(a, b, c, h0, y, h_last, B, S, D, St);
  return cudaGetLastError();
}

template <int U, typename C>
cudaError_t launch_g(int G, dim3 grid, const float* a, const float* b, const C* c,
                     const float* h0, float* y, float* h_last, int64_t B, int64_t S, int64_t D,
                     int St, cudaStream_t stream) {
  switch (G) {
    case 1: return run<1, U, C>(grid, a, b, c, h0, y, h_last, B, S, D, St, stream);
    case 2: return run<2, U, C>(grid, a, b, c, h0, y, h_last, B, S, D, St, stream);
    case 4: return run<4, U, C>(grid, a, b, c, h0, y, h_last, B, S, D, St, stream);
    case 8: return run<8, U, C>(grid, a, b, c, h0, y, h_last, B, S, D, St, stream);
    case 16: return run<16, U, C>(grid, a, b, c, h0, y, h_last, B, S, D, St, stream);
    case 32: return run<32, U, C>(grid, a, b, c, h0, y, h_last, B, S, D, St, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename C>
cudaError_t launch(int G, const float* a, const float* b, const C* c, const float* h0,
                   float* y, float* h_last, int64_t B, int64_t S, int64_t D, int St,
                   cudaStream_t stream) {
  const int64_t threads = B * D * G;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks);
  if (S == 1) return launch_g<1, C>(G, grid, a, b, c, h0, y, h_last, B, S, D, St, stream);
  return launch_g<8, C>(G, grid, a, b, c, h0, y, h_last, B, S, D, St, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (c only).  a, b: [B, S, D, St]
// f32; c: [B, S, St] in c_dtype; h0: [B, D, St] f32 or null (start from
// zero); y: [B, S, D] f32; h_last: [B, D, St] f32; all contiguous.
// 1 <= St <= 32.  Launches on `stream` and returns the launch's
// cudaError_t (0 = queued).
extern "C" int ssm_scan_fwd(const void* a, const void* b, const void* c, const void* h0,
                            void* y, void* h_last, int c_dtype, long long B, long long S,
                            long long D, int St, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || St < 1 || St > 32) return (int)cudaErrorInvalidValue;
  int G = 1;
  while (G < St) G <<= 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a_ = static_cast<const float*>(a);
  const float* b_ = static_cast<const float*>(b);
  const float* h0_ = static_cast<const float*>(h0);
  float* y_ = static_cast<float*>(y);
  float* hl_ = static_cast<float*>(h_last);
  switch (c_dtype) {
    case 0:
      return (int)launch<float>(G, a_, b_, static_cast<const float*>(c), h0_, y_, hl_, B, S, D,
                                St, s);
    case 1:
      return (int)launch<__nv_bfloat16>(G, a_, b_, static_cast<const __nv_bfloat16*>(c), h0_,
                                        y_, hl_, B, S, D, St, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
