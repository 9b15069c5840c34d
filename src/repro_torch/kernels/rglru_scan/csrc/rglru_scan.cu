// RG-LRU linear recurrence (Griffin / recurrentgemma), hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/rglru_scan/kernel.py::rglru_scan_kernel_call
//   (body _kernel, pl.pallas_call at kernel.py:64).
//
// Computes, for every batch row b < B and channel r < R, walking t = 0 ..
// S-1 in order from h_{-1} = h0[b, r] (0 when no h0):
//   h_t = a[b, t, r] * h_{t-1} + b[b, t, r]
//   hs[b, t, r] = h_t,   h_last[b, r] = h_{S-1}
// all in f32.  The product and the sum are rounded separately (__fmul_rn
// then __fadd_rn, no fused multiply-add), as the plain version's `a * h +
// b` rounds them, so hs and h_last are bit-identical to the plain version.
//
// What bounds it on an H100: bytes.  Two flops per element against 12
// bytes (a and b read, hs written): at recurrentgemma's prefill shape B =
// 1, S = 333, R = 2560 that is 10.2 MB, ~3 us at 3.35 TB/s; at decode (S =
// 1, B = 8) 0.25 MB, where the launch itself is the floor.
//
// Design (simple first).  The TPU kernel replaces the chain with an
// associative scan inside each VMEM chunk; on Hopper one thread owns one
// (b, r) and keeps h in a register while it walks S in order.
// Neighbouring threads own neighbouring channels, so each step's loads of
// a and b and store of hs are coalesced.  The loads do not depend on h, so
// the walk loads kUnroll steps of a and b into registers before it runs
// their recurrences.  At B * R = 2560 channels the card has only 80 warps
// of work, so blocks are made small (down to one warp) until there are
// enough of them to reach every SM.  No shared memory, no atomics: every
// output is written by exactly one thread in a fixed order, so the result
// is the same on every run and every stream.  Left on the table: splitting
// S across blocks (a chunked scan with a second pass that carries each
// chunk's state), which is what would fill the card at small B * R, and
// fusing the gates (sigmoid, softplus, exp, sqrt) into the kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 16;
constexpr int kSMs = 132;

__global__ void rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                  const float* __restrict__ h0, float* __restrict__ hs,
                                  float* __restrict__ h_last, int64_t B, int64_t S,
                                  int64_t R) {
  const int64_t ch = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;   // (b, r)
  if (ch >= B * R) return;
  const int64_t bb = ch / R;
  const int64_t r = ch - bb * R;
  const int64_t base = bb * S * R + r;
  float h = h0 != nullptr ? h0[ch] : 0.0f;
  for (int64_t t0 = 0; t0 < S; t0 += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t t = t0 + u;
      av[u] = t < S ? a[base + t * R] : 0.0f;
      bv[u] = t < S ? b[base + t * R] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t t = t0 + u;
      if (t >= S) break;
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      hs[base + t * R] = h;
    }
  }
  h_last[ch] = h;
}

}  // namespace

// a, b: [B, S, R] f32; h0: [B, R] f32 or null (start from zero); hs:
// [B, S, R] f32; h_last: [B, R] f32; all contiguous.  Launches on
// `stream` and returns the launch's cudaError_t (0 = queued).
extern "C" int rglru_scan_fwd(const void* a, const void* b, const void* h0, void* hs,
                              void* h_last, long long B, long long S, long long R,
                              void* stream) {
  if (B <= 0 || S <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  const int64_t total = B * R;
  int threads = 128;                 // shrink blocks until every SM gets one
  while (threads > 32 && (total + threads - 1) / threads < kSMs) threads >>= 1;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  rglru_scan_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(hs), static_cast<float*>(h_last), B,
      S, R);
  return (int)cudaGetLastError();
}
