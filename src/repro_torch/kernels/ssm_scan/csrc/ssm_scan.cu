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
//
// The backward (ssm_scan_bwd), walking t = S-1 .. 0 from g = dh_last:
//   g_t = g + dy[b, t, d] * c[b, t, s]     (the cotangent of h_t)
//   da[b, t, d, s] = g_t * h_{t-1},  db = g_t,  g = g_t * a_t
//   dc[b, t, s] = sum_d h_t[s] * dy[b, t, d],  dh0 = the last g
// The forward keeps no h, and dividing h_t back by a_t would underflow, so
// each lane first re-runs its forward chain (the same rounding as the
// forward, so the same bits) and parks h_{t-1} in da[t], the buffer it is
// about to overwrite; the reverse walk reads it back one step before it
// writes the gradient there.  No scratch of the state's size and no chunk
// bookkeeping, for one more write and read of a [B, S, D, St] array.  The
// lanes and the U = 8 read-ahead are the forward's.  dc sums over D, which
// spans CTAs: per U steps each warp adds its channels' products with
// shuffles, the CTA adds its warps' sums in shared memory in warp order,
// and one row of per-CTA partials [B, D / channels, S, St] is written;
// ssm_scan_dc_sum then adds the partials of each (b, t, s) in CTA order and
// rounds to c's dtype.  Every sum runs in a fixed order and there are no
// atomics: the same bits on every call.  da, db and dh0 are bit-equal to
// the plain version (same chain, same rounding); only dc sums in another
// order.  Bytes bound it: a and b read twice, dy and c once, h written and
// read once, da and db written, ~7 passes over [B, S, D, St] f32 where 4
// are needed (at falcon-mamba's training shape B = 4, S = 512, D = 8192,
// St = 16: ~7.5 GB moved against a 4.3 GB bound, 1.28 ms at 3.35 TB/s).
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

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The backward over one CTA of kThreads / G channels of batch row
// blockIdx.y (G lanes a channel, lane s on state s, as the forward).
template <int G, int U, typename C>
__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const C* __restrict__ c, const float* __restrict__ h0,
                    const float* __restrict__ dy, const float* __restrict__ dh_last,
                    float* __restrict__ da, float* __restrict__ db, float* __restrict__ dh0,
                    float* __restrict__ dc_part, int64_t S, int64_t D, int St) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kCh = kThreads / G;           // channels a CTA
  __shared__ float red[kWarps][U][32];        // each warp's sum over its channels
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t bb = blockIdx.y;
  const int64_t d = (int64_t)blockIdx.x * kCh + tid / G;
  const int s = tid % G;
  const bool live = d < D && s < St;
  const int64_t step_ad = D * St;
  const int64_t at = live ? (bb * S * D + d) * St + s : 0;     // [bb, 0, d, s]
  const int64_t yt = live ? bb * S * D + d : 0;                // dy[bb, 0, d]
  const C* cp = c + bb * S * St + (live ? s : 0);
  const int64_t state = live ? (bb * D + d) * St + s : 0;      // [bb, d, s]
  float* part = dc_part + ((int64_t)bb * gridDim.x + blockIdx.x) * S * St;

  // forward: h_{t-1} into da[t]; h ends as h_{S-1}
  float h = (live && h0 != nullptr) ? h0[state] : 0.0f;
  for (int64_t t0 = 0; t0 < S; t0 += U) {
    float av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t t = t0 + u;
      const bool in = live && t < S;
      av[u] = in ? a[at + t * step_ad] : 0.0f;
      bv[u] = in ? b[at + t * step_ad] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t t = t0 + u;
      if (t >= S) break;
      if (live) da[at + t * step_ad] = h;
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
    }
  }

  // reverse: steps t1-1 down to t1-U a round
  float g = live ? dh_last[state] : 0.0f;
  for (int64_t t1 = S; t1 > 0; t1 -= U) {
    float av[U], hv[U], yv[U], cv[U], p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t t = t1 - 1 - u;
      const bool in = live && t >= 0;
      av[u] = in ? a[at + t * step_ad] : 0.0f;
      hv[u] = in ? da[at + t * step_ad] : 0.0f;
      yv[u] = in ? dy[yt + t * D] : 0.0f;
      cv[u] = in ? to_f32(cp[t * St]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t t = t1 - 1 - u;
      p[u] = 0.0f;
      if (t < 0 || !live) continue;
      g = __fadd_rn(g, __fmul_rn(yv[u], cv[u]));
      da[at + t * step_ad] = __fmul_rn(g, hv[u]);
      db[at + t * step_ad] = g;
      p[u] = __fmul_rn(h, yv[u]);             // h_t * dy_t, a term of dc_t[s]
      g = __fmul_rn(g, av[u]);
      h = hv[u];
    }
    // the warp's channels, then the CTA's warps in order
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int off = G; off < 32; off <<= 1) p[u] += __shfl_xor_sync(0xffffffffu, p[u], off);
      if (lane < G) red[warp][u][lane] = p[u];
    }
    __syncthreads();
    for (int i = tid; i < U * St; i += kThreads) {
      const int u = i / St, st = i - u * St;
      const int64_t t = t1 - 1 - u;
      if (t < 0) continue;
      float sum = red[0][u][st];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += red[w][u][st];
      part[t * St + st] = sum;
    }
    __syncthreads();
  }
  if (live) dh0[state] = g;
}

// dc[b, t, s] = sum over the CTAs k of dc_part[b, k, t, s], in k order
template <typename C>
__global__ void ssm_scan_dc_sum(const float* __restrict__ dc_part, C* __restrict__ dc,
                                int64_t B, int64_t S, int St, int n_blk) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t per_row = S * St;
  if (i >= B * per_row) return;
  const int64_t bb = i / per_row, ts = i - bb * per_row;
  const float* p = dc_part + bb * n_blk * per_row + ts;
  float sum = 0.0f;
  for (int k = 0; k < n_blk; ++k) sum += p[k * per_row];
  dc[i] = from_f32<C>(sum);
}

template <int G, typename C>
cudaError_t run_bwd(const float* a, const float* b, const C* c, const float* h0, const float* dy,
                    const float* dh_last, float* da, float* db, C* dc, float* dh0,
                    float* dc_part, int64_t B, int64_t S, int64_t D, int St,
                    cudaStream_t stream) {
  constexpr int kCh = kThreads / G;
  const int64_t n_blk = (D + kCh - 1) / kCh;
  if (n_blk > 0x7fffffffLL || B > 65535) return cudaErrorInvalidConfiguration;
  ssm_scan_bwd_kernel<G, 8, C><<<dim3((unsigned)n_blk, (unsigned)B), kThreads, 0, stream>>>(
      a, b, c, h0, dy, dh_last, da, db, dh0, dc_part, S, D, St);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = B * S * St;
  ssm_scan_dc_sum<C><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(dc_part, dc, B, S, St,
                                                                       (int)n_blk);
  return cudaGetLastError();
}

template <typename C>
cudaError_t launch_bwd(int G, const float* a, const float* b, const C* c, const float* h0,
                       const float* dy, const float* dh_last, float* da, float* db, C* dc,
                       float* dh0, float* dc_part, int64_t B, int64_t S, int64_t D, int St,
                       cudaStream_t stream) {
  switch (G) {
#define SSM_BWD_CASE(g)                                                                     \
  case g:                                                                                   \
    return run_bwd<g, C>(a, b, c, h0, dy, dh_last, da, db, dc, dh0, dc_part, B, S, D, St, \
                         stream);
    SSM_BWD_CASE(1) SSM_BWD_CASE(2) SSM_BWD_CASE(4) SSM_BWD_CASE(8) SSM_BWD_CASE(16)
    SSM_BWD_CASE(32)
#undef SSM_BWD_CASE
    default: return cudaErrorInvalidValue;
  }
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

// The backward of ssm_scan_fwd.  a, b: [B, S, D, St] f32; c: [B, S, St]
// in c_dtype; h0: [B, D, St] f32 or null (the forward started from zero);
// dy (the cotangent of y): [B, S, D] f32; dh_last (the cotangent of
// h_last): [B, D, St] f32; da, db: [B, S, D, St] f32; dc: [B, S, St] in
// c_dtype; dh0: [B, D, St] f32 (written also when h0 is null); dc_part:
// f32 scratch of ssm_scan_bwd_part_floats(B, S, D, St) floats; all
// contiguous, 1 <= St <= 32.  Launches on `stream` and returns the
// launches' cudaError_t (0 = queued).
extern "C" long long ssm_scan_bwd_part_floats(long long B, long long S, long long D, int St) {
  int G = 1;
  while (G < St) G <<= 1;
  const long long ch = kThreads / G;
  return B * ((D + ch - 1) / ch) * S * St;
}

extern "C" int ssm_scan_bwd(const void* a, const void* b, const void* c, const void* h0,
                            const void* dy, const void* dh_last, void* da, void* db, void* dc,
                            void* dh0, void* dc_part, int c_dtype, long long B, long long S,
                            long long D, int St, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || St < 1 || St > 32) return (int)cudaErrorInvalidValue;
  int G = 1;
  while (G < St) G <<= 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a_ = static_cast<const float*>(a);
  const float* b_ = static_cast<const float*>(b);
  const float* h0_ = static_cast<const float*>(h0);
  const float* dy_ = static_cast<const float*>(dy);
  const float* dhl_ = static_cast<const float*>(dh_last);
  float* da_ = static_cast<float*>(da);
  float* db_ = static_cast<float*>(db);
  float* dh0_ = static_cast<float*>(dh0);
  float* part_ = static_cast<float*>(dc_part);
  switch (c_dtype) {
    case 0:
      return (int)launch_bwd<float>(G, a_, b_, static_cast<const float*>(c), h0_, dy_, dhl_,
                                    da_, db_, static_cast<float*>(dc), dh0_, part_, B, S, D,
                                    St, s);
    case 1:
      return (int)launch_bwd<__nv_bfloat16>(G, a_, b_, static_cast<const __nv_bfloat16*>(c),
                                            h0_, dy_, dhl_, da_, db_,
                                            static_cast<__nv_bfloat16*>(dc), dh0_, part_, B, S,
                                            D, St, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
