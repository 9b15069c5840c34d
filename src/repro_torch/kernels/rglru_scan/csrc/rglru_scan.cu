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
// 1, B = 8) 0.25 MB, where the launch itself is the floor.  Beside the
// bytes sits the chain: S dependent multiply-adds per channel; a lone
// warp walking it from registers and storing each h takes ~5.5 ns a step
// on an H100, ~1.8 us at S = 333, whatever the card does around it.
//
// Design.  The TPU kernel replaces the chain with an associative scan
// inside each VMEM chunk, which sums in another order; here the chain is
// kept step by step, so the only question is how to keep it fed.
// * Staged form (S > 1): a CTA owns `channels` (4, 8, 16 or 32)
//   consecutive channels of one batch row; the host picks that width so
//   the grid reaches every SM wherever B * R allows (ops.py::scan_tiles).
//   Warp 0 walks the chains, one lane per channel, reading a and b from
//   shared memory only and storing each step's h straight to hs (a
//   coalesced run of `channels` floats).  The width is a template
//   argument, so the step stride in shared memory is a constant and each
//   read is one LDS at an immediate offset (with a runtime stride the
//   same loop ran twice as slow); the chain reads blocks of 16 steps into
//   registers one block ahead of their updates.  Warps 1-3 stream [chunk
//   x channels] tiles of a and b into a ring of `stages` stages with cp.async
//   (16-byte copies where R and the pointers allow, 4-byte ones
//   otherwise), `stages` chunks ahead of the chain.  Each stage has two
//   mbarriers: `full`, which every copy thread arrives on when its copies
//   have landed (cp.async.mbarrier.arrive.noinc), and `empty`, which the
//   chain arrives on when it has read the stage.  So the chain waits only
//   when memory is behind it, and the copies only when the ring is full;
//   there is no block-wide barrier after the set-up.
// * Direct form (S = 1, a decode step): one thread per (b, r), no staging;
//   the launch is the floor there.
// * Backward (rglru_scan_bwd): the reverse chain of the same recurrence,
//   dh_t = dhs_t + a_{t+1} dh_{t+1} from the h_last cotangent, da_t = dh_t
//   h_{t-1} (from the saved hs), db_t = dh_t, dh0 = a_0 dh_0, one thread
//   per (b, r) walking t backwards, bit-equal to the plain loop.  Bytes
//   bound it too: a, hs and dhs read, da and db written, 20 bytes per
//   element against 3 flops (at recurrentgemma's training shape B = 4, S =
//   512, R = 2560: 105 MB, ~31 us at 3.35 TB/s).  B * R threads (10240
//   there) keep 48 loads each in flight; the ring-fed chain warp of the
//   forward is the pattern for a later redesign.
// No atomics: every output is written by exactly one thread in a fixed
// order, so the result is the same on every run and every stream.
// Left on the table: fusing the gates (sigmoid, softplus, exp, sqrt) into
// the kernel, which would drop a and b's round trip through memory.
#include <cuda_runtime.h>
#include <stdint.h>

// Phase stamps for scripts/torch_scan_trace.py, which defines this macro
// before it includes this file; nothing in a normal build.  RGLRU_STAMP(
// kind, k, dep) stamps the time once `dep` is ready; kind 0 = start, 1 =
// the chain waits for chunk k, 2 = chunk k has landed, 3 = the chain is
// done with chunk k, 4 = the copies of chunk k are being issued, 5 = end.
#ifndef RGLRU_STAMP
#define RGLRU_STAMP(kind, k, dep) ((void)0)
#endif

namespace {

constexpr int kSMs = 132;
constexpr int kThreads = 128;                // warp 0: chains; warps 1-3: copies
constexpr int kCopyThreads = kThreads - 32;
constexpr int kBlock = 16;                   // chain steps read ahead as one block
constexpr int kMaxSmem = 232448;             // an H100 CTA's opt-in shared memory
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kDirectUnroll = 16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <bool kVec16>
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src) {
  if constexpr (kVec16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// arrives on `bar` once every cp.async this thread has issued so far has landed
__device__ __forceinline__ void mbar_arrive_on_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// steps t .. t + kBlock - 1 of a stage's a and b tiles into registers
template <int kStride>
__device__ __forceinline__ void read_block(const float* sa, const float* sb, int t, float* a,
                                           float* b) {
#pragma unroll
  for (int u = 0; u < kBlock; ++u) {
    a[u] = sa[(t + u) * kStride];
    b[u] = sb[(t + u) * kStride];
  }
}

// kBlock updates of the chain, each h stored at *o, o stepping by R
__device__ __forceinline__ float walk_block(float h, const float* a, const float* b, float*& o,
                                            int64_t R) {
#pragma unroll
  for (int u = 0; u < kBlock; ++u) {
    h = __fadd_rn(__fmul_rn(a[u], h), b[u]);
    *o = h;
    o += R;
  }
  return h;
}

// Shared memory of the staged form: the ring, per stage a [chunk x
// channels] tile of a, then one of b; then `stages` full and `stages`
// empty mbarriers (16 bytes a stage).  ops.py::ring_bytes mirrors it.
size_t ring_bytes(int channels, int chunk, int stages) {
  return (size_t)stages * (16 + 2 * (size_t)chunk * channels * sizeof(float));
}

template <int kChannels, bool kVec16>
__global__ void __launch_bounds__(kThreads)
rglru_scan_staged(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ hs,
                  float* __restrict__ h_last, int64_t S, int64_t R, int chunk, int stages) {
  constexpr int channels = kChannels;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tile = chunk * channels;                 // floats of one array in a stage
  float* ring = reinterpret_cast<float*>(smem);
  const uint32_t full0 = smem_u32(ring + (size_t)stages * 2 * tile);
  const uint32_t empty0 = full0 + 8 * stages;

  const int64_t bb = blockIdx.y;
  const int64_t r0 = (int64_t)blockIdx.x * channels;
  const int nc = (int)(R - r0 < channels ? R - r0 : channels);
  const int n_chunks = (int)((S + chunk - 1) / chunk);
  const int64_t row0 = bb * S * R + r0;              // a[bb, 0, r0]

  if (threadIdx.x == 0) {
    RGLRU_STAMP(0, 0, 0.0f);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, kCopyThreads);
      mbar_init(empty0 + 8 * s, 1);
    }
  }
  __syncthreads();

  if (threadIdx.x >= 32) {
    // copy warps: chunk k into stage k % stages, once the chain has read
    // that stage's previous chunk
    constexpr int kW = kVec16 ? 4 : 1;               // floats per copy
    constexpr int kPerRow = kChannels / kW;          // copies per step of a full block
    const int per_row = nc / kW;
    int s = 0;
    uint32_t phase = 0;                              // of stage s's use, mod 2
    for (int k = 0; k < n_chunks; ++k) {
      if (k >= stages) mbar_wait(empty0 + 8 * s, phase ^ 1);
      if (threadIdx.x == 32) RGLRU_STAMP(4, k, 0.0f);
      const int64_t t0 = (int64_t)k * chunk;
      const int n = (int)(S - t0 < chunk ? S - t0 : chunk);
      float* sa = ring + (size_t)s * 2 * tile;
      const float* ga = a + row0 + t0 * R;
      const float* gb = b + row0 + t0 * R;
      // step t, floats c .. c + kW - 1 of both arrays
      auto copy = [&](int t, int c) {
        cp_async<kVec16>(smem_u32(sa + t * channels + c), ga + t * R + c);
        cp_async<kVec16>(smem_u32(sa + tile + t * channels + c), gb + t * R + c);
      };
      if (per_row == kPerRow) {
        for (int i = threadIdx.x - 32; i < n * kPerRow; i += kCopyThreads)
          copy(i / kPerRow, (i % kPerRow) * kW);
      } else {                                       // the last block of a ragged R
        for (int i = threadIdx.x - 32; i < n * per_row; i += kCopyThreads)
          copy(i / per_row, (i % per_row) * kW);
      }
      mbar_arrive_on_copies(full0 + 8 * s);
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // warp 0: the chains, lane c on channel r0 + c
  const int lane = threadIdx.x;
  const bool live = lane < nc;
  float h = (live && h0 != nullptr) ? h0[bb * R + r0 + lane] : 0.0f;
  float* out = hs + row0 + lane;
  int s = 0;
  uint32_t phase = 0;                                // of stage s's use, mod 2
  for (int k = 0; k < n_chunks; ++k) {
    if (lane == 0) RGLRU_STAMP(1, k, 0.0f);
    mbar_wait(full0 + 8 * s, phase);
    if (lane == 0) RGLRU_STAMP(2, k, 0.0f);
    const int64_t t0 = (int64_t)k * chunk;
    const int n = (int)(S - t0 < chunk ? S - t0 : chunk);
    if (live) {
      // Blocks of kBlock steps, each read into registers one block ahead of
      // the updates that use it (ping-pong between two register buffers),
      // so no update waits on a shared-memory load.  The stride between
      // steps is a constant: every load is one LDS at an immediate offset.
      const float* sa = ring + (size_t)s * 2 * tile + lane;
      const float* sb = sa + tile;
      float* o = out + t0 * R;
      float a0[kBlock], b0[kBlock], a1[kBlock], b1[kBlock];
      int t = 0;
      if (n >= kBlock) read_block<channels>(sa, sb, 0, a0, b0);
      for (; t + 2 * kBlock <= n; t += 2 * kBlock) {
        read_block<channels>(sa, sb, t + kBlock, a1, b1);
        h = walk_block(h, a0, b0, o, R);
        if (t + 3 * kBlock <= n) read_block<channels>(sa, sb, t + 2 * kBlock, a0, b0);
        h = walk_block(h, a1, b1, o, R);
      }
      if (t + kBlock <= n) {
        h = walk_block(h, a0, b0, o, R);
        t += kBlock;
      }
      for (; t < n; ++t) {
        h = __fadd_rn(__fmul_rn(sa[t * channels], h), sb[t * channels]);
        *o = h;
        o += R;
      }
    }
    if (lane == 0) RGLRU_STAMP(3, k, h);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
  if (live) h_last[bb * R + r0 + lane] = h;
  if (lane == 0) RGLRU_STAMP(5, 0, h);
}

// S = 1 (and any S): one thread owns one (b, r) and walks S in order,
// kDirectUnroll steps of a and b loaded ahead of their updates.
__global__ void rglru_scan_direct(const float* __restrict__ a, const float* __restrict__ b,
                                  const float* __restrict__ h0, float* __restrict__ hs,
                                  float* __restrict__ h_last, int64_t B, int64_t S,
                                  int64_t R) {
  const int64_t ch = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;   // (b, r)
  if (ch >= B * R) return;
  const int64_t bb = ch / R;
  const int64_t r = ch - bb * R;
  const int64_t base = bb * S * R + r;
  float h = h0 != nullptr ? h0[ch] : 0.0f;
  for (int64_t t0 = 0; t0 < S; t0 += kDirectUnroll) {
    float av[kDirectUnroll], bv[kDirectUnroll];
#pragma unroll
    for (int u = 0; u < kDirectUnroll; ++u) {
      const int64_t t = t0 + u;
      av[u] = t < S ? a[base + t * R] : 0.0f;
      bv[u] = t < S ? b[base + t * R] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kDirectUnroll; ++u) {
      const int64_t t = t0 + u;
      if (t >= S) break;
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      hs[base + t * R] = h;
    }
  }
  h_last[ch] = h;
}

// The backward: one thread owns one (b, r) and walks t = S-1 .. 0 with the
// cotangent g of h_t in a register, kDirectUnroll steps of a, dhs and the
// saved h_{t-1} loaded ahead of their updates:
//   g = dhs[t] + g;  da[t] = g * h_{t-1};  db[t] = g;  g = g * a[t]
// from g = dh_last, each product and sum rounded alone (__fadd_rn /
// __fmul_rn) in the plain version's order, so every output is bit-equal
// to it; dh0 = the last g.  h_{t-1} is the forward's hs[t - 1] (h0, or
// zero, at t = 0).
__global__ void rglru_scan_bwd_direct(const float* __restrict__ a,
                                      const float* __restrict__ hs,
                                      const float* __restrict__ h0,
                                      const float* __restrict__ dhs,
                                      const float* __restrict__ dh_last,
                                      float* __restrict__ da, float* __restrict__ db,
                                      float* __restrict__ dh0, int64_t B, int64_t S,
                                      int64_t R) {
  const int64_t ch = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;   // (b, r)
  if (ch >= B * R) return;
  const int64_t bb = ch / R;
  const int64_t r = ch - bb * R;
  const int64_t base = bb * S * R + r;
  const float first = h0 != nullptr ? h0[ch] : 0.0f;   // h_{-1}
  float g = dh_last[ch];
  for (int64_t t1 = S; t1 > 0; t1 -= kDirectUnroll) {  // steps t1-1 down to t1-kDirectUnroll
    float av[kDirectUnroll], dv[kDirectUnroll], hv[kDirectUnroll];
#pragma unroll
    for (int u = 0; u < kDirectUnroll; ++u) {
      const int64_t t = t1 - 1 - u;
      av[u] = t >= 0 ? a[base + t * R] : 0.0f;
      dv[u] = t >= 0 ? dhs[base + t * R] : 0.0f;
      hv[u] = t > 0 ? hs[base + (t - 1) * R] : first;
    }
#pragma unroll
    for (int u = 0; u < kDirectUnroll; ++u) {
      const int64_t t = t1 - 1 - u;
      if (t < 0) break;
      g = __fadd_rn(dv[u], g);
      da[base + t * R] = __fmul_rn(g, hv[u]);
      db[base + t * R] = g;
      g = __fmul_rn(g, av[u]);
    }
  }
  dh0[ch] = g;
}

// threads a block of the one-thread-a-channel kernels: shrink blocks until
// every SM gets one
int direct_threads(int64_t total) {
  int threads = 128;
  while (threads > 32 && (total + threads - 1) / threads < kSMs) threads >>= 1;
  return threads;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <int kChannels, bool kVec16>
cudaError_t launch_staged(const float* a, const float* b, const float* h0, float* hs,
                          float* h_last, int64_t B, int64_t S, int64_t R, int chunk,
                          int stages, cudaStream_t stream) {
  const size_t smem = ring_bytes(kChannels, chunk, stages);
  if (smem > (size_t)kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(rglru_scan_staged<kChannels, kVec16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((R + kChannels - 1) / kChannels), (unsigned)B);
  rglru_scan_staged<kChannels, kVec16><<<grid, kThreads, smem, stream>>>(a, b, h0, hs, h_last,
                                                                         S, R, chunk, stages);
  return cudaGetLastError();
}

template <int kChannels>
cudaError_t launch_width(const float* a, const float* b, const float* h0, float* hs,
                         float* h_last, int64_t B, int64_t S, int64_t R, int chunk, int stages,
                         cudaStream_t stream) {
  // 16-byte copies need every row of a block to start on 16 bytes
  const bool vec = R % 4 == 0 && kChannels % 4 == 0 && aligned16(a) && aligned16(b);
  return vec ? launch_staged<kChannels, true>(a, b, h0, hs, h_last, B, S, R, chunk, stages,
                                              stream)
             : launch_staged<kChannels, false>(a, b, h0, hs, h_last, B, S, R, chunk, stages,
                                               stream);
}

}  // namespace

// a, b: [B, S, R] f32; h0: [B, R] f32 or null (start from zero); hs:
// [B, S, R] f32; h_last: [B, R] f32; all contiguous.  channels = 0 takes
// the direct form; otherwise the staged form with `channels` (4, 8, 16 or
// 32) channels a CTA, `chunk` (a multiple of 8) steps a stage and `stages`
// ring stages (ops.py::scan_tiles picks them).  Launches on `stream` and
// returns the launch's cudaError_t (0 = queued).
extern "C" int rglru_scan_fwd(const void* a, const void* b, const void* h0, void* hs,
                              void* h_last, long long B, long long S, long long R,
                              int channels, int chunk, int stages, void* stream) {
  if (B <= 0 || S <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  const float* a_ = static_cast<const float*>(a);
  const float* b_ = static_cast<const float*>(b);
  const float* h0_ = static_cast<const float*>(h0);
  float* hs_ = static_cast<float*>(hs);
  float* hl_ = static_cast<float*>(h_last);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels == 0) {
    const int64_t total = B * R;
    const int threads = direct_threads(total);
    const int64_t blocks = (total + threads - 1) / threads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    rglru_scan_direct<<<(unsigned)blocks, threads, 0, s>>>(a_, b_, h0_, hs_, hl_, B, S, R);
    return (int)cudaGetLastError();
  }
  if (chunk < 8 || chunk % 8 != 0 || stages < 1 ||
      ring_bytes(channels, chunk, stages) > (size_t)kMaxSmem || B > 65535)
    return (int)cudaErrorInvalidValue;
  if ((R + channels - 1) / channels > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  switch (channels) {
    case 4: return (int)launch_width<4>(a_, b_, h0_, hs_, hl_, B, S, R, chunk, stages, s);
    case 8: return (int)launch_width<8>(a_, b_, h0_, hs_, hl_, B, S, R, chunk, stages, s);
    case 16: return (int)launch_width<16>(a_, b_, h0_, hs_, hl_, B, S, R, chunk, stages, s);
    case 32: return (int)launch_width<32>(a_, b_, h0_, hs_, hl_, B, S, R, chunk, stages, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward of rglru_scan_fwd.  a, hs (the forward's output), dhs (the
// cotangent of hs): [B, S, R] f32; h0: [B, R] f32 or null (the forward
// started from zero); dh_last (the cotangent of h_last): [B, R] f32; da,
// db: [B, S, R] f32; dh0: [B, R] f32 (the cotangent of h0, written also
// when h0 is null); all contiguous.  Launches on `stream` and returns the
// launch's cudaError_t (0 = queued).
extern "C" int rglru_scan_bwd(const void* a, const void* hs, const void* h0, const void* dhs,
                              const void* dh_last, void* da, void* db, void* dh0, long long B,
                              long long S, long long R, void* stream) {
  if (B <= 0 || S <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  const int64_t total = B * R;
  const int threads = direct_threads(total);
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  rglru_scan_bwd_direct<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(hs),
      static_cast<const float*>(h0), static_cast<const float*>(dhs),
      static_cast<const float*>(dh_last), static_cast<float*>(da), static_cast<float*>(db),
      static_cast<float*>(dh0), B, S, R);
  return (int)cudaGetLastError();
}
