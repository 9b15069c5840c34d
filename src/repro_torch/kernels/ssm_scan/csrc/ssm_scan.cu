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
// The training form (ssm_scan_train_fwd) is the same kernel with one more
// store: each lane writes its state at the end of every kCkptChunk-step
// chunk (and at t = S-1) into h_ckpt [B, ceil(S / kCkptChunk), D, St], a
// 32nd of a's bytes.  The arithmetic is untouched, so y and h_last are
// bit-identical to the serving form's.
//
// The backward (ssm_scan_bwd), walking t = S-1 .. 0 from g = dh_last:
//   g_t = g + dy[b, t, d] * c[b, t, s]     (the cotangent of h_t)
//   da[b, t, d, s] = g_t * h_{t-1},  db = g_t,  g = g_t * a_t
//   dc[b, t, s] = sum_d h_t[s] * dy[b, t, d],  dh0 = the last g
// What bounds it: bytes.  It must read a and b and write da and db, four
// passes over [B, S, D, St] f32 (at falcon-mamba's training shape B = 4, S
// = 512, D = 8192, St = 16: 4.3 GB, 1.28 ms at 3.35 TB/s); dy, c, the
// checkpoints and dc's partials add ~5%.  The first design kept no
// states: each lane re-ran its whole chain, parked h_{t-1} in da and read
// it back, seven passes (2.91 ms there on an H100 SXM).
// Design.  One CTA of kThreads lanes owns kThreads / G channels of one
// batch row (G lanes a channel, lane s on state s, as the forward) and
// walks the chunks from last to first.  Chunk j's a and b tiles ([32
// steps x channels x St], 64 KB at St = 16) and its dy come into shared
// memory by cp.async, into three buffers where they fit (St <= 16; two
// otherwise): chunks j-1 and j-2 are in flight (and j-2's c, by plain
// loads held in registers) while chunk j is worked: with one CTA an SM,
// the bytes in flight are what the ring holds.
// For each chunk a lane re-runs its 32 steps from the chunk's starting
// state (the checkpoint before it; h0 or zero for the first), rounded as
// the forward (__fmul_rn, then __fadd_rn), writing each h_t over b_t in
// shared memory, then walks the chunk backwards from there: the
// checkpoint is the exact state, so da, db and dh0 are bit-equal to the
// plain version.  dc sums over D, which spans CTAs: per step each warp
// adds its channels' h_t dy_t with shuffles, and at the chunk's end the
// CTA adds its warps' sums in warp order into one row of per-CTA partials
// [B, D / channels, S, St]; ssm_scan_dc_sum then adds the partials of
// each (b, t, s) in CTA order and rounds to c's dtype.  Every sum runs in
// a fixed order and there are no atomics: the same bits on every call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCkptChunk = 32;               // steps a checkpoint chunk (ops.py::CKPT_CHUNK)
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;             // an H100 CTA's opt-in shared memory

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// kSave: also store h at the end of every kCkptChunk steps (the training form)
template <int G, int U, bool kSave, typename C>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const C* __restrict__ c, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_last, float* __restrict__ h_ckpt,
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
  // h_ckpt[bb, j, d, s]: one chunk j apart by D * St
  float* kp = kSave ? h_ckpt + (bb * ((S + kCkptChunk - 1) / kCkptChunk) * D + d) * St + s
                    : nullptr;

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
      if constexpr (kSave) {
        if (live && ((t + 1) % kCkptChunk == 0 || t == S - 1))
          kp[(t / kCkptChunk) * step_ad] = h;
      }
      // rounded intrinsics, so no instantiation contracts them into an FMA
      // and both forms give the same y
      float p = __fmul_rn(h, cv[u]);
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, off, G));
      if (live && s == 0) yp[t * step_y] = p;
    }
  }
  if (live) h_last[(bb * D + d) * St + s] = h;
}

template <int G, int U, bool kSave, typename C>
cudaError_t run(dim3 grid, const float* a, const float* b, const C* c, const float* h0,
                float* y, float* h_last, float* h_ckpt, int64_t B, int64_t S, int64_t D, int St,
                cudaStream_t stream) {
  ssm_scan_kernel<G, U, kSave, C><<<grid, kThreads, 0, stream>>>(a, b, c, h0, y, h_last, h_ckpt,
                                                                 B, S, D, St);
  return cudaGetLastError();
}

template <int U, bool kSave, typename C>
cudaError_t launch_g(int G, dim3 grid, const float* a, const float* b, const C* c,
                     const float* h0, float* y, float* h_last, float* h_ckpt, int64_t B,
                     int64_t S, int64_t D, int St, cudaStream_t stream) {
  switch (G) {
#define SSM_FWD_CASE(g)                                                                      \
  case g:                                                                                    \
    return run<g, U, kSave, C>(grid, a, b, c, h0, y, h_last, h_ckpt, B, S, D, St, stream);
    SSM_FWD_CASE(1) SSM_FWD_CASE(2) SSM_FWD_CASE(4) SSM_FWD_CASE(8) SSM_FWD_CASE(16)
    SSM_FWD_CASE(32)
#undef SSM_FWD_CASE
    default: return cudaErrorInvalidValue;
  }
}

template <bool kSave, typename C>
cudaError_t launch(int G, const float* a, const float* b, const C* c, const float* h0,
                   float* y, float* h_last, float* h_ckpt, int64_t B, int64_t S, int64_t D,
                   int St, cudaStream_t stream) {
  const int64_t threads = B * D * G;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks);
  if (S == 1)
    return launch_g<1, kSave, C>(G, grid, a, b, c, h0, y, h_last, h_ckpt, B, S, D, St, stream);
  return launch_g<8, kSave, C>(G, grid, a, b, c, h0, y, h_last, h_ckpt, B, S, D, St, stream);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// The backward's shared memory, in floats: nbuf chunk buffers (three
// where they fit in a CTA's shared memory, as at St = 16, else two), each
// a [kCkptChunk][channels * St] tile of a, then one of b (each h_t
// overwrites b_t), dy [kCkptChunk][channels] and c [kCkptChunk][St]; then
// the warps' dc sums [warps][kCkptChunk][G].  Every area starts on 16 bytes.
struct BwdSmem {
  int tile, dy, c, buf, red, nbuf, total;
  __host__ __device__ BwdSmem(int G, int St) {
    const int ch = kThreads / G;
    tile = round4(kCkptChunk * ch * St);
    dy = round4(kCkptChunk * ch);
    c = round4(kCkptChunk * St);
    buf = 2 * tile + dy + c;
    red = (kThreads / 32) * kCkptChunk * G;
    nbuf = (3 * buf + red) * 4 <= kMaxSmem ? 3 : 2;
    total = nbuf * buf + red;
  }
};

// The backward over one CTA of kThreads / G channels of batch row
// blockIdx.y, chunk by chunk from the last; vec16: a and b rows copied in
// 16-byte pieces (St % 4 == 0, 16-byte aligned a and b), else 4-byte.
template <int G, typename C>
__global__ void __launch_bounds__(kThreads, 1)
ssm_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const C* __restrict__ c, const float* __restrict__ h0,
                    const float* __restrict__ h_ckpt, const float* __restrict__ dy,
                    const float* __restrict__ dh_last, float* __restrict__ da,
                    float* __restrict__ db, float* __restrict__ dh0, float* __restrict__ dc_part,
                    int64_t S, int64_t D, int St, int vec16) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kCh = kThreads / G;            // channels a CTA
  constexpr int kCRegs = (kCkptChunk * 32 + kThreads - 1) / kThreads;   // c values a thread
  extern __shared__ __align__(16) float smem[];
  const BwdSmem L(G, St);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t bb = blockIdx.y;
  const int64_t d0 = (int64_t)blockIdx.x * kCh;
  const int nc = (int)(D - d0 < kCh ? D - d0 : kCh);      // live channels of this CTA
  const int ch = tid / G, s = tid % G;
  const bool live = ch < nc && s < St;
  const int rs = kCh * St;                    // floats a step in the a and b tiles
  const int off = ch * St + s;                // this lane's float in a step
  const int n_chunks = (int)((S + kCkptChunk - 1) / kCkptChunk);
  const int64_t step_ad = D * St;
  const int64_t at = ((bb * S) * D + d0) * St + off;        // [bb, 0, d0 + ch, s]
  const int64_t state = (bb * D + d0) * St + off;           // [bb, d0 + ch, s]
  float* red = smem + L.nbuf * L.buf;
  float* part = dc_part + ((int64_t)bb * gridDim.x + blockIdx.x) * S * St;

  // chunk j's a, b and dy into buffer j % nbuf, as this thread's share of
  // cp.async copies (one commit group)
  auto copy_chunk = [&](int j) {
    float* buf = smem + (j % L.nbuf) * L.buf;
    const int64_t t0 = (int64_t)j * kCkptChunk;
    const int n = (int)(S - t0 < kCkptChunk ? S - t0 : kCkptChunk);
    const int64_t g0 = ((bb * S + t0) * D + d0) * St;       // a[bb, t0, d0, 0]
    const int w = vec16 ? 4 : 1, per_row = nc * St / w;
    for (int i = tid; i < n * per_row; i += kThreads) {
      const int u = i / per_row, k = (i - u * per_row) * w;
      const int64_t src = g0 + u * step_ad + k;
      if (vec16) {
        cp_async16(smem_u32(buf + u * rs + k), a + src);
        cp_async16(smem_u32(buf + L.tile + u * rs + k), b + src);
      } else {
        cp_async4(smem_u32(buf + u * rs + k), a + src);
        cp_async4(smem_u32(buf + L.tile + u * rs + k), b + src);
      }
    }
    const float* gy = dy + (bb * S + t0) * D + d0;
    for (int i = tid; i < n * nc; i += kThreads) {
      const int u = i / nc, k = i - u * nc;
      cp_async4(smem_u32(buf + 2 * L.tile + u * kCh + k), gy + u * D + k);
    }
    cp_async_commit();
  };
  // chunk j's c rows (contiguous [n][St]) into registers
  auto load_c = [&](int j, float (&cr)[kCRegs]) {
    const int64_t t0 = (int64_t)j * kCkptChunk;
    const int n = (int)(S - t0 < kCkptChunk ? S - t0 : kCkptChunk);
    const C* gc = c + (bb * S + t0) * St;
#pragma unroll
    for (int r = 0; r < kCRegs; ++r) {
      const int i = tid + r * kThreads;
      cr[r] = i < n * St ? to_f32(gc[i]) : 0.0f;
    }
  };
  auto store_c = [&](int j, const float (&cr)[kCRegs]) {
    float* sc = smem + (j % L.nbuf) * L.buf + 2 * L.tile + L.dy;
#pragma unroll
    for (int r = 0; r < kCRegs; ++r) {
      const int i = tid + r * kThreads;
      if (i < kCkptChunk * St) sc[i] = cr[r];
    }
  };
  // the state chunk j starts from: the checkpoint at the end of chunk j-1
  auto start_state = [&](int j) -> float {
    if (!live) return 0.0f;
    if (j == 0) return h0 != nullptr ? h0[state] : 0.0f;
    return h_ckpt[((bb * n_chunks + j - 1) * D + d0) * St + off];
  };

  // chunks go out P = nbuf - 1 ahead of the one being worked; every
  // iteration commits one cp.async group (empty past chunk 0), so chunk j
  // has landed once at most P groups are pending
  const int P = L.nbuf - 1;
  float cr[kCRegs];
  for (int k = 0; k < P; ++k) {
    const int j = n_chunks - 1 - k;
    if (j >= 0) {
      copy_chunk(j);
      load_c(j, cr);
      store_c(j, cr);
    } else {
      cp_async_commit();
    }
  }
  float h_next = start_state(n_chunks - 1);
  float g = live ? dh_last[state] : 0.0f;
  for (int j = n_chunks - 1; j >= 0; --j) {
    const float h_start = h_next;
    const int jn = j - P;                     // the chunk whose reads go out now
    if (jn >= 0) {
      copy_chunk(jn);
      load_c(jn, cr);
    } else {
      cp_async_commit();
    }
    if (j > 0) h_next = start_state(j - 1);
    if (P == 2)
      cp_async_wait<2>();
    else
      cp_async_wait<1>();
    __syncthreads();                          // chunk j is in shared memory
    const float* buf = smem + (j % L.nbuf) * L.buf;
    const float* sa = buf + off;
    float* sh = const_cast<float*>(buf) + L.tile + off;      // b_t, then h_t
    const float* sy = buf + 2 * L.tile + ch;
    const float* sc = buf + 2 * L.tile + L.dy + s;
    const int64_t t0 = (int64_t)j * kCkptChunk;
    const int n = (int)(S - t0 < kCkptChunk ? S - t0 : kCkptChunk);

    // re-run the chunk from its starting state, rounded as the forward
    if (live) {
      float h = h_start;
      for (int u = 0; u < n; ++u) {
        h = __fadd_rn(__fmul_rn(sa[u * rs], h), sh[u * rs]);
        sh[u * rs] = h;
      }
    }
    // walk it back
    float h_t = live ? sh[(n - 1) * rs] : 0.0f;
    for (int u = n - 1; u >= 0; --u) {
      const float h_p = u > 0 ? (live ? sh[(u - 1) * rs] : 0.0f) : h_start;
      float p = 0.0f;
      if (live) {
        const float yv = sy[u * kCh], cv = sc[u * St];
        g = __fadd_rn(g, __fmul_rn(yv, cv));
        const int64_t o = at + (t0 + u) * step_ad;
        da[o] = __fmul_rn(g, h_p);
        db[o] = g;
        p = __fmul_rn(h_t, yv);               // h_t * dy_t, a term of dc_t[s]
        g = __fmul_rn(g, sa[u * rs]);
      }
      // the warp's channels, then (below) the CTA's warps in order
#pragma unroll
      for (int o = G; o < 32; o <<= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
      if (lane < G) red[(warp * kCkptChunk + u) * G + lane] = p;
      h_t = h_p;
    }
    __syncthreads();                          // the warps' sums are in; chunk j is done
    for (int i = tid; i < n * St; i += kThreads) {
      const int u = i / St, st = i - u * St;
      float sum = red[u * G + st];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += red[(w * kCkptChunk + u) * G + st];
      part[(t0 + u) * St + st] = sum;
    }
    if (jn >= 0) store_c(jn, cr);
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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <int G, typename C>
cudaError_t run_bwd(const float* a, const float* b, const C* c, const float* h0,
                    const float* h_ckpt, const float* dy, const float* dh_last, float* da,
                    float* db, C* dc, float* dh0, float* dc_part, int64_t B, int64_t S, int64_t D,
                    int St, cudaStream_t stream) {
  constexpr int kCh = kThreads / G;
  const int64_t n_blk = (D + kCh - 1) / kCh;
  if (n_blk > 0x7fffffffLL || B > 65535) return cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) * BwdSmem(G, St).total;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssm_scan_bwd_kernel<G, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int vec16 = St % 4 == 0 && aligned16(a) && aligned16(b);
  ssm_scan_bwd_kernel<G, C><<<dim3((unsigned)n_blk, (unsigned)B), kThreads, smem, stream>>>(
      a, b, c, h0, h_ckpt, dy, dh_last, da, db, dh0, dc_part, S, D, St, vec16);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = B * S * St;
  ssm_scan_dc_sum<C><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(dc_part, dc, B, S, St,
                                                                       (int)n_blk);
  return cudaGetLastError();
}

template <typename C>
cudaError_t launch_bwd(int G, const float* a, const float* b, const C* c, const float* h0,
                       const float* h_ckpt, const float* dy, const float* dh_last, float* da,
                       float* db, C* dc, float* dh0, float* dc_part, int64_t B, int64_t S,
                       int64_t D, int St, cudaStream_t stream) {
  switch (G) {
#define SSM_BWD_CASE(g)                                                                    \
  case g:                                                                                  \
    return run_bwd<g, C>(a, b, c, h0, h_ckpt, dy, dh_last, da, db, dc, dh0, dc_part, B, S, \
                         D, St, stream);
    SSM_BWD_CASE(1) SSM_BWD_CASE(2) SSM_BWD_CASE(4) SSM_BWD_CASE(8) SSM_BWD_CASE(16)
    SSM_BWD_CASE(32)
#undef SSM_BWD_CASE
    default: return cudaErrorInvalidValue;
  }
}

int lanes(int St) {
  int G = 1;
  while (G < St) G <<= 1;
  return G;
}

template <bool kSave>
int forward(const void* a, const void* b, const void* c, const void* h0, void* y, void* h_last,
            void* h_ckpt, int c_dtype, long long B, long long S, long long D, int St,
            void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || St < 1 || St > 32) return (int)cudaErrorInvalidValue;
  const int G = lanes(St);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a_ = static_cast<const float*>(a);
  const float* b_ = static_cast<const float*>(b);
  const float* h0_ = static_cast<const float*>(h0);
  float* y_ = static_cast<float*>(y);
  float* hl_ = static_cast<float*>(h_last);
  float* hk_ = static_cast<float*>(h_ckpt);
  switch (c_dtype) {
    case 0:
      return (int)launch<kSave, float>(G, a_, b_, static_cast<const float*>(c), h0_, y_, hl_,
                                       hk_, B, S, D, St, s);
    case 1:
      return (int)launch<kSave, __nv_bfloat16>(G, a_, b_,
                                               static_cast<const __nv_bfloat16*>(c), h0_, y_,
                                               hl_, hk_, B, S, D, St, s);
    default: return (int)cudaErrorInvalidValue;
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
  return forward<false>(a, b, c, h0, y, h_last, nullptr, c_dtype, B, S, D, St, stream);
}

// The training form: ssm_scan_fwd's arguments and h_ckpt [B, ceil(S /
// chunk), D, St] f32, the state at the end of each chunk of `chunk` steps
// (the last one at t = S-1).  chunk must be the kernels' kCkptChunk (32);
// refused otherwise.
extern "C" int ssm_scan_train_fwd(const void* a, const void* b, const void* c, const void* h0,
                                  void* y, void* h_last, void* h_ckpt, int chunk, int c_dtype,
                                  long long B, long long S, long long D, int St, void* stream) {
  if (chunk != kCkptChunk || h_ckpt == nullptr) return (int)cudaErrorInvalidValue;
  return forward<true>(a, b, c, h0, y, h_last, h_ckpt, c_dtype, B, S, D, St, stream);
}

// The backward of ssm_scan_train_fwd.  a, b: [B, S, D, St] f32; c: [B, S,
// St] in c_dtype; h0: [B, D, St] f32 or null (the forward started from
// zero); h_ckpt: the training forward's checkpoints [B, ceil(S / chunk),
// D, St] f32 (chunk = kCkptChunk, refused otherwise); dy (the cotangent
// of y): [B, S, D] f32; dh_last (the cotangent of h_last): [B, D, St]
// f32; da, db: [B, S, D, St] f32; dc: [B, S, St] in c_dtype; dh0: [B, D,
// St] f32 (written also when h0 is null); dc_part: f32 scratch of
// ssm_scan_bwd_part_floats(B, S, D, St) floats; all contiguous, 1 <= St
// <= 32.  Launches on `stream` and returns the launches' cudaError_t (0 =
// queued).
extern "C" long long ssm_scan_bwd_part_floats(long long B, long long S, long long D, int St) {
  const long long ch = kThreads / lanes(St);
  return B * ((D + ch - 1) / ch) * S * St;
}

extern "C" int ssm_scan_bwd(const void* a, const void* b, const void* c, const void* h0,
                            const void* h_ckpt, const void* dy, const void* dh_last, void* da,
                            void* db, void* dc, void* dh0, void* dc_part, int chunk,
                            int c_dtype, long long B, long long S, long long D, int St,
                            void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || St < 1 || St > 32 || chunk != kCkptChunk ||
      h_ckpt == nullptr)
    return (int)cudaErrorInvalidValue;
  const int G = lanes(St);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a_ = static_cast<const float*>(a);
  const float* b_ = static_cast<const float*>(b);
  const float* h0_ = static_cast<const float*>(h0);
  const float* hk_ = static_cast<const float*>(h_ckpt);
  const float* dy_ = static_cast<const float*>(dy);
  const float* dhl_ = static_cast<const float*>(dh_last);
  float* da_ = static_cast<float*>(da);
  float* db_ = static_cast<float*>(db);
  float* dh0_ = static_cast<float*>(dh0);
  float* part_ = static_cast<float*>(dc_part);
  switch (c_dtype) {
    case 0:
      return (int)launch_bwd<float>(G, a_, b_, static_cast<const float*>(c), h0_, hk_, dy_,
                                    dhl_, da_, db_, static_cast<float*>(dc), dh0_, part_, B, S,
                                    D, St, s);
    case 1:
      return (int)launch_bwd<__nv_bfloat16>(G, a_, b_, static_cast<const __nv_bfloat16*>(c),
                                            h0_, hk_, dy_, dhl_, da_, db_,
                                            static_cast<__nv_bfloat16*>(dc), dh0_, part_, B, S,
                                            D, St, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
