// Grouped per-expert matmul (the MoE expert FFN), hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/moe_gmm/kernel.py::moe_gmm_kernel_call
//   (body _kernel, pl.pallas_call at kernel.py:60).
//
// Computes, for every expert e < E, row c < C and column f < F,
//   out[e, c, f] = sum_{d < D} x[e, c, d] * w[e, d, f]
// with the products and the sum in f32, stored in x's dtype.  x is
// [E, C, D], w is [E, D, F], out is [E, C, F], all contiguous; x and w are
// both f32 or both bf16.
//
// What bounds it on an H100: bytes at decode, operations at the widest
// prefill.  At the MoE path's shapes (E = 32, D x F = 1024 x 512 or 512 x
// 1024, C = 8 .. 416 capacity slots) the expert weights alone are 33.5 MB
// per call in bf16 (10 us at 3.35 TB/s); the flops reach 2 x 32 x 416 x
// 1024 x 512 = 14 GFLOP (14 us at the 989 TFLOP/s bf16 rate) only at the
// widest prefill.
//
// Three kernels; the wrapper picks one by dtype, shape and alignment (the
// C entry refuses a tensor-core request the shapes cannot take, and never
// falls back):
//
// bf16, D and F multiples of 8, x and w 16-byte aligned: tensor cores
// (mma.sync.m16n8k16, bf16 in, f32 accumulate), operands by ldmatrix from
// a cp.async ring in shared memory (rows padded by 16 bytes so ldmatrix's
// row addresses hit distinct banks):
//   * narrow, C <= 64 (gmm_narrow_mma: a decode step's 8 slots, a paged
//     chunk's ~40): A and B swapped, out^T[F, C] = w^T x^T, so 16 columns
//     of F fill the mma's M and the C slots its N (8, 16, 32 or 64);
//     w [D, F] reaches the A fragment through ldmatrix.trans and x [C, D]
//     is already the "col" B operand.  One CTA of 4 warps per (64 columns
//     of F, expert); each stage holds a 64 x 64 w tile (8 KB) and the x
//     tile, so 24 KB of weights are in flight per CTA and 256 (gate / up)
//     or 512 (down) CTAs stream the 33.5 MB at once: no split of D is
//     needed to fill the card;
//   * wide, C > 64 (gmm_wide_mma: prefills): the normal orientation, one
//     CTA of 4 warps (2 x 2, 64 x 64 each) per (128 rows of C, 128
//     columns of F, expert), 64 of D per stage in a 3-stage ring (107 KB);
//     x by ldmatrix, w by ldmatrix.trans.  A warp's 64 x 64 tile issues 8 ldmatrix per 32 mma,
//     and the CTA's 128 x 128 tile reads each w tile once per 128 rows of
//     C.
// Both stage the output tile in shared memory and store 16-byte vectors;
// ragged C, D and F are zero-filled by the copies and masked on store.
//
// f32, and bf16 shapes or pointers the vector copies cannot take: the SIMT
// kernel of the first port (moe_gmm_simt), unchanged: f32 FMAs (TF32 keeps
// ~3 digits, short of the 2e-5 bar of the f32 checks), one block of 256
// threads per (F tile of 64, C tile of BC, expert), BC in {16, 32, 64},
// tiles converted to f32 in shared memory and double buffered through
// registers; 16-byte loads when D, F and the pointers allow, else element
// by element, so any E, C, D and F work (the TPU kernel needs block sizes
// that tile all three).
//
// No atomics and no split of D across blocks in any kernel: every output
// element is summed by one thread (or one mma lane) in the order of D, so
// the result is the same on every run and every stream.  Left on the
// table: the narrow kernel streams the weights at ~75% of the HBM rate;
// the wide kernel (208 registers a thread, so 2 CTAs of 4 warps per SM)
// reaches about a quarter of the bf16 peak, where mma.sync's issue rate
// and the ldmatrix traffic hold it; wgmma fed by TMA, fusing the
// gate and up products (they share x), and a persistent grid (C = 416
// takes two waves of CTAs) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBF = 64;   // output columns per block
constexpr int kBK = 64;   // depth per shared-memory step

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC consecutive elements of T: one 16-byte load when VEC * sizeof(T) == 16
template <typename T, int VEC>
struct alignas(VEC * sizeof(T) == 16 ? 16 : alignof(T)) Chunk { T v[VEC]; };

template <typename T, int VEC>
__device__ __forceinline__ void load_chunk(Chunk<T, VEC>& c, const T* p, bool ok) {
  if constexpr (VEC * sizeof(T) == 16) {
    if (ok) {
      *reinterpret_cast<uint4*>(c.v) = *reinterpret_cast<const uint4*>(p);
    } else {
      *reinterpret_cast<uint4*>(c.v) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
#pragma unroll
    for (int t = 0; t < VEC; ++t) c.v[t] = ok ? p[t] : from_f32<T>(0.0f);
  }
}

// One block's output tile [BC x kBF] of expert blockIdx.z.
//   x tile in shared memory:  xs[BC][kBK + 1] (f32, padded row)
//   w tile in shared memory:  ws[kBK][kBF]    (f32)
// Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty*TM .. ty*TM+TM-1 and
// columns tx*4 .. tx*4+3 of the tile.
template <typename T, int BC, int VEC>
__global__ void __launch_bounds__(kThreads)
moe_gmm_simt(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
               int C, int D, int F) {
  constexpr int TM = BC / 16;
  constexpr int XV = BC * kBK / VEC;               // x-tile chunks
  constexpr int WV = kBK * kBF / VEC;              // w-tile chunks
  constexpr int XL = (XV + kThreads - 1) / kThreads;
  constexpr int WL = (WV + kThreads - 1) / kThreads;
  __shared__ float xs[BC][kBK + 1];
  __shared__ __align__(16) float ws[kBK][kBF];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int f0 = blockIdx.x * kBF;
  const int c0 = blockIdx.y * BC;
  const int64_t e = blockIdx.z;
  const T* xe = x + e * (int64_t)C * D;
  const T* we = w + e * (int64_t)D * F;

  Chunk<T, VEC> xr[XL], wr[WL];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / (kBK / VEC), kk = (v % (kBK / VEC)) * VEC;
      const bool ok = v < XV && c0 + r < C && k0 + kk < D;
      load_chunk<T, VEC>(xr[i], xe + (int64_t)(c0 + r) * D + k0 + kk, ok);
    }
#pragma unroll
    for (int i = 0; i < WL; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / (kBF / VEC), ff = (v % (kBF / VEC)) * VEC;
      const bool ok = v < WV && k0 + r < D && f0 + ff < F;
      load_chunk<T, VEC>(wr[i], we + (int64_t)(k0 + r) * F + f0 + ff, ok);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int v = tid + i * kThreads;
      if (v < XV) {
        const int r = v / (kBK / VEC), kk = (v % (kBK / VEC)) * VEC;
#pragma unroll
        for (int t = 0; t < VEC; ++t) xs[r][kk + t] = to_f32(xr[i].v[t]);
      }
    }
#pragma unroll
    for (int i = 0; i < WL; ++i) {
      const int v = tid + i * kThreads;
      if (v < WV) {
        const int r = v / (kBF / VEC), ff = (v % (kBF / VEC)) * VEC;
#pragma unroll
        for (int t = 0; t < VEC; ++t) ws[r][ff + t] = to_f32(wr[i].v[t]);
      }
    }
  };

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  load(0);
  for (int k0 = 0; k0 < D; k0 += kBK) {
    stage();
    __syncthreads();
    if (k0 + kBK < D) load(k0 + kBK);              // next step's tiles in flight
    // masked (zero) entries beyond D add exact zeros, so the sum over the
    // real d is the same as an unpadded one
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float a = xs[ty * TM + i][k];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

  T* oe = out + e * (int64_t)C * F;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int c = c0 + ty * TM + i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx * 4 + j;
      if (f < F) oe[(int64_t)c * F + f] = from_f32<T>(acc[i][j]);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T, int BC, int VEC>
cudaError_t launch_tile(const T* x, const T* w, T* out, int E, int C, int D, int F,
                        cudaStream_t s) {
  const dim3 grid((unsigned)((F + kBF - 1) / kBF), (unsigned)((C + BC - 1) / BC), (unsigned)E);
  moe_gmm_simt<T, BC, VEC><<<grid, kThreads, 0, s>>>(x, w, out, C, D, F);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_vec(const T* x, const T* w, T* out, int E, int C, int D, int F,
                       cudaStream_t s) {
  if (C <= 16) return launch_tile<T, 16, VEC>(x, w, out, E, C, D, F, s);
  if (C <= 32) return launch_tile<T, 32, VEC>(x, w, out, E, C, D, F, s);
  return launch_tile<T, 64, VEC>(x, w, out, E, C, D, F, s);
}

template <typename T>
cudaError_t launch_simt(const void* x, const void* w, void* out, int E, int C, int D, int F,
                        cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const T* x_ = static_cast<const T*>(x);
  const T* w_ = static_cast<const T*>(w);
  T* o_ = static_cast<T*>(out);
  if (D % kVec == 0 && F % kVec == 0 && aligned16(x) && aligned16(w))
    return launch_vec<T, kVec>(x_, w_, o_, E, C, D, F, s);
  return launch_vec<T, 1>(x_, w_, o_, E, C, D, F, s);
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;  // 4 warps
constexpr int kStages = 4;       // cp.async ring depth of the narrow kernels
constexpr int kPad = 8;          // elements (16 bytes) of padding per shared row
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !ok (src not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c[16x8] += a[16x16] b[16x8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- narrow (C <= 64): out^T[F, C] = w^T[F, D] x^T[D, C] -----------------------

constexpr int kDF = 64;              // columns of F per CTA (4 warps x 16)
constexpr int kDK = 64;              // depth per stage
constexpr int kDXL = kDK + kPad;     // x-tile row [NB * 8][kDK]
constexpr int kDWL = kDF + kPad;     // w-tile row [kDK][kDF]; also the output tile's

template <int NB> struct NarrowTile {             // NB: 8-slot blocks of C (1, 2, 4, 8)
  static constexpr int XT = NB * 8 * kDXL;        // elements of a stage's x tile
  static constexpr int STAGE = XT + kDK * kDWL;   // x tile, then w tile
  static constexpr size_t SMEM = size_t(kStages) * STAGE * sizeof(bf16);
};

template <int NB>
__global__ void __launch_bounds__(kTcThreads)
gmm_narrow_mma(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ out,
               int C, int D, int F) {
  using DT = NarrowTile<NB>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int f0 = blockIdx.x * kDF;
  const int64_t e = blockIdx.y;
  const bf16* xe = x + e * (int64_t)C * D;
  const bf16* we = w + e * (int64_t)D * F;
  const int nk = (D + kDK - 1) / kDK;

  auto load = [&](int kt, int slot) {
    bf16* xs = smem + slot * DT::STAGE;
    bf16* ws = xs + DT::XT;
    const int d0 = kt * kDK;
    for (int i = tid; i < kDK * (kDF / 8); i += kTcThreads) {
      const int r = i / (kDF / 8), c = i % (kDF / 8);
      const bool ok = d0 + r < D && f0 + c * 8 < F;
      cp_async16(smem_u32(ws + r * kDWL + c * 8),
                 ok ? we + (int64_t)(d0 + r) * F + f0 + c * 8 : we, ok);
    }
    for (int i = tid; i < NB * 8 * (kDK / 8); i += kTcThreads) {
      const int r = i / (kDK / 8), c = i % (kDK / 8);
      const bool ok = r < C && d0 + c * 8 < D;
      cp_async16(smem_u32(xs + r * kDXL + c * 8), ok ? xe + (int64_t)r * D + d0 + c * 8 : xe,
                 ok);
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load(st, st);
    cp_async_commit();
  }

  float acc[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // A = w^T through .trans: matrices (f 0-7, d 0-7), (f 8-15, d 0-7),
  // (f 0-7, d 8-15), (f 8-15, d 8-15) of the warp's 16 columns of F, i.e.
  // w rows d = lane % 8 + 8 (lane / 16), columns f = 16 warp + 8 ((lane / 8) % 2).
  // B = x^T, two 8-slot blocks per ldmatrix: x rows c = lane % 8 (+ 8
  // (lane / 16) for the second block), column half (lane / 8) % 2.
  const int a_off = ((lane & 7) + ((lane >> 4) << 3)) * kDWL + warp * 16 + ((lane >> 3) & 1) * 8;
  const int b_off = ((lane & 7) + (NB >= 2 ? (lane >> 4) << 3 : 0)) * kDXL + ((lane >> 3) & 1) * 8;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();               // stage kt has landed; every warp is done with kt - 1
    const int nxt = kt + kStages - 1;
    if (nxt < nk) load(nxt, nxt % kStages);
    cp_async_commit();
    const bf16* xs = smem + (kt % kStages) * DT::STAGE;
    const uint32_t a_base = smem_u32(xs + DT::XT + a_off);
    const uint32_t b_base = smem_u32(xs + b_off);
#pragma unroll
    for (int kk = 0; kk < kDK / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4_t(a, a_base + kk * 16 * kDWL * 2);
      if constexpr (NB >= 2) {
#pragma unroll
        for (int jj = 0; jj < NB / 2; ++jj) {
          uint32_t bf[4];
          ldsm_x4(bf, b_base + (jj * 16 * kDXL + kk * 16) * 2);
          mma16816(acc[2 * jj], a, bf[0], bf[1]);
          mma16816(acc[2 * jj + 1], a, bf[2], bf[3]);
        }
      } else {
        uint32_t bf[2];
        ldsm_x2(bf, b_base + kk * 32);
        mma16816(acc[0], a, bf[0], bf[1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // acc[j]: out^T rows f = 16 warp + g (+ 8), columns c = 8 j + 2 t4 (+ 1);
  // stage as out[c][f] and store whole 16-byte runs of F
  bf16* o_s = smem;                                // [NB * 8][kDWL]
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      o_s[(8 * j + 2 * t4 + (q & 1)) * kDWL + warp * 16 + g + 8 * (q >> 1)] =
          __float2bfloat16(acc[j][q]);
  __syncthreads();
  bf16* oe = out + e * (int64_t)C * F;
  for (int i = tid; i < NB * 8 * (kDF / 8); i += kTcThreads) {
    const int r = i / (kDF / 8), c = i % (kDF / 8);
    if (r < C && f0 + c * 8 < F)
      *reinterpret_cast<uint4*>(oe + (int64_t)r * F + f0 + c * 8) =
          *reinterpret_cast<const uint4*>(o_s + r * kDWL + c * 8);
  }
}

// -- wide (C > 64): out[C, F] = x[C, D] w[D, F] --------------------------------

constexpr int kPThreads = 128;       // 4 warps, 64 x 64 each
constexpr int kPM = 128;             // rows of C per CTA (2 warps x 64)
constexpr int kPN = 128;             // columns of F per CTA (2 warps x 64)
constexpr int kPK = 64;              // depth per stage
constexpr int kPStages = 3;          // cp.async ring depth
constexpr int kPXL = kPK + kPad;     // x-tile row [kPM][kPK]
constexpr int kPWL = kPN + kPad;     // w-tile row [kPK][kPN]; also the output tile's
constexpr int kPXT = kPM * kPXL;
constexpr int kPStage = kPXT + kPK * kPWL;
constexpr size_t kPSmem = size_t(kPStages) * kPStage * sizeof(bf16);
static_assert(kPM * kPWL <= kPStages * kPStage, "the output tile fits in the ring");

__global__ void __launch_bounds__(kPThreads)
gmm_wide_mma(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ out,
                int C, int D, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;        // the warp's 64 x 64 quarter
  const int f0 = blockIdx.x * kPN, c0 = blockIdx.y * kPM;
  const int64_t e = blockIdx.z;
  const bf16* xe = x + e * (int64_t)C * D;
  const bf16* we = w + e * (int64_t)D * F;
  const int nk = (D + kPK - 1) / kPK;

  auto load = [&](int kt, int slot) {
    bf16* xs = smem + slot * kPStage;
    bf16* ws = xs + kPXT;
    const int d0 = kt * kPK;
    for (int i = tid; i < kPM * (kPK / 8); i += kPThreads) {
      const int r = i / (kPK / 8), c = i % (kPK / 8);
      const bool ok = c0 + r < C && d0 + c * 8 < D;
      cp_async16(smem_u32(xs + r * kPXL + c * 8),
                 ok ? xe + (int64_t)(c0 + r) * D + d0 + c * 8 : xe, ok);
    }
    for (int i = tid; i < kPK * (kPN / 8); i += kPThreads) {
      const int r = i / (kPN / 8), c = i % (kPN / 8);
      const bool ok = d0 + r < D && f0 + c * 8 < F;
      cp_async16(smem_u32(ws + r * kPWL + c * 8),
                 ok ? we + (int64_t)(d0 + r) * F + f0 + c * 8 : we, ok);
    }
  };

#pragma unroll
  for (int st = 0; st < kPStages - 1; ++st) {
    if (st < nk) load(st, st);
    cp_async_commit();
  }

  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  // A = x: rows 64 wm + 16 i + lane % 16, column half lane / 16.
  // B = w through .trans, two 8-column blocks per ldmatrix: w rows
  // d = lane % 8 + 8 ((lane / 8) % 2), columns 64 wn + 16 jj + 8 (lane / 16).
  const int a_off = (wm * 64 + (lane & 15)) * kPXL + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * kPWL + wn * 64 + (lane >> 4) * 8;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kPStages - 2>();
    __syncthreads();
    const int nxt = kt + kPStages - 1;
    if (nxt < nk) load(nxt, nxt % kPStages);
    cp_async_commit();
    const bf16* xs = smem + (kt % kPStages) * kPStage;
    const uint32_t a_base = smem_u32(xs + a_off);
    const uint32_t b_base = smem_u32(xs + kPXT + b_off);
#pragma unroll
    for (int kk = 0; kk < kPK / 16; ++kk) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldsm_x4(a[i], a_base + (i * 16 * kPXL + kk * 16) * 2);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t bf[4];
        ldsm_x4_t(bf, b_base + (kk * 16 * kPWL + jj * 16) * 2);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma16816(acc[i][2 * jj], a[i], bf[0], bf[1]);
          mma16816(acc[i][2 * jj + 1], a[i], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // acc[i][j]: rows 64 wm + 16 i + g (+ 8), columns 64 wn + 8 j + 2 t4 (+ 1)
  bf16* o_s = smem;                                // [kPM][kPWL]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = wm * 64 + i * 16 + g, c = wn * 64 + j * 8 + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(o_s + r * kPWL + c) =
          __floats2bfloat162_rn(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<__nv_bfloat162*>(o_s + (r + 8) * kPWL + c) =
          __floats2bfloat162_rn(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  bf16* oe = out + e * (int64_t)C * F;
  for (int i = tid; i < kPM * (kPN / 8); i += kPThreads) {
    const int r = i / (kPN / 8), c = i % (kPN / 8);
    if (c0 + r < C && f0 + c * 8 < F)
      *reinterpret_cast<uint4*>(oe + (int64_t)(c0 + r) * F + f0 + c * 8) =
          *reinterpret_cast<const uint4*>(o_s + r * kPWL + c * 8);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int NB>
cudaError_t launch_narrow(const bf16* x, const bf16* w, bf16* out, int E, int C, int D, int F,
                          cudaStream_t s) {
  constexpr size_t smem = NarrowTile<NB>::SMEM;
  cudaError_t err = allow_smem(gmm_narrow_mma<NB>, smem);
  if (err != cudaSuccess) return err;
  gmm_narrow_mma<NB><<<dim3((F + kDF - 1) / kDF, E), kTcThreads, smem, s>>>(x, w, out, C, D, F);
  return cudaGetLastError();
}

cudaError_t launch_mma(const void* x, const void* w, void* out, int E, int C, int D, int F,
                       cudaStream_t s) {
  const bf16* x_ = static_cast<const bf16*>(x);
  const bf16* w_ = static_cast<const bf16*>(w);
  bf16* o_ = static_cast<bf16*>(out);
  if (C <= 8) return launch_narrow<1>(x_, w_, o_, E, C, D, F, s);
  if (C <= 16) return launch_narrow<2>(x_, w_, o_, E, C, D, F, s);
  if (C <= 32) return launch_narrow<4>(x_, w_, o_, E, C, D, F, s);
  if (C <= 64) return launch_narrow<8>(x_, w_, o_, E, C, D, F, s);
  cudaError_t err = allow_smem(gmm_wide_mma, kPSmem);
  if (err != cudaSuccess) return err;
  gmm_wide_mma<<<dim3((F + kPN - 1) / kPN, (C + kPM - 1) / kPM, E), kPThreads, kPSmem, s>>>(
      x_, w_, o_, C, D, F);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The backward: dX[e] = dY[e] W[e]^T and dW[e] = X[e]^T dY[e]
// ---------------------------------------------------------------------------
//
// Both are per-expert products out[M, N] = sum_k A(m, k) B(k, n) whose
// operands lie in memory as the forward left them, one of them transposed:
//   dX: M = C, N = D, K = F;  A = dY [C][F] (k contiguous),
//       B = W [D][F] = [N][K] (k contiguous: "BT");
//   dW: M = D, N = F, K = C;  A = X [C][D] = [K][M] (m contiguous: "AT"),
//       B = dY [C][F] = [K][N] (n contiguous).
// So one kernel template covers both, its operand layouts as template
// flags: no operand is transposed in memory.  The reduction over K runs
// inside one CTA (or one thread) from k = 0 up, never split across CTAs,
// so each output element is summed in one fixed order.
//
// bf16 (the forward's tensor-core condition: D and F multiples of 8, all
// operands 16-byte aligned): gmm_bwd_mma, mma.sync.m16n8k16 with f32
// accumulators, the wide forward kernel's CTA (4 warps, 2 x 2 of 64 x 64)
// over 128 x 128 output tiles, 32 of K a stage in a 4-stage cp.async ring
// (80 KB).  Each operand tile keeps the layout it has in memory (rows
// padded by 16 bytes); ldmatrix without .trans reads a k-contiguous tile
// and with .trans an m- or n-contiguous one into the same fragments
// (gmm_narrow_mma does the same for w^T and x^T).  Rows past M, N or K are
// zero-filled by the copies and masked on store, so C (K of dW, M of dX)
// may be any size.  f32, and what the vector copies cannot take:
// gmm_bwd_simt, 64 x 64 tiles of f32 FMAs in k order (the forward's SIMT
// kernel, with the layouts as flags).
//
// What bounds it on an H100: operations.  At granite-moe's training shape
// (E = 32, C = 640, D x F = 1024 x 512) each product is 2 E C D F = 21.5
// GFLOP (21.7 us at the bf16 rate) against ~110 MB of operands (33 us at
// 3.35 TB/s): bytes bound each call by a little, its two products
// together are 43 GFLOP.  The kernel reaches what mma.sync and ldmatrix
// give the wide forward kernel (about a quarter of the peak); wgmma is the
// later step, as for the forward.

constexpr int kGM = 128, kGN = 128, kGK = 32, kGStages = 4, kGThreads = 128;

template <bool kAT, bool kBT> struct BwdTile {
  static constexpr int AL = kAT ? kGM + kPad : kGK + kPad;   // elements a row of the A tile
  static constexpr int AT = kAT ? kGK * AL : kGM * AL;       // elements of the A tile
  static constexpr int BL = kBT ? kGK + kPad : kGN + kPad;
  static constexpr int BT = kBT ? kGN * BL : kGK * BL;
  static constexpr int STAGE = AT + BT;
  static constexpr size_t SMEM = size_t(kGStages) * STAGE * sizeof(bf16);
  static_assert(kGM * (kGN + kPad) <= kGStages * STAGE, "the output tile fits in the ring");
};

// out[e] (M x N, row-major) = A[e] B[e]; A[e] is [M][K] or, with kAT,
// [K][M]; B[e] is [K][N] or, with kBT, [N][K].
template <bool kAT, bool kBT>
__global__ void __launch_bounds__(kGThreads)
gmm_bwd_mma(const bf16* __restrict__ A, const bf16* __restrict__ B, bf16* __restrict__ out,
            int M, int N, int K) {
  using T = BwdTile<kAT, kBT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;        // the warp's 64 x 64 quarter
  const int n0 = blockIdx.x * kGN, m0 = blockIdx.y * kGM;
  const int64_t e = blockIdx.z;
  const bf16* Ae = A + e * (int64_t)M * K;
  const bf16* Be = B + e * (int64_t)K * N;
  const int nk = (K + kGK - 1) / kGK;

  auto load = [&](int kt, int slot) {
    bf16* as = smem + slot * T::STAGE;
    bf16* bs = as + T::AT;
    const int k0 = kt * kGK;
    if constexpr (kAT) {            // [kGK][kGM] from A's rows k, 16 bytes along m
      for (int i = tid; i < kGK * (kGM / 8); i += kGThreads) {
        const int r = i / (kGM / 8), c = i % (kGM / 8);
        const bool ok = k0 + r < K && m0 + c * 8 < M;
        cp_async16(smem_u32(as + r * T::AL + c * 8),
                   ok ? Ae + (int64_t)(k0 + r) * M + m0 + c * 8 : Ae, ok);
      }
    } else {                        // [kGM][kGK] from A's rows m, 16 bytes along k
      for (int i = tid; i < kGM * (kGK / 8); i += kGThreads) {
        const int r = i / (kGK / 8), c = i % (kGK / 8);
        const bool ok = m0 + r < M && k0 + c * 8 < K;
        cp_async16(smem_u32(as + r * T::AL + c * 8),
                   ok ? Ae + (int64_t)(m0 + r) * K + k0 + c * 8 : Ae, ok);
      }
    }
    if constexpr (kBT) {            // [kGN][kGK] from B's rows n, 16 bytes along k
      for (int i = tid; i < kGN * (kGK / 8); i += kGThreads) {
        const int r = i / (kGK / 8), c = i % (kGK / 8);
        const bool ok = n0 + r < N && k0 + c * 8 < K;
        cp_async16(smem_u32(bs + r * T::BL + c * 8),
                   ok ? Be + (int64_t)(n0 + r) * K + k0 + c * 8 : Be, ok);
      }
    } else {                        // [kGK][kGN] from B's rows k, 16 bytes along n
      for (int i = tid; i < kGK * (kGN / 8); i += kGThreads) {
        const int r = i / (kGN / 8), c = i % (kGN / 8);
        const bool ok = k0 + r < K && n0 + c * 8 < N;
        cp_async16(smem_u32(bs + r * T::BL + c * 8),
                   ok ? Be + (int64_t)(k0 + r) * N + n0 + c * 8 : Be, ok);
      }
    }
  };

#pragma unroll
  for (int st = 0; st < kGStages - 1; ++st) {
    if (st < nk) load(st, st);
    cp_async_commit();
  }

  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  // A fragments (16 x 16 at rows 64 wm + 16 i): ldmatrix matrix q = lane / 8
  // holds (rows + 8 (q % 2), k + 8 (q / 2)) for a k-contiguous tile ...
  const int a_off = kAT
      ? ((lane & 7) + ((lane >> 4) << 3)) * T::AL + wm * 64 + ((lane >> 3) & 1) * 8
      : (wm * 64 + (lane & 15)) * T::AL + (lane >> 4) * 8;
  // ... and B fragments (two 8-column blocks at 64 wn + 16 jj): matrix q
  // holds (k + 8 (q % 2), n + 8 (q / 2)), so bf[0..1] are the first block's
  // b0 / b1 and bf[2..3] the second's, whichever way the tile lies
  const int b_off = kBT
      ? (wn * 64 + (lane & 7) + ((lane >> 4) << 3)) * T::BL + ((lane >> 3) & 1) * 8
      : ((lane & 7) + (((lane >> 3) & 1) << 3)) * T::BL + wn * 64 + (lane >> 4) * 8;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kGStages - 2>();
    __syncthreads();
    const int nxt = kt + kGStages - 1;
    if (nxt < nk) load(nxt, nxt % kGStages);
    cp_async_commit();
    const bf16* as = smem + (kt % kGStages) * T::STAGE;
    const uint32_t a_base = smem_u32(as + a_off);
    const uint32_t b_base = smem_u32(as + T::AT + b_off);
#pragma unroll
    for (int kk = 0; kk < kGK / 16; ++kk) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (kAT)
          ldsm_x4_t(a[i], a_base + (kk * 16 * T::AL + i * 16) * 2);
        else
          ldsm_x4(a[i], a_base + (i * 16 * T::AL + kk * 16) * 2);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t bf[4];
        if constexpr (kBT)
          ldsm_x4(bf, b_base + (jj * 16 * T::BL + kk * 16) * 2);
        else
          ldsm_x4_t(bf, b_base + (kk * 16 * T::BL + jj * 16) * 2);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma16816(acc[i][2 * jj], a[i], bf[0], bf[1]);
          mma16816(acc[i][2 * jj + 1], a[i], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // acc[i][j]: rows 64 wm + 16 i + g (+ 8), columns 64 wn + 8 j + 2 t4 (+ 1)
  constexpr int kOL = kGN + kPad;
  bf16* o_s = smem;                                // [kGM][kOL]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = wm * 64 + i * 16 + g, c = wn * 64 + j * 8 + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(o_s + r * kOL + c) =
          __floats2bfloat162_rn(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<__nv_bfloat162*>(o_s + (r + 8) * kOL + c) =
          __floats2bfloat162_rn(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  bf16* oe = out + e * (int64_t)M * N;
  for (int i = tid; i < kGM * (kGN / 8); i += kGThreads) {
    const int r = i / (kGN / 8), c = i % (kGN / 8);
    if (m0 + r < M && n0 + c * 8 < N)
      *reinterpret_cast<uint4*>(oe + (int64_t)(m0 + r) * N + n0 + c * 8) =
          *reinterpret_cast<const uint4*>(o_s + r * kOL + c * 8);
  }
}

// The same products in f32 FMAs: a 64 x 64 output tile per block of 256
// threads, 4 x 4 per thread, 16 of K a step staged in shared memory as f32
// ([k][m] and [k][n]); each operand read along its contiguous axis.
constexpr int kST = 64, kSK = 16;

template <typename T, bool kAT, bool kBT>
__global__ void __launch_bounds__(kThreads)
gmm_bwd_simt(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ out, int M,
             int N, int K) {
  __shared__ float as[kSK][kST + 1];
  __shared__ float bs[kSK][kST + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kST, m0 = blockIdx.y * kST;
  const int64_t e = blockIdx.z;
  const T* Ae = A + e * (int64_t)M * K;
  const T* Be = B + e * (int64_t)K * N;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kSK) {
#pragma unroll
    for (int i = 0; i < kSK * kST / kThreads; ++i) {
      const int v = tid + i * kThreads;
      // A: along m where m is contiguous, else along k
      const int am = kAT ? v % kST : v / kSK, ak = kAT ? v / kST : v % kSK;
      const bool aok = m0 + am < M && k0 + ak < K;
      as[ak][am] = aok ? to_f32(kAT ? Ae[(int64_t)(k0 + ak) * M + m0 + am]
                                    : Ae[(int64_t)(m0 + am) * K + k0 + ak])
                       : 0.0f;
      const int bn = kBT ? v / kSK : v % kST, bk = kBT ? v % kSK : v / kST;
      const bool bok = n0 + bn < N && k0 + bk < K;
      bs[bk][bn] = bok ? to_f32(kBT ? Be[(int64_t)(n0 + bn) * K + k0 + bk]
                                    : Be[(int64_t)(k0 + bk) * N + n0 + bn])
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  T* oe = out + e * (int64_t)M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) oe[(int64_t)m * N + n] = from_f32<T>(acc[i][j]);
    }
  }
}

template <bool kAT, bool kBT>
cudaError_t launch_bwd_mma(const bf16* A, const bf16* B, bf16* out, int E, int M, int N, int K,
                           cudaStream_t s) {
  constexpr size_t smem = BwdTile<kAT, kBT>::SMEM;
  const cudaError_t err = allow_smem(gmm_bwd_mma<kAT, kBT>, smem);
  if (err != cudaSuccess) return err;
  gmm_bwd_mma<kAT, kBT><<<dim3((N + kGN - 1) / kGN, (M + kGM - 1) / kGM, E), kGThreads, smem,
                          s>>>(A, B, out, M, N, K);
  return cudaGetLastError();
}

template <typename T, bool kAT, bool kBT>
cudaError_t launch_bwd_simt(const void* A, const void* B, void* out, int E, int M, int N,
                            int K, cudaStream_t s) {
  gmm_bwd_simt<T, kAT, kBT><<<dim3((N + kST - 1) / kST, (M + kST - 1) / kST, E), kThreads, 0,
                              s>>>(static_cast<const T*>(A), static_cast<const T*>(B),
                                   static_cast<T*>(out), M, N, K);
  return cudaGetLastError();
}

// dX then dW, one form for both
template <typename T>
cudaError_t launch_bwd_simt_pair(const void* x, const void* w, const void* dy, void* dx,
                                 void* dw, int E, int C, int D, int F, cudaStream_t s) {
  if (dx) {
    const cudaError_t err = launch_bwd_simt<T, false, true>(dy, w, dx, E, C, D, F, s);
    if (err != cudaSuccess) return err;
  }
  return dw ? launch_bwd_simt<T, true, false>(x, dy, dw, E, D, F, C, s) : cudaSuccess;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  x: [E, C, D], w: [E, D, F],
// out: [E, C, F], one dtype, all contiguous.  tensor_cores: 1 takes the
// tensor-core kernels, which need bf16, D and F multiples of 8 and x, w
// and out 16-byte aligned (refused otherwise); 0 the SIMT kernel, which
// takes anything.  Launches on `stream` and returns the launch's
// cudaError_t (0 = queued).
extern "C" int moe_gmm_fwd(const void* x, const void* w, void* out, int dtype, long long E,
                           long long C, long long D, long long F, int tensor_cores,
                           void* stream) {
  // grid: (F / 64, C / 16 at most, E) blocks, each within CUDA's limits
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 || C > 16LL * 65535 ||
      D > (1LL << 30) || F > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    if (dtype != 1 || D % 8 != 0 || F % 8 != 0 || !aligned16(x) || !aligned16(w) ||
        !aligned16(out))
      return (int)cudaErrorInvalidValue;
    return (int)launch_mma(x, w, out, (int)E, (int)C, (int)D, (int)F, s);
  }
  switch (dtype) {
    case 0: return (int)launch_simt<float>(x, w, out, (int)E, (int)C, (int)D, (int)F, s);
    case 1: return (int)launch_simt<bf16>(x, w, out, (int)E, (int)C, (int)D, (int)F, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward of moe_gmm_fwd: dy [E, C, F] (the cotangent of out) ->
// dx [E, C, D] = dy w^T and dw [E, D, F] = x^T dy, x, w, dy, dx and dw in
// one dtype, all contiguous.  tensor_cores: 1 takes gmm_bwd_mma for both
// products (the forward's condition, dy, dx and dw 16-byte aligned too;
// refused otherwise), 0 gmm_bwd_simt.  Launches both on `stream` (a null
// dx or dw skips that product, so each half can be timed alone) and
// returns the first failing launch's cudaError_t (0 = all queued).
extern "C" int moe_gmm_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw,
                           int dtype, long long E, long long C, long long D, long long F,
                           int tensor_cores, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 || C > 64LL * 65535 ||
      D > 64LL * 65535 || F > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = (int)E, c = (int)C, d = (int)D, f = (int)F;
  if (tensor_cores) {
    if (dtype != 1 || D % 8 != 0 || F % 8 != 0 || !aligned16(x) || !aligned16(w) ||
        !aligned16(dy) || !aligned16(dx) || !aligned16(dw))
      return (int)cudaErrorInvalidValue;
    const bf16* x_ = static_cast<const bf16*>(x);
    const bf16* w_ = static_cast<const bf16*>(w);
    const bf16* dy_ = static_cast<const bf16*>(dy);
    // dX [C, D] = dY [C, F] . W[D, F]^T;  dW [D, F] = X[C, D]^T . dY [C, F]
    if (dx) {
      const cudaError_t err =
          launch_bwd_mma<false, true>(dy_, w_, static_cast<bf16*>(dx), e, c, d, f, s);
      if (err != cudaSuccess) return (int)err;
    }
    if (!dw) return (int)cudaSuccess;
    return (int)launch_bwd_mma<true, false>(x_, dy_, static_cast<bf16*>(dw), e, d, f, c, s);
  }
  switch (dtype) {
    case 0: return (int)launch_bwd_simt_pair<float>(x, w, dy, dx, dw, e, c, d, f, s);
    case 1: return (int)launch_bwd_simt_pair<bf16>(x, w, dy, dx, dw, e, c, d, f, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
