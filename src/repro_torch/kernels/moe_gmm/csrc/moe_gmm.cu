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
#include <cuda.h>   // CUtensorMap and its enums (types only: no -lcuda)
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
//   dX: M = C, N = D, K = F;  A = dY [C][F] (k contiguous: "K-major"),
//       B = W [D][F] = [N][K] (K-major);
//   dW: M = D, N = F, K = C;  A = X [C][D] = [K][M] (m contiguous:
//       "MN-major"), B = dY [C][F] = [K][N] (MN-major).
// No operand is transposed in memory: for 16-bit types wgmma reads either
// major-ness from shared memory, chosen by its transpose immediates.
//
// What bounds it on an H100.  At granite-moe's training shape (E = 32,
// C = 640, D x F = 1024 x 512 or 512 x 1024, bf16) a call is 4 E C D F =
// 43 GFLOP (43 us at 989 TFLOP/s) against 2 (|X| + |W|) + |dY| = 172 MB
// (51 us at 3.35 TB/s): bytes, by a little.  The first design (two
// launches of an mma.sync kernel, 128 x 128 tiles from a cp.async ring)
// took 0.185 ms there on an H100 SXM, 2.3x a torch.bmm pair: mma.sync's
// issue rate and the ldmatrix traffic held it near a quarter of the bf16
// peak, and each of its two launches ended in a partial wave.  A 128 x 128 tile also needs
// (128 + 128) K bf16 from L2 for 2 x 128 x 128 K flops, 64 flops a byte:
// at the bf16 rate that is ~15 TB/s of L2 reads, well past what L2 gives.
//
// gmm_bwd_wgmma (bf16; D and F multiples of 8, 16-byte aligned operands):
// * wgmma.mma_async m64n256k16, bf16 in, f32 accumulators, both operands
//   from 128-byte-swizzled shared memory.  A CTA's output tile is 128 x
//   256 (85 flops per L2 byte); two consumer warpgroups own 64 rows each
//   (128 f32 accumulators a thread, setmaxnreg 232).
// * TMA brings each stage (64 of K: a 16 KB A tile and a 32 KB B tile)
//   into a 4-stage ring (192 KB) on full / empty mbarriers; one thread of
//   a third warpgroup (setmaxnreg 40) issues the copies and runs up to 4
//   stages ahead, across tile boundaries.  A consumer warpgroup hands a
//   stage back as soon as its own products on it are done (wait_group 0:
//   the other warpgroup's products keep the tensor cores busy), so the
//   copies get the whole ring's lead.  The tensor maps are 3-D
//   ([E][rows][cols], built on the host per call by libcuda's
//   cuTensorMapEncodeTiled), so a box never crosses an expert and
//   TMA's zero fill covers ragged C, D and F.  K-major tiles are one box
//   of 64 x rows; an MN-major tile is boxes of [64 of K][64 of M or N],
//   side by side.
// * The output tile leaves through shared memory: each consumer
//   warpgroup writes its 64 x 256 accumulators as bf16 into 128-byte-
//   swizzled [64][64] boxes (bank-conflict free), two boxes (16 KB) at a
//   time, and one of its threads issues TMA stores, clipped at M and N,
//   that drain while the warpgroup goes on.  Stored straight from
//   registers instead (a masked bf16 pair a thread, both warpgroups idle
//   meanwhile), the epilogue took more time than the products
//   (scripts/torch_family_bwd_probe.py --variants; PERF.md).  Staging
//   all four boxes at once would cost the ring its fourth stage.
// * One launch per call, a persistent grid of one CTA an SM: the CTAs walk
//   one list holding both products' tiles (moe_gmm_bwd_tiles in ops.py
//   gives the order), the product with the longer sum first, so the
//   shorter product's tiles fill the last wave.  A null dx or dw drops
//   that product's tiles.
// * Each output element is summed by one CTA's wgmma chain from k = 0 up,
//   never split across CTAs, with no atomics: the same bits on every call.
// f32, and bf16 shapes or pointers TMA cannot take: gmm_bwd_simt, 64 x 64
// tiles of f32 FMAs in k order (the forward's SIMT kernel, with the
// operand layouts as flags).  Left on the table: TMA multicast across a
// cluster of two CTAs (halves the L2 reads of the shared operand), a TMA
// store of the output tile, fusing gate's and up's products (they share X).

constexpr int kWM = 128;               // output rows a CTA (two warpgroups x 64)
constexpr int kWN = 256;               // output columns a CTA (one m64n256 per warpgroup)
constexpr int kWK = 64;                // depth a stage: one 128-byte swizzle row of bf16
constexpr int kWStages = 4;
constexpr int kWThreads = 384;         // warpgroups 0, 1: consumers; 2: the producer
constexpr uint32_t kWATile = kWM * kWK * 2;           // 16 KB
constexpr uint32_t kWBTile = kWN * kWK * 2;           // 32 KB
constexpr uint32_t kWStage = kWATile + kWBTile;
constexpr uint32_t kWBox = 64 * kWK * 2;              // an [64][64] box: 8 KB
constexpr int kWOutBoxes = 2;          // output boxes a warpgroup stages at once (of 4)
constexpr uint32_t kWOut = kWOutBoxes * kWBox;        // a warpgroup's staged output
// the ring, then each consumer warpgroup's output boxes, + 1024-byte alignment
constexpr size_t kWSmem = size_t(kWStages) * kWStage + 2 * kWOut + 1024;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
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

// one box of a 3-D tensor map ([E][rows][cols], innermost first) into
// shared memory, completing on `bar`; out-of-bounds elements read as zero
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// wgmma's shared-memory matrix descriptor for a 128-byte-swizzled tile:
// start address, leading and stride byte offsets (16-byte units), layout 1
// (B128) in bits 62-63.  K-major: SBO = 1024 (eight 128-byte rows), LBO
// unused.  MN-major: SBO = 1024 (eight rows of K), LBO = the distance
// between 64-wide blocks of M or N.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d[64 x 256] += A[64 x 16] B[16 x 256]; kTrans: both operands MN-major
template <int kTrans>
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %131;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(kTrans));
}

// one box of shared memory out to a 3-D tensor map, clipped at its bounds
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, __nv_bfloat162 v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(*reinterpret_cast<uint32_t*>(&v))
               : "memory");
}

// the 128 threads of consumer warpgroup wg (barrier 0 is __syncthreads')
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma (whose completion it cannot see)
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One tile of the list: product (0 = dX, 1 = dW), expert, row and column
// tile, and its number of K stages.  The list is [first product's tiles]
// then [second's]; within a product, expert by expert, row tiles by column
// tiles (moe_gmm_bwd_tiles in ops.py is the same list in Python).
struct WTile { int prod, e, mt, nt, nk; };

struct WProblem {
  int E, C, D, F;
  int n_dx, n_dw;          // tiles of each product (0 when its output is null)
  int dw_first;
  __device__ WTile tile(int i) const {
    const bool first = i < (dw_first ? n_dw : n_dx);
    const int prod = first == (dw_first != 0) ? 1 : 0;
    if (!first) i -= dw_first ? n_dw : n_dx;
    const int M = prod ? D : C, N = prod ? F : D, K = prod ? C : F;
    const int mt = (M + kWM - 1) / kWM, nt = (N + kWN - 1) / kWN;
    const int per_e = mt * nt, r = i % per_e;
    return WTile{prod, i / per_e, r / nt, r % nt, (K + kWK - 1) / kWK};
  }
};

__global__ void __launch_bounds__(kWThreads, 1)
gmm_bwd_wgmma(const __grid_constant__ CUtensorMap dy_k,   // dY, [64 of F][128 of C] boxes
              const __grid_constant__ CUtensorMap w_k,    // W, [64 of F][256 of D]
              const __grid_constant__ CUtensorMap x_mn,   // X, [64 of D][64 of C]
              const __grid_constant__ CUtensorMap dy_mn,  // dY, [64 of F][64 of C]
              const __grid_constant__ CUtensorMap dx_out, // dX, [64 of D][64 of C]
              const __grid_constant__ CUtensorMap dw_out, // dW, [64 of F][64 of D]
              WProblem p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kWStages];   // full[s], then empty[s]
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;   // swizzle atoms: 1024-aligned
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * kWStages;
  const int n_tiles = p.n_dx + p.n_dw;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(full0 + 8 * s, 1);          // the producer's expect_tx; TMA's bytes
      mbar_init(empty0 + 8 * s, 8);         // each consumer warp once
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // the producer: one thread keeps the ring full, tile after tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 256) return;
    int s = 0;
    uint32_t phase = 0;
    for (int i = blockIdx.x; i < n_tiles; i += gridDim.x) {
      const WTile t = p.tile(i);
      for (int kb = 0; kb < t.nk; ++kb) {
        mbar_wait(empty0 + 8 * s, phase ^ 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t sa = base + s * kWStage, sb = sa + kWATile;
        mbar_expect_tx(full, kWStage);
        if (t.prod == 0) {           // K-major: A = dY rows of C, B = W rows of D
          tma_load(sa, &dy_k, kb * kWK, t.mt * kWM, t.e, full);
          tma_load(sb, &w_k, kb * kWK, t.nt * kWN, t.e, full);
        } else {                     // MN-major: [64 of K][64 of M or N] boxes
          tma_load(sa, &x_mn, t.mt * kWM, kb * kWK, t.e, full);
          tma_load(sa + kWBox, &x_mn, t.mt * kWM + 64, kb * kWK, t.e, full);
#pragma unroll
          for (int j = 0; j < kWN / 64; ++j)
            tma_load(sb + j * kWBox, &dy_mn, t.nt * kWN + 64 * j, kb * kWK, t.e, full);
        }
        if (++s == kWStages) { s = 0; phase ^= 1; }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const uint32_t out_s = base + kWStages * kWStage + wg * kWOut;   // this warpgroup's rows
  float acc[128];
  int s = 0;
  uint32_t phase = 0;
  for (int i = blockIdx.x; i < n_tiles; i += gridDim.x) {
    const WTile t = p.tile(i);
#pragma unroll
    for (int r = 0; r < 128; ++r) acc[r] = 0.0f;
    fence_acc(acc);
    for (int kb = 0; kb < t.nk; ++kb) {
      mbar_wait(full0 + 8 * s, phase);
      const uint32_t sa = base + s * kWStage + wg * kWBox, sb = base + s * kWStage + kWATile;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      if (t.prod == 0) {
        // K-major: a k16 step is 32 bytes along the swizzled 128-byte rows
#pragma unroll
        for (int k = 0; k < kWK / 16; ++k)
          wgmma_256<0>(acc, wgmma_desc(sa + 32 * k, 16, 1024), wgmma_desc(sb + 32 * k, 16, 1024));
      } else {
        // MN-major: a k16 step is 16 rows of 128 bytes
#pragma unroll
        for (int k = 0; k < kWK / 16; ++k)
          wgmma_256<1>(acc, wgmma_desc(sa + 2048 * k, kWBox, 1024),
                       wgmma_desc(sb + 2048 * k, kWBox, 1024));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the stage has been read: hand it back at once (the other
      // warpgroup's products fill the tensor cores meanwhile)
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      if (++s == kWStages) { s = 0; phase ^= 1; }
    }

    // The tile out: this warpgroup's [64 rows][256 columns] in shared
    // memory as 128-byte-swizzled [64][64] boxes, kWOutBoxes at a time,
    // each part leaving by TMA stores (clipped at M and N) that drain while
    // the next part is written and the next tile's products run.
    // acc[4 j + q] is row 16 warp + lane / 4 + 8 (q / 2),
    // column 8 j + 2 (lane % 4) + q % 2: a warp's 32 lanes write one
    // 16-byte chunk per row, the chunks of its 8 rows on distinct banks.
    const int N = t.prod ? p.F : p.D;
#pragma unroll
    for (int part = 0; part < kWN / 64 / kWOutBoxes; ++part) {
      // the previous stores have read out_s
      if (tid == 0 && (part > 0 || i != (int)blockIdx.x))
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      wg_sync(wg);
#pragma unroll
      for (int jj = 0; jj < 8 * kWOutBoxes; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = part * 8 * kWOutBoxes + jj, r = warp * 16 + lane / 4 + 8 * h;
          st_shared(out_s + (jj / 8) * kWBox + r * 128 + (((jj % 8) ^ (r % 8)) * 16) +
                        4 * (lane % 4),
                    __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to TMA
      wg_sync(wg);
      if (tid == 0) {
        for (int b = 0; b < kWOutBoxes; ++b) {
          const int c0 = t.nt * kWN + 64 * (part * kWOutBoxes + b);
          if (c0 < N)
            tma_store(t.prod ? &dw_out : &dx_out, out_s + b * kWBox, c0, t.mt * kWM + 64 * wg,
                      t.e);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (so the
// library needs no -lcuda); null where libcuda lacks it
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f)
                                                                   : nullptr;
  }();
  return fn;
}

// a bf16 [E][rows][cols] tensor in boxes of [64 of cols][box_rows]
bool tensor_map(CUtensorMap* map, const void* ptr, int E, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    return sms;
  }();
  return n;
}

// dX and dW in one launch of the persistent kernel
cudaError_t launch_bwd_wgmma(const bf16* x, const bf16* w, const bf16* dy, bf16* dx, bf16* dw,
                             int E, int C, int D, int F, int dw_first, cudaStream_t s) {
  CUtensorMap dy_k, w_k, x_mn, dy_mn, dx_out = {}, dw_out = {};
  if (!tensor_map(&dy_k, dy, E, C, F, kWM) || !tensor_map(&w_k, w, E, D, F, kWN) ||
      !tensor_map(&x_mn, x, E, C, D, kWK) || !tensor_map(&dy_mn, dy, E, C, F, kWK) ||
      (dx && !tensor_map(&dx_out, dx, E, C, D, 64)) ||
      (dw && !tensor_map(&dw_out, dw, E, D, F, 64)))
    return cudaErrorInvalidValue;
  WProblem p{E, C, D, F, 0, 0, dw_first};
  if (dx) p.n_dx = E * ((C + kWM - 1) / kWM) * ((D + kWN - 1) / kWN);
  if (dw) p.n_dw = E * ((D + kWM - 1) / kWM) * ((F + kWN - 1) / kWN);
  const int n_tiles = p.n_dx + p.n_dw, sms = sm_count();
  if (n_tiles == 0) return cudaSuccess;
  if (sms <= 0) return cudaErrorInvalidDevice;
  const cudaError_t err = allow_smem(gmm_bwd_wgmma, kWSmem);
  if (err != cudaSuccess) return err;
  gmm_bwd_wgmma<<<n_tiles < sms ? n_tiles : sms, kWThreads, kWSmem, s>>>(dy_k, w_k, x_mn, dy_mn,
                                                                         dx_out, dw_out, p);
  return cudaGetLastError();
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
// one dtype, all contiguous.  tensor_cores: 1 takes gmm_bwd_wgmma, one
// launch for both products (the forward's condition, dy, dx and dw
// 16-byte aligned too; refused otherwise), its tile list with dW's tiles
// first when dw_first (ops.py::moe_gmm_bwd_tiles); 0 gmm_bwd_simt, one
// launch a product.  A null dx or dw skips that product, so each half can
// be timed alone.  Launches on `stream` and returns the first failing
// launch's cudaError_t (0 = all queued).
extern "C" int moe_gmm_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw,
                           int dtype, long long E, long long C, long long D, long long F,
                           int tensor_cores, int dw_first, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 || C > 64LL * 65535 ||
      D > 64LL * 65535 || F > (1LL << 30) || E * C * D > (1LL << 40) ||
      E * D * F > (1LL << 40))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = (int)E, c = (int)C, d = (int)D, f = (int)F;
  if (tensor_cores) {
    if (dtype != 1 || D % 8 != 0 || F % 8 != 0 || !aligned16(x) || !aligned16(w) ||
        !aligned16(dy) || !aligned16(dx) || !aligned16(dw))
      return (int)cudaErrorInvalidValue;
    return (int)launch_bwd_wgmma(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                                 static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
                                 static_cast<bf16*>(dw), e, c, d, f, dw_first, s);
  }
  switch (dtype) {
    case 0: return (int)launch_bwd_simt_pair<float>(x, w, dy, dx, dw, e, c, d, f, s);
    case 1: return (int)launch_bwd_simt_pair<bf16>(x, w, dy, dx, dw, e, c, d, f, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
