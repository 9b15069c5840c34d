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
// What bounds it on an H100: bytes.  At the MoE path's shapes (E = 32,
// D x F = 1024 x 512 or 512 x 1024, C = 8 .. 416 capacity slots) the
// expert weights alone are 33.5 MB per call in bf16; the flops reach
// 2 x 32 x 416 x 1024 x 512 = 14 GFLOP only at the widest prefill, still
// below the bytes' time at the bf16 tensor-core rate.
//
// Design (simple first): one block of 256 threads per (F tile of 64,
// C tile of BC, expert).  BC is 16, 32 or 64, the smallest that holds C
// (64 beyond), so a decode step's 8 slots do not pay for 64 rows.  The block
// walks D in steps of 64: each step's x tile [BC x 64] and w tile [64 x 64]
// are converted to f32 and staged in shared memory, and the next step's
// tiles are already loading into registers while this step's products run
// (double buffering through registers).  Each thread owns a BC/16 x 4
// micro-tile of the output in f32 registers.  Loads are 16-byte vectors
// when D and F allow it and the pointers are aligned; otherwise element by
// element, masked, so any E, C, D and F work (the TPU kernel needs block
// sizes that tile all three).  No atomics and no split of D across blocks:
// every output element is summed by one thread in the order d = 0, 1, ...,
// so the result is the same on every run and every stream.  Left on the
// table: the tensor cores (wgmma with TMA-fed shared-memory rings), fusing
// the gate and up products (they share x), and a persistent grid.
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
moe_gmm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
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
  moe_gmm_kernel<T, BC, VEC><<<grid, kThreads, 0, s>>>(x, w, out, C, D, F);
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
cudaError_t launch(const void* x, const void* w, void* out, int E, int C, int D, int F,
                   cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const T* x_ = static_cast<const T*>(x);
  const T* w_ = static_cast<const T*>(w);
  T* o_ = static_cast<T*>(out);
  if (D % kVec == 0 && F % kVec == 0 && aligned16(x) && aligned16(w))
    return launch_vec<T, kVec>(x_, w_, o_, E, C, D, F, s);
  return launch_vec<T, 1>(x_, w_, o_, E, C, D, F, s);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  x: [E, C, D], w: [E, D, F],
// out: [E, C, F], one dtype, all contiguous.  Launches on `stream` and
// returns the launch's cudaError_t (0 = queued).
extern "C" int moe_gmm_fwd(const void* x, const void* w, void* out, int dtype, long long E,
                           long long C, long long D, long long F, void* stream) {
  // grid: (F / 64, C / 16 at most, E) blocks, each within CUDA's limits
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 || C > 16LL * 65535 ||
      D > (1LL << 30) || F > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(x, w, out, (int)E, (int)C, (int)D, (int)F, s);
    case 1: return (int)launch<__nv_bfloat16>(x, w, out, (int)E, (int)C, (int)D, (int)F, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
