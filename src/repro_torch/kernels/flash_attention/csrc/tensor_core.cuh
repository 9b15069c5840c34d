// Tensor-core and async-copy building blocks for Hopper (sm_90a), shared by
// the flash-attention forward (flash_fwd.cu) and backward (flash_bwd.cu):
// 16-byte cp.async, ldmatrix (plain and transposed), mma.sync.m16n8k16 with
// bf16 / fp16 operands and f32 accumulation, and f32 pairs packed as two
// 16-bit operands.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 g + t4): A [16 x 16] row-major,
// a[0] = A[g][2 t4 .. +1], a[1] = A[g + 8][..], a[2] = A[g][2 t4 + 8 ..],
// a[3] = A[g + 8][2 t4 + 8 ..]; B [16 x 8], b0 = B[2 t4 .. +1][g], b1 =
// B[2 t4 + 8 .. +9][g]; C [16 x 8], c[0..1] = C[g][2 t4 .. +1], c[2..3] =
// C[g + 8][..].  A C fragment is therefore the A fragment of the next
// product over the same rows, packed two columns a register.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !ok (src not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// The element offset of chunk c (8 elements) of a row at element offset row,
// for cp_async16.  A chunk that loads nothing (!ok) keeps an in-bounds
// address: column c of the first row at an exact width (PAD false; on an
// H100 this form reads 2-3% faster than the other at hd 64 / 128), the first
// row's base at a padded width (PAD true; chunk c may lie past a true row).
template <bool PAD>
__device__ __forceinline__ long long chunk_off(bool ok, long long row, int c) {
  return PAD ? (ok ? row + c * 8 : 0) : (ok ? row : 0) + c * 8;
}

// 4 bytes global -> shared, asynchronously; zeros when !ok
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// two 8 x 8 matrices, transposed; lanes 0-15 give the row addresses
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// c[16x8] += a[16x16] b[16x8], f32 accumulate
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&c)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&c)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as one register of two T, the first in the low half
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a register of two T back to f32
template <typename T> __device__ __forceinline__ float2 unpack2(uint32_t r);
template <> __device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
}
template <> __device__ __forceinline__ float2 unpack2<__half>(uint32_t r) {
  return __half22float2(*reinterpret_cast<__half2*>(&r));
}

// (x0, x1) as three terms of T each: hi = x rounded, mid = (x - hi)
// rounded, lo = (x - hi - mid) rounded, so hi + mid + lo keeps ~24 bits of
// each (8 + 8 + 8 in bf16), an f32's worth
template <typename T>
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = pack2<T>(x0, x1);
  const float2 h = unpack2<T>(hi);
  const float r0 = x0 - h.x, r1 = x1 - h.y;
  mid = pack2<T>(r0, r1);
  const float2 m = unpack2<T>(mid);
  lo = pack2<T>(r0 - m.x, r1 - m.y);
}

}  // namespace
