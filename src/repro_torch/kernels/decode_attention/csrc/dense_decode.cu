// Dense-cache decode attention, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/kernel.py::decode_attention_kernel_call
//   (body _kernel, pl.pallas_call at kernel.py:106).
//
// Computes single-token GQA attention for every batch row b: the query
// q [B, Hq, hd] against a dense (linear or ring) cache k/v [B, S, Hkv, hd]
// whose entries carry absolute positions kv_pos.  Two forms, one kernel:
//   * shared:  kv_pos [S],    q_pos []   (the wave engine's cache);
//   * per-row: kv_pos [B, S], q_pos [B]  (the slot engine's cache);
// the shared form is the per-row one with a batch stride of 0.  Entry e of
// a row keeps position kv_pos[e]; a row that keeps nothing writes the mean
// of V over its S entries.
//
// What bounds it and how: see decode_core.cuh, the split-K cluster core it
// shares with the paged kernel (paged_decode.cu).  The dense range of a row
// is all S entries (a ring buffer's positions can sit anywhere), so each
// CTA reads the positions of its S / n_c entries and then streams only the
// chunks that keep one.
#include "decode_core.cuh"

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  hd <= 256 (padded to 16,
// 32, 64, 128 or 256 inside).  pos_per_row / qpos_per_row: 1 for kv_pos
// [B, S] and q_pos [B], 0 for kv_pos [S] and q_pos [].  n_c: CTAs per
// cluster (1..8), each taking ceil(S / n_c) entries; chunk: entries per
// pipeline stage (32 or 64), both picked by the caller (ops.py:
// decode_split).  window <= 0: no window.  lse: null, or f32 [B, Hq] for
// each row's log-sum-exp of its kept scaled scores (-inf where it keeps
// nothing), which a merge over cache shards weighs the row by.  Returns the
// launch's cudaError_t (0 on success); launches on `stream` and does not
// synchronise.
extern "C" int dense_decode_attention_lse(const void* q, const void* k, const void* v,
                                          const int32_t* kv_pos, const int32_t* q_pos,
                                          void* out, float* lse, int dtype, int B, int S,
                                          int Hq, int Hkv, int hd, int pos_per_row,
                                          int qpos_per_row, int n_c, int chunk, int window,
                                          float scale, void* stream) {
  if (S <= 0) return (int)cudaErrorInvalidValue;
  CoreArgs a = {};
  a.lse = lse;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.pos = kv_pos;
  a.q_pos = q_pos;
  a.pos_stride = pos_per_row ? (long long)S : 0;
  a.qpos_stride = qpos_per_row ? 1 : 0;
  a.S = S;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.hd = hd;
  a.window = window;
  a.scale = scale;
  a.chunk = chunk;
  return core_dispatch<false>(a, dtype, B, n_c, stream);
}

extern "C" int dense_decode_attention(const void* q, const void* k, const void* v,
                                      const int32_t* kv_pos, const int32_t* q_pos, void* out,
                                      int dtype, int B, int S, int Hq, int Hkv, int hd,
                                      int pos_per_row, int qpos_per_row, int n_c, int chunk,
                                      int window, float scale, void* stream) {
  return dense_decode_attention_lse(q, k, v, kv_pos, q_pos, out, nullptr, dtype, B, S, Hq,
                                    Hkv, hd, pos_per_row, qpos_per_row, n_c, chunk, window,
                                    scale, stream);
}
