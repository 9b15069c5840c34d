// Paged decode attention, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/kernel.py::paged_decode_attention_kernel_call
//   (body _paged_kernel, pl.pallas_call at kernel.py:234).
//
// Computes single-token GQA attention for every batch row b: the query
// q [B, Hq, hd] against a global page pool k/v [P, ps, Hkv, hd] reached
// through a page table [B, n_pt] (int32, -1 = unmapped).  The logical
// position of table entry (j, t) is j*ps + t.  An entry is kept iff its page
// is mapped, pos <= q_pos[b] and, with a window, pos > q_pos[b] - window.  A
// row that keeps nothing (an idle serving slot: nothing mapped) writes what
// the plain version's softmax over all-masked scores gives it, the mean of
// V over all n_pt * ps entries its table gathers (unmapped pages read as
// page 0), so what an idle row feeds the layers after attention is the
// plain version's (a MoE FFN routes idle rows too).
//
// What bounds it and how: see decode_core.cuh, the split-K cluster core it
// shares with the dense kernel (dense_decode.cu).  The TPU kernel gets the
// table by scalar prefetch; here each CTA reads q_pos[b], then the table
// entries of its share of the row's live positions (the window's start to
// q_pos[b]), and gathers that share's pages chunk by chunk through a
// cp.async ring; unmapped pages inside the range are zero-filled, not read.
#include "decode_core.cuh"

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  hd <= 256; rows whose
// bytes are not 16-aligned take scalar copies.  n_c: CTAs per cluster
// (1..8); chunk: entries per pipeline stage (32 or 64), both picked by the
// caller (ops.py: decode_split).  window <= 0: no window.  Returns the
// launch's cudaError_t (0 on success); launches on `stream` and does not
// synchronise.
extern "C" int paged_decode_attention(const void* q, const void* k_pages,
                                      const void* v_pages, const int32_t* table,
                                      const int32_t* q_pos, void* out, int dtype, int B,
                                      int Hq, int Hkv, int hd, int P, int ps, int n_pt, int n_c,
                                      int chunk, int window, float scale, void* stream) {
  if (ps <= 0 || n_pt <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  CoreArgs a = {};
  a.q = q;
  a.k = k_pages;
  a.v = v_pages;
  a.out = out;
  a.pos = table;
  a.q_pos = q_pos;
  a.pos_stride = n_pt;
  a.qpos_stride = 1;
  a.P = P;
  a.ps = ps;
  a.n_pt = n_pt;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.hd = hd;
  a.window = window;
  a.scale = scale;
  a.chunk = chunk;
  return core_dispatch<true>(a, dtype, B, n_c, stream);
}
