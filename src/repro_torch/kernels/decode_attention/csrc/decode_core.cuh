// Decode attention core for Hopper (sm_90a), shared by dense_decode.cu (B2)
// and paged_decode.cu (B1).
//
// Both kernels compute single-token GQA attention of q [B, Hq, hd] over the
// cache entries of each (row b, KV head h); they differ only in where entry
// e of a row lives and which position it holds:
//   * dense: k/v [B, S, Hkv, hd], entry e holds position kv_pos[b][e] (or
//     kv_pos[e] in the shared form);
//   * paged: a pool k/v [P, ps, Hkv, hd] reached through page_table [B,
//     n_pt]; entry e = j*ps + t is row t of page table[b][j] and holds
//     position e; an unmapped page (-1) keeps nothing.
// An entry is kept iff it holds a position p >= 0 with p <= q_pos and, with
// a window, p > q_pos - window.  Softmax in f32 with scale hd^-0.5; the
// output has q's dtype.  A row that keeps nothing writes the mean of V over
// all its entries (dense: S; paged: n_pt * ps, unmapped pages read as page
// 0), which is what the plain version's softmax over all-masked scores
// gives it.
//
// What bounds it on an H100: bytes, and at serving sizes the latency of
// the trips to device memory.  Each kept entry's K and V row is read once
// (gemma-2b: 512 B + 512 B) for 4 * G flops per element pair, ~8 flop/byte
// at G = 8 against a ridge of ~295.
//
// Design:
//   * one thread-block cluster of n_c CTAs per (row, KV head, group of up
//     to 8 query heads), grid (n_c, Hkv * head groups, B); the CTAs split
//     the row's live range evenly (dense: all S entries; paged: the
//     positions from the window's start to q_pos), on the device, so row
//     lengths never reach the host;
//   * each CTA makes one dependent trip for metadata (the positions or page
//     ids of its range, q_pos and the queries go out together; a paged
//     range needs q_pos first) and writes the source row of every entry (or
//     -1 where the entry keeps nothing) and a flag per chunk into shared
//     memory.  A dense row's first chunk is copied in that same trip, since
//     its entry e is cache row e (its masked entries are read too);
//   * then it streams the chunks that keep entries through a two-stage
//     cp.async ring (16-byte cp.async.cg; a masked entry is zero-filled and
//     not read), so the next chunk's copy overlaps this chunk's math;
//   * math on the CUDA cores, each staged row read once for all query heads
//     of its KV head.  Scores: a group of lanes reads one K row, each lane
//     holding its slice of every head's query in registers, and the heads'
//     partial dots are summed over the group by a halving shuffle reduction
//     (9 shuffles for 8 heads over 32 lanes).  One warp per head then runs
//     the chunk's online softmax.  P.V: a thread owns one column of some
//     heads over the chunk's entries, its accumulators in registers;
//   * the CTA leaves (acc, m, l) per head in shared memory, the cluster
//     syncs, and the CTAs share the merge: every output element is merged
//     from all CTAs' states, read through distributed shared memory in rank
//     order.  A last cluster sync keeps each CTA's shared memory alive until
//     its peers have read it.  One launch, no scratch in device memory, no
//     atomics: the same bits on every call;
//   * a row that keeps nothing is known only after the first cluster sync;
//     then (and only then) each CTA sums the V columns of its share of all
//     the row's entries, the cluster syncs again, and the merge divides the
//     sum over ranks by the entry count;
//   * head dims are instantiated on HD in {16, 32, 64, 128, 256}; the real
//     hd <= HD arrives at run time and the tail columns stay zero.  The
//     registers hold 2 query heads (G <= 2) or 8.
// What this leaves on the table: TMA bulk copies, and the latency of each
// chunk's chain of shuffles, barriers and shared-memory loads, which sets
// the time at serving sizes (PERF.md); tensor cores would not help at ~8
// flop/byte.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1e30f;
constexpr int kMaxCluster = 8;      // portable cluster size
constexpr int kMaxHeads = 8;        // query heads per CTA (more: head groups on grid y)
constexpr int kWarps = 8;           // 256 threads a CTA
constexpr int kMeta = 1024;         // entries whose metadata a CTA holds at once
constexpr int kPad = 16;            // bytes of padding per staged row
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448; // 227 KB a block may opt in to

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 16 bytes global -> shared, in flight until the group is waited for;
// `fill` false writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Values per lane and lanes in use for a head dimension in the column sums
// of an idle row: HD / 32 values on all 32 lanes, or one on each of the
// first HD lanes when HD < 32.
template <int HD> struct LaneMap {
  static constexpr int VPL = HD >= 32 ? HD / 32 : 1;
  static constexpr int LANES = HD / VPL;
};

template <typename T, int HD> struct Tile {
  static constexpr int EPV = 16 / sizeof(T);                 // elements per 16-byte vector
  static constexpr int VPR = HD / EPV;                       // vectors per padded row
  static constexpr int LD = HD + kPad / sizeof(T);           // staged row, in elements
};

// Shared memory of one CTA (bytes), in the order the kernel lays it out:
// two stages of K and V chunks; the CTA's accumulator of 8 heads; the
// scores; the probabilities; m, l and the rescale per head; the metadata
// window, its chunk flags and one flag word.  The host function that picks
// the chunk (ops.py: decode_split) mirrors it.
__host__ __device__ inline size_t core_smem(int chunk, int itemsize, int HD) {
  const size_t ld = HD + kPad / itemsize;
  return 2 * 2 * size_t(chunk) * ld * itemsize        // stages x (K, V) x chunk rows
         + 4 * size_t(kMaxHeads) * HD                 // the CTA's accumulator
         + 4 * size_t(64 * kMaxHeads)                 // scores [8][chunk]
         + 4 * size_t(64 * kMaxHeads)                 // probabilities [chunk][8]
         + 4 * size_t(3 * kMaxHeads)                  // m, l, rescale
         + 4 * size_t(kMeta)                          // source row per entry, -1 = masked
         + 4 * size_t(kMeta / 32)                     // chunk keeps anything
         + 16;                                        // this CTA kept anything
}

struct CoreArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;              // dense only: each row's log-sum-exp [B, Hq], or null
  const int32_t* pos;      // dense: kv_pos; paged: page table
  const int32_t* q_pos;
  long long pos_stride;    // per row: dense S (0 shared), paged n_pt
  int qpos_stride;         // 1 per row, 0 shared
  int S;                   // dense: entries per row
  int P, ps, n_pt;         // paged: pool pages, page size, table width
  int Hq, Hkv, hd;
  int window;              // <= 0: none
  float scale;
  int chunk;               // entries per stage (32 or 64)
  int head_groups;         // ceil(G / kMaxHeads)
};

// What entry e's metadata comes from: its position (dense) or its page
// (paged).  One load, sent before anything that needs it.
template <bool PAGED>
__device__ __forceinline__ int entry_word(const CoreArgs& a, const int32_t* prow, int e) {
  return prow[PAGED ? e / a.ps : e];
}

// Source row of entry e (an index into the row's cache, dense, or into the
// pool's rows, paged), or -1 where the entry keeps nothing.
template <bool PAGED>
__device__ __forceinline__ int entry_row(const CoreArgs& a, int word, int e, int qp) {
  int p = e, row = e;
  if constexpr (PAGED) {
    if (word < 0 || word >= a.P) return -1;
    row = word * a.ps + e % a.ps;
  } else {
    p = word;
  }
  return (p >= 0 && p <= qp && (a.window <= 0 || p > qp - a.window)) ? row : -1;
}

// Column sums of V over this CTA's share of all N entries of a row that
// keeps nothing (paged: unmapped pages read as page 0), summed per warp in
// entry order and then in warp order, into vsum [HD].  `scratch` holds
// n_warps * HD floats.  Every thread of the CTA calls it.
template <typename T, int HD, bool PAGED>
__device__ void idle_column_sums(const CoreArgs& a, const T* vb, long long rs,
                                 const int32_t* prow, int rank, int n_c, float* scratch,
                                 float* vsum) {
  constexpr int VPL = LaneMap<HD>::VPL, LANES = LaneMap<HD>::LANES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  const int N = PAGED ? a.n_pt * a.ps : a.S;
  const int per = (N + n_c - 1) / n_c;
  const int e0 = rank * per, e1 = min(N, e0 + per);
  float acc[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) acc[i] = 0.f;
  if (lane < LANES) {
#pragma unroll 4
    for (int e = e0 + warp; e < e1; e += n_warps) {
      long long row = e;
      if constexpr (PAGED) {
        const int j = e / a.ps;
        int page = prow[j];
        if (page < 0) page = 0;
        if (page >= a.P) continue;
        row = (long long)page * a.ps + (e - j * a.ps);
      }
      const T* vr = vb + row * rs + lane * VPL;
#pragma unroll
      for (int i = 0; i < VPL; ++i)
        if (lane * VPL + i < a.hd) acc[i] += to_f32(vr[i]);
    }
#pragma unroll
    for (int i = 0; i < VPL; ++i) scratch[warp * HD + lane * VPL + i] = acc[i];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float t = 0.f;
    for (int w = 0; w < n_warps; ++w) t += scratch[w * HD + d];
    vsum[d] = t;
  }
}

// Lanes per staged row in the score step (a group), and 16-byte vectors of
// the row per lane: a row of HD elements is VPR vectors.
template <typename T, int HD> struct Groups {
  static constexpr int VPR = Tile<T, HD>::VPR;
  static constexpr int L = VPR < 32 ? VPR : 32;       // lanes per row
  static constexpr int NVL = VPR / L;                 // vectors per lane
  static constexpr int NQ = NVL * Tile<T, HD>::EPV;   // query values per lane and head
};

// One halving step of the reduction over a group: the lanes whose `s` bit
// is set keep the upper half of the first N values, the others the lower
// half, and each adds its partner's copy of the half it keeps.
template <int N, int NH>
__device__ __forceinline__ void halve(float (&v)[NH], int lane, int s, int& head0) {
  const bool up = lane & s;
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const float send = up ? v[j] : v[j + N / 2];
    const float keep = up ? v[j + N / 2] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, s);
  }
  if (up) head0 += N / 2;
}

// Sums each of NH per-head partial dots over the lanes of a group (strides
// S, S / 2, ..., 1), halving the values held while more than one is left
// (9 shuffles for 8 heads over 32 lanes, not 40).  Afterwards v[0 ..
// NH >> halvings) hold heads head0, head0 + 1, ..., summed in the same order
// on every call.
template <int S, int N, int NH>
__device__ __forceinline__ void reduce_heads(float (&v)[NH], int lane, int& head0) {
  if constexpr (S >= 1) {
    if constexpr (N > 1) {
      halve<N, NH>(v, lane, S, head0);
      reduce_heads<S / 2, N / 2, NH>(v, lane, head0);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], S);
      reduce_heads<S / 2, 1, NH>(v, lane, head0);
    }
  }
}

// log2 of a power of two
__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }

// One CTA: rank `rank` of the cluster of (row b, KV head h, head group hg).
// NH: heads the CTA's registers hold (2 when G <= 2, else 8).  With 2 heads
// the registers are held to three CTAs an SM: such launches have many
// small clusters (one per KV head), and a second wave would cost more than
// the registers do.
template <typename T, int HD, int NH, bool PAGED, bool VEC>
__global__ void __launch_bounds__(32 * kWarps, NH <= 2 ? 3 : 1)
decode_core_kernel(const CoreArgs a) {
  using TL = Tile<T, HD>;
  using GR = Groups<T, HD>;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.z;
  const int h = blockIdx.y / a.head_groups, hg = blockIdx.y - h * a.head_groups;
  const int G = a.Hq / a.Hkv;
  const int gc = min(G, kMaxHeads);            // heads the CTA is laid out for
  const int g0 = hg * kMaxHeads, gn = min(gc, G - g0);   // heads it serves
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hd = a.hd, chunk = a.chunk;

  extern __shared__ __align__(16) unsigned char smem[];
  T* stage_s = reinterpret_cast<T*>(smem);     // [2 stages][K, V][chunk][LD]
  float* acc_s = reinterpret_cast<float*>(smem + 4 * size_t(chunk) * TL::LD * sizeof(T));
                                               // [8][HD] the CTA's accumulator
  float* dot_s = acc_s + kMaxHeads * HD;       // [kMaxHeads][64] scores
  float* p_s = dot_s + 64 * kMaxHeads;         // [chunk][kMaxHeads] probabilities
  float* m_s = p_s + 64 * kMaxHeads;           // [kMaxHeads] running max
  float* l_s = m_s + kMaxHeads;                // [kMaxHeads] running sum
  float* corr_s = l_s + kMaxHeads;             // [kMaxHeads] this chunk's rescale
  int* meta_s = reinterpret_cast<int*>(corr_s + kMaxHeads);   // [kMeta]
  int* flag_s = meta_s + kMeta;                // [kMeta / 32]
  int* kept_s = flag_s + kMeta / 32;           // [1]

  const int qp = a.q_pos[(long long)b * a.qpos_stride];
  // the scaled queries in registers: lane owns vectors (lane % L) + k * L
  // of every head's row (zeros past hd and for heads past gn)
  const T* q = static_cast<const T*>(a.q) + ((long long)b * a.Hq + (long long)h * G + g0) * hd;
  // loaded raw here and converted once the metadata is in, so that the two
  // trips to device memory overlap
  uint4 q_raw[NH][GR::NVL];
#pragma unroll
  for (int g = 0; g < NH; ++g)
#pragma unroll
    for (int k = 0; k < GR::NVL; ++k) {
      const int d0 = ((lane % GR::L) + k * GR::L) * TL::EPV;
      q_raw[g][k] = make_uint4(0, 0, 0, 0);
      T* qv = reinterpret_cast<T*>(&q_raw[g][k]);
      if (VEC && g < gn && d0 < hd) {
        q_raw[g][k] = *reinterpret_cast<const uint4*>(q + g * hd + d0);
      } else {
#pragma unroll
        for (int x = 0; x < TL::EPV; ++x)
          if (g < gn && d0 + x < hd) qv[x] = q[g * hd + d0 + x];
      }
    }
  float qr[NH][GR::NQ];
  bool q_ready = false;
  auto convert_q = [&]() {
#pragma unroll
    for (int g = 0; g < NH; ++g)
#pragma unroll
      for (int k = 0; k < GR::NVL; ++k) {
        const T* qv = reinterpret_cast<const T*>(&q_raw[g][k]);
#pragma unroll
        for (int x = 0; x < TL::EPV; ++x) qr[g][k * TL::EPV + x] = to_f32(qv[x]) * a.scale;
      }
    q_ready = true;
  };
  // heads past gn keep zero queries, probabilities and accumulators, so the
  // loops over heads need no bound
  for (int i = tid; i < 64 * kMaxHeads; i += blockDim.x) p_s[i] = 0.f;
  if (tid < kMaxHeads) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    corr_s[tid] = 1.f;
  }
  if (hd < HD)   // the copies write columns [0, hd); the rest stays zero
    for (int i = tid; i < 4 * chunk * (HD - hd); i += blockDim.x) {
      const int r = i / (HD - hd);
      stage_s[r * TL::LD + hd + (i - r * (HD - hd))] = from_f32<T>(0.f);
    }

  const int32_t* prow = a.pos + (long long)b * a.pos_stride;
  int lo = 0, hi = a.S;
  if constexpr (PAGED) {
    hi = min(qp + 1, a.n_pt * a.ps);
    if (a.window > 0) lo = max(0, qp - a.window + 1);
  }
  const int per = (max(hi - lo, 0) + n_c - 1) / n_c;
  const int my_lo = lo + rank * per, my_hi = min(hi, my_lo + per);
  const long long rs = (long long)a.Hkv * hd;  // one entry further
  const long long base = PAGED ? (long long)h * hd : ((long long)b * a.S * a.Hkv + h) * hd;
  const T* kb = static_cast<const T*>(a.k) + base;
  const T* vb = static_cast<const T*>(a.v) + base;

  // scores: a group of L lanes per entry, 32 / L entries per warp step
  constexpr int EPS = 32 / GR::L;
  constexpr int EB = 4;                        // entries a warp scores at once
  constexpr int HALVINGS = ilog2(GR::L) < ilog2(NH) ? ilog2(GR::L) : ilog2(NH);
  constexpr int NV = NH >> HALVINGS;           // heads a lane ends with
  const int grp = lane / GR::L;
  const bool rep_lane = ((lane % GR::L) & ((GR::L >> HALVINGS) - 1)) == 0;
  // P.V: the NH x HD outputs, OW at a time over the CTA's threads: thread
  // owns column pd of heads ph0, ph0 + TPD, ... (NHT of them), over the
  // entries es, es + ES, ... of each chunk (ES > 1 only when there are
  // fewer outputs than threads; the splits are summed at the end)
  constexpr int OW = NH * HD < 32 * kWarps ? NH * HD : 32 * kWarps;
  constexpr int ES = 32 * kWarps / OW, TPD = OW / HD, NHT = NH / TPD;
  const int pd = tid % HD, ph0 = (tid / HD) % TPD, es = tid / OW;
  float acc[NHT];
#pragma unroll
  for (int k = 0; k < NHT; ++k) acc[k] = 0.f;

  for (int w0 = my_lo; w0 < my_hi; w0 += kMeta) {
    const int wn = min(kMeta, my_hi - w0);
    const int nch = (wn + chunk - 1) / chunk;
    // copy chunk c of the window into stage st: the rows the metadata names,
    // or (direct, dense only) rows w0 + c * chunk + r before it is known
    auto load_chunk = [&](int c, int st, bool direct) {
      T* ks = stage_s + size_t(2 * st) * chunk * TL::LD;
      T* vs = ks + size_t(chunk) * TL::LD;
      const int* mr = meta_s + c * chunk;
      auto row_of = [&](int r) {
        return direct ? (c * chunk + r < wn ? w0 + c * chunk + r : -1) : mr[r];
      };
      if constexpr (VEC) {
        // thread: vector cv of rows r0, r0 + RPI, ...
        constexpr int RPI = 32 * kWarps / TL::VPR;
        const int cv = tid % TL::VPR;
        if (cv * TL::EPV < hd) {
          for (int r = tid / TL::VPR; r < chunk; r += RPI) {
            const int row = row_of(r);
            const long long off = (long long)max(row, 0) * rs + cv * TL::EPV;
            cp_async16(ks + r * TL::LD + cv * TL::EPV, kb + off, row >= 0);
            cp_async16(vs + r * TL::LD + cv * TL::EPV, vb + off, row >= 0);
          }
        }
      } else {
        for (int i = tid; i < chunk * hd; i += blockDim.x) {
          const int r = i / hd, d = i - r * hd;
          const int row = row_of(r);
          T kx = from_f32<T>(0.f), vx = kx;
          if (row >= 0) {
            kx = kb[(long long)row * rs + d];
            vx = vb[(long long)row * rs + d];
          }
          ks[r * TL::LD + d] = kx;
          vs[r * TL::LD + d] = vx;
        }
      }
    };

    // the metadata loads go out first; then, for a dense row, whose entry e
    // is cache row e, the first chunk's copy, which need not wait for the
    // positions (its masked entries are read too, with p = 0)
    constexpr int kMetaPerThread = kMeta / (32 * kWarps);
    int words[kMetaPerThread];
#pragma unroll
    for (int k = 0; k < kMetaPerThread; ++k) {
      const int i = tid + k * 32 * kWarps;
      words[k] = i < wn ? entry_word<PAGED>(a, prow, w0 + i) : -1;
    }
    if constexpr (!PAGED) load_chunk(0, 0, true);
    cp_async_commit();
    if (!q_ready) convert_q();
#pragma unroll
    for (int k = 0; k < kMetaPerThread; ++k) {
      const int i = tid + k * 32 * kWarps;
      if (i < nch * chunk) meta_s[i] = i < wn ? entry_row<PAGED>(a, words[k], w0 + i, qp) : -1;
    }
    __syncthreads();
    for (int c = warp; c < nch; c += kWarps) {
      bool any = false;
      for (int i = lane; i < chunk; i += 32) any |= meta_s[c * chunk + i] >= 0;
      any = __any_sync(0xffffffffu, any);
      if (lane == 0) flag_s[c] = any;
    }
    __syncthreads();

    auto next_live = [&](int c) {
      for (++c; c < nch && !flag_s[c]; ++c) {
      }
      return c;
    };
    int cur = next_live(-1), st = 0;
    if (PAGED || cur != 0) {   // the direct copy (if any) is not the first live chunk
      cp_async_wait<0>();
      __syncthreads();
      if (cur < nch) load_chunk(cur, 0, false);
      cp_async_commit();
    }
    while (cur < nch) {
      const int nxt = next_live(cur);
      if (nxt < nch) load_chunk(nxt, st ^ 1, false);
      cp_async_commit();
      cp_async_wait<1>();   // this chunk's copies have landed
      __syncthreads();
      const T* ks = stage_s + size_t(2 * st) * chunk * TL::LD;
      const T* vs = ks + size_t(chunk) * TL::LD;
      const int* mr = meta_s + cur * chunk;

      // 1. scores: the group of entry e reads its row once for all heads;
      // a warp takes EB entries at once so their reductions overlap
      for (int e0 = warp * EPS; e0 < chunk; e0 += EB * kWarps * EPS) {
        float d[EB][NH];
#pragma unroll
        for (int j = 0; j < EB; ++j) {
          const int e = e0 + j * kWarps * EPS + grp;
#pragma unroll
          for (int g = 0; g < NH; ++g) d[j][g] = 0.f;
          if (e0 + j * kWarps * EPS < chunk) {
#pragma unroll
            for (int k = 0; k < GR::NVL; ++k) {
              const uint4 raw = *reinterpret_cast<const uint4*>(
                  ks + e * TL::LD + ((lane % GR::L) + k * GR::L) * TL::EPV);
              const T* kt = reinterpret_cast<const T*>(&raw);
#pragma unroll
              for (int x = 0; x < TL::EPV; ++x) {
                const float kx = to_f32(kt[x]);
#pragma unroll
                for (int g = 0; g < NH; ++g) d[j][g] += qr[g][k * TL::EPV + x] * kx;
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < EB; ++j) {
          const int e = e0 + j * kWarps * EPS + grp;
          int head0 = 0;
          reduce_heads<GR::L / 2, NH, NH>(d[j], lane, head0);
          if (rep_lane && e0 + j * kWarps * EPS < chunk) {
#pragma unroll
            for (int v = 0; v < NV; ++v) dot_s[(head0 + v) * 64 + e] = d[j][v];
          }
        }
      }
      __syncthreads();

      // 2. online softmax of the chunk, one warp per head
      if (warp < gn) {
        const int g = warp;
        float s[2], p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = lane + 32 * e;
          s[e] = kNegInf;
          if (r < chunk && mr[r] >= 0) s[e] = dot_s[g * 64 + r];
        }
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(s[0], s[1])));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = lane + 32 * e;
          p[e] = (r < chunk && mr[r] >= 0) ? expf(s[e] - m_new) : 0.f;
          if (r < chunk) p_s[r * kMaxHeads + g] = p[e];
        }
        const float sum = warp_sum(p[0] + p[1]);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          corr_s[g] = corr;
          l_s[g] = l_s[g] * corr + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();

      // 3. P.V (a masked entry has p = 0 and zero V)
#pragma unroll
      for (int k = 0; k < NHT; ++k) acc[k] *= corr_s[ph0 + k * TPD];
      {
        const T* vc = vs + pd;
#pragma unroll 8
        for (int r = es; r < chunk; r += ES) {
          const float vx = to_f32(vc[r * TL::LD]);
          float pr[NHT];
          if constexpr (TPD == 1 && NH % 4 == 0) {   // every head: aligned vectors
#pragma unroll
            for (int k = 0; k < NHT; k += 4) {
              const float4 p4 = *reinterpret_cast<const float4*>(p_s + r * kMaxHeads + k);
              pr[k] = p4.x, pr[k + 1] = p4.y, pr[k + 2] = p4.z, pr[k + 3] = p4.w;
            }
          } else {
#pragma unroll
            for (int k = 0; k < NHT; ++k) pr[k] = p_s[r * kMaxHeads + ph0 + k * TPD];
          }
#pragma unroll
          for (int k = 0; k < NHT; ++k) acc[k] += pr[k] * vx;
        }
      }
      __syncthreads();      // everyone is done with this stage before it refills
      cur = nxt;
      st ^= 1;
    }
    cp_async_wait<0>();
    __syncthreads();        // flags and metadata are read no more
  }

  // the CTA's (acc, m, l) for its peers; entry splits summed in order
  if constexpr (ES > 1) {
    dot_s[tid] = acc[0];   // [ES][OW]; the scores are needed no more
    __syncthreads();
    if (es == 0) {
      float t = 0.f;
      for (int x = 0; x < ES; ++x) t += dot_s[x * OW + tid];
      acc_s[ph0 * HD + pd] = t;
    }
  } else {
#pragma unroll
    for (int k = 0; k < NHT; ++k) acc_s[(ph0 + k * TPD) * HD + pd] = acc[k];
  }
  if (tid == 0) kept_s[0] = l_s[0] > 0.f;
  cluster.sync();

  // remote reads are sent together (unrolled, predicated by rank): one
  // trip through distributed shared memory, not n_c
  int row_kept = 0;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < n_c) row_kept |= *cluster.map_shared_rank(kept_s, r);
  T* out = static_cast<T*>(a.out) + ((long long)b * a.Hq + (long long)h * G + g0) * hd;
  const int nthr = blockDim.x;
  if (row_kept) {
    // merge (acc, m, l) of every CTA, in rank order
    for (int i = rank * nthr + tid; i < gn * HD; i += n_c * nthr) {
      const int g = i / HD, d = i - g * HD;
      if (d >= hd) continue;
      float mr[kMaxCluster], lr[kMaxCluster], ar[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        mr[r] = kNegInf, lr[r] = 0.f, ar[r] = 0.f;
        if (r < n_c) {
          mr[r] = cluster.map_shared_rank(m_s, r)[g];
          lr[r] = cluster.map_shared_rank(l_s, r)[g];
          ar[r] = cluster.map_shared_rank(acc_s, r)[i];
        }
      }
      float m_tot = kNegInf;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) m_tot = fmaxf(m_tot, mr[r]);
      float l_tot = 0.f, a_tot = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r >= n_c) break;
        const float w = expf(mr[r] - m_tot);
        l_tot += lr[r] * w;
        a_tot += ar[r] * w;
      }
      out[g * hd + d] = from_f32<T>(a_tot / l_tot);
      if (a.lse != nullptr && d == 0)
        a.lse[(long long)b * a.Hq + (long long)h * G + g0 + g] = m_tot + logf(l_tot);
    }
  } else {
    // a row that keeps nothing: the mean of V over all its entries
    float* vsum_s = dot_s;   // the partial dots are needed no more
    idle_column_sums<T, HD, PAGED>(a, vb, rs, prow, rank, n_c,
                                   reinterpret_cast<float*>(stage_s), vsum_s);
    cluster.sync();
    const float n = (float)(PAGED ? a.n_pt * a.ps : a.S);
    for (int i = rank * nthr + tid; i < gn * HD; i += n_c * nthr) {
      const int g = i / HD, d = i - g * HD;
      if (d >= hd) continue;
      float vr[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        vr[r] = r < n_c ? cluster.map_shared_rank(vsum_s, r)[d] : 0.f;
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) s += vr[r];
      out[g * hd + d] = from_f32<T>(s / n);
      // kept nothing: weighs nothing in a merge over cache shards
      if (a.lse != nullptr && d == 0)
        a.lse[(long long)b * a.Hq + (long long)h * G + g0 + g] = __int_as_float(0xff800000);  // -inf
    }
  }
  cluster.sync();   // peers may still read this CTA's shared memory until here
}

template <typename T, int HD, bool PAGED>
cudaError_t core_launch(const CoreArgs& a, int B, int n_c, bool vec, cudaStream_t stream) {
  const size_t smem = core_smem(a.chunk, sizeof(T), HD);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const bool few = a.Hq / a.Hkv <= 2;
  auto kern = few ? (vec ? decode_core_kernel<T, HD, 2, PAGED, true>
                         : decode_core_kernel<T, HD, 2, PAGED, false>)
                  : (vec ? decode_core_kernel<T, HD, kMaxHeads, PAGED, true>
                         : decode_core_kernel<T, HD, kMaxHeads, PAGED, false>);
  if (smem > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_c, a.Hkv * a.head_groups, B);
  cfg.blockDim = dim3(32 * kWarps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Checks what every launch needs, then dispatches on dtype (0 = float32,
// 1 = bfloat16, 2 = float16) and the padded head dimension.  Returns the
// launch's cudaError_t (0 on success); launches on `stream` and does not
// synchronise.
template <bool PAGED>
int core_dispatch(CoreArgs a, int dtype, int B, int n_c, void* stream) {
  if (B <= 0 || B > 65535 || a.Hkv <= 0 || a.Hq <= 0 || a.Hq % a.Hkv != 0 || a.hd <= 0 ||
      a.hd > 256 || n_c < 1 || n_c > kMaxCluster || (a.chunk != 32 && a.chunk != 64))
    return (int)cudaErrorInvalidValue;
  a.head_groups = (a.Hq / a.Hkv + kMaxHeads - 1) / kMaxHeads;
  if ((long long)a.Hkv * a.head_groups > 65535) return (int)cudaErrorInvalidValue;
  const int itemsize = dtype == 0 ? 4 : 2;
  const bool vec = a.hd % (16 / itemsize) == 0 && reinterpret_cast<uintptr_t>(a.q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int HD = a.hd <= 16 ? 16 : a.hd <= 32 ? 32 : a.hd <= 64 ? 64 : a.hd <= 128 ? 128 : 256;
#define DECODE_CORE_HD(T)                                          \
  switch (HD) {                                                    \
    case 16: return (int)core_launch<T, 16, PAGED>(a, B, n_c, vec, s);   \
    case 32: return (int)core_launch<T, 32, PAGED>(a, B, n_c, vec, s);   \
    case 64: return (int)core_launch<T, 64, PAGED>(a, B, n_c, vec, s);   \
    case 128: return (int)core_launch<T, 128, PAGED>(a, B, n_c, vec, s); \
    default: return (int)core_launch<T, 256, PAGED>(a, B, n_c, vec, s);  \
  }
  switch (dtype) {
    case 0: DECODE_CORE_HD(float)
    case 1: DECODE_CORE_HD(__nv_bfloat16)
    case 2: DECODE_CORE_HD(__half)
    default: return (int)cudaErrorInvalidValue;
  }
#undef DECODE_CORE_HD
}

}  // namespace
