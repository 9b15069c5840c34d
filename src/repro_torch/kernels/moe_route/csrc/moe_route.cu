// Slot assignment of MoE routing (repro_torch::moe_route_slots), hand-written
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package counts slots with XLA
// (src/repro/models/moe.py::moe_ffn, a one-hot cumsum a rank).  Run eagerly
// on the card, the port's one cumulative count over the claims
// (models/moe.py::route before this kernel; ops.py::route_slots_plain now)
// is an int64 one-hot [G, k*Tg, E] scanned along the claims: PyTorch's
// outer-dim scan walks the ~10^5 claims one after another for each expert,
// 13 ms a call at moonlight-16b-a3b's 49,152 claims, ~15 launches in all.
//
// The function.  Claim c = r*Tg + t of group g is token t's rank-r choice
// expert_idx[g, t, r] (the reference's rank-major order: every token's first
// choice, then every second choice).  Its rank is the number of earlier
// claims on its expert.  Outputs, every element written exactly once (the
// same bits on every run):
//   positions[g, t, r]   the rank, or capacity where rank >= capacity;
//   keep[g, t, r]        rank < capacity;
//   slot_tok[g, e, j]    the token of the claim ranked j on e for j < capacity,
//                        0 in the slots no claim fills; in the trash column
//                        (j = capacity) the token of the first dropped claim,
//                        0 where none was dropped;
//   counts[g, e]         all claims on e, before capacity (the balance loss's).
// An id outside [0, E) (top-k never gives one) is a dropped claim counted
// nowhere.
//
// What bounds it on an H100: neither bytes nor operations.  A call reads
// 8 B a claim and writes ~17 B a claim plus the slot table (1.3 MB at
// moonlight's shape: 0.4 us at 3.35 TB/s); what costs is the chain of ranks
// and the launch.  Design: tiles of kThreads * rounds claims, in claim
// order, one CTA each; warp w of a tile takes its 32 * rounds consecutive
// claims in rounds of 32, lanes in claim order.  In a round __match_any_sync
// groups the lanes on one expert: a lane's rank among them is the popcount
// of the lower lanes of its group, and the group's lowest lane adds the
// group's size to the warp's running count of that expert (shared memory).
//   route_count   each tile's per-warp counts [tiles, kWarps, E] and their
//                 sums [tiles, E] (int32 scratch the wrapper allocates);
//   route_assign  each tile sums the tiles before it (and all of them: the
//                 totals) and its own warps before each warp, then runs the
//                 same rounds again and writes each claim's outputs; the slot
//                 cells no claim writes are shared out among the tiles.
// The stream orders the two launches: no flag, atomic or zeroed memory.
// The wrapper picks rounds so that a call has at most ~32 tiles a group
// (ops.py::route_grid), so route_assign's sums stay short.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRounds = 16;     // ops.py's MAX_ROUNDS
constexpr int kMaxExperts = 1024;  // ops.py's MAX_EXPERTS: shared memory under 48 KB
constexpr unsigned kFull = 0xffffffffu;

struct Claims {
  const int64_t* idx;  // expert_idx [G, Tg, k], contiguous
  int Tg, k, E;
  int n;               // k * Tg claims a group
  int rounds;          // 32-claim rounds a warp
  int tiles;           // tiles a group
};

// The expert ids of this lane's claims, one a round; -1 past the group's
// claims and for an id outside [0, E).
__device__ __forceinline__ void load_ids(const Claims& a, int g, int chunk, int lane,
                                         int (&ids)[kMaxRounds]) {
#pragma unroll
  for (int q = 0; q < kMaxRounds; ++q) {
    ids[q] = -1;
    if (q < a.rounds) {
      const int c = chunk + q * 32 + lane;
      if (c < a.n) {
        const int r = c / a.Tg, t = c - r * a.Tg;
        const int64_t e = __ldg(a.idx + ((int64_t)g * a.Tg + t) * a.k + r);
        ids[q] = (e >= 0 && e < a.E) ? (int)e : -1;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) route_count(Claims a, int* __restrict__ warp_rows,
                                                        int* __restrict__ tile_rows) {
  extern __shared__ int cnt[];  // [kWarps][E]
  const int tile = blockIdx.x, g = blockIdx.y;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int ids[kMaxRounds];
  load_ids(a, g, (tile * kWarps + w) * a.rounds * 32, lane, ids);
  for (int i = threadIdx.x; i < kWarps * a.E; i += kThreads) cnt[i] = 0;
  __syncthreads();
  int* mine = cnt + w * a.E;
#pragma unroll
  for (int q = 0; q < kMaxRounds; ++q) {
    if (q < a.rounds) {  // the same on every lane
      const int e = ids[q];
      const unsigned same = __match_any_sync(kFull, e);
      if (e >= 0 && lane == __ffs(same) - 1) mine[e] += __popc(same);
      __syncwarp();
    }
  }
  __syncthreads();
  const int64_t tile_at = (int64_t)g * a.tiles + tile;
  for (int i = threadIdx.x; i < kWarps * a.E; i += kThreads)
    warp_rows[tile_at * kWarps * a.E + i] = cnt[i];
  for (int e = threadIdx.x; e < a.E; e += kThreads) {
    int s = 0;
    for (int v = 0; v < kWarps; ++v) s += cnt[v * a.E + e];
    tile_rows[tile_at * a.E + e] = s;
  }
}

__global__ void __launch_bounds__(kThreads) route_assign(
    Claims a, int capacity, const int* __restrict__ warp_rows, const int* __restrict__ tile_rows,
    int64_t* __restrict__ positions, uint8_t* __restrict__ keep, int64_t* __restrict__ slot_tok,
    int64_t* __restrict__ counts) {
  extern __shared__ int sm[];
  const int E = a.E;
  const int parts = E <= kThreads ? kThreads / E : 1;  // threads summing one expert's tiles
  int* base = sm;                       // [kWarps][E]: each warp's next rank on each expert
  int* total = base + kWarps * E;       // [E]
  int* part_before = total + E;         // [parts][E]
  int* part_all = part_before + parts * E;
  const int tile = blockIdx.x, g = blockIdx.y;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk = (tile * kWarps + w) * a.rounds * 32;
  int ids[kMaxRounds];
  load_ids(a, g, chunk, lane, ids);

  // the claims on each expert in the tiles before this one, and in all
  const int* rows = tile_rows + (int64_t)g * a.tiles * E;
  for (int i = threadIdx.x; i < parts * E; i += kThreads) {
    const int e = i % E;
    int before = 0, all = 0;
#pragma unroll 4
    for (int t = i / E; t < a.tiles; t += parts) {
      const int v = rows[(int64_t)t * E + e];
      all += v;
      before += t < tile ? v : 0;
    }
    part_before[i] = before;
    part_all[i] = all;
  }
  __syncthreads();
  const int* own = warp_rows + ((int64_t)g * a.tiles + tile) * kWarps * E;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    int before = 0, all = 0;
    for (int p = 0; p < parts; ++p) {
      before += part_before[p * E + e];
      all += part_all[p * E + e];
    }
    total[e] = all;
    for (int v = 0; v < kWarps; ++v) {
      base[v * E + e] = before;
      before += own[v * E + e];
    }
    if (tile == 0) counts[(int64_t)g * E + e] = all;
  }
  __syncthreads();

  // each claim's rank, in the rounds route_count ran
  int* run = base + w * E;
  const unsigned below = (1u << lane) - 1u;
  int64_t* table = slot_tok + (int64_t)g * E * (capacity + 1);
#pragma unroll
  for (int q = 0; q < kMaxRounds; ++q) {
    if (q < a.rounds) {
      const int c = chunk + q * 32 + lane;
      const int e = ids[q];
      const unsigned same = __match_any_sync(kFull, e);
      const int first = e >= 0 ? run[e] : 0;
      __syncwarp();  // every lane has read run[e] before its group's lowest lane adds
      if (c < a.n) {
        const int r = c / a.Tg, t = c - r * a.Tg;
        const int64_t at = ((int64_t)g * a.Tg + t) * a.k + r;
        const int rank = e >= 0 ? first + __popc(same & below) : capacity;
        positions[at] = rank < capacity ? rank : capacity;
        keep[at] = rank < capacity;
        if (e >= 0 && rank <= capacity) table[(int64_t)e * (capacity + 1) + rank] = t;
      }
      if (e >= 0 && lane == __ffs(same) - 1) run[e] = first + __popc(same);
      __syncwarp();
    }
  }

  // the slots no claim fills hold token 0, and so does the trash column
  // where no claim was dropped; the tiles share the table out
  const int64_t width = capacity + 1, cells = (int64_t)E * width;
  const int64_t per = (cells + a.tiles - 1) / a.tiles;
  const int64_t end = cells < (tile + 1) * per ? cells : (tile + 1) * per;
  for (int64_t i = tile * per + threadIdx.x; i < end; i += kThreads) {
    const int e = (int)(i / width);
    const int j = (int)(i - (int64_t)e * width);
    const int n = total[e];
    if (j < capacity ? j >= n : n <= capacity) table[i] = 0;
  }
}

}  // namespace

extern "C" int moe_route_max_experts() { return kMaxExperts; }
extern "C" int moe_route_max_rounds() { return kMaxRounds; }
extern "C" int moe_route_threads() { return kThreads; }

// expert_idx [G, Tg, k] int64 -> positions [G, Tg, k] int64, keep [G, Tg, k]
// bool, slot_tok [G, E, capacity + 1] int64, counts [G, E] int64, all
// contiguous on one card.  scratch: G * tiles * (kWarps + 1) * E int32,
// tiles = ceil(k * Tg / (kThreads * rounds)).  Two launches on `stream`;
// returns the first failing launch's cudaError_t.
extern "C" int moe_route_slots(const int64_t* expert_idx, int64_t* positions, uint8_t* keep,
                               int64_t* slot_tok, int64_t* counts, int* scratch, int G, int Tg,
                               int k, int E, int capacity, int rounds, void* stream) {
  if (G < 1 || G > 65535 || Tg < 1 || k < 1 || E < 1 || E > kMaxExperts || capacity < 0 ||
      rounds < 1 || rounds > kMaxRounds ||
      (int64_t)k * Tg > (int64_t)0x7fffffff - kThreads * kMaxRounds)
    return (int)cudaErrorInvalidValue;
  Claims a;
  a.idx = expert_idx;
  a.Tg = Tg;
  a.k = k;
  a.E = E;
  a.n = k * Tg;
  a.rounds = rounds;
  a.tiles = (a.n + kThreads * rounds - 1) / (kThreads * rounds);
  int* warp_rows = scratch;
  int* tile_rows = scratch + (int64_t)G * a.tiles * kWarps * E;
  const dim3 grid(a.tiles, G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  route_count<<<grid, kThreads, kWarps * E * sizeof(int), s>>>(a, warp_rows, tile_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int parts = E <= kThreads ? kThreads / E : 1;
  const size_t smem = (size_t)(kWarps * E + E + 2 * parts * E) * sizeof(int);
  route_assign<<<grid, kThreads, smem, s>>>(a, capacity, warp_rows, tile_rows, positions, keep,
                                            slot_tok, counts);
  return (int)cudaGetLastError();
}
