// Dense gather-sum for Hopper (sm_90a): split's aggregation through the
// dense [K, D] neighbour matrix, forward and backward, one launch each.
//
//   dense_gather_sum:   out[d, :] = sum over k = 0..K-1, in order, of
//                                   float(x[nbr[k, d], :])
//   dense_scatter_add:  dx[s, :]  = sum of g[d, :] over the slots (k, d)
//                                   with nbr[k, d] == s
//   dense_scatter_slots: the same with each slot's own row,
//                        rows[k * D + d] in place of g[d], and
//                        dx[S - 1] = 0 (padding slots' rows unread),
//                        through a plan the caller ships with nbr
//
// x is f32 or bf16 [S, H] row-major, and its last row S - 1 is the frame's
// reserved zero row that every padding slot names; nbr is int32 [K, D],
// k-major, row k at nbr + k * ld (ld >= D: a dst tile of a wider matrix
// is passed as a column slice); out and g are f32 [D, H], dx f32 [S, H].
// A slot's id is k * D + d.
//
// Replaces: occ_gnn_tpu/parallel/split.py:161-197 (local_aggregate_dense),
// its default unrolled branch at :191-197, which XLA compiles into one
// 26-way add fusion (no pallas_call), and the transpose of that gather
// that XLA derives for the backward. The per-slot mode sums the rows that
// GAT's attention backward (csrc/gat_attention.cu) writes a slot each.
//
// Bound: device-memory bytes. The forward reads K rows of x for each dst
// and writes one f32 row; the backward reads one g row for each dst and
// writes every row of dx once. One add an element read, far below the
// card's arithmetic rate, so the design is about bytes and loads in flight.
//
// Forward. A team of lanes for each dst row (a block stages its dst rows'
// K indices in shared memory with coalesced loads; an index outside
// [0, S) stops the kernel with a device-side assert, as
// torch.index_select does on the card, where JAX clamps it silently).
// Each lane keeps its columns' sums in f32 registers and adds the K rows in
// the order of k, from the first row on, so the result equals the plain
// version (the first gathered row in f32, then add_ of each later k) bit
// for bit, whatever the zero row holds. Padding slots load the zero row
// like any other: it stays in L1, and holding it in registers instead was
// measured slower (tools/dense_ab.py).
//   * f32 rows (H % 4 == 0, 16-byte aligned): one float4 a lane, kUnroll
//     rows in flight a lane, teams of H / 4 lanes packed into the block.
//   * bf16 rows, H % 4 == 0, a window of at most 256 B, D >=
//     kWordsMinRows: a row's 16-byte-aligned window (208 B at H = 100:
//     from 200 r, or from 200 r - 8 for odd r; only every other row
//     starts on 16 bytes) as one 16-byte word a lane,
//     an odd row realigned with one shuffle, so that lane j sums columns
//     8 j .. 8 j + 7: 13 loads a row where 8-byte loads take 25, and teams
//     of 16 lanes, two dst rows a warp. The window of an even row runs 8
//     bytes into the next row; the zero row is read in 8-byte halves.
//   * other bf16 rows of H % 4 == 0: 8-byte loads of 4 columns a lane.
//   * Any other width or alignment: one element a lane.
// Row offsets are 64-bit: row * H passes 2^31 on larger graphs.
//
// Backward: one cooperative launch, no memset, no atomics on rows, and
// the same bits from every launch. It transposes nbr into a plan in the
// caller's workspace and then writes every row of dx once, in phases
// separated by grid-wide barriers:
//   0. the per-row slot counts to zero;
//   1. each slot naming a row s < S - 1 takes a place in s's list (an
//      integer atomic on s's count, kBatch slots a thread in flight); the
//      zero row's first level: a warp for kZeroCols columns counts their
//      padding slots c_d (those naming S - 1) and sums c_d * g[d] in order;
//   2. the counts are scanned in fixed chunks, each into offsets within
//      its chunk and a chunk total; the zero row's second level (kZeroFan
//      partials each, in order); rows no slot names written as zeros;
//   3. every block scans the chunk totals into shared memory; each slot
//      is written into its row's list; the zero row's third level;
//   4. a warp for each kGroup rows copies their lists into shared memory,
//      sorts each by slot id (the fill's order is the atomics'), and sums
//      each row's g rows in slot order in f32 registers, kUnroll loads in
//      flight across row ends, writing each row once (a group of more than
//      kSpan slots row by row); a row of more than kSpan slots (listed in
//      phase 2) by a block, merge-sorted in global memory and summed in
//      kWarps contiguous parts, added in order; one warp sums the
//      third-level partials in order into dx[S - 1].
// The zero row's tree is fixed by D alone, the row sums by nbr alone, so
// two launches give the same bits. g (11.5 MB at split A's layer 1)
// stays in L2; dx is written with streaming stores. Each phase is a chain
// of dependent loads behind a barrier, about 17 us at the smallest layers
// (PERF.md); from split A's layer 1 up it is faster than atomics. One
// cluster of blocks a range of rows, building its plan in distributed
// shared memory with cluster barriers only, was measured slower
// (PERF.md).
//
// Per-slot scatter: one plain launch, no grid barrier, no sort, no
// workspace, no memset and no atomics. GAT's attention backward
// (csrc/gat_attention.cu) writes one row a valid slot; this sums them
// into dx. The transpose of nbr that the cooperative launch rebuilds on
// every call depends on nbr alone, and nbr is built on the host, so the
// host builds the plan beside it (the C++ sampling service, or the plain
// version ops/dense_gather_sum.slots_plan) and ships it with the batch:
//   offsets [S]   the exclusive scan of the slots naming each row s <
//                 S - 1; offsets[S - 1] is the valid slot count;
//   slots         each row's slot ids k * D + d in slot order, row s's at
//                 offsets[s] .. offsets[s + 1];
//   long_rows     the rows of more than `span` slots, *num_long of them.
// `span` is the plan's: its builders and this kernel take it from
// ops/dense_gather_sum.SPAN, so a row the warps skip is one the plan
// lists.
// A warp takes a run of `run` consecutive rows (static: warp w the run
// from w * run), lane i holding row i's first place and count. Its places
// (the slots of its rows, and one empty place for a row no slot names
// and for the zero row) are taken 32 at a time: lane j finds the row of
// place j by a binary search over the lanes' exclusive scan, and loads
// its slot id; then the warp streams them, lanes over the row's columns,
// kSlotUnroll rows in flight across row ends, each row's sum in f32 from
// its first slot's row, in slot order, written once with streaming
// stores.
// A row of more than `span` slots is skipped by its warp and summed by one
// of the first blocks of the grid in kWarps contiguous parts, added in
// order. The order of every sum is the cooperative launch's, so the bits
// are too, and the same from every launch. At H = 128 a lane holds one
// float4 (a warp a row); wider rows loop over 128-column tiles; any other
// width or alignment takes one element a lane. A run holds kRunTiles row
// tiles (8 rows at H = 128, 1 at H = 1024), fewer where the grid would
// have less than kFillWarps warps: rows hold about one slot each at split
// GAT A's layers 1-2, and the small layers would leave the card idle.
// Bound: each valid slot's row and what is read of the plan (offsets,
// the valid slots' ids, num_long and the listed long rows) read once,
// each dx row written once.

#include <assert.h>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // a block
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;     // row loads in flight a lane
// dst rows from which bf16 frames take 16-byte words (below: 8-byte loads,
// whose grid of 8 dst rows a block fills the card better).
constexpr long long kWordsMinRows = 8192;
constexpr unsigned kFull = 0xffffffffu;
// Shared memory a block may take without opting in to more.
constexpr size_t kSmemBytes = 48 * 1024;
// The backward's plan: counts a thread scans (at least), chunk totals a
// block keeps in shared memory (at most), slots a thread takes at a time;
// the zero row's tree: kZeroCols columns a first-level partial, kZeroFan
// partials a partial of each level above; rows a warp sums at a time, and
// their slots it sorts in shared memory at once (at most).
constexpr int kScanItems = 8;
constexpr int kMaxChunks = 8192;
constexpr int kBatch = 4;
constexpr int kZeroCols = 8;
constexpr int kZeroFan = 16;
constexpr int kGroup = 16;
constexpr int kSpan = 256;
// The per-slot scatter: row tiles of 128 columns a warp's run holds (at
// most), warps its grid keeps at the least (shorter runs below), row
// loads in flight a lane, and blocks for the long rows (at most). Each
// value was picked by timing its neighbours at split GAT A's layers 1-2,
// GAT P4-B's and the CLI's hidden width.
constexpr int kRunTiles = 8;
constexpr long long kFillWarps = 1536;
constexpr int kSlotUnroll = 6;
constexpr long long kLongBlocks = 128;

// Column groups: float4 sums of 4 columns, or one float.
__device__ __forceinline__ void add(float& acc, float v) { acc += v; }
__device__ __forceinline__ void add(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}
__device__ __forceinline__ void zero(float& v) { v = 0.f; }
__device__ __forceinline__ void zero(float4& v) {
  v = make_float4(0.f, 0.f, 0.f, 0.f);
}
// acc + m * v with two roundings (no contraction into an fma), as the
// zero row's model in the tests computes it.
__device__ __forceinline__ void add_times(float& acc, float m, float v) {
  acc = __fadd_rn(acc, __fmul_rn(m, v));
}
__device__ __forceinline__ void add_times(float4& acc, float m,
                                          const float4& v) {
  add_times(acc.x, m, v.x);
  add_times(acc.y, m, v.y);
  add_times(acc.z, m, v.z);
  add_times(acc.w, m, v.w);
}
__device__ __forceinline__ void store_streaming(float* p, float v) {
  __stcs(p, v);
}
__device__ __forceinline__ void store_streaming(float4* p, const float4& v) {
  __stcs(p, v);
}

__device__ __forceinline__ float2 bf16x2(uint32_t raw) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
}

// Load column group c of row r of a row-major [*, width groups] array as
// f32, for each input type and group size.
template <typename In, int VEC>
struct Rows;

template <>
struct Rows<float, 4> {
  using Acc = float4;
  static __device__ __forceinline__ float4 load(const float* x, long long r,
                                                int width, int c) {
    return __ldg(reinterpret_cast<const float4*>(x) + r * width + c);
  }
};

template <>
struct Rows<float, 1> {
  using Acc = float;
  static __device__ __forceinline__ float load(const float* x, long long r,
                                               int width, int c) {
    return __ldg(x + r * width + c);
  }
};

template <>
struct Rows<__nv_bfloat16, 4> {
  using Acc = float4;
  static __device__ __forceinline__ float4 load(const __nv_bfloat16* x,
                                                long long r, int width, int c) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(x) + r * width + c);
    const float2 lo = bf16x2(raw.x), hi = bf16x2(raw.y);
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
};

template <>
struct Rows<__nv_bfloat16, 1> {
  using Acc = float;
  static __device__ __forceinline__ float load(const __nv_bfloat16* x,
                                               long long r, int width, int c) {
    return __bfloat162float(x[r * width + c]);
  }
};

// The block's dst rows [d0, d0 + teams) and their K indices, staged k-major
// in s_nbr[k * teams + j]; columns past D get row 0 and are never used.
__device__ __forceinline__ void stage_indices(
    const int* __restrict__ nbr, long long ld, int K, long long D,
    long long x_rows, int teams, long long d0, int* s_nbr) {
  for (int i = threadIdx.x; i < K * teams; i += blockDim.x) {
    const int k = i / teams;
    const long long d = d0 + (i - k * teams);
    int r = 0;
    if (d < D) {
      r = __ldg(nbr + k * ld + d);
      assert(r >= 0 && r < x_rows);
    }
    s_nbr[i] = r;
  }
}

// f32 rows, or bf16 rows one element a lane: a team of lanes for each dst
// row, a lane for each column group.
template <typename In, int VEC>
__global__ void __launch_bounds__(kThreads)
gather_sum(const In* __restrict__ x, long long x_rows,
           const int* __restrict__ nbr, long long ld, int K, long long D,
           int width, int team_threads, int teams,
           typename Rows<In, VEC>::Acc* __restrict__ out) {
  using Acc = typename Rows<In, VEC>::Acc;
  extern __shared__ int s_nbr[];
  const long long d0 = static_cast<long long>(blockIdx.x) * teams;
  stage_indices(nbr, ld, K, D, x_rows, teams, d0, s_nbr);
  __syncthreads();
  const int team = threadIdx.x / team_threads;
  const int col0 = threadIdx.x - team * team_threads;
  const long long d = d0 + team;
  if (team >= teams || d >= D) return;
  const int* idx = s_nbr + team;  // idx[k * teams]
  for (int c = col0; c < width; c += team_threads) {
    Acc acc = Rows<In, VEC>::load(x, idx[0], width, c);
    for (int k0 = 1; k0 < K; k0 += kUnroll) {
      Acc v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (k0 + u < K) {
          v[u] = Rows<In, VEC>::load(x, idx[(k0 + u) * teams], width, c);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (k0 + u < K) add(acc, v[u]);
      }
    }
    out[d * width + c] = acc;
  }
}

// Eight bf16 of a 16-byte word as f32, added into acc[0..7].
__device__ __forceinline__ void add8(float (&acc)[8], const uint4& w) {
  const float2 a = bf16x2(w.x), b = bf16x2(w.y), c = bf16x2(w.z),
               e = bf16x2(w.w);
  acc[0] += a.x;
  acc[1] += a.y;
  acc[2] += b.x;
  acc[3] += b.y;
  acc[4] += c.x;
  acc[5] += c.y;
  acc[6] += e.x;
  acc[7] += e.y;
}

__device__ __forceinline__ void set8(float (&acc)[8], const uint4& w) {
  const float2 a = bf16x2(w.x), b = bf16x2(w.y), c = bf16x2(w.z),
               e = bf16x2(w.w);
  acc[0] = a.x;
  acc[1] = a.y;
  acc[2] = b.x;
  acc[3] = b.y;
  acc[4] = c.x;
  acc[5] = c.y;
  acc[6] = e.x;
  acc[7] = e.y;
}

// bf16 rows of H % 4 == 0 whose aligned window is at most 256 bytes, x
// 16-byte aligned: a team of kLanes lanes for each dst row, two a warp,
// lane j summing columns 8 j .. 8 j + 7 (lanes of 8 j >= H idle). Row r's bytes
// start at 2 H r; lane j loads the 16-byte word j of the aligned window at
// 2 H r - off (off = 2 H r mod 16, 0 or 8), and for off == 8 takes its
// upper half and the next lane's lower half. The zero row is read in
// 8-byte halves (its window could pass the end of x).
constexpr int kLanes = 16;

__global__ void __launch_bounds__(kThreads)
gather_sum_bf16(const __nv_bfloat16* __restrict__ x, long long x_rows, int h,
                const int* __restrict__ nbr, long long ld, int K, long long D,
                float* __restrict__ out) {
  constexpr int kTeams = kThreads / kLanes;
  extern __shared__ int s_nbr[];
  const long long d0 = static_cast<long long>(blockIdx.x) * kTeams;
  stage_indices(nbr, ld, K, D, x_rows, kTeams, d0, s_nbr);
  __syncthreads();
  const int team = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const long long d = d0 + team;
  // Both teams of a warp stay to the end: the shuffles take every lane.
  const bool real = d < D;
  if (__all_sync(kFull, !real)) return;
  const int* idx = s_nbr + team;  // idx[k * kTeams]
  const long long zero_row = x_rows - 1;
  const long long row_bytes = 2LL * h;
  const int cols = h - 8 * lane;  // this lane's columns: min(cols, 8)
  const char* base = reinterpret_cast<const char*>(x);
  // Lanes that load a word of the window: 2 H / 16, or (2 H + 8) / 16.
  const bool loads =
      16 * lane < (row_bytes % 16 ? row_bytes + 8 : row_bytes);
  // Lane j's 16-byte word of row r's window, or its columns of the zero
  // row in two 8-byte halves.
  auto word = [&](int r) {
    uint4 w = make_uint4(0, 0, 0, 0);
    if (r == zero_row) {
      if (cols > 0) {
        const uint2* zr = reinterpret_cast<const uint2*>(
            base + zero_row * row_bytes + 16 * lane);
        const uint2 lo = __ldg(zr);
        const uint2 hi = cols > 4 ? __ldg(zr + 1) : make_uint2(0, 0);
        w = make_uint4(lo.x, lo.y, hi.x, hi.y);
      }
    } else if (loads) {
      const long long start = r * row_bytes;
      w = __ldg(reinterpret_cast<const uint4*>(base + (start & ~15LL)) +
                lane);
    }
    return w;
  };
  // The 16 bytes of row r that lane j sums, from every lane's word w.
  auto realign = [&](int r, const uint4& w) {
    const uint32_t nx = __shfl_down_sync(kFull, w.x, 1, kLanes);
    const uint32_t ny = __shfl_down_sync(kFull, w.y, 1, kLanes);
    const bool shift = r != zero_row && (r * row_bytes) & 15;
    return shift ? make_uint4(w.z, w.w, nx, ny) : w;
  };
  float acc[8];
  const int r0 = real ? idx[0] : static_cast<int>(zero_row);
  set8(acc, realign(r0, word(r0)));
  for (int k0 = 1; k0 < K; k0 += kUnroll) {
    int r[kUnroll];
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      r[u] = real && k0 + u < K ? idx[(k0 + u) * kTeams]
                                : static_cast<int>(zero_row);
      if (k0 + u < K) w[u] = word(r[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u < K) add8(acc, realign(r[u], w[u]));
    }
  }
  if (real && cols > 0) {
    float4* o = reinterpret_cast<float4*>(out + d * h + 8 * lane);
    o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    if (cols > 4) o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

// ---------------------------------------------------------------- backward


// The backward's plan in the caller's workspace (int32 unless noted).
struct Plan {
  int* counts;     // [S - 1] slots naming each row
  int* local;      // [S - 1] exclusive scan of counts within its chunk
  int* totals;     // [chunks] each chunk's sum
  int* rank;       // [K * D] a slot's place in its row's list; then the
                   // merge sort's second buffer for rows of more than
                   // kSpan slots
  int* list;       // [K * D] slot ids by row
  int* longs;      // [K * D / (kSpan + 1) + 1] the rows of more than kSpan
                   // slots, in any order
  int* n_long;     // [1] their number
  float* zero[3];  // [nz[i], H] the zero row's partials, level by level
  int nz[3];
  int chunk;       // counts a chunk (kThreads * items)
  int items;       // counts a thread of a chunk
  int chunks;
};

struct Layout {
  Plan plan;
  size_t bytes;
};

size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Where each array of the plan lies in a workspace at `base` (nullptr to
// size it), for K slots a column, D columns, S rows of h floats.
Layout layout(int K, long long D, long long S, int h, char* base) {
  Layout out;
  Plan& p = out.plan;
  const long long rows = S - 1;
  p.items = kScanItems;
  while (static_cast<long long>(kMaxChunks) * kThreads * p.items < rows) {
    p.items *= 2;
  }
  p.chunk = kThreads * p.items;
  p.chunks = static_cast<int>((rows + p.chunk - 1) / p.chunk);
  p.nz[0] = static_cast<int>((D + kZeroCols - 1) / kZeroCols);
  p.nz[1] = (p.nz[0] + kZeroFan - 1) / kZeroFan;
  p.nz[2] = (p.nz[1] + kZeroFan - 1) / kZeroFan;
  const long long slots = static_cast<long long>(K) * D;
  size_t at = 0;
  auto take = [&](size_t bytes) {
    char* ptr = base ? base + at : nullptr;
    at += align16(bytes);
    return ptr;
  };
  p.counts = reinterpret_cast<int*>(take(sizeof(int) * rows));
  p.local = reinterpret_cast<int*>(take(sizeof(int) * rows));
  p.totals = reinterpret_cast<int*>(take(sizeof(int) * p.chunks));
  p.rank = reinterpret_cast<int*>(take(sizeof(int) * slots));
  p.list = reinterpret_cast<int*>(take(sizeof(int) * slots));
  p.longs =
      reinterpret_cast<int*>(take(sizeof(int) * (slots / (kSpan + 1) + 1)));
  p.n_long = reinterpret_cast<int*>(take(sizeof(int)));
  for (int i = 0; i < 3; ++i) {
    p.zero[i] = reinterpret_cast<float*>(take(sizeof(float) * p.nz[i] * h));
  }
  out.bytes = at;
  return out;
}

// Exclusive scan of one value a thread across the block; returns the
// block's total in *total. Uses s_warp[kWarps]; ends synchronised.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp,
                                                    int* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = s_warp[w];
    if (w < warp) before += t;
    sum += t;
  }
  __syncthreads();
  *total = sum;
  return before + incl - v;
}

// One level of the zero row's tree, by warp `j` of `warps`: partial i of
// `out` is the sum, in order from 0, of the `fan` rows of f32 [*, width]
// `src` from row i * fan on (of n in all), for column group c.
template <typename Acc>
__device__ __forceinline__ void zero_level(const Acc* src, long long n,
                                           int fan, Acc* out, long long j,
                                           long long warps, int width) {
  const int lane = threadIdx.x % 32;
  for (long long i = j; i * fan < n; i += warps) {
    const long long first = i * fan;
    const int m = static_cast<int>(n - first < fan ? n - first : fan);
    for (int c = lane; c < width; c += 32) {
      Acc acc;
      zero(acc);
      for (int t0 = 0; t0 < m; t0 += kZeroFan) {
        Acc v[kZeroFan];
#pragma unroll
        for (int u = 0; u < kZeroFan; ++u) {
          if (t0 + u < m) v[u] = src[(first + t0 + u) * width + c];
        }
#pragma unroll
        for (int u = 0; u < kZeroFan; ++u) {
          if (t0 + u < m) add(acc, v[u]);
        }
      }
      out[i * width + c] = acc;
    }
  }
}

// Metadata of a slot at place t of a span: its output row and whether it
// is its row's first or last.
constexpr int kFirst = 1 << 8, kLast = 1 << 9;

// The rows of one span of the lists, by one warp: at place t < span, d[t]
// is the g row of a slot and meta[t] its output row (a row's slots
// consecutive and in slot order) with kFirst / kLast. Sums each row's g
// rows in that order, in f32 from its first, and writes it to out + row *
// width: kUnroll loads in flight across row ends.
template <typename Acc>
__device__ __forceinline__ void stream_span(const int* d, const int* meta,
                                            int span,
                                            const Acc* __restrict__ g,
                                            int width, Acc* out) {
  const int lane = threadIdx.x % 32;
  for (int c = lane; c < width; c += 32) {
    Acc acc;
    zero(acc);
    for (int t0 = 0; t0 < span; t0 += kUnroll) {
      Acc v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (t0 + u < span) {
          v[u] = __ldg(g + static_cast<long long>(d[t0 + u]) * width + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (t0 + u < span) {
          const int m = meta[t0 + u];
          if (m & kFirst) {
            acc = v[u];
          } else {
            add(acc, v[u]);
          }
          if (m & kLast) store_streaming(out + (m & 0xff) * width + c, acc);
        }
      }
    }
  }
  __syncwarp();  // the shared arrays are the next span's
}

// One span of the lists by one warp: `rows` rows, row i's slots at
// [row_at[i], row_at[i + 1]) of list[0 .. span) (row_at[rows] == span),
// copied into shared memory, each row's sorted by slot id (a slot's place
// is its rank among its row's), then streamed. span <= kSpan.
template <typename Acc>
__device__ __forceinline__ void sum_span(const int* list, int span, int rows,
                                         const int* row_at, int* ent,
                                         int* d_at, int* meta,
                                         const Acc* __restrict__ g, int mod,
                                         int width, Acc* out) {
  const int lane = threadIdx.x % 32;
  for (int q = lane; q < span; q += 32) ent[q] = list[q];
  __syncwarp();
  for (int q = lane; q < span; q += 32) {
    // The row of place q: the last whose start is at most q.
    int lo = 0, hi = rows;
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (row_at[mid] <= q) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    const int a = row_at[lo], b = row_at[lo + 1];
    const int slot = ent[q];
    int r = 0;
    for (int j = a; j < b; ++j) r += ent[j] < slot;
    d_at[a + r] = slot % mod;
    meta[a + r] = lo | (r == 0 ? kFirst : 0) | (a + r == b - 1 ? kLast : 0);
  }
  __syncwarp();
  stream_span(d_at, meta, span, g, width, out);
}

// A row of n > kSpan slots by the whole block: its list at a (in the
// fill's order), b a second buffer as long. Runs of kSpan are sorted in
// shared memory (a slot's place is its rank among its run's; warp w
// takes runs w, w + kWarps, ...) from a into b, then merged pairwise
// between b and a, a slot's place in the merged run its place in its own
// plus the count of the other run's slots below it (a binary search):
// O(n log^2 n) loads, spread over the block. Then sum_in_parts. A slot's
// g row is its id modulo `mod`.
template <typename Acc>
__device__ __forceinline__ void sum_in_parts(const int* list, int n,
                                             const Acc* __restrict__ g,
                                             int mod, int width, Acc* out,
                                             Acc* part);

template <typename Acc>
__device__ __forceinline__ void sum_long_row(int* a, int* b, int n,
                                             const Acc* __restrict__ g,
                                             int mod, int width, Acc* out,
                                             int (*ent)[kSpan], Acc* part) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r0 = warp * kSpan; r0 < n; r0 += kWarps * kSpan) {
    const int m = n - r0 < kSpan ? n - r0 : kSpan;
    int* e = ent[warp];
    for (int q = lane; q < m; q += 32) e[q] = a[r0 + q];
    __syncwarp();
    for (int q = lane; q < m; q += 32) {
      const int slot = e[q];
      int r = 0;
      for (int j = 0; j < m; ++j) r += e[j] < slot;
      b[r0 + r] = slot;
    }
    __syncwarp();
  }
  __syncthreads();
  int* src = b;
  int* dst = a;
  for (int w = kSpan; w < n; w *= 2) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int run = i / w;
      const int mine = run * w, other = (run ^ 1) * w;
      const int slot = src[i];
      // The other run's slots below this one: lo of them.
      const int end = other + w < n ? other + w : n;
      int lo = 0, hi = other < n ? end - other : 0;
      while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (src[other + mid] < slot) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      dst[(mine < other ? mine : other) + (i - mine) + lo] = slot;
    }
    __syncthreads();
    int* t = src;
    src = dst;
    dst = t;
  }
  sum_in_parts(src, n, g, mod, width, out, part);
}

// A row's n >= kWarps slots, listed in slot order, by the whole block:
// warp w sums places [w n / kWarps, (w + 1) n / kWarps) of the list in
// f32 from its first, and the kWarps partials are added in order into
// out. `part` holds kWarps * 32 column groups in shared memory.
template <typename Acc>
__device__ __forceinline__ void sum_in_parts(const int* list, int n,
                                             const Acc* __restrict__ g,
                                             int mod, int width, Acc* out,
                                             Acc* part) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int t0 = static_cast<int>(static_cast<long long>(warp) * n / kWarps);
  const int t1 =
      static_cast<int>(static_cast<long long>(warp + 1) * n / kWarps);
  for (int c0 = 0; c0 < width; c0 += 32) {
    const int c = c0 + lane;
    if (c < width) {
      Acc acc =
          __ldg(g + static_cast<long long>(list[t0] % mod) * width + c);
      for (int t = t0 + 1; t < t1; t += kUnroll) {
        Acc v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (t + u < t1) {
            v[u] = __ldg(g + static_cast<long long>(list[t + u] % mod) *
                                 width + c);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (t + u < t1) add(acc, v[u]);
        }
      }
      part[warp * 32 + lane] = acc;
    }
    __syncthreads();
    if (warp == 0 && c < width) {
      Acc acc = part[lane];
      for (int w = 1; w < kWarps; ++w) add(acc, part[w * 32 + lane]);
      store_streaming(out + c, acc);
    }
    __syncthreads();
  }
}

template <typename Acc>
__global__ void __launch_bounds__(kThreads)
scatter_rows(const Acc* __restrict__ g, const int* __restrict__ nbr, int K,
             int D, int S, int width, Plan p, Acc* __restrict__ dx) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int s_base[];  // [p.chunks] each chunk's first offset
  __shared__ int s_warp[kWarps];
  // Each warp's span of the lists: as filled, then each place's g row and
  // metadata; and its rows' starts.
  __shared__ int s_ent[kWarps][kSpan];
  __shared__ __align__(16) int s_d[kWarps][kSpan];
  __shared__ int s_meta[kWarps][kSpan];
  __shared__ int s_row[kWarps][kGroup + 1];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  const long long gwarp = tid / 32, warps = threads / 32;
  const int zero_row = S - 1;
  const long long slots = static_cast<long long>(K) * D;
  // A slot id modulo D is its g row.
  const int mod = D;

  // 0. Counts to zero.
  for (long long s = tid; s < zero_row; s += threads) p.counts[s] = 0;
  if (tid == 0) *p.n_long = 0;
  grid.sync();

  // 1. Each slot's place in its row's list (kBatch slots a thread at a
  // time, their loads and atomics in flight together).
  for (long long i0 = tid; i0 < slots; i0 += threads * kBatch) {
    int r[kBatch], q[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long i = i0 + u * threads;
      r[u] = i < slots ? __ldg(nbr + i) : zero_row;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      assert(r[u] >= 0 && r[u] < S);
      if (r[u] != zero_row) q[u] = atomicAdd(p.counts + r[u], 1);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (r[u] != zero_row) p.rank[i0 + u * threads] = q[u];
    }
  }
  // The zero row's first level, from the last warp down (the slots above
  // start from the first thread): a warp for kZeroCols consecutive columns,
  // lane j counting column d0 + j's padding slots c_d, then c_d * g[d]
  // summed over the columns in order.
  for (long long j = warps - 1 - gwarp; j < p.nz[0]; j += warps) {
    const long long d0 = j * kZeroCols;
    const int n = static_cast<int>(D - d0 < kZeroCols ? D - d0 : kZeroCols);
    int c = 0;
    for (int k0 = 0; k0 < K; k0 += 2 * kUnroll) {
      int v[2 * kUnroll];
#pragma unroll
      for (int u = 0; u < 2 * kUnroll; ++u) {
        v[u] = k0 + u < K && lane < n ? __ldg(nbr + (k0 + u) * D + d0 + lane)
                                      : 0;
      }
#pragma unroll
      for (int u = 0; u < 2 * kUnroll; ++u) {
        c += k0 + u < K && lane < n && v[u] == zero_row;
      }
    }
    float m[kZeroCols];
#pragma unroll
    for (int u = 0; u < kZeroCols; ++u) {
      m[u] = static_cast<float>(__shfl_sync(kFull, c, u));
    }
    Acc* out = reinterpret_cast<Acc*>(p.zero[0]) + j * width;
    for (int col = lane; col < width; col += 32) {
      Acc v[kZeroCols], acc;
      zero(acc);
#pragma unroll
      for (int u = 0; u < kZeroCols; ++u) {
        if (u < n && m[u] != 0.f) v[u] = __ldg(g + (d0 + u) * width + col);
      }
#pragma unroll
      for (int u = 0; u < kZeroCols; ++u) {
        if (u < n && m[u] != 0.f) add_times(acc, m[u], v[u]);
      }
      out[col] = acc;
    }
  }
  grid.sync();

  // 2. Chunk scans of the counts (the first blocks), which also list the
  // rows of more than kSpan slots; the zero row's second
  // level and the rows no slot names written as zeros (the warps of the
  // other blocks, or of all when there are no others).
  const long long scanning =
      kWarps * static_cast<long long>(p.chunks < gridDim.x ? p.chunks
                                                             : gridDim.x);
  const long long helper = warps > scanning ? gwarp - scanning : gwarp;
  const long long helpers = warps > scanning ? warps - scanning : warps;
  for (int c = blockIdx.x; c < p.chunks; c += gridDim.x) {
    const long long first =
        static_cast<long long>(c) * p.chunk +
        static_cast<long long>(threadIdx.x) * p.items;
    int sum = 0;
    for (int i0 = 0; i0 < p.items; i0 += kScanItems) {
      int v[kScanItems];
#pragma unroll
      for (int u = 0; u < kScanItems; ++u) {
        v[u] = first + i0 + u < zero_row ? p.counts[first + i0 + u] : 0;
      }
#pragma unroll
      for (int u = 0; u < kScanItems; ++u) sum += v[u];
    }
    int total;
    int run = block_exclusive_scan(sum, s_warp, &total);
    for (int i0 = 0; i0 < p.items; i0 += kScanItems) {
      int v[kScanItems];
#pragma unroll
      for (int u = 0; u < kScanItems; ++u) {
        v[u] = first + i0 + u < zero_row ? p.counts[first + i0 + u] : 0;
      }
#pragma unroll
      for (int u = 0; u < kScanItems; ++u) {
        if (first + i0 + u < zero_row) p.local[first + i0 + u] = run;
        if (v[u] > kSpan) {
          p.longs[atomicAdd(p.n_long, 1)] = static_cast<int>(first + i0 + u);
        }
        run += v[u];
      }
    }
    if (threadIdx.x == 0) p.totals[c] = total;
  }
  if (helper >= 0) {
    zero_level(reinterpret_cast<const Acc*>(p.zero[0]), p.nz[0], kZeroFan,
               reinterpret_cast<Acc*>(p.zero[1]), helper, helpers, width);
    Acc z;
    zero(z);
    for (long long s0 = helper * 32; s0 < zero_row; s0 += helpers * 32) {
      const long long mine = s0 + lane;
      unsigned empty =
          __ballot_sync(kFull, mine < zero_row && p.counts[mine] == 0);
      while (empty) {
        const int b = __ffs(empty) - 1;
        empty &= empty - 1;
        Acc* o = dx + (s0 + b) * width;
        for (int c = lane; c < width; c += 32) store_streaming(o + c, z);
      }
    }
  }
  grid.sync();

  // 3. Chunk bases (every block); the zero row's third level; the lists.
  {
    const int per = (p.chunks + kThreads - 1) / kThreads;
    const int first = threadIdx.x * per;
    int sum = 0;
    for (int i = 0; i < per; ++i) {
      if (first + i < p.chunks) sum += p.totals[first + i];
    }
    int total;
    int run = block_exclusive_scan(sum, s_warp, &total);
    for (int i = 0; i < per; ++i) {
      if (first + i < p.chunks) {
        s_base[first + i] = run;
        run += p.totals[first + i];
      }
    }
    __syncthreads();
  }
  zero_level(reinterpret_cast<const Acc*>(p.zero[1]), p.nz[1], kZeroFan,
             reinterpret_cast<Acc*>(p.zero[2]), warps - 1 - gwarp, warps,
             width);
  for (long long i0 = tid; i0 < slots; i0 += threads * kBatch) {
    int r[kBatch], at[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long i = i0 + u * threads;
      r[u] = i < slots ? __ldg(nbr + i) : zero_row;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (r[u] != zero_row) {
        at[u] = p.local[r[u]] + p.rank[i0 + u * threads];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (r[u] != zero_row) {
        p.list[at[u] + s_base[r[u] / p.chunk]] =
            static_cast<int>(i0 + u * threads);
      }
    }
  }
  grid.sync();

  // 4. Rows of more than kSpan slots: a block each. The zero row: the last
  // level, by the last warp. Every other row: a warp takes kGroup rows at
  // a time, lane i < kGroup reading row s0 + i's count and offset; their
  // slots lie in one span of the lists, which the warp sorts row by row in
  // shared memory and then streams (empty rows, written in phase 2, have
  // no slot in it).
  const int n_long = *p.n_long;
  for (int i = blockIdx.x; i < n_long; i += gridDim.x) {
    const int s = p.longs[i];
    const int at = p.local[s] + s_base[s / p.chunk];
    sum_long_row(p.list + at, p.rank + at, p.counts[s], g, mod, width,
                 dx + static_cast<long long>(s) * width, s_ent,
                 reinterpret_cast<Acc*>(&s_d[0][0]));
  }
  if (gwarp == warps - 1) {
    const Acc* src = reinterpret_cast<const Acc*>(p.zero[2]);
    for (int c = lane; c < width; c += 32) {
      Acc acc;
      zero(acc);
      for (int t = 0; t < p.nz[2]; ++t) {
        add(acc, src[t * width + c]);
      }
      store_streaming(dx + static_cast<long long>(zero_row) * width + c, acc);
    }
  }
  for (long long s0 = gwarp * kGroup; s0 < zero_row;
       s0 += warps * kGroup) {
    const long long mine = s0 + lane;
    const bool real = lane < kGroup && mine < zero_row;
    const int n = real ? p.counts[mine] : 0;
    const int start = real ? p.local[mine] + s_base[mine / p.chunk] : 0;
    const int rows = static_cast<int>(
        zero_row - s0 < kGroup ? zero_row - s0 : kGroup);
    const int first = __shfl_sync(kFull, start, 0);
    const int span = __shfl_sync(kFull, start + n, rows - 1) - first;
    if (span <= kSpan) {
      // Row i's slots at [row_at[i], row_at[i + 1]) of the span.
      if (lane < kGroup) s_row[warp][lane] = real ? start - first : span;
      if (lane == 0) s_row[warp][kGroup] = span;
      sum_span(p.list + first, span, kGroup, s_row[warp], s_ent[warp],
               s_d[warp], s_meta[warp], g, mod, width, dx + s0 * width);
      continue;
    }
    // A span too long for shared memory: row by row.
    unsigned left = __ballot_sync(kFull, n > 0);
    while (left) {
      const int b = __ffs(left) - 1;
      left &= left - 1;
      const int rn = __shfl_sync(kFull, n, b);
      const int roff = __shfl_sync(kFull, start, b);
      if (rn > kSpan) continue;  // a block's, above
      if (lane == 0) {
        s_row[warp][0] = 0;
        s_row[warp][1] = rn;
      }
      sum_span(p.list + roff, rn, 1, s_row[warp], s_ent[warp], s_d[warp],
               s_meta[warp], g, mod, width, dx + (s0 + b) * width);
    }
  }
}

// The per-slot scatter through the host's plan (see the top of the file):
// the first `long_blocks` blocks sum the listed long rows (those of
// more than `span` slots), a block a row at a time; every other warp
// takes its run of rows. A slot id is its row of `rows` (num_slots of
// them).
template <typename Acc>
__global__ void __launch_bounds__(kThreads)
scatter_slots(const Acc* __restrict__ rows, long long num_slots,
              const int* __restrict__ offsets, const int* __restrict__ slots,
              const int* __restrict__ long_rows,
              const int* __restrict__ num_long, int span, int S, int width,
              int run, int long_blocks, Acc* __restrict__ dx) {
  __shared__ __align__(16) char s_part[kWarps * 32 * sizeof(Acc)];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (static_cast<int>(blockIdx.x) < long_blocks) {
    const int n_long = __ldg(num_long);
    for (int i = blockIdx.x; i < n_long; i += long_blocks) {
      const int s = __ldg(long_rows + i);
      assert(s >= 0 && s < S - 1);
      const int a = __ldg(offsets + s);
      sum_in_parts(slots + a, __ldg(offsets + s + 1) - a, rows, 0x7fffffff,
                   width, dx + static_cast<long long>(s) * width,
                   reinterpret_cast<Acc*>(s_part));
    }
    return;
  }
  const long long s0 =
      (static_cast<long long>(blockIdx.x - long_blocks) * kWarps + warp) *
      run;
  if (s0 >= S) return;  // the whole warp
  // Lane i: row s0 + i's first place in `slots` (-1: an empty place) and
  // its count of places; 0 for a long row and past the run or the frame.
  const long long s = s0 + lane;
  int first = -1, count = 0;
  if (lane < run && s < S - 1) {
    const int a = __ldg(offsets + s), n = __ldg(offsets + s + 1) - a;
    if (n > 0) first = a;
    count = n == 0 ? 1 : (n > span ? 0 : n);
  } else if (lane < run && s == S - 1) {
    count = 1;  // the zero row, written as zeros
  }
  int incl = count;
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  const int pos = incl - count;  // the row's first place in the warp's
  const int total = __shfl_sync(kFull, incl, 31);
  for (int c0 = 0; c0 < width; c0 += 32) {
    const int c = c0 + lane;
    Acc acc;
    zero(acc);
    for (int t0 = 0; t0 < total; t0 += 32) {
      // Place t: its row r (the last lane whose first place is at most t:
      // one with places, as a lane without shares its successor's), its
      // slot and whether it is its row's first or last.
      const int t = t0 + lane;
      int r = 0;
#pragma unroll
      for (int step = 16; step > 0; step /= 2) {
        if (__shfl_sync(kFull, pos, r + step) <= t) r += step;
      }
      const int r_pos = __shfl_sync(kFull, pos, r);
      const int r_first = __shfl_sync(kFull, first, r);
      const int r_count = __shfl_sync(kFull, count, r);
      int slot = -1, meta = 0;
      if (t < total) {
        const int j = t - r_pos;
        if (r_first >= 0) {
          slot = __ldg(slots + r_first + j);
          assert(slot >= 0 && slot < num_slots);
        }
        meta = r | (j == 0 ? kFirst : 0) | (j == r_count - 1 ? kLast : 0);
      }
      const int places = total - t0 < 32 ? total - t0 : 32;
      for (int u0 = 0; u0 < places; u0 += kSlotUnroll) {
        Acc v[kSlotUnroll];
        int m[kSlotUnroll];
#pragma unroll
        for (int u = 0; u < kSlotUnroll; ++u) {
          const int q = u0 + u;
          const int sl = __shfl_sync(kFull, slot, q & 31);
          m[u] = __shfl_sync(kFull, meta, q & 31);
          zero(v[u]);
          if (q < places && sl >= 0 && c < width) {
            v[u] = __ldg(rows + static_cast<long long>(sl) * width + c);
          }
        }
#pragma unroll
        for (int u = 0; u < kSlotUnroll; ++u) {
          if (u0 + u < places) {
            if (m[u] & kFirst) {
              acc = v[u];
            } else {
              add(acc, v[u]);
            }
            if ((m[u] & kLast) && c < width) {
              store_streaming(dx + (s0 + (m[u] & 0xff)) * width + c, acc);
            }
          }
        }
      }
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// A block's teams and threads for rows of `width` column groups, with K
// indices a dst staged in shared memory; 0 teams when even one dst's
// indices do not fit.
struct Geometry {
  int team_threads, teams, threads;
  size_t smem;
};

Geometry geometry(int width, int K) {
  Geometry geo;
  geo.team_threads = width < kThreads ? width : kThreads;
  geo.teams = kThreads / geo.team_threads;
  const long long fit =
      static_cast<long long>(kSmemBytes / (sizeof(int) * K));
  if (fit < geo.teams) geo.teams = static_cast<int>(fit);
  geo.threads = (geo.teams * geo.team_threads + 31) / 32 * 32;
  geo.smem = sizeof(int) * K * geo.teams;
  return geo;
}

template <typename In, int VEC>
cudaError_t launch_gather(const void* x, long long x_rows, int h,
                          const void* nbr, long long ld, int K, long long D,
                          void* out, cudaStream_t stream) {
  using Acc = typename Rows<In, VEC>::Acc;
  const int width = h / VEC;
  const Geometry geo = geometry(width, K);
  if (geo.teams < 1) return cudaErrorInvalidValue;
  const long long blocks = (D + geo.teams - 1) / geo.teams;
  gather_sum<In, VEC><<<static_cast<unsigned>(blocks), geo.threads, geo.smem,
                        stream>>>(
      static_cast<const In*>(x), x_rows, static_cast<const int*>(nbr), ld, K,
      D, width, geo.team_threads, geo.teams, static_cast<Acc*>(out));
  return cudaGetLastError();
}

cudaError_t launch_gather_bf16(const void* x, long long x_rows, int h,
                               const void* nbr, long long ld, int K,
                               long long D, void* out, cudaStream_t stream) {
  constexpr int kTeams = kThreads / kLanes;
  const size_t smem = sizeof(int) * K * kTeams;
  if (smem > kSmemBytes) return cudaErrorInvalidValue;
  const long long blocks = (D + kTeams - 1) / kTeams;
  gather_sum_bf16<<<static_cast<unsigned>(blocks), kThreads, smem,
                    stream>>>(
      static_cast<const __nv_bfloat16*>(x), x_rows, h,
      static_cast<const int*>(nbr), ld, K, D, static_cast<float*>(out));
  return cudaGetLastError();
}

// The cooperative grid of scatter_rows<Acc> with `smem` bytes of dynamic
// shared memory: as many blocks as fit on the card at once, and no more
// than the work asks for. The card's answer is kept for each device and
// size, so a launch queries nothing; the kernel's dynamic shared memory
// limit is raised (never lowered) to the largest size asked for.
template <typename Acc>
cudaError_t scatter_grid(int device, size_t smem, long long work,
                         int* blocks) {
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, long long> most_blocks;
  static std::map<int, size_t> smem_limit;
  std::lock_guard<std::mutex> lock(mu);
  auto it = most_blocks.find({device, smem});
  if (it == most_blocks.end()) {
    auto kernel = scatter_rows<Acc>;
    cudaError_t err;
    if (smem > smem_limit[device]) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      smem_limit[device] = smem;
    }
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    it = most_blocks.emplace(std::make_pair(device, smem),
                             static_cast<long long>(per_sm) * sms).first;
  }
  const long long need = (work + kThreads - 1) / kThreads;
  *blocks = static_cast<int>(need < it->second ? (need < 1 ? 1 : need)
                                               : it->second);
  return cudaSuccess;
}

template <int VEC>
cudaError_t launch_scatter(const void* g, const void* nbr, long long ld,
                           int K, long long D, int h, long long x_rows,
                           void* dx, void* workspace, int device,
                           cudaStream_t stream) {
  using Acc = typename Rows<float, VEC>::Acc;
  int width = h / VEC;
  Plan plan = layout(K, D, x_rows, h, static_cast<char*>(workspace)).plan;
  const size_t smem = sizeof(int) * plan.chunks;
  const long long slots = static_cast<long long>(K) * D;
  // Every phase strides over its work: kBatch slots a thread, or kGroup
  // rows a warp.
  const long long rows = x_rows * 32 / kGroup;
  const long long work = slots / kBatch > rows ? slots / kBatch : rows;
  int blocks = 0;
  cudaError_t err = scatter_grid<Acc>(device, smem, work, &blocks);
  if (err != cudaSuccess) return err;
  const Acc* g_ = static_cast<const Acc*>(g);
  const int* nbr_ = static_cast<const int*>(nbr);
  int K_ = K, D_ = static_cast<int>(D), S_ = static_cast<int>(x_rows);
  Acc* dx_ = static_cast<Acc*>(dx);
  void* args[] = {&g_, &nbr_, &K_, &D_, &S_, &width, &plan, &dx_};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(scatter_rows<Acc>), blocks, kThreads,
      args, smem, stream);
}

// What both entries check before a launch: the device, the shapes, and
// whether there is anything to do (*done when not).
int prologue(int h, int K, long long D, long long x_rows, long long ld,
             int device, bool* done) {
  *done = true;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // A block takes one dst row at least, and a grid at most 2^31 - 1.
  if (h < 0 || K < 1 || D < 0 || D > 2147483647LL || ld < D || x_rows < 1 ||
      x_rows > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (D == 0 || h == 0) return 0;
  *done = false;
  return 0;
}

}  // namespace

// The entries launch on `stream` (a cudaStream_t) on device `device`,
// return the cudaError_t of the launch, 0 on success, and do not
// synchronise. nbr is int32 [K, D] with row stride ld (in elements).

// out[d] = sum over k in order of float(x[nbr[k, d]]); x is f32
// (x_bf16 == 0) or bf16 [x_rows, h], out f32 [D, h] contiguous.
extern "C" int dense_gather_sum(const void* x, int x_bf16, long long x_rows,
                                int h, const void* nbr, long long ld, int k,
                                long long d, void* out, int device,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool done = false;
  const int early = prologue(h, k, d, x_rows, ld, device, &done);
  if (done) return early;
  cudaError_t err;
  if (x_bf16) {
    // 16-byte words of a row's aligned window, one a lane.
    const long long window = 2LL * h + (2 * h % 16 ? 8 : 0);
    const bool words = h % 4 == 0 && window <= 16 * kLanes &&
                       aligned(x, 16) && aligned(out, 16);
    const bool vec = h % 4 == 0 && aligned(x, 8) && aligned(out, 16);
    if (words && d >= kWordsMinRows) {
      err = launch_gather_bf16(x, x_rows, h, nbr, ld, k, d, out, s);
    } else if (vec) {
      err = launch_gather<__nv_bfloat16, 4>(x, x_rows, h, nbr, ld, k, d, out,
                                            s);
    } else {
      err = launch_gather<__nv_bfloat16, 1>(x, x_rows, h, nbr, ld, k, d, out,
                                            s);
    }
  } else {
    const bool vec = h % 4 == 0 && aligned(x, 16) && aligned(out, 16);
    err = vec ? launch_gather<float, 4>(x, x_rows, h, nbr, ld, k, d, out, s)
              : launch_gather<float, 1>(x, x_rows, h, nbr, ld, k, d, out, s);
  }
  return static_cast<int>(err);
}

// Bytes of workspace dense_scatter_add takes for these shapes.
extern "C" long long dense_scatter_workspace_bytes(int k, long long d, int h,
                                                   long long x_rows) {
  return static_cast<long long>(layout(k, d, x_rows, h, nullptr).bytes);
}

// dx[s] = sum of g[d] over the slots (k, d) naming s, in slot order; g f32
// [D, h], dx f32 [x_rows, h], both contiguous, and nbr too (ld == d);
// every row of dx is written. workspace: dense_scatter_workspace_bytes(k,
// d, h, x_rows) bytes, 16-byte aligned, uninitialised. k * d < 2^31.
extern "C" int dense_scatter_add(const void* g, const void* nbr, long long ld,
                                 int k, long long d, int h, long long x_rows,
                                 void* dx, void* workspace, int device,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool done = false;
  const int early = prologue(h, k, d, x_rows, ld, device, &done);
  if (done) return early;
  if (ld != d || static_cast<long long>(k) * d > 2147483647LL ||
      !aligned(workspace, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = h % 4 == 0 && aligned(g, 16) && aligned(dx, 16);
  const cudaError_t err =
      vec ? launch_scatter<4>(g, nbr, ld, k, d, h, x_rows, dx, workspace,
                              device, s)
          : launch_scatter<1>(g, nbr, ld, k, d, h, x_rows, dx, workspace,
                              device, s);
  return static_cast<int>(err);
}

namespace {

template <int VEC>
cudaError_t launch_slots(const void* rows, long long num_slots, int h,
                         const void* offsets, const void* slots,
                         const void* long_rows, const void* num_long,
                         long long long_cap, int span, long long x_rows,
                         void* dx, cudaStream_t stream) {
  using Acc = typename Rows<float, VEC>::Acc;
  // A run of kRunTiles row tiles a warp, halved while the grid would
  // have less than kFillWarps warps; a block for each listed long row up
  // to kLongBlocks.
  const int tiles = (h / VEC + 31) / 32;
  int run = kRunTiles / tiles > 1 ? kRunTiles / tiles : 1;
  while (run > 1 && (x_rows + run - 1) / run < kFillWarps) run /= 2;
  const int long_blocks =
      static_cast<int>(long_cap < kLongBlocks ? long_cap : kLongBlocks);
  const long long warps = (x_rows + run - 1) / run;
  const long long blocks = long_blocks + (warps + kWarps - 1) / kWarps;
  scatter_slots<Acc><<<static_cast<unsigned>(blocks), kThreads, 0,
                       stream>>>(
      static_cast<const Acc*>(rows), num_slots,
      static_cast<const int*>(offsets), static_cast<const int*>(slots),
      static_cast<const int*>(long_rows), static_cast<const int*>(num_long),
      span, static_cast<int>(x_rows), h / VEC, run, long_blocks,
      static_cast<Acc*>(dx));
  return cudaGetLastError();
}

}  // namespace

// dx[s] = sum of rows[i] over the slots i (ids k * D + d of the [K, D]
// matrix) that name s, in slot order, for s < x_rows - 1, and dx[x_rows -
// 1] = 0, through the plan of that matrix (see the top of the file):
// offsets int32 [x_rows], slots int32 [num_slots], long_rows int32
// [long_cap] (the rows of more than `span` slots, span >= kWarps - 1 so
// that a block's parts hold a slot each) and num_long int32 [1], all on
// the device. rows f32
// [num_slots, h] (padding slots' rows are not read) and dx f32 [x_rows,
// h], both contiguous; every row of dx is written. num_slots < 2^31.
extern "C" int dense_scatter_slots(const void* rows, long long num_slots,
                                   int h, const void* offsets,
                                   const void* slots, const void* long_rows,
                                   const void* num_long, long long long_cap,
                                   int span, long long x_rows, void* dx,
                                   int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (h < 0 || num_slots < 0 || num_slots > 2147483647LL || long_cap < 1 ||
      span < kWarps - 1 || x_rows < 1 || x_rows > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (h == 0) return 0;
  const bool vec = h % 4 == 0 && aligned(rows, 16) && aligned(dx, 16);
  const cudaError_t err =
      vec ? launch_slots<4>(rows, num_slots, h, offsets, slots, long_rows,
                            num_long, long_cap, span, x_rows, dx, s)
          : launch_slots<1>(rows, num_slots, h, offsets, slots, long_rows,
                            num_long, long_cap, span, x_rows, dx, s);
  return static_cast<int>(err);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
