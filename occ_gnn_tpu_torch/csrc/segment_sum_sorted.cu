// Sorted segment-sum for Hopper (sm_90a), in two entry points on one tile
// machinery:
//
//   segment_sum_sorted_f32:  out[d, :] = sum over e with dst[e] == d of
//                                        msgs[e, :]
//   gather_segment_sum:      out[d, :] = sum over e with dst[e] == d of
//                                        w[e] * float(x[src[e], :])
//
// msgs is f32 [E, H] row-major; x is f32 or bf16 [S, H]; src and dst are
// int32 [E], dst sorted ascending, and padding edges carry dst ==
// num_segments; w is an optional f32 [E]. out is f32 [num_segments, H].
// The first is the contract of the TPU kernel it replaces,
// occ_gnn_tpu/ops/pallas_spmm_blocked.py::segment_sum_sorted; the second is
// that file's spmm_sum_blocked (the gather followed by the segment-sum) and
// ops/segment.py::spmm_sum with an edge weight, with the gather inside the
// kernel: each valid edge's x row is read once, in its own type, and no
// [E, H] message tensor is ever written.
//
// Bound: device-memory bytes. Each valid edge row is read once and each
// output row written once, with one add (and one multiply under a weight)
// per element read, far below the card's arithmetic rate.
//
// Design: edge-balanced tiles, no search per row.
//   * The valid-edge count V = lower_bound(dst, num_segments) is found once
//     a block, by a search whose rounds probe one entry a thread (3
//     dependent rounds at E = 6.6 M), and no edge at or past V is read.
//   * The valid edges are cut into tiles of tile_edges (an argument: the
//     wrapper's constant). A team of threads, one thread for each 16-byte
//     (f32) or 8-byte (bf16) column group of a row, takes one tile; a block
//     holds as many teams as fit in 256 threads (25 a row at H = 100 f32:
//     10 teams, 250 threads busy), so lanes run over (tile, column) and a
//     warp keeps rows of two tiles in flight. Blocks are persistent and
//     take runs of teams * tile_edges edges in turn.
//   * A block copies its run's dst (and src, w) into shared memory with
//     coalesced loads, with one tile more on each side, and each team
//     finds its tile's row boundaries there.
//   * Each thread walks its tile's edges in order, with two batches of
//     kUnroll row loads in flight (the next batch is issued before the
//     adds of this one wait on it), and keeps the row's sum in f32
//     registers. A row wholly inside the tile is written once. The empty
//     rows between two of a tile's rows are written 0 by that tile; those
//     before the first valid edge and after the last (a layer's dst frame
//     is padded to its capacity, so these can be most of the output) by
//     the whole grid, coalesced. Every output row is written once.
//   * A row cut by a tile's edge that spans two tiles (the common case:
//     rows are short beside a tile) is summed whole by the tile where it
//     begins, which reads on into the next tile's staged edges; the next
//     tile skips them. A row that spans three tiles or more is split: each
//     tile leaves its part in a scratch buffer of [num_tiles, 2, H] f32
//     (slot 0: the row began in an earlier tile; slot 1: the row begins
//     here and goes on), the tile where it begins marks itself in an owner
//     array, and a short second pass adds the owner's slot 1 and the
//     following tiles' slot 0 in tile order. So a long row is summed by as
//     many teams as it spans tiles, and short rows cost no scratch traffic.
//   * No atomics: the same inputs give the same bits on every launch.
//   * Vector loads where the rows allow them: float4 for f32 rows when H %
//     4 == 0 and the pointers are 16-byte aligned, 8-byte loads of 4 bf16
//     when H % 4 == 0 and x is 8-byte aligned (a bf16 row of H = 100 is
//     200 B, so only every other row starts on 16 B); one element a thread
//     otherwise.
//   * An edge_src entry of a valid edge outside [0, S) stops the kernel
//     with a device-side assert, as torch.index_select does on the card.
// Offsets row * H are 64-bit: at the innermost block E * H passes 2^31 on
// larger graphs.
//
// Tried on the card (an H100 SXM, throwaway probes at synthetic layer-0
// shapes of 1.85 M to 2.9 M valid edges, H = 100 to 192): tiles of 32 to
// 256 edges (32 leaves most rows of 25 edges long, so the second pass
// grows; 128 and more lengthen each thread's serial walk, which small
// layers pay in full), one or two batches of 4, 8 or 16 loads (16 costs
// occupancy), one 4-byte column a thread as torch.segment_reduce reads
// (far slower here: a thread's walk is a whole tile), warp-aligned teams,
// a scattered order of the blocks' runs, L2 prefetch and L1 no-allocate
// hints, a shared-memory carveout, and a programmatic dependent launch of
// the second pass. The kernel keeps 64-edge tiles and two batches of 8.

#include <assert.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // at most, a block
constexpr int kMaxBlockEdges = 2048;  // edges of a block's run
constexpr int kUnroll = 8;           // row loads a batch; two batches in flight
constexpr int kFixupWarps = 8;       // warps a block of the second pass
constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ __forceinline__ long long lmin(long long a, long long b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ long long lmax(long long a, long long b) {
  return a > b ? a : b;
}

// The first index in [0, num_edges) with dst >= num_segments (num_edges if
// none), by the whole block: each round probes blockDim.x evenly spaced
// entries and keeps the span between the last probe below and the first
// at or above (3 dependent rounds at E = 6.6 M and 256 threads).
__device__ long long count_valid(const int* __restrict__ dst,
                                 long long num_edges, int num_segments) {
  const long long probes = blockDim.x;
  long long lo = 0, hi = num_edges;
  while (lo < hi) {
    const long long step = (hi - lo + probes - 1) / probes;
    const long long probe = lo + threadIdx.x * step;
    const bool below = probe < hi && __ldg(dst + probe) < num_segments;
    const int c = __syncthreads_count(below);
    if (c == 0) return lo;
    const long long next_lo = lo + (c - 1) * step + 1;
    hi = lmin(hi, lo + c * step);
    lo = next_lo;
  }
  return lo;
}

// The first index in [lo, hi) of sorted s with s[i] != key, where every
// entry before it equals key (hi if none).
__device__ __forceinline__ int row_end(const int* s, int lo, int hi, int key) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] == key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Column groups: float4 sums of 4 columns, or one float.
__device__ __forceinline__ void zero(float& v) { v = 0.f; }
__device__ __forceinline__ void zero(float4& v) {
  v = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void add(float& acc, float v) { acc += v; }
__device__ __forceinline__ void add(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}
__device__ __forceinline__ void scale(float& v, float w) { v *= w; }
__device__ __forceinline__ void scale(float4& v, float w) {
  v.x *= w;
  v.y *= w;
  v.z *= w;
  v.w *= w;
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
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
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

// Pass 1: every tile sums its rows. GATHER reads row src[e] of x (else row
// e of the messages), WEIGHT scales it by w[e] first. Shared memory holds
// a block's run of edges with one tile more on each side and one entry
// beyond those: edge e at index e - start + tile_edges + 1, dst[0] - 1
// before edge 0 and num_segments from V on. owner[t] (t below the valid
// tiles) says whether a long row begins in tile t; owner[tiles_cap] is V.
template <typename In, int VEC, bool GATHER, bool WEIGHT>
__global__ void __launch_bounds__(kThreads)
tile_pass(const In* __restrict__ x, long long x_rows,
          const int* __restrict__ edge_src, const int* __restrict__ edge_dst,
          const float* __restrict__ weight, long long num_edges, int width,
          int num_segments, int tile_edges, int team_threads, int teams,
          typename Rows<In, VEC>::Acc* __restrict__ out,
          typename Rows<In, VEC>::Acc* __restrict__ partial,
          int* __restrict__ owner, long long tiles_cap) {
  using Acc = typename Rows<In, VEC>::Acc;
  extern __shared__ int smem[];
  const int block_edges = teams * tile_edges;
  const int span = block_edges + 2 * tile_edges + 2;
  int* s_dst = smem;
  int* s_src = s_dst + span;
  float* s_w = reinterpret_cast<float*>(s_src + (GATHER ? span : 0));

  const long long valid = count_valid(edge_dst, num_edges, num_segments);
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    owner[tiles_cap] = static_cast<int>(valid);
  }
  Acc z;
  zero(z);
  // The rows before the first valid edge and after the last have no edge
  // (a layer's dst frame is padded to its capacity): the whole grid writes
  // their zeros, all of them when every edge is padding.
  const long long total = static_cast<long long>(num_segments) * width;
  const long long head =
      valid == 0 ? total : static_cast<long long>(__ldg(edge_dst)) * width;
  const long long tail =
      valid == 0 ? total
                 : (static_cast<long long>(__ldg(edge_dst + valid - 1)) + 1) *
                       width;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < head + (total - tail);
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    out[i < head ? i : tail + (i - head)] = z;
  }
  if (valid == 0) return;
  const int before = __ldg(edge_dst) - 1;  // stands for the edges before 0

  const int team = threadIdx.x / team_threads;
  const int col0 = threadIdx.x - team * team_threads;
  for (long long start = static_cast<long long>(blockIdx.x) * block_edges;
       start < valid;
       start += static_cast<long long>(gridDim.x) * block_edges) {
    // The run, the tile after it (for rows that begin in the run and end
    // there) and the tile before it (to tell a long row from a short one).
    const int staged = static_cast<int>(
        lmin(block_edges + tile_edges, valid - start));
    const long long base = start - tile_edges - 1;
    for (int i = threadIdx.x; i < staged + tile_edges + 2; i += blockDim.x) {
      const long long e = base + i;
      s_dst[i] = e < 0 ? before
                       : (e < valid ? __ldg(edge_dst + e) : num_segments);
      if (e >= start && e < start + staged) {
        if (GATHER) {
          const int s = __ldg(edge_src + e);
          assert(s >= 0 && s < x_rows);
          s_src[i] = s;
        }
        if (WEIGHT) s_w[i] = __ldg(weight + e);
      }
    }
    __syncthreads();

    const long long a = start + static_cast<long long>(team) * tile_edges;
    if (team < teams && a < valid) {
      const int lo = (team + 1) * tile_edges + 1;  // index of the first edge
      const int hi = lo + static_cast<int>(lmin(tile_edges, valid - a));
      const long long tile = a / tile_edges;
      const int prev = s_dst[lo - 1];
      const int first_row = s_dst[lo];
      const int last_row = s_dst[hi - 1];
      const int next = s_dst[hi];
      const bool cut_start = prev == first_row;
      const bool cut_end = next == last_row;
      // A row that also lies in the tile before the previous one, or in
      // the next one, spans three tiles or more: it is long.
      const bool long_first =
          cut_start && (s_dst[lo - tile_edges - 1] == first_row ||
                        (last_row == first_row && cut_end));
      const bool begins_last = !(cut_start && last_row == first_row);
      const bool long_last = cut_end && begins_last &&
                             a + 2 * tile_edges < valid &&
                             s_dst[hi + tile_edges] == last_row;
      // A short row cut at the start was summed by the tile before; a
      // short row cut at the end is summed here, into the next tile.
      const int from = cut_start && !long_first
                           ? row_end(s_dst, lo, hi, first_row) : lo;
      const int to =
          cut_end && begins_last && !long_last
              ? row_end(s_dst, hi,
                        hi + static_cast<int>(lmin(tile_edges,
                                                   valid - a - tile_edges)),
                        last_row)
              : hi;
      // The empty rows before the first row this tile sums.
      const int gap_from = from > lo ? first_row : prev;
      const int gap_to = from < to ? s_dst[from] : first_row;
      if (col0 == 0) owner[tile] = long_last;
      for (int c = col0; c < width; c += team_threads) {
        auto put = [&](int row, const Acc& v) {
          if (row == first_row && long_first) {
            partial[(2 * tile) * width + c] = v;
          } else if (row == last_row && long_last) {
            partial[(2 * tile + 1) * width + c] = v;
          } else {
            out[static_cast<long long>(row) * width + c] = v;
          }
        };
        for (int r = gap_from + 1; r < gap_to; ++r) {
          out[static_cast<long long>(r) * width + c] = z;
        }
        Acc acc = z;
        int row = gap_to;
        // Issue the row loads of edges [i, i + kUnroll) ...
        auto load = [&](Acc (&vals)[kUnroll], int i) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int k = i + u;
            if (k < to) {
              const long long r = GATHER ? s_src[k] : a + (k - lo);
              vals[u] = Rows<In, VEC>::load(x, r, width, c);
            }
          }
        };
        // ... and add them to their rows, in edge order.
        auto consume = [&](Acc (&vals)[kUnroll], int i) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int k = i + u;
            if (k < to) {
              if (WEIGHT) scale(vals[u], s_w[k]);
              const int d = s_dst[k];
              if (d != row) {
                put(row, acc);
                for (int r = row + 1; r < d; ++r) {
                  out[static_cast<long long>(r) * width + c] = z;
                }
                row = d;
                acc = z;
              }
              add(acc, vals[u]);
            }
          }
        };
        // Two batches in flight: the next batch's loads go out before
        // this one's adds wait on its own.
        Acc va[kUnroll], vb[kUnroll];
        load(va, from);
        for (int i = from; i < to; i += 2 * kUnroll) {
          load(vb, i + kUnroll);
          consume(va, i);
          load(va, i + 2 * kUnroll);
          consume(vb, i + kUnroll);
        }
        if (from < to) put(row, acc);
      }
    }
    __syncthreads();
  }
}

// Pass 2: a warp a tile. The tile where a long row begins writes it: its
// own slot 1 plus slot 0 of each following tile the row reaches, in tile
// order. Tiles without a long row only read their flag.
template <typename Acc>
__global__ void __launch_bounds__(kFixupWarps * 32)
fixup_pass(const int* __restrict__ edge_dst, const int* __restrict__ owner,
           long long tiles_cap, int tile_edges, int width,
           const Acc* __restrict__ partial, Acc* __restrict__ out) {
  const long long valid = owner[tiles_cap];
  const long long tiles = (valid + tile_edges - 1) / tile_edges;
  const int lane = threadIdx.x & 31;
  for (long long t = static_cast<long long>(blockIdx.x) * kFixupWarps +
                     (threadIdx.x >> 5);
       t < tiles; t += static_cast<long long>(gridDim.x) * kFixupWarps) {
    if (!owner[t]) continue;
    const int row = __ldg(edge_dst + (t + 1) * tile_edges - 1);
    for (int c = lane; c < width; c += 32) {
      Acc acc = partial[(2 * t + 1) * width + c];
      for (long long u = t + 1;
           u * tile_edges < valid && __ldg(edge_dst + u * tile_edges) == row;
           ++u) {
        add(acc, partial[(2 * u) * width + c]);
      }
      out[static_cast<long long>(row) * width + c] = acc;
    }
  }
}

int sm_count(int device) {
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
  return n > 0 ? n : 1;
}

template <typename In, int VEC, bool GATHER, bool WEIGHT>
cudaError_t launch(const void* x, long long x_rows, const void* edge_src,
                   const void* edge_dst, const void* weight,
                   long long num_edges, int h, int num_segments,
                   int tile_edges, void* partial, void* owner, void* out,
                   int device, cudaStream_t stream) {
  using Acc = typename Rows<In, VEC>::Acc;
  const int width = h / VEC;
  const int team_threads = static_cast<int>(lmin(width, kThreads));
  const int teams = static_cast<int>(
      lmin(kThreads / team_threads, lmax(1, kMaxBlockEdges / tile_edges)));
  const int threads = (teams * team_threads + 31) / 32 * 32;
  const long long block_edges = static_cast<long long>(teams) * tile_edges;
  const size_t smem = static_cast<size_t>(block_edges + 2 * tile_edges + 2) *
                      (sizeof(int) + (GATHER ? sizeof(int) : 0) +
                       (WEIGHT ? sizeof(float) : 0));
  const long long tiles_cap = (num_edges + tile_edges - 1) / tile_edges;
  auto kernel = tile_pass<In, VEC, GATHER, WEIGHT>;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  const int sms = sm_count(device);
  const long long blocks_cap = (num_edges + block_edges - 1) / block_edges;
  const int grid = static_cast<int>(
      lmin(blocks_cap, static_cast<long long>(sms) * lmax(per_sm, 1)));
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const In*>(x), x_rows, static_cast<const int*>(edge_src),
      static_cast<const int*>(edge_dst), static_cast<const float*>(weight),
      num_edges, width, num_segments, tile_edges, team_threads, teams,
      static_cast<Acc*>(out), static_cast<Acc*>(partial),
      static_cast<int*>(owner), tiles_cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int fixup_grid = static_cast<int>(
      lmin((tiles_cap + kFixupWarps - 1) / kFixupWarps, sms * 8LL));
  fixup_pass<Acc><<<fixup_grid, kFixupWarps * 32, 0, stream>>>(
      static_cast<const int*>(edge_dst), static_cast<const int*>(owner),
      tiles_cap, tile_edges, width, static_cast<const Acc*>(partial),
      static_cast<Acc*>(out));
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// What both entries do before their launches: nothing for an empty
// output, zeros for an empty edge list, a check of the tile size.
int prologue(long long num_edges, int h, int num_segments, int tile_edges,
             void* out, int device, cudaStream_t stream, bool* done) {
  *done = true;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tile_edges < 1 || 2 * tile_edges > kMaxBlockEdges) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_segments <= 0 || h <= 0) return 0;
  if (num_edges == 0) {
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(num_segments) * h * sizeof(float), stream));
  }
  *done = false;
  return 0;
}

}  // namespace

// Both entries launch on `stream` (a cudaStream_t) on device `device`,
// return the cudaError_t of the launches, 0 on success, and do not
// synchronise. With tiles = ceil(num_edges / tile_edges), `partial` is f32
// scratch of 2 * tiles * h floats and `owner` int32 scratch of tiles + 1;
// `out` is f32 [num_segments, h]. tile_edges is at most 1024.
extern "C" int segment_sum_sorted_f32(const void* msgs, const void* edge_dst,
                                      long long num_edges, int h,
                                      int num_segments, int tile_edges,
                                      void* partial, void* owner, void* out,
                                      int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool done = false;
  const int early = prologue(num_edges, h, num_segments, tile_edges, out,
                             device, s, &done);
  if (done) return early;
  const bool vec = h % 4 == 0 && aligned(msgs, 16) && aligned(out, 16) &&
                   aligned(partial, 16);
  const cudaError_t err =
      vec ? launch<float, 4, false, false>(
                msgs, num_edges, nullptr, edge_dst, nullptr, num_edges, h,
                num_segments, tile_edges, partial, owner, out, device, s)
          : launch<float, 1, false, false>(
                msgs, num_edges, nullptr, edge_dst, nullptr, num_edges, h,
                num_segments, tile_edges, partial, owner, out, device, s);
  return static_cast<int>(err);
}

// x is f32 (x_bf16 == 0) or bf16 [x_rows, h]; weight may be null.
extern "C" int gather_segment_sum(const void* x, int x_bf16, long long x_rows,
                                  const void* edge_src, const void* edge_dst,
                                  const void* weight, long long num_edges,
                                  int h, int num_segments, int tile_edges,
                                  void* partial, void* owner, void* out,
                                  int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool done = false;
  const int early = prologue(num_edges, h, num_segments, tile_edges, out,
                             device, s, &done);
  if (done) return early;
  const bool vec = h % 4 == 0 && aligned(x, x_bf16 ? 8 : 16) &&
                   aligned(out, 16) && aligned(partial, 16);
#define OCC_GATHER_LAUNCH(In, VEC, W)                                        \
  launch<In, VEC, true, W>(x, x_rows, edge_src, edge_dst, weight, num_edges, \
                           h, num_segments, tile_edges, partial, owner, out, \
                           device, s)
  cudaError_t err;
  if (x_bf16) {
    if (vec) {
      err = weight ? OCC_GATHER_LAUNCH(__nv_bfloat16, 4, true)
                   : OCC_GATHER_LAUNCH(__nv_bfloat16, 4, false);
    } else {
      err = weight ? OCC_GATHER_LAUNCH(__nv_bfloat16, 1, true)
                   : OCC_GATHER_LAUNCH(__nv_bfloat16, 1, false);
    }
  } else {
    if (vec) {
      err = weight ? OCC_GATHER_LAUNCH(float, 4, true)
                   : OCC_GATHER_LAUNCH(float, 4, false);
    } else {
      err = weight ? OCC_GATHER_LAUNCH(float, 1, true)
                   : OCC_GATHER_LAUNCH(float, 1, false);
    }
  }
#undef OCC_GATHER_LAUNCH
  return static_cast<int>(err);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
