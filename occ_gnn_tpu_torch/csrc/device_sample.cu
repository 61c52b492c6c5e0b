// The on-device samplers for Hopper (sm_90a), three entries on one source:
//
//   synthesize_innermost: split A's layer 0 from a resident CSR. For each
//       dst column d of a frame dst [D] (global ids, pad -1) of a layer of
//       fan-out K, with off = indptr[g], deg = indptr[g + 1] - off (0 at a
//       pad) and take = min(deg, K):
//         nbr[0, d]     = g, or the zero row src_cap - 1 at a pad;
//         nbr[k + 1, d] = indices[off + sel], sel = draws[k, d] % deg if
//                         deg > K, else k; the zero row where k >= take;
//       and over the first out_cap columns owned_idx (d, or -1 at a pad),
//       owned_deg (take + 1 as f32, 1 at a pad), self_idx (g, 0 at a pad)
//       and owned_mask (d is no pad); num_owned = the columns that are no
//       pad. The frame's valid columns must be a prefix (the sampling
//       service writes each dst id at its dense rank and pads the rest).
//   draw_neighbors: quiver's next frontier. out [n * (1 + K)] int32; out[i]
//       = frontier[i] for i < n, and out[n + s * K + k] = indices[indptr[f]
//       + r[s, k] % deg] for f = frontier[s], deg its in-degree, or f
//       itself where deg == 0.
//   gather_mean: quiver's deepest gather and first-layer mean. For each
//       self row s < n of the deepest frontier f [n * (1 + K)]: x_self[s] =
//       float(x[f[s]]) and mean[s] = (x_self[s] + sum over k = 0..K-1 of
//       float(x[f[n + s * K + k]])) / (K + 1), both f32 [n, H], for an f32
//       or bf16 table x [rows, H].
//
// Replaces: synthesize_innermost, occ_gnn_tpu/parallel/split.py:200-310
// (synthesize_device_innermost under its default randint lowering, and
// _finish_innermost), which XLA lowers to a few dozen fused gathers and
// selects (no pallas_call); draw_neighbors,
// occ_gnn_tpu/sampling/device_sampler.py:71-85 (sample_neighbors_dense and
// the concatenation of dense_frontiers); gather_mean, the same file's
// :164 (features[frontiers[-1]]) and :139-141 (the first layer's mean of
// dense_sage_forward). The random numbers are an input (the wrapper draws
// them with torch.randint as the plain versions do), so a kernel and its
// plain version give the same bits from the same generator.
//
// Bound: device-memory bytes, far from the card's arithmetic rate (one
// modulo a draw, one multiply-add an element read). What each design does
// about it:
//   * synthesize_innermost: a warp takes a tile of 32 consecutive
//     columns, a lane each, and never waits for another warp. The frame's
//     warps are all resident at once, so the kernel takes about one
//     warp's chain of dependent reads, and the chain is short: dst, then
//     indptr, then one round of asynchronous copies (cp.async) into the
//     warp's shared memory, all in flight together: the tile's adjacency
//     runs indices[off, off + deg) of up to kRunFactor * K words, a column
//     at a time with consecutive lanes on consecutive words (each run's
//     sectors leave device memory once), and kDrawRows rows of the draws
//     of the columns of deg > K (only those read them, coalesced along
//     d). The
//     slots are then picked in shared memory (k where deg <= K, draws[k,
//     d] % deg where deg > K) and nbr is written a row of the tile at a
//     time. A longer run (a hub), or one past the warp's staging space,
//     reads its picked words directly. The 64-bit remainder goes by the
//     column's reciprocal of deg (mod_by), not by the card's division
//     routine. The count num_owned needs no state between launches: the
//     valid columns are a prefix, so it is the index of the first pad (or
//     D), and the one warp whose tile holds that boundary writes it,
//     seeing from the column before its tile whether the boundary came
//     earlier. A valid column after a pad stops the kernel with a
//     device-side assert. No memset, no atomics.
//   * draw_neighbors: a warp takes a tile of 8 consecutive frontier
//     entries, a lane each, and a stage of up to 1,024 words in shared
//     memory. Each warp is a chain of three rounds of reads, not each
//     output word: (1) the lane's node f, then asynchronous copies
//     (cp.async) of the tile's draws r[s0
//     * K, (s0 + 8) * K), one contiguous block, into the stage; (2) f's
//     indptr pair, which the lane writes to the warp's shared memory with
//     deg's reciprocal; (3) lanes over the tile's output words,
//     consecutive lanes on consecutive words: each word's index copied by
//     cp.async over its draw in the stage, every copy of the warp in
//     flight at once and none held in a register, then the stage stored
//     coalesced. A word's node comes from its tile-local index by a 32-bit
//     multiply-high by K's reciprocal, and r % deg by deg's (mod32): no
//     division a word. The reads of one node's run fall in one or two warp
//     instructions, so the coalescer fetches each of its sectors once, and
//     L1 (the default split of it and shared memory) holds the runs of a
//     tile's repeated nodes.
//   * gather_mean: a warp an output row s. Its K + 1 ids (the self row,
//     then the draws; in chunks of 32 past 31 draws) sit a lane each, and
//     __match_any_sync merges the repeated ones before any row is read:
//     each distinct id, at its lowest lane, is read once and added with
//     weight count (quiver draws with replacement, so a row of a
//     low-degree node is drawn several times). The distinct rows are
//     copied into the warp's stage in shared memory by bulk copies (the
//     Tensor Memory Accelerator, cp.async.bulk: a lane a row, its
//     16-byte-aligned window, completing on the warp's mbarrier): a bf16
//     row of 200 bytes that starts 8 bytes off a 16-byte boundary moves
//     as 13 whole 16-byte words, and the copies take no lane's registers,
//     so every lane is free while they fly. A stage holds at most an
//     output's K + 1 rows (gather_mean_plan), so narrower rows leave
//     room for more warps an SM, more rows in flight. A window that would
//     pass either end of the table is copied by the lanes, element by
//     element within it, zeros outside. Then lanes over the row's columns (4 a
//     lane, 128 columns a pass) add count * row from shared memory in the
//     order of the distinct ids' lanes, in f32; the [n * (1 + K), H] frame
//     of the plain version is never written. x_self is the self row's
//     copy, converted: bit-equal. The mean differs from the plain version
//     only by its order of summation (count * row for repeated adds).
//
// A table row or CSR entry outside its array stops the kernel with a
// device-side assert, as torch.index_select does on the card (JAX clamps
// silently). Offsets row * H and k * D are 64-bit.

#include <assert.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr unsigned kFullMask = 0xffffffffu;

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------
// synthesize_innermost

constexpr int kSynWarps = 4;  // a block
constexpr int kSynThreads = kSynWarps * kLanes;
constexpr int kRunWords = 1024;  // a warp's staged adjacency words (4 KB)
constexpr int kRunFactor = 8;    // runs of up to 8 K words are staged
constexpr int kDrawRows = 16;    // draws rows a warp stages at once

// r % d for r < 2^63 and 0 < d < 2^31, from the column's reciprocal m =
// floor((2^64 - 1) / d): q = floor(r m / 2^64) is at most 2 short of
// floor(r / d) and never over it, so at most two subtractions finish it.
// A 64-bit remainder is a long software routine on the card; this is a
// multiply-high, a multiply and compares.
__device__ __forceinline__ int mod_by(unsigned long long r, unsigned d,
                                      unsigned long long m) {
  unsigned long long rem = r - __umul64hi(r, m) * d;
  while (rem >= d) rem -= d;
  return static_cast<int>(rem);
}

// Asynchronous copies of 4 and 8 bytes from device into shared memory.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// The bytes of dynamic shared memory a block takes: each warp's staged
// runs, then its draws rows.
constexpr size_t synthesize_smem(int rows) {
  return kSynWarps * (sizeof(int) * kRunWords +
                      sizeof(long long) * rows * kLanes);
}

// A warp owns a tile of 32 consecutive columns, a lane each; the warps
// never wait for each other. `rows` draws rows a stage (min(K,
// kDrawRows)).
__global__ void __launch_bounds__(kSynThreads)
synthesize_kernel(const int* __restrict__ dst, int D,
                  const int* __restrict__ indptr, long long num_nodes,
                  const int* __restrict__ indices, long long num_indices,
                  const long long* __restrict__ draws, int K, int rows,
                  int out_cap, int zero_row, int* __restrict__ nbr,
                  int* __restrict__ owned_idx, float* __restrict__ owned_deg,
                  int* __restrict__ self_idx,
                  unsigned char* __restrict__ owned_mask,
                  int* __restrict__ num_owned) {
  extern __shared__ __align__(16) unsigned char syn_smem[];
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  long long* drawn = reinterpret_cast<long long*>(syn_smem) +
                     warp * rows * kLanes;  // [rows][32]
  int* run = reinterpret_cast<int*>(reinterpret_cast<long long*>(syn_smem) +
                                    kSynWarps * rows * kLanes) +
             warp * kRunWords;
  const long long d0 =
      (static_cast<long long>(blockIdx.x) * kSynThreads + threadIdx.x) -
      lane;  // the warp's first column
  if (d0 >= D) return;  // whole warps
  const long long dl = d0 + lane;
  const bool in = dl < D;
  const int d = static_cast<int>(in ? dl : 0);
  bool valid = false;
  int g = 0, off = 0, deg = 0;
  if (in) {
    const int gd = __ldg(dst + d);
    valid = gd >= 0;
    if (valid) {
      g = gd;
      assert(g < num_nodes);
      off = __ldg(indptr + g);
      deg = __ldg(indptr + g + 1) - off;
      assert(deg >= 0 && off + static_cast<long long>(deg) <= num_indices);
    }
  }
  // num_owned: the first pad's index, written by the warp whose tile holds
  // it (its column before is valid, or it is the first tile); the last
  // tile writes D when no column is a pad.
  const unsigned pads = __ballot_sync(kFullMask, in && !valid);
  const int first_pad = pads ? __ffs(pads) - 1 : kLanes;
  const bool pad_before = d0 > 0 && __ldg(dst + d0 - 1) < 0;
  assert(!valid || (!pad_before && lane < first_pad));
  if (lane == 0 && !pad_before) {
    if (first_pad < kLanes) {
      *num_owned = static_cast<int>(d0) + first_pad;
    } else if (d0 + kLanes >= D) {
      *num_owned = D;
    }
  }
  // The tile's staging plan: an exclusive scan of the runs to stage; a
  // run that would pass kRunWords (and every one after it) is read
  // directly instead.
  int len = valid && deg <= kRunFactor * K ? deg : 0;
  int base = len;
#pragma unroll
  for (int o = 1; o < kLanes; o *= 2) {
    const int v = __shfl_up_sync(kFullMask, base, o);
    if (lane >= o) base += v;
  }
  base -= len;
  const bool staged = len > 0 && base + len <= kRunWords;
  if (!staged) len = 0;
  const int take = deg < K ? deg : K;
  const bool drawing = deg > K;
  // This lane's first rows of draws, then every staged run, a column at a
  // time with lanes over its words: all copies in flight at once.
  const long long ld = D;
  const int kn0 = K < rows ? K : rows;
  if (drawing) {
    for (int j = 0; j < kn0; ++j) {
      cp_async8(drawn + j * kLanes + lane, draws + j * ld + d);
    }
  }
#pragma unroll 8
  for (int c = 0; c < kLanes; ++c) {
    const int n = __shfl_sync(kFullMask, len, c);
    const int o = __shfl_sync(kFullMask, off, c);
    const int b = __shfl_sync(kFullMask, base, c);
    for (int i = lane; i < n; i += kLanes) {
      cp_async4(run + b + i, indices + o + i);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
  if (!in) return;
  const unsigned long long recip =
      drawing ? ~0ULL / static_cast<unsigned>(deg) : 0ULL;
  nbr[d] = valid ? g : zero_row;
  for (int k0 = 0; k0 < K; k0 += rows) {
    const int kn = K - k0 < rows ? K - k0 : rows;
    if (k0 > 0 && drawing) {  // the next rows of draws (K > kDrawRows)
      for (int j = 0; j < kn; ++j) {
        cp_async8(drawn + j * kLanes + lane, draws + (k0 + j) * ld + d);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    for (int j = 0; j < kn; ++j) {
      const int k = k0 + j;
      int v = zero_row;
      if (k < take) {
        const int sel =
            drawing ? mod_by(static_cast<unsigned long long>(
                                 drawn[j * kLanes + lane]),
                             static_cast<unsigned>(deg), recip)
                    : k;
        v = staged ? run[base + sel] : __ldg(indices + off + sel);
      }
      nbr[(k + 1) * ld + d] = v;
    }
  }
  if (d < out_cap) {
    owned_idx[d] = valid ? d : -1;
    owned_deg[d] = valid ? static_cast<float>(take + 1) : 1.0f;
    self_idx[d] = g;
    owned_mask[d] = static_cast<unsigned char>(valid);
  }
}

// ---------------------------------------------------------------------
// draw_neighbors

constexpr int kDrawWarps = 4;  // a block
constexpr int kDrawThreads = kDrawWarps * kLanes;
// 12 blocks an SM cap a thread at 40 registers (48 without it: 10
// blocks), which measured faster at quiver's layer 2 on an H100 80GB HBM3
// at 700 W (PERF.md, PR 17).
constexpr int kDrawBlocksAnSm = 12;
// Frontier entries a warp: a tile of 8 was faster than one of 4, 16 or 32
// at each of quiver's layers on the same card (more warps, each a shorter
// walk of words).
constexpr int kDrawTile = 8;
constexpr int kDrawStage = 1024;  // a warp's staged words at most (4 KB)
constexpr int kMaxDrawK = 1 << 25;  // a tile's words stay in an int

// x / d and x % d for 0 < d and any 32-bit x, from m = floor((2^32 - 1) /
// d): 2^32 - m d is at most d, so x / d - x m / 2^32 = x (2^32 - m d) / (d
// 2^32) lies in [0, 1), and q = floor(x m / 2^32) is floor(x / d) or one
// short of it; one compare finishes it. A multiply-high, a multiply and a
// compare, where `/` and `%` are software routines on the card.
__device__ __forceinline__ unsigned div32(unsigned x, unsigned d,
                                          unsigned m) {
  const unsigned q = __umulhi(x, m);
  return x - q * d >= d ? q + 1 : q;
}

__device__ __forceinline__ unsigned mod32(unsigned x, unsigned d,
                                          unsigned m) {
  const unsigned rem = x - __umulhi(x, m) * d;
  return rem >= d ? rem - d : rem;
}

// An asynchronous copy of 16 bytes into shared memory, cached in L2 only.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// A warp owns the tile of frontier entries [s0, s0 + kDrawTile), a lane
// each, and a stage of `stage` words (min(kDrawTile K, kDrawStage), a
// multiple of 4) in dynamic shared memory; k_recip = floor((2^32 - 1) /
// K).
__global__ void __launch_bounds__(kDrawThreads, kDrawBlocksAnSm)
draw_kernel(const int* __restrict__ frontier, long long n,
            const int* __restrict__ indptr, long long num_nodes,
            const int* __restrict__ indices, long long num_indices,
            const int* __restrict__ r, int K, unsigned k_recip, int stage,
            int* __restrict__ out) {
  extern __shared__ __align__(16) int draw_smem[];
  // Each tile node's run start (its own id at degree 0), its degree and
  // the degree's reciprocal, at the node's lane.
  __shared__ uint4 nodes_of[kDrawWarps][kDrawTile];
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  uint4* nodes = nodes_of[warp];
  int* staged = draw_smem + warp * stage;
  const long long s0 =
      (static_cast<long long>(blockIdx.x) * kDrawWarps + warp) * kDrawTile;
  if (s0 >= n) return;  // whole warps
  const int tile =
      n - s0 < kDrawTile ? static_cast<int>(n - s0) : kDrawTile;
  const int words = tile * K;  // the tile's output words, r's words
  const int* rt = r + s0 * K;
  int* ot = out + n + s0 * K;
  // r's words [w0, w0 + len) into the stage: 16 bytes a copy where r's
  // block is 16-byte aligned (s0 K words, s0 a multiple of 8, from an
  // aligned r), else 4.
  const bool quads = reinterpret_cast<uintptr_t>(rt) % 16 == 0;
  auto stage_draws = [&](int w0, int len) {
    const int head = quads ? len / 4 * 4 : 0;
    for (int w = 4 * lane; w < head; w += 4 * kLanes) {
      cp_async16(staged + w, rt + w0 + w);
    }
    for (int w = head + lane; w < len; w += kLanes) {
      cp_async4(staged + w, rt + w0 + w);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // Round 1: the lane's node, then the first stage of the tile's draws
  // (issued after it, so it does not queue behind them); round 2: the
  // node's indptr pair.
  const int f = lane < tile ? __ldg(frontier + s0 + lane) : 0;
  stage_draws(0, words < stage ? words : stage);
  uint4 node = make_uint4(0, 0, 0, 0);
  if (lane < tile) {
    assert(f >= 0 && f < num_nodes);
    out[s0 + lane] = f;
    const int start = __ldg(indptr + f);
    const int deg = __ldg(indptr + f + 1) - start;
    node = deg > 0 ? make_uint4(start, deg, 0xffffffffu / deg, 0)
                   : make_uint4(f, 0, 0, 0);
  }
  if (lane < kDrawTile) nodes[lane] = node;
  // Round 3, a stage at a time: each word's index copied over its draw in
  // the stage, all in flight at once, then the stage stored coalesced.
  for (int w0 = 0; w0 < words; w0 += stage) {
    const int len = words - w0 < stage ? words - w0 : stage;
    if (w0 > 0) stage_draws(w0, len);  // K > kDrawStage / kDrawTile
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
#pragma unroll 8
    for (int i = lane; i < len; i += kLanes) {
      const uint4 a = nodes[div32(w0 + i, K, k_recip)];
      if (a.y > 0) {
        const long long pos =
            static_cast<long long>(a.x) +
            mod32(static_cast<unsigned>(staged[i]), a.y, a.z);
        assert(pos < num_indices);
        cp_async4(staged + i, indices + pos);
      } else {
        staged[i] = static_cast<int>(a.x);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
#pragma unroll 8
    for (int i = lane; i < len; i += kLanes) ot[w0 + i] = staged[i];
    __syncwarp();
  }
}

// ---------------------------------------------------------------------
// gather_mean

constexpr int kGmWarps = 8;  // a block: its shared memory is their stages
constexpr int kGmThreads = kGmWarps * kLanes;
constexpr int kStageWords = 368;  // the most a warp's stage takes (5.75 KB)
constexpr int kTileCols = 128;    // output columns a pass: 4 a lane

__device__ __forceinline__ void bar_init(unsigned long long* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(b))
               : "memory");
}

// One arrival on b (the warp's lane 0) that expects `bytes` of copies.
__device__ __forceinline__ void bar_expect(unsigned long long* b,
                                           unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* b,
                                         unsigned phase) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(b)), "r"(phase)
        : "memory");
  } while (!done);
}

// A bulk copy of `bytes`, a multiple of 16, between 16-byte-aligned
// addresses, completing on mbarrier b.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(b))
      : "memory");
}

// VEC consecutive elements of a staged row, as f32, from shared memory at
// p (aligned to VEC elements where VEC == 4).
template <typename In, int VEC>
struct Staged;

template <>
struct Staged<float, 4> {
  static __device__ __forceinline__ void load(const char* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
};

template <>
struct Staged<float, 1> {
  static __device__ __forceinline__ void load(const char* p, float* v) {
    v[0] = *reinterpret_cast<const float*>(p);
  }
};

template <>
struct Staged<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const char* p, float* v) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(a.x << 16);
    v[1] = __uint_as_float(a.x & 0xffff0000u);
    v[2] = __uint_as_float(a.y << 16);
    v[3] = __uint_as_float(a.y & 0xffff0000u);
  }
};

template <>
struct Staged<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const char* p, float* v) {
    v[0] = __uint_as_float(
        static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(p))
        << 16);
  }
};

template <int VEC>
__device__ __forceinline__ void store(float* out, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    out[0] = v[0];
  }
}

// The output rows s of the grid's warps; rows `stride` 16-byte words apart
// in a warp's stage of `group` rows (dynamic shared memory, a stage a
// warp), as gather_mean_plan sets them.
template <typename In, int VEC>
__global__ void __launch_bounds__(kGmThreads)
gather_mean_kernel(const In* __restrict__ x, long long x_rows, int h,
                   const int* __restrict__ f, long long n, int K, int stride,
                   int group, float* __restrict__ x_self,
                   float* __restrict__ mean) {
  constexpr int kPer = kTileCols / kLanes;  // columns a lane a pass
  constexpr int kVecs = kPer / VEC;
  constexpr int es = sizeof(In);
  extern __shared__ __align__(128) uint4 stages[];
  __shared__ int ids_of[kGmWarps][kLanes];
  __shared__ float counts_of[kGmWarps][kLanes];
  __shared__ __align__(8) unsigned long long bars[kGmWarps];
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  uint4* stage = stages + warp * stride * group;
  int* ids = ids_of[warp];
  float* counts = counts_of[warp];
  unsigned long long* bar = bars + warp;
  if (lane == 0) {
    bar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  unsigned phase = 0;
  const uintptr_t x_begin = reinterpret_cast<uintptr_t>(x);
  const long long row_bytes = static_cast<long long>(h) * es;
  const uintptr_t x_end = x_begin + x_rows * row_bytes;
  const int ids_total = K + 1;
  const float div = static_cast<float>(K + 1);
  // Where row r's columns [e0, e0 + te) start in device memory.
  auto row_at = [&](int r, int e0) {
    return x_begin + static_cast<unsigned long long>(r) * row_bytes +
           static_cast<unsigned long long>(e0) * es;
  };
  for (long long s = static_cast<long long>(blockIdx.x) * kGmWarps + warp;
       s < n; s += static_cast<long long>(gridDim.x) * kGmWarps) {
    for (int e0 = 0; e0 < h; e0 += kTileCols) {
      const int te = h - e0 < kTileCols ? h - e0 : kTileCols;
      const unsigned span = static_cast<unsigned>(te) * es;
      float acc[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] = 0.0f;
      for (int c0 = 0; c0 < ids_total; c0 += kLanes) {
        // The chunk's ids, a lane each, merged: each distinct id at its
        // lowest lane, with its count, in lane order into ids / counts.
        const int i = c0 + lane;
        int id = -1;
        if (i < ids_total) {
          id = __ldg(i == 0 ? f + s : f + n + s * K + (i - 1));
          assert(id >= 0 && id < x_rows);
        }
        const unsigned same = __match_any_sync(kFullMask, id);
        const bool lead = i < ids_total && __ffs(same) - 1 == lane;
        const unsigned leaders = __ballot_sync(kFullMask, lead);
        const int distinct = __popc(leaders);
        if (lead) {
          const int rank = __popc(leaders & ((1u << lane) - 1u));
          ids[rank] = id;
          counts[rank] = static_cast<float>(__popc(same));
        }
        __syncwarp();
        for (int g0 = 0; g0 < distinct; g0 += group) {
          const int rows = distinct - g0 < group ? distinct - g0 : group;
          // Lane j copies row g0 + j's aligned window by one bulk copy,
          // or marks it for the lanes' copy at an end of the table.
          uintptr_t w0 = 0, w1 = 0;
          if (lane < rows) {
            const uintptr_t a = row_at(ids[g0 + lane], e0);
            w0 = a & ~uintptr_t(15);
            w1 = (a + span + 15) & ~uintptr_t(15);
          }
          const bool bulk = lane < rows && w0 >= x_begin && w1 <= x_end;
          const bool edge = lane < rows && !bulk;
          const unsigned bytes = __reduce_add_sync(
              kFullMask, bulk ? static_cast<unsigned>(w1 - w0) : 0u);
          // The stage's earlier reads and writes come before the copies'.
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          if (lane == 0) bar_expect(bar, bytes);
          __syncwarp();
          if (bulk) {
            bulk_copy(stage + lane * stride,
                      reinterpret_cast<const void*>(w0),
                      static_cast<unsigned>(w1 - w0), bar);
          }
          for (unsigned edges = __ballot_sync(kFullMask, edge); edges;
               edges &= edges - 1) {
            const int j = __ffs(edges) - 1;
            const unsigned long long a0 = __shfl_sync(
                kFullMask, static_cast<unsigned long long>(w0), j);
            const int words = static_cast<int>(
                (__shfl_sync(kFullMask, static_cast<unsigned long long>(w1),
                             j) -
                 a0) /
                16);
            for (int w = lane; w < words; w += kLanes) {
              unsigned short half[8];
#pragma unroll
              for (int m = 0; m < 8; ++m) {
                const unsigned long long p = a0 + 16 * w + 2 * m;
                half[m] = p >= x_begin && p < x_end
                              ? __ldg(reinterpret_cast<const unsigned short*>(
                                    p))
                              : static_cast<unsigned short>(0);
              }
              uint4 word;
              word.x = half[0] | (static_cast<unsigned>(half[1]) << 16);
              word.y = half[2] | (static_cast<unsigned>(half[3]) << 16);
              word.z = half[4] | (static_cast<unsigned>(half[5]) << 16);
              word.w = half[6] | (static_cast<unsigned>(half[7]) << 16);
              stage[j * stride + w] = word;
            }
          }
          bar_wait(bar, phase);
          phase ^= 1u;
          __syncwarp();
          // count * row, the distinct rows in lane order, 4 columns a
          // lane at a time.
          for (int j = 0; j < rows; ++j) {
            const float c = counts[g0 + j];
            const char* row =
                reinterpret_cast<const char*>(stage + j * stride) +
                (row_at(ids[g0 + j], e0) & 15);
#pragma unroll
            for (int q = 0; q < kVecs; ++q) {
              const int e = (q * kLanes + lane) * VEC;
              if (e < te) {
                float v[VEC];
                Staged<In, VEC>::load(row + e * es, v);
#pragma unroll
                for (int u = 0; u < VEC; ++u) {
                  acc[q * VEC + u] = fmaf(c, v[u], acc[q * VEC + u]);
                }
              }
            }
          }
          if (c0 == 0 && g0 == 0) {  // row 0 of the first stage: self
            const char* row = reinterpret_cast<const char*>(stage) +
                              (row_at(ids[0], e0) & 15);
#pragma unroll
            for (int q = 0; q < kVecs; ++q) {
              const int e = (q * kLanes + lane) * VEC;
              if (e < te) {
                float v[VEC];
                Staged<In, VEC>::load(row + e * es, v);
                store<VEC>(x_self + s * h + e0 + e, v);
              }
            }
          }
          __syncwarp();
        }
      }
#pragma unroll
      for (int q = 0; q < kVecs; ++q) {
        const int e = (q * kLanes + lane) * VEC;
        if (e < te) {
          float v[VEC];
#pragma unroll
          for (int u = 0; u < VEC; ++u) v[u] = acc[q * VEC + u] / div;
          store<VEC>(mean + s * h + e0 + e, v);
        }
      }
    }
  }
}

unsigned gcd16(unsigned long long v) {
  unsigned g = 16;
  while (v % g) g /= 2;
  return g;
}

// A warp's stage for table x and k draws: its rows' stride in 16-byte
// words (the longest aligned window of a pass's columns: a row starts at
// most `lead` bytes past a 16-byte boundary) and the rows it holds: an
// output's k + 1 ids (a chunk of 32 past 31 draws) where kStageWords
// allow. A smaller stage holds more warps an SM, so more rows in flight.
void gather_mean_plan(const void* x, int h, int es, int k, int* stride,
                      int* group) {
  const unsigned long long row_bytes = static_cast<unsigned long long>(h) * es;
  const unsigned g = gcd16(row_bytes);
  const unsigned lead =
      16 - g + static_cast<unsigned>(reinterpret_cast<uintptr_t>(x) % g);
  const int span = (h < kTileCols ? h : kTileCols) * es;
  *stride = static_cast<int>((lead + span + 15) / 16);
  int rows = kStageWords / *stride;
  if (rows > kLanes) rows = kLanes;
  *group = k + 1 < rows ? k + 1 : rows;
}

template <typename In, int VEC>
cudaError_t launch_gather_mean(const void* x, long long x_rows, int h,
                               const void* f, long long n, int k,
                               void* x_self, void* mean, cudaStream_t s) {
  auto kernel = gather_mean_kernel<In, VEC>;
  // The SM's split of shared memory and L1 leans to shared memory: the
  // stages are what holds more warps an SM (the rows are read once); and
  // the stages may pass the 48 KB a launch takes by default.
  static const cudaError_t prepared = [&] {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(uint4)) * kGmWarps * kStageWords);
  }();
  if (prepared != cudaSuccess) return prepared;
  int stride, group;
  gather_mean_plan(x, h, sizeof(In), k, &stride, &group);
  const long long blocks = (n + kGmWarps - 1) / kGmWarps;
  const size_t smem = sizeof(uint4) * kGmWarps * stride * group;
  kernel<<<static_cast<unsigned>(blocks), kGmThreads, smem, s>>>(
      static_cast<const In*>(x), x_rows, h, static_cast<const int*>(f), n, k,
      stride, group, static_cast<float*>(x_self), static_cast<float*>(mean));
  return cudaGetLastError();
}

}  // namespace

// The entries launch on `stream` (a cudaStream_t) on device `device`,
// return the cudaError_t of the launch, 0 on success, and do not
// synchronise. Every array is contiguous; the CSR is int32 indptr
// [num_nodes + 1] and indices [num_indices].

// dst int32 [d], its valid columns a prefix; draws int64 [k, d] in [0,
// 2^63); nbr int32 [k + 1, d]; owned_idx, self_idx int32 [out_cap],
// owned_deg f32 [out_cap], owned_mask bool [out_cap]; num_owned int32 [].
extern "C" int synthesize_innermost(
    const void* dst, long long d, const void* indptr, long long num_nodes,
    const void* indices, long long num_indices, const void* draws, int k,
    int out_cap, int zero_row, void* nbr, void* owned_idx, void* owned_deg,
    void* self_idx, void* owned_mask, void* num_owned, int device,
    void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d < 1 || d > 2147483647LL || k < 1 || out_cap < 0 || out_cap > d ||
      num_nodes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The SM gives shared memory all it can (the warps' stages), and a
  // block may take past the 48 KB a launch takes by default.
  static const cudaError_t prepared = [] {
    const cudaError_t err = cudaFuncSetAttribute(
        synthesize_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(
        synthesize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(synthesize_smem(kDrawRows)));
  }();
  if (prepared != cudaSuccess) return static_cast<int>(prepared);
  const int rows = k < kDrawRows ? k : kDrawRows;
  synthesize_kernel<<<
      static_cast<unsigned>((d + kSynThreads - 1) / kSynThreads),
      kSynThreads, synthesize_smem(rows), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(dst), static_cast<int>(d),
      static_cast<const int*>(indptr), num_nodes,
      static_cast<const int*>(indices), num_indices,
      static_cast<const long long*>(draws), k, rows, out_cap, zero_row,
      static_cast<int*>(nbr), static_cast<int*>(owned_idx),
      static_cast<float*>(owned_deg), static_cast<int*>(self_idx),
      static_cast<unsigned char*>(owned_mask), static_cast<int*>(num_owned));
  return static_cast<int>(cudaGetLastError());
}

// frontier int32 [n]; r int32 [n, k] in [0, 2^31), 1 <= k <= 2^25; out
// int32 [n * (1 + k)].
extern "C" int draw_neighbors(const void* frontier, long long n,
                              const void* indptr, long long num_nodes,
                              const void* indices, long long num_indices,
                              const void* r, int k, void* out, int device,
                              void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0 || k < 1 || k > kMaxDrawK || num_nodes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long block_rows = kDrawWarps * kDrawTile;
  const long long blocks = (n + block_rows - 1) / block_rows;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  // The split of shared memory and L1 stays the CUDA default: L1 holds the
  // runs a tile reads more than once (its repeated nodes); asking for all
  // the shared memory an SM gives was slower on the same card.
  const int stage =
      k < kDrawStage / kDrawTile ? kDrawTile * k : kDrawStage;
  draw_kernel<<<static_cast<unsigned>(blocks), kDrawThreads,
                sizeof(int) * kDrawWarps * stage,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(frontier), n, static_cast<const int*>(indptr),
      num_nodes, static_cast<const int*>(indices), num_indices,
      static_cast<const int*>(r), k, 0xffffffffu / static_cast<unsigned>(k),
      stage, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x f32 (x_bf16 == 0) or bf16 [x_rows, h]; f int32 [n * (1 + k)], k >= 1;
// x_self and mean f32 [n, h].
extern "C" int gather_mean(const void* x, int x_bf16, long long x_rows, int h,
                           const void* f, long long n, int k, void* x_self,
                           void* mean, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (h < 0 || n < 0 || k < 1 || x_rows < 1 ||
      (n + kGmWarps - 1) / kGmWarps > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || h == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool out16 = aligned(x_self, 16) && aligned(mean, 16);
  cudaError_t e;
  if (x_bf16) {
    e = h % 4 == 0 && aligned(x, 8) && out16
            ? launch_gather_mean<__nv_bfloat16, 4>(x, x_rows, h, f, n, k,
                                                   x_self, mean, s)
            : launch_gather_mean<__nv_bfloat16, 1>(x, x_rows, h, f, n, k,
                                                   x_self, mean, s);
  } else {
    e = h % 4 == 0 && aligned(x, 16) && out16
            ? launch_gather_mean<float, 4>(x, x_rows, h, f, n, k, x_self,
                                           mean, s)
            : launch_gather_mean<float, 1>(x, x_rows, h, f, n, k, x_self,
                                           mean, s);
  }
  return static_cast<int>(e);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
