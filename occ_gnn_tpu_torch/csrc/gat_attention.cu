// GAT's dense attention for Hopper (sm_90a): split GAT's local softmax
// partials through the dense [K, D] neighbour matrix, forward and backward,
// one launch each.
//
//   gat_attention_fwd: for each dst column d and head c, over the slots k
//     whose nbr[k, d] is not the zero row S - 1,
//       z[k, c]   = leaky_relu(x[nbr[k, d]] . wl[:, c] + er[d, c], slope)
//       m[d, c]   = max over k of z[k, c]             (-inf with no slot)
//       pw[k, c]  = exp(z[k, c] - m[d, c])
//       s[d, c]   = sum over k of pw[k, c]
//       agg[d, c, :] = sum over k of pw[k, c] * x[nbr[k, d], :]
//   gat_attention_bwd: from m and the gradients ds [D, heads] and dagg [D,
//     heads, H], recomputing z and pw,
//       dpw[k, c] = ds[d, c] + dagg[d, c, :] . x[nbr[k, d], :]
//       dpre[k, c] = pw[k, c] * dpw[k, c] * (pre > 0 ? 1 : slope)
//       der[d, c] = sum over k of dpre[k, c], in slot order
//       dwl[:, c] += x[nbr[k, d], :] * dpre[k, c]  (a partial a block, or
//                                                   a warp: `_any`)
//       dxg[k * D + d, :] = sum over c of pw[k, c] * dagg[d, c, :]
//                          + sum over c of dpre[k, c] * wl[:, c]
//     (dxg only where asked for, and only for valid slots: a padding
//     slot's row is not written, and the per-slot scatter does not read it).
//
// x is f32 or bf16 [S, H] row-major, its last row the frame's reserved zero
// row that padding slots name; nbr int32 [K, D] k-major; wl f32 [H, heads];
// er, m, s, ds, der f32 [D, heads]; agg, dagg f32 [D, heads, H]; dxg f32
// [K * D, H]; dwl_part f32 [partials, H, heads]. Under a bf16 frame wl and the
// pw that multiplies a leaf are rounded to bf16 (and dagg . leaf in dpw, as
// autograd rounds a gradient through a bf16 tensor), and every sum is f32:
// what the plain version (ops/gat_attention.py) computes.
//
// Replaces: occ_gnn_tpu/parallel/model.py:294-363, the batched branch of
// SplitGAT.layer, which XLA lowers (no pallas_call): it gathers the
// [K, D, H] leaves x[nbr] whole and keeps them, the scores and the weights
// for the backward.
//
// Bound: device-memory bytes. Each valid slot's leaf row is read (400 B at
// split GAT A's layer 0) for a few multiply-adds a byte; the forward writes
// agg (heads f32 rows a column), the backward reads dagg and, past layer 0,
// writes a row a valid slot. The leaves never reach device memory.
//
// Design: a block owns a tile of `tile` consecutive dst columns at a time,
// a warp each; the grid is persistent, block b taking tiles b, b + grid,
// ... (a static order: dwl's partials come out the same over two
// launches). A warp copies every valid slot's leaf row of its column into
// its own stage of shared memory at once, by bulk copies (the Tensor
// Memory Accelerator, cp.async.bulk: one a lane, the row's 16-byte-aligned
// window, completing on an mbarrier), and reads the leaves from there
// only: each leaf leaves device memory once, and padding slots' rows (the
// zero row) are not copied. Its next column's rows (and the slot ids of
// the one after, 4-byte cp.async; the tile's warps share each sector of a
// row of nbr through L1) are in flight while it computes on this one, in
// a ring of kStages stages; warps never wait on each other but at the
// start and the end. Staged rows are an odd number of 16 bytes apart, so
// that lanes reading one 16-byte unit of different rows hit different
// banks. Bulk copies, not per-lane cp.async, carry the rows: with the
// latter the copies' issue held the forward back by a third (PERF.md
// §6); 4-byte cp.async carry the slot ids and an unaligned dagg. A
// deeper ring (fewer warps in the same shared memory) was slower.
//   * forward: lanes take the valid slots (as many lanes a slot as fit,
//     their partial sums added in a fixed order) and sum the scores over
//     the row in f64, wl read as f64 from shared memory, rounded to f32
//     once (the plain version's f64 sums: the same leaky ReLU slope near
//     0); the exact max across the warp; the valid slots' weights in
//     shared memory; then lanes take the row's read units and add the
//     weighted leaves of the valid slots in slot order, heads in registers,
//     and (lane 0) s beside them in slot order; agg, m and s written once.
//     A column no slot names writes m = -inf and zeros: every column of
//     the grid is written.
//   * backward: the column's dagg rows go by the same bulk copies. Lanes
//     take the valid slots and recompute the score (f64) and dagg . leaf
//     (f32) from shared memory into dpre and the rounded pw; then lanes
//     take the row's read units and, valid slots in order, add leaf * dpre
//     for dwl and der, and past layer 0 write each valid slot's dx row
//     (pw . dagg + dpre . wl). dwl's sums go into the warp's partial in
//     shared memory once a column, are added over the warps in order at
//     the end and written once a block (no float atomics; the wrapper adds
//     the blocks' partials in a fixed order).
// Any head count: heads go in groups of 4 (the unused ones of the last
// group never written; past the first group a lane adds its group's part
// of a dx row into the row it wrote). Rows shorter than 16 bytes are
// copied by the lanes. Where a whole column does not fit shared memory, or
// fits it with too few warps an SM to hide the shared-memory and f64
// latencies (wide rows, many heads or slots: the wrapper's plan decides,
// and passes a null layout), the `_any` kernels take it: a warp a column,
// 8 warps a block, walking the slots kBatch at a time with their rows'
// loads in flight together, the row in tiles of 128 columns and the heads
// in groups of 4, a leaf read once a tile and group in each pass (L1 or L2
// after the first), wl and dagg read through L1, the scores' maxima and
// sums taken from shared memory; the same sums in the same orders. Their
// backward keeps a column's dpre in shared memory, adds dwl's sums over
// the column's slots into the warp's partial in dwl_part a tile and group
// at a time (a partial a warp), and walks the columns strided over its
// grid.
//
// The staged kernels' shared memory is laid out by the wrapper
// (ops/gat_attention.py, `layout`), which passes the Layout below; the
// entries check that it fits a block and matches the frame.

#include <assert.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxWarps = 8;  // a block: one dst column of a tile a warp
constexpr int kHeadGroup = 4;
// A warp's ring: staged columns, and one more of slot ids (the layout's
// `stages`, checked; a compile-time count keeps the ring's index
// arithmetic to shifts and masks).
constexpr unsigned kStages = 2;
constexpr unsigned kSmemBlock = 232448;  // a block's most on sm_90
// Shared memory a block may take without opting in to more.
constexpr unsigned kSmemDefault = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;
// The `_any` kernels: a block's warps (a dst column each), its row tile
// (32 * kAnyJ columns), its head group, and the slots a warp loads at
// once, their rows in flight together.
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kAnyJ = 4;
constexpr int kTile = 32 * kAnyJ;
constexpr int kAnyHeads = 4;
constexpr int kBatch = 4;

// Where everything sits in a staged kernel's shared memory (bytes), and
// how a staged row is laid out, as the wrapper (ops/gat_attention.py,
// `layout`, its LAYOUT_FIELDS in this order) plans it.
struct Layout {
  int read;    // read unit, bytes: the widest of 16, 8, 4, 2 dividing the
               // row's bytes and the frame's address alignment
  int bulk;    // rows of 16 bytes or more: bulk copies of their windows
  int stride;  // bytes between staged rows: an odd number of 16 bytes
  int nvec;    // read units a row
  int groups;  // head groups
  int wunit;   // doubles of wl64 a read unit: its E elements' 4 heads and
               // 16 bytes, so that lanes reading wl for units j, j + 1,
               // ... at once hit different banks
  int stages;  // a warp's ring's stages: kStages
  int wl64;    // block: wl in f64 [groups][nvec][wunit]
  int wl32;    // backward, block: wl in f32 [groups * 4][h]
  // a warp's, from `warp` on, `per_warp` bytes each:
  int rows;    // [stages][K][stride]
  int dagg;    // backward: [stages][heads][h] f32, 16-byte stages
  int ids;     // [stages + 1][K] int32
  int z;       // [K][groups][4] f32: scores, then weights (bwd: dpre)
  int pw;      // backward: [K][groups][4] f32 rounded weights
  int dwl;     // backward: [groups][h][4] f32 partial
  int bar;     // [stages] mbarriers of the bulk copies
  int dstage;  // backward: bytes a dagg stage
  int warp, per_warp, total;
};

// Both kernels' arguments.
struct Args {
  const void* x;
  long long x_rows;
  int h;
  const int* nbr;
  int K;
  long long D;
  const float* wl;
  const float* er;
  int heads;
  float slope;
  int tile;
  long long tiles;
  Layout L;
  // forward
  float* m_out;
  float* s_out;
  float* agg;
  // backward
  const float* m;
  const float* ds;
  const float* dagg;
  int dagg_bulk;  // dagg's columns by one bulk copy each
  float* der;
  float* dwl_part;
  float* dxg;  // nullptr: no gradient to x
};

// A frame element as f32, and an f32 rounded as the frame's type.
template <typename In>
struct Frame;

template <>
struct Frame<float> {
  static __device__ __forceinline__ float load(const void* x, long long i) {
    return __ldg(static_cast<const float*>(x) + i);
  }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Frame<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const void* x, long long i) {
    const unsigned short raw =
        __ldg(static_cast<const unsigned short*>(x) + i);
    return __bfloat162float(__ushort_as_bfloat16(raw));
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

__device__ __forceinline__ float leaky(float pre, float slope) {
  return pre > 0.f ? pre : slope * pre;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An asynchronous copy of 4 bytes from device memory into shared memory.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The bulk copies' mbarriers: one arrival a phase (the warp's lane 0,
// with the phase's bytes), the copies completing the bytes.
__device__ __forceinline__ void bar_init(unsigned long long* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(b))
               : "memory");
}

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

// A bulk copy (the Tensor Memory Accelerator) of `bytes`, a multiple of 16,
// between 16-byte-aligned addresses, completing on mbarrier b.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(b))
      : "memory");
}

// Unpack bf16 pairs of a 32-bit word, the first at the lower address.
__device__ __forceinline__ float bf_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// The E = V / sizeof(In) elements of one read unit of V bytes at p, as f32.
template <typename In, int V>
struct Unit {
  static constexpr int E = V / static_cast<int>(sizeof(In));
  static __device__ __forceinline__ void load(const unsigned char* p,
                                              float (&v)[E]) {
    if constexpr (std::is_same<In, float>::value) {
      if constexpr (V == 16) {
        const float4 f = *reinterpret_cast<const float4*>(p);
        v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
      } else if constexpr (V == 8) {
        const float2 f = *reinterpret_cast<const float2*>(p);
        v[0] = f.x, v[1] = f.y;
      } else {
        v[0] = *reinterpret_cast<const float*>(p);
      }
    } else {
      if constexpr (V == 16) {
        const uint4 u = *reinterpret_cast<const uint4*>(p);
        const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[2 * i] = bf_lo(w[i]);
          v[2 * i + 1] = bf_hi(w[i]);
        }
      } else if constexpr (V == 8) {
        const uint2 u = *reinterpret_cast<const uint2*>(p);
        v[0] = bf_lo(u.x), v[1] = bf_hi(u.x), v[2] = bf_lo(u.y),
        v[3] = bf_hi(u.y);
      } else if constexpr (V == 4) {
        const unsigned u = *reinterpret_cast<const unsigned*>(p);
        v[0] = bf_lo(u), v[1] = bf_hi(u);
      } else {
        const unsigned short u = *reinterpret_cast<const unsigned short*>(p);
        v[0] = __uint_as_float(static_cast<unsigned>(u) << 16);
      }
    }
  }
};

// E consecutive f32 at p, aligned to 4 E bytes (16 for E >= 4).
template <int E>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + i);
      v[i] = f.x, v[i + 1] = f.y, v[i + 2] = f.z, v[i + 3] = f.w;
    }
  } else if constexpr (E == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x, v[1] = f.y;
  } else {
    v[0] = *p;
  }
}

template <int E>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E; i += 4) {
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
  } else if constexpr (E == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A warp's shared memory, by the layout.
struct Warp {
  unsigned char* rows;
  float* dagg;
  int* ids;
  float* z;
  float* pw;
  float* dwl;
  __device__ Warp(unsigned char* smem, const Layout& L, int warp) {
    unsigned char* base = smem + L.warp + static_cast<size_t>(warp) *
                                               L.per_warp;
    rows = base + L.rows;
    dagg = reinterpret_cast<float*>(base + L.dagg);
    ids = reinterpret_cast<int*>(base + L.ids);
    z = reinterpret_cast<float*>(base + L.z);
    pw = reinterpret_cast<float*>(base + L.pw);
    dwl = reinterpret_cast<float*>(base + L.dwl);
    bar = reinterpret_cast<unsigned long long*>(base + L.bar);
  }
  unsigned long long* bar;
};

// wl rounded as the frame's type, in f64 [groups][nvec][wunit] (element e
// of unit j, head c of group g at (g * nvec + j) * wunit + e * 4 + c; zero
// past heads), and (wl32 not null) in f32 [groups * 4][h], by the whole
// block.
template <typename In>
__device__ __forceinline__ void stage_weights(const Args& a, double* wl64,
                                              float* wl32) {
  const int n = a.L.groups * kHeadGroup * a.h;
  const int E = a.h / a.L.nvec;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = i / a.h, col = i - c * a.h;
    const float w =
        c < a.heads ? Frame<In>::round(__ldg(a.wl + col * a.heads + c)) : 0.f;
    const int j = col / E, e = col - j * E;
    wl64[(c / kHeadGroup * a.L.nvec + j) * a.L.wunit + e * kHeadGroup +
         c % kHeadGroup] = w;
    if (wl32 != nullptr) wl32[i] = w;
  }
}

// Column d's K slot ids into ids, by the warp.
__device__ __forceinline__ void stage_ids(const Args& a, int* ids,
                                          long long d, int lane) {
  for (int k = lane; k < a.K; k += 32) {
    cp_async4(ids + k, a.nbr + static_cast<long long>(k) * a.D + d);
  }
}

// Byte offset of row r's first element in its staged window (0 for rows
// of whole 16-byte units on 16-byte boundaries).
template <typename In, int V>
__device__ __forceinline__ int window_shift(const Args& a, int r) {
  if constexpr (V == 16) {
    return 0;
  } else {
    return a.L.bulk ? static_cast<int>(
                          (reinterpret_cast<uintptr_t>(a.x) +
                           static_cast<unsigned long long>(r) * a.h *
                               sizeof(In)) & 15)
                    : 0;
  }
}

// Column d's valid slots' leaf rows into `rows` and, when dagg_dst is not
// null, its dagg [heads][h] into dagg_dst, by the warp. Rows of 16 bytes or
// more go by bulk copies of their 16-byte-aligned windows, one a lane,
// completing on mbarrier b with dagg's bulk copy; padding slots' rows are
// not copied (an id outside [0, S) stops the kernel with a device-side
// assert, as torch.index_select does on the card). Shorter rows are copied
// by the lanes, and a dagg that is not 16-byte aligned by 4-byte cp.async.
template <typename In>
__device__ __forceinline__ void stage_column(const Args& a, const int* ids,
                                             unsigned char* rows,
                                             float* dagg_dst, long long d,
                                             unsigned long long* b,
                                             int lane) {
  const int zero_row = static_cast<int>(a.x_rows - 1);
  const unsigned rowbytes = a.h * sizeof(In);
  const unsigned dbytes = 4u * a.heads * a.h;
  const uintptr_t x = reinterpret_cast<uintptr_t>(a.x);
  unsigned bytes = 0;
  for (int k = lane; k < a.K; k += 32) {
    const int r = ids[k];
    assert(r >= 0 && r < a.x_rows);
    if (r != zero_row && a.L.bulk) {
      const uintptr_t at = x + static_cast<unsigned long long>(r) * rowbytes;
      bytes += static_cast<unsigned>(((at + rowbytes + 15) & ~uintptr_t(15)) -
                                     (at & ~uintptr_t(15)));
    }
  }
  if (lane == 0 && dagg_dst != nullptr && a.dagg_bulk) bytes += dbytes;
  bytes = __reduce_add_sync(kFull, bytes);
  // The stage's earlier reads come before the copies' writes.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (lane == 0) bar_expect(b, bytes);
  __syncwarp();
  if (a.L.bulk) {
    for (int k = lane; k < a.K; k += 32) {
      const int r = ids[k];
      if (r == zero_row) continue;
      const uintptr_t at = x + static_cast<unsigned long long>(r) * rowbytes;
      const uintptr_t from = at & ~uintptr_t(15);
      bulk_copy(rows + static_cast<size_t>(k) * a.L.stride,
                reinterpret_cast<const void*>(from),
                static_cast<unsigned>(((at + rowbytes + 15) & ~uintptr_t(15)) -
                                      from),
                b);
    }
  } else {
    for (int k = 0; k < a.K; ++k) {
      const int r = ids[k];
      if (r == zero_row) continue;
      const unsigned short* src = reinterpret_cast<const unsigned short*>(
          x + static_cast<unsigned long long>(r) * rowbytes);
      unsigned short* dst = reinterpret_cast<unsigned short*>(
          rows + static_cast<size_t>(k) * a.L.stride);
      for (unsigned i = lane; i < rowbytes / 2; i += 32) dst[i] = src[i];
    }
  }
  if (dagg_dst == nullptr) return;
  const float* src = a.dagg + d * a.heads * a.h;
  if (a.dagg_bulk) {
    if (lane == 0) bulk_copy(dagg_dst, src, dbytes, b);
  } else {
    for (int i = lane; i < a.heads * a.h; i += 32) {
      cp_async4(dagg_dst + i, src + i);
    }
  }
}

// The warp's ring: the slot ids of its n-th column at ids(n), its rows in
// stage n % kStages, completing on bar(n).
struct Ring {
  const Warp& sm;
  int K, stride, dfloats;
  __device__ int* ids(unsigned n) const {
    return sm.ids + n % (kStages + 1) * K;
  }
  __device__ unsigned char* rows(unsigned n) const {
    return sm.rows + static_cast<size_t>(n % kStages) * K * stride;
  }
  __device__ float* dagg(unsigned n) const {
    return sm.dagg + n % kStages * dfloats;
  }
  __device__ unsigned long long* bar(unsigned n) const {
    return sm.bar + n % kStages;
  }
};

// This warp's k-th column (-1 past its last): block b's warp w takes column
// w of tiles b, b + grid, ...
__device__ __forceinline__ long long column(const Args& a, int warp,
                                            unsigned n) {
  const long long tile = blockIdx.x + n * gridDim.x;
  const long long d = tile * a.tile + warp;
  return tile < a.tiles && d < a.D ? d : -1;
}

// The ring's first columns: the slot ids of columns 0 .. kStages - 1, then
// the rows (and, `bwd`, dagg) of columns 0 .. kStages - 2.
template <typename In>
__device__ __forceinline__ void fill(const Args& a, const Ring& ring,
                                     int warp, int lane, bool bwd) {
  for (unsigned i = 0; i < kStages; ++i) {
    const long long c = column(a, warp, i);
    if (c >= 0) stage_ids(a, ring.ids(i), c, lane);
  }
  cp_commit();
  cp_wait_all();
  __syncwarp();
  for (unsigned i = 0; i + 1 < kStages; ++i) {
    const long long c = column(a, warp, i);
    if (c >= 0) {
      stage_column<In>(a, ring.ids(i), ring.rows(i),
                       bwd ? ring.dagg(i) : nullptr, c, ring.bar(i), lane);
    }
  }
  cp_commit();
}

// Before the warp computes its n-th column: wait for its copies, then start
// the rows (and dagg) of column n + kStages - 1, whose slot ids are in, and
// the slot ids of column n + kStages.
template <typename In>
__device__ __forceinline__ void advance(const Args& a, const Ring& ring,
                                        int warp, int lane, unsigned n,
                                        bool bwd) {
  cp_wait_all();
  bar_wait(ring.bar(n), n / kStages & 1);
  __syncwarp();
  const unsigned m = n + kStages - 1;
  const long long c1 = column(a, warp, m);
  if (c1 >= 0) {
    stage_column<In>(a, ring.ids(m), ring.rows(m),
                     bwd ? ring.dagg(m) : nullptr, c1, ring.bar(m), lane);
  }
  const long long c2 = column(a, warp, m + 1);
  if (c2 >= 0) stage_ids(a, ring.ids(m + 1), c2, lane);
  cp_commit();
}

// The column's valid slots in order: the one after slot k (k = -1: the
// first; K past the last), from the bits of `mask` (the warp's ballot of
// its valid slots, taken where its lanes are converged) when K <= 32, else
// from the ids.
__device__ __forceinline__ int next_slot(const Args& a, const int* ids,
                                         unsigned mask, int k) {
  if (a.K <= 32) {
    const unsigned rest =
        k < 0 ? mask : (k >= 31 ? 0u : mask & (~0u << (k + 1)));
    return rest != 0 ? __ffs(rest) - 1 : a.K;
  }
  const int zero_row = static_cast<int>(a.x_rows - 1);
  for (++k; k < a.K && ids[k] == zero_row; ++k) {
  }
  return k;
}

// How the warp's lanes take a column's slots in the slot steps: for K <= 32
// its valid slots only, in order, lps lanes a slot (the most that fit, a
// power of two; lanes 32 / lps apart); for larger K every slot, a lane
// each, in passes of 32.
struct SlotMap {
  int lps, spp, slot, sub, passes;
  unsigned mask;
  __device__ SlotMap(const Args& a, unsigned vmask, int lane) : mask(vmask) {
    lps = 1;
    passes = (a.K + 31) / 32;
    if (a.K <= 32) {
      const int nv = __popc(vmask);
      while (lps < 32 && nv * lps * 2 <= 32) lps *= 2;
      passes = nv > 0 ? 1 : 0;
    }
    spp = 32 / lps;
    slot = lane % spp;
    sub = lane / spp;
  }
  // This lane's slot in pass p, or -1.
  __device__ int at(const Args& a, const int* ids, int p) const {
    if (a.K <= 32) {
      return slot < __popc(mask) ? static_cast<int>(__fns(mask, 0, slot + 1))
                                 : -1;
    }
    const int k = p * 32 + slot;
    return k < a.K && ids[k] != static_cast<int>(a.x_rows - 1) ? k : -1;
  }
};

// A slot step's sums for the lanes of a slot (sub-lane `sub` of `lps`,
// lanes 32 / lps apart, the read units sub, sub + lps, ... of the row at
// `row`): the f64 sums of leaf
// . wl[:, g * 4 + c], and in the backward (Bwd) the f32 sums of leaf .
// dagg[d, g * 4 + c, :] from the column's staged dagg `ga` (heads past
// `heads` left at 0); then the slot's lanes' sums added in a fixed order
// (sub-lane 0's first), every lane of the slot holding the same bits.
template <typename In, int V, bool Bwd>
__device__ __forceinline__ void slot_sums(const Args& a, const double* wl64,
                                          int g, const unsigned char* row,
                                          bool valid, int sub, int lps,
                                          const float* ga, double (&t)[4],
                                          float (&u)[4]) {
  using R = Unit<In, V>;
  constexpr int E = R::E;
  const Layout& L = a.L;
#pragma unroll
  for (int c = 0; c < 4; ++c) t[c] = 0.0, u[c] = 0.f;
  const double* w = wl64 + static_cast<long long>(g) * L.nvec * L.wunit;
  const int hc = a.heads - g * kHeadGroup;  // heads of this group, >= 1
  if (valid) {
#pragma unroll 2
    for (int j = sub; j < L.nvec; j += lps) {
      float v[E];
      R::load(row + j * V, v);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const double* we = w + j * L.wunit + e * kHeadGroup;
        const double lv = static_cast<double>(v[e]);
        const double2 w01 = *reinterpret_cast<const double2*>(we);
        const double2 w23 = *reinterpret_cast<const double2*>(we + 2);
        t[0] = fma(lv, w01.x, t[0]);
        t[1] = fma(lv, w01.y, t[1]);
        t[2] = fma(lv, w23.x, t[2]);
        t[3] = fma(lv, w23.y, t[3]);
      }
      if constexpr (Bwd) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c < hc) {
            float gv[E];
            load_f32<E>(ga + (g * kHeadGroup + c) * a.h + j * E, gv);
#pragma unroll
            for (int e = 0; e < E; ++e) u[c] = fmaf(v[e], gv[e], u[c]);
          }
        }
      }
    }
  }
  const int spp = 32 / lps;
  for (int o = 1; o < lps; o *= 2) {
    const bool upper = sub & o;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const double tc = __shfl_xor_sync(kFull, t[c], o * spp);
      t[c] = upper ? tc + t[c] : t[c] + tc;
      if constexpr (Bwd) {
        const float uc = __shfl_xor_sync(kFull, u[c], o * spp);
        u[c] = upper ? uc + u[c] : u[c] + uc;
      }
    }
  }
}

template <typename In, int V>
__global__ void __launch_bounds__(32 * kMaxWarps, 2) attention_fwd(Args a) {
  using R = Unit<In, V>;
  constexpr int E = R::E;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout& L = a.L;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int zero_row = static_cast<int>(a.x_rows - 1);
  double* wl64 = reinterpret_cast<double*>(smem + L.wl64);
  Warp sm(smem, L, warp);
  stage_weights<In>(a, wl64, nullptr);
  if (lane == 0) {
    for (unsigned i = 0; i < kStages; ++i) bar_init(sm.bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (column(a, warp, 0) < 0) return;
  const Ring ring{sm, a.K, L.stride, 0};
  fill<In>(a, ring, warp, lane, false);
  long long d;
  for (unsigned n = 0; (d = column(a, warp, n)) >= 0; ++n) {
    advance<In>(a, ring, warp, lane, n, false);
    const int* ids = ring.ids(n);
    const unsigned char* rows = ring.rows(n);
    const unsigned vmask =
        __ballot_sync(kFull, lane < a.K && ids[lane] != zero_row);
    const SlotMap map(a, vmask, lane);
    for (int g = 0; g < L.groups; ++g) {
      float* zg = sm.z + g * 4;  // slot k's at zg + k * groups * 4
      float er[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int cc = g * kHeadGroup + c;
        er[c] = cc < a.heads ? __ldg(a.er + d * a.heads + cc) : 0.f;
      }
      // The scores, the lanes of a slot over its row, and their max.
      float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
      for (int p = 0; p < map.passes; ++p) {
        const int k = map.at(a, ids, p);
        const bool valid = k >= 0;
        double t[4];
        float unused[4];
        slot_sums<In, V, false>(
            a, wl64, g,
            rows + static_cast<size_t>(valid ? k : 0) * L.stride +
                (valid ? window_shift<In, V>(a, ids[k]) : 0),
            valid, map.sub, map.lps, nullptr, t, unused);
        if (valid) {
          float z[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            z[c] = leaky(static_cast<float>(t[c] + static_cast<double>(er[c])),
                         a.slope);
            mx[c] = fmaxf(mx[c], z[c]);
          }
          if (map.sub == 0) {
            *reinterpret_cast<float4*>(zg + k * L.groups * 4) =
                make_float4(z[0], z[1], z[2], z[3]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int o = 16; o > 0; o /= 2) {
          mx[c] = fmaxf(mx[c], __shfl_xor_sync(kFull, mx[c], o));
        }
      }
      __syncwarp();
      // The weights of the valid slots, in place.
      for (int k = lane; k < a.K; k += 32) {
        if (ids[k] == zero_row) continue;
        float* zk = zg + k * L.groups * 4;
        const float4 z = load4(zk);
        *reinterpret_cast<float4*>(zk) =
            make_float4(expf(z.x - mx[0]), expf(z.y - mx[1]),
                        expf(z.z - mx[2]), expf(z.w - mx[3]));
      }
      __syncwarp();
      // The weighted leaves, lanes over the row's units, valid slots in
      // order, and (lane 0) the weights' sums beside them.
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = lane; j < L.nvec; j += 32) {
        float acc[4][E];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int e = 0; e < E; ++e) acc[c][e] = 0.f;
        }
#pragma unroll 2
        for (int k = next_slot(a, ids, vmask, -1); k < a.K;
             k = next_slot(a, ids, vmask, k)) {
          float v[E];
          R::load(rows + static_cast<size_t>(k) * L.stride +
                      window_shift<In, V>(a, ids[k]) + j * V,
                  v);
          const float4 p = load4(zg + k * L.groups * 4);
          if (j == lane) s[0] += p.x, s[1] += p.y, s[2] += p.z, s[3] += p.w;
          const float pc[4] = {Frame<In>::round(p.x), Frame<In>::round(p.y),
                               Frame<In>::round(p.z), Frame<In>::round(p.w)};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
#pragma unroll
            for (int e = 0; e < E; ++e) {
              acc[c][e] = fmaf(pc[c], v[e], acc[c][e]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int cc = g * kHeadGroup + c;
          if (cc < a.heads) {
            store_f32<E>(a.agg + (d * a.heads + cc) * a.h + j * E, acc[c]);
          }
        }
      }
      if (lane == 0) {  // lane 0 summed s over every valid slot
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (g * kHeadGroup + c < a.heads) {
            const long long at = d * a.heads + g * kHeadGroup + c;
            a.m_out[at] = mx[c];
            a.s_out[at] = s[c];
          }
        }
      }
      __syncwarp();
    }
  }
}

template <typename In, int V>
__global__ void __launch_bounds__(32 * kMaxWarps, 2) attention_bwd(Args a) {
  using R = Unit<In, V>;
  constexpr int E = R::E;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout& L = a.L;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int zero_row = static_cast<int>(a.x_rows - 1);
  double* wl64 = reinterpret_cast<double*>(smem + L.wl64);
  float* wl32 = reinterpret_cast<float*>(smem + L.wl32);
  Warp sm(smem, L, warp);
  stage_weights<In>(a, wl64, wl32);
  for (int i = lane; i < L.groups * a.h * 4; i += 32) sm.dwl[i] = 0.f;
  if (lane == 0) {
    for (unsigned i = 0; i < kStages; ++i) bar_init(sm.bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const Ring ring{sm, a.K, L.stride, L.dstage / 4};
  fill<In>(a, ring, warp, lane, true);
  long long d;
  for (unsigned n = 0; (d = column(a, warp, n)) >= 0; ++n) {
    advance<In>(a, ring, warp, lane, n, true);
    const int* ids = ring.ids(n);
    const unsigned char* rows = ring.rows(n);
    const unsigned vmask =
        __ballot_sync(kFull, lane < a.K && ids[lane] != zero_row);
    const SlotMap map(a, vmask, lane);
    const float* ga = ring.dagg(n);
    for (int g = 0; g < L.groups; ++g) {
      const int hc = a.heads - g * kHeadGroup;
      float* dg = sm.z + g * 4;   // slot k's dpre at dg + k * groups * 4
      float* pg = sm.pw + g * 4;  // and its rounded pw
      float er[4], mm[4], ds[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long at = d * a.heads + g * kHeadGroup + c;
        er[c] = c < hc ? __ldg(a.er + at) : 0.f;
        mm[c] = c < hc ? __ldg(a.m + at) : 0.f;
        ds[c] = c < hc ? __ldg(a.ds + at) : 0.f;
      }
      // dpre and the rounded pw of the valid slots, the lanes of a slot
      // over its row (0 past heads).
      for (int p = 0; p < map.passes; ++p) {
        const int k = map.at(a, ids, p);
        const bool valid = k >= 0;
        double tp[4];
        float ta[4];
        slot_sums<In, V, true>(
            a, wl64, g,
            rows + static_cast<size_t>(valid ? k : 0) * L.stride +
                (valid ? window_shift<In, V>(a, ids[k]) : 0),
            valid, map.sub, map.lps, ga, tp, ta);
        if (valid && map.sub == 0) {
          float dp[4] = {0.f, 0.f, 0.f, 0.f}, pc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (c < hc) {
              const float pre =
                  static_cast<float>(tp[c] + static_cast<double>(er[c]));
              const float pe = expf(leaky(pre, a.slope) - mm[c]);
              dp[c] = pe * (ds[c] + Frame<In>::round(ta[c])) *
                      (pre > 0.f ? 1.f : a.slope);
              pc[c] = Frame<In>::round(pe);
            }
          }
          *reinterpret_cast<float4*>(dg + k * L.groups * 4) =
              make_float4(dp[0], dp[1], dp[2], dp[3]);
          *reinterpret_cast<float4*>(pg + k * L.groups * 4) =
              make_float4(pc[0], pc[1], pc[2], pc[3]);
        }
      }
      __syncwarp();
      // dwl's sums and der in slot order, and the dx rows, lanes over the
      // row's units.
      float der[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = lane; j < L.nvec; j += 32) {
        float acc[4][E], w[4][E];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int e = 0; e < E; ++e) acc[c][e] = 0.f;
          if (a.dxg != nullptr) {
            load_f32<E>(wl32 + (g * kHeadGroup + c) * a.h + j * E, w[c]);
          }
        }
#pragma unroll 2
        for (int k = next_slot(a, ids, vmask, -1); k < a.K;
             k = next_slot(a, ids, vmask, k)) {
          float v[E];
          R::load(rows + static_cast<size_t>(k) * L.stride +
                      window_shift<In, V>(a, ids[k]) + j * V,
                  v);
          const float4 dp4 = load4(dg + k * L.groups * 4);
          const float dp[4] = {dp4.x, dp4.y, dp4.z, dp4.w};
          if (j == lane) {
#pragma unroll
            for (int c = 0; c < 4; ++c) der[c] += dp[c];
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
#pragma unroll
            for (int e = 0; e < E; ++e) acc[c][e] = fmaf(v[e], dp[c], acc[c][e]);
          }
          if (a.dxg == nullptr) continue;
          const float4 pw4 = load4(pg + k * L.groups * 4);
          const float pc[4] = {pw4.x, pw4.y, pw4.z, pw4.w};
          float o[E];
#pragma unroll
          for (int e = 0; e < E; ++e) o[e] = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (c < hc) {
              float gv[E];
              load_f32<E>(ga + (g * kHeadGroup + c) * a.h + j * E, gv);
#pragma unroll
              for (int e = 0; e < E; ++e) o[e] = fmaf(pc[c], gv[e], o[e]);
            }
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
#pragma unroll
            for (int e = 0; e < E; ++e) o[e] = fmaf(dp[c], w[c][e], o[e]);
          }
          float* out =
              a.dxg + ((static_cast<long long>(k) * a.D + d) * a.h + j * E);
          if (g > 0) {  // this lane wrote the row's earlier groups' part
            float prev[E];
            load_f32<E>(out, prev);
#pragma unroll
            for (int e = 0; e < E; ++e) o[e] += prev[e];
          }
          store_f32<E>(out, o);
        }
        float* part = sm.dwl + (static_cast<long long>(g) * a.h + j * E) * 4;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float4 p = load4(part + e * 4);
          p.x += acc[0][e], p.y += acc[1][e], p.z += acc[2][e],
              p.w += acc[3][e];
          *reinterpret_cast<float4*>(part + e * 4) = p;
        }
      }
      if (lane == 0) {  // lane 0 summed der over every valid slot
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c < hc) a.der[d * a.heads + g * kHeadGroup + c] = der[c];
        }
      }
      __syncwarp();
    }
  }
  // The block's dwl partial: the warps' sums added in order.
  __syncthreads();
  const int n = a.h * a.heads;
  const int warps = blockDim.x / 32;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int col = i / a.heads, c = i - col * a.heads;
    const int at = ((c / kHeadGroup) * a.h + col) * 4 + c % kHeadGroup;
    float s = 0.f;
    for (int w = 0; w < warps; ++w) {
      s += Warp(smem, L, w).dwl[at];
    }
    a.dwl_part[static_cast<long long>(blockIdx.x) * n + i] = s;
  }
}

// The `_any` kernels (see the top of the file).

// This lane's columns h0 + lane + 32 i of leaf row r, as f32 (zero past
// h).
template <typename In, int J>
__device__ __forceinline__ void load_leaf(const Args& a, int r, int h0,
                                          int lane, float (&v)[J]) {
  const long long base = static_cast<long long>(r) * a.h;
#pragma unroll
  for (int i = 0; i < J; ++i) {
    const int col = h0 + lane + 32 * i;
    v[i] = col < a.h ? Frame<In>::load(a.x, base + col) : 0.f;
  }
}

// Column d's K slot ids into s_idx (an id outside [0, S) stops the kernel
// with a device-side assert, as torch.index_select does on the card).
__device__ __forceinline__ void stage_slots(const Args& a, long long d,
                                            int lane, int* s_idx) {
  for (int k = lane; k < a.K; k += 32) {
    const int r = __ldg(a.nbr + static_cast<long long>(k) * a.D + d);
    assert(r >= 0 && r < a.x_rows);
    s_idx[k] = r;
  }
}

// The warp's sums of the HEADS values t[0 .. HEADS) (HEADS a power of two
// up to 32), folded so that lane l ends with the sum of value l / (32 /
// HEADS), its head: each halving step sends the half of the values a lane
// still holds that its partner keeps (log2 HEADS steps of HEADS / 2, ...,
// 1 shuffles), then a butterfly over the lanes of a head. Every lane of a
// head holds the same bits. t is overwritten.
template <typename T, int HEADS>
__device__ __forceinline__ T head_sums(T (&t)[HEADS], int lane) {
#pragma unroll
  for (int n = HEADS, o = 16; n > 1; n /= 2, o /= 2) {
    const bool upper = lane & o;
#pragma unroll
    for (int j = 0; j < n / 2; ++j) {
      const T send = upper ? t[j] : t[j + n / 2];
      const T keep = upper ? t[j + n / 2] : t[j];
      t[j] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  T v = t[0];
#pragma unroll
  for (int o = 16 / HEADS; o > 0; o /= 2) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Head c's value of a [D, heads] array at column d (zero past heads).
__device__ __forceinline__ float head_value(const float* p, const Args& a,
                                            long long d, int c) {
  return c < a.heads ? __ldg(p + d * a.heads + c) : 0.f;
}

// The rows of kBatch slots from k0 on, their columns from h0, loaded
// together (a padding slot's, or one past K, not at all: r[u] is then the
// zero row).
template <typename In, int J>
__device__ __forceinline__ void load_batch(const Args& a, const int* s_idx,
                                           int k0, int h0, int zero_row,
                                           int lane, int (&r)[kBatch],
                                           float (&v)[kBatch][J]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    r[u] = k0 + u < a.K ? s_idx[k0 + u] : zero_row;
    if (r[u] != zero_row) load_leaf<In>(a, r[u], h0, lane, v[u]);
  }
}

// wl[col, c] rounded as the frame's type (zero past heads).
template <typename In>
__device__ __forceinline__ float weight(const Args& a, int c, int col) {
  return c < a.heads ? Frame<In>::round(__ldg(a.wl + col * a.heads + c))
                     : 0.f;
}

// The `_any` forward.
template <typename In>
__global__ void __launch_bounds__(kThreads) attention_fwd_any(Args a) {
  constexpr int J = kAnyJ, HG = kAnyHeads, kGroup = 32 / HG;
  extern __shared__ float s_fmem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int mine = lane / kGroup;  // this lane's head in a group's sums
  const int nh = a.heads;
  // A warp's [K][heads] scores, then weights, and [heads] maxima; its slot
  // ids.
  float* s_z = s_fmem + warp * (a.K + 1) * nh;
  float* s_m = s_z + a.K * nh;
  int* s_idx =
      reinterpret_cast<int*>(s_fmem + kWarps * (a.K + 1) * nh) + warp * a.K;
  const long long d = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (d >= a.D) return;
  const int zero_row = static_cast<int>(a.x_rows - 1);
  stage_slots(a, d, lane, s_idx);
  __syncwarp();
  // Pass 1: each (slot, head)'s score, -inf on padding; a group's products
  // summed over the row's tiles in f64, then folded across the lanes.
  for (int k0 = 0; k0 < a.K; k0 += kBatch) {
    for (int c0 = 0; c0 < nh; c0 += HG) {
      double t[kBatch][HG];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
#pragma unroll
        for (int c = 0; c < HG; ++c) t[u][c] = 0.0;
      }
      for (int h0 = 0; h0 < a.h; h0 += kTile) {
        double w[HG][J];
#pragma unroll
        for (int c = 0; c < HG; ++c) {
#pragma unroll
          for (int i = 0; i < J; ++i) {
            const int col = h0 + lane + 32 * i;
            w[c][i] = col < a.h ? weight<In>(a, c0 + c, col) : 0.0;
          }
        }
        int r[kBatch];
        float v[kBatch][J];
        load_batch<In>(a, s_idx, k0, h0, zero_row, lane, r, v);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (r[u] == zero_row) continue;
#pragma unroll
          for (int i = 0; i < J; ++i) {
            if (h0 + lane + 32 * i >= a.h) break;
#pragma unroll
            for (int c = 0; c < HG; ++c) {
              t[u][c] = fma(static_cast<double>(v[u][i]), w[c][i], t[u][c]);
            }
          }
        }
      }
      const int c = c0 + mine;
      const double e = head_value(a.er, a, d, c);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (k0 + u >= a.K) break;
        float z = -INFINITY;
        if (s_idx[k0 + u] != zero_row) {
          z = leaky(static_cast<float>(head_sums(t[u], lane) + e), a.slope);
        }
        if (lane % kGroup == 0 && c < nh) s_z[(k0 + u) * nh + c] = z;
      }
    }
  }
  __syncwarp();
  for (int c = lane; c < nh; c += 32) {
    float mx = -INFINITY;
    for (int k = 0; k < a.K; ++k) mx = fmaxf(mx, s_z[k * nh + c]);
    s_m[c] = mx;
  }
  __syncwarp();
  for (int t = lane; t < a.K * nh; t += 32) {
    const int k = t / nh;
    s_z[t] = s_idx[k] == zero_row ? 0.f : expf(s_z[t] - s_m[t - k * nh]);
  }
  __syncwarp();
  for (int c = lane; c < nh; c += 32) {
    float s = 0.f;
    for (int k = 0; k < a.K; ++k) s += s_z[k * nh + c];
    a.m_out[d * nh + c] = s_m[c];
    a.s_out[d * nh + c] = s;
  }
  // Pass 2: the weighted leaves, a group and a tile at a time, k in order.
  for (int c0 = 0; c0 < nh; c0 += HG) {
    for (int h0 = 0; h0 < a.h; h0 += kTile) {
      float acc[HG][J];
#pragma unroll
      for (int c = 0; c < HG; ++c) {
#pragma unroll
        for (int i = 0; i < J; ++i) acc[c][i] = 0.f;
      }
      for (int k0 = 0; k0 < a.K; k0 += kBatch) {
        int r[kBatch];
        float v[kBatch][J];
        load_batch<In>(a, s_idx, k0, h0, zero_row, lane, r, v);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (r[u] == zero_row) continue;
#pragma unroll
          for (int c = 0; c < HG; ++c) {
            const float pc =
                c0 + c < nh ? Frame<In>::round(s_z[(k0 + u) * nh + c0 + c])
                            : 0.f;
#pragma unroll
            for (int i = 0; i < J; ++i) {
              acc[c][i] = fmaf(pc, v[u][i], acc[c][i]);
            }
          }
        }
      }
#pragma unroll
      for (int c = 0; c < HG; ++c) {
        if (c0 + c >= nh) break;
        float* out = a.agg + (d * nh + c0 + c) * a.h;
#pragma unroll
        for (int i = 0; i < J; ++i) {
          const int col = h0 + lane + 32 * i;
          if (col < a.h) out[col] = acc[c][i];
        }
      }
    }
  }
}

// The `_any` backward.
// A column's dpre and rounded pw for all its slots go to shared memory
// first; then, a tile and a head group at a time, dwl's sums run over the
// column's slots in registers and are added into the warp's partial once.
template <typename In>
__global__ void __launch_bounds__(kThreads) attention_bwd_any(Args a) {
  constexpr int J = kAnyJ, HG = kAnyHeads, kGroup = 32 / HG;
  extern __shared__ float s_fmem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int mine = lane / kGroup;  // this lane's head in a group's sums
  const int nh = a.heads;
  // A warp's dpre and rounded pw [K][heads], its column's der [heads] and
  // its slot ids.
  float* s_dp = s_fmem + warp * (2 * a.K + 1) * nh;
  float* s_pc = s_dp + a.K * nh;
  float* s_der = s_pc + a.K * nh;
  int* s_idx =
      reinterpret_cast<int*>(s_fmem + kWarps * (2 * a.K + 1) * nh) +
      warp * a.K;
  const int zero_row = static_cast<int>(a.x_rows - 1);
  // The warp's dwl partial [h][heads], a lane's columns its own.
  float* gw = a.dwl_part +
              (static_cast<long long>(blockIdx.x) * kWarps + warp) * a.h * nh;
  for (int col = lane; col < a.h; col += 32) {
    for (int c = 0; c < nh; ++c) gw[col * nh + c] = 0.f;
  }
  for (long long d = static_cast<long long>(blockIdx.x) * kWarps + warp;
       d < a.D; d += static_cast<long long>(gridDim.x) * kWarps) {
    __syncwarp();  // the shared arrays hold the last column's until here
    stage_slots(a, d, lane, s_idx);
    for (int c = lane; c < nh; c += 32) s_der[c] = 0.f;
    __syncwarp();
    const float* ga = a.dagg + d * nh * a.h;
    // Each slot's dpre and rounded pw, a group of heads at a time: the
    // score and dagg . leaf summed over the row's tiles, then folded.
    for (int k0 = 0; k0 < a.K; k0 += kBatch) {
      for (int c0 = 0; c0 < nh; c0 += HG) {
        double tp[kBatch][HG];
        float ta[kBatch][HG];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
#pragma unroll
          for (int c = 0; c < HG; ++c) {
            tp[u][c] = 0.0;
            ta[u][c] = 0.f;
          }
        }
        for (int h0 = 0; h0 < a.h; h0 += kTile) {
          float w[HG][J], g[HG][J];
#pragma unroll
          for (int c = 0; c < HG; ++c) {
#pragma unroll
            for (int i = 0; i < J; ++i) {
              const int col = h0 + lane + 32 * i;
              const bool real = c0 + c < nh && col < a.h;
              w[c][i] = real ? weight<In>(a, c0 + c, col) : 0.f;
              g[c][i] = real ? __ldg(ga + (c0 + c) * a.h + col) : 0.f;
            }
          }
          int r[kBatch];
          float v[kBatch][J];
          load_batch<In>(a, s_idx, k0, h0, zero_row, lane, r, v);
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (r[u] == zero_row) continue;
#pragma unroll
            for (int i = 0; i < J; ++i) {
              if (h0 + lane + 32 * i >= a.h) break;
#pragma unroll
              for (int c = 0; c < HG; ++c) {
                tp[u][c] = fma(static_cast<double>(v[u][i]),
                               static_cast<double>(w[c][i]), tp[u][c]);
                ta[u][c] = fmaf(v[u][i], g[c][i], ta[u][c]);
              }
            }
          }
        }
        const int c = c0 + mine;
        const double e = head_value(a.er, a, d, c);
        const float m = head_value(a.m, a, d, c);
        const float ds = head_value(a.ds, a, d, c);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (k0 + u >= a.K) break;
          if (s_idx[k0 + u] == zero_row) continue;
          const float pre = static_cast<float>(head_sums(tp[u], lane) + e);
          const float t = Frame<In>::round(head_sums(ta[u], lane));
          const float p = expf(leaky(pre, a.slope) - m);
          const float dpre = p * (ds + t) * (pre > 0.f ? 1.f : a.slope);
          if (lane % kGroup == 0 && c < nh) {
            s_dp[(k0 + u) * nh + c] = dpre;
            s_pc[(k0 + u) * nh + c] = Frame<In>::round(p);
            s_der[c] += dpre;
          }
        }
      }
    }
    __syncwarp();
    for (int c = lane; c < nh; c += 32) a.der[d * nh + c] = s_der[c];
    for (int h0 = 0; h0 < a.h; h0 += kTile) {
      // dwl: a group's sums over the column's slots in registers, k in
      // order, added into the warp's partial.
      for (int c0 = 0; c0 < nh; c0 += HG) {
        float acc[HG][J];
#pragma unroll
        for (int c = 0; c < HG; ++c) {
#pragma unroll
          for (int i = 0; i < J; ++i) {
            const int col = h0 + lane + 32 * i;
            acc[c][i] = c0 + c < nh && col < a.h ? gw[col * nh + c0 + c]
                                                 : 0.f;
          }
        }
        for (int k0 = 0; k0 < a.K; k0 += kBatch) {
          int r[kBatch];
          float v[kBatch][J];
          load_batch<In>(a, s_idx, k0, h0, zero_row, lane, r, v);
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (r[u] == zero_row) continue;
#pragma unroll
            for (int c = 0; c < HG; ++c) {
              const float dp = c0 + c < nh ? s_dp[(k0 + u) * nh + c0 + c]
                                           : 0.f;
#pragma unroll
              for (int i = 0; i < J; ++i) {
                acc[c][i] = fmaf(v[u][i], dp, acc[c][i]);
              }
            }
          }
        }
#pragma unroll
        for (int c = 0; c < HG; ++c) {
#pragma unroll
          for (int i = 0; i < J; ++i) {
            const int col = h0 + lane + 32 * i;
            if (c0 + c < nh && col < a.h) gw[col * nh + c0 + c] = acc[c][i];
          }
        }
      }
      if (a.dxg == nullptr) continue;
      // The valid slots' dx rows: sum over c of pw * dagg, then of dpre *
      // wl, each dagg and wl element read once for the batch's slots.
      for (int k0 = 0; k0 < a.K; k0 += kBatch) {
#pragma unroll
        for (int i = 0; i < J; ++i) {
          const int col = h0 + lane + 32 * i;
          if (col >= a.h) break;
          float o[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) o[u] = 0.f;
          const int n = a.K - k0 < kBatch ? a.K - k0 : kBatch;
          for (int c = 0; c < nh; ++c) {
            const float g = __ldg(ga + c * a.h + col);
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              if (u < n) o[u] = fmaf(s_pc[(k0 + u) * nh + c], g, o[u]);
            }
          }
          for (int c = 0; c < nh; ++c) {
            const float w = weight<In>(a, c, col);
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              if (u < n) o[u] = fmaf(s_dp[(k0 + u) * nh + c], w, o[u]);
            }
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (u < n && s_idx[k0 + u] != zero_row) {
              a.dxg[(static_cast<long long>(k0 + u) * a.D + d) * a.h + col] =
                  o[u];
            }
          }
        }
      }
    }
  }
}

// Let the kernel take the layout's shared memory, and the SM give shared
// memory all it can (its split with L1 is otherwise left to the CUDA
// runtime, which may hold fewer blocks an SM than the plan counts on).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, const Layout& L) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess || static_cast<unsigned>(L.total) <= kSmemDefault) {
    return err;
  }
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              L.total);
}

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, const Args& a, int grid,
                          cudaStream_t stream, int* per_sm) {
  cudaError_t err = prepare(kernel, a.L);
  if (err != cudaSuccess) return err;
  if (per_sm != nullptr) {  // the blocks an SM holds, no launch
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kernel, 32 * a.tile, a.L.total);
  }
  kernel<<<grid, 32 * a.tile, a.L.total, stream>>>(a);
  return cudaGetLastError();
}

template <typename In, int V>
cudaError_t launch(const Args& a, bool backward, int grid,
                   cudaStream_t stream, int* per_sm) {
  return backward
             ? launch_kernel(attention_bwd<In, V>, a, grid, stream, per_sm)
             : launch_kernel(attention_fwd<In, V>, a, grid, stream, per_sm);
}

template <typename In>
cudaError_t by_read(const Args& a, bool backward, int grid,
                    cudaStream_t stream, int* per_sm) {
  switch (a.L.read) {
    case 16:
      return launch<In, 16>(a, backward, grid, stream, per_sm);
    case 8:
      return launch<In, 8>(a, backward, grid, stream, per_sm);
    case 4:
      return launch<In, 4>(a, backward, grid, stream, per_sm);
    default:
      if constexpr (std::is_same<In, float>::value) {
        return cudaErrorInvalidValue;
      } else {
        return launch<In, 2>(a, backward, grid, stream, per_sm);
      }
  }
}

// Raise a kernel's dynamic shared memory limit where it needs more than
// the default (never lowered).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename In>
cudaError_t launch_any(const Args& a, bool backward, int grid,
                       cudaStream_t stream) {
  if (!backward) {
    const size_t smem =
        (sizeof(float) * a.heads * (a.K + 1) + sizeof(int) * a.K) * kWarps;
    cudaError_t err = allow_smem(attention_fwd_any<In>, smem);
    if (err != cudaSuccess) return err;
    attention_fwd_any<In><<<grid, kThreads, smem, stream>>>(a);
  } else {
    const size_t smem = (sizeof(float) * a.heads * (2 * a.K + 1) +
                         sizeof(int) * a.K) * kWarps;
    cudaError_t err = allow_smem(attention_bwd_any<In>, smem);
    if (err != cudaSuccess) return err;
    attention_bwd_any<In><<<grid, kThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

int x_align(const void* x) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(x);
  return p % 16 == 0 ? 16 : static_cast<int>(p & (~p + 1));
}

// Whether a staged layout can serve this launch: its read unit divides the
// row's bytes and the frame's alignment, its head groups are the heads',
// a staged row holds the row's window, and its warps fit a block.
bool layout_fits(const Layout& L, const Args& a, int elt) {
  const int rowbytes = a.h * elt;
  const bool read_ok = (L.read == 16 || L.read == 8 || L.read == 4 ||
                        (L.read == 2 && elt == 2)) &&
                       rowbytes % L.read == 0 &&
                       x_align(a.x) % L.read == 0 &&
                       L.nvec * L.read == rowbytes;
  return read_ok && L.bulk == (rowbytes >= 16) &&
         L.groups == (a.heads + kHeadGroup - 1) / kHeadGroup &&
         L.stages == static_cast<int>(kStages) && L.stride % 16 == 0 &&
         L.stride >= ((rowbytes + (L.bulk && L.read < 16 ? 16 - L.read : 0) +
                       15) & ~15) &&
         L.per_warp > 0 && L.warp >= 0 &&
         static_cast<long long>(L.warp) +
                 static_cast<long long>(L.per_warp) * a.tile ==
             L.total &&
         static_cast<unsigned>(L.total) <= kSmemBlock;
}

// The checks both entries make, then the launch: the staged kernels with
// `layout`, or the `_any` kernels where it is null (`grid` blocks of
// kWarps warps, a dst column each; the forward's must reach every column).
int run(Args& a, int x_bf16, int grid, const Layout* layout, bool backward,
        int device, void* stream, int* per_sm = nullptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.h < 1 || a.heads < 1 || a.K < 1 || a.D < 0 || a.x_rows < 1 ||
      a.x_rows > 2147483647LL || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.D == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == nullptr) {
    if (per_sm != nullptr ||
        (!backward && static_cast<long long>(grid) * kWarps < a.D)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    err = x_bf16 ? launch_any<__nv_bfloat16>(a, backward, grid, s)
                 : launch_any<float>(a, backward, grid, s);
    return static_cast<int>(err);
  }
  if (a.tile < 1 || a.tile > kMaxWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.tiles = (a.D + a.tile - 1) / a.tile;
  a.L = *layout;
  // Every block takes a tile (so every dwl partial is written), and the
  // layout fits a block and the frame.
  if (grid > a.tiles || !layout_fits(a.L, a, x_bf16 ? 2 : 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (backward) {
    a.dagg_bulk = (a.heads * a.h) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(a.dagg) % 16 == 0;
  }
  err = x_bf16 ? by_read<__nv_bfloat16>(a, backward, grid, s, per_sm)
               : by_read<float>(a, backward, grid, s, per_sm);
  return static_cast<int>(err);
}

Args common(const void* x, long long x_rows, int h, const void* nbr, int k,
            long long d, const void* wl, const void* er, int heads,
            float slope, int tile) {
  Args a = {};
  a.x = x;
  a.x_rows = x_rows;
  a.h = h;
  a.nbr = static_cast<const int*>(nbr);
  a.K = k;
  a.D = d;
  a.wl = static_cast<const float*>(wl);
  a.er = static_cast<const float*>(er);
  a.heads = heads;
  a.slope = slope;
  a.tile = tile;
  return a;
}

}  // namespace

// The entries launch on `stream` (a cudaStream_t) on device `device`,
// return the cudaError_t of the launch, 0 on success, and do not
// synchronise. Every array is contiguous; x is f32 (x_bf16 == 0) or bf16
// [x_rows, h], its row x_rows - 1 the zero row. The wrapper's plan gives
// `layout` (a host array of the Layout's ints, in its order), `tile`
// columns a tile (a warp each, at most 8) and `grid` blocks (at most the
// tiles); a null layout takes the `_any` kernels, `grid` blocks of 8
// warps (`tile` unread).

// m, s [d, heads] and agg [d, heads, h], every column written.
extern "C" int gat_attention_fwd(const void* x, int x_bf16, long long x_rows,
                                 int h, const void* nbr, int k, long long d,
                                 const void* wl, const void* er, int heads,
                                 float slope, const void* layout, int tile,
                                 int grid, void* m, void* s, void* agg,
                                 int device, void* stream) {
  Args a = common(x, x_rows, h, nbr, k, d, wl, er, heads, slope, tile);
  a.m_out = static_cast<float*>(m);
  a.s_out = static_cast<float*>(s);
  a.agg = static_cast<float*>(agg);
  return run(a, x_bf16, grid, static_cast<const Layout*>(layout), false,
             device, stream);
}

// der [d, heads], dwl_part [partials, h, heads] (a block's partial each,
// `grid` of them; the `_any` kernel's a warp's, 8 * grid) and, unless dxg
// is null, dxg [k * d, h] (the rows of valid slots; padding slots' rows
// are left as they were).
extern "C" int gat_attention_bwd(const void* x, int x_bf16, long long x_rows,
                                 int h, const void* nbr, int k, long long d,
                                 const void* wl, const void* er, int heads,
                                 float slope, const void* layout, int tile,
                                 int grid, const void* m, const void* ds,
                                 const void* dagg, void* der, void* dwl_part,
                                 void* dxg, int device, void* stream) {
  Args a = common(x, x_rows, h, nbr, k, d, wl, er, heads, slope, tile);
  a.m = static_cast<const float*>(m);
  a.ds = static_cast<const float*>(ds);
  a.dagg = static_cast<const float*>(dagg);
  a.der = static_cast<float*>(der);
  a.dwl_part = static_cast<float*>(dwl_part);
  a.dxg = static_cast<float*>(dxg);
  return run(a, x_bf16, grid, static_cast<const Layout*>(layout), true,
             device, stream);
}

// The blocks of a staged kernel with this layout and tile that an SM
// holds at once, into *per_sm (the arrays are not read: no launch).
extern "C" int gat_attention_occupancy(const void* x, int x_bf16,
                                       long long x_rows, int h, int k,
                                       long long d, int heads,
                                       const void* layout, int tile,
                                       int backward, int device,
                                       int* per_sm) {
  Args a = common(x, x_rows, h, nullptr, k, d, nullptr, nullptr, heads,
                  0.f, tile);
  return run(a, x_bf16, 1, static_cast<const Layout*>(layout),
             backward != 0, device, nullptr, per_sm);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
