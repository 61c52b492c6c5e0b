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
//       dwl[:, c] += x[nbr[k, d], :] * dpre[k, c]  (a partial a warp)
//       dxg[k * D + d, :] = sum over c of pw[k, c] * dagg[d, c, :]
//                          + sum over c of dpre[k, c] * wl[:, c]
//     (dxg only where asked for, and only for valid slots: a padding
//     slot's row is not written, and the per-slot scatter does not read it).
//
// x is f32 or bf16 [S, H] row-major, its last row the frame's reserved zero
// row that padding slots name; nbr int32 [K, D] k-major; wl f32 [H, heads];
// er, m, s, ds, der f32 [D, heads]; agg, dagg f32 [D, heads, H]; dxg f32
// [K * D, H]; dwl_part f32 [blocks * kWarps, H, heads]. Under a bf16 frame
// wl and the pw that multiplies a leaf are rounded to bf16 (and dagg . leaf
// in dpw, as autograd rounds a gradient through a bf16 tensor), and every
// sum is f32: what the plain version (ops/gat_attention.py) computes.
//
// Replaces: occ_gnn_tpu/parallel/model.py:294-363, the batched branch of
// SplitGAT.layer, which XLA lowers (no pallas_call): it gathers the
// [K, D, H] leaves x[nbr] whole and keeps them, the scores and the weights
// for the backward.
//
// Bound: device-memory bytes. Each valid slot's leaf row is read (400 B at
// split GAT A's layer 0) for a few multiply-adds a byte; the forward writes
// agg (heads f32 rows a column), the backward reads dagg and, past layer 0,
// writes a row a valid slot. Design: a warp for each dst column, lane j
// holding columns j + 32 i of a row (i < J), so each load of a row is one
// contiguous 128-byte (f32) or 64-byte (bf16) access. A score's products
// and sums are taken in f64 and rounded to f32 once (`score`), as the plain
// version's are, so both take the same leaky ReLU slope at scores near 0;
// the heads' sums are folded into one across the lanes, every lane of a
// head holding the same bits, so the warp's branches stay uniform. The
// leaves never reach device memory.
// A warp walks its column's slots kBatch at a time, their rows' loads in
// flight together: one row at a time left a warp waiting on each load's
// latency, several times the bytes' time.
//   * forward: the column's slot ids staged in shared memory; pass 1 reads
//     each valid leaf, scores the heads and keeps z in shared memory
//     (K x heads), taking the exact max; pass 2 reads the leaves again (L1
//     or L2, read microseconds before) and adds pw * leaf into registers,
//     heads x J of them, written once as agg. A column no slot names still
//     writes m = -inf and zeros, so every column of the grid is written.
//   * backward: the same walk over columns, strided over a grid of two
//     blocks an SM; each valid leaf read once; wl and the column's dagg in
//     shared memory (in registers they held one block an SM); dwl summed
//     in registers over the warp's columns and written as the warp's
//     partial (no float atomics; the wrapper adds the partials in a fixed
//     order). der is written by the column's warp.
// Heads take groups of 4 or 8 (the unused ones carry zero weights and are
// never written); J is 4 (H <= 128) or 16 (H <= 512). Wider rows or more
// heads take the `_any` kernels: the same walk and the same sums in the
// same orders, the row in tiles of 128 columns and the heads in groups of
// 4, a leaf read once a tile and group in each pass (L1 or L2 after the
// first), wl and dagg read through L1, the scores' maxima and sums taken
// from shared memory; the backward keeps a column's dpre in shared memory
// and adds dwl's sums over the column's slots into the warp's partial in
// dwl_part a tile and group at a time.

#include <assert.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // a block; a dst column a warp
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
// Shared memory a block may take without opting in to more.
constexpr size_t kSmemDefault = 48 * 1024;
// What the kernels that keep a row and the heads in registers take; the
// `_any` kernels take the rest.
constexpr int kMaxH = 512;
constexpr int kMaxHeads = 8;
// The `_any` kernels' tile (32 * kAnyJ columns) and head group.
constexpr int kAnyJ = 4;
constexpr int kTile = 32 * kAnyJ;
constexpr int kAnyHeads = 4;
// Slots a warp loads at once, their rows in flight together.
constexpr int kBatch = 4;

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
  // forward
  float* m_out;
  float* s_out;
  float* agg;
  // backward
  const float* m;
  const float* ds;
  const float* dagg;
  float* der;
  float* dwl_part;
  float* dxg;  // nullptr: no gradient to x
};

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

// wl rounded as the frame's type, into shared memory as s_wd[c * h + col]
// (f64, zero past heads), by the whole block.
template <typename In, int HEADS>
__device__ __forceinline__ void stage_weights(const Args& a, double* s_wd) {
  for (int t = threadIdx.x; t < HEADS * a.h; t += kThreads) {
    const int c = t / a.h, col = t - c * a.h;
    s_wd[t] = c < a.heads
                  ? Frame<In>::round(__ldg(a.wl + col * a.heads + c))
                  : 0.0;
  }
}

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

// The score's pre-activation leaf . wl[:, c] + e of this lane's head: the
// products and sums in f64 (a lane's columns, then the folded warp sum),
// rounded to f32 once. Any order of f64 sums rounds to the same f32 but
// for a value within about 2^-40 of its size of a rounding boundary, so
// the plain version, which sums in f64 too, takes the same leaky ReLU
// slope; sums in f32 in two orders may not, at scores within rounding of
// 0.
template <int J, int HEADS>
__device__ __forceinline__ float score(const float (&v)[J],
                                       const double* s_wd, int h, float e,
                                       int lane) {
  double t[HEADS];
#pragma unroll
  for (int c = 0; c < HEADS; ++c) {
    t[c] = 0.0;
#pragma unroll
    for (int i = 0; i < J; ++i) {
      const int col = lane + 32 * i;
      if (col < h) {
        t[c] = fma(static_cast<double>(v[i]), s_wd[c * h + col], t[c]);
      }
    }
  }
  return static_cast<float>(head_sums(t, lane) + static_cast<double>(e));
}

// Head c's value of a [D, heads] array at column d (zero past heads).
__device__ __forceinline__ float head_value(const float* p, const Args& a,
                                            long long d, int c) {
  return c < a.heads ? __ldg(p + d * a.heads + c) : 0.f;
}

__device__ __forceinline__ float leaky(float pre, float slope) {
  return pre > 0.f ? pre : slope * pre;
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

template <typename In, int J, int HEADS>
__global__ void __launch_bounds__(kThreads) attention_fwd(Args a) {
  constexpr int kGroup = 32 / HEADS;  // lanes a head
  extern __shared__ double s_dmem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int mine = lane / kGroup;  // this lane's head in the folded sums
  // wl [HEADS][h] in f64; a warp's [K][HEADS] scores, then weights, and
  // [HEADS] maxima; its slot ids.
  double* s_wd = s_dmem;
  float* s_mem = reinterpret_cast<float*>(s_wd + HEADS * a.h);
  float* s_z = s_mem + warp * (a.K + 1) * HEADS;
  float* s_m = s_z + a.K * HEADS;
  int* s_idx =
      reinterpret_cast<int*>(s_mem + kWarps * (a.K + 1) * HEADS) + warp * a.K;
  stage_weights<In, HEADS>(a, s_wd);
  __syncthreads();
  const long long d = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (d >= a.D) return;
  const int zero_row = static_cast<int>(a.x_rows - 1);
  const float e = head_value(a.er, a, d, mine);
  stage_slots(a, d, lane, s_idx);
  __syncwarp();
  // Pass 1: the scores and their exact max, a head's in its lanes.
  float mx = -INFINITY;
  for (int k0 = 0; k0 < a.K; k0 += kBatch) {
    int r[kBatch];
    float v[kBatch][J];
    load_batch<In>(a, s_idx, k0, 0, zero_row, lane, r, v);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (r[u] == zero_row) continue;
      const float z =
          leaky(score<J, HEADS>(v[u], s_wd, a.h, e, lane), a.slope);
      mx = fmaxf(mx, z);
      if (lane % kGroup == 0) s_z[(k0 + u) * HEADS + mine] = z;
    }
  }
  if (lane % kGroup == 0) s_m[mine] = mx;
  __syncwarp();
  // The weights, each (slot, head) once across the lanes (0 on padding),
  // and their sums, a head's by one lane, k in order.
  for (int t = lane; t < a.K * HEADS; t += 32) {
    const int k = t / HEADS;
    s_z[t] = s_idx[k] == zero_row ? 0.f : expf(s_z[t] - s_m[t - k * HEADS]);
  }
  __syncwarp();
  if (lane < HEADS && lane < a.heads) {
    float s = 0.f;
    for (int k = 0; k < a.K; ++k) s += s_z[k * HEADS + lane];
    a.m_out[d * a.heads + lane] = s_m[lane];
    a.s_out[d * a.heads + lane] = s;
  }
  // Pass 2: the weighted leaves, k in order.
  float acc[HEADS][J];
#pragma unroll
  for (int c = 0; c < HEADS; ++c) {
#pragma unroll
    for (int i = 0; i < J; ++i) acc[c][i] = 0.f;
  }
  for (int k0 = 0; k0 < a.K; k0 += kBatch) {
    int r[kBatch];
    float v[kBatch][J];
    load_batch<In>(a, s_idx, k0, 0, zero_row, lane, r, v);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (r[u] == zero_row) continue;
#pragma unroll
      for (int c = 0; c < HEADS; ++c) {
        const float pc = Frame<In>::round(s_z[(k0 + u) * HEADS + c]);
#pragma unroll
        for (int i = 0; i < J; ++i) acc[c][i] = fmaf(pc, v[u][i], acc[c][i]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < HEADS; ++c) {
    if (c >= a.heads) break;
    float* out = a.agg + (d * a.heads + c) * a.h;
#pragma unroll
    for (int i = 0; i < J; ++i) {
      const int col = lane + 32 * i;
      if (col < a.h) out[col] = acc[c][i];
    }
  }
}

// The backward holds wl (rounded) and the column's dagg in shared memory,
// [HEADS][h] each with zeros past heads, to keep two blocks an SM.
template <typename In, int J, int HEADS>
__global__ void __launch_bounds__(kThreads, 2) attention_bwd(Args a) {
  constexpr int kGroup = 32 / HEADS;  // lanes a head
  extern __shared__ double s_dmem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int mine = lane / kGroup;  // this lane's head in the folded sums
  const int hh = HEADS * a.h;
  double* s_wd = s_dmem;                           // wl in f64, the scores'
  float* s_mem = reinterpret_cast<float*>(s_wd + hh);
  float* s_w = s_mem;                              // wl
  float* s_ga = s_mem + (1 + warp) * hh;           // this warp's dagg
  int* s_idx = reinterpret_cast<int*>(s_mem + (1 + kWarps) * hh) +
               warp * a.K;
  const int zero_row = static_cast<int>(a.x_rows - 1);
  for (int t = threadIdx.x; t < hh; t += kThreads) {
    const int c = t / a.h, col = t - c * a.h;
    s_w[t] = c < a.heads
                 ? Frame<In>::round(__ldg(a.wl + col * a.heads + c))
                 : 0.f;
  }
  stage_weights<In, HEADS>(a, s_wd);
  __syncthreads();
  float gw[HEADS][J];
#pragma unroll
  for (int c = 0; c < HEADS; ++c) {
#pragma unroll
    for (int i = 0; i < J; ++i) gw[c][i] = 0.f;
  }
  for (long long d = static_cast<long long>(blockIdx.x) * kWarps + warp;
       d < a.D; d += static_cast<long long>(gridDim.x) * kWarps) {
    __syncwarp();  // s_idx and s_ga hold the last column's until here
    stage_slots(a, d, lane, s_idx);
    for (int t = lane; t < hh; t += 32) {
      const int c = t / a.h;
      s_ga[t] = c < a.heads ? __ldg(a.dagg + d * a.heads * a.h + t) : 0.f;
    }
    __syncwarp();
    const float e = head_value(a.er, a, d, mine);
    const float m = head_value(a.m, a, d, mine);
    const float ds = head_value(a.ds, a, d, mine);
    float der = 0.f;
    for (int k0 = 0; k0 < a.K; k0 += kBatch) {
      int r[kBatch];
      float v[kBatch][J];
      load_batch<In>(a, s_idx, k0, 0, zero_row, lane, r, v);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (r[u] == zero_row) continue;
        // The score and dagg . leaf, a head's in its lanes.
        float ta[HEADS];
#pragma unroll
        for (int c = 0; c < HEADS; ++c) {
          ta[c] = 0.f;
#pragma unroll
          for (int i = 0; i < J; ++i) {
            const int col = lane + 32 * i;
            if (col < a.h) ta[c] = fmaf(v[u][i], s_ga[c * a.h + col], ta[c]);
          }
        }
        const float pre = score<J, HEADS>(v[u], s_wd, a.h, e, lane);
        const float t = Frame<In>::round(head_sums(ta, lane));
        const float p = expf(leaky(pre, a.slope) - m);
        const float dpre_mine = p * (ds + t) * (pre > 0.f ? 1.f : a.slope);
        const float pc_mine = Frame<In>::round(p);
        der += dpre_mine;
        float dpre[HEADS], pc[HEADS];
#pragma unroll
        for (int c = 0; c < HEADS; ++c) {
          dpre[c] = __shfl_sync(kFull, dpre_mine, c * kGroup);
          pc[c] = __shfl_sync(kFull, pc_mine, c * kGroup);
#pragma unroll
          for (int i = 0; i < J; ++i) {
            gw[c][i] = fmaf(v[u][i], dpre[c], gw[c][i]);
          }
        }
        if (a.dxg != nullptr) {
          float* row =
              a.dxg + (static_cast<long long>(k0 + u) * a.D + d) * a.h;
#pragma unroll
          for (int i = 0; i < J; ++i) {
            const int col = lane + 32 * i;
            if (col < a.h) {
              float o = 0.f;
#pragma unroll
              for (int c = 0; c < HEADS; ++c) {
                o = fmaf(pc[c], s_ga[c * a.h + col], o);
              }
#pragma unroll
              for (int c = 0; c < HEADS; ++c) {
                o = fmaf(dpre[c], s_w[c * a.h + col], o);
              }
              row[col] = o;
            }
          }
        }
      }
    }
    if (lane % kGroup == 0 && mine < a.heads) {
      a.der[d * a.heads + mine] = der;
    }
  }
  // The warp's dwl partial.
  float* out = a.dwl_part +
               (static_cast<long long>(blockIdx.x) * kWarps + warp) * a.h *
                   a.heads;
#pragma unroll
  for (int c = 0; c < HEADS; ++c) {
    if (c >= a.heads) break;
#pragma unroll
    for (int i = 0; i < J; ++i) {
      const int col = lane + 32 * i;
      if (col < a.h) out[col * a.heads + c] = gw[c][i];
    }
  }
}

// The forward for any width and head count (see the top of the file).
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

// The backward for any width and head count (see the top of the file).
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

// Raise a kernel's dynamic shared memory limit where it needs more than
// the default (never lowered).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename In, int J, int HEADS>
cudaError_t launch(const Args& a, int blocks, cudaStream_t stream) {
  if (blocks == 0) {  // the forward: a warp a column
    const size_t smem = sizeof(double) * HEADS * a.h +
                        (sizeof(float) * HEADS * (a.K + 1) +
                         sizeof(int) * a.K) * kWarps;
    auto kernel = attention_fwd<In, J, HEADS>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const long long grid = (a.D + kWarps - 1) / kWarps;
    attention_fwd<In, J, HEADS>
        <<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(a);
  } else {
    const size_t smem = sizeof(double) * HEADS * a.h +
                        sizeof(float) * (1 + kWarps) * HEADS * a.h +
                        sizeof(int) * kWarps * a.K;
    auto kernel = attention_bwd<In, J, HEADS>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    attention_bwd<In, J, HEADS><<<blocks, kThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename In>
cudaError_t launch_any(const Args& a, int blocks, cudaStream_t stream) {
  if (blocks == 0) {
    const size_t smem =
        (sizeof(float) * a.heads * (a.K + 1) + sizeof(int) * a.K) * kWarps;
    cudaError_t err = allow_smem(attention_fwd_any<In>, smem);
    if (err != cudaSuccess) return err;
    const long long grid = (a.D + kWarps - 1) / kWarps;
    attention_fwd_any<In>
        <<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(a);
  } else {
    const size_t smem = (sizeof(float) * a.heads * (2 * a.K + 1) +
                         sizeof(int) * a.K) * kWarps;
    cudaError_t err = allow_smem(attention_bwd_any<In>, smem);
    if (err != cudaSuccess) return err;
    attention_bwd_any<In><<<blocks, kThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename In, int J>
cudaError_t by_heads(const Args& a, int blocks, cudaStream_t stream) {
  return a.heads <= 4 ? launch<In, J, 4>(a, blocks, stream)
                      : launch<In, J, 8>(a, blocks, stream);
}

template <typename In>
cudaError_t by_width(const Args& a, int blocks, cudaStream_t stream) {
  if (a.h > kMaxH || a.heads > kMaxHeads) {
    return launch_any<In>(a, blocks, stream);
  }
  return a.h <= 128 ? by_heads<In, 4>(a, blocks, stream)
                    : by_heads<In, 16>(a, blocks, stream);
}

// The checks both entries make, then the launch (blocks == 0: forward).
int run(const Args& a, int x_bf16, int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.h < 1 || a.heads < 1 || a.K < 1 || a.D < 0 || a.x_rows < 1 ||
      a.x_rows > 2147483647LL || blocks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.D == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = x_bf16 ? by_width<__nv_bfloat16>(a, blocks, s)
               : by_width<float>(a, blocks, s);
  return static_cast<int>(err);
}

Args common(const void* x, long long x_rows, int h, const void* nbr, int k,
            long long d, const void* wl, const void* er, int heads,
            float slope) {
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
  return a;
}

}  // namespace

// The entries launch on `stream` (a cudaStream_t) on device `device`,
// return the cudaError_t of the launch, 0 on success, and do not
// synchronise. Every array is contiguous; x is f32 (x_bf16 == 0) or bf16
// [x_rows, h], its row x_rows - 1 the zero row.

// m, s [d, heads] and agg [d, heads, h], every column written.
extern "C" int gat_attention_fwd(const void* x, int x_bf16, long long x_rows,
                                 int h, const void* nbr, int k, long long d,
                                 const void* wl, const void* er, int heads,
                                 float slope, void* m, void* s, void* agg,
                                 int device, void* stream) {
  Args a = common(x, x_rows, h, nbr, k, d, wl, er, heads, slope);
  a.m_out = static_cast<float*>(m);
  a.s_out = static_cast<float*>(s);
  a.agg = static_cast<float*>(agg);
  return run(a, x_bf16, 0, device, stream);
}

// der [d, heads], dwl_part [blocks * 8, h, heads] (a warp's partial each;
// blocks >= 1 of 8 warps strided over the columns) and, unless dxg is
// null, dxg [k * d, h] (the rows of valid slots; padding slots' rows are
// left as they were).
extern "C" int gat_attention_bwd(const void* x, int x_bf16, long long x_rows,
                                 int h, const void* nbr, int k, long long d,
                                 const void* wl, const void* er, int heads,
                                 float slope, const void* m, const void* ds,
                                 const void* dagg, void* der, void* dwl_part,
                                 int blocks, void* dxg, int device,
                                 void* stream) {
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a = common(x, x_rows, h, nbr, k, d, wl, er, heads, slope);
  a.m = static_cast<const float*>(m);
  a.ds = static_cast<const float*>(ds);
  a.dagg = static_cast<const float*>(dagg);
  a.der = static_cast<float*>(der);
  a.dwl_part = static_cast<float*>(dwl_part);
  a.dxg = static_cast<float*>(dxg);
  return run(a, x_bf16, blocks, device, stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
