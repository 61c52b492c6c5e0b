// UniMP's layer tail for Hopper (sm_90a): from the merged softmax partials
// (s, v) of the query-key attention to the layer's output at its owned
// rows, one launch each way (ops/unimp_tail.py wraps them).
//
// The owned rows are the dst frame's prefix: owned row o is dst row o
// wherever owned_mask[o] (every layer builder makes them so), so neither
// kernel reads the owned rows' indices. W is the output's width: heads * dh
// on a hidden layer, dh on the last.
//
//   unimp_tail_fwd: for each owned row o whose owned_mask is set,
//       x[c, j]  = v[o, c, j] / max(s[o, c], 1e-16)
//       m        = x + b_v, the heads concatenated (hidden), or the heads'
//                  mean of x + b_v (last)
//       beta     = sigmoid(m . (w1 + w3) + r[o] . (w2 - w3)),
//                  w_beta = [w1; w2; w3]
//       out      = m + beta (r[o] - m) (torch's lerp)
//       hidden:  y[o] = relu((out - mean) rstd (1 + ln_g) + ln_b), with the
//                row's mean and rstd = 1 / sqrt(var + eps) saved [O]
//       last:    y[o] = out
//     and zeros at the other owned rows (v and r not read there).
//   unimp_tail_bwd: from dy (as y) and the saved statistics, recomputing x,
//     m, beta and out as the forward does (the same operations, so the same
//     bits: the ReLU's mask is the forward's),
//       hidden:  xh = (out - mean) rstd, z = xh (1 + ln_g) + ln_b,
//                dz = z > 0 ? dy : 0, dxh = dz (1 + ln_g),
//                dout = rstd (dxh - mean(dxh) - xh mean(dxh xh))
//       last:    dout = dy
//       da   = (dout . (r - m)) beta (1 - beta)
//       dm   = dout (1 - beta) + da (w1 + w3),  dr[o] = dout beta + da (w2 - w3)
//       dv[o, c, j] = dm[c, j] / max(s[o, c], 1e-16) (last: dm[j] / heads
//                     for every head), ds[o, c] = -(sum over j of dv x), 0
//                     where s[o, c] < 1e-16 (the clamp passes none there)
//     with dv and ds zero at every dst row no owned row names, dr zero at
//     the pads, and the weights' gradients
//       db_v = sum of dm (last: dm / heads, for every head),
//       dw_beta = [dwa, dwb, dwa - dwb] with dwa = sum of m da and
//       dwb = sum of r da, dln_g = sum of dz xh and dln_b = sum of dz,
//     sums over the owned rows.
//
// v is f32 [D, heads, dh] through its strides (v_row, v_head; unit stride
// along dh), so the value projection's head-major result is read in place;
// dv is written through its own strides (the wrapper gives it v's). s and
// ds are f32 [D, heads], owned_mask one byte [O] (O <= D), r, y, dy and dr
// f32 [O, W], b_v f32 [heads * dh], w_beta f32 [3 W], ln_g, ln_b f32 [W].
//
// Replaces: the torch chain of ops/unimp_tail.py (the value bias, the
// gate's two products, sigmoid and lerp, LayerNorm and ReLU, the mask, and
// their explicit backward: about 40 elementwise passes over layer 0's rows
// each step). The JAX package has no UniMP, so no TPU kernel.
//
// Bound: device-memory bytes, a few operations a byte. Forward: v and r at
// the valid owned rows read once, y written at every owned row; backward:
// dy, v and r at the valid rows read once, dv and ds written at every dst
// row, dr at every owned row.
//
// Design: a persistent grid of blocks of up to kWarps warps, a warp a row
// at a time, rows w, w + warps, ... (a static order, so the weights'
// partials come out the same over two launches). The block first stages
// its constant vectors (b_v, w1 + w3, w2 - w3, 1 + ln_g, ln_b) in shared
// memory. Lanes take the row's read units of V floats (16 bytes where dh,
// the strides and the addresses allow; 8 or 4 bytes else), lane l the
// units l, l + 32, ...; the row's loads (v, r and backward dy) are issued
// together before any is used. In the register form (W <= 32 *
// kRowFloats) a lane keeps its units of each row array in registers
// between the passes the row's sums divide it into, so each row leaves
// device memory once each way; a wider row is staged in the warp's slice
// of shared memory by the same code (the shared form). The row sums (the
// gate's dot, LayerNorm's mean and its two-pass variance, the backward's
// two LayerNorm sums and da) are f64: lane partials of exact f64 products,
// then a butterfly over the warp, so every lane holds the same bits. ds's
// sum over a head's columns is a lane partial in the warp's slice, then a
// butterfly. The weights' gradients: each lane adds its columns' terms
// over its rows into its own slots of the warp's slice (f32), the block
// adds its warps' slices in order in f64 into a partial a block, and the
// entry's second kernel adds the partials in block order in f64 and
// rounds once: no float atomics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // a block's warps at most
// The register form: a lane's floats of each row array, so rows up to
// 32 * kRowFloats = 512 wide.
constexpr int kRowFloats = 16;
constexpr int kMaxHeads = 32;  // a lane a head's clamped sum
constexpr float kFloor = 1e-16f;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kSmemDefault = 48 * 1024;
constexpr unsigned kSmemBlock = 232448;  // a block's most on sm_90
constexpr int kSumThreads = 256;
// The weights' gradients a warp accumulates, in its slice's order: db_v
// (last layer: dm / heads, a column), dwa, dwb, then a hidden layer's
// dln_g and dln_b.
constexpr int kAccBv = 0, kAccWa = 1, kAccWb = 2, kAccG = 3, kAccB = 4;

struct Args {
  const float* v;
  long long v_row, v_head;
  const float* s;
  const float* r;
  const float* b_v;
  const float* w_beta;
  const float* ln_g;  // nullptr on the last layer
  const float* ln_b;
  const unsigned char* owned_mask;
  long long D, O;
  int heads, dh, width, last, warps;
  double eps;
  // Shared memory in floats: the block's constants, then a slice a warp
  // (`per_warp` floats), its staged rows `rowpad` floats each.
  int consts, per_warp, rowpad;
  // forward
  float* y;
  float* mean;
  float* rstd;
  // backward
  const float* dy;
  const float* mean_in;
  const float* rstd_in;
  float* dv;
  long long dv_row, dv_head;
  float* ds;
  float* dr;
  double* part;  // [grid, parts]
  int parts;
};

__host__ __device__ __forceinline__ int pad4(long long n) {
  return static_cast<int>((n + 3) & ~3LL);
}

// torch's clamp(min=1e-16): a NaN stays NaN.
__device__ __forceinline__ float floored(float s) {
  return isnan(s) ? s : fmaxf(s, kFloor);
}

template <int V>
__device__ __forceinline__ void ldg(const float* p, float (&out)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = t.x, out[1] = t.y, out[2] = t.z, out[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    out[0] = t.x, out[1] = t.y;
  } else {
    out[0] = __ldg(p);
  }
}

// A plain load (shared memory, or this kernel's own writes).
template <int V>
__device__ __forceinline__ void ld(const float* p, float (&out)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x, out[1] = t.y, out[2] = t.z, out[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x, out[1] = t.y;
  } else {
    out[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void st(float* p, const float (&in)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  } else {
    *p = in[0];
  }
}

template <int V>
__device__ __forceinline__ void st_zero(float* p) {
  float z[V];
#pragma unroll
  for (int i = 0; i < V; ++i) z[i] = 0.f;
  st<V>(p, z);
}

// p[0..V) += in, p in the lane's own slots of shared memory.
template <int V>
__device__ __forceinline__ void add_to(float* p, const float (&in)[V]) {
  float t[V];
  ld<V>(p, t);
#pragma unroll
  for (int i = 0; i < V; ++i) t[i] += in[i];
  st<V>(p, t);
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// The operations both kernels run on an element, rounded as written (no
// contraction), so the backward recomputes the forward's bits. The gate
// is torch's lerp: r exactly where beta is 1, m where it is 0.
__device__ __forceinline__ float gated(float m, float r, float beta) {
  const float d = __fsub_rn(r, m);
  return beta < 0.5f ? __fmaf_rn(beta, d, m)
                     : __fmaf_rn(-d, __fsub_rn(1.f, beta), r);
}

__device__ __forceinline__ float normed(float out, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(out, mean), rstd);
}

__device__ __forceinline__ float affine(float xh, float gp, float lb) {
  return __fmaf_rn(xh, gp, lb);
}

__device__ __forceinline__ float sigmoid(double a) {
  return 1.f / (1.f + expf(-static_cast<float>(a)));
}

// A lane's units of one row array: in registers (KR units of V floats), or
// (KR == 0, the shared form) in the warp's staged row, unit k of lane l at
// floats (32 k + l) V.
template <int V, int KR>
struct Row {
  float reg[KR > 0 ? KR : 1][V];
  float* staged;
  __device__ __forceinline__ float (&at(int k))[V] {
    if constexpr (KR > 0) {
      return reg[k];
    } else {
      return *reinterpret_cast<float(*)[V]>(staged + k * 32 * V);
    }
  }
};

// The head of each of a lane's units on a hidden layer: in registers in
// the register form, computed where the shared form needs it.
template <int V, int KR>
struct Heads {
  int c[KR > 0 ? KR : 1];
  int dh;
  __device__ __forceinline__ void init(int lane, int units, int dh_) {
    dh = dh_;
    if constexpr (KR > 0) {
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        const int u = lane + 32 * k;
        c[k] = u < units ? u * V / dh : 0;
      }
    }
  }
  __device__ __forceinline__ int of(int k, int u) const {
    if constexpr (KR > 0) {
      return c[k];
    } else {
      return u * V / dh;
    }
  }
};

// Where the block's shared memory holds what (floats).
struct Smem {
  float* bv;   // b_v [heads * dh]
  float* wa;   // w1 + w3 [W]
  float* wb;   // w2 - w3 [W]
  float* gp;   // 1 + ln_g [W] (hidden)
  float* lb;   // ln_b [W] (hidden)
  float* sc;   // the warp's row's clamped sums [kMaxHeads]
  float* hp;   // the warp's ds partials [heads][32] (backward)
  float* acc;  // the warp's gradient slots [slots][rowpad] (backward)
  float* rows; // the warp's staged rows [n][rowpad] (shared form)
};

// Warp `w`'s view of the block's shared memory.
__device__ __forceinline__ Smem smem_at(const Args& a, float* base, int w,
                                        bool backward, bool last) {
  Smem m;
  const int nb = pad4(static_cast<long long>(a.heads) * a.dh);
  m.bv = base;
  m.wa = base + nb;
  m.wb = m.wa + a.rowpad;
  m.gp = m.wb + a.rowpad;
  m.lb = m.gp + a.rowpad;
  m.sc = base + a.consts + w * a.per_warp;
  m.hp = m.sc + kMaxHeads;
  m.acc = m.hp + (backward ? a.heads * 32 : 0);
  m.rows = m.acc + (backward ? (last ? 3 : 5) * a.rowpad : 0);
  return m;
}

// The block's constants into shared memory, and (backward) the warps'
// gradient slots and ds partials to 0; then the block waits for them.
__device__ __forceinline__ void stage(const Args& a, const Smem& m,
                                      bool backward, bool last) {
  const int nb = a.heads * a.dh;
  const int W = a.width;
  for (int e = threadIdx.x; e < nb; e += blockDim.x) m.bv[e] = a.b_v[e];
  for (int e = threadIdx.x; e < W; e += blockDim.x) {
    const float w1 = a.w_beta[e], w2 = a.w_beta[W + e];
    const float w3 = a.w_beta[2 * W + e];
    m.wa[e] = w1 + w3;
    m.wb[e] = w2 - w3;
    if (!last) {
      m.gp[e] = 1.f + a.ln_g[e];
      m.lb[e] = a.ln_b[e];
    }
  }
  if (backward) {
    const int lane = threadIdx.x & 31;
    for (int e = lane; e < a.heads * 32; e += 32) m.hp[e] = 0.f;
    for (int e = lane; e < (last ? 3 : 5) * a.rowpad; e += 32) m.acc[e] = 0.f;
  }
  __syncthreads();
}

// m at a unit: x + b_v on a hidden layer; on the last, x holds m.
template <int V, bool Last>
__device__ __forceinline__ void value(const Smem& m, int col,
                                      const float (&x)[V], float (&mm)[V]) {
  if constexpr (Last) {
#pragma unroll
    for (int i = 0; i < V; ++i) mm[i] = x[i];
  } else {
    float bv[V];
    ld<V>(m.bv + col, bv);
#pragma unroll
    for (int i = 0; i < V; ++i) mm[i] = __fadd_rn(x[i], bv[i]);
  }
}

// A row's inputs: its loads (r, v on a hidden layer, backward dy) issued
// together, the clamped sums into the warp's `sc`; then x = v / sc (hidden,
// into X) or the heads' mean m (last, into X), and the gate's dot, summed
// over the warp. Every lane returns the same bits.
template <int V, int KR, bool Last, bool Bwd>
__device__ __forceinline__ double row_in(const Args& a, const Smem& m,
                                         const Heads<V, KR>& hd,
                                         long long o, int lane,
                                         Row<V, KR>& X, Row<V, KR>& R,
                                         Row<V, KR>& G, float& s_lane) {
  const int W = a.width;
  const int units = W / V;
  const int nk = KR > 0 ? KR : (units + 31) >> 5;
  s_lane = lane < a.heads ? __ldg(a.s + o * a.heads + lane) : 0.f;
  const float* vrow = a.v + o * a.v_row;
#pragma unroll
  for (int k = 0; k < nk; ++k) {
    const int u = lane + 32 * k;
    if (u >= units) break;
    ldg<V>(a.r + o * W + u * V, R.at(k));
    if constexpr (Bwd) ldg<V>(a.dy + o * W + u * V, G.at(k));
    if constexpr (!Last) {
      const int c = hd.of(k, u);
      ldg<V>(vrow + c * a.v_head + (u * V - c * a.dh), X.at(k));
    }
  }
  __syncwarp();
  if (lane < a.heads) m.sc[lane] = floored(s_lane);
  __syncwarp();
  double dot = 0.0;
#pragma unroll
  for (int k = 0; k < nk; ++k) {
    const int u = lane + 32 * k;
    if (u >= units) break;
    const int col = u * V;
    float (&x)[V] = X.at(k);
    float (&r)[V] = R.at(k);
    float wa[V], wb[V];
    ld<V>(m.wa + col, wa);
    ld<V>(m.wb + col, wb);
    if constexpr (!Last) {
      const float sc = m.sc[hd.of(k, u)];
      float bv[V];
      ld<V>(m.bv + col, bv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        x[i] = __fdiv_rn(x[i], sc);
        const float mm = __fadd_rn(x[i], bv[i]);
        dot = fma(static_cast<double>(mm), static_cast<double>(wa[i]), dot);
        dot = fma(static_cast<double>(r[i]), static_cast<double>(wb[i]),
                  dot);
      }
    } else {
      float sum[V];
#pragma unroll
      for (int i = 0; i < V; ++i) sum[i] = 0.f;
      for (int c = 0; c < a.heads; ++c) {
        float vv[V], bv[V];
        ldg<V>(vrow + c * a.v_head + col, vv);
        ld<V>(m.bv + c * a.dh + col, bv);
        const float sc = m.sc[c];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          sum[i] = __fadd_rn(sum[i], __fadd_rn(__fdiv_rn(vv[i], sc), bv[i]));
        }
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        x[i] = __fdiv_rn(sum[i], static_cast<float>(a.heads));
        dot = fma(static_cast<double>(x[i]), static_cast<double>(wa[i]), dot);
        dot = fma(static_cast<double>(r[i]), static_cast<double>(wb[i]),
                  dot);
      }
    }
  }
  return warp_sum(dot);
}

// Two blocks an SM both ways: at three, the forward's register form
// spilled and ran 12 % slower at the cell's layer 0 (PERF.md, PR 23).
template <int V, int KR, bool Last>
__global__ void __launch_bounds__(32 * kWarps, 2)
    unimp_tail_fwd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  const Smem m = smem_at(a, base, threadIdx.x >> 5, false, Last);
  stage(a, m, false, Last);
  const int lane = threadIdx.x & 31;
  const int W = a.width;
  const int units = W / V;
  const int nk = KR > 0 ? KR : (units + 31) >> 5;
  Heads<V, KR> hd;
  hd.init(lane, units, a.dh);
  Row<V, KR> X, R, G;
  if constexpr (KR == 0) {
    X.staged = m.rows + lane * V;
    R.staged = X.staged + a.rowpad;
  }
  const long long step = static_cast<long long>(gridDim.x) * a.warps;
  for (long long o = static_cast<long long>(blockIdx.x) * a.warps +
                     (threadIdx.x >> 5);
       o < a.O; o += step) {
    float* yrow = a.y + o * W;
    if (!a.owned_mask[o]) {
      for (int u = lane; u < units; u += 32) st_zero<V>(yrow + u * V);
      if (!Last && lane == 0) a.mean[o] = a.rstd[o] = 0.f;
      continue;
    }
    float s_lane;
    const float beta = sigmoid(
        row_in<V, KR, Last, false>(a, m, hd, o, lane, X, R, G, s_lane));
    // out = m + beta (r - m), into X; its sum (hidden).
    double sum = 0.0;
#pragma unroll
    for (int k = 0; k < nk; ++k) {
      const int u = lane + 32 * k;
      if (u >= units) break;
      float (&x)[V] = X.at(k);
      const float(&r)[V] = R.at(k);
      float mm[V];
      value<V, Last>(m, u * V, x, mm);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        x[i] = gated(mm[i], r[i], beta);
        sum += x[i];
      }
      if constexpr (Last) st<V>(yrow + u * V, x);
    }
    if constexpr (!Last) {
      const double mean_d = warp_sum(sum) / W;
      double sq = 0.0;
#pragma unroll
      for (int k = 0; k < nk; ++k) {
        const int u = lane + 32 * k;
        if (u >= units) break;
        const float(&x)[V] = X.at(k);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const double d = static_cast<double>(x[i]) - mean_d;
          sq = fma(d, d, sq);
        }
      }
      const double var = warp_sum(sq) / W;
      const float mean = static_cast<float>(mean_d);
      const float rstd = static_cast<float>(1.0 / sqrt(var + a.eps));
#pragma unroll
      for (int k = 0; k < nk; ++k) {
        const int u = lane + 32 * k;
        if (u >= units) break;
        const int col = u * V;
        const float(&x)[V] = X.at(k);
        float gp[V], lb[V], out[V];
        ld<V>(m.gp + col, gp);
        ld<V>(m.lb + col, lb);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float z = affine(normed(x[i], mean, rstd), gp[i], lb[i]);
          out[i] = z > 0.f ? z : 0.f;
        }
        st<V>(yrow + col, out);
      }
      if (lane == 0) {
        a.mean[o] = mean;
        a.rstd[o] = rstd;
      }
    }
  }
}

template <int V, int KR, bool Last>
__global__ void __launch_bounds__(32 * kWarps, 2)
    unimp_tail_bwd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  const Smem m = smem_at(a, base, threadIdx.x >> 5, true, Last);
  stage(a, m, true, Last);
  const int lane = threadIdx.x & 31;
  const int W = a.width;
  const int units = W / V;
  const int nk = KR > 0 ? KR : (units + 31) >> 5;
  const int heads = a.heads;
  Heads<V, KR> hd;
  hd.init(lane, units, a.dh);
  Row<V, KR> X, R, G;
  if constexpr (KR == 0) {
    X.staged = m.rows + lane * V;
    R.staged = X.staged + a.rowpad;
    G.staged = R.staged + a.rowpad;
  }
  float* acc_bv = m.acc + kAccBv * a.rowpad + lane * V;
  float* acc_wa = m.acc + kAccWa * a.rowpad + lane * V;
  float* acc_wb = m.acc + kAccWb * a.rowpad + lane * V;
  float* acc_g = m.acc + kAccG * a.rowpad + lane * V;
  float* acc_b = m.acc + kAccB * a.rowpad + lane * V;
  const int hunits = heads * a.dh / V;  // a dv row's units, every head
  const long long step = static_cast<long long>(gridDim.x) * a.warps;
  for (long long d = static_cast<long long>(blockIdx.x) * a.warps +
                     (threadIdx.x >> 5);
       d < a.D; d += step) {
    const bool named = d < a.O && a.owned_mask[d];
    float* dvrow = a.dv + d * a.dv_row;
    if (!named) {
      for (int e = lane; e < hunits; e += 32) {
        const int c = e * V / a.dh;
        st_zero<V>(dvrow + c * a.dv_head + (e * V - c * a.dh));
      }
      for (int c = lane; c < heads; c += 32) a.ds[d * heads + c] = 0.f;
      if (d < a.O) {
        for (int u = lane; u < units; u += 32) st_zero<V>(a.dr + d * W + u * V);
      }
      continue;
    }
    float mean = 0.f, rstd = 0.f;
    if constexpr (!Last) {
      mean = __ldg(a.mean_in + d);
      rstd = __ldg(a.rstd_in + d);
    }
    float s_lane;
    const float beta = sigmoid(
        row_in<V, KR, Last, true>(a, m, hd, d, lane, X, R, G, s_lane));
    double dap = 0.0;
    if constexpr (!Last) {
      // LayerNorm's sums, and its weights' gradients.
      double s1 = 0.0, s2 = 0.0;
#pragma unroll
      for (int k = 0; k < nk; ++k) {
        const int u = lane + 32 * k;
        if (u >= units) break;
        const int col = u * V;
        const float(&x)[V] = X.at(k);
        const float(&r)[V] = R.at(k);
        const float(&g)[V] = G.at(k);
        float bv[V], gp[V], lb[V], dz[V], dzx[V];
        ld<V>(m.bv + col, bv);
        ld<V>(m.gp + col, gp);
        ld<V>(m.lb + col, lb);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xh =
              normed(gated(__fadd_rn(x[i], bv[i]), r[i], beta), mean, rstd);
          dz[i] = affine(xh, gp[i], lb[i]) > 0.f ? g[i] : 0.f;
          dzx[i] = dz[i] * xh;
          const float dxh = dz[i] * gp[i];
          s1 += dxh;
          s2 = fma(static_cast<double>(dxh), static_cast<double>(xh), s2);
        }
        add_to<V>(acc_g + k * 32 * V, dzx);
        add_to<V>(acc_b + k * 32 * V, dz);
      }
      const float c1 = static_cast<float>(warp_sum(s1) / W);
      const float c2 = static_cast<float>(warp_sum(s2) / W);
      // dout into G, and the gate's da.
#pragma unroll
      for (int k = 0; k < nk; ++k) {
        const int u = lane + 32 * k;
        if (u >= units) break;
        const int col = u * V;
        const float(&x)[V] = X.at(k);
        const float(&r)[V] = R.at(k);
        float (&g)[V] = G.at(k);
        float bv[V], gp[V], lb[V];
        ld<V>(m.bv + col, bv);
        ld<V>(m.gp + col, gp);
        ld<V>(m.lb + col, lb);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float mm = __fadd_rn(x[i], bv[i]);
          const float xh = normed(gated(mm, r[i], beta), mean, rstd);
          const float dz = affine(xh, gp[i], lb[i]) > 0.f ? g[i] : 0.f;
          g[i] = rstd * (dz * gp[i] - c1 - xh * c2);
          dap = fma(static_cast<double>(g[i]),
                    static_cast<double>(r[i] - mm), dap);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < nk; ++k) {
        const int u = lane + 32 * k;
        if (u >= units) break;
        const float(&x)[V] = X.at(k);
        const float(&r)[V] = R.at(k);
        const float(&g)[V] = G.at(k);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          dap = fma(static_cast<double>(g[i]),
                    static_cast<double>(r[i] - x[i]), dap);
        }
      }
    }
    const float da = static_cast<float>(warp_sum(dap)) * (beta * (1.f - beta));
    const float keep = 1.f - beta;
    // dm, dr, dv, the gate's and the value bias's gradients, ds's partials.
#pragma unroll
    for (int k = 0; k < nk; ++k) {
      const int u = lane + 32 * k;
      if (u >= units) break;
      const int col = u * V;
      const float(&x)[V] = X.at(k);
      const float(&r)[V] = R.at(k);
      const float(&g)[V] = G.at(k);
      float wa[V], wb[V], mm[V], dm[V], dr[V], twa[V], twb[V];
      ld<V>(m.wa + col, wa);
      ld<V>(m.wb + col, wb);
      value<V, Last>(m, col, x, mm);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        dm[i] = g[i] * keep + da * wa[i];
        dr[i] = g[i] * beta + da * wb[i];
        twa[i] = mm[i] * da;
        twb[i] = r[i] * da;
        if constexpr (Last) dm[i] = dm[i] / static_cast<float>(heads);
      }
      st<V>(a.dr + d * W + col, dr);
      add_to<V>(acc_wa + k * 32 * V, twa);
      add_to<V>(acc_wb + k * 32 * V, twb);
      add_to<V>(acc_bv + k * 32 * V, dm);
      if constexpr (!Last) {
        const int c = hd.of(k, u);
        const float inv = 1.f / m.sc[c];
        float dvv[V];
        float p = 0.f;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          dvv[i] = dm[i] * inv;
          p += dvv[i] * x[i];
        }
        st<V>(dvrow + c * a.dv_head + (col - c * a.dh), dvv);
        m.hp[c * 32 + lane] += p;
      } else {
        for (int c = 0; c < heads; ++c) {
          float vv[V], dvv[V];
          ldg<V>(a.v + d * a.v_row + c * a.v_head + col, vv);
          const float sc = m.sc[c];
          const float inv = 1.f / sc;
          float p = 0.f;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            dvv[i] = dm[i] * inv;
            p += dvv[i] * __fdiv_rn(vv[i], sc);
          }
          st<V>(dvrow + c * a.dv_head + col, dvv);
          m.hp[c * 32 + lane] += p;
        }
      }
    }
    for (int c = 0; c < heads; ++c) {
      const float p = warp_sum(m.hp[c * 32 + lane]);
      m.hp[c * 32 + lane] = 0.f;
      if (lane == c) a.ds[d * heads + c] = s_lane >= kFloor ? -p : 0.f;
    }
  }
  // The block's partial: its warps' slots added in order, in f64, laid out
  // as the gradients are: db_v [heads * dh], dwa, dwb, dwa - dwb [W] each,
  // then a hidden layer's dln_g, dln_b [W] each.
  __syncthreads();
  const int nb = heads * a.dh;
  for (int p = threadIdx.x; p < a.parts; p += blockDim.x) {
    int slot, col;  // slot -1: dwa - dwb
    if (p < nb) {
      slot = kAccBv, col = Last ? p % a.dh : p;
    } else if (p < nb + 3 * W) {
      const int q = (p - nb) / W;
      slot = q == 2 ? -1 : kAccWa + q, col = (p - nb) % W;
    } else {
      slot = kAccG + (p - nb - 3 * W) / W, col = (p - nb - 3 * W) % W;
    }
    double t = 0.0;
    if (slot < 0) {
      double t2 = 0.0;
      for (int w = 0; w < a.warps; ++w) {
        const float* acc = smem_at(a, base, w, true, Last).acc;
        t += acc[kAccWa * a.rowpad + col];
        t2 += acc[kAccWb * a.rowpad + col];
      }
      t -= t2;
    } else {
      for (int w = 0; w < a.warps; ++w) {
        t += smem_at(a, base, w, true, Last).acc[slot * a.rowpad + col];
      }
    }
    a.part[static_cast<long long>(blockIdx.x) * a.parts + p] = t;
  }
}

// The gradients: the blocks' partials added in block order, in f64,
// rounded once.
__global__ void __launch_bounds__(kSumThreads)
    unimp_tail_sum_kernel(const double* part, int grid, int parts,
                          float* out) {
  const int p = blockIdx.x * kSumThreads + threadIdx.x;
  if (p >= parts) return;
  double t = 0.0;
  for (int b = 0; b < grid; ++b) t += part[static_cast<long long>(b) * parts + p];
  out[p] = static_cast<float>(t);
}

// A's shared memory and its gradients' length, as the kernels lay them
// out; the shared form (`wide`) stages its rows. Returns the block's bytes.
size_t layout(Args& a, bool backward, bool wide) {
  const bool last = a.last != 0;
  a.rowpad = pad4(a.width);
  a.consts = pad4(static_cast<long long>(a.heads) * a.dh) +
             (last ? 2 : 4) * a.rowpad;
  a.per_warp = kMaxHeads +
               (backward ? a.heads * 32 + (last ? 3 : 5) * a.rowpad : 0) +
               (wide ? (backward ? 3 : 2) * a.rowpad : 0);
  a.parts = a.heads * a.dh + (last ? 3 : 5) * a.width;
  return sizeof(float) *
         (static_cast<size_t>(a.consts) +
          static_cast<size_t>(a.per_warp) * a.warps);
}

bool is_wide(const Args& a) { return a.width > 32 * kRowFloats; }

// The warps a block of the shared form fits (the register form takes
// kWarps), 0 if not one does.
int block_warps(Args a, bool backward) {
  const bool wide = is_wide(a);
  a.warps = 1;
  const size_t one = layout(a, backward, wide);
  const size_t warp = sizeof(float) * a.per_warp;
  const size_t consts = one - warp;
  if (one > kSmemBlock) return 0;
  const size_t fit = (kSmemBlock - consts) / warp;
  return static_cast<int>(fit < static_cast<size_t>(kWarps) ? fit : kWarps);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, bool carveout) {
  cudaError_t err = cudaSuccess;
  if (carveout) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  if (smem <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename Kernel>
cudaError_t go(Kernel kernel, const Args& a, int grid, size_t smem,
               bool carveout, cudaStream_t stream, int* per_sm) {
  cudaError_t err = prepare(kernel, smem, carveout);
  if (err != cudaSuccess) return err;
  if (per_sm != nullptr) {  // the blocks an SM holds, no launch
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kernel, 32 * a.warps, smem);
  }
  kernel<<<grid, 32 * a.warps, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int V, bool Last, bool Wide>
cudaError_t by_form(const Args& a, bool backward, int grid, size_t smem,
                    cudaStream_t stream, int* per_sm) {
  constexpr int KR = Wide ? 0 : kRowFloats / V;
  if (!backward) {
    return go(unimp_tail_fwd_kernel<V, KR, Last>, a, grid, smem, false,
              stream, per_sm);
  }
  return go(unimp_tail_bwd_kernel<V, KR, Last>, a, grid, smem, true, stream,
            per_sm);
}

template <int V>
cudaError_t by_layer(const Args& a, bool backward, int grid, size_t smem,
                     cudaStream_t stream, int* per_sm) {
  const bool wide = is_wide(a);
  if (a.last) {
    return wide ? by_form<V, true, true>(a, backward, grid, smem, stream,
                                         per_sm)
                : by_form<V, true, false>(a, backward, grid, smem, stream,
                                          per_sm);
  }
  return wide ? by_form<V, false, true>(a, backward, grid, smem, stream,
                                        per_sm)
              : by_form<V, false, false>(a, backward, grid, smem, stream,
                                         per_sm);
}

bool aligned(const void* p, int vec) {
  return reinterpret_cast<uintptr_t>(p) % (sizeof(float) * vec) == 0;
}

// The checks every entry makes (the read unit `vec` floats: dh, the
// strides and every vector-read address divisible by it; at most
// kMaxHeads heads), then the launch of `grid` blocks of a.warps warps, or
// (per_sm) the occupancy query.
int run(Args& a, int vec, bool backward, int grid, int device, void* stream,
        float* grads = nullptr, int* per_sm = nullptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.width = a.last ? a.dh : a.heads * a.dh;
  if (a.heads < 1 || a.heads > kMaxHeads || a.dh < 1 || a.D < 0 ||
      a.O < 0 || a.O > a.D || grid < 1 || a.warps < 1 || a.warps > kWarps ||
      (vec != 1 && vec != 2 && vec != 4) || a.dh % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = layout(a, backward, is_wide(a));
  if (smem > kSmemBlock) return static_cast<int>(cudaErrorInvalidValue);
  if (per_sm == nullptr) {
    const bool hidden_ok = a.last || (a.ln_g != nullptr && a.ln_b != nullptr);
    const bool fits =
        a.v_row % vec == 0 && a.v_head % vec == 0 && aligned(a.v, vec) &&
        aligned(a.r, vec) &&
        (backward ? aligned(a.dy, vec) && aligned(a.dv, vec) &&
                        aligned(a.dr, vec) && a.dv_row % vec == 0 &&
                        a.dv_head % vec == 0 && a.part != nullptr &&
                        grads != nullptr &&
                        (a.last || (a.mean_in != nullptr &&
                                    a.rstd_in != nullptr))
                  : aligned(a.y, vec) &&
                        (a.last || (a.mean != nullptr && a.rstd != nullptr)));
    if (!fits || !hidden_ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (per_sm == nullptr && (backward ? a.D : a.O) == 0) {
    if (!backward) return 0;
    // No row: the gradients are 0.
    return static_cast<int>(
        cudaMemsetAsync(grads, 0, sizeof(float) * a.parts, s));
  }
  switch (vec) {
    case 4:
      err = by_layer<4>(a, backward, grid, smem, s, per_sm);
      break;
    case 2:
      err = by_layer<2>(a, backward, grid, smem, s, per_sm);
      break;
    default:
      err = by_layer<1>(a, backward, grid, smem, s, per_sm);
  }
  if (err != cudaSuccess || per_sm != nullptr || !backward) {
    return static_cast<int>(err);
  }
  unimp_tail_sum_kernel<<<(a.parts + kSumThreads - 1) / kSumThreads,
                          kSumThreads, 0, s>>>(a.part, grid, a.parts, grads);
  return static_cast<int>(cudaGetLastError());
}

Args common(const void* v, long long v_row, long long v_head, const void* s,
            const void* r, const void* b_v, const void* w_beta,
            const void* ln_g, const void* ln_b, const void* owned_mask,
            long long d, long long o, int heads, int dh, int last,
            double eps, int warps) {
  Args a = {};
  a.v = static_cast<const float*>(v);
  a.v_row = v_row;
  a.v_head = v_head;
  a.s = static_cast<const float*>(s);
  a.r = static_cast<const float*>(r);
  a.b_v = static_cast<const float*>(b_v);
  a.w_beta = static_cast<const float*>(w_beta);
  a.ln_g = static_cast<const float*>(ln_g);
  a.ln_b = static_cast<const float*>(ln_b);
  a.owned_mask = static_cast<const unsigned char*>(owned_mask);
  a.D = d;
  a.O = o;
  a.heads = heads;
  a.dh = dh;
  a.last = last != 0;
  a.eps = eps;
  a.warps = warps;
  return a;
}

}  // namespace

// The entries launch on `stream` (a cudaStream_t) on device `device`,
// return the cudaError_t of the launch, 0 on success, and do not
// synchronise. v [d, heads, dh] through its strides (v_row, v_head
// floats), s [d, heads], r [o, W], b_v [heads * dh], w_beta [3 W], ln_g and
// ln_b [W] (null on the last layer, `last`), owned_mask [o] (owned row o is
// dst row o where it is set); `vec` floats a read unit; `grid` blocks of
// `warps` warps (unimp_tail_occupancy's); at most 32 heads.

// Forward: y [o, W], every row written; on a hidden layer mean and rstd
// [o] (0 at the pads).
extern "C" int unimp_tail_fwd(const void* v, long long v_row,
                              long long v_head, const void* s, const void* r,
                              const void* b_v, const void* w_beta,
                              const void* ln_g, const void* ln_b,
                              const void* owned_mask, long long d,
                              long long o, int heads, int dh, int last,
                              double eps, int vec, int warps, int grid,
                              void* y, void* mean, void* rstd, int device,
                              void* stream) {
  Args a = common(v, v_row, v_head, s, r, b_v, w_beta, ln_g, ln_b,
                  owned_mask, d, o, heads, dh, last, eps, warps);
  a.y = static_cast<float*>(y);
  a.mean = static_cast<float*>(mean);
  a.rstd = static_cast<float*>(rstd);
  return run(a, vec, false, grid, device, stream);
}

// Backward, from dy [o, W] and (hidden) the forward's mean and rstd: dv [d,
// heads, dh] through its strides, ds [d, heads], dr [o, W], every row
// written; the weights' gradients into grads (f32: db_v [heads * dh], then
// dwa, dwb, dwa - dwb [W] each, then a hidden layer's dln_g, dln_b [W]
// each), through part (f64, [grid, that length], the blocks' partials).
extern "C" int unimp_tail_bwd(const void* dy, const void* v, long long v_row,
                              long long v_head, const void* s, const void* r,
                              const void* b_v, const void* w_beta,
                              const void* ln_g, const void* ln_b,
                              const void* owned_mask, const void* mean,
                              const void* rstd, long long d, long long o,
                              int heads, int dh, int last, double eps,
                              int vec, int warps, int grid, void* dv,
                              long long dv_row, long long dv_head, void* ds,
                              void* dr, void* part, void* grads, int device,
                              void* stream) {
  Args a = common(v, v_row, v_head, s, r, b_v, w_beta, ln_g, ln_b,
                  owned_mask, d, o, heads, dh, last, eps, warps);
  a.dy = static_cast<const float*>(dy);
  a.mean_in = static_cast<const float*>(mean);
  a.rstd_in = static_cast<const float*>(rstd);
  a.dv = static_cast<float*>(dv);
  a.dv_row = dv_row;
  a.dv_head = dv_head;
  a.ds = static_cast<float*>(ds);
  a.dr = static_cast<float*>(dr);
  a.part = static_cast<double*>(part);
  return run(a, vec, true, grid, device, stream, static_cast<float*>(grads));
}

// A kernel's block: its warps (*warps), the blocks an SM holds at once
// (*per_sm) and whether it takes the shared form (*shared); no launch.
extern "C" int unimp_tail_occupancy(int backward, int last, int vec,
                                    int heads, int dh, int device,
                                    int* warps, int* per_sm, int* shared) {
  Args a = common(nullptr, 0, 0, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, 0, 0, heads, dh, last, 1e-5, 1);
  a.width = last ? dh : heads * dh;
  a.warps = block_warps(a, backward != 0);
  *warps = a.warps;
  *shared = is_wide(a);
  *per_sm = 0;
  if (a.warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  return run(a, vec, backward != 0, 1, device, nullptr, nullptr, per_sm);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
