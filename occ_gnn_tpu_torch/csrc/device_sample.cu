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
//       pad, over all D.
//   draw_neighbors: quiver's next frontier. out [n * (1 + K)] int32; out[i]
//       = frontier[i] for i < n, and out[n + s * K + k] = indices[indptr[f]
//       + r[s, k] % deg] for f = frontier[s], deg its in-degree, or f
//       itself where deg == 0.
//   gather_mean: quiver's deepest gather and first-layer mean. For each
//       self row s < n of the deepest frontier f [n * (1 + K)]: x_self[s] =
//       float(x[f[s]]) and mean[s] = (x_self[s] + sum over k = 0..K-1, in
//       order, of float(x[f[n + s * K + k]])) / (K + 1), both f32 [n, H],
//       for an f32 or bf16 table x [rows, H].
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
// modulo a draw, one add an element read). What each design does about it:
//   * synthesize_innermost: one thread a dst column, looping over k, so a
//     warp's reads of draws[k, :] and writes of nbr[k + 1, :] coalesce;
//     kChunk slots' indices loads are in flight a thread. Only the columns
//     of deg > K read their draws. num_owned is summed in the same launch:
//     each block writes its count of valid columns, and the last block to
//     finish (a ticket the caller keeps at zero between launches, reset by
//     that block) sums them in a fixed order. No memset, no atomics on an
//     output.
//   * draw_neighbors: one thread an output word; the frontier and the draws
//     read coalesced, the CSR at random.
//   * gather_mean: a warp a self row, lanes over H (16-byte loads of 4 f32
//     columns where H % 4 == 0 and the table is 16-byte aligned, 8-byte
//     loads of 4 bf16 columns where H % 4 == 0 and it is 8-byte aligned,
//     one element a lane otherwise), kUnroll neighbour rows in flight a
//     lane; the row ids read once a warp (a lane each) and passed by
//     shuffles. Each neighbour row is read once, summed in f32 registers in
//     the order of k, and the [n * (1 + K), H] frame of the plain version is
//     never written. The sum order of k is the plain version's at every
//     element, so the mean differs from it only where torch's own sum over
//     the fan-out axis takes another order.
//
// A table row or CSR entry outside its array stops the kernel with a
// device-side assert, as torch.index_select does on the card (JAX clamps
// silently). Offsets row * H and k * D are 64-bit.

#include <assert.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a block, every kernel
constexpr int kChunk = 8;      // a synthesis column's slots in flight
constexpr int kUnroll = 8;     // a gather_mean lane's rows in flight
constexpr int kLanes = 32;
constexpr unsigned kFullMask = 0xffffffffu;

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// ---------------------------------------------------------------------
// synthesize_innermost

__global__ void __launch_bounds__(kThreads)
synthesize_kernel(const int* __restrict__ dst, int D,
                  const int* __restrict__ indptr, long long num_nodes,
                  const int* __restrict__ indices, long long num_indices,
                  const long long* __restrict__ draws, int K, int out_cap,
                  int zero_row, int* __restrict__ nbr,
                  int* __restrict__ owned_idx, float* __restrict__ owned_deg,
                  int* __restrict__ self_idx,
                  unsigned char* __restrict__ owned_mask,
                  int* __restrict__ num_owned, int* block_counts,
                  unsigned int* ticket) {
  __shared__ bool last_block;
  __shared__ int warp_sums[kThreads / kLanes];
  const int d = blockIdx.x * kThreads + threadIdx.x;
  int valid = 0;
  if (d < D) {
    const int gd = __ldg(dst + d);
    valid = gd >= 0;
    const int g = valid ? gd : 0;
    int off = 0, deg = 0;
    if (valid) {
      assert(g < num_nodes);
      off = __ldg(indptr + g);
      deg = __ldg(indptr + g + 1) - off;
    }
    const int take = deg < K ? deg : K;
    const long long ld = D;
    nbr[d] = valid ? g : zero_row;
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      int v[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int k = k0 + j;
        v[j] = zero_row;
        if (k < take) {
          int sel = k;
          if (deg > K) {
            const unsigned long long r =
                static_cast<unsigned long long>(__ldg(draws + k * ld + d));
            sel = static_cast<int>(r % static_cast<unsigned int>(deg));
          }
          assert(off + sel < num_indices);
          v[j] = __ldg(indices + off + sel);
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (k0 + j < K) nbr[(k0 + j + 1) * ld + d] = v[j];
      }
    }
    if (d < out_cap) {
      owned_idx[d] = valid ? d : -1;
      owned_deg[d] = valid ? static_cast<float>(take + 1) : 1.0f;
      self_idx[d] = g;
      owned_mask[d] = static_cast<unsigned char>(valid);
    }
  }
  // num_owned: this block's count, then the last block's fixed-order sum.
  const int count = __syncthreads_count(valid);
  if (threadIdx.x == 0) {
    block_counts[blockIdx.x] = count;
    __threadfence();
    last_block = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  int sum = 0;
  for (int b = threadIdx.x; b < gridDim.x; b += kThreads) {
    sum += static_cast<volatile int*>(block_counts)[b];
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o /= 2) {
    sum += __shfl_down_sync(kFullMask, sum, o);
  }
  if (threadIdx.x % kLanes == 0) warp_sums[threadIdx.x / kLanes] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / kLanes; ++w) total += warp_sums[w];
    *num_owned = total;
    *ticket = 0u;  // ready for the next launch
  }
}

// ---------------------------------------------------------------------
// draw_neighbors

__global__ void __launch_bounds__(kThreads)
draw_kernel(const int* __restrict__ frontier, long long n,
            const int* __restrict__ indptr, long long num_nodes,
            const int* __restrict__ indices, long long num_indices,
            const int* __restrict__ r, int K, int* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n * (1 + K)) return;
  if (i < n) {
    out[i] = __ldg(frontier + i);
    return;
  }
  const long long j = i - n;  // s * K + k
  const int f = __ldg(frontier + j / K);
  assert(f >= 0 && f < num_nodes);
  const int start = __ldg(indptr + f);
  const int deg = __ldg(indptr + f + 1) - start;
  int v = f;
  if (deg > 0) {
    const int pos = start + __ldg(r + j) % deg;
    assert(pos < num_indices);
    v = __ldg(indices + pos);
  }
  out[i] = v;
}

// ---------------------------------------------------------------------
// gather_mean

__device__ __forceinline__ float2 bf16x2(uint32_t raw) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
}

// Column group c of row r of a row-major [*, width groups] table as f32,
// for each input type and group size, and the f32 arithmetic on groups.
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
                                                long long r, int width,
                                                int c) {
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

__device__ __forceinline__ void zero(float& a) { a = 0.0f; }
__device__ __forceinline__ void zero(float4& a) {
  a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
__device__ __forceinline__ void add(float& a, float v) { a += v; }
__device__ __forceinline__ void add(float4& a, const float4& v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}
// (s + a) / div, per element.
__device__ __forceinline__ float mean_of(float s, float a, float div) {
  return (s + a) / div;
}
__device__ __forceinline__ float4 mean_of(const float4& s, const float4& a,
                                          float div) {
  return make_float4((s.x + a.x) / div, (s.y + a.y) / div, (s.z + a.z) / div,
                     (s.w + a.w) / div);
}

template <typename In, int VEC>
__global__ void __launch_bounds__(kThreads)
gather_mean_kernel(const In* __restrict__ x, long long x_rows, int h,
                   const int* __restrict__ f, long long n, int K,
                   float* __restrict__ x_self, float* __restrict__ mean) {
  using R = Rows<In, VEC>;
  using Acc = typename R::Acc;
  const long long s =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kLanes;
  const int lane = threadIdx.x % kLanes;
  if (s >= n) return;  // whole warps: s is the same across a warp
  const int width = h / VEC;
  const float div = static_cast<float>(K + 1);
  const int self = __ldg(f + s);
  assert(self >= 0 && self < x_rows);
  const int* nbrs = f + n + s * K;
  Acc* self_out = reinterpret_cast<Acc*>(x_self + s * h);
  Acc* mean_out = reinterpret_cast<Acc*>(mean + s * h);
  for (int c0 = 0; c0 < width; c0 += kLanes) {
    const int c = c0 + lane;
    const bool on = c < width;
    Acc acc;
    zero(acc);
    for (int k0 = 0; k0 < K; k0 += kLanes) {
      const int kn = K - k0 < kLanes ? K - k0 : kLanes;
      int mine = 0;
      if (lane < kn) {
        mine = __ldg(nbrs + k0 + lane);
        assert(mine >= 0 && mine < x_rows);
      }
      for (int k1 = 0; k1 < kn; k1 += kUnroll) {
        Acc v[kUnroll];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          const int row = __shfl_sync(kFullMask, mine, (k1 + j) % kLanes);
          if (on && k1 + j < kn) v[j] = R::load(x, row, width, c);
        }
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          if (on && k1 + j < kn) add(acc, v[j]);
        }
      }
    }
    if (on) {
      const Acc sv = R::load(x, self, width, c);
      self_out[c] = sv;
      mean_out[c] = mean_of(sv, acc, div);
    }
  }
}

template <typename In, int VEC>
cudaError_t launch_gather_mean(const void* x, long long x_rows, int h,
                               const void* f, long long n, int k,
                               void* x_self, void* mean, cudaStream_t s) {
  const long long blocks = (n * kLanes + kThreads - 1) / kThreads;
  gather_mean_kernel<In, VEC><<<static_cast<unsigned>(blocks), kThreads, 0,
                                s>>>(
      static_cast<const In*>(x), x_rows, h, static_cast<const int*>(f), n, k,
      static_cast<float*>(x_self), static_cast<float*>(mean));
  return cudaGetLastError();
}

}  // namespace

// The entries launch on `stream` (a cudaStream_t) on device `device`,
// return the cudaError_t of the launch, 0 on success, and do not
// synchronise. Every array is contiguous; the CSR is int32 indptr
// [num_nodes + 1] and indices [num_indices].

// The blocks of a synthesize_innermost launch over d columns: the int32
// block_counts it takes.
extern "C" long long synthesize_innermost_blocks(long long d) {
  return (d + kThreads - 1) / kThreads;
}

// dst int32 [d]; draws int64 [k, d] in [0, 2^63); nbr int32 [k + 1, d];
// owned_idx, self_idx int32 [out_cap], owned_deg f32 [out_cap], owned_mask
// bool [out_cap]; num_owned int32 []; block_counts int32
// [synthesize_innermost_blocks(d)]; ticket uint32 [1], zero before the
// launch and zero after it.
extern "C" int synthesize_innermost(
    const void* dst, long long d, const void* indptr, long long num_nodes,
    const void* indices, long long num_indices, const void* draws, int k,
    int out_cap, int zero_row, void* nbr, void* owned_idx, void* owned_deg,
    void* self_idx, void* owned_mask, void* num_owned, void* block_counts,
    void* ticket, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d < 1 || d > 2147483647LL || k < 1 || out_cap < 0 || out_cap > d ||
      num_nodes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  synthesize_kernel<<<static_cast<unsigned>(synthesize_innermost_blocks(d)),
                      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(dst), static_cast<int>(d),
      static_cast<const int*>(indptr), num_nodes,
      static_cast<const int*>(indices), num_indices,
      static_cast<const long long*>(draws), k, out_cap, zero_row,
      static_cast<int*>(nbr), static_cast<int*>(owned_idx),
      static_cast<float*>(owned_deg), static_cast<int*>(self_idx),
      static_cast<unsigned char*>(owned_mask), static_cast<int*>(num_owned),
      static_cast<int*>(block_counts), static_cast<unsigned int*>(ticket));
  return static_cast<int>(cudaGetLastError());
}

// frontier int32 [n]; r int32 [n, k] in [0, 2^31); out int32 [n * (1 + k)].
extern "C" int draw_neighbors(const void* frontier, long long n,
                              const void* indptr, long long num_nodes,
                              const void* indices, long long num_indices,
                              const void* r, int k, void* out, int device,
                              void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0 || k < 1 || num_nodes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = n * (1 + k);
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return 0;
  draw_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(frontier), n, static_cast<const int*>(indptr),
      num_nodes, static_cast<const int*>(indices), num_indices,
      static_cast<const int*>(r), k, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x f32 (x_bf16 == 0) or bf16 [x_rows, h]; f int32 [n * (1 + k)]; x_self
// and mean f32 [n, h].
extern "C" int gather_mean(const void* x, int x_bf16, long long x_rows, int h,
                           const void* f, long long n, int k, void* x_self,
                           void* mean, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (h < 0 || n < 0 || k < 0 || x_rows < 1 ||
      n * kLanes / kThreads >= 2147483647LL) {
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
