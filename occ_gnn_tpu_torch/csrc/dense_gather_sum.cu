// Dense gather-sum for Hopper (sm_90a): split's aggregation through the
// dense [K, D] neighbour matrix, forward and backward, one launch each.
//
//   dense_gather_sum:   out[d, :] = sum over k = 0..K-1, in order, of
//                                   float(x[nbr[k, d], :])
//   dense_scatter_add:  dx[nbr[k, d], :] += g[d, :]  for every slot
//
// x is f32 or bf16 [S, H] row-major, and its last row S - 1 is the frame's
// reserved zero row that every padding slot names; nbr is int32 [K, D],
// k-major, row k at nbr + k * ld (ld >= D: a dst tile of a wider matrix
// is passed as a column slice); out and g are f32 [D, H], dx f32 [S, H].
//
// Replaces: occ_gnn_tpu/parallel/split.py:161-197 (local_aggregate_dense),
// its default unrolled branch at :191-197, which XLA compiles into one
// 26-way add fusion (no pallas_call), and the transpose of that gather
// that XLA derives for the backward.
//
// Bound: device-memory bytes. The forward reads K rows of x for each dst
// and writes one f32 row; the backward reads one g row for each dst and
// adds it into K rows of dx. Each element read or written costs one add,
// far below the card's arithmetic rate, so the design is about bytes and
// loads in flight.
//
// Design:
//   * A team of threads for each dst row, one thread for each 16-byte
//     (f32) or 8-byte (bf16) column group: 25 threads at H = 100 f32, 32
//     at H = 128. A block holds as many teams as fit in 256 threads (10 at
//     H = 100, 8 at H = 128) and takes that many consecutive dst rows.
//   * The block copies its dst rows' K indices into shared memory with
//     coalesced loads, each nbr entry read once from device memory; a team
//     then reads its index from shared memory as one broadcast. An index
//     outside [0, S) stops the kernel with a device-side assert, as
//     torch.index_select does on the card (JAX clamps it silently).
//   * Forward: each thread keeps its column group's sum in f32 registers
//     and walks k = 0..K-1 in order, with kUnroll row loads in flight
//     before the adds that consume them; it writes its row once. Only adds
//     in the order of k, from the first row on: the result equals the plain
//     version (the first gathered row in f32, then add_ of each later k)
//     bit for bit.
//   * Backward: each thread reads its g row's column group once into
//     registers and adds it into dx[nbr[k, d]] for each k with f32 atomics
//     (four-wide on sm_90), as index_add_ does on the card. The slots that
//     name the zero row (every padding slot, and every slot of a padding
//     dst column) would serialise on one row of dx: a team sums its share
//     in registers, the block sums the teams' in shared memory, and the
//     block adds that with one atomic a column group. The order of the
//     atomics differs from run to run, so the sums do too, within f32
//     rounding.
//   * Vector loads where the rows allow them: float4 for f32 rows when
//     H % 4 == 0 and the pointers are 16-byte aligned; 8-byte loads of 4
//     bf16 when H % 4 == 0 and x is 8-byte aligned (a bf16 row of H = 100
//     is 200 B, so only every other row starts on 16 B); one element a
//     thread otherwise.
//   * Row offsets are 64-bit: row * H passes 2^31 on larger graphs.

#include <assert.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // at most, a block
constexpr int kUnroll = 8;     // row loads in flight a thread
// Shared memory a block may take without opting in to more.
constexpr size_t kSmemBytes = 48 * 1024;

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

__device__ __forceinline__ void atomic_add(float* p, float v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void atomic_add(float4* p, const float4& v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(p, v);
#else
  float* q = reinterpret_cast<float*>(p);
  atomicAdd(q, v.x);
  atomicAdd(q + 1, v.y);
  atomicAdd(q + 2, v.z);
  atomicAdd(q + 3, v.w);
#endif
}
// Shared memory has no four-wide float atomic.
__device__ __forceinline__ void shared_add(float* p, float v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void shared_add(float4* p, const float4& v) {
  float* q = reinterpret_cast<float*>(p);
  atomicAdd(q, v.x);
  atomicAdd(q + 1, v.y);
  atomicAdd(q + 2, v.z);
  atomicAdd(q + 3, v.w);
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

// Words of shared memory a block's staged indices take, rounded up to 16
// bytes so that what follows them is aligned for float4.
__host__ __device__ __forceinline__ int staged_words(int K, int teams) {
  return (K * teams + 3) / 4 * 4;
}

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

template <typename Acc>
__global__ void __launch_bounds__(kThreads)
scatter_add(const Acc* __restrict__ g, const int* __restrict__ nbr,
            long long ld, int K, long long D, long long x_rows, int width,
            int team_threads, int teams, Acc* __restrict__ dx) {
  extern __shared__ int s_nbr[];
  // The block's sum of its zero-row slots, a row of width column groups,
  // 16-byte aligned after the indices.
  Acc* s_zero = reinterpret_cast<Acc*>(s_nbr + staged_words(K, teams));
  const long long d0 = static_cast<long long>(blockIdx.x) * teams;
  stage_indices(nbr, ld, K, D, x_rows, teams, d0, s_nbr);
  Acc z;
  zero(z);
  for (int c = threadIdx.x; c < width; c += blockDim.x) s_zero[c] = z;
  __syncthreads();
  const int team = threadIdx.x / team_threads;
  const int col0 = threadIdx.x - team * team_threads;
  const long long d = d0 + team;
  const int zero_row = static_cast<int>(x_rows - 1);
  bool any_zero = false;
  if (team < teams && d < D) {
    const int* idx = s_nbr + team;  // idx[k * teams]
    for (int c = col0; c < width; c += team_threads) {
      const Acc gv = __ldg(g + d * width + c);
      Acc zsum = z;
      bool hit = false;
      for (int k = 0; k < K; ++k) {
        const int r = idx[k * teams];
        if (r == zero_row) {
          add(zsum, gv);
          hit = true;
        } else {
          atomic_add(dx + static_cast<long long>(r) * width + c, gv);
        }
      }
      if (hit) {
        shared_add(s_zero + c, zsum);
        any_zero = true;
      }
    }
  }
  if (__syncthreads_or(any_zero)) {
    for (int c = threadIdx.x; c < width; c += blockDim.x) {
      atomic_add(dx + static_cast<long long>(zero_row) * width + c,
                 s_zero[c]);
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// A block's teams and threads for rows of `width` column groups, with K
// indices a dst staged in shared memory (and `extra` bytes beside them);
// 0 teams when even one dst's indices do not fit.
struct Geometry {
  int team_threads, teams, threads;
  size_t smem;
};

Geometry geometry(int width, int K, size_t extra) {
  Geometry geo;
  geo.team_threads = width < kThreads ? width : kThreads;
  geo.teams = kThreads / geo.team_threads;
  // Leave 16 bytes for the rounding of staged_words.
  const long long fit =
      extra + 16 >= kSmemBytes
          ? 0
          : static_cast<long long>((kSmemBytes - extra - 16) /
                                   (sizeof(int) * K));
  if (fit < geo.teams) geo.teams = static_cast<int>(fit);
  geo.threads = (geo.teams * geo.team_threads + 31) / 32 * 32;
  geo.smem = sizeof(int) * staged_words(K, geo.teams) + extra;
  return geo;
}

template <typename In, int VEC>
cudaError_t launch_gather(const void* x, long long x_rows, int h,
                          const void* nbr, long long ld, int K, long long D,
                          void* out, cudaStream_t stream) {
  using Acc = typename Rows<In, VEC>::Acc;
  const int width = h / VEC;
  const Geometry geo = geometry(width, K, 0);
  if (geo.teams < 1) return cudaErrorInvalidValue;
  const long long blocks = (D + geo.teams - 1) / geo.teams;
  gather_sum<In, VEC><<<static_cast<unsigned>(blocks), geo.threads, geo.smem,
                        stream>>>(
      static_cast<const In*>(x), x_rows, static_cast<const int*>(nbr), ld, K,
      D, width, geo.team_threads, geo.teams, static_cast<Acc*>(out));
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_scatter(const void* g, const void* nbr, long long ld,
                           int K, long long D, int h, long long x_rows,
                           void* dx, cudaStream_t stream) {
  using Acc = typename Rows<float, VEC>::Acc;
  const int width = h / VEC;
  const Geometry geo = geometry(width, K, sizeof(float) * h);
  if (geo.teams < 1) return cudaErrorInvalidValue;
  const long long blocks = (D + geo.teams - 1) / geo.teams;
  scatter_add<Acc><<<static_cast<unsigned>(blocks), geo.threads, geo.smem,
                     stream>>>(
      static_cast<const Acc*>(g), static_cast<const int*>(nbr), ld, K, D,
      x_rows, width, geo.team_threads, geo.teams, static_cast<Acc*>(dx));
  return cudaGetLastError();
}

// What both entries check before a launch: the device, the shapes, and
// whether there is anything to do (*done when not).
int prologue(int h, int K, long long D, long long x_rows, long long ld,
             int device, bool* done) {
  *done = true;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // A block takes one dst row at least, and a grid at most 2^31 - 1.
  if (h < 0 || K < 1 || D < 0 || D > 2147483647LL || ld < D || x_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (D == 0 || h == 0) return 0;
  *done = false;
  return 0;
}

}  // namespace

// Both entries launch on `stream` (a cudaStream_t) on device `device`,
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
  const bool vec = h % 4 == 0 && aligned(x, x_bf16 ? 8 : 16) &&
                   aligned(out, 16);
  cudaError_t err;
  if (x_bf16) {
    err = vec ? launch_gather<__nv_bfloat16, 4>(x, x_rows, h, nbr, ld, k, d,
                                                out, s)
              : launch_gather<__nv_bfloat16, 1>(x, x_rows, h, nbr, ld, k, d,
                                                out, s);
  } else {
    err = vec ? launch_gather<float, 4>(x, x_rows, h, nbr, ld, k, d, out, s)
              : launch_gather<float, 1>(x, x_rows, h, nbr, ld, k, d, out, s);
  }
  return static_cast<int>(err);
}

// dx[nbr[k, d]] += g[d] for every slot; g f32 [D, h], dx f32 [x_rows, h],
// both contiguous, dx zeroed by the caller.
extern "C" int dense_scatter_add(const void* g, const void* nbr, long long ld,
                                 int k, long long d, int h, long long x_rows,
                                 void* dx, int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool done = false;
  const int early = prologue(h, k, d, x_rows, ld, device, &done);
  if (done) return early;
  const bool vec = h % 4 == 0 && aligned(g, 16) && aligned(dx, 16);
  const cudaError_t err =
      vec ? launch_scatter<4>(g, nbr, ld, k, d, h, x_rows, dx, s)
          : launch_scatter<1>(g, nbr, ld, k, d, h, x_rows, dx, s);
  return static_cast<int>(err);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
