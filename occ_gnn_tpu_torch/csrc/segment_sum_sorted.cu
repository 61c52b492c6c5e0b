// Sorted segment-sum for Hopper (sm_90a):
//
//   out[d, :] = sum over edges e with edge_dst[e] == d of msgs[e, :]
//
// msgs is f32 [E, H] row-major, edge_dst is int32 [E] sorted ascending,
// and padding edges carry edge_dst == num_segments. out is f32
// [num_segments, H]. This is the contract of the TPU kernel it replaces,
// occ_gnn_tpu/ops/pallas_spmm_blocked.py::segment_sum_sorted.
//
// Bound: device-memory bytes. Each valid edge row is read once and each
// output row written once, with one add per element read, far below the
// card's arithmetic rate.
//
// Design. The TPU kernel re-aligns the edge stream into chunks and sums
// each dst tile with one-hot matrix products, because its grid runs in
// order on one core and its matrix unit is the fast path. None of that
// is carried over. Here one warp owns one dst row:
//   * the warp finds its edge range [lower_bound(d), lower_bound(d+1))
//     by binary search over the sorted edge_dst (lane 0 searches for d,
//     lane 1 for d+1, in parallel);
//   * lanes stride over the H columns, four floats at a time (float4)
//     when H % 4 == 0 and both base pointers are 16-byte aligned, one
//     float at a time otherwise, so each edge row is one coalesced read;
//   * the sum stays in f32 registers and is written once: no atomics, so
//     the result is deterministic, an empty row writes 0, and the
//     padding tail (edge_dst == num_segments) is never visited.
// Offsets e * H are 64-bit: at the innermost block E * H passes 2^31 on
// larger graphs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ long long lower_bound(const int* __restrict__ a,
                                                 long long n, int key) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ void zero(float& v) { v = 0.f; }
__device__ __forceinline__ void zero(float4& v) { v = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void add(float& acc, float v) { acc += v; }
__device__ __forceinline__ void add(float4& acc, float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// V is float or float4; width is H in units of V.
template <typename V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_sorted_kernel(const V* __restrict__ msgs,
                          const int* __restrict__ edge_dst,
                          long long num_edges, int width, int num_segments,
                          V* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= num_segments) return;  // the whole warp leaves together
  const long long found =
      lower_bound(edge_dst, num_edges, static_cast<int>(row) + (lane & 1));
  const long long begin = __shfl_sync(kFullMask, found, 0);
  const long long end = __shfl_sync(kFullMask, found, 1);
  for (int c = lane; c < width; c += 32) {
    V acc;
    zero(acc);
    const V* p = msgs + begin * width + c;
#pragma unroll 4
    for (long long e = begin; e < end; ++e, p += width) add(acc, __ldg(p));
    out[row * width + c] = acc;
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t) on device `device`; returns the
// cudaError_t of the launch, 0 on success. Does not synchronise.
extern "C" int segment_sum_sorted_f32(const void* msgs, const void* edge_dst,
                                      long long num_edges, int h,
                                      int num_segments, void* out,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_segments <= 0 || h <= 0) return 0;
  const dim3 grid((num_segments + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = h % 4 == 0 && reinterpret_cast<uintptr_t>(msgs) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int* dst = static_cast<const int*>(edge_dst);
  if (vec) {
    segment_sum_sorted_kernel<float4><<<grid, block, 0, s>>>(
        static_cast<const float4*>(msgs), dst, num_edges, h / 4, num_segments,
        static_cast<float4*>(out));
  } else {
    segment_sum_sorted_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(msgs), dst, num_edges, h, num_segments,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
