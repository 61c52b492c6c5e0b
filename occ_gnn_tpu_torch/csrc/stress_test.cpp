// Standalone stress driver for the sampling/slicing service
// (occ_sampler.cpp), meant for sanitizer builds: no CPython in the
// process, so every ThreadSanitizer / AddressSanitizer report is ours.
//
//   python -c "from occ_gnn_tpu_torch.ops.build import build_stress; \
//              print(build_stress('thread'))"     # then run the binary
//
// Exercises the concurrent surface: several workers sampling and slicing
// with cache routing (compact maps), emit-range sharding (the full range,
// and ranges of two partitions, the feed of a process that holds two),
// worker-side gathers of the refresh tail's features in f32 and bf16,
// reservoir draws (a fanout above 64), the per-slot scatter's plan beside
// the dense matrix past layer 0 (each row's slots in slot order, checked
// against the matrix), delivery of out-of-order completions, and
// shutdown with work in flight.
//
// It declares the service's C interface as occ_sampler.cpp defines it:
// occ_create's 33 parameters, occ_next's field list, occ_stats' four
// doubles. Exit code 0 and "STRESS OK" when every batch came back clean.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>

extern "C" {
void* occ_create(int64_t num_nodes, const int64_t* indptr,
                 const int64_t* indices, const int32_t* wmap, int32_t P,
                 int32_t L, const int32_t* fanouts, const int64_t* frame_caps,
                 const int64_t* edge_caps, const int64_t* dst_caps,
                 const int64_t* out_caps, const int64_t* shuffle_caps,
                 const int64_t* deg_caps, const int32_t* owner_local,
                 const int64_t* foreign_off, const int64_t* foreign_nodes,
                 const int32_t* foreign_local, int64_t tail_start,
                 int64_t refresh_cap, int32_t num_workers,
                 int32_t queue_depth, uint64_t seed, int32_t sample_replace,
                 int32_t emit_lo, int32_t emit_hi, int32_t emit_coo,
                 int32_t emit_input, const float* features,
                 int64_t feat_stride, int32_t feat_cols, int32_t feat_bf16,
                 int32_t replicated, int32_t device_innermost,
                 int32_t plan_span);
void occ_submit(void* handle, const int64_t* nodes, int64_t n, int64_t seq);
int32_t occ_next(void* handle, void** field_ptrs, int64_t* seq_out);
void occ_stats(void* handle, double* out4);
void occ_destroy(void* handle);
}

namespace {

constexpr int64_t N = 8000;
constexpr int P = 4;
constexpr int L = 2;
constexpr int64_t DEG = 8;
constexpr int BATCHES = 10;
constexpr int64_t BS = 128;
constexpr int WORKERS = 3;
constexpr int32_t FEAT = 16;

struct Emit {
  int lo, hi;     // partitions emitted: [lo, hi)
  int coo;        // emit_coo: the edge lists beside the dense matrix
  int input;      // emit_input: the input frame's ids
  int features;   // 0: no tail gather, 1: f32 rows, 2: bf16 rows
  int plan;       // plan_span: the per-slot scatter's plan past layer 0
                  // (0: none), rows of more than `plan` slots listed
};

}  // namespace

int main() {
  std::mt19937_64 rng(7);
  std::vector<int64_t> indptr(N + 1);
  for (int64_t i = 0; i <= N; i++) indptr[i] = i * DEG;
  std::vector<int64_t> indices(N * DEG);
  for (auto& v : indices) v = (int64_t)(rng() % N);
  std::vector<int32_t> wmap(N);
  for (int64_t i = 0; i < N; i++) wmap[i] = (int32_t)(i % P);
  std::vector<float> features((size_t)N * FEAT);
  for (size_t i = 0; i < features.size(); i++)
    features[i] = (float)(i % 97) * 0.25f;

  int32_t fanouts[L] = {4, 70};  // 70 > 64 exercises reservoir sampling
  // Generous caps (worst-case-ish); layer 0 is the innermost.
  int64_t frame_caps[L + 1] = {60000, 1024, 256};
  int64_t edge_caps[L] = {60000, 1280};
  int64_t dst_caps[L] = {2048, 384};
  int64_t out_caps[L] = {1024, 256};
  int64_t shuffle_caps[L] = {1024, 256};
  int64_t deg_caps[L] = {71, 5};

  // Compact cache maps: 10% of each partition's nodes statically cached.
  std::vector<int32_t> owner_local(N, -1);
  std::vector<int64_t> cnt(P, 0);
  for (int64_t i = 0; i < N; i++)
    if ((i / P) % 10 == 0) owner_local[i] = (int32_t)cnt[wmap[i]]++;
  int64_t foreign_off[P + 1] = {0, 0, 0, 0, 0};
  const int64_t tail_start = 2400;
  const int64_t refresh_cap = 50000;
  frame_caps[0] = tail_start + refresh_cap + 1;

  const Emit configs[] = {
      {0, P, 1, 1, 0, 0},  // every partition, COO and dense, input ids
      {2, 4, 0, 1, 1, 3},  // a process holding two: f32 tail rows, plans
                           // (a span of 3, so that rows are listed)
      {1, 3, 1, 0, 2, 0},  // two in the middle: bf16 rows, no input ids
  };
  int cfg = 0;
  for (const Emit& e : configs) {
    const int PE = e.hi - e.lo;
    void* svc = occ_create(
        N, indptr.data(), indices.data(), wmap.data(), P, L, fanouts,
        frame_caps, edge_caps, dst_caps, out_caps, shuffle_caps, deg_caps,
        owner_local.data(), foreign_off, nullptr, nullptr, tail_start,
        refresh_cap, WORKERS, 4, 42 + cfg, /*sample_replace=*/0, e.lo, e.hi,
        e.coo, e.input, e.features ? features.data() : nullptr, FEAT, FEAT,
        e.features == 2, /*replicated=*/0, /*device_innermost=*/0,
        e.plan);

    // Receive buffers in occ_next's field order (device_innermost off).
    std::vector<std::vector<int32_t>> bufs;
    std::vector<void*> ptrs;
    size_t nbr_buf = 0, plan_buf = 0;  // layer 1's matrix and plan
    auto add = [&](size_t bytes) {
      bufs.emplace_back((bytes + 3) / 4);
      ptrs.push_back(bufs.back().data());
    };
    for (int l = 0; l < L; l++) {
      if (e.coo || deg_caps[l] <= 0) {
        add((size_t)PE * edge_caps[l] * 4);          // edge_src
        add((size_t)PE * edge_caps[l] * 4);          // edge_dst
      }
      add((size_t)PE * P * shuffle_caps[l] * 4);     // push
      add((size_t)PE * P * shuffle_caps[l] * 4);     // recv
      add((size_t)PE * out_caps[l] * 4);             // owned_idx
      add((size_t)PE * out_caps[l] * 4);             // owned_deg (f32)
      add((size_t)PE * out_caps[l] * 4);             // self_idx
      add((size_t)PE * out_caps[l]);                 // owned_mask (u8)
      add((size_t)PE * 4);                           // num_owned
      if (deg_caps[l] > 0) {
        nbr_buf = bufs.size();
        add((size_t)PE * deg_caps[l] * dst_caps[l] * 4);  // nbr
      }
      if (e.plan && l > 0 && deg_caps[l] > 0) {
        const int64_t slots = deg_caps[l] * dst_caps[l];
        plan_buf = bufs.size();
        add((size_t)PE * frame_caps[l] * 4);             // plan_offsets
        add((size_t)PE * slots * 4);                     // plan_slots
        add((size_t)PE * (slots / (e.plan + 1) + 1) * 4);  // plan_long
        add((size_t)PE * 4);                             // plan_num_long
      }
    }
    if (e.input) add((size_t)PE * frame_caps[0] * 4);  // input_nodes
    add((size_t)PE * out_caps[L - 1] * 4);             // targets
    add((size_t)P * refresh_cap * 4);                  // refresh (all P)
    if (e.features)                                    // gathered tail
      add((size_t)PE * refresh_cap * FEAT * (e.features == 2 ? 2 : 4));

    for (int b = 0; b < BATCHES; b++) {
      std::vector<int64_t> nodes(BS);
      for (auto& v : nodes) v = (int64_t)(rng() % N);
      occ_submit(svc, nodes.data(), BS, b);
    }
    // Completion order is worker-dependent; the seq tags let the caller
    // reorder. Every batch must come back once, without an error.
    std::vector<int> seen(BATCHES, 0);
    for (int b = 0; b < BATCHES; b++) {
      int64_t seq = -1;
      int32_t err = occ_next(svc, ptrs.data(), &seq);
      if (err != 0 || seq < 0 || seq >= BATCHES || seen[seq]++) {
        std::fprintf(stderr, "cfg %d: batch seq %lld error %d\n", cfg,
                     (long long)seq, err);
        return 1;
      }
      // The plan of layer 1's matrix: each row's slots name it, in slot
      // order, the lists hold every valid slot, and the rows of more than
      // e.plan slots are listed in increasing order, then -1.
      for (int q = 0; e.plan && q < PE; q++) {
        const int64_t K = deg_caps[1], D = dst_caps[1], F = frame_caps[1];
        const int32_t* nb = bufs[nbr_buf].data() + q * K * D;
        const int32_t* offs = bufs[plan_buf].data() + q * F;
        const int32_t* slots = bufs[plan_buf + 1].data() + q * K * D;
        const int64_t long_cap = K * D / (e.plan + 1) + 1;
        const int32_t* longs = bufs[plan_buf + 2].data() + q * long_cap;
        const int32_t num_long = bufs[plan_buf + 3][q];
        int64_t valid = 0;
        for (int64_t i = 0; i < K * D; i++) valid += nb[i] != F - 1;
        bool ok = offs[0] == 0 && offs[F - 1] == valid;
        for (int64_t s = 0; ok && s + 1 < F; s++) {
          for (int32_t j = offs[s]; ok && j < offs[s + 1]; j++) {
            ok = nb[slots[j]] == s &&
                 (j == offs[s] || slots[j - 1] < slots[j]);
          }
        }
        int64_t n_long = 0;
        for (int64_t s = 0; ok && s + 1 < F; s++) {
          if (offs[s + 1] - offs[s] > e.plan) ok = longs[n_long++] == s;
        }
        ok = ok && num_long == n_long;
        for (int64_t i = n_long; ok && i < long_cap; i++) ok = longs[i] == -1;
        if (!ok) {
          std::fprintf(stderr, "cfg %d: batch %lld partition %d: bad plan\n",
                       cfg, (long long)seq, q);
          return 1;
        }
      }
    }
    double st[4];
    occ_stats(svc, st);
    if (st[3] < BATCHES) {
      std::fprintf(stderr, "cfg %d: %g samples counted for %d batches\n",
                   cfg, st[3], BATCHES);
      return 1;
    }
    std::printf("cfg %d: emit [%d, %d), %d batches ok, sample %.3fs slice "
                "%.3fs tail gather %.3fs\n", cfg, e.lo, e.hi, BATCHES, st[0],
                st[1], st[2]);
    // Leave one batch in flight to exercise shutdown with queued work.
    std::vector<int64_t> extra(BS, 1);
    occ_submit(svc, extra.data(), BS, BATCHES);
    occ_destroy(svc);
    cfg++;
  }
  std::puts("STRESS OK");
  return 0;
}
