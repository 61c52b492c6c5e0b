// occ_sampler — multithreaded host-side neighbor sampling + split slicing
// service for the TPU training loop.
//
// TPU-native re-design of the reference's C++ slicer stack
// (/root/reference/cslicer/: pyfrontend.cpp CSlicer service, WorkerPool.cpp
// producer/consumer, slicer.cpp fused sample+slice, bipartite.h append-CSR
// builder, util/duplicate.cpp mask-based dedup, util/conqueue.h bounded
// queue). Differences driven by the TPU consumer:
//   * emits fixed-capacity PADDED arrays (edge COO sorted by local dst,
//     paired push/recv shuffle indices, owned sets, degree totals) —
//     device-ready for jax, instead of ragged per-GPU CSR objects;
//   * fanouts / layer count / partition count are configuration, not
//     hard-coded constants (reference hard-codes 4 GPUs / 3 layers /
//     fanout 10, slicer.h:16, slicer.cpp:10,75);
//   * cache-aware innermost-layer routing (natural edges) is built in,
//     with per-sample dynamic-tail assignment so worker threads share no
//     mutable cache state (the reference mutates global maps per batch,
//     memory_manager.py:75-106, which would race under its own WorkerPool);
//   * dedup keeps the reference's O(1) mask-array renumbering trick
//     (duplicate.cpp:14-39) — it is the right tool on the host.
//
// The port's copy adds one output to the JAX package's service: on
// request (occ_create's last argument, the plan's span) the transpose of
// every dense matrix past layer 0, the plan of the per-slot scatter in
// split GAT's backward (csrc/dense_gather_sum.cu), counted in the
// matrix's own edge walk and filled by one k-major walk.
//
// Exposed to Python via a C ABI (ctypes) — see sampling/native.py.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

#ifdef __linux__
#include <sys/resource.h>
#include <sys/syscall.h>
#include <unistd.h>
#endif

namespace {

constexpr int MAX_LAYERS = 8;

struct Config {
  int64_t num_nodes = 0;
  const int64_t* indptr = nullptr;
  const int64_t* indices = nullptr;
  const int32_t* wmap = nullptr;
  int32_t P = 0;
  int32_t L = 0;
  int32_t fanouts[MAX_LAYERS] = {0};  // sampling order (targets outward)
  // capacities, innermost-first (python caps dict order)
  int64_t frame_caps[MAX_LAYERS + 1] = {0};
  int64_t edge_caps[MAX_LAYERS] = {0};
  int64_t dst_caps[MAX_LAYERS] = {0};
  int64_t out_caps[MAX_LAYERS] = {0};
  int64_t shuffle_caps[MAX_LAYERS] = {0};
  // Dense neighbor-matrix depth per layer: fanout+1 (self loop included) —
  // a hard bound under fanout sampling; < 0 disables the dense layout
  // (full-neighborhood layers have unbounded degree).
  int64_t deg_caps[MAX_LAYERS] = {0};
  // optional cache
  // Compact cache maps (papers100M-viable; the dense [N, P] maps of the
  // reference MemoryManager would be ~16 GB at N=111M):
  //   owner_local[N]   frame row of node on its OWNER partition, -1 if not
  //                    statically cached there
  //   foreign_off[P+1] / foreign_nodes / foreign_local: per-partition
  //                    sorted (global id -> frame row) high-degree foreign
  //                    extras (empty when cache_pct <= 1/P)
  const int32_t* owner_local = nullptr;
  const int64_t* foreign_off = nullptr;
  const int64_t* foreign_nodes = nullptr;
  const int32_t* foreign_local = nullptr;

  // Frame row of u among partition p's foreign extras, -1 if absent.
  inline int32_t foreign_row(int64_t u, int p) const {
    if (!foreign_off) return -1;
    const int64_t* lo = foreign_nodes + foreign_off[p];
    const int64_t* hi = foreign_nodes + foreign_off[p + 1];
    const int64_t* it = std::lower_bound(lo, hi, u);
    if (it != hi && *it == u)
      return foreign_local[foreign_off[p] + (it - lo)];
    return -1;
  }
  int64_t tail_start = 0;
  int64_t refresh_cap = 0;
  int64_t cache_frame_cap = 0;
  int32_t sample_replace = 1;  // 1: rand%deg (reference slicer.cpp); 0: DGL
  // Multi-host work sharding: emit padded arrays only for partitions in
  // [emit_lo, emit_hi) — each host builds just its local rows (routing and
  // error checks stay global so every host agrees on each batch), so
  // per-host EMISSION scales with the emitted share (measured 0.64x of
  // single-host at 2 hosts, 0.49x floor at 8 — the replicated routing
  // passes don't shard; multihost_scale.jsonl). Default [0, P): emit all.
  int32_t emit_lo = 0;
  int32_t emit_hi = 0;  // 0 means "set to P at create time"
  // Payload trimming (VERDICT r3 item 1): when a layer carries the dense
  // nbr matrix the device never reads the COO (parallel/split.aggregate
  // prefers nbr), and when a feature cache feeds the step the input-frame
  // global ids are never read — skip copying either out, cutting the
  // per-batch host->device arena.
  int32_t emit_coo = 1;    // 1: always copy edge_src/edge_dst out
  int32_t emit_input = 1;  // 1: copy input_nodes out
  // Worker-side cache-tail feature gather (r4): with a feature table
  // configured, each worker gathers+casts the refresh rows' features into
  // the sample, so the Python consumer never touches the table — the
  // gather+cast (~194 ms/batch serial at products scale, 5.4x the device
  // step) parallelizes across workers and pipelines ahead.
  const float* features = nullptr;  // [num_nodes, feat_stride] f32
  int64_t feat_stride = 0;          // row stride in ELEMENTS (padded H)
  int32_t feat_cols = 0;            // columns to copy (true feature dim)
  int32_t feat_bf16 = 0;            // 1: cast to bf16; 0: copy f32
  // Replicated identity cache (cache_pct == 1.0, HBM-auto-sized): every
  // partition holds the whole feature table at frame row == global id.
  // Every edge is natural (executes on its dst's owner — zero
  // innermost-layer shuffle at any P) and src row lookup is the id
  // itself (no owner_local walk / foreign binary search).
  int32_t replicated = 0;
  // Device-side innermost sampling (requires replicated): the deepest
  // fanout expansion — the dominant host cost AND the dominant
  // host->device payload (the [K_cap, D_cap] nbr matrix) — is skipped
  // here; layer 0 emits ONLY dst_global (the would-be frontier's global
  // ids in per-partition dst order) and the device synthesizes the
  // neighbor matrix per step from a resident CSR
  // (parallel/split.synthesize_device_innermost).
  int32_t device_innermost = 0;
  // The per-slot scatter's plan (ops/dense_gather_sum.ScatterPlan) beside
  // every dense matrix past layer 0 when > 0: split GAT's training asks
  // for it, so that its backward sums a row a slot with no transpose on
  // the device. Rows of more than plan_span slots are listed (a whole
  // block of the kernel sums each); the caller passes the kernel's value,
  // ops/dense_gather_sum.SPAN.
  int32_t plan_span = 0;
  inline bool local(int p) const { return p >= emit_lo && p < emit_hi; }
  inline int32_t n_emit() const { return emit_hi - emit_lo; }
  inline bool coo_out(int l) const {
    return emit_coo != 0 || deg_caps[l] <= 0;
  }
  inline bool plan_out(int l) const {
    return plan_span > 0 && l > 0 && deg_caps[l] > 0;
  }
  // Room for the plan's rows of more than plan_span of `slots` slots.
  inline int64_t long_capacity(int64_t slots) const {
    return slots / (plan_span + 1) + 1;
  }
};

struct Edge {
  int32_t dst_row;   // row in the layer's frontier
  int32_t src_pos;   // row in the layer's frame (dst-first dedup order)
};

struct LayerSample {
  std::vector<Edge> edges;
  std::vector<int32_t> counts;       // per frontier row, incl self loop
  std::vector<int64_t> frame;        // deduped frontier of the next layer
  std::vector<int32_t> frame_owner;  // wmap[frame]
  std::vector<int32_t> frame_rank;   // rank within owner
};

// One fully sliced sample, innermost-first layers, flat padded arrays.
struct Sample {
  struct Layer {
    std::vector<int32_t> edge_src, edge_dst;    // [P * E_cap]
    std::vector<int32_t> push, recv;            // [P * P * S_cap]
    std::vector<int32_t> owned_idx, self_idx;   // [P * O_cap]
    std::vector<float> owned_deg;               // [P * O_cap]
    std::vector<uint8_t> owned_mask;            // [P * O_cap]
    std::vector<int32_t> num_owned;             // [P]
    // Dense transposed neighbor matrix [P * K_cap * D_cap], padded with
    // the src frame's reserved zero row; empty when deg_cap < 0. The
    // device aggregates with K_cap row-gathers instead of a scatter-add
    // (TPU scatter lowering is ~3.3x slower at production shapes).
    std::vector<int32_t> nbr;
    // nbr's plan when plan_out(l): per partition, offsets [F_cap] (the
    // exclusive scan of the slots naming each row s < F_cap - 1), slots
    // [K_cap * D_cap] (each row's slot ids k * D_cap + d in slot order;
    // the tail past offsets[F_cap - 1] is unread and not copied out),
    // plan_long [long_capacity] (the rows of more than plan_span slots in
    // increasing order, then -1) and plan_num_long [1].
    std::vector<int32_t> plan_offsets, plan_slots, plan_long, plan_num_long;
    // Device-innermost mode, layer 0 only: global ids of the dst frame
    // rows in per-partition rank order [P * D_cap], pad -1 — the ONLY
    // field emitted for that layer.
    std::vector<int32_t> dst_global;
  };
  std::vector<Layer> layers;
  std::vector<int32_t> input_nodes;    // [P * F0_cap], pad -1
  std::vector<int32_t> targets;        // [P * T_cap], pad -1
  std::vector<int32_t> refresh_nodes;  // [P * refresh_cap], pad -1
  // Gathered tail features for emitted partitions, filled prefix per
  // partition only: [PE * refresh_cap * feat_cols] as bf16 (u16) or f32
  // (2 u16 words). Beyond each partition's fill count the content is
  // UNSPECIFIED (those frame rows are never referenced by the batch).
  std::vector<uint16_t> tail_feats;
  std::vector<int64_t> tail_fill;      // [P] rows gathered per partition
  int32_t error = 0;  // 0 ok; >0 capacity overflow code
  int64_t seq = -1;   // submission sequence number (ordered delivery)
};

template <typename T>
class BoundedQueue {
 public:
  explicit BoundedQueue(size_t cap) : cap_(cap) {}
  // False when the queue is closed: the caller still owns ``v``.
  bool push(T v) {
    std::unique_lock<std::mutex> lk(mu_);
    not_full_.wait(lk, [&] { return q_.size() < cap_ || closed_; });
    if (closed_) return false;
    q_.push(std::move(v));
    not_empty_.notify_one();
    return true;
  }
  bool pop(T* out) {
    std::unique_lock<std::mutex> lk(mu_);
    not_empty_.wait(lk, [&] { return !q_.empty() || closed_; });
    if (q_.empty()) return false;
    *out = std::move(q_.front());
    q_.pop();
    not_full_.notify_one();
    return true;
  }
  // Blocks until an item is queued or the queue is closed, and leaves
  // the item queued: false when the queue is closed and empty.
  bool wait() {
    std::unique_lock<std::mutex> lk(mu_);
    waiting_++;
    not_empty_.wait(lk, [&] { return !q_.empty() || closed_; });
    bool ready = !q_.empty();
    if (--waiting_ == 0) no_waiters_.notify_all();
    return ready;
  }
  void close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    not_empty_.notify_all();
    not_full_.notify_all();
  }
  // Blocks until no thread is inside ``wait``: after ``close``, the queue
  // may then be freed.
  void drain_waiters() {
    std::unique_lock<std::mutex> lk(mu_);
    no_waiters_.wait(lk, [&] { return waiting_ == 0; });
  }

 private:
  size_t cap_;
  std::queue<T> q_;
  std::mutex mu_;
  std::condition_variable not_empty_, not_full_, no_waiters_;
  bool closed_ = false;
  int waiting_ = 0;
};

// Phase-timer accumulators (role of the reference's enum-indexed TIMERS,
// src/util/timer.h:7-48): nanoseconds spent sampling vs slicing across all
// workers, plus samples produced. Read via occ_stats.
struct Stats {
  std::atomic<int64_t> sample_ns{0};
  std::atomic<int64_t> slice_ns{0};
  std::atomic<int64_t> tail_ns{0};  // worker-side tail feature gather
  std::atomic<int64_t> samples{0};
};

// Round-to-nearest-even f32 -> bf16 (matches ml_dtypes/XLA casts on
// finite values; feature tables are finite by construction).
static inline uint16_t f32_to_bf16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  x += 0x7FFFu + ((x >> 16) & 1u);
  return (uint16_t)(x >> 16);
}

struct XorShift {
  uint64_t s;
  explicit XorShift(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ULL) {}
  inline uint64_t next() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  }
  // Uniform draw from [0, bound) via Lemire's multiply-shift reduction —
  // a 64-bit modulo costs ~30 cycles and the sampler draws one per edge;
  // the multiply-high costs ~3. Bias is bound/2^64 (immeasurable for any
  // real degree; validated by the chi-square distribution tests).
  inline uint64_t bounded(uint64_t bound) {
    return (uint64_t)(((__uint128_t)next() * bound) >> 64);
  }
};

class Worker {
 public:
  Worker(const Config& cfg, uint64_t seed, Stats* stats = nullptr)
      : cfg_(cfg), rng_(seed), seed_base_(seed), stats_(stats) {
    mask_.assign(cfg.num_nodes, 0);
    foreign_mask_.assign(cfg.P, {});
    int64_t max_frontier = 0;
    for (int l = 0; l <= cfg.L; l++)
      max_frontier = std::max(max_frontier, cfg.frame_caps[l] * cfg.P + 8);
    for (int p = 0; p < cfg.P; p++) foreign_mask_[p].assign(max_frontier, 0);
    if (cfg.owner_local) tail_id_.assign(cfg.num_nodes, -1);
    layers_.resize(cfg.L);
    for_e_.resize(cfg.P);
    foreign_rows_.resize(cfg.P);
    ecnt_.resize(cfg.P);
    own_cursor_.resize(cfg.P);
    cursor_.resize(cfg.P);
    fcnt_.resize(cfg.P);
    n_own_.resize(cfg.P);
  }

  // Sample + slice one batch into `out`. Returns false on overflow (error
  // code is set in out->error). The RNG is re-seeded from (base_seed, seq)
  // so a batch's content is independent of WHICH worker processed it —
  // required for deterministic multi-host replicated sampling.
  bool process(const std::vector<int64_t>& batch, Sample* out, int64_t seq);

 private:
  void sample_raw(const std::vector<int64_t>& batch);
  bool slice_layer(int l, Sample* out);
  void write_plan(const int32_t* nb, int64_t K_cap, int64_t D_cap,
                  int64_t n_dst, int64_t used, int64_t F_cap,
                  int32_t sentinel, int32_t* offs, int32_t* slots,
                  int32_t* longs, int64_t long_cap, int32_t* num_long);

  const Config& cfg_;
  XorShift rng_;
  uint64_t seed_base_ = 0;
  Stats* stats_ = nullptr;
  std::vector<int32_t> mask_;  // global-id scratch (dedup / tail)
  std::vector<int64_t> frontier0_;
  std::vector<int32_t> f0_owner_, f0_rank_;
  std::vector<LayerSample> layers_;
  std::vector<std::vector<int32_t>> foreign_mask_;  // per partition
  std::vector<int32_t> tail_id_;                    // per-sample tail assign
  std::vector<int64_t> tail_nodes_scratch_;
  std::vector<int64_t> chosen_scratch_;  // reservoir scratch (fanout > 64)
  // slice_layer arenas, reused across batches (per-batch std::vector
  // construction was the dominant slicing cost after the memory walks —
  // see benchmarks/probe_slicer.py before/after records).
  std::vector<std::vector<Edge>> for_e_;            // foreign-dst buckets
  std::vector<std::vector<int32_t>> foreign_rows_;  // per partition
  std::vector<int64_t> ecnt_, own_cursor_, cursor_, fcnt_;
  std::vector<int32_t> n_own_;
  std::vector<int32_t> plan_cursor_;  // the plan's fill, a row each
  // Frame-indexed routing precompute for the cache layer: src partition
  // and frame row per UNIQUE src node instead of per edge (the frame is
  // ~5x smaller than the edge list, so ~5x fewer random N-sized lookups).
  // Packed as (part << 32) | row so the edge loop costs ONE cache line
  // per src lookup.
  std::vector<int64_t> src_route_;
  static inline int32_t route_part(int64_t r) { return (int32_t)(r >> 32); }
  static inline int32_t route_row(int64_t r) { return (int32_t)r; }
};

void Worker::sample_raw(const std::vector<int64_t>& batch) {
  // Initial frontier: sorted unique batch (numpy np.unique semantics).
  frontier0_ = batch;
  std::sort(frontier0_.begin(), frontier0_.end());
  frontier0_.erase(std::unique(frontier0_.begin(), frontier0_.end()),
                   frontier0_.end());
  f0_owner_.resize(frontier0_.size());
  f0_rank_.resize(frontier0_.size());
  {
    std::vector<int32_t> cnt(cfg_.P, 0);
    for (size_t i = 0; i < frontier0_.size(); i++) {
      int32_t p = cfg_.wmap[frontier0_[i]];
      f0_owner_[i] = p;
      f0_rank_[i] = cnt[p]++;
    }
  }

  const int64_t* frontier = frontier0_.data();
  int64_t n = (int64_t)frontier0_.size();
  // Device-innermost: the deepest expansion is synthesized on the TPU
  // from a resident CSR; skip it here (and clear the stale layer so the
  // refresh/input loops over deepest.frame see an empty frame).
  const int depths = cfg_.device_innermost ? cfg_.L - 1 : cfg_.L;
  if (cfg_.device_innermost) {
    LayerSample& last = layers_[cfg_.L - 1];
    last.edges.clear();
    last.counts.clear();
    last.frame.clear();
    last.frame_owner.clear();
    last.frame_rank.clear();
  }
  for (int d = 0; d < depths; d++) {
    LayerSample& ls = layers_[d];
    ls.edges.clear();
    ls.counts.assign(n, 0);
    ls.frame.clear();
    ls.frame_owner.clear();
    ls.frame_rank.clear();
    // Frame prefix: the frontier itself (dst-first ordering).
    std::vector<int32_t> owner_cnt(cfg_.P, 0);
    for (int64_t i = 0; i < n; i++) {
      int64_t v = frontier[i];
      ls.frame.push_back(v);
      mask_[v] = (int32_t)ls.frame.size();  // pos + 1
      int32_t p = cfg_.wmap[v];
      ls.frame_owner.push_back(p);
      ls.frame_rank.push_back(owner_cnt[p]++);
    }
    int fanout = cfg_.fanouts[d];
    int64_t chosen_stack[64];  // Floyd's scratch for small fanout
    // Per-neighbor dedup/renumber (reference duplicate.cpp:14-39 trick).
    // Called through the chunked emitter below, which prefetches the
    // mask_/indices cache lines a chunk ahead — the random walks over the
    // N-sized mask and the adjacency array are the sampling bottleneck,
    // and chunking turns their serial misses into parallel ones.
    auto emit = [&](int64_t i, int64_t u) {
      int32_t pos = mask_[u];
      if (pos == 0) {
        ls.frame.push_back(u);
        pos = (int32_t)ls.frame.size();
        mask_[u] = pos;
        int32_t pp = cfg_.wmap[u];
        ls.frame_owner.push_back(pp);
        ls.frame_rank.push_back(owner_cnt[pp]++);
      }
      ls.edges.push_back({(int32_t)i, pos - 1});
    };
    constexpr int64_t CHUNK = 32;
    int64_t ubuf[CHUNK];
    for (int64_t i = 0; i < n; i++) {
      int64_t v = frontier[i];
      if (i + 4 < n) __builtin_prefetch(&cfg_.indptr[frontier[i + 4]]);
      // self loop first (mask already set: src_pos = i)
      ls.edges.push_back({(int32_t)i, (int32_t)i});
      int64_t deg = cfg_.indptr[v + 1] - cfg_.indptr[v];
      int64_t off = cfg_.indptr[v];
      // fanout < 0 means full neighborhood (reference fanout=-1)
      int64_t take = (fanout < 0 || deg <= fanout) ? deg : fanout;
      bool subsample = take != deg;
      const int64_t* chosen = nullptr;  // offsets into the adjacency row
      int64_t nc = take;
      if (subsample && !cfg_.sample_replace) {
        // `fanout` DISTINCT offsets from [0, deg) (DGL sample_neighbors
        // semantics). Small fanout: Floyd's algorithm (O(fanout) linear
        // membership scans are cache-cheap). Large fanout: reservoir
        // sampling, Algorithm R (O(deg), no membership scans) — no silent
        // with-replacement degradation at any fanout.
        int64_t* ch = chosen_stack;
        if (fanout <= 64) {
          int64_t k2 = 0;
          for (int64_t j = deg - fanout; j < deg; j++) {
            int64_t t = (int64_t)rng_.bounded((uint64_t)(j + 1));
            bool seen = false;
            for (int64_t k = 0; k < k2; k++)
              if (ch[k] == t) { seen = true; break; }
            ch[k2++] = seen ? j : t;
          }
          nc = k2;
        } else {
          chosen_scratch_.resize(fanout);
          ch = chosen_scratch_.data();
          for (int64_t j = 0; j < fanout; j++) ch[j] = j;
          for (int64_t j = fanout; j < deg; j++) {
            int64_t t = (int64_t)rng_.bounded((uint64_t)(j + 1));
            if (t < fanout) ch[t] = j;
          }
          nc = fanout;
        }
        chosen = ch;
      }
      int64_t done = 0;
      while (done < nc) {
        int64_t m = std::min(CHUNK, nc - done);
        if (chosen != nullptr) {
          for (int64_t t = 0; t < m; t++)
            __builtin_prefetch(&cfg_.indices[off + chosen[done + t]]);
          for (int64_t t = 0; t < m; t++)
            ubuf[t] = cfg_.indices[off + chosen[done + t]];
        } else if (take == deg) {
          for (int64_t t = 0; t < m; t++)
            ubuf[t] = cfg_.indices[off + done + t];
        } else {  // with replacement: rand % deg (reference slicer.cpp)
          for (int64_t t = 0; t < m; t++)
            ubuf[t] = (int64_t)rng_.bounded((uint64_t)deg);
          for (int64_t t = 0; t < m; t++)
            __builtin_prefetch(&cfg_.indices[off + ubuf[t]]);
          for (int64_t t = 0; t < m; t++)
            ubuf[t] = cfg_.indices[off + ubuf[t]];
        }
        for (int64_t t = 0; t < m; t++) __builtin_prefetch(&mask_[ubuf[t]]);
        for (int64_t t = 0; t < m; t++) emit(i, ubuf[t]);
        done += m;
      }
      ls.counts[i] = (int32_t)(nc + 1);  // + self loop
    }
    for (int64_t v : ls.frame) mask_[v] = 0;
    frontier = ls.frame.data();
    n = (int64_t)ls.frame.size();
  }
}

// One partition's plan of its dense matrix nb [K_cap, D_cap] (rows of a
// frame of F_cap, the last the zero row `sentinel`; its first n_dst
// columns in use, naming its first `used` frame rows): offs holds each
// row s's slot count at offs[s + 1] (0 at offs[0]) and becomes its
// exclusive scan; the rows of more than plan_span slots are listed; then
// one walk of nb in the order of slot ids (k-major) writes each slot id
// at its row's cursor, so every row's list is in slot order with no
// sort. The tail of `slots`, past the lists, is unread and left as it
// was.
void Worker::write_plan(const int32_t* nb, int64_t K_cap, int64_t D_cap,
                        int64_t n_dst, int64_t used, int64_t F_cap,
                        int32_t sentinel, int32_t* offs, int32_t* slots,
                        int32_t* longs, int64_t long_cap,
                        int32_t* num_long) {
  int32_t n_long = 0, run = 0;
  for (int64_t s = 0; s < used; s++) {
    const int32_t c = offs[s + 1];
    if (c > cfg_.plan_span) longs[n_long++] = (int32_t)s;
    run += c;
    offs[s + 1] = run;
  }
  std::fill(offs + used + 1, offs + F_cap, run);
  std::fill(longs + n_long, longs + long_cap, -1);
  *num_long = n_long;
  plan_cursor_.assign(offs, offs + used);
  int32_t* cur = plan_cursor_.data();
  for (int64_t k = 0; k < K_cap; k++) {
    const int32_t* row = nb + k * D_cap;
    for (int64_t d = 0; d < n_dst; d++) {
      const int32_t s = row[d];
      if (s != sentinel) slots[cur[s]++] = (int32_t)(k * D_cap + d);
    }
  }
}

bool Worker::slice_layer(int l, Sample* out) {
  const int P = cfg_.P;
  int d = cfg_.L - 1 - l;  // sampled depth consumed by model layer l
  const LayerSample& ls = layers_[d];
  // Frontier of depth d == frame of depth d-1 (or the initial frontier);
  // per-row global ids are read through the frame prefix (src_row_), so
  // only the owner/rank views are needed here.
  const int32_t* dst_owner =
      d == 0 ? f0_owner_.data() : layers_[d - 1].frame_owner.data();
  const int32_t* dst_rank =
      d == 0 ? f0_rank_.data() : layers_[d - 1].frame_rank.data();
  int64_t n = d == 0 ? (int64_t)frontier0_.size()
                     : (int64_t)layers_[d - 1].frame.size();

  const int64_t E_cap = cfg_.edge_caps[l];
  const int64_t D_cap = cfg_.dst_caps[l];
  const int64_t O_cap = cfg_.out_caps[l];
  const int64_t S_cap = cfg_.shuffle_caps[l];
  const bool use_cache = (l == 0) && cfg_.owner_local != nullptr;

  Sample::Layer& L = out->layers[l];
  if (l == 0 && cfg_.device_innermost) {
    // The device synthesizes this layer from the resident CSR; emit only
    // the dst frame's global ids in per-partition rank order.
    const int PE0 = cfg_.n_emit();
    const int LO0 = cfg_.emit_lo;
    const int64_t* dst_ids =
        d == 0 ? frontier0_.data() : layers_[d - 1].frame.data();
    L.dst_global.assign((size_t)PE0 * D_cap, -1);
    for (int64_t i = 0; i < n; i++) {
      int p = dst_owner[i];
      int32_t t = dst_rank[i];
      if (t >= D_cap) {
        out->error = 3;  // dst frame overflow
        return false;
      }
      if (cfg_.local(p))
        L.dst_global[(size_t)(p - LO0) * D_cap + t] = (int32_t)dst_ids[i];
    }
    return true;
  }
  const int64_t K_cap = cfg_.deg_caps[l];
  // Sentinel: the src frame's RESERVED zero row (cache frames reserve
  // tail_start + refresh_cap; regular frames reserve frame_cap - 1).
  const int32_t sentinel =
      use_cache ? (int32_t)(cfg_.tail_start + cfg_.refresh_cap)
                : (int32_t)(cfg_.frame_caps[l] - 1);
  if (!use_cache) {
    // The reserved row must stay unallocated: the layer's src frame may
    // fill at most frame_cap - 1 rows per partition.
    std::fill(fcnt_.begin(), fcnt_.end(), 0);
    for (int32_t fo : ls.frame_owner) fcnt_[fo]++;
    for (int p = 0; p < P; p++) {
      if (fcnt_[p] > cfg_.frame_caps[l] - 1) {
        out->error = 8;  // src frame overflow (reserved zero row)
        return false;
      }
    }
  }
  const int PE = cfg_.n_emit();
  const int LO = cfg_.emit_lo;
  // Edge arrays are written front-to-back then TAIL-padded after the edge
  // pass (a full pre-fill would touch 2x the bytes); nbr takes scattered
  // writes so it keeps the sentinel pre-fill.
  L.edge_src.resize((size_t)PE * E_cap);
  L.edge_dst.resize((size_t)PE * E_cap);
  if (K_cap > 0)
    L.nbr.assign((size_t)PE * K_cap * D_cap, sentinel);
  else
    L.nbr.clear();
  const bool plan = cfg_.plan_out(l);
  const int64_t F_cap = cfg_.frame_caps[l];
  const int64_t n_slots = K_cap * D_cap;
  if (plan) {
    L.plan_offsets.resize((size_t)PE * F_cap);
    L.plan_slots.resize((size_t)PE * n_slots);
    L.plan_long.resize((size_t)PE * cfg_.long_capacity(n_slots));
    L.plan_num_long.resize(PE);
  } else {
    L.plan_offsets.clear();
    L.plan_slots.clear();
    L.plan_long.clear();
    L.plan_num_long.clear();
  }
  L.push.assign((size_t)PE * P * S_cap, -1);
  L.recv.assign((size_t)PE * P * S_cap, (int32_t)D_cap);
  L.owned_idx.assign((size_t)PE * O_cap, -1);
  L.self_idx.assign((size_t)PE * O_cap, 0);
  L.owned_deg.assign((size_t)PE * O_cap, 1.0f);
  L.owned_mask.assign((size_t)PE * O_cap, 0);
  L.num_owned.assign(PE, 0);

  int32_t* n_own = n_own_.data();
  std::fill(n_own_.begin(), n_own_.end(), 0);
  for (int64_t i = 0; i < n; i++) n_own[dst_owner[i]]++;
  for (int p = 0; p < P; p++) {
    if (n_own[p] > O_cap) {
      out->error = 1;  // owned overflow
      return false;
    }
  }

  // Frame-indexed routing precompute (cache layer): partition + frame row
  // per UNIQUE src node. The frame is several times smaller than the edge
  // list, so the random owner_local/wmap/tail walks run once per node
  // instead of once per edge; the edge loop then reads two frame-sized
  // arrays. Also subsumes the per-edge error-5 check: every frame node is
  // validated here (a superset of the edge srcs), identically on every
  // host.
  const bool have_foreign =
      cfg_.foreign_off != nullptr && cfg_.foreign_off[P] > 0;
  if (use_cache) {
    size_t fs = ls.frame.size();
    src_route_.resize(fs);
    const int64_t* fr = ls.frame.data();
    const int32_t* fo = ls.frame_owner.data();  // = wmap[frame], no re-walk
    if (cfg_.replicated) {
      // Identity frames: row == global id on every partition; no
      // owner_local walk, no tail, nothing can be missing.
      for (size_t i = 0; i < fs; i++)
        src_route_[i] = ((int64_t)fo[i] << 32) | (uint32_t)(int32_t)fr[i];
    } else {
      for (size_t i = 0; i < fs; i++) {
        if (i + 8 < fs) __builtin_prefetch(&cfg_.owner_local[fr[i + 8]]);
        int64_t u = fr[i];
        int32_t g = cfg_.owner_local[u];
        int32_t row = g >= 0 ? g : tail_id_[u];
        if (row < 0) {
          out->error = 5;  // routed src missing from cache
          return false;
        }
        src_route_[i] = ((int64_t)fo[i] << 32) | (uint32_t)row;
      }
    }
  }

  // Edge pass: owned-dst edges stream DIRECTLY into the output arrays
  // (they arrive already sorted by local dst — dst_rank is monotone over
  // the frontier rows of each owner); only foreign-dst edges are
  // bucketed, to be appended after the owned block. All buckets/counters
  // are member arenas — zero allocation per batch.
  for (int p = 0; p < P; p++) {
    for_e_[p].clear();
    foreign_rows_[p].clear();
  }
  std::fill(ecnt_.begin(), ecnt_.end(), 0);
  std::fill(own_cursor_.begin(), own_cursor_.end(), 0);
  int64_t* ecnt = ecnt_.data();
  int64_t* own_cursor = own_cursor_.data();
  const Edge* eptr = ls.edges.data();
  const size_t ne = ls.edges.size();
  for (size_t t = 0; t < ne; t++) {
    // The per-edge src lookup is a random walk over a frame-sized array;
    // the edge record itself is sequential, so the lookup address is known
    // a chunk ahead — prefetch it.
    if (t + 16 < ne) {
      int32_t sp = eptr[t + 16].src_pos;
      if (use_cache) {
        __builtin_prefetch(&src_route_[sp]);
      } else {
        __builtin_prefetch(&ls.frame_owner[sp]);
        __builtin_prefetch(&ls.frame_rank[sp]);
      }
    }
    const Edge& e = eptr[t];
    int64_t i = e.dst_row;
    int32_t s = e.src_pos;
    int p;
    int32_t src_local;
    if (use_cache) {
      int64_t r = src_route_[s];
      if (cfg_.replicated) {
        // Every edge is natural: the src row (== its global id) exists in
        // every partition's frame, so execute on the dst's owner — zero
        // foreign rows, zero shuffle for this layer at any P.
        p = dst_owner[i];
        src_local = route_row(r);
      } else {
        p = route_part(r);
        src_local = route_row(r);
        if (have_foreign) {
          int q = dst_owner[i];
          if (q != p) {
            int32_t frow = cfg_.foreign_row(ls.frame[s], q);
            if (frow >= 0) {  // natural edge: src cached on dst's partition
              p = q;
              src_local = frow;
            }
          }
        }
      }
    } else {
      p = ls.frame_owner[s];
      src_local = ls.frame_rank[s];
    }
    if (dst_owner[i] == p) {
      ecnt[p]++;
      if (cfg_.local(p)) {
        int64_t c = own_cursor[p]++;
        if (c < E_cap) {  // overflow reported by the ecnt check below,
                          // identically on every host
          L.edge_dst[(size_t)(p - LO) * E_cap + c] = dst_rank[i];
          L.edge_src[(size_t)(p - LO) * E_cap + c] = src_local;
        }
      }
    } else {
      int32_t& fm = foreign_mask_[p][i];
      if (fm == 0) {
        foreign_rows_[p].push_back((int32_t)i);
        fm = (int32_t)foreign_rows_[p].size();  // k + 1
      }
      ecnt[p]++;
      if (cfg_.local(p))
        for_e_[p].push_back({(int32_t)(n_own[p] + fm - 1), src_local});
    }
  }
  for (int p = 0; p < P; p++) {
    for (int32_t i : foreign_rows_[p]) foreign_mask_[p][i] = 0;
  }

  for (int p = 0; p < P; p++) {
    if (ecnt[p] > E_cap) {
      out->error = 2;  // edge overflow
      return false;
    }
    if (n_own[p] + (int64_t)foreign_rows_[p].size() > D_cap) {
      out->error = 3;  // dst frame overflow
      return false;
    }
    // Shuffle bookkeeping runs for ALL p (recv rows on local q come from
    // remote p's push ordering); the heavy edge/nbr emission only for
    // local p.
    {
      std::fill(cursor_.begin(), cursor_.end(), 0);
      for (size_t t = 0; t < foreign_rows_[p].size(); t++) {
        int32_t i = foreign_rows_[p][t];
        int q = dst_owner[i];
        int64_t c = cursor_[q]++;
        if (c >= S_cap) {
          out->error = 4;  // shuffle overflow
          return false;
        }
        if (cfg_.local(p))
          L.push[((size_t)(p - LO) * P + q) * S_cap + c] =
              (int32_t)(n_own[p] + t);
        if (cfg_.local(q))
          L.recv[((size_t)(q - LO) * P + p) * S_cap + c] = dst_rank[i];
      }
    }
    if (!cfg_.local(p)) continue;
    int32_t* es = L.edge_src.data() + (size_t)(p - LO) * E_cap;
    int32_t* ed = L.edge_dst.data() + (size_t)(p - LO) * E_cap;
    int64_t k = own_cursor[p];  // owned block already written in place
    for (const Edge& e : for_e_[p]) {
      ed[k] = e.dst_row;
      es[k] = e.src_pos;
      k++;
    }
    // Tail padding (the pre-fill this replaces touched all E_cap slots);
    // skipped when the COO never leaves the worker (nbr-only layers).
    if (cfg_.coo_out(l)) {
      std::fill(ed + k, ed + E_cap, (int32_t)D_cap);
      std::fill(es + k, es + E_cap, 0);
    }
    // Edges within own_e are in frontier-row order; local owned ids are the
    // rank within owner, also ascending. But interleaved partitions mean
    // own_e isn't globally sorted by local id when... it is: dst_rank is
    // monotone over the frontier rows of owner p. Same for foreign ranks.
    // However own edges with the same dst are contiguous. A stable sort
    // guard (cheap: check + sort if needed) protects the invariant:
    if (!std::is_sorted(ed, ed + k)) {
      std::vector<int64_t> order(k);
      for (int64_t t = 0; t < k; t++) order[t] = t;
      std::stable_sort(order.begin(), order.end(),
                       [&](int64_t a, int64_t b) { return ed[a] < ed[b]; });
      std::vector<int32_t> es2(k), ed2(k);
      for (int64_t t = 0; t < k; t++) {
        es2[t] = es[order[t]];
        ed2[t] = ed[order[t]];
      }
      std::copy(es2.begin(), es2.end(), es);
      std::copy(ed2.begin(), ed2.end(), ed);
    }

    // Dense neighbor matrix: edges are dst-sorted, so the within-dst rank
    // is a run counter. rank < K_cap is guaranteed by fanout sampling
    // (fanout neighbors + self loop); checked anyway.
    if (K_cap > 0) {
      int32_t* nb = L.nbr.data() + (size_t)(p - LO) * K_cap * D_cap;
      // The plan's counts, a row s at offs[s + 1], in the same walk; p's
      // edges name only its fcnt_[p] frame rows.
      int32_t* offs =
          plan ? L.plan_offsets.data() + (size_t)(p - LO) * F_cap : nullptr;
      if (plan) std::fill(offs, offs + fcnt_[p] + 1, 0);
      int32_t prev = -1;
      int64_t r = 0;
      for (int64_t t = 0; t < k; t++) {
        if (ed[t] != prev) {
          prev = ed[t];
          r = 0;
        }
        if (r >= K_cap) {
          out->error = 9;  // degree capacity overflow
          return false;
        }
        nb[r * D_cap + ed[t]] = es[t];
        if (plan) offs[es[t] + 1]++;
        r++;
      }
      if (plan) {
        const size_t q = (size_t)(p - LO);
        write_plan(nb, K_cap, D_cap, n_own[p] + foreign_rows_[p].size(),
                   fcnt_[p], F_cap, sentinel, offs,
                   L.plan_slots.data() + q * n_slots,
                   L.plan_long.data() + q * cfg_.long_capacity(n_slots),
                   cfg_.long_capacity(n_slots), &L.plan_num_long[q]);
      }
    }

  }

  // Owned per-row data (error 5 was already checked for the whole frame
  // in the routing precompute, identically on every host; writes only for
  // local p). The frontier is the PREFIX of the frame (sample_raw pushes
  // it first), so src_row_[i] is exactly the cache row of frontier[i] on
  // its owner — no extra random walk.
  for (int64_t i = 0; i < n; i++) {
    int p = dst_owner[i];
    int32_t t = dst_rank[i];
    int32_t self_row;
    if (use_cache) {
      self_row = route_row(src_route_[i]);
    } else {
      // frontier is a prefix of the frame: frame row i.
      self_row = ls.frame_rank[i];
    }
    if (!cfg_.local(p)) continue;
    L.owned_idx[(size_t)(p - LO) * O_cap + t] = t;
    L.owned_deg[(size_t)(p - LO) * O_cap + t] = (float)ls.counts[i];
    L.self_idx[(size_t)(p - LO) * O_cap + t] = self_row;
    L.owned_mask[(size_t)(p - LO) * O_cap + t] = 1;
  }
  for (int p = cfg_.emit_lo; p < cfg_.emit_hi; p++)
    L.num_owned[p - LO] = n_own[p];
  return true;
}

bool Worker::process(const std::vector<int64_t>& batch, Sample* out,
                     int64_t seq) {
  const int P = cfg_.P;
  rng_ = XorShift(seed_base_ * 0x9e3779b97f4a7c15ULL ^
                  (uint64_t)(seq + 1) * 0xbf58476d1ce4e5b9ULL);
  out->error = 0;
  out->layers.resize(cfg_.L);
  auto t0 = std::chrono::steady_clock::now();
  sample_raw(batch);
  auto t1 = std::chrono::steady_clock::now();

  const LayerSample& deepest = layers_[cfg_.L - 1];

  // Cache: assign per-sample dynamic tail ids in deepest-frame order
  // (identical to CachePlan.refresh ordering) and emit the refresh list.
  tail_nodes_scratch_.clear();
  out->tail_fill.assign(P, 0);
  if (cfg_.owner_local) {
    out->refresh_nodes.assign((size_t)P * cfg_.refresh_cap, -1);
    std::vector<int64_t> tail_cnt(P, 0);
    const size_t dn = deepest.frame.size();
    for (size_t di = 0; di < dn; di++) {
      if (di + 8 < dn)
        __builtin_prefetch(&cfg_.owner_local[deepest.frame[di + 8]]);
      int64_t u = deepest.frame[di];
      int p = deepest.frame_owner[di];  // = wmap[u], already computed
      if (cfg_.owner_local[u] < 0 && tail_id_[u] < 0) {
        int64_t c = tail_cnt[p]++;
        if (c >= cfg_.refresh_cap) {
          out->error = 6;  // refresh overflow
          for (int64_t w : tail_nodes_scratch_) tail_id_[w] = -1;
          tail_nodes_scratch_.clear();
          return false;
        }
        tail_id_[u] = (int32_t)(cfg_.tail_start + c);
        tail_nodes_scratch_.push_back(u);
        out->refresh_nodes[(size_t)p * cfg_.refresh_cap + c] = (int32_t)u;
      }
    }
    for (int p = 0; p < P; p++) out->tail_fill[p] = tail_cnt[p];
  }

  bool ok = true;
  for (int l = 0; l < cfg_.L && ok; l++) ok = slice_layer(l, out);

  if (ok) {
    // input frame global ids (no-cache path) / targets for labels.
    const int PE = cfg_.n_emit();
    const int LO = cfg_.emit_lo;
    const bool emit_in = cfg_.emit_input != 0;
    if (emit_in)
      out->input_nodes.assign((size_t)PE * cfg_.frame_caps[0], -1);
    else
      out->input_nodes.clear();
    std::vector<int64_t> cnt(P, 0);
    for (size_t di = 0; di < deepest.frame.size(); di++) {
      int64_t u = deepest.frame[di];
      int p = deepest.frame_owner[di];  // = wmap[u], already computed
      int64_t c = cnt[p]++;
      if (c >= cfg_.frame_caps[0]) {
        ok = false, out->error = 7;  // input frame overflow
      } else if (emit_in && cfg_.local(p)) {
        out->input_nodes[(size_t)(p - LO) * cfg_.frame_caps[0] + c] =
            (int32_t)u;
      }
    }
    out->targets.assign((size_t)PE * cfg_.out_caps[cfg_.L - 1], -1);
    std::vector<int64_t> tcnt(P, 0);
    for (size_t i = 0; i < frontier0_.size() && ok; i++) {
      int p = f0_owner_[i];
      int64_t c = tcnt[p]++;
      if (cfg_.local(p))
        out->targets[(size_t)(p - LO) * cfg_.out_caps[cfg_.L - 1] + c] =
            (int32_t)frontier0_[i];
    }
  }

  auto t_slice_end = std::chrono::steady_clock::now();
  // Worker-side tail feature gather+cast for emitted partitions (only
  // after a fully successful slice — overflow samples carry no tail).
  if (ok && cfg_.owner_local && cfg_.features) {
    const int PE = cfg_.n_emit();
    const int LO = cfg_.emit_lo;
    const int64_t rc = cfg_.refresh_cap;
    const int32_t cols = cfg_.feat_cols;
    const size_t words = cfg_.feat_bf16 ? (size_t)cols : (size_t)cols * 2;
    out->tail_feats.resize((size_t)PE * rc * words);
    for (int p = LO; p < cfg_.emit_hi; p++) {
      const int32_t* rows = out->refresh_nodes.data() + (size_t)p * rc;
      uint16_t* dst_base =
          out->tail_feats.data() + (size_t)(p - LO) * rc * words;
      const int64_t fill = out->tail_fill[p];
      for (int64_t c = 0; c < fill; c++) {
        const float* src = cfg_.features + (size_t)rows[c] * cfg_.feat_stride;
        // Random row reads from a GB-scale table are latency-bound; a
        // single first-line prefetch a few rows ahead measured best
        // (prefetching every line of the row 8 ahead ran ~8% SLOWER —
        // fill-buffer pressure; worker_scaling.jsonl r4 runs).
        if (c + 4 < fill)
          __builtin_prefetch(cfg_.features +
                             (size_t)rows[c + 4] * cfg_.feat_stride);
        uint16_t* dst = dst_base + (size_t)c * words;
        if (cfg_.feat_bf16) {
          for (int32_t j = 0; j < cols; j++) dst[j] = f32_to_bf16(src[j]);
        } else {
          std::memcpy(dst, src, (size_t)cols * 4);
        }
      }
    }
  } else {
    out->tail_feats.clear();
  }

  // Reset per-sample tail assignments.
  for (int64_t u : tail_nodes_scratch_) tail_id_[u] = -1;
  tail_nodes_scratch_.clear();
  if (stats_) {
    auto t2 = std::chrono::steady_clock::now();
    stats_->sample_ns += std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0).count();
    stats_->slice_ns += std::chrono::duration_cast<std::chrono::nanoseconds>(t_slice_end - t1).count();
    stats_->tail_ns += std::chrono::duration_cast<std::chrono::nanoseconds>(t2 - t_slice_end).count();
    stats_->samples += 1;
  }
  return ok;
}

// ---------------------------------------------------------------------------
// Service: producer (epoch batches) + worker threads + output queue.
// ---------------------------------------------------------------------------

struct WorkItem {
  int64_t seq;
  std::vector<int64_t>* nodes;
};

struct Service {
  Config cfg;
  Stats stats;
  std::unique_ptr<BoundedQueue<WorkItem>> work;
  std::unique_ptr<BoundedQueue<Sample*>> done;
  std::vector<std::thread> threads;
  std::vector<Sample*> pool;
  std::mutex pool_mu;
  std::atomic<bool> stop{false};
  uint64_t seed = 0;

  Sample* get_buffer() {
    std::lock_guard<std::mutex> lk(pool_mu);
    if (pool.empty()) return new Sample();
    Sample* s = pool.back();
    pool.pop_back();
    return s;
  }
  void put_buffer(Sample* s) {
    std::lock_guard<std::mutex> lk(pool_mu);
    pool.push_back(s);
  }
};

void worker_main(Service* svc, int wid) {
  // Sampling runs at low priority: it pipelines ahead of the device and
  // must never starve the runtime threads that feed the accelerator
  // (critical on small hosts where workers could saturate every core).
#ifdef __linux__
  setpriority(PRIO_PROCESS, (id_t)syscall(SYS_gettid), 10);
#endif
  // All workers share the same seed base: batch content is a function of
  // (seed, seq), never of worker identity.
  Worker w(svc->cfg, svc->seed, &svc->stats);
  WorkItem item;
  while (svc->work->pop(&item)) {
    if (item.nodes->empty()) {  // shutdown sentinel (WorkerPool.cpp:52)
      delete item.nodes;
      break;
    }
    Sample* s = svc->get_buffer();
    w.process(*item.nodes, s, item.seq);
    s->seq = item.seq;
    delete item.nodes;
    // After occ_destroy closed the output queue the sample goes back to
    // the pool, which occ_destroy frees once the workers have joined.
    if (!svc->done->push(s)) svc->put_buffer(s);
  }
}

}  // namespace

extern "C" {

void* occ_create(int64_t num_nodes, const int64_t* indptr,
                 const int64_t* indices, const int32_t* wmap, int32_t P,
                 int32_t L, const int32_t* fanouts, const int64_t* frame_caps,
                 const int64_t* edge_caps, const int64_t* dst_caps,
                 const int64_t* out_caps, const int64_t* shuffle_caps,
                 const int64_t* deg_caps,
                 const int32_t* owner_local, const int64_t* foreign_off,
                 const int64_t* foreign_nodes, const int32_t* foreign_local,
                 int64_t tail_start, int64_t refresh_cap, int32_t num_workers,
                 int32_t queue_depth, uint64_t seed,
                 int32_t sample_replace, int32_t emit_lo, int32_t emit_hi,
                 int32_t emit_coo, int32_t emit_input,
                 const float* features, int64_t feat_stride,
                 int32_t feat_cols, int32_t feat_bf16,
                 int32_t replicated, int32_t device_innermost,
                 int32_t plan_span) {
  Service* svc = new Service();
  Config& c = svc->cfg;
  c.num_nodes = num_nodes;
  c.indptr = indptr;
  c.indices = indices;
  c.wmap = wmap;
  c.P = P;
  c.L = L;
  for (int i = 0; i < L; i++) {
    c.fanouts[i] = fanouts[i];
    c.edge_caps[i] = edge_caps[i];
    c.dst_caps[i] = dst_caps[i];
    c.out_caps[i] = out_caps[i];
    c.shuffle_caps[i] = shuffle_caps[i];
    c.deg_caps[i] = deg_caps ? deg_caps[i] : -1;
  }
  for (int i = 0; i <= L; i++) c.frame_caps[i] = frame_caps[i];
  c.owner_local = owner_local;
  c.foreign_off = foreign_off;
  c.foreign_nodes = foreign_nodes;
  c.foreign_local = foreign_local;
  c.tail_start = tail_start;
  c.refresh_cap = refresh_cap;
  c.sample_replace = sample_replace;
  c.emit_lo = emit_lo;
  c.emit_hi = (emit_hi > emit_lo) ? emit_hi : P;
  c.emit_coo = emit_coo;
  c.emit_input = emit_input;
  c.features = features;
  c.feat_stride = feat_stride;
  c.feat_cols = feat_cols;
  c.feat_bf16 = feat_bf16;
  c.replicated = replicated;
  c.device_innermost = device_innermost;
  c.plan_span = plan_span;
  svc->seed = seed;
  svc->work = std::make_unique<BoundedQueue<WorkItem>>(
      queue_depth > 0 ? queue_depth : 4);
  svc->done = std::make_unique<BoundedQueue<Sample*>>(
      queue_depth > 0 ? queue_depth : 4);
  for (int i = 0; i < num_workers; i++)
    svc->threads.emplace_back(worker_main, svc, i);
  return svc;
}

// Enqueue one batch of target node ids tagged with a sequence number;
// occ_next reports the tag so Python delivers samples in submission order
// (required for deterministic multi-host replicated sampling).
void occ_submit(void* handle, const int64_t* nodes, int64_t n, int64_t seq) {
  Service* svc = static_cast<Service*>(handle);
  svc->work->push({seq, new std::vector<int64_t>(nodes, nodes + n)});
}

// Blocking: wait until a finished sample is queued, without taking it,
// so that the occ_next after it only copies. Returns 0 when one is
// queued, -1 when the service was closed (occ_destroy) meanwhile.
int32_t occ_wait(void* handle) {
  Service* svc = static_cast<Service*>(handle);
  return svc->done->wait() ? 0 : -1;
}

// Blocking: pop one finished sample and copy it into caller buffers.
// `field_ptrs` order: per layer l in [0,L): dst_global ONLY when
// (l == 0 && device_innermost); else edge_src, edge_dst (only when
// coo_out(l) — i.e. emit_coo or no dense nbr), push, recv, owned_idx,
// owned_deg(float), self_idx, owned_mask(uint8), num_owned, nbr (only
// when deg_caps[l] > 0), plan_offsets, plan_slots, plan_long,
// plan_num_long (only when plan_out(l)); then input_nodes (only when
// emit_input),
// targets, refresh_nodes. Returns error code (0 = ok).
int32_t occ_next(void* handle, void** field_ptrs, int64_t* seq_out) {
  Service* svc = static_cast<Service*>(handle);
  Sample* s;
  if (!svc->done->pop(&s)) return -1;
  const Config& c = svc->cfg;
  if (seq_out) *seq_out = s->seq;
  int32_t err = s->error;
  if (err == 0) {
    int f = 0;
    for (int l = 0; l < c.L; l++) {
      Sample::Layer& L = s->layers[l];
      auto cp = [&](const void* src, size_t bytes) {
        std::memcpy(field_ptrs[f++], src, bytes);
      };
      if (l == 0 && c.device_innermost) {
        cp(L.dst_global.data(), L.dst_global.size() * 4);
        continue;
      }
      if (c.coo_out(l)) {
        cp(L.edge_src.data(), L.edge_src.size() * 4);
        cp(L.edge_dst.data(), L.edge_dst.size() * 4);
      }
      cp(L.push.data(), L.push.size() * 4);
      cp(L.recv.data(), L.recv.size() * 4);
      cp(L.owned_idx.data(), L.owned_idx.size() * 4);
      cp(L.owned_deg.data(), L.owned_deg.size() * 4);
      cp(L.self_idx.data(), L.self_idx.size() * 4);
      cp(L.owned_mask.data(), L.owned_mask.size());
      cp(L.num_owned.data(), L.num_owned.size() * 4);
      if (c.deg_caps[l] > 0) cp(L.nbr.data(), L.nbr.size() * 4);
      if (c.plan_out(l)) {
        cp(L.plan_offsets.data(), L.plan_offsets.size() * 4);
        // Each partition's lists only: the tail of its slots is unread.
        const int64_t F = c.frame_caps[l];
        const size_t n_slots = L.plan_slots.size() / c.n_emit();
        int32_t* dst = static_cast<int32_t*>(field_ptrs[f++]);
        for (int q = 0; q < c.n_emit(); q++) {
          std::memcpy(dst + q * n_slots, L.plan_slots.data() + q * n_slots,
                      (size_t)L.plan_offsets[q * F + F - 1] * 4);
        }
        cp(L.plan_long.data(), L.plan_long.size() * 4);
        cp(L.plan_num_long.data(), L.plan_num_long.size() * 4);
      }
    }
    auto cp = [&](const void* src, size_t bytes) {
      std::memcpy(field_ptrs[f++], src, bytes);
    };
    if (c.emit_input)
      cp(s->input_nodes.data(), s->input_nodes.size() * 4);
    cp(s->targets.data(), s->targets.size() * 4);
    if (c.owner_local) cp(s->refresh_nodes.data(),
                         s->refresh_nodes.size() * 4);
    if (c.owner_local && c.features) {
      // Gathered tail features: copy ONLY each partition's filled prefix
      // (dst layout [PE, refresh_cap, cols]; rows past the fill are
      // unspecified and never referenced by this batch).
      const size_t words = c.feat_bf16 ? (size_t)c.feat_cols
                                       : (size_t)c.feat_cols * 2;
      uint16_t* dst = (uint16_t*)field_ptrs[f++];
      const int64_t rc = c.refresh_cap;
      for (int p = c.emit_lo; p < c.emit_hi; p++) {
        const size_t off = (size_t)(p - c.emit_lo) * rc * words;
        std::memcpy(dst + off, s->tail_feats.data() + off,
                    (size_t)s->tail_fill[p] * words * 2);
      }
    }
  }
  svc->put_buffer(s);
  return err;
}

// Fill [sample_s, slice_s, tail_gather_s, samples] for phase reporting.
void occ_stats(void* handle, double* out4) {
  Service* svc = static_cast<Service*>(handle);
  out4[0] = svc->stats.sample_ns.load() * 1e-9;
  out4[1] = svc->stats.slice_ns.load() * 1e-9;
  out4[2] = svc->stats.tail_ns.load() * 1e-9;
  out4[3] = (double)svc->stats.samples.load();
}

void occ_destroy(void* handle) {
  Service* svc = static_cast<Service*>(handle);
  // Unblock workers stuck pushing results before sending shutdown
  // sentinels (closing first avoids the join deadlocking on a full
  // output queue).
  svc->done->close();
  svc->done->drain_waiters();
  for (size_t i = 0; i < svc->threads.size(); i++)
    svc->work->push({-1, new std::vector<int64_t>()});  // sentinels
  for (auto& t : svc->threads) t.join();
  svc->work->close();
  Sample* s;
  while (svc->done->pop(&s)) delete s;
  for (Sample* p : svc->pool) delete p;
  delete svc;
}

}  // extern "C"
