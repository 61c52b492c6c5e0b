// Multilevel k-way graph partitioner (coarsen - partition - refine).
//
// In-repo replacement for METIS: the reference's split-parallel benefit
// numbers ride on real gpmetis partitions with degree vertex weights
// (/root/reference/python/utils/metis.py:76-88; exp4's my-cache 0.44
// ratio is METIS-based), but gpmetis does not exist in this environment
// and the streaming LDG fallback's distance from multilevel quality was
// unmeasured (VERDICT r4 missing #2). Classic multilevel scheme
// (Karypis/Kumar style, re-implemented from the published algorithm, no
// METIS code consulted):
//
//   1. COARSEN: heavy-edge matching — visit vertices in random order,
//      match each unmatched vertex to its unmatched neighbor with the
//      heaviest (accumulated) edge weight; contract matched pairs,
//      summing vertex and parallel-edge weights. Repeat until the graph
//      is small or shrinkage stalls.
//   2. INITIAL PARTITION: weighted greedy growth on the coarsest graph
//      (highest-degree-first, score = connectivity * balance headroom) —
//      the same objective as the Python LDG, but on a few hundred
//      supernodes where greedy is near-optimal.
//   3. UNCOARSEN + REFINE: project the partition up one level at a time;
//      at each level run boundary refinement passes (greedy KL/FM-style
//      without buckets): move a vertex to the partition with the largest
//      positive cut gain subject to the balance constraint.
//
// Vertex weight = degree + 1, matching the reference's degree-weighted
// METIS call (metis.py:22-41) so partitions balance WORK, not node
// counts. Exposed via a C ABI (occ_metis_partition) for ctypes; the
// Python wrapper is data/partition.py mode="metis".

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <random>
#include <vector>

namespace {

struct UGraph {
  int64_t n = 0;
  std::vector<int64_t> indptr;   // undirected adjacency
  std::vector<int32_t> adj;
  std::vector<int32_t> ew;       // edge weights (parallel edges summed)
  std::vector<int64_t> vw;       // vertex weights
};

// Build the undirected (symmetrized) adjacency from the directed in-CSR,
// merging duplicate edges by weight accumulation and dropping self loops.
UGraph symmetrize(int64_t n, const int64_t* indptr, const int64_t* indices) {
  UGraph g;
  g.n = n;
  std::vector<int64_t> deg(n, 0);
  for (int64_t v = 0; v < n; v++) {
    for (int64_t e = indptr[v]; e < indptr[v + 1]; e++) {
      int64_t u = indices[e];
      if (u == v) continue;
      deg[v]++;
      deg[u]++;
    }
  }
  g.indptr.assign(n + 1, 0);
  for (int64_t v = 0; v < n; v++) g.indptr[v + 1] = g.indptr[v] + deg[v];
  g.adj.resize(g.indptr[n]);
  g.ew.assign(g.indptr[n], 1);
  std::vector<int64_t> cur(g.indptr.begin(), g.indptr.end() - 1);
  for (int64_t v = 0; v < n; v++) {
    for (int64_t e = indptr[v]; e < indptr[v + 1]; e++) {
      int64_t u = indices[e];
      if (u == v) continue;
      g.adj[cur[v]++] = (int32_t)u;
      g.adj[cur[u]++] = (int32_t)v;
    }
  }
  // Merge duplicate neighbors (sort each row; duplicates sum weights).
  std::vector<int64_t> nptr(n + 1, 0);
  int64_t w = 0;
  for (int64_t v = 0; v < n; v++) {
    int64_t lo = g.indptr[v], hi = g.indptr[v + 1];
    std::sort(g.adj.begin() + lo, g.adj.begin() + hi);
    int64_t start = w;
    for (int64_t e = lo; e < hi; e++) {
      if (w > start && g.adj[w - 1] == g.adj[e]) {
        g.ew[w - 1] += 1;
      } else {
        g.adj[w] = g.adj[e];
        g.ew[w] = 1;
        w++;
      }
    }
    nptr[v + 1] = w;
  }
  g.adj.resize(w);
  g.ew.resize(w);
  g.indptr = std::move(nptr);
  g.vw.resize(n);
  for (int64_t v = 0; v < n; v++)
    g.vw[v] = (g.indptr[v + 1] - g.indptr[v]) + 1;
  return g;
}

// One heavy-edge-matching coarsening step. Returns the coarse graph and
// fills cmap (fine vertex -> coarse vertex).
UGraph coarsen(const UGraph& g, std::mt19937_64& rng,
               std::vector<int32_t>& cmap) {
  const int64_t n = g.n;
  std::vector<int32_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::shuffle(order.begin(), order.end(), rng);
  std::vector<int32_t> match(n, -1);
  cmap.assign(n, -1);
  int64_t nc = 0;
  for (int64_t t = 0; t < n; t++) {
    int32_t v = order[t];
    if (match[v] >= 0) continue;
    int32_t best = -1;
    int64_t best_w = 0;
    for (int64_t e = g.indptr[v]; e < g.indptr[v + 1]; e++) {
      int32_t u = g.adj[e];
      if (match[u] >= 0) continue;
      if (g.ew[e] > best_w) {
        best_w = g.ew[e];
        best = u;
      }
    }
    if (best >= 0) {
      match[v] = best;
      match[best] = v;
      cmap[v] = cmap[best] = (int32_t)nc++;
    } else {
      match[v] = v;
      cmap[v] = (int32_t)nc++;
    }
  }
  // Contract: bucket edges by coarse endpoint.
  UGraph c;
  c.n = nc;
  c.vw.assign(nc, 0);
  for (int64_t v = 0; v < n; v++) c.vw[cmap[v]] += g.vw[v];
  std::vector<int64_t> deg(nc, 0);
  for (int64_t v = 0; v < n; v++) {
    int32_t cv = cmap[v];
    for (int64_t e = g.indptr[v]; e < g.indptr[v + 1]; e++) {
      if (cmap[g.adj[e]] != cv) deg[cv]++;
    }
  }
  c.indptr.assign(nc + 1, 0);
  for (int64_t v = 0; v < nc; v++) c.indptr[v + 1] = c.indptr[v] + deg[v];
  c.adj.resize(c.indptr[nc]);
  c.ew.resize(c.indptr[nc]);
  std::vector<int64_t> cur(c.indptr.begin(), c.indptr.end() - 1);
  for (int64_t v = 0; v < n; v++) {
    int32_t cv = cmap[v];
    for (int64_t e = g.indptr[v]; e < g.indptr[v + 1]; e++) {
      int32_t cu = cmap[g.adj[e]];
      if (cu == cv) continue;
      c.adj[cur[cv]] = cu;
      c.ew[cur[cv]] = g.ew[e];
      cur[cv]++;
    }
  }
  // Merge duplicates per row.
  std::vector<int64_t> nptr(nc + 1, 0);
  int64_t w = 0;
  std::vector<int64_t> perm;
  for (int64_t v = 0; v < nc; v++) {
    int64_t lo = c.indptr[v], hi = c.indptr[v + 1];
    perm.resize(hi - lo);
    std::iota(perm.begin(), perm.end(), 0);
    std::sort(perm.begin(), perm.end(), [&](int64_t a, int64_t b) {
      return c.adj[lo + a] < c.adj[lo + b];
    });
    int64_t start = w;
    for (int64_t t = 0; t < hi - lo; t++) {
      int32_t u = c.adj[lo + perm[t]];
      int32_t weight = c.ew[lo + perm[t]];
      if (w > start && c.adj[w - 1] == u) {
        c.ew[w - 1] += weight;
      } else {
        c.adj[w] = u;
        c.ew[w] = weight;
        w++;
      }
    }
    nptr[v + 1] = w;
  }
  c.adj.resize(w);
  c.ew.resize(w);
  c.indptr = std::move(nptr);
  return c;
}

// Greedy growth initial partition on the coarsest graph (the Python
// LDG's objective: connectivity weighted by balance headroom).
void initial_partition(const UGraph& g, int k, double cap,
                       std::mt19937_64& rng, std::vector<int32_t>& part) {
  const int64_t n = g.n;
  part.assign(n, -1);
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return g.vw[a] > g.vw[b];
  });
  std::vector<double> load(k, 0.0);
  std::vector<double> conn(k);
  for (int64_t v : order) {
    std::fill(conn.begin(), conn.end(), 0.0);
    for (int64_t e = g.indptr[v]; e < g.indptr[v + 1]; e++) {
      int32_t p = part[g.adj[e]];
      if (p >= 0) conn[p] += g.ew[e];
    }
    int best = 0;
    double best_s = -1.0;
    for (int p = 0; p < k; p++) {
      double headroom = 1.0 - load[p] / cap;
      if (headroom <= 0) continue;
      double s = conn[p] * headroom;
      if (s > best_s) {
        best_s = s;
        best = p;
      }
    }
    if (best_s <= 0.0) {
      best = (int)(std::min_element(load.begin(), load.end()) -
                   load.begin());
    }
    part[v] = best;
    load[best] += (double)g.vw[v];
  }
}

// Greedy boundary refinement passes (KL/FM-style gains, no buckets):
// move each vertex to the partition with the largest positive cut gain
// that respects the balance cap; repeat until a pass makes no moves.
void refine(const UGraph& g, int k, double cap, std::vector<int32_t>& part,
            std::vector<double>& load, int max_passes,
            std::mt19937_64& rng) {
  const int64_t n = g.n;
  std::vector<int64_t> conn(k);
  std::vector<int32_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  for (int pass = 0; pass < max_passes; pass++) {
    std::shuffle(order.begin(), order.end(), rng);
    int64_t moves = 0;
    for (int64_t t = 0; t < n; t++) {
      int32_t v = order[t];
      int32_t own = part[v];
      std::fill(conn.begin(), conn.end(), 0);
      bool boundary = false;
      for (int64_t e = g.indptr[v]; e < g.indptr[v + 1]; e++) {
        int32_t p = part[g.adj[e]];
        conn[p] += g.ew[e];
        if (p != own) boundary = true;
      }
      if (!boundary) continue;
      int best = own;
      int64_t best_gain = 0;
      for (int p = 0; p < k; p++) {
        if (p == own) continue;
        int64_t gain = conn[p] - conn[own];
        if (gain > best_gain && load[p] + g.vw[v] <= cap) {
          best_gain = gain;
          best = p;
        }
      }
      if (best != own) {
        part[v] = best;
        load[own] -= (double)g.vw[v];
        load[best] += (double)g.vw[v];
        moves++;
      }
    }
    if (moves == 0) break;
  }
}

}  // namespace

extern "C" {

// Partition the directed in-CSR graph (indptr/indices, int64) into k
// parts; writes node -> part into out_pmap (int32[n]). imbalance is the
// allowed load factor over perfect balance (e.g. 1.05). Returns 0.
int32_t occ_metis_partition(int64_t n, const int64_t* indptr,
                            const int64_t* indices, int32_t k,
                            uint64_t seed, double imbalance,
                            int32_t* out_pmap) {
  std::mt19937_64 rng(seed ? seed : 1);
  std::vector<UGraph> levels;
  std::vector<std::vector<int32_t>> cmaps;
  levels.push_back(symmetrize(n, indptr, indices));
  // Coarsen until small or shrinkage stalls (<10% reduction).
  const int64_t target = std::max<int64_t>(64LL * k, 256);
  while (levels.back().n > target) {
    std::vector<int32_t> cmap;
    UGraph c = coarsen(levels.back(), rng, cmap);
    if (c.n > levels.back().n * 9 / 10) break;
    cmaps.push_back(std::move(cmap));
    levels.push_back(std::move(c));
  }
  double total_w = 0.0;
  for (int64_t v = 0; v < levels[0].n; v++)
    total_w += (double)levels[0].vw[v];
  const double cap = total_w / k * imbalance;

  std::vector<int32_t> part;
  initial_partition(levels.back(), k, cap, rng, part);
  for (int64_t lvl = (int64_t)levels.size() - 1; lvl >= 0; lvl--) {
    const UGraph& g = levels[lvl];
    std::vector<double> load(k, 0.0);
    for (int64_t v = 0; v < g.n; v++) load[part[v]] += (double)g.vw[v];
    // More passes on the small coarse levels (cheap), fewer at the fine
    // level (each pass is O(E)).
    int passes = g.n < 100000 ? 8 : 3;
    refine(g, k, cap, part, load, passes, rng);
    if (lvl > 0) {
      // project to the next finer level
      const std::vector<int32_t>& cmap = cmaps[lvl - 1];
      std::vector<int32_t> fine(levels[lvl - 1].n);
      for (int64_t v = 0; v < levels[lvl - 1].n; v++)
        fine[v] = part[cmap[v]];
      part = std::move(fine);
    }
  }
  std::memcpy(out_pmap, part.data(), (size_t)n * 4);
  return 0;
}

}  // extern "C"
