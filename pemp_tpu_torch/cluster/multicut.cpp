// Correlation-clustering (multicut) solvers for sparse graphs.
//
// Native replacement for the reference's unvendored andres_graph C++
// dependency (reference: src/Utils/correlation_clustering/
// correlation_clustering_utils.py:15 imports it; the library itself is
// absent from the repo). Implements the same algorithm family:
//
//   GAEC  — greedy additive edge contraction (Keuper et al. 2015)
//   KL    — GAEC followed by Kernighan-Lin-style local node moves
//   MUT   — mutex watershed (Wolf et al. 2018)
//
// Convention: positive weight = attractive (reward for keeping the edge
// inside a cluster), negative = repulsive. Output: cut flag per input edge
// (1 = endpoints in different clusters).
//
// C API (ctypes-friendly), thread-safe, no globals.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <tuple>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int64_t> parent;
  std::vector<int64_t> rank_;
  explicit UnionFind(int64_t n) : parent(n), rank_(n, 0) {
    for (int64_t i = 0; i < n; ++i) parent[i] = i;
  }
  int64_t find(int64_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  // returns new root after merging a and b (must be roots)
  int64_t merge(int64_t a, int64_t b) {
    if (rank_[a] < rank_[b]) std::swap(a, b);
    parent[b] = a;
    if (rank_[a] == rank_[b]) ++rank_[a];
    return a;
  }
};

using AdjMap = std::unordered_map<int64_t, double>;

// Greedy additive edge contraction. adj holds inter-cluster weights between
// roots; contract the max-positive-weight pair until none remains.
void gaec(UnionFind& uf, std::vector<AdjMap>& adj) {
  using Item = std::tuple<double, int64_t, int64_t>;  // weight, u, v (roots at push)
  std::priority_queue<Item> pq;
  const int64_t n = static_cast<int64_t>(adj.size());
  for (int64_t u = 0; u < n; ++u)
    for (const auto& kv : adj[u])
      if (kv.first > u && kv.second > 0)
        pq.emplace(kv.second, u, kv.first);

  while (!pq.empty()) {
    auto [w, u, v] = pq.top();
    pq.pop();
    int64_t ru = uf.find(u), rv = uf.find(v);
    if (ru == rv) continue;
    auto it = adj[ru].find(rv);
    if (it == adj[ru].end() || it->second != w) continue;  // stale entry
    if (w <= 0) break;
    // contract: merge smaller adjacency into larger
    if (adj[ru].size() < adj[rv].size()) std::swap(ru, rv);
    int64_t keep = uf.merge(ru, rv);
    int64_t drop = (keep == ru) ? rv : ru;
    if (keep != ru) std::swap(ru, rv);  // ensure ru == keep
    adj[ru].erase(drop);
    adj[drop].erase(ru);
    for (const auto& kv : adj[drop]) {
      int64_t nbr = kv.first;
      adj[nbr].erase(drop);
      double nw = kv.second;
      auto ins = adj[ru].emplace(nbr, nw);
      if (!ins.second) ins.first->second += nw;
      double total = adj[ru][nbr];
      adj[nbr][ru] = total;
      if (total > 0) pq.emplace(total, ru, nbr);
    }
    AdjMap().swap(adj[drop]);
  }
}

// Kernighan-Lin-style local search: move single nodes to neighbouring
// clusters (or split off) while the multicut objective improves.
void kl_moves(int64_t n_nodes, const std::vector<std::vector<std::pair<int64_t, double>>>& nbrs,
              std::vector<int64_t>& cluster, int max_passes) {
  int64_t next_cluster = 0;
  for (int64_t i = 0; i < n_nodes; ++i)
    next_cluster = std::max(next_cluster, cluster[i] + 1);

  for (int pass = 0; pass < max_passes; ++pass) {
    bool changed = false;
    for (int64_t v = 0; v < n_nodes; ++v) {
      // gain of leaving the current cluster = -sum w(v, same-cluster nbrs);
      // gain of joining cluster c = sum w(v, nbrs in c)
      std::unordered_map<int64_t, double> gain_to;
      double stay = 0.0;
      for (const auto& [u, w] : nbrs[v]) {
        if (cluster[u] == cluster[v])
          stay += w;
        else
          gain_to[cluster[u]] += w;
      }
      int64_t best_c = -1;
      double best_gain = 0.0;
      for (const auto& [c, g] : gain_to) {
        double gain = g - stay;
        if (gain > best_gain + 1e-12) {
          best_gain = gain;
          best_c = c;
        }
      }
      // splitting off into a singleton gains -stay
      if (-stay > best_gain + 1e-12) {
        best_gain = -stay;
        best_c = next_cluster++;
      }
      if (best_c >= 0 && best_gain > 1e-12) {
        cluster[v] = best_c;
        changed = true;
      }
    }
    if (!changed) break;
  }
}

// Mutex watershed: process edges by |w| descending; positive edges merge
// unless a mutex exists, negative edges install a mutex unless merged.
void mutex_watershed(int64_t n_nodes, const int64_t* src, const int64_t* dst,
                     const double* w, int64_t n_edges, UnionFind& uf) {
  std::vector<int64_t> order(n_edges);
  for (int64_t i = 0; i < n_edges; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return std::abs(w[a]) > std::abs(w[b]);
  });
  std::vector<std::unordered_set<int64_t>> mutex(n_nodes);
  auto has_mutex = [&](int64_t a, int64_t b) {
    if (mutex[a].size() > mutex[b].size()) std::swap(a, b);
    return mutex[a].count(b) > 0;
  };
  for (int64_t idx : order) {
    int64_t a = uf.find(src[idx]), b = uf.find(dst[idx]);
    if (a == b) continue;
    if (w[idx] > 0) {
      if (has_mutex(a, b)) continue;
      int64_t keep = uf.merge(a, b);
      int64_t drop = (keep == a) ? b : a;
      if (mutex[keep].size() < mutex[drop].size()) std::swap(mutex[keep], mutex[drop]);
      for (int64_t m : mutex[drop]) {
        mutex[keep].insert(m);
        mutex[m].erase(drop);
        mutex[m].insert(keep);
      }
      mutex[drop].clear();
    } else if (w[idx] < 0) {
      mutex[a].insert(b);
      mutex[b].insert(a);
    }
  }
}

}  // namespace

extern "C" {

// method: 0 = GAEC, 1 = GAEC + KL local search, 2 = mutex watershed.
// cut_out: n_edges bytes, 1 = edge is cut. Returns 0 on success.
int multicut_solve(const int64_t* src, const int64_t* dst, const double* weights,
                   int64_t n_edges, int64_t n_nodes, int method,
                   uint8_t* cut_out) {
  if (n_nodes <= 0) return 1;
  UnionFind uf(n_nodes);

  if (method == 2) {
    mutex_watershed(n_nodes, src, dst, weights, n_edges, uf);
  } else {
    std::vector<AdjMap> adj(n_nodes);
    for (int64_t e = 0; e < n_edges; ++e) {
      int64_t a = src[e], b = dst[e];
      if (a == b || a < 0 || b < 0 || a >= n_nodes || b >= n_nodes) continue;
      auto ins = adj[a].emplace(b, weights[e]);
      if (!ins.second) ins.first->second += weights[e];
      adj[b][a] = adj[a][b];
    }
    gaec(uf, adj);
    if (method == 1) {
      std::vector<int64_t> cluster(n_nodes);
      for (int64_t i = 0; i < n_nodes; ++i) cluster[i] = uf.find(i);
      std::vector<std::vector<std::pair<int64_t, double>>> nbrs(n_nodes);
      for (int64_t e = 0; e < n_edges; ++e) {
        if (src[e] == dst[e]) continue;
        nbrs[src[e]].push_back({dst[e], weights[e]});
        nbrs[dst[e]].push_back({src[e], weights[e]});
      }
      kl_moves(n_nodes, nbrs, cluster, 20);
      for (int64_t e = 0; e < n_edges; ++e)
        cut_out[e] = cluster[src[e]] != cluster[dst[e]] ? 1 : 0;
      return 0;
    }
  }
  for (int64_t e = 0; e < n_edges; ++e)
    cut_out[e] = uf.find(src[e]) != uf.find(dst[e]) ? 1 : 0;
  return 0;
}

// Cluster labels variant: writes one label per node.
int multicut_labels(const int64_t* src, const int64_t* dst, const double* weights,
                    int64_t n_edges, int64_t n_nodes, int method,
                    int64_t* labels_out) {
  std::vector<uint8_t> cut(n_edges);
  int rc = multicut_solve(src, dst, weights, n_edges, n_nodes, method, cut.data());
  if (rc != 0) return rc;
  UnionFind uf(n_nodes);
  for (int64_t e = 0; e < n_edges; ++e)
    if (!cut[e]) {
      int64_t a = uf.find(src[e]), b = uf.find(dst[e]);
      if (a != b) uf.merge(a, b);
    }
  for (int64_t i = 0; i < n_nodes; ++i) labels_out[i] = uf.find(i);
  return 0;
}

}  // extern "C"
