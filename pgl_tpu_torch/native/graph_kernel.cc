// Host-side graph kernels in C++ (ctypes ABI) for pgl_tpu_torch.
//
// The port's own copy of pgl_tpu/native/graph_kernel.cc, every function of
// it: the O(E + N) counting-sort index build, `map_nodes`, the per-node
// uniform neighbour sample, the first-order, node2vec and node2vec+ walks,
// skip-gram pairs, alias tables, induced-edge extraction and the
// multilevel partitioner. The source of each function is the reference's,
// so the same inputs and seed give the reference's outputs bit for bit.
//
// Built by graph_kernel.py with g++ on first use (no PyTorch headers).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>
#include <unordered_map>
#include <unordered_set>
#include <vector>

using i64 = long long;

extern "C" {

// -------------------------------------------------------------------------
// CSR construction: counting sort by u.  O(E + N).
// Outputs: degree[N], sorted_v[E], sorted_eid[E], indptr[N+1].
void build_index(const i64* u, const i64* v, i64 num_edges, i64 num_nodes,
                 i64* degree, i64* sorted_v, i64* sorted_eid, i64* indptr) {
  std::memset(degree, 0, sizeof(i64) * num_nodes);
  for (i64 e = 0; e < num_edges; ++e) degree[u[e]]++;
  indptr[0] = 0;
  for (i64 n = 0; n < num_nodes; ++n) indptr[n + 1] = indptr[n] + degree[n];
  std::vector<i64> fill(indptr, indptr + num_nodes);
  for (i64 e = 0; e < num_edges; ++e) {
    i64 pos = fill[u[e]]++;
    sorted_v[pos] = v[e];
    sorted_eid[pos] = e;
  }
}

// -------------------------------------------------------------------------
// Reindex: build hashmap old_id -> position-in-`nodes`, then map queries.
// Unknown queries map to -1 (callers filter).  Hot path of minibatch
// subgraph extraction.
void map_nodes(const i64* nodes, i64 num_nodes, const i64* query,
               i64 num_query, i64* out) {
  std::unordered_map<i64, i64> index;
  index.reserve(static_cast<size_t>(num_nodes) * 2);
  for (i64 i = 0; i < num_nodes; ++i) index.emplace(nodes[i], i);
  for (i64 q = 0; q < num_query; ++q) {
    auto it = index.find(query[q]);
    out[q] = (it == index.end()) ? -1 : it->second;
  }
}

// -------------------------------------------------------------------------
// Per-node uniform neighbor sampling from CSR, at most max_degree neighbors
// per queried node, without replacement (partial Fisher–Yates when the
// neighborhood is larger than max_degree; full copy otherwise).
// Outputs are packed: out_indptr[num_query+1] then caller reads
// out_v/out_eid[0:out_indptr[num_query]].  out_v/out_eid must be sized
// num_query*max_degree.
void sample_subset_with_eid(const i64* indptr, const i64* sorted_v,
                            const i64* sorted_eid, const i64* query,
                            i64 num_query, i64 max_degree, i64 seed,
                            i64* out_indptr, i64* out_v, i64* out_eid) {
  std::mt19937_64 rng(static_cast<uint64_t>(seed));
  i64 cursor = 0;
  out_indptr[0] = 0;
  std::vector<i64> perm;
  for (i64 q = 0; q < num_query; ++q) {
    i64 node = query[q];
    i64 begin = indptr[node], end = indptr[node + 1];
    i64 deg = end - begin;
    if (deg <= max_degree) {
      for (i64 i = begin; i < end; ++i) {
        out_v[cursor] = sorted_v[i];
        out_eid[cursor] = sorted_eid[i];
        ++cursor;
      }
    } else {
      perm.resize(deg);
      for (i64 i = 0; i < deg; ++i) perm[i] = i;
      for (i64 i = 0; i < max_degree; ++i) {  // partial Fisher–Yates
        std::uniform_int_distribution<i64> dist(i, deg - 1);
        std::swap(perm[i], perm[dist(rng)]);
        out_v[cursor] = sorted_v[begin + perm[i]];
        out_eid[cursor] = sorted_eid[begin + perm[i]];
        ++cursor;
      }
    }
    out_indptr[q + 1] = cursor;
  }
}

// -------------------------------------------------------------------------
// First-order random walk: walks[num_starts * walk_len], padded with -1 when
// a walk hits a node with no outgoing edges.
void random_walk(const i64* indptr, const i64* sorted_v, const i64* starts,
                 i64 num_starts, i64 walk_len, i64 seed, i64* walks) {
  std::mt19937_64 rng(static_cast<uint64_t>(seed));
  for (i64 w = 0; w < num_starts; ++w) {
    i64 cur = starts[w];
    walks[w * walk_len] = cur;
    for (i64 step = 1; step < walk_len; ++step) {
      i64 begin = indptr[cur], end = indptr[cur + 1];
      if (begin == end) {
        for (i64 s = step; s < walk_len; ++s) walks[w * walk_len + s] = -1;
        break;
      }
      std::uniform_int_distribution<i64> dist(begin, end - 1);
      cur = sorted_v[dist(rng)];
      walks[w * walk_len + step] = cur;
    }
  }
}

// -------------------------------------------------------------------------
// Second-order (node2vec) biased walk with return parameter p and in-out
// parameter q, rejection-sampling formulation (KnightKing-style): accept a
// uniform neighbor candidate with prob 1 (dst==prev: 1/p; dst adjacent to
// prev: 1; else 1/q), normalized by max of the three.
void node2vec_walk(const i64* indptr, const i64* sorted_v, const i64* starts,
                   i64 num_starts, i64 walk_len, double p, double q, i64 seed,
                   i64* walks) {
  std::mt19937_64 rng(static_cast<uint64_t>(seed));
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  double inv_p = 1.0 / p, inv_q = 1.0 / q;
  double upper = std::max({inv_p, 1.0, inv_q});
  for (i64 w = 0; w < num_starts; ++w) {
    i64 prev = -1;
    i64 cur = starts[w];
    walks[w * walk_len] = cur;
    for (i64 step = 1; step < walk_len; ++step) {
      i64 begin = indptr[cur], end = indptr[cur + 1];
      if (begin == end) {
        for (i64 s = step; s < walk_len; ++s) walks[w * walk_len + s] = -1;
        break;
      }
      i64 next = -1;
      if (prev < 0) {
        std::uniform_int_distribution<i64> dist(begin, end - 1);
        next = sorted_v[dist(rng)];
      } else {
        // CSR rows keep original edge order (counting sort by u only),
        // so membership must use a hash set — binary_search over an
        // unsorted range is undefined and misclassifies the shared-
        // neighbor (weight 1.0) case
        std::unordered_set<i64> prev_nbrs(sorted_v + indptr[prev],
                                          sorted_v + indptr[prev + 1]);
        for (int attempt = 0; attempt < 128; ++attempt) {
          std::uniform_int_distribution<i64> dist(begin, end - 1);
          i64 cand = sorted_v[dist(rng)];
          double w_cand;
          if (cand == prev) {
            w_cand = inv_p;
          } else if (prev_nbrs.count(cand)) {
            w_cand = 1.0;
          } else {
            w_cand = inv_q;
          }
          if (unif(rng) * upper <= w_cand) { next = cand; break; }
        }
        if (next < 0) {  // fall back to uniform after rejection budget
          std::uniform_int_distribution<i64> dist(begin, end - 1);
          next = sorted_v[dist(rng)];
        }
      }
      walks[w * walk_len + step] = next;
      prev = cur;
      cur = next;
    }
  }
}

// -------------------------------------------------------------------------
// node2vec+ variant (reference behavior at pgl/graph_kernel.pyx:179-224 via
// pgl/sampling/walk.py:125): the "distance-1" class is the union of the
// neighborhoods of every node visited so far in the walk, not just the
// previous node's neighbors. Same rejection-sampling formulation as
// node2vec_walk, with an accumulated hash set instead of a binary search.
void node2vec_walk_plus(const i64* indptr, const i64* sorted_v,
                        const i64* starts, i64 num_starts, i64 walk_len,
                        double p, double q, i64 seed, i64* walks) {
  std::mt19937_64 rng(static_cast<uint64_t>(seed));
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  double inv_p = 1.0 / p, inv_q = 1.0 / q;
  double upper = std::max({inv_p, 1.0, inv_q});
  std::unordered_set<i64> seen;
  for (i64 w = 0; w < num_starts; ++w) {
    seen.clear();
    i64 prev = -1;
    i64 cur = starts[w];
    walks[w * walk_len] = cur;
    for (i64 step = 1; step < walk_len; ++step) {
      i64 begin = indptr[cur], end = indptr[cur + 1];
      if (begin == end) {
        for (i64 s = step; s < walk_len; ++s) walks[w * walk_len + s] = -1;
        break;
      }
      i64 next = -1;
      if (prev < 0) {
        std::uniform_int_distribution<i64> dist(begin, end - 1);
        next = sorted_v[dist(rng)];
      } else {
        for (int attempt = 0; attempt < 128; ++attempt) {
          std::uniform_int_distribution<i64> dist(begin, end - 1);
          i64 cand = sorted_v[dist(rng)];
          double w_cand;
          if (cand == prev) {
            w_cand = inv_p;
          } else if (seen.count(cand)) {
            w_cand = 1.0;
          } else {
            w_cand = inv_q;
          }
          if (unif(rng) * upper <= w_cand) { next = cand; break; }
        }
        if (next < 0) {  // fall back to uniform after rejection budget
          std::uniform_int_distribution<i64> dist(begin, end - 1);
          next = sorted_v[dist(rng)];
        }
      }
      // the set used at step t covers neighborhoods of nodes visited
      // strictly before t, matching the reference's accumulation order
      seen.insert(sorted_v + begin, sorted_v + end);
      walks[w * walk_len + step] = next;
      prev = cur;
      cur = next;
    }
  }
}

// -------------------------------------------------------------------------
// Skip-gram positive pair generation with a random window per position
// (reference behavior at pgl/graph_kernel.pyx:343-364: for each center t,
// draw win in [1, max_win], pair with up to `win` predecessors in the walk).
// Returns pair count; src/dst must be sized num_walks*walk_len*max_win.
i64 skip_gram_gen_pair(const i64* walks, i64 num_walks, i64 walk_len,
                       i64 max_win, i64 seed, i64* src, i64* dst) {
  std::mt19937_64 rng(static_cast<uint64_t>(seed));
  std::uniform_int_distribution<i64> windist(1, max_win);
  i64 cnt = 0;
  for (i64 w = 0; w < num_walks; ++w) {
    const i64* walk = walks + w * walk_len;
    for (i64 t = 0; t < walk_len; ++t) {
      if (walk[t] < 0) break;
      i64 win = windist(rng);
      for (i64 b = 1; b <= win && t - b >= 0; ++b) {
        if (walk[t - b] < 0) continue;
        src[cnt] = walk[t];
        dst[cnt] = walk[t - b];
        ++cnt;
      }
    }
  }
  return cnt;
}

// -------------------------------------------------------------------------
// O(n) alias-method table construction for weighted sampling.
// probs normalized internally; outputs alias[n] (index) and events[n] (prob).
void alias_sample_build_table(const double* weights, i64 n, double* events,
                              i64* alias) {
  std::vector<double> scaled(n);
  double total = 0.0;
  for (i64 i = 0; i < n; ++i) total += weights[i];
  if (!(total > 0.0)) {
    // all-zero (or negative/NaN) weights: fall back to uniform instead
    // of dividing by zero and emitting a NaN-poisoned table
    for (i64 i = 0; i < n; ++i) { events[i] = 1.0; alias[i] = i; }
    return;
  }
  for (i64 i = 0; i < n; ++i) scaled[i] = weights[i] * n / total;
  std::vector<i64> small, large;
  small.reserve(n); large.reserve(n);
  for (i64 i = 0; i < n; ++i)
    (scaled[i] < 1.0 ? small : large).push_back(i);
  while (!small.empty() && !large.empty()) {
    i64 s = small.back(); small.pop_back();
    i64 l = large.back(); large.pop_back();
    events[s] = scaled[s];
    alias[s] = l;
    scaled[l] = scaled[l] + scaled[s] - 1.0;
    (scaled[l] < 1.0 ? small : large).push_back(l);
  }
  while (!large.empty()) { events[large.back()] = 1.0; alias[large.back()] = large.back(); large.pop_back(); }
  while (!small.empty()) { events[small.back()] = 1.0; alias[small.back()] = small.back(); small.pop_back(); }
}

// -------------------------------------------------------------------------
// Induced-subgraph edge extraction: all eids (u,v) with both endpoints in
// `nodes` (GraphSAINT style).  Scans CSR rows of the kept nodes.
// Returns count; out_eid must be sized total degree of `nodes`.
i64 extract_edges_from_nodes(const i64* indptr, const i64* sorted_v,
                             const i64* sorted_eid, i64 num_nodes_graph,
                             const i64* nodes, i64 num_nodes, i64* out_eid) {
  std::vector<char> in_set(num_nodes_graph, 0);
  for (i64 i = 0; i < num_nodes; ++i) in_set[nodes[i]] = 1;
  i64 cnt = 0;
  for (i64 i = 0; i < num_nodes; ++i) {
    i64 u = nodes[i];
    for (i64 e = indptr[u]; e < indptr[u + 1]; ++e) {
      if (in_set[sorted_v[e]]) out_eid[cnt++] = sorted_eid[e];
    }
  }
  return cnt;
}

}  // extern "C"

// -------------------------------------------------------------------------
// Multilevel k-way graph partitioning (METIS-style, original implementation):
//   1. coarsen by heavy-edge matching until small,
//   2. greedy BFS-based initial partition balancing vertex weights,
//   3. uncoarsen with boundary Kernighan-Lin style refinement.
// Undirected view of the CSR (callers symmetrize or accept direction bias).
// Outputs parts[n] in [0, k).
extern "C" {

namespace {

struct CoarseGraph {
  std::vector<i64> indptr, adj, wgt, vwgt;   // CSR with edge weights
  std::vector<i64> cmap;                      // fine -> coarse vertex map
};

// Heavy-edge matching: visit vertices in random order, match with the
// unmatched neighbor of maximal edge weight.
CoarseGraph coarsen(const std::vector<i64>& indptr,
                    const std::vector<i64>& adj,
                    const std::vector<i64>& wgt,
                    const std::vector<i64>& vwgt, std::mt19937_64& rng) {
  i64 n = static_cast<i64>(indptr.size()) - 1;
  std::vector<i64> match(n, -1), order(n);
  for (i64 i = 0; i < n; ++i) order[i] = i;
  std::shuffle(order.begin(), order.end(), rng);
  i64 nc = 0;
  std::vector<i64> cmap(n, -1);
  for (i64 vi = 0; vi < n; ++vi) {
    i64 v = order[vi];
    if (match[v] >= 0) continue;
    i64 best = -1, best_w = -1, ties = 0;
    for (i64 e = indptr[v]; e < indptr[v + 1]; ++e) {
      i64 u = adj[e];
      if (u == v || match[u] >= 0) continue;
      if (wgt[e] > best_w) {
        best = u;
        best_w = wgt[e];
        ties = 1;
      } else if (wgt[e] == best_w) {
        // reservoir tie-break: uniformly random among equal-weight
        // neighbors (level 0 has all-1 weights — order bias here merges
        // across communities)
        ++ties;
        if (static_cast<i64>(rng() % ties) == 0) best = u;
      }
    }
    if (best >= 0) {
      match[v] = best;
      match[best] = v;
      cmap[v] = cmap[best] = nc++;
    } else {
      match[v] = v;
      cmap[v] = nc++;
    }
  }
  // build coarse CSR by hashing neighbor contributions
  CoarseGraph cg;
  cg.cmap = cmap;
  cg.vwgt.assign(nc, 0);
  for (i64 v = 0; v < n; ++v) cg.vwgt[cmap[v]] += vwgt[v];
  std::vector<std::unordered_map<i64, i64>> nbr(nc);
  for (i64 v = 0; v < n; ++v) {
    i64 cv = cmap[v];
    for (i64 e = indptr[v]; e < indptr[v + 1]; ++e) {
      i64 cu = cmap[adj[e]];
      if (cu != cv) nbr[cv][cu] += wgt[e];
    }
  }
  cg.indptr.assign(nc + 1, 0);
  for (i64 c = 0; c < nc; ++c)
    cg.indptr[c + 1] = cg.indptr[c] + static_cast<i64>(nbr[c].size());
  cg.adj.resize(cg.indptr[nc]);
  cg.wgt.resize(cg.indptr[nc]);
  for (i64 c = 0; c < nc; ++c) {
    i64 pos = cg.indptr[c];
    for (auto& kv : nbr[c]) {
      cg.adj[pos] = kv.first;
      cg.wgt[pos] = kv.second;
      ++pos;
    }
  }
  return cg;
}

// Greedy graph-growing initial partition on the coarsest graph.
void initial_partition(const std::vector<i64>& indptr,
                       const std::vector<i64>& adj,
                       const std::vector<i64>& vwgt, i64 k,
                       std::vector<i64>& parts, std::mt19937_64& rng) {
  i64 n = static_cast<i64>(indptr.size()) - 1;
  i64 total = 0;
  for (i64 v = 0; v < n; ++v) total += vwgt[v];
  i64 target = (total + k - 1) / k;
  parts.assign(n, -1);
  std::vector<i64> order(n);
  for (i64 i = 0; i < n; ++i) order[i] = i;
  std::shuffle(order.begin(), order.end(), rng);
  i64 cursor = 0;
  for (i64 p = 0; p < k; ++p) {
    i64 load = 0;
    std::vector<i64> frontier;
    while (load < target && cursor < n) {
      // find an unassigned seed
      while (cursor < n && parts[order[cursor]] >= 0) ++cursor;
      if (cursor >= n) break;
      frontier.assign(1, order[cursor]);
      size_t head = 0;                 // true BFS: ball-shaped growth —
      while (head < frontier.size() && load < target) {
        i64 v = frontier[head++];      // a DFS stack grows stringy parts
        if (parts[v] >= 0) continue;   // that thread across communities
        parts[v] = p;
        load += vwgt[v];
        for (i64 e = indptr[v]; e < indptr[v + 1]; ++e)
          if (parts[adj[e]] < 0) frontier.push_back(adj[e]);
      }
    }
  }
  for (i64 v = 0; v < n; ++v)
    if (parts[v] < 0) parts[v] = static_cast<i64>(rng() % k);
}

// One pass of boundary refinement: move a vertex to the neighbor partition
// with the largest edge-cut gain if balance permits. Vertices are visited
// in a fresh random order every pass (fixed-order greedy sweeps stall in
// local minima), and zero-gain moves toward the lighter partition are
// allowed — the plateau wander that lets FM-style refinement escape
// locked boundaries.
void refine(const std::vector<i64>& indptr, const std::vector<i64>& adj,
            const std::vector<i64>& wgt, const std::vector<i64>& vwgt,
            i64 k, std::vector<i64>& parts, int passes,
            std::mt19937_64& rng) {
  i64 n = static_cast<i64>(indptr.size()) - 1;
  i64 total = 0;
  for (i64 v = 0; v < n; ++v) total += vwgt[v];
  double max_load = 1.08 * static_cast<double>(total) / k + 1.0;
  std::vector<i64> load(k, 0);
  for (i64 v = 0; v < n; ++v) load[parts[v]] += vwgt[v];
  std::vector<i64> conn(k, 0);
  std::vector<i64> order(n);
  for (i64 i = 0; i < n; ++i) order[i] = i;
  for (int pass = 0; pass < passes; ++pass) {
    std::shuffle(order.begin(), order.end(), rng);
    i64 moves = 0, gain_moves = 0;
    for (i64 vi = 0; vi < n; ++vi) {
      i64 v = order[vi];
      i64 pv = parts[v];
      std::fill(conn.begin(), conn.end(), 0);
      for (i64 e = indptr[v]; e < indptr[v + 1]; ++e)
        conn[parts[adj[e]]] += wgt[e];
      i64 best = pv, best_gain = 0;
      bool best_zero = false;
      for (i64 p = 0; p < k; ++p) {
        if (p == pv) continue;
        if (load[p] + vwgt[v] > static_cast<i64>(max_load)) continue;
        i64 gain = conn[p] - conn[pv];
        if (gain > best_gain) {
          best = p;
          best_gain = gain;
          best_zero = false;
        } else if (gain == 0 && best == pv && conn[p] > 0 &&
                   load[p] < load[pv]) {
          // plateau move: same cut, better balance, stays on a boundary
          best = p;
          best_zero = true;
        }
      }
      if (best != pv) {
        load[pv] -= vwgt[v];
        load[best] += vwgt[v];
        parts[v] = best;
        ++moves;
        if (!best_zero) ++gain_moves;
      }
    }
    if (!gain_moves && pass > 0) break;
  }
}

i64 cut_of(const std::vector<i64>& indptr, const std::vector<i64>& adj,
           const std::vector<i64>& wgt, const std::vector<i64>& parts) {
  i64 cut = 0;
  i64 n = static_cast<i64>(indptr.size()) - 1;
  for (i64 v = 0; v < n; ++v)
    for (i64 e = indptr[v]; e < indptr[v + 1]; ++e)
      if (parts[adj[e]] != parts[v]) cut += wgt[e];
  return cut / 2;
}

}  // namespace

// parts must be sized num_nodes. vwgt_in: optional per-vertex balance
// weights (nullptr = unit weights). Degree weights make each part carry
// ~equal EDGE mass — the balance that matters for halo-sharded SpMM,
// where a hub-heavy shard sets the step time (edge skew), not node
// count.
void metis_style_partition_w(const i64* indptr_in, const i64* adj_in,
                             const i64* vwgt_in,
                             i64 num_nodes, i64 nparts, i64 seed,
                             i64* parts_out) {
  std::mt19937_64 rng(static_cast<uint64_t>(seed));
  std::vector<i64> indptr(indptr_in, indptr_in + num_nodes + 1);
  std::vector<i64> adj(adj_in, adj_in + indptr[num_nodes]);
  std::vector<i64> wgt(adj.size(), 1), vwgt(num_nodes, 1);
  if (vwgt_in != nullptr)
    vwgt.assign(vwgt_in, vwgt_in + num_nodes);

  if (nparts <= 1 || num_nodes == 0) {
    std::fill(parts_out, parts_out + num_nodes, 0);
    return;
  }

  // coarsening chain
  std::vector<CoarseGraph> chain;
  std::vector<i64>*cur_indptr = &indptr, *cur_adj = &adj, *cur_wgt = &wgt,
                  *cur_vwgt = &vwgt;
  i64 limit = std::max<i64>(4 * nparts, 64);
  while (static_cast<i64>(cur_indptr->size()) - 1 > limit) {
    CoarseGraph cg = coarsen(*cur_indptr, *cur_adj, *cur_wgt, *cur_vwgt, rng);
    i64 before = static_cast<i64>(cur_indptr->size()) - 1;
    i64 after = static_cast<i64>(cg.indptr.size()) - 1;
    chain.push_back(std::move(cg));
    cur_indptr = &chain.back().indptr;
    cur_adj = &chain.back().adj;
    cur_wgt = &chain.back().wgt;
    cur_vwgt = &chain.back().vwgt;
    if (after > (before * 95) / 100) break;  // stalled matching
  }

  // coarsest level: cheap (few hundred supernodes) — take the best of
  // several random initial partitions after refinement, by actual cut
  std::vector<i64> parts, trial;
  i64 best_cut = -1;
  for (int restart = 0; restart < 10; ++restart) {
    initial_partition(*cur_indptr, *cur_adj, *cur_vwgt, nparts, trial, rng);
    refine(*cur_indptr, *cur_adj, *cur_wgt, *cur_vwgt, nparts, trial, 12,
           rng);
    i64 c = cut_of(*cur_indptr, *cur_adj, *cur_wgt, trial);
    if (best_cut < 0 || c < best_cut) {
      best_cut = c;
      parts = trial;
    }
  }

  // project back through the chain with refinement at each level
  for (i64 level = static_cast<i64>(chain.size()) - 1; level >= 0; --level) {
    const std::vector<i64>& cmap = chain[level].cmap;
    std::vector<i64> fine_parts(cmap.size());
    for (size_t v = 0; v < cmap.size(); ++v) fine_parts[v] = parts[cmap[v]];
    parts.swap(fine_parts);
    if (level == 0) {
      refine(indptr, adj, wgt, vwgt, nparts, parts, 6, rng);
    } else {
      refine(chain[level - 1].indptr, chain[level - 1].adj,
             chain[level - 1].wgt, chain[level - 1].vwgt, nparts, parts, 6,
             rng);
    }
  }
  std::copy(parts.begin(), parts.end(), parts_out);
}

// Back-compat unit-weight entry point.
void metis_style_partition(const i64* indptr_in, const i64* adj_in,
                           i64 num_nodes, i64 nparts, i64 seed,
                           i64* parts_out) {
  metis_style_partition_w(indptr_in, adj_in, nullptr, num_nodes, nparts,
                          seed, parts_out);
}

}  // extern "C"
