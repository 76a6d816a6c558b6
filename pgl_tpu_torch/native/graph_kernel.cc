// Host-side graph kernels in C++ (ctypes ABI) for pgl_tpu_torch.
//
// The port's own copy of pgl_tpu/native/graph_kernel.cc, the functions
// `Graph` calls so far: the O(E + N) counting-sort index build and the
// per-node uniform neighbour sample. The source of each function is the
// reference's, so the same seed gives the reference's samples. The walks,
// `map_nodes`, skip-gram pairs, alias tables and the partitioner come with
// the sampling slice of the port.
//
// Built by graph_kernel.py with g++ on first use (no PyTorch headers).

#include <cstdint>
#include <cstring>
#include <random>
#include <utility>
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

}  // extern "C"
