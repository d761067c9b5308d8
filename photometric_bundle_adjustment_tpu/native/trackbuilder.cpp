// Native union-find for feature-track building.
//
// the framework's host-side runtime component: the transitive
// closure of pairwise matches (the reference's TrackBuilder + UnionFind,
// include/visnav/tracks.h:53-172, union_find.h) is O(edges alpha(n))
// pointer chasing — no flops, wrong shape for the chip, and too slow in
// Python for maps with 10^5..10^6 matches.  This is the C++ replacement:
// path-compressed, union-by-rank disjoint sets over pre-encoded node ids.
//
// Built on demand with `g++ -O3 -shared -fPIC` and loaded via ctypes
// (no pybind11 dependency); see pipeline/native_tracks.py.

#include <cstdint>
#include <vector>

extern "C" {

// edges: (n_edges) pairs (a[i], b[i]) of node indices in [0, n_nodes).
// out_root: (n_nodes) receives the representative (root) of each node.
void uf_build(int64_t n_nodes, int64_t n_edges, const int64_t* a,
              const int64_t* b, int64_t* out_root) {
  std::vector<int64_t> parent(n_nodes);
  std::vector<int32_t> rank(n_nodes, 0);
  for (int64_t i = 0; i < n_nodes; ++i) parent[i] = i;

  auto find = [&](int64_t i) {
    int64_t root = i;
    while (parent[root] != root) root = parent[root];
    while (parent[i] != root) {  // path compression
      int64_t next = parent[i];
      parent[i] = root;
      i = next;
    }
    return root;
  };

  for (int64_t e = 0; e < n_edges; ++e) {
    int64_t ra = find(a[e]);
    int64_t rb = find(b[e]);
    if (ra == rb) continue;
    if (rank[ra] < rank[rb]) {
      int64_t t = ra;
      ra = rb;
      rb = t;
    }
    parent[rb] = ra;
    if (rank[ra] == rank[rb]) rank[ra]++;
  }

  for (int64_t i = 0; i < n_nodes; ++i) out_root[i] = find(i);
}

}  // extern "C"
