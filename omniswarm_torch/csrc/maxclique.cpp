// Heuristic max-clique finder for PCM inlier selection.
//
// Native-runtime counterpart of the reference's vendored
// fast_max-clique_finder (FMC::maxCliqueHeu, used at
// swarm_localization/src/swarm_outlier_rejection/
// swarm_outlier_rejection.cpp:288). Independent implementation: bitset
// adjacency rows + greedy expansion in global-degree order from each of the
// top-K seed vertices, followed by a saturation pass (add any vertex
// adjacent to the whole clique). PCM consistency graphs are dense
// near-cliques plus sparse outliers, where degree-ordered greedy recovers
// the maximum clique in practice; the bitset intersection makes each
// expansion step O(n/64) so thousand-loop windows stay sub-millisecond
// (the previous local-degree greedy was O(|cand|^2) per step — ~60 ms per
// solve at 500-vertex pair graphs, the dominant host cost of the
// vectorized build).
//
// C ABI for ctypes: adj is a row-major n*n 0/1 matrix.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

inline bool test_bit(const uint64_t* row, int j) {
  return (row[j >> 6] >> (j & 63)) & 1u;
}
inline void set_bit(uint64_t* row, int j) {
  row[j >> 6] |= (uint64_t(1) << (j & 63));
}
inline void clear_bit(uint64_t* row, int j) {
  row[j >> 6] &= ~(uint64_t(1) << (j & 63));
}

}  // namespace

extern "C" {

// Returns clique size; writes member indices into out (capacity >= n).
int max_clique_heu(const uint8_t* adj, int n, int* out) {
  if (n <= 0) return 0;
  const int W = (n + 63) >> 6;
  std::vector<uint64_t> bits(static_cast<size_t>(n) * W, 0);
  std::vector<int> deg(n, 0), order(n);
  for (int i = 0; i < n; ++i) {
    uint64_t* row = &bits[static_cast<size_t>(i) * W];
    const uint8_t* arow = adj + static_cast<size_t>(i) * n;
    for (int j = 0; j < n; ++j) {
      if (i != j && arow[j]) {
        set_bit(row, j);
        ++deg[i];
      }
    }
    order[i] = i;
  }
  std::sort(order.begin(), order.end(),
            [&](int a, int b) { return deg[a] > deg[b]; });

  const int kSeeds = std::min(n, 16);
  std::vector<int> best, cur;
  std::vector<uint64_t> cand(W);
  for (int s = 0; s < kSeeds; ++s) {
    const int seed = order[s];
    cur.clear();
    cur.push_back(seed);
    std::memcpy(cand.data(), &bits[static_cast<size_t>(seed) * W],
                W * sizeof(uint64_t));
    // expand in global-degree order; each step intersects the candidate
    // bitset with the new member's adjacency row
    for (;;) {
      int pick = -1;
      for (int idx : order) {
        if (test_bit(cand.data(), idx)) { pick = idx; break; }
      }
      if (pick < 0) break;
      cur.push_back(pick);
      const uint64_t* row = &bits[static_cast<size_t>(pick) * W];
      for (int w = 0; w < W; ++w) cand[w] &= row[w];
      clear_bit(cand.data(), pick);
    }
    if (cur.size() > best.size()) best = cur;
  }
  if (best.empty()) best.push_back(order[0]);

  // saturation: add any vertex adjacent to every current member
  bool improved = true;
  while (improved) {
    improved = false;
    for (int u = 0; u < n; ++u) {
      if (std::find(best.begin(), best.end(), u) != best.end()) continue;
      bool ok = true;
      for (int w : best)
        if (!test_bit(&bits[static_cast<size_t>(u) * W], w)) {
          ok = false;
          break;
        }
      if (ok) {
        best.push_back(u);
        improved = true;
      }
    }
  }

  std::sort(best.begin(), best.end());
  std::memcpy(out, best.data(), best.size() * sizeof(int));
  return static_cast<int>(best.size());
}

}  // extern "C"
