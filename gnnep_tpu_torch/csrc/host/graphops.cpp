// graphops — native kernels for the host-side graph pipeline.
//
// The reference's featurization is pure Python; its hot loops are the
// per-material neighbor enumeration and the O(Σ deg²) line-graph
// construction (reference fetch.py:189-247,417-447). These
// C++ kernels reproduce those semantics exactly (periodic bond identity
// (i, j, jimage), dict-style last-wins duplicate handling, exact-backtrack
// skipping) for the TPU framework's dataset builds, which gate full-MP
// featurization throughput (SURVEY.md §7 risk list).
//
// Exposed as a C ABI for ctypes; built by gnnep_tpu_torch/native.py. The code
// is the JAX package's native/graphops.cpp unchanged.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Key {
    int32_t i, j, a, b, c;
    bool operator==(const Key& o) const {
        return i == o.i && j == o.j && a == o.a && b == o.b && c == o.c;
    }
};

struct KeyHash {
    size_t operator()(const Key& k) const {
        size_t h = static_cast<size_t>(k.i);
        h = h * 1000003u ^ static_cast<size_t>(k.j);
        h = h * 1000003u ^ static_cast<size_t>(k.a + 512);
        h = h * 1000003u ^ static_cast<size_t>(k.b + 512);
        h = h * 1000003u ^ static_cast<size_t>(k.c + 512);
        return h;
    }
};

}  // namespace

extern "C" {

// Build the ALIGNN line graph from directed bonds.
//
// Inputs:
//   n_edges           number of directed bonds
//   src, dst          [E] bond endpoints (i -> j)
//   jimage            [E*3] periodic image of the target
//   dirs              [E*3] unit direction vectors i -> j (0 if zero length)
//   n_nodes           number of atoms
//   angle_centers     [n_centers] Gaussian centers over [0, pi]
//   n_centers, angle_gamma
// Outputs (caller-allocated, capacity `cap` LG edges):
//   lg_src, lg_dst    [cap]
//   lg_feat           [cap * (n_centers + 3)]  basis ⊕ (θ, cos θ, sin θ)
//   angles            [cap] raw angles (for global statistics)
// Returns the number of LG edges required; if > cap, outputs are untouched
// beyond cap and the caller must retry with a larger buffer.
int64_t build_line_graph(
    int64_t n_edges, const int32_t* src, const int32_t* dst,
    const int32_t* jimage, const double* dirs, int64_t n_nodes,
    const double* angle_centers, int32_t n_centers, double angle_gamma,
    int64_t cap, int32_t* lg_src, int32_t* lg_dst, float* lg_feat,
    double* angles) {
    // neighbor map: per source atom, bond slots in insertion order
    std::vector<std::vector<int32_t>> neigh(static_cast<size_t>(n_nodes));
    for (int64_t e = 0; e < n_edges; ++e) {
        neigh[static_cast<size_t>(src[e])].push_back(static_cast<int32_t>(e));
    }
    // bond identity map (i, j, image) -> last bond index (dict semantics)
    std::unordered_map<Key, int32_t, KeyHash> bond_of;
    bond_of.reserve(static_cast<size_t>(n_edges) * 2);
    for (int64_t e = 0; e < n_edges; ++e) {
        bond_of[Key{src[e], dst[e], jimage[3 * e], jimage[3 * e + 1],
                    jimage[3 * e + 2]}] = static_cast<int32_t>(e);
    }

    const int feat_dim = n_centers + 3;
    int64_t count = 0;
    for (int64_t e1 = 0; e1 < n_edges; ++e1) {
        const int32_t i = src[e1], j = dst[e1];
        const int32_t rx = -jimage[3 * e1], ry = -jimage[3 * e1 + 1],
                      rz = -jimage[3 * e1 + 2];
        // d_ji through the exact reverse image is the negation of d_ij
        const double uix = -dirs[3 * e1], uiy = -dirs[3 * e1 + 1],
                     uiz = -dirs[3 * e1 + 2];
        const double nu = std::sqrt(uix * uix + uiy * uiy + uiz * uiz);
        const auto it1 = bond_of.find(Key{i, j, jimage[3 * e1],
                                          jimage[3 * e1 + 1], jimage[3 * e1 + 2]});
        const int32_t b1 = it1 == bond_of.end() ? -1 : it1->second;
        for (const int32_t e2 : neigh[static_cast<size_t>(j)]) {
            const int32_t k = dst[e2];
            const int32_t kx = jimage[3 * e2], ky = jimage[3 * e2 + 1],
                          kz = jimage[3 * e2 + 2];
            if (k == i && kx == rx && ky == ry && kz == rz) continue;  // backtrack
            const auto it2 = bond_of.find(Key{j, k, kx, ky, kz});
            if (b1 < 0 || it2 == bond_of.end()) continue;
            if (count < cap) {
                const double vx = dirs[3 * e2], vy = dirs[3 * e2 + 1],
                             vz = dirs[3 * e2 + 2];
                const double nv = std::sqrt(vx * vx + vy * vy + vz * vz);
                double theta = 0.0;
                if (nu > 0.0 && nv > 0.0) {
                    double cosv = (uix * vx + uiy * vy + uiz * vz) / (nu * nv);
                    if (cosv > 1.0) cosv = 1.0;
                    if (cosv < -1.0) cosv = -1.0;
                    theta = std::acos(cosv);
                }
                lg_src[count] = b1;
                lg_dst[count] = it2->second;
                float* f = lg_feat + count * feat_dim;
                for (int c = 0; c < n_centers; ++c) {
                    const double d = theta - angle_centers[c];
                    f[c] = static_cast<float>(std::exp(-angle_gamma * d * d));
                }
                f[n_centers] = static_cast<float>(theta);
                f[n_centers + 1] = static_cast<float>(std::cos(theta));
                f[n_centers + 2] = static_cast<float>(std::sin(theta));
                angles[count] = theta;
            }
            ++count;
        }
    }
    return count;
}

// Periodic fixed-radius neighbor enumeration.
//
// frac [N*3], lattice row-major [9] (cartesian = frac @ lattice),
// reps [3] image repeats per axis. Output edges (i, j, image) sorted per
// source atom by (j, image) — the framework's canonical ordering.
// Returns required edge count; retry with larger cap if exceeded.
int64_t cutoff_neighbors(
    int64_t n, const double* frac, const double* lattice, double cutoff,
    const int32_t* reps, int64_t cap, int32_t* out_src, int32_t* out_dst,
    int32_t* out_image, double* out_dist, double* out_dir) {
    const double eps = 1e-8;
    const double cut2 = cutoff * cutoff;
    struct Hit { int32_t j, a, b, c; double d, vx, vy, vz; };
    std::vector<Hit> hits;
    int64_t count = 0;
    std::vector<double> cart(static_cast<size_t>(n) * 3);
    for (int64_t i = 0; i < n; ++i) {
        for (int d = 0; d < 3; ++d) {
            cart[3 * i + d] = frac[3 * i] * lattice[0 + d]
                            + frac[3 * i + 1] * lattice[3 + d]
                            + frac[3 * i + 2] * lattice[6 + d];
        }
    }
    for (int64_t i = 0; i < n; ++i) {
        hits.clear();
        for (int a = -reps[0]; a <= reps[0]; ++a)
        for (int b = -reps[1]; b <= reps[1]; ++b)
        for (int c = -reps[2]; c <= reps[2]; ++c) {
            const double ox = a * lattice[0] + b * lattice[3] + c * lattice[6];
            const double oy = a * lattice[1] + b * lattice[4] + c * lattice[7];
            const double oz = a * lattice[2] + b * lattice[5] + c * lattice[8];
            for (int64_t j = 0; j < n; ++j) {
                const double vx = cart[3 * j] + ox - cart[3 * i];
                const double vy = cart[3 * j + 1] + oy - cart[3 * i + 1];
                const double vz = cart[3 * j + 2] + oz - cart[3 * i + 2];
                const double d2 = vx * vx + vy * vy + vz * vz;
                if (d2 <= cut2 && d2 > eps * eps) {
                    hits.push_back(Hit{static_cast<int32_t>(j), a, b, c,
                                       std::sqrt(d2), vx, vy, vz});
                }
            }
        }
        // canonical per-source ordering: by (j, image) lexicographic
        std::sort(hits.begin(), hits.end(), [](const Hit& x, const Hit& y) {
            if (x.j != y.j) return x.j < y.j;
            if (x.a != y.a) return x.a < y.a;
            if (x.b != y.b) return x.b < y.b;
            return x.c < y.c;
        });
        for (const Hit& h : hits) {
            if (count < cap) {
                out_src[count] = static_cast<int32_t>(i);
                out_dst[count] = h.j;
                out_image[3 * count] = h.a;
                out_image[3 * count + 1] = h.b;
                out_image[3 * count + 2] = h.c;
                out_dist[count] = h.d;
                const double inv = h.d > 0 ? 1.0 / h.d : 0.0;
                out_dir[3 * count] = h.vx * inv;
                out_dir[3 * count + 1] = h.vy * inv;
                out_dir[3 * count + 2] = h.vz * inv;
            }
            ++count;
        }
    }
    return count;
}

// Dilution planner for the batch packer (batching.py:plan_dilution): a
// monotone target remap honoring a per-aligned-`group` edge bound. Pure
// integer sequential logic — the Python loop over ~10^4 targets per batch
// is a measurable share of host packing time. Returns -1 when the remap
// would overflow `cap_rows - 1` (the reserved dummy row), else 0.
int64_t plan_dilution(
    int64_t n_real, const int64_t* counts, int64_t bound, int64_t cap_rows,
    int64_t group, int64_t* new_pos) {
  int64_t pos = 0;
  int64_t acc = 0;
  for (int64_t t = 0; t < n_real; ++t) {
    const int64_t c = counts[t];
    if (acc + c > bound && pos % group) {
      pos = (pos / group + 1) * group;
      acc = 0;
    }
    if (pos >= cap_rows - 1) return -1;
    new_pos[t] = pos;
    acc += c;
    pos += 1;
    if (pos % group == 0) acc = 0;
  }
  return 0;
}

// Arena assembly (batching.py:_assemble head): initialize the padded
// node/edge/line-graph arenas and copy each selected graph's columnar
// slices in with index offsets applied. The store keeps graphs in
// canonical dst-sorted order, so the concatenation is globally CSR-sorted
// by construction. Complements build_batch_tables below — together they
// form the native whole-batch assembler (PERF.md roadmap).
void assemble_arenas(
    int64_t n_sel, const int64_t* graph_ids,
    const int64_t* node_off, const int64_t* edge_off, const int64_t* lg_off,
    const float* s_nodes, const int32_t* s_esrc, const int32_t* s_edst,
    const float* s_eattr, const int32_t* s_lsrc, const int32_t* s_ldst,
    const float* s_lattr,
    int64_t f_node, int64_t f_edge, int64_t f_angle,
    int64_t Np, int64_t Ep, int64_t Lp, int32_t graph_pad,
    float* nodes, int32_t* node_graph, int32_t* edge_src, int32_t* edge_dst,
    float* edge_attr, float* edge_mask, int32_t* lg_src, int32_t* lg_dst,
    float* lg_attr, float* lg_mask) {
  const int32_t dummy_node = static_cast<int32_t>(Np - 1);
  const int32_t dummy_edge = static_cast<int32_t>(Ep - 1);
  std::memset(nodes, 0, sizeof(float) * Np * f_node);
  std::fill(node_graph, node_graph + Np, graph_pad);
  std::fill(edge_src, edge_src + Ep, dummy_node);
  std::fill(edge_dst, edge_dst + Ep, dummy_node);
  std::memset(edge_attr, 0, sizeof(float) * Ep * f_edge);
  std::memset(edge_mask, 0, sizeof(float) * Ep);
  std::fill(lg_src, lg_src + Lp, dummy_edge);
  std::fill(lg_dst, lg_dst + Lp, dummy_edge);
  std::memset(lg_attr, 0, sizeof(float) * Lp * f_angle);
  std::memset(lg_mask, 0, sizeof(float) * Lp);
  int64_t nc = 0, ec = 0, lc = 0;
  for (int64_t slot = 0; slot < n_sel; ++slot) {
    const int64_t g = graph_ids[slot];
    const int64_t n0 = node_off[g], n = node_off[g + 1] - n0;
    const int64_t e0 = edge_off[g], e = edge_off[g + 1] - e0;
    const int64_t l0 = lg_off[g], l = lg_off[g + 1] - l0;
    std::memcpy(nodes + nc * f_node, s_nodes + n0 * f_node,
                sizeof(float) * n * f_node);
    std::fill(node_graph + nc, node_graph + nc + n,
              static_cast<int32_t>(slot));
    for (int64_t t = 0; t < e; ++t) {
      edge_src[ec + t] = s_esrc[e0 + t] + static_cast<int32_t>(nc);
      edge_dst[ec + t] = s_edst[e0 + t] + static_cast<int32_t>(nc);
    }
    std::memcpy(edge_attr + ec * f_edge, s_eattr + e0 * f_edge,
                sizeof(float) * e * f_edge);
    std::fill(edge_mask + ec, edge_mask + ec + e, 1.0f);
    for (int64_t t = 0; t < l; ++t) {
      lg_src[lc + t] = s_lsrc[l0 + t] + static_cast<int32_t>(ec);
      lg_dst[lc + t] = s_ldst[l0 + t] + static_cast<int32_t>(ec);
    }
    std::memcpy(lg_attr + lc * f_angle, s_lattr + l0 * f_angle,
                sizeof(float) * l * f_angle);
    std::fill(lg_mask + lc, lg_mask + lc + l, 1.0f);
    nc += n;
    ec += e;
    lc += l;
  }
}

// Whole-batch table builder (batching.py:_assemble tail): the four dense
// incoming/outgoing tables, both src-CSR permutations, and both CSR row
// pointers in one GIL-released pass. Replaces four stable argsort-based
// build_incoming_table calls + two argsort/searchsorted pairs + two
// searchsorted row-pointer builds — ~70 % of host packing time (PERF.md
// "Host packing pipeline"). All sorts are counting sorts (index values are
// bounded by the arena capacities) in ascending-index order, which is
// exactly the stable-argsort order the Python path produces — numerics are
// bit-identical (tests/test_native.py).
//
// Outputs are caller-allocated, uninitialized; this routine fills padding.
// Returns 0, or 1..4 when a dense-table in-degree exceeds its capacity
// (node_in / lg_in / node_out / lg_out respectively) — the caller falls
// back to the Python path for the identical diagnostic.
int64_t build_batch_tables(
    int64_t Np, int64_t Ep, int64_t Lp,
    const int32_t* edge_src, const int32_t* edge_dst, const float* edge_mask,
    const int32_t* lg_src, const int32_t* lg_dst, const float* lg_mask,
    int64_t cap_in_a, int64_t cap_in_l, int64_t cap_out_a, int64_t cap_out_l,
    int32_t* node_tab, float* node_tab_mask, int32_t* edge_pos,
    int32_t* lg_tab, float* lg_tab_mask, int32_t* lg_pos,
    int32_t* node_ot, float* node_ot_mask,
    int32_t* lg_ot, float* lg_ot_mask,
    int32_t* e_order, int32_t* e_starts,
    int32_t* l_order, int32_t* l_starts,
    int32_t* e_rp, int32_t* l_rp) {
  // one dense table: rows ∈ [0, n_rows), keyed by key[e] over real entries
  // (mask > 0) in ascending e — the stable per-key order. `pos` (optional)
  // records each entry's flat table slot.
  const auto fill_table = [](int64_t n_entries, const int32_t* key,
                             const float* mask, int64_t n_rows, int64_t cap,
                             int32_t pad_slot, int32_t* tab, float* tab_mask,
                             int32_t* pos, std::vector<int32_t>& cnt) -> bool {
    std::fill(tab, tab + n_rows * cap, pad_slot);
    std::fill(tab_mask, tab_mask + n_rows * cap, 0.0f);
    if (pos != nullptr) {
      const int32_t safe =
          static_cast<int32_t>((n_rows - 1) * cap + (cap - 1));
      std::fill(pos, pos + n_entries, safe);
    }
    cnt.assign(static_cast<size_t>(n_rows), 0);
    for (int64_t e = 0; e < n_entries; ++e) {
      if (mask[e] <= 0.0f) continue;
      const int64_t r = key[e];
      const int32_t c = cnt[static_cast<size_t>(r)]++;
      if (c >= cap) return false;
      tab[r * cap + c] = static_cast<int32_t>(e);
      tab_mask[r * cap + c] = 1.0f;
      if (pos != nullptr) pos[e] = static_cast<int32_t>(r * cap + c);
    }
    return true;
  };
  // counting sort of the FULL arena by key (values < n_rows): `order` is the
  // stable argsort permutation, `starts[v]` the first slot with key >= v
  // (searchsorted-left semantics on the sorted keys).
  const auto csr_index = [](int64_t n_entries, const int32_t* key,
                            int64_t n_rows, int32_t* order, int32_t* starts,
                            std::vector<int64_t>& cnt) {
    cnt.assign(static_cast<size_t>(n_rows) + 1, 0);
    for (int64_t e = 0; e < n_entries; ++e) ++cnt[static_cast<size_t>(key[e]) + 1];
    for (int64_t v = 0; v < n_rows; ++v) cnt[v + 1] += cnt[v];
    for (int64_t v = 0; v < n_rows; ++v)
      starts[v] = static_cast<int32_t>(cnt[v]);
    std::vector<int64_t> cursor(cnt.begin(), cnt.end() - 1);
    for (int64_t e = 0; e < n_entries; ++e)
      order[cursor[static_cast<size_t>(key[e])]++] = static_cast<int32_t>(e);
  };
  // row pointers of an already dst-sorted arena: rp[v] = #entries with
  // dst < v, v ∈ [0, n_rows] — equals searchsorted(dst, arange(n_rows+1)).
  const auto row_ptr = [](int64_t n_entries, const int32_t* dst,
                          int64_t n_rows, int32_t* rp,
                          std::vector<int64_t>& cnt) {
    cnt.assign(static_cast<size_t>(n_rows) + 1, 0);
    for (int64_t e = 0; e < n_entries; ++e) ++cnt[static_cast<size_t>(dst[e]) + 1];
    int64_t acc = 0;
    rp[0] = 0;
    for (int64_t v = 0; v < n_rows; ++v) {
      acc += cnt[v + 1];
      rp[v + 1] = static_cast<int32_t>(acc);
    }
  };

  std::vector<int32_t> cnt32;
  std::vector<int64_t> cnt64;
  if (!fill_table(Ep, edge_dst, edge_mask, Np, cap_in_a,
                  static_cast<int32_t>(Ep - 1), node_tab, node_tab_mask,
                  edge_pos, cnt32))
    return 1;
  if (!fill_table(Lp, lg_dst, lg_mask, Ep, cap_in_l,
                  static_cast<int32_t>(Lp - 1), lg_tab, lg_tab_mask,
                  lg_pos, cnt32))
    return 2;
  if (!fill_table(Ep, edge_src, edge_mask, Np, cap_out_a,
                  static_cast<int32_t>(Ep - 1), node_ot, node_ot_mask,
                  nullptr, cnt32))
    return 3;
  if (!fill_table(Lp, lg_src, lg_mask, Ep, cap_out_l,
                  static_cast<int32_t>(Lp - 1), lg_ot, lg_ot_mask,
                  nullptr, cnt32))
    return 4;
  csr_index(Ep, edge_src, Np, e_order, e_starts, cnt64);
  csr_index(Lp, lg_src, Ep, l_order, l_starts, cnt64);
  row_ptr(Ep, edge_dst, Np, e_rp, cnt64);
  row_ptr(Lp, lg_dst, Ep, l_rp, cnt64);
  return 0;
}

}  // extern "C"
