"""Static-shape graph batching (the port's own copy of `gnnep_tpu.data.batching`).

Packs graphs into fixed-capacity arenas with validity masks, exactly as the
JAX package does, so both packages see array-equal batches from the same
store (tests/test_torch_data.py). The dense tables, src orders and win64
bounds are TPU layouts that the CUDA eproj kernel does not read; they stay
because the training slice's backward kernels and the parity tests do.

Conventions:
- Node arena has capacity `Np`; index `Np-1` is the reserved DUMMY node.
  Padded edges point src=dst=dummy so their messages scatter into a slot
  that is never pooled. Padded nodes carry graph id `G` (one extra segment,
  dropped after pooling).
- Edge arena capacity `Ep`; index `Ep-1` is the reserved DUMMY bond, the
  target of padded line-graph edges.
- Graph arena capacity `G`; padded graph rows have `graph_mask=False`,
  y=1.0 (safe under log), y_mask=0 (the authority on target validity —
  y's fill value is NOT a sentinel), weight 0.
- When the budget carries win64 window bounds, dense regions are DILUTED:
  masked padding rows are interleaved into the arenas (bond gap rows carry
  src=dummy but a forward-filled real dst to keep the CSR sort), so "padding
  ⇒ dst == dummy" holds only for the tail, not for interior gap rows. All
  consumers treat `*_mask == 0` as the authority.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, NamedTuple, Optional, Sequence

import numpy as np

from .. import native as _native
from .store import GraphStore


class GraphBatch(NamedTuple):
    """One padded batch; a pytree of arrays with static shapes.

    Besides the COO arenas, batches carry *dense incoming-edge tables* — the
    TPU-native aggregation layout: `node_in_edges[n, d]` lists the edge slots
    targeting node n (padded with the dummy edge), so attention softmax and
    message aggregation become plain masked reductions over the degree axis
    with no XLA scatter anywhere. `edge_table_pos` is the inverse map (each
    edge's flat position in that table) that turns the backward pass into a
    pure gather. Same structure one level up for the line graph.
    """

    nodes: np.ndarray        # [Np, F_node] f32
    node_graph: np.ndarray   # [Np] i32 — graph slot, padding → G
    edge_src: np.ndarray     # [Ep] i32 — node index (message source)
    edge_dst: np.ndarray     # [Ep] i32 — node index (aggregation target)
    edge_attr: np.ndarray    # [Ep, F_edge] f32
    edge_mask: np.ndarray    # [Ep] f32 (1 = real)
    lg_src: np.ndarray       # [Lp] i32 — bond index
    lg_dst: np.ndarray       # [Lp] i32
    lg_attr: np.ndarray      # [Lp, F_angle] f32
    lg_mask: np.ndarray      # [Lp] f32
    globals_: np.ndarray     # [G, 59] f32
    sg_num: np.ndarray       # [G] i32 (1..230, 0 unknown/padding)
    y: np.ndarray            # [G, T] f32
    graph_mask: np.ndarray   # [G] f32
    weight: np.ndarray       # [G] f32 per-sample loss weights
    sample_index: np.ndarray  # [G] i32 global dataset index (−1 padding)
    node_in_edges: np.ndarray  # [Np, Da] i32 edge slots with dst == n (pad: Ep-1)
    node_in_mask: np.ndarray   # [Np, Da] f32
    edge_table_pos: np.ndarray  # [Ep] i32 flat position in node_in_edges
    lg_in_edges: np.ndarray    # [Ep, Dl] i32 LG slots with dst == bond (pad: Lp-1)
    lg_in_mask: np.ndarray     # [Ep, Dl] f32
    lg_table_pos: np.ndarray   # [Lp] i32 flat position in lg_in_edges
    node_out_edges: np.ndarray  # [Np, Doa] i32 edge slots with src == n
    node_out_mask: np.ndarray   # [Np, Doa] f32
    lg_out_edges: np.ndarray    # [Ep, Dol] i32 LG slots with src == bond
    lg_out_mask: np.ndarray     # [Ep, Dol] f32
    edge_src_order: np.ndarray  # [Ep] i32 permutation sorting edges by src
    edge_src_starts: np.ndarray  # [Np] i32 per-node start in that order
    lg_src_order: np.ndarray    # [Lp] i32 permutation sorting LG by src
    lg_src_starts: np.ndarray   # [Ep] i32 per-bond start in that order
    # CSR row pointers of the dst-sorted arenas, precomputed at pack time:
    # a device-side searchsorted costs ~12 % of a train step (a 17-iteration
    # binary-search while-loop in XLA), and the arenas are static per batch
    edge_row_ptr: np.ndarray    # [Np+1] i32 searchsorted(edge_dst, arange)
    lg_row_ptr: np.ndarray      # [Ep+1] i32 searchsorted(lg_dst, arange)
    # per-target validity (1 = a real, finite ground-truth value). Padded
    # graph rows and missing targets are 0 — consumers must use THIS, never
    # a magic y value (a real material with K=G=1.0 GPa is a valid sample)
    y_mask: np.ndarray          # [G, T] f32
    # span-formulation metadata (optional — None on hand-built batches):
    # per-target FIRST possible source row. Graphs are packed contiguously,
    # so every edge into target t sources from t's own graph's row range;
    # `node_span_lo[t]` (atom conv) / `bond_span_lo[t]` (LG conv) is that
    # range's first real row, monotone over the arena (padding rows carry
    # the following real row's value). The span kernels DMA one contiguous
    # node-table span per target block instead of a gathered edge-space kv
    # arena (ops/pallas/csr_attention.py "span formulation").
    node_span_lo: Optional[np.ndarray] = None   # [Np] i32
    bond_span_lo: Optional[np.ndarray] = None   # [Ep] i32

    @property
    def capacity(self):
        return (self.nodes.shape[0], self.edge_src.shape[0],
                self.lg_src.shape[0], self.y.shape[0])

    @property
    def n_real_graphs(self) -> int:
        return int(np.asarray(self.graph_mask).sum())


@dataclasses.dataclass(frozen=True)
class BatchBudget:
    """Fixed arena capacities; one compilation per budget."""

    n_graphs: int
    n_nodes: int    # includes the dummy slot
    n_edges: int    # includes the dummy slot
    n_lg_edges: int
    max_in_degree: int = 32      # dense-table width: atom in-degree cap
    max_lg_in_degree: int = 32   # dense-table width: bond LG in-degree cap
    max_out_degree: int = 32     # atom out-degree cap (gather-VJP tables)
    max_lg_out_degree: int = 32  # bond LG out-degree cap
    # packer-enforced window bounds (0 = unenforced): max edge rows owned by
    # any aligned 64-node group / max LG rows per aligned 64-bond group. The
    # packer dilutes dense regions with interior padding rows to honor them,
    # letting the Pallas kernels size VMEM windows far below the
    # block·max_in_degree worst case (see PERF.md "window density").
    edge_win64: int = 0
    lg_win64: int = 0
    # src-side bounds: max rows owned by any aligned group of 64 consecutive
    # segments of the SRC-sorted arenas (the gather-VJP segment-sum layout).
    # Not enforceable by dilution (segment sizes are the data's out-degrees);
    # the packer asserts and defers tail graphs on overflow instead.
    edge_src_win64: int = 0
    lg_src_win64: int = 0

    @classmethod
    def plan(cls, store: GraphStore, indices: Sequence[int], batch_size: int,
             slack: float = 1.15, quantile: float = 0.95,
             win_quantile: float = 0.999,
             cover_all: bool = True) -> "BatchBudget":
        """Size arenas so `batch_size` typical graphs fit: capacity =
        max(largest single graph, batch_size × q-quantile × slack), rounded
        up to a multiple of 8 (TPU sublane) with +1 dummy slot. Dense-table
        widths are the dataset maxima of atom in-degree / bond LG in-degree.

        `cover_all=False` drops the largest-single-graph guarantee: arenas
        size to TYPICAL batch statistics only, so outlier giant graphs no
        longer balloon every batch's padding — callers must route graphs
        that do not fit (`parallel.giant.find_giants`) through the
        boundary-partitioned path instead of this packer."""
        idx = np.asarray(list(indices), dtype=np.int64)
        if idx.size == 0:
            raise ValueError("Cannot plan a batch budget over an empty index set.")
        n = np.diff(store.node_off)[idx]
        e = np.diff(store.edge_off)[idx]
        l = np.diff(store.lg_off)[idx]

        def cap(counts: np.ndarray, mult: int = 8) -> int:
            # mean-based capacity: on heavy-tailed distributions a
            # quantile-based budget overshoots the typical batch several-fold
            # (mostly padding); the packer emits a batch early when a tail
            # graph would overflow, and max() guarantees every graph fits
            per = float(counts.mean()) if counts.size else 1.0
            need = int(np.ceil(batch_size * per * slack))
            if cover_all:
                need = max(int(counts.max(initial=1)), need)
            return _round_up(need + 1, mult)

        deg_a = deg_l = deg_ao = deg_lo = 1
        node_counts: List[np.ndarray] = []
        bond_counts: List[np.ndarray] = []
        node_out_counts: List[np.ndarray] = []
        bond_out_counts: List[np.ndarray] = []
        for g in idx:
            n_g = int(store.node_off[g + 1] - store.node_off[g])
            e_g = store.edge_dst[store.edge_off[g]:store.edge_off[g + 1]]
            es_g = store.edge_src[store.edge_off[g]:store.edge_off[g + 1]]
            l_g = store.lg_dst[store.lg_off[g]:store.lg_off[g + 1]]
            ls_g = store.lg_src[store.lg_off[g]:store.lg_off[g + 1]]
            if e_g.size:
                nc = np.bincount(e_g, minlength=n_g)
                no = np.bincount(es_g, minlength=n_g)
                deg_a = max(deg_a, int(nc.max()))
                deg_ao = max(deg_ao, int(no.max()))
                node_counts.append(nc)
                node_out_counts.append(no)
            if l_g.size:
                bc = np.bincount(l_g, minlength=e_g.size)
                bo = np.bincount(ls_g, minlength=e_g.size)
                deg_l = max(deg_l, int(bc.max()))
                deg_lo = max(deg_lo, int(bo.max()))
                bond_counts.append(bc)
                bond_out_counts.append(bo)

        def win_bound(counts: List[np.ndarray], floor: int) -> int:
            # quantile of aligned-64-group sums over the concatenated
            # per-target counts; the packer's dilution is the safety valve
            # for batches that exceed it, so this is a target, not a maximum
            if not counts:
                return _round_up(floor, 32)
            c = np.concatenate(counts)
            pad = (-c.size) % 64
            g = np.pad(c, (0, pad)).reshape(-1, 64).sum(axis=1)
            q = float(np.quantile(g, win_quantile)) * 1.1
            return _round_up(max(int(np.ceil(q)), floor, 1), 32)

        # all arenas pad to the fused kernel's 128 tile (node/edge rows are
        # aggregation blocks; the LG arena is a 128-lane-aligned window source)
        return cls(n_graphs=int(batch_size), n_nodes=cap(n, 128),
                   n_edges=cap(e, 128), n_lg_edges=cap(l, 128),
                   max_in_degree=_round_up(deg_a, 4),
                   max_lg_in_degree=_round_up(deg_l, 4),
                   max_out_degree=_round_up(deg_ao, 4),
                   max_lg_out_degree=_round_up(deg_lo, 4),
                   # +128 on the atom floor: LG dilution interleaves padding
                   # rows into the edge arena, so a single atom's row span
                   # can exceed its degree by up to two group skips
                   edge_win64=win_bound(node_counts, deg_a + 128),
                   lg_win64=win_bound(bond_counts, deg_l),
                   # src arenas have no interleaved padding (padded rows
                   # carry src=dummy and sort last), so no dilution fudge;
                   # a modest extra floor absorbs out-degree clustering
                   edge_src_win64=win_bound(node_out_counts, deg_ao + 64),
                   lg_src_win64=win_bound(bond_out_counts, deg_lo + 64))


def build_incoming_table(dst: np.ndarray, mask: np.ndarray, n_rows: int,
                         cap: int, pad_slot: int,
                         order: Optional[np.ndarray] = None):
    """Dense incoming table for one arena.

    Returns (table [n_rows, cap] i32, table_mask [n_rows, cap] f32,
    pos [len(dst)] i32) where `pos[e]` is edge e's flat slot in the table
    (padded entries point at row n_rows-1's last column, which is always a
    masked slot by the dummy-row convention). `order` is an optional
    precomputed stable key-sort permutation of the FULL arena (shared with
    `src_csr_index` for the outgoing tables).
    """
    e_total = dst.shape[0]
    table = np.full((n_rows, cap), pad_slot, dtype=np.int32)
    table_mask = np.zeros((n_rows, cap), dtype=np.float32)
    safe_pos = (n_rows - 1) * cap + (cap - 1)
    pos = np.full(e_total, safe_pos, dtype=np.int32)
    real = np.nonzero(mask > 0)[0]
    if real.size:
        d = dst[real]
        if order is not None:
            es = order[mask[order] > 0].astype(np.int64)
            ds = dst[es]
        elif bool(np.all(d[1:] >= d[:-1])):  # arena is CSR-sorted already
            ds, es = d, real
        else:
            o = np.argsort(d, kind="stable")
            ds, es = d[o], real[o]
        # first occurrence per run, O(n) (a searchsorted(ds, ds) here was a
        # measurable share of host packing)
        starts = np.flatnonzero(np.concatenate(([True], ds[1:] != ds[:-1])))
        first = np.repeat(starts, np.diff(np.append(starts, ds.size)))
        cum = np.arange(ds.size) - first
        overflow = int(cum.max(initial=0))
        if overflow >= cap:
            raise ValueError(
                f"in-degree {overflow + 1} exceeds dense-table capacity {cap}; "
                "re-plan the batch budget over these indices.")
        table[ds, cum] = es
        table_mask[ds, cum] = 1.0
        pos[es] = ds.astype(np.int64) * cap + cum
    return table, table_mask, pos


class DilutionOverflow(Exception):
    """Honoring a win64 bound would overflow the arena; repack with fewer
    graphs."""


def plan_dilution(counts: np.ndarray, bound: int, cap_rows: int,
                  group: int = 64) -> Optional[np.ndarray]:
    """Monotone target remap honoring a per-aligned-group edge bound.

    `counts[t]` is the number of edge rows owned by real target t (in CSR
    order). Returns new positions such that every aligned `group` of target
    rows owns ≤ `bound` edge rows, skipping to the next group boundary when
    a target would overflow the current group — the skipped slots become
    interior padding rows. None if the remap needs ≥ cap_rows − 1 rows (the
    last row stays reserved for the dummy target), or if a single target
    alone exceeds the bound (no remap can honor it — found by fuzzing:
    bond-dilution padding can inflate one atom's edge span past an
    otherwise-sufficient bound).
    """
    if counts.size and int(counts.max()) > bound:
        return None
    native = _native.plan_dilution_native(counts, bound, cap_rows, group)
    if native is not NotImplemented:
        return native
    n_real = counts.shape[0]
    new = np.empty(n_real, np.int64)
    pos = 0
    acc = 0
    for t in range(n_real):
        c = int(counts[t])
        if acc + c > bound and pos % group:
            pos = ((pos // group) + 1) * group
            acc = 0
        if pos >= cap_rows - 1:
            return None
        new[t] = pos
        acc += c
        pos += 1
        if pos % group == 0:
            acc = 0
    return new


def dilute_for_window_bounds(nodes, node_graph, edge_src, edge_dst, edge_attr,
                             edge_mask, lg_src, lg_dst, lg_mask, *,
                             n_real_nodes: int, n_real_edges: int,
                             edge_win64: int, lg_win64: int):
    """Relocate tail padding rows into dense regions so every aligned
    64-target group honors the window bounds.

    Bond-space dilution (for the LG conv) runs first — it interleaves masked
    bond rows into the edge arena, whose forward-filled dst values keep the
    atom-CSR sort while extending atom row spans — then node-space dilution
    (for the atom conv) re-spaces node indices over the final edge arena.
    Raises DilutionOverflow when a bound cannot be met within capacity.
    """
    Np = nodes.shape[0]
    Ep = edge_src.shape[0]
    dummy_node, dummy_edge = Np - 1, Ep - 1

    if lg_win64 and n_real_edges:
        lg_counts = np.bincount(lg_dst[lg_mask > 0].astype(np.int64),
                                minlength=Ep)[:n_real_edges]
        new_pos = plan_dilution(lg_counts, lg_win64, Ep)
        if new_pos is None:
            raise DilutionOverflow()
        if int(new_pos[-1]) != n_real_edges - 1:
            ns = np.full(Ep, dummy_node, np.int32)
            nd = np.full(Ep, dummy_node, np.int32)
            na = np.zeros_like(edge_attr)
            nm = np.zeros(Ep, np.float32)
            ns[new_pos] = edge_src[:n_real_edges]
            nd[new_pos] = edge_dst[:n_real_edges]
            na[new_pos] = edge_attr[:n_real_edges]
            nm[new_pos] = edge_mask[:n_real_edges]
            # forward-fill gap rows' dst inside the diluted span: keeps the
            # arena sorted by dst; the rows stay masked interior padding
            end = int(new_pos[-1]) + 1
            assigned = np.zeros(Ep, bool)
            assigned[new_pos] = True
            last = np.where(assigned, np.arange(Ep), 0)
            np.maximum.accumulate(last, out=last)
            gaps = ~assigned
            gaps[end:] = False
            nd[gaps] = nd[last[gaps]]
            remap = np.full(Ep, dummy_edge, np.int64)
            remap[:n_real_edges] = new_pos
            edge_src, edge_dst, edge_attr, edge_mask = ns, nd, na, nm
            lg_src = remap[lg_src].astype(np.int32)
            lg_dst = remap[lg_dst].astype(np.int32)

    if edge_win64 and n_real_nodes:
        rp = np.searchsorted(edge_dst, np.arange(Np + 1))
        spans = (rp[1:] - rp[:-1])[:n_real_nodes]
        new_pos = plan_dilution(spans, edge_win64, Np)
        if new_pos is None:
            raise DilutionOverflow()
        if int(new_pos[-1]) != n_real_nodes - 1:
            nn = np.zeros_like(nodes)
            ng = np.full(Np, node_graph[dummy_node], np.int32)
            nn[new_pos] = nodes[:n_real_nodes]
            ng[new_pos] = node_graph[:n_real_nodes]
            remap = np.full(Np, dummy_node, np.int64)
            remap[:n_real_nodes] = new_pos
            nodes, node_graph = nn, ng
            edge_src = remap[edge_src].astype(np.int32)
            edge_dst = remap[edge_dst].astype(np.int32)

    # the plans bound per-group sums of the counts they saw, but coupling
    # between the two passes (bond dilution stretches atom spans) means the
    # ACHIEVED spans must be verified — never emit a batch the kernels'
    # windows would under-cover; deferral (fewer graphs → less dilution)
    # is the recovery path
    if lg_win64 and n_real_edges and measure_win64(lg_dst, Ep) > lg_win64:
        raise DilutionOverflow()
    if edge_win64 and n_real_nodes and \
            measure_win64(edge_dst, Np) > edge_win64:
        raise DilutionOverflow()

    return (nodes, node_graph, edge_src, edge_dst, edge_attr, edge_mask,
            lg_src, lg_dst)


def measure_win64(dst_sorted: np.ndarray, n_rows: int, group: int = 64) -> int:
    """Max edge-row span owned by any aligned group of `group` consecutive
    aggregation targets, excluding the reserved dummy target's tail padding.

    This is the quantity the Pallas kernels' `win64` window bound must
    dominate; measuring it on a packed batch yields an exact static bound
    for single-batch benchmarks, and validates packer-enforced budgets.
    """
    rp = np.searchsorted(dst_sorted, np.arange(n_rows + 1)).astype(np.int64)
    dummy_start = rp[n_rows - 1]
    rp = np.minimum(rp, dummy_start)
    starts = rp[0:n_rows:group]
    end_idx = np.minimum(np.arange(0, n_rows, group) + group, n_rows)
    return int(np.max(rp[end_idx] - starts)) if n_rows else 0


def _span_bounds(gid: np.ndarray, real: np.ndarray, n_graphs: int):
    """Per-row [lo, hi) bounds of the rows' graphs' real-row ranges.

    `gid` [R] per-row graph ids (padding rows excluded via `real`); returns
    (span_lo [R] i64 monotone — padding rows backward-filled with the next
    real row's value, tail → R-1 — and span_hi [R] i64, 0 on padding rows).
    """
    r = gid.shape[0]
    idx = np.arange(r, dtype=np.int64)
    first = np.full(n_graphs, r - 1, np.int64)
    last = np.full(n_graphs, -1, np.int64)
    g_real = gid[real].astype(np.int64)
    np.minimum.at(first, g_real, idx[real])
    np.maximum.at(last, g_real, idx[real])
    big = np.int64(1 << 60)
    lo = np.where(real, first[np.clip(gid, 0, n_graphs - 1)], big)
    # monotone backward-fill of padding rows (block span starts index the
    # block's FIRST row, which must lower-bound every row in the block)
    lo = np.minimum.accumulate(lo[::-1])[::-1]
    lo = np.minimum(lo, r - 1)
    hi = np.where(real, last[np.clip(gid, 0, n_graphs - 1)] + 1, 0)
    return lo, hi


def compute_span_lo(node_graph: np.ndarray, edge_dst: np.ndarray,
                    edge_mask: np.ndarray, n_graphs: int):
    """Span-formulation metadata for a packed batch (see GraphBatch).

    Returns (node_span_lo [Np] i32, bond_span_lo [Ep] i32): per aggregation
    target, the first arena row that can source an edge into it — its
    graph's first real row in the node / bond arena respectively. Must be
    computed AFTER dilution (dilution relocates rows).
    """
    np_, ep = node_graph.shape[0], edge_dst.shape[0]
    real_n = node_graph < n_graphs
    n_lo, _ = _span_bounds(node_graph.astype(np.int64), real_n, n_graphs)
    real_b = edge_mask > 0
    bond_gid = np.where(real_b,
                        node_graph[np.clip(edge_dst, 0, np_ - 1)], n_graphs)
    b_lo, _ = _span_bounds(bond_gid.astype(np.int64), real_b, n_graphs)
    return n_lo.astype(np.int32), b_lo.astype(np.int32)


def measure_span64(node_graph: np.ndarray, edge_dst: np.ndarray,
                   edge_mask: np.ndarray, n_graphs: int, group: int = 64):
    """Measured static span bounds for the span-formulation kernels.

    For each aligned `group` of aggregation targets, the kernels DMA the
    node-table rows [align128_down(span_lo[first]), ·+SPAN); this returns
    the smallest 128-multiple SPAN that covers every group's sources —
    (node_span64, bond_span64) for the atom / LG conv respectively.
    """
    np_, ep = node_graph.shape[0], edge_dst.shape[0]
    real_n = node_graph < n_graphs
    real_b = edge_mask > 0
    bond_gid = np.where(real_b,
                        node_graph[np.clip(edge_dst, 0, np_ - 1)], n_graphs)

    def bound(gid, real):
        lo, hi = _span_bounds(gid.astype(np.int64), real, n_graphs)
        r = gid.shape[0]
        req = 0
        for s in range(0, r, group):
            e = min(s + group, r)
            if not np.any(real[s:e]):
                continue
            g_lo = (int(lo[s]) // 128) * 128
            g_hi = int(hi[s:e].max())
            req = max(req, g_hi - g_lo)
        return ((req + 127) // 128) * 128 if req else 0

    return bound(node_graph, real_n), bound(bond_gid, real_b)


def csr_row_ptrs(edge_dst: np.ndarray, lg_dst: np.ndarray, Np: int, Ep: int):
    """Host-side CSR row pointers of both dst-sorted arenas (see GraphBatch)."""
    e_rp = np.searchsorted(edge_dst, np.arange(Np + 1)).astype(np.int32)
    l_rp = np.searchsorted(lg_dst, np.arange(Ep + 1)).astype(np.int32)
    return e_rp, l_rp


def measure_seg_win64(seg_starts: np.ndarray, e_total: int,
                      group: int = 64) -> int:
    """Max row span of any aligned group of `group` consecutive segments of
    a segment-contiguous arena (`seg_starts` [N] per-segment start offsets),
    clamped at the reserved dummy segment: the last segment owns the tail
    padding and is unspecified by the kernel contract."""
    n = seg_starts.shape[0]
    if n == 0:
        return 0
    starts = seg_starts.astype(np.int64)
    ends = np.concatenate([starts[1:], [np.int64(e_total)]])
    dummy_start = int(starts[n - 1])
    s = np.minimum(starts, dummy_start)
    e = np.minimum(ends, dummy_start)
    gs = s[0:n:group]
    ge_idx = np.minimum(np.arange(0, n, group) + group - 1, n - 1)
    return int(np.max(e[ge_idx] - gs))


def src_csr_index(src_vals: np.ndarray, n_rows: int):
    """Permutation sorting an arena by source plus per-row segment starts —
    the gather-transpose layout consumed by the windowed segment-sum kernel."""
    order = np.argsort(src_vals, kind="stable").astype(np.int32)
    starts = np.searchsorted(src_vals[order], np.arange(n_rows)).astype(np.int32)
    return order, starts


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _csr_sort(dst: np.ndarray, cap: int) -> np.ndarray:
    """Stable permutation sorting an arena by aggregation target. Padded
    entries (dst = dummy, the maximum index) sort last, and stability keeps
    the reserved dummy row at index cap-1."""
    return np.argsort(dst, kind="stable").astype(np.int64)


def _nondecreasing(a: np.ndarray) -> bool:
    return bool(np.all(a[1:] >= a[:-1])) if a.size > 1 else True


def apply_csr_sort(edge_src, edge_dst, edge_attr, edge_mask,
                   lg_src, lg_dst, lg_attr, lg_mask):
    """CSR-sort both arenas by aggregation target, remapping the line
    graph's bond references through the edge permutation.

    Fast path: GraphStore canonicalizes each graph to dst-sorted order, so
    the assembled arenas (per-graph slices at increasing offsets, padding
    at the tail) are already globally sorted — both permutations reduce to
    an O(n) sortedness check."""
    Ep, Lp = edge_src.shape[0], lg_src.shape[0]
    if not _nondecreasing(edge_dst):
        edge_perm = _csr_sort(edge_dst, Ep)
        inv_edge = np.empty(Ep, np.int32)
        inv_edge[edge_perm] = np.arange(Ep, dtype=np.int32)
        edge_src = edge_src[edge_perm]
        edge_dst = edge_dst[edge_perm]
        edge_attr = edge_attr[edge_perm]
        edge_mask = edge_mask[edge_perm]
        lg_src = inv_edge[lg_src]
        lg_dst = inv_edge[lg_dst]
    if not _nondecreasing(lg_dst):
        lg_perm = _csr_sort(lg_dst, Lp)
        lg_src, lg_dst = lg_src[lg_perm], lg_dst[lg_perm]
        lg_attr, lg_mask = lg_attr[lg_perm], lg_mask[lg_perm]
    return (edge_src, edge_dst, edge_attr, edge_mask,
            lg_src, lg_dst, lg_attr, lg_mask)


class BatchPacker:
    """Greedy first-fit packer: graphs are packed in the given order until a
    capacity would overflow, then the batch is emitted. When the budget
    carries win64 window bounds, batches whose dilution would overflow the
    arenas are re-emitted with their tail graphs deferred to the next batch.
    """

    def __init__(self, store: GraphStore, budget: BatchBudget):
        self.store = store
        self.budget = budget

    def plan_groups(self, indices: Sequence[int]) -> List[List[int]]:
        """Greedy capacity partition of `indices` into batch groups —
        the cheap counting phase of `pack`, pre-dilution."""
        b = self.budget
        groups: List[List[int]] = []
        cur: List[int] = []
        n_used, e_used, l_used = 0, 0, 0
        for raw in indices:
            i = int(raw)
            n, e, l = self.store.counts(i)
            if n > b.n_nodes - 1 or e > b.n_edges - 1 or l > b.n_lg_edges:
                raise ValueError(
                    f"Graph {i} (nodes={n}, edges={e}, lg={l}) exceeds batch budget {b}; "
                    "re-plan with a larger quantile/slack.")
            if cur and (len(cur) + 1 > b.n_graphs or n_used + n > b.n_nodes - 1
                        or e_used + e > b.n_edges - 1
                        or l_used + l > b.n_lg_edges):
                groups.append(cur)
                cur = []
                n_used = e_used = l_used = 0
            cur.append(i)
            n_used += n
            e_used += e
            l_used += l
        if cur:
            groups.append(cur)
        return groups

    def pack(self, indices: Sequence[int],
             weights: Optional[np.ndarray] = None,
             drop_remainder: bool = False) -> Iterator[GraphBatch]:
        b = self.budget
        pending: List[int] = [int(i) for i in indices]
        pending.reverse()                     # treat as a stack: pop() = next
        cur: List[int] = []
        n_used, e_used, l_used = 0, 0, 0
        while pending:
            i = pending.pop()
            n, e, l = self.store.counts(i)
            if n > b.n_nodes - 1 or e > b.n_edges - 1 or l > b.n_lg_edges:
                raise ValueError(
                    f"Graph {i} (nodes={n}, edges={e}, lg={l}) exceeds batch budget {b}; "
                    "re-plan with a larger quantile/slack.")
            if (len(cur) + 1 > b.n_graphs or n_used + n > b.n_nodes - 1
                    or e_used + e > b.n_edges - 1 or l_used + l > b.n_lg_edges):
                batch, cur = self._assemble_fitting(cur, weights)
                yield batch
                n_used = e_used = l_used = 0
                for j in cur:
                    nj, ej, lj = self.store.counts(j)
                    n_used += nj
                    e_used += ej
                    l_used += lj
            cur.append(i)
            n_used += n
            e_used += e
            l_used += l
        if cur and not drop_remainder:
            while cur:
                batch, cur = self._assemble_fitting(cur, weights)
                yield batch

    def pack_parallel(self, indices: Sequence[int],
                      weights: Optional[np.ndarray] = None,
                      workers: int = 4) -> List[GraphBatch]:
        """Assemble an epoch's batches on a thread pool (the numpy-heavy
        assembly releases the GIL). Semantics differ from `pack` in one
        documented way: graphs deferred by dilution overflow are repacked at
        the END of the epoch rather than into the immediately following
        batch — every graph still appears exactly once."""
        from concurrent.futures import ThreadPoolExecutor

        out: List[GraphBatch] = []
        todo = [int(i) for i in indices]
        with ThreadPoolExecutor(max_workers=workers) as ex:
            while todo:
                groups = self.plan_groups(todo)
                results = list(ex.map(
                    lambda g: self._assemble_fitting(g, weights), groups))
                todo = []
                for batch, leftover in results:
                    out.append(batch)
                    todo.extend(leftover)
        return out

    def _assemble_fitting(self, cur: List[int], weights):
        """Assemble `cur`, deferring tail graphs while dilution overflows.

        Returns (batch, leftover): leftover graphs start the next batch."""
        leftover: List[int] = []
        while True:
            try:
                return self._assemble(cur, weights), leftover[::-1]
            except DilutionOverflow:
                if len(cur) <= 1:
                    raise ValueError(
                        f"Graph {cur} cannot satisfy window bounds "
                        f"(edge_win64={self.budget.edge_win64}, "
                        f"lg_win64={self.budget.lg_win64}) within the arena "
                        "capacities; re-plan with a larger win_quantile or "
                        "capacity slack.")
                leftover.append(cur.pop())

    def _assemble(self, graph_ids: List[int], weights: Optional[np.ndarray]) -> GraphBatch:
        s, b = self.store, self.budget
        Np, Ep, Lp, G = b.n_nodes, b.n_edges, b.n_lg_edges, b.n_graphs
        dummy_node, dummy_edge = Np - 1, Ep - 1
        f_node, f_edge, f_angle = s.node_dim, s.edge_dim, s.angle_dim

        arenas = _native.assemble_arenas_native(
            s, graph_ids, Np, Ep, Lp, G)
        if arenas is not None:
            (nodes, node_graph, edge_src, edge_dst, edge_attr, edge_mask,
             lg_src, lg_dst, lg_attr, lg_mask) = arenas
            n_cursor = e_cursor = l_cursor = 0
            for g in graph_ids:
                n_cursor += int(s.node_off[g + 1] - s.node_off[g])
                e_cursor += int(s.edge_off[g + 1] - s.edge_off[g])
                l_cursor += int(s.lg_off[g + 1] - s.lg_off[g])
        else:
            nodes = np.zeros((Np, f_node), dtype=np.float32)
            node_graph = np.full(Np, G, dtype=np.int32)
            edge_src = np.full(Ep, dummy_node, dtype=np.int32)
            edge_dst = np.full(Ep, dummy_node, dtype=np.int32)
            edge_attr = np.zeros((Ep, f_edge), dtype=np.float32)
            edge_mask = np.zeros(Ep, dtype=np.float32)
            lg_src = np.full(Lp, dummy_edge, dtype=np.int32)
            lg_dst = np.full(Lp, dummy_edge, dtype=np.int32)
            lg_attr = np.zeros((Lp, f_angle), dtype=np.float32)
            lg_mask = np.zeros(Lp, dtype=np.float32)
            n_cursor = e_cursor = l_cursor = 0
            for slot, g in enumerate(graph_ids):
                n0, n1 = s.node_off[g], s.node_off[g + 1]
                e0, e1 = s.edge_off[g], s.edge_off[g + 1]
                l0, l1 = s.lg_off[g], s.lg_off[g + 1]
                n, e, l = n1 - n0, e1 - e0, l1 - l0

                nodes[n_cursor:n_cursor + n] = s.node_feats[n0:n1]
                node_graph[n_cursor:n_cursor + n] = slot
                edge_src[e_cursor:e_cursor + e] = s.edge_src[e0:e1] + n_cursor
                edge_dst[e_cursor:e_cursor + e] = s.edge_dst[e0:e1] + n_cursor
                edge_attr[e_cursor:e_cursor + e] = s.edge_attr[e0:e1]
                edge_mask[e_cursor:e_cursor + e] = 1.0
                lg_src[l_cursor:l_cursor + l] = s.lg_src[l0:l1] + e_cursor
                lg_dst[l_cursor:l_cursor + l] = s.lg_dst[l0:l1] + e_cursor
                lg_attr[l_cursor:l_cursor + l] = s.lg_attr[l0:l1]
                lg_mask[l_cursor:l_cursor + l] = 1.0
                n_cursor += n
                e_cursor += e
                l_cursor += l

        globals_ = np.zeros((G, s.global_scalar_dim), dtype=np.float32)
        sg_num = np.zeros(G, dtype=np.int32)
        y = np.ones((G, s.target_dim), dtype=np.float32)
        y_mask = np.zeros((G, s.target_dim), dtype=np.float32)
        graph_mask = np.zeros(G, dtype=np.float32)
        weight = np.zeros(G, dtype=np.float32)
        sample_index = np.full(G, -1, dtype=np.int32)
        for slot, g in enumerate(graph_ids):
            globals_[slot] = s.global_scalars[g]
            sg_num[slot] = s.sg_num[g]
            yg = s.y[g]
            finite = np.isfinite(yg)
            y[slot] = np.where(finite, yg, 1.0)  # 1.0 = inert under log
            y_mask[slot] = finite.astype(np.float32)
            graph_mask[slot] = 1.0
            weight[slot] = 1.0 if weights is None else float(weights[g])
            sample_index[slot] = g

        # CSR-sort both arenas by aggregation target: segments become
        # contiguous (dense-table gathers coalesce; Pallas kernels window
        # them with a single DMA). Padded slots (dst = dummy) sort last,
        # except the reserved dummy row itself which must stay at Ep-1/Lp-1.
        (edge_src, edge_dst, edge_attr, edge_mask,
         lg_src, lg_dst, lg_attr, lg_mask) = apply_csr_sort(
            edge_src, edge_dst, edge_attr, edge_mask,
            lg_src, lg_dst, lg_attr, lg_mask)

        if b.edge_win64 or b.lg_win64:
            (nodes, node_graph, edge_src, edge_dst, edge_attr, edge_mask,
             lg_src, lg_dst) = dilute_for_window_bounds(
                nodes, node_graph, edge_src, edge_dst, edge_attr, edge_mask,
                lg_src, lg_dst, lg_mask,
                n_real_nodes=n_cursor, n_real_edges=e_cursor,
                edge_win64=b.edge_win64, lg_win64=b.lg_win64)
            # dilute_for_window_bounds verifies the ACHIEVED spans of both
            # arenas itself (raising DilutionOverflow otherwise), so a
            # returned batch is guaranteed within bounds

        (node_tab, node_tab_mask, edge_pos, lg_tab, lg_tab_mask, lg_pos,
         node_ot, node_ot_mask, lg_ot, lg_ot_mask,
         e_order, e_starts, l_order, l_starts, e_rp, l_rp) = build_tables(
            edge_src, edge_dst, edge_mask, lg_src, lg_dst, lg_mask, Np, Ep,
            Lp, b.max_in_degree, b.max_lg_in_degree, b.max_out_degree,
            b.max_lg_out_degree)
        # src-side window bounds can't be enforced by dilution (segment
        # sizes are the data's out-degrees) — defer tail graphs instead
        if (b.edge_src_win64
                and measure_seg_win64(e_starts, Ep) > b.edge_src_win64):
            raise DilutionOverflow()
        if (b.lg_src_win64
                and measure_seg_win64(l_starts, Lp) > b.lg_src_win64):
            raise DilutionOverflow()
        n_span_lo, b_span_lo = compute_span_lo(node_graph, edge_dst,
                                               edge_mask, G)
        return GraphBatch(nodes, node_graph, edge_src, edge_dst, edge_attr,
                          edge_mask, lg_src, lg_dst, lg_attr, lg_mask,
                          globals_, sg_num, y, graph_mask, weight, sample_index,
                          node_tab, node_tab_mask, edge_pos,
                          lg_tab, lg_tab_mask, lg_pos,
                          node_ot, node_ot_mask, lg_ot, lg_ot_mask,
                          e_order, e_starts, l_order, l_starts, e_rp, l_rp,
                          y_mask, n_span_lo, b_span_lo)


def build_tables(edge_src, edge_dst, edge_mask, lg_src, lg_dst, lg_mask,
                 Np: int, Ep: int, Lp: int, cap_in_a: int, cap_in_l: int,
                 cap_out_a: int, cap_out_l: int):
    """Dense incoming/outgoing tables + src-CSR index + row pointers for one
    batch's (already CSR-sorted) arenas — native builder when the compiled
    library is present, pure-Python fallback otherwise (no toolchain, or a
    dense-table capacity overflow where the Python path raises the full
    in-degree diagnostic). Returns the 16-tuple consumed by GraphBatch."""
    native = _native.build_batch_tables_native(
        edge_src, edge_dst, edge_mask, lg_src, lg_dst, lg_mask, Np,
        cap_in_a, cap_in_l, cap_out_a, cap_out_l)
    if native is not None:
        return native
    node_tab, node_tab_mask, edge_pos = build_incoming_table(
        edge_dst, edge_mask, Np, cap_in_a, Ep - 1)
    lg_tab, lg_tab_mask, lg_pos = build_incoming_table(
        lg_dst, lg_mask, Ep, cap_in_l, Lp - 1)
    e_order, e_starts = src_csr_index(edge_src, Np)
    l_order, l_starts = src_csr_index(lg_src, Ep)
    node_ot, node_ot_mask, _ = build_incoming_table(
        edge_src, edge_mask, Np, cap_out_a, Ep - 1, order=e_order)
    lg_ot, lg_ot_mask, _ = build_incoming_table(
        lg_src, lg_mask, Ep, cap_out_l, Lp - 1, order=l_order)
    e_rp, l_rp = csr_row_ptrs(edge_dst, lg_dst, Np, Ep)
    return (node_tab, node_tab_mask, edge_pos, lg_tab, lg_tab_mask, lg_pos,
            node_ot, node_ot_mask, lg_ot, lg_ot_mask,
            e_order, e_starts, l_order, l_starts, e_rp, l_rp)


def equalize_batches(batches: Sequence[GraphBatch]) -> List[GraphBatch]:
    """Re-pad a list of GraphBatches to shared (max) arena capacities.

    The single source of the dummy-slot pad-fill conventions for mixed-budget
    batches (used by `__graft_entry__.dryrun_multichip` and anything else
    stacking batches from different budgets): core arenas are extended with
    inert rows (dst → the new dummy slot, masks 0), then the dense tables,
    src-CSR orders/starts, and row pointers are RE-DERIVED from the padded
    arenas with the same helpers the packer uses — no second hand-written
    copy of the table conventions to drift. Dense-table widths are the maxima
    across the inputs. CSR sortedness is preserved (appended rows carry the
    largest dst).
    """
    batches = list(batches)
    if not batches:
        return []
    Np = max(np.asarray(b.nodes).shape[0] for b in batches)
    Ep = max(np.asarray(b.edge_src).shape[0] for b in batches)
    Lp = max(np.asarray(b.lg_src).shape[0] for b in batches)
    G = max(np.asarray(b.y).shape[0] for b in batches)
    da = max(np.asarray(b.node_in_edges).shape[1] for b in batches)
    dl = max(np.asarray(b.lg_in_edges).shape[1] for b in batches)
    doa = max(np.asarray(b.node_out_edges).shape[1] for b in batches)
    dol = max(np.asarray(b.lg_out_edges).shape[1] for b in batches)

    def grow(arr, n_rows, fill):
        arr = np.asarray(arr)
        pad = n_rows - arr.shape[0]
        if pad <= 0:
            return arr
        tail = np.full((pad,) + arr.shape[1:], fill, dtype=arr.dtype)
        return np.concatenate([arr, tail], axis=0)

    out: List[GraphBatch] = []
    for b in batches:
        g_old = np.asarray(b.y).shape[0]
        node_graph = np.asarray(b.node_graph).copy()
        node_graph[node_graph == g_old] = G    # padding nodes pool to slot G
        edge_src = grow(b.edge_src, Ep, Np - 1)
        edge_dst = grow(b.edge_dst, Ep, Np - 1)
        edge_mask = grow(b.edge_mask, Ep, 0.0)
        lg_src = grow(b.lg_src, Lp, Ep - 1)
        lg_dst = grow(b.lg_dst, Lp, Ep - 1)
        lg_mask = grow(b.lg_mask, Lp, 0.0)
        (node_tab, node_tab_mask, edge_pos, lg_tab, lg_tab_mask, lg_pos,
         node_ot, node_ot_mask, lg_ot, lg_ot_mask,
         e_order, e_starts, l_order, l_starts, e_rp, l_rp) = build_tables(
            edge_src, edge_dst, edge_mask, lg_src, lg_dst, lg_mask,
            Np, Ep, Lp, da, dl, doa, dol)
        ng_grown = grow(node_graph, Np, G)
        nsl, bsl = compute_span_lo(ng_grown, edge_dst, edge_mask, G)
        out.append(GraphBatch(
            nodes=grow(b.nodes, Np, 0.0), node_graph=ng_grown,
            edge_src=edge_src, edge_dst=edge_dst,
            edge_attr=grow(b.edge_attr, Ep, 0.0), edge_mask=edge_mask,
            lg_src=lg_src, lg_dst=lg_dst, lg_attr=grow(b.lg_attr, Lp, 0.0),
            lg_mask=lg_mask,
            globals_=grow(b.globals_, G, 0.0), sg_num=grow(b.sg_num, G, 0),
            y=grow(b.y, G, 1.0), y_mask=grow(b.y_mask, G, 0.0),
            graph_mask=grow(b.graph_mask, G, 0.0),
            weight=grow(b.weight, G, 0.0),
            sample_index=grow(b.sample_index, G, -1),
            node_in_edges=node_tab, node_in_mask=node_tab_mask,
            edge_table_pos=edge_pos,
            lg_in_edges=lg_tab, lg_in_mask=lg_tab_mask, lg_table_pos=lg_pos,
            node_out_edges=node_ot, node_out_mask=node_ot_mask,
            lg_out_edges=lg_ot, lg_out_mask=lg_ot_mask,
            edge_src_order=e_order, edge_src_starts=e_starts,
            lg_src_order=l_order, lg_src_starts=l_starts,
            edge_row_ptr=e_rp, lg_row_ptr=l_rp,
            node_span_lo=nsl, bond_span_lo=bsl))
    return out


def verify_win64(batches, cfg) -> None:
    """Assert every batch's measured per-64-group row spans fit the model
    config's kernel window bounds (any attribute-bearing `cfg` with the four
    win64 fields works).

    Guards the silent-wrong-output hazard: a fused Pallas kernel whose
    `win64` VMEM window is smaller than a batch's actual 64-target edge span
    drops the tail edges without error. Eval/inference paths call this after
    packing with a fresh budget; pair with `train.loop.reconcile_win64`."""
    checks = (
        ("edge_win64", lambda b: measure_win64(np.asarray(b.edge_dst),
                                               b.nodes.shape[0])),
        ("lg_win64", lambda b: measure_win64(np.asarray(b.lg_dst),
                                             b.edge_src.shape[0])),
        ("edge_src_win64", lambda b: measure_seg_win64(
            np.asarray(b.edge_src_starts), b.edge_src.shape[0])),
        ("lg_src_win64", lambda b: measure_seg_win64(
            np.asarray(b.lg_src_starts), b.lg_src.shape[0])),
        # span-formulation bounds: same silent-drop hazard class (the span
        # kernels' one-hot gather returns zero rows for sources outside the
        # static span window); one measure_span64 pass yields both bounds
        ("edge_span64", lambda b: _span64_pair(b)[0]),
        ("lg_span64", lambda b: _span64_pair(b)[1]),
    )

    def _span64_pair(b, _cache={}):
        key = id(b)
        if key not in _cache:
            _cache.clear()   # one live batch at a time; never grows
            _cache[key] = measure_span64(
                np.asarray(b.node_graph), np.asarray(b.edge_dst),
                np.asarray(b.edge_mask), np.asarray(b.y).shape[0])
        return _cache[key]
    for i, b in enumerate(batches):
        for name, fn in checks:
            bound = int(getattr(cfg, name, 0) or 0)
            if not bound:
                continue
            got = fn(b)
            if got > bound:
                raise ValueError(
                    f"Batch {i}: measured {name} span {got} exceeds the "
                    f"active kernel window bound {bound}; the fused kernels "
                    f"would silently drop edges. Re-pack with a budget whose "
                    f"bounds cover this data, or reconcile the model config "
                    f"via train.loop.reconcile_win64.")


def epoch_batches(store: GraphStore, indices: Sequence[int], budget: BatchBudget,
                  *, shuffle: bool, rng: Optional[np.random.Generator] = None,
                  weights: Optional[np.ndarray] = None,
                  workers: Optional[int] = None) -> List[GraphBatch]:
    """Materialize one epoch's batches (optionally shuffled).

    `workers` > 1 assembles batches on a thread pool (GNNEP_PACK_WORKERS
    sets the default; host packing otherwise caps device throughput on fast
    chips — see PERF.md). Deterministic for fixed inputs; differs from the
    serial packer only in where dilution-deferred graphs land (epoch tail)."""
    order = np.asarray(list(indices), dtype=np.int64)
    if shuffle:
        if rng is None:
            rng = np.random.default_rng()
        order = order[rng.permutation(order.size)]
    packer = BatchPacker(store, budget)
    if workers is None:
        workers = int(os.environ.get("GNNEP_PACK_WORKERS", "0"))
    if workers > 1 and order.size > 1:
        return packer.pack_parallel(order, weights=weights, workers=workers)
    return list(packer.pack(order, weights=weights))
