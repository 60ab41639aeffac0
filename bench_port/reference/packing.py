"""The trainer's batch layout, worked out again from the raw graphs.

A frozen copy of the packing rules the port applies with its window bounds
cleared (arena capacities planned over the store, greedy grouping in epoch
order, concatenation, CSR order by aggregation target).
The reference needs the layout for one reason: every dropout and jitter mask
is drawn over the padded arenas, so the same generator gives the same masks
only at the same row positions. It reads nothing the program made.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def plan_budget(graphs, indices: Sequence[int], batch_size: int,
                slack: float = 1.15) -> Dict:
    """Arena capacities (dummy slots included) planned over `indices`,
    every graph guaranteed to fit. The window bounds the trainer's budget
    also plans are cleared, as the cells run the program: no dilution, no
    deferral."""
    idx = np.asarray(list(indices), dtype=np.int64)
    n, e, l = graphs.counts(idx)

    def cap(counts: np.ndarray, mult: int) -> int:
        per = float(counts.mean()) if counts.size else 1.0
        need = int(np.ceil(batch_size * per * slack))
        need = max(int(counts.max(initial=1)), need)
        return _round_up(need + 1, mult)

    return dict(n_graphs=int(batch_size), n_nodes=cap(n, 128),
                n_edges=cap(e, 128), n_lg_edges=cap(l, 128))


def plan_groups(graphs, order: Sequence[int], budget: Dict) -> List[List[int]]:
    """Greedy partition of `order` into batches that fit the capacities."""
    groups: List[List[int]] = []
    cur: List[int] = []
    used = np.zeros(3, np.int64)
    lim = (budget["n_nodes"] - 1, budget["n_edges"] - 1, budget["n_lg_edges"])
    for raw in order:
        g = int(raw)
        c = np.array([graphs.node_off[g + 1] - graphs.node_off[g],
                      graphs.edge_off[g + 1] - graphs.edge_off[g],
                      graphs.lg_off[g + 1] - graphs.lg_off[g]])
        if cur and (len(cur) + 1 > budget["n_graphs"]
                    or any(used[i] + c[i] > lim[i] for i in range(3))):
            groups.append(cur)
            cur, used = [], np.zeros(3, np.int64)
        cur.append(g)
        used += c
    if cur:
        groups.append(cur)
    return groups


def _assemble(graphs, ids: List[int], b: Dict) -> Dict:
    Np, Ep, Lp, G = b["n_nodes"], b["n_edges"], b["n_lg_edges"], b["n_graphs"]
    a = dict(nodes=np.zeros((Np, graphs.node_feats.shape[1]), np.float32),
             node_graph=np.full(Np, G, np.int32),
             edge_src=np.full(Ep, Np - 1, np.int32),
             edge_dst=np.full(Ep, Np - 1, np.int32),
             edge_attr=np.zeros((Ep, graphs.edge_attr.shape[1]), np.float32),
             edge_mask=np.zeros(Ep, np.float32),
             lg_src=np.full(Lp, Ep - 1, np.int32),
             lg_dst=np.full(Lp, Ep - 1, np.int32),
             lg_attr=np.zeros((Lp, graphs.lg_attr.shape[1]), np.float32),
             lg_mask=np.zeros(Lp, np.float32))
    nc = ec = lc = 0
    for slot, g in enumerate(ids):
        n0, n1 = graphs.node_off[g], graphs.node_off[g + 1]
        e0, e1 = graphs.edge_off[g], graphs.edge_off[g + 1]
        l0, l1 = graphs.lg_off[g], graphs.lg_off[g + 1]
        n, e, l = int(n1 - n0), int(e1 - e0), int(l1 - l0)
        a["nodes"][nc:nc + n] = graphs.node_feats[n0:n1]
        a["node_graph"][nc:nc + n] = slot
        a["edge_src"][ec:ec + e] = graphs.edge_src[e0:e1] + nc
        a["edge_dst"][ec:ec + e] = graphs.edge_dst[e0:e1] + nc
        a["edge_attr"][ec:ec + e] = graphs.edge_attr[e0:e1]
        a["edge_mask"][ec:ec + e] = 1.0
        a["lg_src"][lc:lc + l] = graphs.lg_src[l0:l1] + ec
        a["lg_dst"][lc:lc + l] = graphs.lg_dst[l0:l1] + ec
        a["lg_attr"][lc:lc + l] = graphs.lg_attr[l0:l1]
        a["lg_mask"][lc:lc + l] = 1.0
        nc, ec, lc = nc + n, ec + e, lc + l
    # CSR order by aggregation target (stable; padding holds the largest id)
    if np.any(a["edge_dst"][1:] < a["edge_dst"][:-1]):
        perm = np.argsort(a["edge_dst"], kind="stable")
        inv = np.empty(Ep, np.int32)
        inv[perm] = np.arange(Ep, dtype=np.int32)
        for k in ("edge_src", "edge_dst", "edge_attr", "edge_mask"):
            a[k] = a[k][perm]
        a["lg_src"], a["lg_dst"] = inv[a["lg_src"]], inv[a["lg_dst"]]
    if np.any(a["lg_dst"][1:] < a["lg_dst"][:-1]):
        perm = np.argsort(a["lg_dst"], kind="stable")
        for k in ("lg_src", "lg_dst", "lg_attr", "lg_mask"):
            a[k] = a[k][perm]
    T = graphs.y.shape[1]
    a["globals_"] = np.zeros((G, graphs.global_scalars.shape[1]), np.float32)
    a["sg_num"] = np.zeros(G, np.int32)
    a["y"] = np.ones((G, T), np.float32)
    a["y_mask"] = np.zeros((G, T), np.float32)
    a["graph_mask"] = np.zeros(G, np.float32)
    a["weight"] = np.zeros(G, np.float32)
    a["sample_index"] = np.full(G, -1, np.int32)
    for slot, g in enumerate(ids):
        a["globals_"][slot] = graphs.global_scalars[g]
        a["sg_num"][slot] = graphs.sg_num[g]
        finite = np.isfinite(graphs.y[g])
        a["y"][slot] = np.where(finite, graphs.y[g], 1.0)
        a["y_mask"][slot] = finite
        a["graph_mask"][slot] = 1.0
        a["weight"][slot] = 1.0
        a["sample_index"][slot] = g
    return a


def bootstrap_order(train_indices: Sequence[int], member_seed: int,
                    ratio: float) -> np.ndarray:
    """The member's first epoch in step order: the bootstrap resample drawn
    with the member's seed, then the epoch's permutation drawn with the
    member's seed + 17."""
    base = np.asarray(list(train_indices), dtype=np.int64)
    count = max(1, int(round(len(base) * ratio)))
    effective = np.random.default_rng(member_seed).choice(base, size=count,
                                                          replace=True)
    return effective[np.random.default_rng(member_seed + 17).permutation(
        effective.size)]


def first_batches(graphs, train_indices: Sequence[int], budget: Dict,
                  member_seed: int, ratio: float, n: int) -> List[Dict]:
    """The arenas of the member's first `n` optimizer steps."""
    groups = plan_groups(graphs, bootstrap_order(train_indices, member_seed,
                                                 ratio), budget)
    return [_assemble(graphs, g, budget) for g in groups[:n]]


def real_counts(a: Dict) -> Dict[str, int]:
    """Live rows of one arena: graphs, atoms, bonds, line-graph rows."""
    return dict(graphs=int(a["graph_mask"].sum()),
                atoms=int((a["node_graph"] < a["graph_mask"].shape[0]).sum()),
                bonds=int(a["edge_mask"].sum()), lg=int(a["lg_mask"].sum()))

