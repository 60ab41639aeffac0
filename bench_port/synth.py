"""Seeded synthetic crystal graphs, the benchmark's own frozen generator.

Graph topology follows the statistics of the port's `utils/synth.py` (MP-like:
Poisson atom counts, Poisson in-degree per atom, no self-loops) with one more
knob: each graph draws its mean in-degree uniformly from `degree` = [lo, hi],
which with [28, 56] gives the 5 Å fixed-radius graphs of the reference's
`fetch.py --nn-method cutoff`. The line graph is ALIGNN's: every bond into
atom src[b] feeds bond b. Features are standard normal (already standardized,
as a served store is), targets log-normal moduli.

The result is one columnar arena (`Graphs`), the same arrays that both the
program (as a `GraphStore`) and the plain reference read.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class Graphs:
    node_feats: np.ndarray      # [ΣN, node_dim] f32
    edge_src: np.ndarray        # [ΣE] i32, graph-local, dst-sorted per graph
    edge_dst: np.ndarray        # [ΣE] i32
    edge_attr: np.ndarray       # [ΣE, edge_dim] f32
    lg_src: np.ndarray          # [ΣL] i32, graph-local bond ids
    lg_dst: np.ndarray          # [ΣL] i32, sorted per graph
    lg_attr: np.ndarray         # [ΣL, angle_dim] f32
    node_off: np.ndarray        # [G+1] i64
    edge_off: np.ndarray        # [G+1] i64
    lg_off: np.ndarray          # [G+1] i64
    global_scalars: np.ndarray  # [G, global_scalar_dim] f32
    sg_num: np.ndarray          # [G] i32, 1..230
    y: np.ndarray               # [G, T] f32, > 0
    material_ids: List[str]

    @property
    def n_graphs(self) -> int:
        return len(self.material_ids)

    def counts(self, idx: Sequence[int]):
        """(atoms, bonds, line-graph rows) of each graph in `idx`."""
        i = np.asarray(idx, dtype=np.int64)
        return (np.diff(self.node_off)[i], np.diff(self.edge_off)[i],
                np.diff(self.lg_off)[i])


def make_graphs(seed: int, n_graphs: int, *, mean_atoms: float,
                degree: Sequence[float], node_dim: int, edge_dim: int,
                angle_dim: int, global_scalar_dim: int, target_dim: int
                ) -> Graphs:
    """`n_graphs` graphs from `seed`: topology graph by graph, features in
    one draw per array."""
    rng = np.random.default_rng(seed)
    lo, hi = float(degree[0]), float(degree[1])
    n_atoms = np.maximum(rng.poisson(mean_atoms, n_graphs), 2)
    mean_deg = rng.uniform(lo, hi, n_graphs) if hi > lo else \
        np.full(n_graphs, lo)
    srcs, dsts, lsrcs, ldsts = [], [], [], []
    n_edges = np.zeros(n_graphs, np.int64)
    n_lg = np.zeros(n_graphs, np.int64)
    for g in range(n_graphs):
        n = int(n_atoms[g])
        in_deg = np.maximum(rng.poisson(mean_deg[g], n), 1)
        dst = np.repeat(np.arange(n), in_deg)
        src = (dst + rng.integers(1, n, dst.size)) % n
        rp = np.concatenate([[0], np.cumsum(in_deg)])
        counts = in_deg[src]
        lg_dst = np.repeat(np.arange(dst.size), counts)
        within = np.arange(lg_dst.size) - np.repeat(np.cumsum(counts) - counts,
                                                    counts)
        lg_src = rp[src][lg_dst] + within
        srcs.append(src)
        dsts.append(dst)
        lsrcs.append(lg_src)
        ldsts.append(lg_dst)
        n_edges[g], n_lg[g] = dst.size, lg_dst.size

    def off(c):
        return np.concatenate([[0], np.cumsum(c)]).astype(np.int64)

    node_off, edge_off, lg_off = off(n_atoms), off(n_edges), off(n_lg)

    def feats(rows, width):
        return rng.standard_normal((int(rows), width), dtype=np.float32)

    return Graphs(
        node_feats=feats(node_off[-1], node_dim),
        edge_src=np.concatenate(srcs).astype(np.int32),
        edge_dst=np.concatenate(dsts).astype(np.int32),
        edge_attr=feats(edge_off[-1], edge_dim),
        lg_src=np.concatenate(lsrcs).astype(np.int32),
        lg_dst=np.concatenate(ldsts).astype(np.int32),
        lg_attr=feats(lg_off[-1], angle_dim),
        node_off=node_off, edge_off=edge_off, lg_off=lg_off,
        global_scalars=feats(n_graphs, global_scalar_dim),
        sg_num=rng.integers(1, 231, n_graphs).astype(np.int32),
        y=np.exp(rng.normal(4.0, 0.9, (n_graphs, target_dim))).astype(
            np.float32),
        material_ids=[f"synth-{g:05d}" for g in range(n_graphs)])
