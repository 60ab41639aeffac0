"""Seeded synthetic crystals with Materials-Project-like statistics.

Graphs for the chip smoke run and the tests, without featurization: Poisson
atom counts, about `degree` incoming bonds per atom, and a real line graph
(bond a = k→i feeds bond b = i→j, the ALIGNN angle triplets), so a batch of
64 graphs holds about 7k bonds and 60k line-graph edges. Feature widths are
the flagship's: node 206, edge 36, angle 11, global 59.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..data.featurize import GraphSample
from ..models.alignn import AlignnConfig

NODE_DIM, EDGE_DIM, ANGLE_DIM, GLOBAL_DIM = 206, 36, 11, 59


def synthetic_graph(rng: np.random.Generator, material_id: str, *,
                    mean_atoms: int = 10, degree: int = 10,
                    node_dim: int = NODE_DIM, edge_dim: int = EDGE_DIM,
                    angle_dim: int = ANGLE_DIM, global_dim: int = GLOBAL_DIM,
                    target_dim: int = 2) -> GraphSample:
    n = max(2, int(rng.poisson(mean_atoms)))
    in_deg = np.maximum(rng.poisson(degree, n), 1)
    dst = np.repeat(np.arange(n), in_deg)
    src = (dst + rng.integers(1, n, dst.size)) % n      # no self-loops
    rp = np.concatenate([[0], np.cumsum(in_deg)])
    # line graph: every bond into atom src[b] feeds bond b
    counts = in_deg[src]
    lg_dst = np.repeat(np.arange(dst.size), counts)
    within = np.arange(lg_dst.size) - np.repeat(np.cumsum(counts) - counts,
                                                counts)
    lg_src = rp[src][lg_dst] + within

    def feats(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return GraphSample(
        material_id=material_id, formula="", reduced_formula="",
        prototype="", node_feats=feats(n, node_dim),
        edge_src=src.astype(np.int32), edge_dst=dst.astype(np.int32),
        edge_attr=feats(dst.size, edge_dim),
        lg_src=lg_src.astype(np.int32), lg_dst=lg_dst.astype(np.int32),
        lg_attr=feats(lg_dst.size, angle_dim),
        global_scalars=feats(global_dim), sg_num=int(rng.integers(1, 231)),
        y=np.exp(rng.normal(4.0, 0.9, target_dim)).astype(np.float32))


def synthetic_samples(rng: np.random.Generator, n_graphs: int, **kw
                      ) -> List[GraphSample]:
    return [synthetic_graph(rng, f"synth-{i:05d}", **kw)
            for i in range(n_graphs)]


def flagship_config(**kw) -> AlignnConfig:
    """The reference-default flagship architecture: hidden 256, 4 layers,
    4 heads, at the flagship feature widths."""
    base = dict(node_dim=NODE_DIM, edge_dim=EDGE_DIM, angle_dim=ANGLE_DIM,
                global_dim=GLOBAL_DIM + 230, target_dim=2, hidden=256,
                layers=4, heads=4, dropout=0.15, conv_impl="fused")
    base.update(kw)
    return AlignnConfig(**base)
