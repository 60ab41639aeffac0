"""The graph IR of one featurized crystal (the port's own copy of the part of
`gnnep_tpu.data.featurize` that serving needs).

On-the-fly featurization of pymatgen structures (`build_graph`, the radial and
angular bases, element tables) waits for the featurization slice; see
ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

N_SG = 230  # space groups


@dataclasses.dataclass
class GraphSample:
    """One featurized crystal as flat numpy arrays (the framework's graph IR)."""

    material_id: str
    formula: str
    reduced_formula: str
    prototype: str
    node_feats: np.ndarray      # [N, F_node] float32
    edge_src: np.ndarray        # [E] int32  (bond i→j: src=i)
    edge_dst: np.ndarray        # [E] int32
    edge_attr: np.ndarray       # [E, F_edge] float32
    lg_src: np.ndarray          # [L] int32  (line-graph edge: bond→bond)
    lg_dst: np.ndarray          # [L] int32
    lg_attr: np.ndarray         # [L, F_angle] float32
    global_scalars: np.ndarray  # [59] float32
    sg_num: int                 # 1..230, 0 = unknown
    y: Optional[np.ndarray]     # [T] float32 targets (K_VRH, G_VRH) or None
    neighbor_method: str = ""

    @property
    def n_nodes(self) -> int:
        return int(self.node_feats.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.edge_src.shape[0])

    @property
    def n_lg_edges(self) -> int:
        return int(self.lg_src.shape[0])
