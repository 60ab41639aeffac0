"""ALIGNN-style graph featurization → flat numpy arrays (the port's own copy
of `gnnep_tpu.data.featurize`; the same arrays, held equal by
`tests/test_torch_featurize.py`).

Reimplements the featurization semantics of the reference
(reference `fetch.py:319-611`) — CGCNN-style RBF bond features,
ALIGNN line-graph angle features keyed by periodic bond identity
`(i, j, jimage)`, and the 59 global structure descriptors — but emits columnar
numpy arrays (COO edge lists + feature matrices) instead of PyG objects, so
downstream batching can pack them into fixed-shape batches.

Feature dimensions (verified against the reference's shipped scaler state):
    node  = 6 element scalars (+ mat2vec, typically 200)  → 206
    edge  = rbf_n (32) + |ΔEN| + unit direction (3)        → 36
    angle = angle_n (8) + (θ, cos θ, sin θ)                → 11
    global= 6 metric + vol/atom + density + 51 structural  → 59
    plus a 230-way space-group one-hot carried as an integer index.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..elements import element_props
from .neighbors import find_edges
from .structure import Structure

N_SG = 230  # space groups
N_GLOBAL_SCALARS = 59


@dataclasses.dataclass(frozen=True)
class BasisConfig:
    """Radial / angular expansion settings (reference defaults, fetch.py:846-851)."""

    rbf_n: int = 32
    rbf_cutoff: float = 8.0
    rbf_gamma: Optional[float] = None  # None → 1/spacing² (fetch.py:703-706)
    angle_n: int = 8

    @property
    def rbf_centers(self) -> np.ndarray:
        return np.linspace(0.0, self.rbf_cutoff, self.rbf_n)

    @property
    def rbf_gamma_value(self) -> float:
        if self.rbf_gamma is not None:
            return float(self.rbf_gamma)
        spacing = self.rbf_cutoff / max(1, self.rbf_n - 1)
        return float(1.0 / (spacing + 1e-8) ** 2)

    @property
    def angle_centers(self) -> np.ndarray:
        return np.linspace(0.0, math.pi, self.angle_n)

    @property
    def angle_gamma_value(self) -> float:
        return float((self.angle_n - 1) / (math.pi + 1e-8)) ** 2

    @property
    def edge_dim(self) -> int:
        return self.rbf_n + 4

    @property
    def angle_dim(self) -> int:
        return self.angle_n + 3


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

    def sg_one_hot(self) -> np.ndarray:
        out = np.zeros(N_SG, dtype=np.float32)
        if 1 <= self.sg_num <= N_SG:
            out[self.sg_num - 1] = 1.0
        return out

    def group_key(self) -> str:
        """Leakage-safe split group: '{prototype}|{reduced_formula}' (train.py:1303-1309)."""
        reduced = self.reduced_formula or self.formula
        if reduced:
            return f"{self.prototype}|{reduced}"
        return self.material_id


def load_mat2vec(path: Optional[str]) -> Dict[str, np.ndarray]:
    """Load element→embedding lookup from JSON (symbol → list[float]) or NPZ."""
    if not path:
        return {}
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"mat2vec embedding file not found: {p}")
    if p.suffix == ".npz":
        data = np.load(p, allow_pickle=False)
        symbols = [str(s) for s in data["symbols"]]
        matrix = np.asarray(data["vectors"], dtype=np.float64)
        return {s: matrix[i] for i, s in enumerate(symbols)}
    with p.open("r", encoding="utf-8") as fh:
        raw = json.load(fh)
    if not raw:
        raise ValueError(f"mat2vec embedding file {p} is empty")
    return {k: np.asarray(v, dtype=np.float64) for k, v in raw.items()}


def _mat2vec_for(symbol: str, lookup: Dict[str, np.ndarray], dim: int) -> np.ndarray:
    """Case-variant fallback then zero vector (fetch.py:352-358)."""
    emb = lookup.get(symbol)
    if emb is None and symbol.capitalize() != symbol:
        emb = lookup.get(symbol.capitalize())
    if emb is None and symbol.lower() != symbol:
        emb = lookup.get(symbol.lower())
    if emb is None:
        emb = np.zeros(dim, dtype=np.float64)
    return emb


def _edge_geometry(structure: Structure, i: int, j: int,
                   jimage: Tuple[int, int, int]) -> Tuple[float, np.ndarray]:
    """Distance and unit direction i→j through the given periodic image."""
    dfrac = (structure.frac_coords[j] + np.asarray(jimage, dtype=np.float64)
             - structure.frac_coords[i])
    vec = dfrac @ structure.lattice.matrix
    dist = float(np.linalg.norm(vec))
    if dist > 0:
        return dist, vec / dist
    return dist, np.zeros(3)


def spacegroup_number(structure: Structure, symprec: float = 1e-2) -> int:
    """Space-group number via pymatgen/spglib when available, else 0."""
    try:
        from pymatgen.core import Lattice as PmgLattice, Structure as PmgStructure  # type: ignore
        from pymatgen.symmetry.analyzer import SpacegroupAnalyzer  # type: ignore

        pmg = PmgStructure(PmgLattice(structure.lattice.matrix), structure.species,
                           structure.frac_coords)
        return int(SpacegroupAnalyzer(pmg, symprec=symprec).get_space_group_number())
    except Exception:
        return 0


def build_graph(
    structure: Structure,
    *,
    material_id: str = "unknown",
    formula: str = "",
    y: Optional[np.ndarray] = None,
    basis: BasisConfig = BasisConfig(),
    nn_method: str = "crystalnn",
    cutoff: float = 5.0,
    fallback_cutoff: float = 7.5,
    mat2vec: Optional[Dict[str, np.ndarray]] = None,
    guess_oxidation: bool = True,
    sg_num: Optional[int] = None,
    reduced_formula: Optional[str] = None,
    prototype: Optional[str] = None,
) -> GraphSample:
    """Featurize one structure into a `GraphSample`.

    Semantics track reference `build_graph_from_structure` (fetch.py:319-611):
    directed bonds with periodic-image identity, RBF+ΔEN+direction edge
    features, line-graph angles at the shared atom with exact-backtrack
    skipping, and the 59 global structure descriptors in reference order.
    """
    n = len(structure)
    lookup = mat2vec or {}
    m2v_dim = len(next(iter(lookup.values()))) if lookup else 0

    # ---- node features ---------------------------------------------------
    node_rows: List[np.ndarray] = []
    en_list: List[float] = []
    for sym in structure.species:
        p = element_props(sym)
        base = np.array([p.z, p.group, p.period, p.en, p.mass, p.radius], dtype=np.float64)
        if m2v_dim:
            core = "".join(ch for ch in sym if ch.isalpha())
            base = np.concatenate([base, _mat2vec_for(core, lookup, m2v_dim)])
        node_rows.append(base)
        en_list.append(p.en)
    node_feats = (np.stack(node_rows) if node_rows
                  else np.zeros((0, 6 + m2v_dim)))

    # ---- bonds (vectorized edge geometry) --------------------------------
    edges, used_method = find_edges(structure, nn_method, cutoff,
                                    fallback_cutoff, guess_oxidation)
    n_e = len(edges)
    src_arr = np.fromiter((e[0] for e in edges), np.int32, n_e)
    dst_arr = np.fromiter((e[1] for e in edges), np.int32, n_e)
    im_arr = (np.array([e[2] for e in edges], dtype=np.int32).reshape(n_e, 3)
              if n_e else np.zeros((0, 3), np.int32))
    fr = structure.frac_coords
    vec = ((fr[dst_arr] + im_arr - fr[src_arr]) @ structure.lattice.matrix
           if n_e else np.zeros((0, 3)))
    dist = np.linalg.norm(vec, axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        dirs = np.where(dist[:, None] > 0, vec / np.where(dist[:, None] > 0,
                                                          dist[:, None], 1.0), 0.0)

    rbf_centers = basis.rbf_centers
    rbf_gamma = basis.rbf_gamma_value
    en_arr = np.asarray(en_list, dtype=np.float64) if n else np.zeros(0)
    e_attr_mat = np.concatenate([
        np.exp(-rbf_gamma * (dist[:, None] - rbf_centers[None, :]) ** 2),
        np.abs(en_arr[src_arr] - en_arr[dst_arr])[:, None] if n_e else
        np.zeros((0, 1)),
        dirs,
    ], axis=1) if n_e else np.zeros((0, basis.edge_dim))

    per_atom_lengths: List[List[float]] = [[] for _ in range(n)]
    coord_sets: List[set] = [set() for _ in range(n)]
    unique_bonds: set = set()
    for idx in range(n_e):
        i, j = int(src_arr[idx]), int(dst_arr[idx])
        d = float(dist[idx])
        per_atom_lengths[i].append(d)
        per_atom_lengths[j].append(d)
        coord_sets[i].add(j)
        coord_sets[j].add(i)
        unique_bonds.add((min(i, j), max(i, j)))
    dir_abs = [np.abs(dirs[idx]) for idx in range(n_e)]
    bond_lengths = dist.tolist()

    # ---- line graph (angles at the shared atom) --------------------------
    angle_centers = basis.angle_centers
    angle_gamma = basis.angle_gamma_value
    native_lg = None
    if n_e:
        from .. import native as _native

        native_lg = _native.build_line_graph_native(
            src_arr, dst_arr, im_arr, dirs, n, angle_centers, angle_gamma)
    if native_lg is not None:
        lg_src_arr, lg_dst_arr, lg_attr_mat, angles_arr = native_lg
        bond_angles = angles_arr.tolist()
    else:
        lg_src_arr, lg_dst_arr, lg_attr_mat, bond_angles = _line_graph_python(
            edges, src_arr, dst_arr, im_arr, dirs, angle_centers, angle_gamma)

    # ---- global scalars (reference order, fetch.py:132-156 + 448-569) ----
    g = _global_scalars(structure, coord_sets, bond_lengths, per_atom_lengths,
                        dir_abs, bond_angles, unique_bonds)

    sg = spacegroup_number(structure) if sg_num is None else int(sg_num)

    reduced = reduced_formula if reduced_formula is not None else structure.reduced_formula() if n else ""
    # reference prototype cascade (fetch.py:159-186): StructureMatcher
    # get_structure_type when pymatgen exposes it, else anonymized formula
    proto = prototype if prototype is not None else (structure.prototype_label() if n else "")

    return GraphSample(
        material_id=str(material_id),
        formula=str(formula or reduced),
        reduced_formula=str(reduced),
        prototype=str(proto),
        node_feats=node_feats.astype(np.float32),
        edge_src=src_arr,
        edge_dst=dst_arr,
        edge_attr=e_attr_mat.astype(np.float32),
        lg_src=np.asarray(lg_src_arr, dtype=np.int32),
        lg_dst=np.asarray(lg_dst_arr, dtype=np.int32),
        lg_attr=np.asarray(lg_attr_mat, dtype=np.float32).reshape(-1, basis.angle_dim),
        global_scalars=g.astype(np.float32),
        sg_num=sg,
        y=None if y is None else np.asarray(y, dtype=np.float32).reshape(-1),
        neighbor_method=used_method,
    )


def _line_graph_python(edges, src_arr, dst_arr, im_arr, dirs,
                       angle_centers: np.ndarray, angle_gamma: float):
    """Pure-Python line-graph fallback (used when the native library is
    unavailable); numerics identical to fetch.py:417-447."""
    n_e = len(edges)
    neigh_of: Dict[int, List[int]] = {}
    for idx in range(n_e):
        neigh_of.setdefault(int(src_arr[idx]), []).append(idx)
    bond_of: Dict[Tuple[int, int, Tuple[int, int, int]], int] = {}
    for idx, (i, j, im) in enumerate(edges):
        bond_of[(i, j, im)] = idx
    l_src: List[int] = []
    l_dst: List[int] = []
    l_attr: List[np.ndarray] = []
    angles: List[float] = []
    for e1, (i, j, im) in enumerate(edges):
        rev = (-im[0], -im[1], -im[2])
        u = -dirs[e1]          # d(j→i) through the exact reverse image
        nu = float(np.linalg.norm(u))
        b1 = bond_of.get((i, j, im))
        for e2 in neigh_of.get(j, []):
            k = int(dst_arr[e2])
            km = (int(im_arr[e2, 0]), int(im_arr[e2, 1]), int(im_arr[e2, 2]))
            if k == i and km == rev:  # exact backtrack i→j→i
                continue
            b2 = bond_of.get((j, k, km))
            if b1 is None or b2 is None:
                continue
            v = dirs[e2]
            nv = float(np.linalg.norm(v))
            if nu == 0 or nv == 0:
                theta = 0.0
            else:
                theta = float(math.acos(float(np.clip(np.dot(u, v) / (nu * nv),
                                                      -1.0, 1.0))))
            l_src.append(b1)
            l_dst.append(b2)
            l_attr.append(np.concatenate([
                np.exp(-angle_gamma * (theta - angle_centers) ** 2),
                [theta, math.cos(theta), math.sin(theta)]]))
            angles.append(theta)
    attr = (np.stack(l_attr) if l_attr
            else np.zeros((0, angle_centers.shape[0] + 3)))
    return (np.asarray(l_src, np.int32), np.asarray(l_dst, np.int32),
            attr.astype(np.float32), angles)


def _global_scalars(structure: Structure, coord_sets, bond_lengths,
                    per_atom_lengths, dir_abs, bond_angles, unique_bonds) -> np.ndarray:
    """The 59 global descriptors in the reference's exact order."""
    lat = structure.lattice
    n = len(structure)
    out: List[float] = []

    # metric tensor (6), vol/atom, density  — fetch.py:132-156
    ga, gb, gc = math.radians(lat.gamma), math.radians(lat.beta), math.radians(lat.alpha)
    out += [lat.a ** 2, lat.b ** 2, lat.c ** 2,
            lat.a * lat.b * math.cos(ga),
            lat.a * lat.c * math.cos(gb),
            lat.b * lat.c * math.cos(gc),
            structure.volume / max(1, n), structure.density]

    # coordination-number histogram (13 bins: 0..11, 12+) + 4 moments
    max_cn = 12
    cns = np.array([len(s) for s in coord_sets], dtype=np.float64)
    hist = np.zeros(max_cn + 1)
    if cns.size:
        for cn in cns.astype(int):
            hist[min(cn, max_cn)] += 1.0
        hist /= n
        out += hist.tolist() + [cns.mean(), cns.std(), cns.min(), cns.max()]
    else:
        out += hist.tolist() + [0.0] * 4

    # bond-length stats (6)
    bl = np.asarray(bond_lengths, dtype=np.float64)
    if bl.size:
        out += [bl.mean(), bl.std(), bl.min(), bl.max(),
                bl.max() / max(bl.min(), 1e-8),
                float(np.percentile(bl, 90) - np.percentile(bl, 10))]
    else:
        out += [0.0] * 6

    # per-atom min/max/gap stats (8)
    mins = [min(ls) for ls in per_atom_lengths if ls]
    maxs = [max(ls) for ls in per_atom_lengths if ls]
    gaps, gap_ratios = [], []
    for ls in per_atom_lengths:
        if len(ls) >= 2:
            s = sorted(ls)
            gaps.append(s[-1] - s[0])
            gap_ratios.append(s[-1] / max(s[0], 1e-8))
    out += ([np.mean(mins), np.std(mins)] if mins else [0.0, 0.0])
    out += ([np.mean(maxs)] if maxs else [0.0])
    out += ([np.mean(gaps), np.std(gaps), np.max(gaps)] if gaps else [0.0] * 3)
    out += ([np.mean(gap_ratios), np.std(gap_ratios)] if gap_ratios else [0.0, 0.0])

    # angle stats (5): mean/std/min/max + planarity deviation from 120°
    ang = np.asarray(bond_angles, dtype=np.float64)
    if ang.size:
        out += [ang.mean(), ang.std(), ang.min(), ang.max(),
                float(np.mean(np.abs(ang - 2 * math.pi / 3)))]
    else:
        out += [0.0] * 5

    # edge density + unique bond count (2)
    ub = len(unique_bonds)
    out += [(2.0 * ub) / (n * (n - 1)) if n > 1 else 0.0, float(ub)]

    # |direction| stats (10)
    if dir_abs:
        da = np.stack(dir_abs)
        out += da.mean(axis=0).tolist() + da.std(axis=0).tolist()
        out += [float(np.mean(da[:, 0] > 0.8)), float(np.mean(da[:, 1] > 0.8)),
                float(np.mean(da[:, 2] > 0.8)), float(np.mean(da[:, 2] < 0.3))]
    else:
        out += [0.0] * 10

    # lattice ratios (3)
    out += [lat.a / max(lat.b, 1e-8), lat.a / max(lat.c, 1e-8), lat.b / max(lat.c, 1e-8)]

    arr = np.asarray(out, dtype=np.float64)
    assert arr.shape == (N_GLOBAL_SCALARS,), f"global scalars: {arr.shape}"
    return arr
