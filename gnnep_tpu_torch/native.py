"""ctypes loader for the native host graph library (the port's own copy of
`gnnep_tpu.native`: the featurizer's neighbor list and line graph, and the
batch assembly).

Compiles `csrc/host/graphops.cpp` (the JAX package's `native/graphops.cpp`,
code unchanged) on first use, cached as
`build/host/libgraphops-<hash>.so` inside this package, and exposes typed
wrappers with transparent fallback to the pure-Python implementations when no
C++ toolchain is available. Numerics are bit-identical to the Python path, so
the port packs array-equal batches (tests/test_torch_data.py) and
featurizes array-equal graphs (tests/test_torch_featurize.py).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parent
_SRC = _ROOT / "csrc" / "host" / "graphops.cpp"
_BUILD = _ROOT / "build" / "host"

_lib: Optional[ctypes.CDLL] = None
_lib_failed = False

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        if not _SRC.exists():
            raise FileNotFoundError(_SRC)
        tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
        so = _BUILD / f"libgraphops-{tag}.so"
        if not so.exists():
            _BUILD.mkdir(parents=True, exist_ok=True)
            # per-process temporary: concurrent first builds (test workers)
            # must not interleave writes into one file before the rename
            tmp = so.with_suffix(f".so.{os.getpid()}.tmp")
            subprocess.run(
                ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
                 "-fPIC", str(_SRC), "-o", str(tmp)],
                check=True, capture_output=True, timeout=300)
            tmp.rename(so)
        lib = ctypes.CDLL(str(so))
        lib.build_line_graph.restype = ctypes.c_int64
        lib.build_line_graph.argtypes = [
            ctypes.c_int64, _i32p, _i32p, _i32p, _f64p, ctypes.c_int64,
            _f64p, ctypes.c_int32, ctypes.c_double,
            ctypes.c_int64, _i32p, _i32p, _f32p, _f64p]
        lib.cutoff_neighbors.restype = ctypes.c_int64
        lib.cutoff_neighbors.argtypes = [
            ctypes.c_int64, _f64p, _f64p, ctypes.c_double, _i32p,
            ctypes.c_int64, _i32p, _i32p, _i32p, _f64p, _f64p]
        lib.plan_dilution.restype = ctypes.c_int64
        lib.plan_dilution.argtypes = [
            ctypes.c_int64, _i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, _i64p]
        lib.assemble_arenas.restype = None
        lib.assemble_arenas.argtypes = [
            ctypes.c_int64, _i64p, _i64p, _i64p, _i64p,
            _f32p, _i32p, _i32p, _f32p, _i32p, _i32p, _f32p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            _f32p, _i32p, _i32p, _i32p, _f32p, _f32p,
            _i32p, _i32p, _f32p, _f32p]
        lib.build_batch_tables.restype = ctypes.c_int64
        lib.build_batch_tables.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            _i32p, _i32p, _f32p, _i32p, _i32p, _f32p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            _i32p, _f32p, _i32p, _i32p, _f32p, _i32p,
            _i32p, _f32p, _i32p, _f32p,
            _i32p, _i32p, _i32p, _i32p, _i32p, _i32p]
        _lib = lib
    except Exception:
        _lib_failed = True
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def build_line_graph_native(
    edge_src: np.ndarray, edge_dst: np.ndarray, jimages: np.ndarray,
    dirs: np.ndarray, n_nodes: int, angle_centers: np.ndarray,
    angle_gamma: float,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """(lg_src, lg_dst, lg_feat[f32], angles[f64]) or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    e = int(edge_src.shape[0])
    src = np.ascontiguousarray(edge_src, np.int32)
    dst = np.ascontiguousarray(edge_dst, np.int32)
    jim = np.ascontiguousarray(jimages, np.int32).reshape(e, 3)
    dvec = np.ascontiguousarray(dirs, np.float64).reshape(e, 3)
    centers = np.ascontiguousarray(angle_centers, np.float64)
    n_centers = centers.shape[0]
    feat_dim = n_centers + 3
    cap = max(e * 16, 64)
    while True:
        lg_src = np.empty(cap, np.int32)
        lg_dst = np.empty(cap, np.int32)
        lg_feat = np.empty((cap, feat_dim), np.float32)
        angles = np.empty(cap, np.float64)
        need = lib.build_line_graph(
            e, src, dst, jim, dvec, int(n_nodes), centers, n_centers,
            float(angle_gamma), cap, lg_src, lg_dst, lg_feat, angles)
        if need <= cap:
            return (lg_src[:need].copy(), lg_dst[:need].copy(),
                    lg_feat[:need].copy(), angles[:need].copy())
        cap = int(need)


def cutoff_neighbors_native(
    frac: np.ndarray, lattice: np.ndarray, cutoff: float, reps: List[int],
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """(src, dst, images, dists, dirs) or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = int(frac.shape[0])
    frac_c = np.ascontiguousarray(frac, np.float64).reshape(n, 3)
    lat_c = np.ascontiguousarray(lattice, np.float64).reshape(3, 3)
    reps_c = np.ascontiguousarray(reps, np.int32)
    cap = max(n * 64, 64)
    while True:
        src = np.empty(cap, np.int32)
        dst = np.empty(cap, np.int32)
        img = np.empty((cap, 3), np.int32)
        dist = np.empty(cap, np.float64)
        dirs = np.empty((cap, 3), np.float64)
        need = lib.cutoff_neighbors(n, frac_c, lat_c, float(cutoff), reps_c,
                                    cap, src, dst, img, dist, dirs)
        if need <= cap:
            return (src[:need].copy(), dst[:need].copy(), img[:need].copy(),
                    dist[:need].copy(), dirs[:need].copy())
        cap = int(need)


def _store_columns(store):
    """Canonicalize the store's columns for the C ABI exactly once per store.

    A per-batch `np.ascontiguousarray` over entire columns silently copies
    the whole dataset on every call if any column deviates from the
    canonical dtype/contiguity (e.g. int64 edge indices, a non-contiguous
    view) — which can make the native path slower than the Python slicing
    it replaces. The canonical tuple is cached on the store instance; cheap
    identity checks keep the fast path allocation-free."""
    cached = getattr(store, "_native_cols", None)
    if cached is not None:
        return cached
    cols = (np.ascontiguousarray(store.node_off, np.int64),
            np.ascontiguousarray(store.edge_off, np.int64),
            np.ascontiguousarray(store.lg_off, np.int64),
            np.ascontiguousarray(store.node_feats, np.float32),
            np.ascontiguousarray(store.edge_src, np.int32),
            np.ascontiguousarray(store.edge_dst, np.int32),
            np.ascontiguousarray(store.edge_attr, np.float32),
            np.ascontiguousarray(store.lg_src, np.int32),
            np.ascontiguousarray(store.lg_dst, np.int32),
            np.ascontiguousarray(store.lg_attr, np.float32))
    try:
        store._native_cols = cols
    except AttributeError:  # slotted/frozen store: recompute per call
        pass
    return cols


def assemble_arenas_native(store, graph_ids, Np: int, Ep: int, Lp: int,
                           graph_pad: int):
    """Fill the padded batch arenas from the columnar store in one
    GIL-released pass (see graphops.cpp:assemble_arenas). Returns the
    10-tuple (nodes, node_graph, edge_src, edge_dst, edge_attr, edge_mask,
    lg_src, lg_dst, lg_attr, lg_mask) or None when the library is
    unavailable. Requires the store's canonical (dst-sorted) layout — the
    caller's sortedness check still guards the assembled arenas."""
    lib = _load()
    if lib is None:
        return None
    ids = np.ascontiguousarray(graph_ids, np.int64)
    (node_off, edge_off, lg_off, node_feats, s_edge_src, s_edge_dst,
     s_edge_attr, s_lg_src, s_lg_dst, s_lg_attr) = _store_columns(store)
    # fail-loud parity with the Python path: an out-of-budget graph_ids list
    # must fall back to the raising numpy assembly, not memcpy past the
    # caller-allocated arenas
    if (int(np.sum(node_off[ids + 1] - node_off[ids])) > Np
            or int(np.sum(edge_off[ids + 1] - edge_off[ids])) > Ep
            or int(np.sum(lg_off[ids + 1] - lg_off[ids])) > Lp):
        return None
    f_node = int(node_feats.shape[1])
    f_edge = int(s_edge_attr.shape[1])
    f_angle = int(s_lg_attr.shape[1])
    nodes = np.empty((Np, f_node), np.float32)
    node_graph = np.empty(Np, np.int32)
    edge_src = np.empty(Ep, np.int32)
    edge_dst = np.empty(Ep, np.int32)
    edge_attr = np.empty((Ep, f_edge), np.float32)
    edge_mask = np.empty(Ep, np.float32)
    lg_src = np.empty(Lp, np.int32)
    lg_dst = np.empty(Lp, np.int32)
    lg_attr = np.empty((Lp, f_angle), np.float32)
    lg_mask = np.empty(Lp, np.float32)
    lib.assemble_arenas(
        ids.shape[0], ids, node_off, edge_off, lg_off,
        node_feats, s_edge_src, s_edge_dst, s_edge_attr,
        s_lg_src, s_lg_dst, s_lg_attr,
        f_node, f_edge, f_angle, int(Np), int(Ep), int(Lp), int(graph_pad),
        nodes, node_graph, edge_src, edge_dst, edge_attr, edge_mask,
        lg_src, lg_dst, lg_attr, lg_mask)
    return (nodes, node_graph, edge_src, edge_dst, edge_attr, edge_mask,
            lg_src, lg_dst, lg_attr, lg_mask)


def build_batch_tables_native(
    edge_src: np.ndarray, edge_dst: np.ndarray, edge_mask: np.ndarray,
    lg_src: np.ndarray, lg_dst: np.ndarray, lg_mask: np.ndarray,
    n_nodes: int, cap_in_a: int, cap_in_l: int, cap_out_a: int,
    cap_out_l: int):
    """Whole-batch table builder (see graphops.cpp:build_batch_tables).

    Returns the 16-tuple (node_tab, node_tab_mask, edge_pos, lg_tab,
    lg_tab_mask, lg_pos, node_ot, node_ot_mask, lg_ot, lg_ot_mask, e_order,
    e_starts, l_order, l_starts, e_rp, l_rp), or None when the library is
    unavailable or a dense-table capacity overflows (caller falls back to
    the Python path, which raises the full diagnostic)."""
    lib = _load()
    if lib is None:
        return None
    Np = int(n_nodes)
    Ep, Lp = int(edge_src.shape[0]), int(lg_src.shape[0])
    es = np.ascontiguousarray(edge_src, np.int32)
    ed = np.ascontiguousarray(edge_dst, np.int32)
    em = np.ascontiguousarray(edge_mask, np.float32)
    ls = np.ascontiguousarray(lg_src, np.int32)
    ld = np.ascontiguousarray(lg_dst, np.int32)
    lm = np.ascontiguousarray(lg_mask, np.float32)
    node_tab = np.empty((Np, cap_in_a), np.int32)
    node_tab_mask = np.empty((Np, cap_in_a), np.float32)
    edge_pos = np.empty(Ep, np.int32)
    lg_tab = np.empty((Ep, cap_in_l), np.int32)
    lg_tab_mask = np.empty((Ep, cap_in_l), np.float32)
    lg_pos = np.empty(Lp, np.int32)
    node_ot = np.empty((Np, cap_out_a), np.int32)
    node_ot_mask = np.empty((Np, cap_out_a), np.float32)
    lg_ot = np.empty((Ep, cap_out_l), np.int32)
    lg_ot_mask = np.empty((Ep, cap_out_l), np.float32)
    e_order = np.empty(Ep, np.int32)
    e_starts = np.empty(Np, np.int32)
    l_order = np.empty(Lp, np.int32)
    l_starts = np.empty(Ep, np.int32)
    e_rp = np.empty(Np + 1, np.int32)
    l_rp = np.empty(Ep + 1, np.int32)
    rc = lib.build_batch_tables(
        Np, Ep, Lp, es, ed, em, ls, ld, lm,
        int(cap_in_a), int(cap_in_l), int(cap_out_a), int(cap_out_l),
        node_tab, node_tab_mask, edge_pos, lg_tab, lg_tab_mask, lg_pos,
        node_ot, node_ot_mask, lg_ot, lg_ot_mask,
        e_order, e_starts, l_order, l_starts, e_rp, l_rp)
    if rc != 0:
        return None
    return (node_tab, node_tab_mask, edge_pos, lg_tab, lg_tab_mask, lg_pos,
            node_ot, node_ot_mask, lg_ot, lg_ot_mask,
            e_order, e_starts, l_order, l_starts, e_rp, l_rp)


def plan_dilution_native(counts: np.ndarray, bound: int, cap_rows: int,
                         group: int = 64):
    """Native batch-packer dilution planner; returns the new-position array,
    None if the bound cannot be met (overflow), or NotImplemented when the
    library is unavailable (caller falls back to the Python loop)."""
    lib = _load()
    if lib is None:
        return NotImplemented
    c = np.ascontiguousarray(counts, np.int64)
    new_pos = np.empty(c.shape[0], np.int64)
    rc = lib.plan_dilution(c.shape[0], c, int(bound), int(cap_rows),
                           int(group), new_pos)
    return None if rc < 0 else new_pos
