"""Columnar graph store (the port's own copy of `gnnep_tpu.data.store`).

Graphs live in a single columnar arena: all node/edge/line-graph features
concatenated with per-graph offsets. One `np.load` maps the whole dataset;
batch assembly is pure slicing. The on-disk format is the JAX package's, so a
dataset written by either package loads in the other.

On-disk layout:
    <dir>/<material_id>.npz   one archive per material (resume-friendly fetch)
    <dir>/index.json          manifest (ids, counts, has_target, …)
    <dir>/_arena_cache.npz    consolidated columnar cache (auto-rebuilt)
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from .featurize import GraphSample

_SAMPLE_KEYS = ("node_feats", "edge_src", "edge_dst", "edge_attr",
                "lg_src", "lg_dst", "lg_attr", "global_scalars")


def save_sample(directory: str | Path, sample: GraphSample) -> Path:
    """Write one material as an .npz archive (id sanitized as in fetch.py:735)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"{sample.material_id.replace('/', '_')}.npz"
    payload = {k: getattr(sample, k) for k in _SAMPLE_KEYS}
    payload["sg_num"] = np.int32(sample.sg_num)
    payload["y"] = (np.asarray([], dtype=np.float32) if sample.y is None else sample.y)
    payload["meta"] = np.array(json.dumps({
        "material_id": sample.material_id,
        "formula": sample.formula,
        "reduced_formula": sample.reduced_formula,
        "prototype": sample.prototype,
        "neighbor_method": sample.neighbor_method,
    }))
    np.savez_compressed(path, **payload)
    return path


def load_sample(path: str | Path) -> GraphSample:
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["meta"]))
        y = data["y"]
        return GraphSample(
            material_id=meta["material_id"],
            formula=meta["formula"],
            reduced_formula=meta["reduced_formula"],
            prototype=meta["prototype"],
            node_feats=data["node_feats"],
            edge_src=data["edge_src"], edge_dst=data["edge_dst"],
            edge_attr=data["edge_attr"],
            lg_src=data["lg_src"], lg_dst=data["lg_dst"], lg_attr=data["lg_attr"],
            global_scalars=data["global_scalars"],
            sg_num=int(data["sg_num"]),
            y=None if y.size == 0 else y,
            neighbor_method=meta["neighbor_method"],
        )


def _canonical_sample(s: GraphSample) -> GraphSample:
    """Sort a graph's bond arrays by dst atom and its line-graph arrays by
    dst bond (stable), remapping LG bond references. Idempotent."""
    e_sorted = bool(np.all(s.edge_dst[1:] >= s.edge_dst[:-1]))
    l_sorted = bool(np.all(s.lg_dst[1:] >= s.lg_dst[:-1]))
    if e_sorted and l_sorted:
        return s
    lg_src, lg_dst, lg_attr = s.lg_src, s.lg_dst, s.lg_attr
    edge_src, edge_dst, edge_attr = s.edge_src, s.edge_dst, s.edge_attr
    if not e_sorted:
        perm = np.argsort(edge_dst, kind="stable")
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size)
        edge_src = edge_src[perm]
        edge_dst = edge_dst[perm]
        edge_attr = edge_attr[perm]
        lg_src = inv[lg_src].astype(np.int32)
        lg_dst = inv[lg_dst].astype(np.int32)
        l_sorted = bool(np.all(lg_dst[1:] >= lg_dst[:-1]))
    if not l_sorted:
        lperm = np.argsort(lg_dst, kind="stable")
        lg_src = lg_src[lperm]
        lg_dst = lg_dst[lperm]
        lg_attr = lg_attr[lperm]
    return dataclasses.replace(s, edge_src=edge_src, edge_dst=edge_dst,
                               edge_attr=edge_attr, lg_src=lg_src,
                               lg_dst=lg_dst, lg_attr=lg_attr)


@dataclasses.dataclass
class GraphStore:
    """All graphs of a dataset as one columnar arena.

    Per-graph row `g` spans nodes `node_off[g]:node_off[g+1]`, edges
    `edge_off[g]:edge_off[g+1]`, line-graph edges `lg_off[g]:lg_off[g+1]`.
    Edge endpoints / LG endpoints are *graph-local* indices.
    """

    node_feats: np.ndarray      # [ΣN, F_node] float32
    edge_src: np.ndarray        # [ΣE] int32 (graph-local)
    edge_dst: np.ndarray        # [ΣE] int32
    edge_attr: np.ndarray       # [ΣE, F_edge] float32
    lg_src: np.ndarray          # [ΣL] int32 (graph-local bond ids)
    lg_dst: np.ndarray          # [ΣL] int32
    lg_attr: np.ndarray         # [ΣL, F_angle] float32
    node_off: np.ndarray        # [G+1] int64
    edge_off: np.ndarray        # [G+1] int64
    lg_off: np.ndarray          # [G+1] int64
    global_scalars: np.ndarray  # [G, 59] float32
    sg_num: np.ndarray          # [G] int32
    y: np.ndarray               # [G, T] float32 (NaN rows = missing target)
    material_ids: List[str]
    formulas: List[str]
    reduced_formulas: List[str]
    prototypes: List[str]

    # ------------------------------------------------------------------ api
    def __len__(self) -> int:
        return len(self.material_ids)

    @property
    def n_graphs(self) -> int:
        return len(self.material_ids)

    @property
    def node_dim(self) -> int:
        return int(self.node_feats.shape[1])

    @property
    def edge_dim(self) -> int:
        return int(self.edge_attr.shape[1])

    @property
    def angle_dim(self) -> int:
        return int(self.lg_attr.shape[1])

    @property
    def target_dim(self) -> int:
        return int(self.y.shape[1])

    @property
    def global_scalar_dim(self) -> int:
        return int(self.global_scalars.shape[1])

    def counts(self, g: int):
        return (int(self.node_off[g + 1] - self.node_off[g]),
                int(self.edge_off[g + 1] - self.edge_off[g]),
                int(self.lg_off[g + 1] - self.lg_off[g]))

    def has_target(self) -> np.ndarray:
        return np.isfinite(self.y).all(axis=1)

    def group_keys(self) -> List[str]:
        """'{prototype}|{reduced_formula}' in store order (train.py:1303-1309)."""
        keys = []
        for g in range(self.n_graphs):
            reduced = self.reduced_formulas[g] or self.formulas[g]
            if reduced:
                keys.append(f"{self.prototypes[g]}|{reduced}")
            else:
                keys.append(self.material_ids[g] or f"idx_{g}")
        return keys

    def subset(self, indices: Sequence[int]) -> "GraphStore":
        idx = list(int(i) for i in indices)
        return GraphStore.from_samples([self.sample(i) for i in idx])

    def sample(self, g: int) -> GraphSample:
        n0, n1 = self.node_off[g], self.node_off[g + 1]
        e0, e1 = self.edge_off[g], self.edge_off[g + 1]
        l0, l1 = self.lg_off[g], self.lg_off[g + 1]
        yg = self.y[g]
        return GraphSample(
            material_id=self.material_ids[g], formula=self.formulas[g],
            reduced_formula=self.reduced_formulas[g], prototype=self.prototypes[g],
            node_feats=self.node_feats[n0:n1],
            edge_src=self.edge_src[e0:e1], edge_dst=self.edge_dst[e0:e1],
            edge_attr=self.edge_attr[e0:e1],
            lg_src=self.lg_src[l0:l1], lg_dst=self.lg_dst[l0:l1],
            lg_attr=self.lg_attr[l0:l1],
            global_scalars=self.global_scalars[g],
            sg_num=int(self.sg_num[g]),
            y=None if not np.isfinite(yg).all() else yg,
        )

    # ------------------------------------------------------------- builders
    @classmethod
    def from_samples(cls, samples: Sequence[GraphSample],
                     target_dim: int = 2) -> "GraphStore":
        """Build the arena; each graph's edge/LG arrays are canonicalized to
        dst-sorted order first, so batch assembly's global CSR sort becomes
        a no-op concatenation (offsets grow monotonically across graphs —
        see `batching.apply_csr_sort`'s sorted fast path). The model is
        edge-permutation-invariant, so this is an internal layout choice."""
        if not samples:
            raise ValueError("Cannot build a GraphStore from zero samples.")
        samples = [_canonical_sample(s) for s in samples]
        node_off = np.zeros(len(samples) + 1, dtype=np.int64)
        edge_off = np.zeros(len(samples) + 1, dtype=np.int64)
        lg_off = np.zeros(len(samples) + 1, dtype=np.int64)
        ys = np.full((len(samples), target_dim), np.nan, dtype=np.float32)
        for g, s in enumerate(samples):
            node_off[g + 1] = node_off[g] + s.n_nodes
            edge_off[g + 1] = edge_off[g] + s.n_edges
            lg_off[g + 1] = lg_off[g] + s.n_lg_edges
            if s.y is not None:
                ys[g] = s.y[:target_dim]
        cat = lambda key: np.concatenate([getattr(s, key) for s in samples], axis=0)
        return cls(
            node_feats=cat("node_feats"),
            edge_src=cat("edge_src"), edge_dst=cat("edge_dst"), edge_attr=cat("edge_attr"),
            lg_src=cat("lg_src"), lg_dst=cat("lg_dst"), lg_attr=cat("lg_attr"),
            node_off=node_off, edge_off=edge_off, lg_off=lg_off,
            global_scalars=np.stack([s.global_scalars for s in samples]),
            sg_num=np.asarray([s.sg_num for s in samples], dtype=np.int32),
            y=ys,
            material_ids=[s.material_id for s in samples],
            formulas=[s.formula for s in samples],
            reduced_formulas=[s.reduced_formula for s in samples],
            prototypes=[s.prototype for s in samples],
        )

    @classmethod
    def load_dir(cls, directory: str | Path, *, require_target: bool = True,
                 use_cache: bool = True) -> "GraphStore":
        """Load every per-material .npz (sorted by filename, matching the
        reference's sorted glob, train.py:64) with a consolidated arena cache."""
        directory = Path(directory)
        files = sorted(p for p in directory.glob("*.npz") if not p.name.startswith("_"))
        if not files:
            raise FileNotFoundError(f"No .npz graph files under {directory}")
        fingerprint = hashlib.sha256(
            "\n".join(f"{p.name}:{p.stat().st_mtime_ns}:{p.stat().st_size}" for p in files)
            .encode()).hexdigest()[:16]
        cache = directory / "_arena_cache.npz"
        if use_cache:
            try:
                store = cls._load_arena(cache, fingerprint)
                if store is not None:
                    return store.filter_targets() if require_target else store
            except Exception:
                pass
        samples = []
        for p in files:
            try:
                samples.append(load_sample(p))
            except Exception as exc:  # corrupted archive → skip, as fetch resume does
                print(f"[store] skipping unreadable {p.name}: {exc}")
        store = cls.from_samples(samples)
        if use_cache:
            try:
                store._save_arena(cache, fingerprint)
            except Exception:
                pass
        return store.filter_targets() if require_target else store

    def filter_targets(self) -> "GraphStore":
        """Drop graphs lacking finite targets or containing non-finite features
        (reference validity filter, train.py:174-182)."""
        ok = self.has_target()
        for g in range(self.n_graphs):
            if not ok[g]:
                continue
            n0, n1 = self.node_off[g], self.node_off[g + 1]
            e0, e1 = self.edge_off[g], self.edge_off[g + 1]
            l0, l1 = self.lg_off[g], self.lg_off[g + 1]
            if (not np.isfinite(self.node_feats[n0:n1]).all()
                    or not np.isfinite(self.edge_attr[e0:e1]).all()
                    or not np.isfinite(self.lg_attr[l0:l1]).all()
                    or not np.isfinite(self.global_scalars[g]).all()):
                ok[g] = False
        if ok.all():
            return self
        keep = np.nonzero(ok)[0]
        if keep.size == 0:
            raise ValueError("Dataset is empty after filtering for targets.")
        return self.subset(keep)

    # --------------------------------------------------------------- arena io
    _ARENA_ARRAYS = ("node_feats", "edge_src", "edge_dst", "edge_attr",
                     "lg_src", "lg_dst", "lg_attr", "node_off", "edge_off",
                     "lg_off", "global_scalars", "sg_num", "y")

    def _save_arena(self, path: Path, fingerprint: str) -> None:
        """Write the columnar cache as a DIRECTORY of raw .npy files so
        reloads can memory-map them (`np.load(..., mmap_mode='r')` only works
        on .npy) — a full-MP arena reload goes from a ~10 s decompress+copy
        to page-on-demand. Written to a tmp dir and renamed for atomicity."""
        final = path.with_suffix("")  # <dir>/_arena_cache/
        tmp = final.with_name(final.name + ".tmp")
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        for key in self._ARENA_ARRAYS:
            np.save(tmp / f"{key}.npy", np.ascontiguousarray(getattr(self, key)))
        (tmp / "meta.json").write_text(json.dumps({
            "fingerprint": fingerprint,
            "material_ids": self.material_ids,
            "formulas": self.formulas,
            "reduced_formulas": self.reduced_formulas,
            "prototypes": self.prototypes,
        }))
        shutil.rmtree(final, ignore_errors=True)
        tmp.rename(final)

    @classmethod
    def _load_arena(cls, path: Path, fingerprint: str) -> Optional["GraphStore"]:
        arena_dir = path.with_suffix("")
        if arena_dir.is_dir():
            meta = json.loads((arena_dir / "meta.json").read_text())
            if meta["fingerprint"] != fingerprint:
                return None
            arrays = {key: np.load(arena_dir / f"{key}.npy", mmap_mode="r",
                                   allow_pickle=False)
                      for key in cls._ARENA_ARRAYS}
            return cls(**arrays,
                       material_ids=meta["material_ids"],
                       formulas=meta["formulas"],
                       reduced_formulas=meta["reduced_formulas"],
                       prototypes=meta["prototypes"])
        if not path.exists():
            return None
        # legacy single-.npz cache (eager load)
        with np.load(path, allow_pickle=False) as data:
            if str(data["fingerprint"]) != fingerprint:
                return None
            meta = json.loads(str(data["meta"]))
            return cls(
                **{key: data[key] for key in cls._ARENA_ARRAYS},
                material_ids=meta["material_ids"], formulas=meta["formulas"],
                reduced_formulas=meta["reduced_formulas"], prototypes=meta["prototypes"],
            )


def write_index(directory: str | Path, store: GraphStore) -> None:
    """Manifest equivalent to the reference's index.json (fetch.py:812-830)."""
    rows = []
    for g in range(store.n_graphs):
        n, e, l = store.counts(g)
        rows.append({
            "material_id": store.material_ids[g],
            "formula": store.formulas[g],
            "reduced_formula": store.reduced_formulas[g] or store.formulas[g],
            "prototype": store.prototypes[g] or None,
            "n_atoms": n, "n_edges": e, "n_lg_edges": l,
            "has_target": bool(np.isfinite(store.y[g]).all()),
        })
    Path(directory, "index.json").write_text(json.dumps(rows, indent=2))
