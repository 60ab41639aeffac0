"""Dataset-build CLI: Materials Project fetch → featurize → columnar store
(the port's own copy of `gnnep_tpu.cli.fetch`, with the same flags; host
code only, so it has no `--device`).

Mirrors the reference fetcher (reference `fetch.py:654-915`):
paged `summary.search` filtered to entries with elasticity VRH moduli,
per-material featurization with resume (`--skip-existing`) and
corrupted-file rebuild, an index.json manifest, and mat2vec node-feature
augmentation. The MP API client (`mp_api`) and pymatgen are optional — when
absent, `--from-json` ingests structures offline from a JSON file of
pymatgen `Structure.as_dict()` entries (same schema as custom inference).

    python -m gnnep_tpu_torch.cli.fetch --out-dir data/mp_gnn --limit 100
    python -m gnnep_tpu_torch.cli.fetch --out-dir data/mp_gnn --from-json dump.json
"""
from __future__ import annotations

import argparse
import json
import math
import os
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np

from ..data.featurize import BasisConfig, build_graph, load_mat2vec
from ..data.store import load_sample, save_sample, write_index_streaming
from ..data.structure import Structure


def _get_api_key(explicit: Optional[str]) -> str:
    key = explicit or os.environ.get("MAPI_KEY") or os.environ.get("MP_API_KEY")
    if not key:
        raise SystemExit("Materials Project API key not provided. "
                         "Set MAPI_KEY/MP_API_KEY or use --api-key.")
    return key


def _coerce_float(val) -> Optional[float]:
    """Tolerant VRH field coercion (reference fetch.py:99-114)."""
    if val is None:
        return None
    if isinstance(val, (int, float)):
        return float(val)
    if isinstance(val, dict):
        for key in ("vrh", "VRH", "value", "avg", "mean", "K_VRH", "G_VRH"):
            if key in val and isinstance(val[key], (int, float)):
                return float(val[key])
        for v in val.values():
            if isinstance(v, (int, float)):
                return float(v)
    return None


def _structure_from_doc(doc) -> Structure:
    """Convert an MP document's pymatgen structure to the native container."""
    from ..data.structure import Lattice

    pmg = doc.structure
    return Structure(
        lattice=Lattice(np.asarray(pmg.lattice.matrix, dtype=np.float64)),
        species=[str(site.specie.symbol if hasattr(site.specie, "symbol")
                     else site.specie) for site in pmg.sites],
        frac_coords=np.asarray(pmg.frac_coords, dtype=np.float64))


def iter_mp_documents(api_key: str, limit: Optional[int], fetch_all: bool,
                      page_size: int) -> Iterable:
    """Stream MP summary docs with elasticity filters (fetch.py:674-699)."""
    try:
        from mp_api.client import MPRester  # type: ignore
    except ImportError as exc:
        raise SystemExit(
            "mp_api is not installed in this environment. Install mp-api to "
            "fetch from Materials Project, or build a dataset offline with "
            "--from-json.") from exc
    fields = ["material_id", "formula_pretty", "structure",
              "bulk_modulus", "shear_modulus"]
    kwargs = {"has_props": ["elasticity"],
              "k_vrh": (0.0, float("inf")), "g_vrh": (0.0, float("inf"))}
    with MPRester(api_key) as mpr:
        if fetch_all:
            docs = mpr.materials.summary.search(
                fields=fields, **kwargs, num_chunks=None, chunk_size=page_size)
        else:
            docs = mpr.materials.summary.search(
                fields=fields, **kwargs,
                num_chunks=math.ceil(limit / page_size), chunk_size=page_size)
    if not fetch_all:
        docs = list(docs)[:limit]
    return docs


def iter_json_documents(path: str) -> Iterable:
    """Offline document source: JSON list (or {'materials': [...]}) of entries
    with 'structure' (pymatgen as_dict), ids and VRH targets."""
    payload = json.loads(Path(path).read_text())
    entries = payload.get("materials", payload) if isinstance(payload, dict) \
        else payload

    class Doc:
        def __init__(self, e: Dict):
            self.entry = e
            self.material_id = e.get("material_id", "unknown")
            self.formula_pretty = e.get("formula", "")
            self.k_vrh = e.get("k_vrh", e.get("bulk_modulus"))
            self.g_vrh = e.get("g_vrh", e.get("shear_modulus"))
            self.native_structure = Structure.from_dict(e["structure"])

    return [Doc(e) for e in entries]


_WORKER_CTX: Dict = {}


def _init_featurize_worker(out_dir, basis, nn_method, cutoff, mat2vec,
                           guess_oxidation):
    _WORKER_CTX.update(out_dir=out_dir, basis=basis, nn_method=nn_method,
                       cutoff=cutoff, mat2vec=mat2vec,
                       guess_oxidation=guess_oxidation)


def _featurize_one(payload):
    """Featurize + save one material in a worker process (returns
    (material_id, neighbor_method, error-or-None))."""
    mid, structure, formula, y = payload
    w = _WORKER_CTX
    try:
        sample = build_graph(structure, material_id=mid, formula=formula,
                             y=y, basis=w["basis"], nn_method=w["nn_method"],
                             cutoff=w["cutoff"], fallback_cutoff=7.5,
                             mat2vec=w["mat2vec"] or None,
                             guess_oxidation=w["guess_oxidation"])
        save_sample(w["out_dir"], sample)
        return mid, sample.neighbor_method, None
    except Exception as exc:
        return mid, "", f"{type(exc).__name__}: {exc}"


def fetch_and_build(args) -> None:
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    basis = BasisConfig(rbf_n=args.rbf_n, rbf_cutoff=args.rbf_cutoff,
                        rbf_gamma=args.rbf_gamma, angle_n=args.angle_n)
    mat2vec = {}
    if args.mat2vec_path and not args.disable_mat2vec:
        mat2vec = load_mat2vec(args.mat2vec_path)
        dim = len(next(iter(mat2vec.values())))
        print(f"Loaded mat2vec embeddings ({dim} dims) for {len(mat2vec)} "
              f"tokens from {args.mat2vec_path}")

    if args.from_json:
        docs = iter_json_documents(args.from_json)
    else:
        docs = iter_mp_documents(_get_api_key(args.api_key), args.limit,
                                 args.fetch_all, args.page_size)

    expected_node_dim = 6 + (len(next(iter(mat2vec.values()))) if mat2vec else 0)
    saved = skipped = 0
    pending = []  # payloads for parallel featurization (--fetch-workers > 1)
    for doc in docs:
        mid = str(getattr(doc, "material_id", "unknown")).replace("/", "_")
        out_path = out_dir / f"{mid}.npz"
        if out_path.exists():
            rebuild = False
            try:
                existing = load_sample(out_path)
                if existing.node_feats.shape[1] != expected_node_dim:
                    rebuild = True  # mat2vec-dim mismatch (fetch.py:758-762)
            except Exception as exc:
                print(f"Existing graph file {out_path} is unreadable ({exc}); "
                      "rebuilding entry.")
                rebuild = True
            if args.skip_existing and not rebuild:
                skipped += 1
                continue

        structure = getattr(doc, "native_structure", None)
        if structure is None:
            structure = _structure_from_doc(doc)
        k_val = _coerce_float(getattr(doc, "k_vrh", None))
        g_val = _coerce_float(getattr(doc, "g_vrh", None))
        if k_val is None or g_val is None:
            k_val = _coerce_float(getattr(doc, "bulk_modulus", None))
            g_val = _coerce_float(getattr(doc, "shear_modulus", None))
        y = [k_val, g_val] if (k_val is not None and g_val is not None) else None

        formula = str(getattr(doc, "formula_pretty", "") or "")
        workers = max(int(getattr(args, "fetch_workers", 1) or 1), 1)
        if workers > 1:
            pending.append((mid, structure, formula, y))
            continue

        sample = build_graph(
            structure, material_id=mid, formula=formula,
            y=y, basis=basis, nn_method=args.nn_method, cutoff=args.cutoff,
            fallback_cutoff=7.5, mat2vec=mat2vec or None,
            guess_oxidation=args.guess_oxidation)
        if sample.neighbor_method != args.nn_method:
            print(f"{mid}: CrystalNN unavailable/failed; fell back to cutoff "
                  f"neighbors (r=7.5 Å).")
        save_sample(out_dir, sample)
        saved += 1
        if saved % 200 == 0:
            print(f"  featurized {saved} materials ...")

    if pending:
        # parallel featurization: CrystalNN/pymatgen analysis is CPU-bound
        # per material (SURVEY §7 "parallelize on host"); each process writes
        # its own .npz, so the only serialization is the payload pickle.
        # Workers are spawned, not forked: the caller may hold threads
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        workers = max(int(args.fetch_workers), 1)
        print(f"Featurizing {len(pending)} materials on {workers} processes")
        with ProcessPoolExecutor(
                max_workers=workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_init_featurize_worker,
                initargs=(out_dir, basis, args.nn_method, args.cutoff,
                          mat2vec, args.guess_oxidation)) as ex:
            for mid, nn_used, err in ex.map(_featurize_one, pending,
                                            chunksize=8):
                if err is not None:
                    print(f"{mid}: featurization FAILED ({err}); skipping.")
                    continue
                if nn_used != args.nn_method:
                    print(f"{mid}: CrystalNN unavailable/failed; fell back "
                          "to cutoff neighbors (r=7.5 Å).")
                saved += 1
                if saved % 200 == 0:
                    print(f"  featurized {saved} materials ...")

    n_indexed = write_index_streaming(out_dir)
    print(f"Saved {saved} graphs to {out_dir} "
          f"(skipped: {skipped}, indexed: {n_indexed})")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Fetch MP structures and build ALIGNN graphs "
                    "(CGCNN-style edges, line-graph angles, VRH targets)")
    p.add_argument("--out-dir", default=os.path.join("data", "mp_gnn"))
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--nn-method", default="crystalnn",
                   help="crystalnn (reference default; falls back to a "
                        "7.5 A cutoff without pymatgen), cutoff, or "
                        "knn[<k>] — k-nearest with shell ties (ALIGNN "
                        "convention; CrystalNN-grade coordination on "
                        "pymatgen-less hosts)")
    p.add_argument("--cutoff", type=float, default=5.0)
    p.add_argument("--api-key", default=None)
    p.add_argument("--rbf-n", type=int, default=32)
    p.add_argument("--rbf-cutoff", type=float, default=8.0)
    p.add_argument("--rbf-gamma", type=float, default=None)
    p.add_argument("--angle-n", type=int, default=8)
    p.add_argument("--all", dest="fetch_all", action="store_true", default=True)
    p.add_argument("--no-all", dest="fetch_all", action="store_false")
    p.add_argument("--page-size", type=int, default=1000)
    p.add_argument("--skip-existing", action="store_true", default=False)
    p.add_argument("--fetch-workers", type=int, default=1,
                   help="Parallel featurization processes (CrystalNN/"
                        "pymatgen analysis is CPU-bound per material)")
    p.add_argument("--guess-oxidation-states", dest="guess_oxidation",
                   action="store_true", default=True)
    p.add_argument("--no-guess-oxidation-states", dest="guess_oxidation",
                   action="store_false")
    p.add_argument("--no-skip-existing", dest="skip_existing",
                   action="store_false")
    p.add_argument("--mat2vec-path", default=_default_mat2vec())
    p.add_argument("--disable-mat2vec", action="store_true")
    p.add_argument("--quiet", dest="quiet", action="store_true", default=True,
                   help="Suppress known benign featurization warnings "
                        "(default on, as in the reference)")
    p.add_argument("--no-quiet", dest="quiet", action="store_false")
    p.add_argument("--from-json", default=None,
                   help="Offline source: JSON with pymatgen structure dicts "
                        "(no network / mp_api needed)")
    return p


def _default_mat2vec() -> str:
    """Bundled 200-d mat2vec element embeddings (public Tshitoyan et al. data,
    the same table the reference ships as data/mat2vec_embeddings.json; the
    port's own copy of the JAX package's asset)."""
    candidate = Path(__file__).resolve().parents[1] / "assets" / "mat2vec_200d.npz"
    return str(candidate) if candidate.exists() else ""


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.quiet:
        # known benign warnings from pymatgen-backed featurization
        # (fetch.py:726-729); the pure-numpy path emits none of these
        import warnings

        for pat in (r"No Pauling electronegativity for .*",
                    r"CrystalNN: cannot locate an appropriate radius.*",
                    r"No oxidation states specified on sites!.*"):
            warnings.filterwarnings("ignore", message=pat,
                                    category=UserWarning)
    if args.limit is not None and args.limit <= 0:
        raise SystemExit("--limit must be a positive integer when provided.")
    if args.limit is not None and args.fetch_all:
        args.fetch_all = False
    if not args.fetch_all and args.limit is None and not args.from_json:
        raise SystemExit("--no-all requires --limit to be set.")
    fetch_and_build(args)


if __name__ == "__main__":
    main()
