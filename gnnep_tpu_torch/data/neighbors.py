"""Periodic neighbor finding (the port's own copy of
`gnnep_tpu.data.neighbors`).

Native numpy implementation of fixed-radius periodic neighbor lists
(equivalent semantics to the reference's cutoff mode,
reference `fetch.py:189-247`), plus an optional CrystalNN path
that defers to pymatgen when it is importable. Directed edges are
`(i, j, jimage)` with the convention that the neighbor's position is
`frac[j] + jimage` in fractional coordinates — identical to the bond
identity key the reference uses for line-graph construction
(fetch.py:387-398).
"""
from __future__ import annotations

import itertools
from typing import List, Tuple

import numpy as np

from .structure import Structure

Edge = Tuple[int, int, Tuple[int, int, int]]


def _image_ranges(lattice_matrix: np.ndarray, cutoff: float) -> List[int]:
    """Periodic image repeats needed per axis to cover a sphere of `cutoff`.

    Uses perpendicular interplanar spacings d_i = V / |a_j × a_k|.
    """
    vol = abs(float(np.linalg.det(lattice_matrix)))
    reps = []
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        cross = np.cross(lattice_matrix[j], lattice_matrix[k])
        d = vol / max(float(np.linalg.norm(cross)), 1e-12)
        reps.append(int(np.ceil(cutoff / max(d, 1e-12))) + 1)
    return reps


def cutoff_neighbors(structure: Structure, cutoff: float) -> List[Edge]:
    """All directed edges (i, j, jimage) with 0 < |r_ij| <= cutoff.

    Vectorized over periodic images; enumeration order is per source atom i,
    then by (image, j) lexicographic order of the candidate list, sorted by
    (j, image) for a deterministic canonical ordering.
    """
    n = len(structure)
    if n == 0:
        return []
    mat = structure.lattice.matrix
    fracs = structure.frac_coords
    reps = _image_ranges(mat, cutoff)

    from .. import native as _native

    nat = _native.cutoff_neighbors_native(fracs, mat, cutoff, reps)
    if nat is not None:
        src, dst, img, _, _ = nat
        return [(int(src[t]), int(dst[t]),
                 (int(img[t, 0]), int(img[t, 1]), int(img[t, 2])))
                for t in range(src.shape[0])]

    images = np.array(list(itertools.product(
        range(-reps[0], reps[0] + 1),
        range(-reps[1], reps[1] + 1),
        range(-reps[2], reps[2] + 1))), dtype=np.int64)  # [M, 3]

    # candidate positions: frac[j] + image, for all j, all images
    cand_frac = fracs[None, :, :] + images[:, None, :].astype(np.float64)  # [M, N, 3]
    cand_cart = cand_frac.reshape(-1, 3) @ mat                            # [M*N, 3]
    cart = structure.cart_coords

    edges: List[Edge] = []
    eps = 1e-8
    for i in range(n):
        d = np.linalg.norm(cand_cart - cart[i], axis=1)
        hit = np.nonzero((d > eps) & (d <= cutoff))[0]
        entries = []
        for flat in hit:
            m, j = divmod(int(flat), n)
            entries.append((j, tuple(int(x) for x in images[m])))
        entries.sort()
        for j, im in entries:
            edges.append((i, j, im))
    return edges


def _radius_candidates(
    structure: Structure, cutoff: float,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """All (src, dst, image, dist) pairs with 0 < dist <= cutoff, as arrays.

    Shared candidate machinery for `cutoff_neighbors` and `knn_neighbors`;
    uses the native C kernel when available, numpy otherwise.
    """
    n = len(structure)
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64),
             np.zeros((0, 3), np.int64), np.zeros(0, np.float64))
    if n == 0:
        return empty
    mat = structure.lattice.matrix
    fracs = structure.frac_coords
    reps = _image_ranges(mat, cutoff)

    from .. import native as _native

    nat = _native.cutoff_neighbors_native(fracs, mat, cutoff, reps)
    if nat is not None:
        src, dst, img, dist, _ = nat
        return (src.astype(np.int64), dst.astype(np.int64),
                img.astype(np.int64), dist)

    images = np.array(list(itertools.product(
        range(-reps[0], reps[0] + 1),
        range(-reps[1], reps[1] + 1),
        range(-reps[2], reps[2] + 1))), dtype=np.int64)  # [M, 3]
    cand_frac = fracs[None, :, :] + images[:, None, :].astype(np.float64)
    cand_cart = cand_frac.reshape(-1, 3) @ mat
    cart = structure.cart_coords
    srcs, dsts, imgs, dists = [], [], [], []
    eps = 1e-8
    for i in range(n):
        d = np.linalg.norm(cand_cart - cart[i], axis=1)
        hit = np.nonzero((d > eps) & (d <= cutoff))[0]
        m, j = np.divmod(hit, n)
        srcs.append(np.full(hit.shape, i, np.int64))
        dsts.append(j.astype(np.int64))
        imgs.append(images[m])
        dists.append(d[hit])
    if not srcs:
        return empty
    return (np.concatenate(srcs), np.concatenate(dsts),
            np.concatenate(imgs, axis=0), np.concatenate(dists))


def knn_neighbors(structure: Structure, k: int = 12,
                  init_cutoff: float = 4.0,
                  max_cutoff: float = 25.0) -> List[Edge]:
    """k-nearest periodic neighbors per atom, keeping distance-shell ties.

    The ALIGNN graph convention (k=12 nearest neighbors, ties at the k-th
    distance included so symmetric coordination shells are never split) and
    a CrystalNN-grade coordination statistic for hosts without pymatgen:
    the reference's CrystalNN bonded sets (fetch.py:221-238) have median
    coordination ~12 on MP, while its 7.5 Å fixed-radius fallback explodes
    to 50+ neighbors on dense metals (and the line graph grows as the
    square of coordination). Deterministic: candidates are ranked by
    (rounded distance, j, image); output keeps `cutoff_neighbors`' per-src
    (j, image) canonical ordering.
    """
    if k < 1:
        raise ValueError(f"knn neighbor count must be >= 1, got {k}")
    n = len(structure)
    if n == 0:
        return []
    cutoff = float(init_cutoff)
    while True:
        src, dst, img, dist = _radius_candidates(structure, cutoff)
        counts = np.bincount(src, minlength=n) if src.size else \
            np.zeros(n, np.int64)
        # counts has length n >= 1 (bincount minlength), so plain min() is
        # safe; min(initial=0) would always be 0 and escalate every
        # structure to max_cutoff, defeating the adaptive radius
        if counts.min() >= k or cutoff >= max_cutoff:
            break
        cutoff *= 1.6
    edges: List[Edge] = []
    qd = np.round(dist, 10)
    for i in range(n):
        sel = np.nonzero(src == i)[0]
        if sel.size == 0:
            continue
        order = sel[np.lexsort((img[sel, 2], img[sel, 1], img[sel, 0],
                                dst[sel], qd[sel]))]
        kk = min(k, order.size)
        shell_d = qd[order[kk - 1]]
        take = order[qd[order] <= shell_d + 1e-8]
        ent = sorted((int(dst[t]),
                      (int(img[t, 0]), int(img[t, 1]), int(img[t, 2])))
                     for t in take)
        edges.extend((i, j, im) for j, im in ent)
    # Symmetrize: per-atom k-NN selection is directed (j can be in i's shell
    # without i being in j's — common in multi-species/distorted cells), but
    # both other methods produce symmetric sets and the ALIGNN convention
    # builds undirected edge data. Add the missing reverse (j, i, -image)
    # edges, then re-canonicalize to the per-src (j, image) ordering.
    have = set(edges)
    for i, j, im in list(edges):
        rev = (j, i, (-im[0], -im[1], -im[2]))
        if rev not in have:
            have.add(rev)
    return sorted(have)


def shortest_image(structure: Structure, i: int, j: int) -> Tuple[int, int, int]:
    """Lattice translation mapping j to its nearest periodic copy w.r.t. i."""
    mat = structure.lattice.matrix
    dfrac = structure.frac_coords[j] - structure.frac_coords[i]
    base = -np.round(dfrac)
    best, best_d = (0, 0, 0), np.inf
    for delta in itertools.product((-1, 0, 1), repeat=3):
        im = base + np.asarray(delta)
        d = float(np.linalg.norm((dfrac + im) @ mat))
        if d < best_d - 1e-12:
            best_d, best = d, tuple(int(x) for x in im)
    return best


def crystalnn_neighbors(structure: Structure,
                        guess_oxidation: bool = True) -> List[Edge]:
    """CrystalNN bonded-structure edges via pymatgen (optional dependency).

    `guess_oxidation` adds guessed oxidation states first, improving
    CrystalNN bonding quality (reference fetch.py:333-339)."""
    from pymatgen.core import Lattice as PmgLattice, Structure as PmgStructure  # type: ignore
    from pymatgen.analysis.local_env import CrystalNN  # type: ignore

    pmg = PmgStructure(
        PmgLattice(structure.lattice.matrix), structure.species,
        structure.frac_coords, coords_are_cartesian=False)
    if guess_oxidation:
        try:
            pmg.add_oxidation_state_by_guess()
        except Exception:
            pass
    cnn = CrystalNN()
    sg = cnn.get_bonded_structure(pmg)
    edges: List[Edge] = []
    for i in range(len(pmg)):
        for nb in sg.get_connected_sites(i):
            j = nb.index
            im = getattr(nb, "jimage", None)
            if im is None:
                jimage = shortest_image(structure, i, j)
            else:
                jimage = (int(im[0]), int(im[1]), int(im[2]))
            edges.append((i, j, jimage))
    return edges


def find_edges(structure: Structure, method: str, cutoff: float,
               fallback_cutoff: float = 7.5,
               guess_oxidation: bool = True) -> Tuple[List[Edge], str]:
    """Dispatch on neighbor method with the reference's fallback semantics.

    'crystalnn' attempts pymatgen CrystalNN and falls back to a fixed-radius
    list at `fallback_cutoff` on any failure (including pymatgen being
    absent), mirroring fetch.py:210-247. 'knn' / 'knn<k>' (e.g. 'knn12')
    selects the k-nearest method — the recommended CrystalNN stand-in on
    pymatgen-less hosts. Unknown method strings raise (a typo silently
    falling through to cutoff graphs would skew every downstream feature).
    """
    import re

    if not re.fullmatch(r"crystalnn|cutoff|knn\d*", method):
        raise ValueError(
            f"Unknown neighbor method {method!r}; expected 'crystalnn', "
            "'cutoff', or 'knn<k>' (e.g. 'knn12').")
    if method == "crystalnn":
        try:
            edges = crystalnn_neighbors(structure, guess_oxidation)
        except Exception:
            edges = []
        if edges:
            return edges, "crystalnn"
        return cutoff_neighbors(structure, fallback_cutoff), "cutoff"
    if method.startswith("knn"):
        k = int(method[3:]) if method[3:] else 12
        if k < 1:
            raise ValueError(f"knn neighbor count must be >= 1, got {k}")
        return knn_neighbors(structure, k=k), method
    return cutoff_neighbors(structure, cutoff), "cutoff"
