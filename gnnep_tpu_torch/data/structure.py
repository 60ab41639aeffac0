"""Native crystal-structure container and lattice math (the port's own copy
of `gnnep_tpu.data.structure`).

A minimal, numpy-only stand-in for the subset of `pymatgen.core.Structure`
the featurization layer needs (the reference leans on pymatgen throughout
reference `fetch.py`): lattice vectors, fractional coords,
species symbols, volume/density, and parsing of pymatgen's
`Structure.as_dict()` JSON format (the custom-inference input schema,
reference `predict.py:402-440`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence

import numpy as np

from ..elements import element_props

_AMU_PER_A3_TO_G_PER_CM3 = 1.66053906660  # 1 amu/Å³ in g/cm³

# pymatgen Composition.special_formulas (peroxides and diatomic gases)
_SPECIAL_FORMULAS = {
    "LiO": "Li2O2", "NaO": "Na2O2", "KO": "K2O2", "HO": "H2O2", "CsO": "Cs2O2",
    "RbO": "Rb2O2", "O": "O2", "N": "N2", "F": "F2", "Cl": "Cl2", "H": "H2",
}


def _pymatgen_composition():
    """pymatgen's Composition class when importable, else None (the native
    implementations below reproduce its formula strings byte-for-byte)."""
    try:
        from pymatgen.core import Composition
        return Composition
    except Exception:
        return None


def _en_of(symbol: str) -> float:
    return float(element_props(symbol).en)


def _formula_double_format(amt: float) -> str:
    """pymatgen formula_double_format(ignore_ones=True): 1 → '', ints bare."""
    if amt == 1:
        return ""
    if abs(amt - int(amt)) < 1e-8:
        return str(int(amt))
    return str(round(amt, 8))


def _reduce_formula(sym_amt):
    """pymatgen `reduce_formula` parity: (formula string, reduction factor).

    Elements sorted by (Pauling EN, symbol); integer GCD reduction; the two
    most electronegative elements form a parenthesized polyanion when their
    EN gap is < 1.65 and the pair itself reduces (e.g. Fe2(SO4)3). Missing
    EN maps to 0.0 (pymatgen yields NaN there — only affects noble-gas
    compositions, absent from elasticity data)."""
    syms = sorted(sym_amt, key=lambda s: (_en_of(s), s))
    syms = [s for s in syms if abs(sym_amt[s]) >= 1e-8]
    factor = 1
    if all(int(i) == i for i in sym_amt.values()):
        factor = abs(math.gcd(*(int(i) for i in sym_amt.values())))
    polyanion = []
    if len(syms) >= 3 and _en_of(syms[-1]) - _en_of(syms[-2]) < 1.65:
        poly_sym_amt = {syms[i]: sym_amt[syms[i]] / factor for i in [-2, -1]}
        poly_form, poly_factor = _reduce_formula(poly_sym_amt)
        if poly_factor != 1:
            polyanion.append(f"({poly_form}){poly_factor}")
    syms = syms[: len(syms) - 2 if polyanion else len(syms)]
    parts = []
    for s in syms:
        parts.append(s)
        parts.append(_formula_double_format(sym_amt[s] / factor))
    return "".join([*parts, *polyanion]), factor


@dataclasses.dataclass(frozen=True)
class Lattice:
    """Row-vector lattice: cartesian = frac @ matrix."""

    matrix: np.ndarray  # [3, 3] float64, rows are a, b, c

    def __post_init__(self):
        object.__setattr__(self, "matrix", np.asarray(self.matrix, dtype=np.float64).reshape(3, 3))

    @property
    def lengths(self) -> np.ndarray:
        return np.linalg.norm(self.matrix, axis=1)

    @property
    def a(self) -> float:
        return float(self.lengths[0])

    @property
    def b(self) -> float:
        return float(self.lengths[1])

    @property
    def c(self) -> float:
        return float(self.lengths[2])

    def _angle(self, i: int, j: int) -> float:
        u, v = self.matrix[i], self.matrix[j]
        cosang = np.dot(u, v) / (np.linalg.norm(u) * np.linalg.norm(v))
        return math.degrees(math.acos(float(np.clip(cosang, -1.0, 1.0))))

    @property
    def alpha(self) -> float:  # angle between b and c
        return self._angle(1, 2)

    @property
    def beta(self) -> float:  # angle between a and c
        return self._angle(0, 2)

    @property
    def gamma(self) -> float:  # angle between a and b
        return self._angle(0, 1)

    @property
    def volume(self) -> float:
        return float(abs(np.linalg.det(self.matrix)))

    def cartesian(self, frac: np.ndarray) -> np.ndarray:
        return np.asarray(frac, dtype=np.float64) @ self.matrix

    @classmethod
    def from_parameters(cls, a: float, b: float, c: float,
                        alpha: float, beta: float, gamma: float) -> "Lattice":
        """Standard crystallographic construction (a along x, b in xy-plane)."""
        ar, br, gr = (math.radians(x) for x in (alpha, beta, gamma))
        cx = c * math.cos(br)
        cy = c * (math.cos(ar) - math.cos(br) * math.cos(gr)) / max(math.sin(gr), 1e-12)
        cz = math.sqrt(max(c * c - cx * cx - cy * cy, 0.0))
        m = np.array([
            [a, 0.0, 0.0],
            [b * math.cos(gr), b * math.sin(gr), 0.0],
            [cx, cy, cz],
        ])
        return cls(m)


@dataclasses.dataclass
class Structure:
    """Periodic crystal: lattice + species symbols + fractional coordinates."""

    lattice: Lattice
    species: List[str]           # element symbols, may carry oxidation suffixes
    frac_coords: np.ndarray      # [N, 3] float64

    def __post_init__(self):
        self.frac_coords = np.asarray(self.frac_coords, dtype=np.float64).reshape(-1, 3)
        if len(self.species) != self.frac_coords.shape[0]:
            raise ValueError(
                f"species ({len(self.species)}) and frac_coords ({self.frac_coords.shape[0]}) disagree")

    def __len__(self) -> int:
        return len(self.species)

    @property
    def cart_coords(self) -> np.ndarray:
        return self.lattice.cartesian(self.frac_coords)

    @property
    def volume(self) -> float:
        return self.lattice.volume

    @property
    def total_mass(self) -> float:
        return float(sum(element_props(s).mass for s in self.species))

    @property
    def density(self) -> float:
        """g/cm³ (matches pymatgen's Structure.density)."""
        vol = self.volume
        if vol <= 0:
            return 0.0
        return self.total_mass / vol * _AMU_PER_A3_TO_G_PER_CM3

    @property
    def composition(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in self.species:
            core = "".join(ch for ch in s if ch.isalpha())
            out[core] = out.get(core, 0) + 1
        return out

    def reduced_formula(self) -> str:
        """Electronegativity-ordered reduced formula, e.g. 'NaCl', 'Fe2(SO4)3'.

        Byte-identical to pymatgen's `Composition.reduced_formula` (the
        reference's group-key ingredient, fetch.py:159-186): elements sorted
        by (Pauling EN, symbol), integer-GCD reduction, polyanion grouping
        when the last two elements are within 1.65 EN of each other, and the
        peroxide/diatomic special cases. Defers to pymatgen when importable
        so key strings (hence train/test splits) match a reference run."""
        comp = self.composition
        if not comp:
            return ""
        pmg = _pymatgen_composition()
        if pmg is not None:
            try:
                return str(pmg(comp).reduced_formula)
            except Exception:
                pass
        formula, factor = _reduce_formula({k: float(v) for k, v in comp.items()})
        if formula in _SPECIAL_FORMULAS:
            formula = _SPECIAL_FORMULAS[formula]
        return formula

    def anonymized_formula(self) -> str:
        """ABC-style prototype label, e.g. 'AB2C4' for spinel.

        Byte-identical to pymatgen's `Composition.anonymized_formula`:
        amounts GCD-reduced, sorted ascending, then labelled A, B, C, …
        (zip with the uppercase alphabet — compositions beyond 26 elements
        truncate exactly as pymatgen does)."""
        comp = self.composition
        if not comp:
            return ""
        pmg = _pymatgen_composition()
        if pmg is not None:
            try:
                return str(pmg(comp).anonymized_formula)
            except Exception:
                pass
        counts = [float(c) for c in comp.values()]
        g = math.gcd(*(int(c) for c in counts))
        amounts = sorted(c / g for c in counts)
        parts = []
        for letter, amt in zip("ABCDEFGHIJKLMNOPQRSTUVWXYZ", amounts):
            if amt == 1:
                amt_str = ""
            elif abs(amt % 1) < 1e-8:
                amt_str = str(int(amt))
            else:
                amt_str = str(amt)
            parts.append(f"{letter}{amt_str}")
        return "".join(parts)

    def prototype_label(self) -> str:
        """Reference prototype cascade (fetch.py:159-186): pymatgen
        `StructureMatcher.get_structure_type` when it exists (it does not in
        modern pymatgen — the reference guards with a callable check), else
        the anonymized formula."""
        try:
            from pymatgen.analysis.structure_matcher import StructureMatcher
            from pymatgen.core import Structure as PmgStructure

            matcher = StructureMatcher(primitive_cell=True, scale=True,
                                       attempt_supercell=False)
            get_type = getattr(matcher, "get_structure_type", None)
            if callable(get_type):
                val = get_type(PmgStructure.from_dict(self.as_dict()))
                if val:
                    return str(val)
        except Exception:
            pass
        return self.anonymized_formula()

    # -- serialization ------------------------------------------------------

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Structure":
        """Parse pymatgen `Structure.as_dict()` JSON (custom-inference input)."""
        lat_d = d["lattice"]
        if "matrix" in lat_d:
            lattice = Lattice(np.asarray(lat_d["matrix"], dtype=np.float64))
        else:
            lattice = Lattice.from_parameters(
                lat_d["a"], lat_d["b"], lat_d["c"],
                lat_d["alpha"], lat_d["beta"], lat_d["gamma"])
        species: List[str] = []
        fracs: List[Sequence[float]] = []
        for site in d["sites"]:
            sp = site.get("species")
            if sp:
                # majority-occupancy species on disordered sites
                best = max(sp, key=lambda e: float(e.get("occu", 1.0)))
                sym = best.get("element") or best.get("species") or ""
            else:
                sym = site.get("label", "")
            species.append(str(sym))
            fracs.append(site["abc"])
        return cls(lattice=lattice, species=species, frac_coords=np.asarray(fracs))

    def as_dict(self) -> Dict[str, Any]:
        lat = self.lattice
        return {
            "lattice": {
                "matrix": lat.matrix.tolist(),
                "a": lat.a, "b": lat.b, "c": lat.c,
                "alpha": lat.alpha, "beta": lat.beta, "gamma": lat.gamma,
                "volume": lat.volume,
            },
            "sites": [
                {"species": [{"element": s, "occu": 1}], "abc": list(map(float, fc))}
                for s, fc in zip(self.species, self.frac_coords)
            ],
        }
