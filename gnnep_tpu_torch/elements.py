"""Element property tables for node featurization (the port's own copy of
`gnnep_tpu.elements`, tables unchanged).

Provides the six per-site scalars the featurizer needs — atomic number Z,
periodic-table group, period, Pauling electronegativity, standard atomic
mass, and an empirical atomic radius — matching the semantics of the
reference featurizer (reference `fetch.py:69-96`, which reads
them from `pymatgen.core.Element` with a covalent→atomic-radius fallback).

This module is self-contained: when pymatgen is importable we defer to it so
features are bit-identical to a pymatgen-based pipeline; otherwise we use the
built-in public data tables below (standard atomic weights, Pauling
electronegativities, Slater empirical atomic radii with calculated radii as
fallback). Missing values map to 0.0, as in the reference.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple

# Z-ordered element symbols, index = Z - 1.
SYMBOLS = (
    "H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe Co Ni "
    "Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In Sn Sb Te I "
    "Xe Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf Ta W Re Os Ir Pt "
    "Au Hg Tl Pb Bi Po At Rn Fr Ra Ac Th Pa U Np Pu Am Cm Bk Cf Es Fm Md No Lr "
    "Rf Db Sg Bh Hs Mt Ds Rg Cn Nh Fl Mc Lv Ts Og"
).split()

Z_OF: Dict[str, int] = {s: i + 1 for i, s in enumerate(SYMBOLS)}

# Standard atomic weights (IUPAC 2021 conventional values; most-stable-isotope
# mass for elements without a standard weight).
_MASSES = (
    1.008, 4.002602, 6.94, 9.0121831, 10.81, 12.011, 14.007, 15.999, 18.998403163,
    20.1797, 22.98976928, 24.305, 26.9815385, 28.085, 30.973761998, 32.06,
    35.45, 39.948, 39.0983, 40.078, 44.955908, 47.867, 50.9415, 51.9961,
    54.938044, 55.845, 58.933194, 58.6934, 63.546, 65.38, 69.723, 72.63,
    74.921595, 78.971, 79.904, 83.798, 85.4678, 87.62, 88.90584, 91.224,
    92.90637, 95.95, 98.0, 101.07, 102.9055, 106.42, 107.8682, 112.414,
    114.818, 118.71, 121.76, 127.6, 126.90447, 131.293, 132.90545196, 137.327,
    138.90547, 140.116, 140.90766, 144.242, 145.0, 150.36, 151.964, 157.25,
    158.92535, 162.5, 164.93033, 167.259, 168.93422, 173.045, 174.9668,
    178.49, 180.94788, 183.84, 186.207, 190.23, 192.217, 195.084, 196.966569,
    200.592, 204.38, 207.2, 208.9804, 209.0, 210.0, 222.0, 223.0, 226.0,
    227.0, 232.0377, 231.03588, 238.02891, 237.0, 244.0, 243.0, 247.0, 247.0,
    251.0, 252.0, 257.0, 258.0, 259.0, 262.0, 267.0, 268.0, 271.0, 272.0,
    270.0, 276.0, 281.0, 280.0, 285.0, 284.0, 289.0, 288.0, 293.0, 294.0, 294.0,
)

# Pauling electronegativities; 0.0 where undefined (He, Ne, Ar, …).
_PAULING_EN: Dict[str, float] = {
    "H": 2.20, "Li": 0.98, "Be": 1.57, "B": 2.04, "C": 2.55, "N": 3.04,
    "O": 3.44, "F": 3.98, "Na": 0.93, "Mg": 1.31, "Al": 1.61, "Si": 1.90,
    "P": 2.19, "S": 2.58, "Cl": 3.16, "K": 0.82, "Ca": 1.00, "Sc": 1.36,
    "Ti": 1.54, "V": 1.63, "Cr": 1.66, "Mn": 1.55, "Fe": 1.83, "Co": 1.88,
    "Ni": 1.91, "Cu": 1.90, "Zn": 1.65, "Ga": 1.81, "Ge": 2.01, "As": 2.18,
    "Se": 2.55, "Br": 2.96, "Kr": 3.00, "Rb": 0.82, "Sr": 0.95, "Y": 1.22,
    "Zr": 1.33, "Nb": 1.6, "Mo": 2.16, "Tc": 1.9, "Ru": 2.2, "Rh": 2.28,
    "Pd": 2.20, "Ag": 1.93, "Cd": 1.69, "In": 1.78, "Sn": 1.96, "Sb": 2.05,
    "Te": 2.1, "I": 2.66, "Xe": 2.60, "Cs": 0.79, "Ba": 0.89, "La": 1.10,
    "Ce": 1.12, "Pr": 1.13, "Nd": 1.14, "Pm": 1.13, "Sm": 1.17, "Eu": 1.2,
    "Gd": 1.20, "Tb": 1.1, "Dy": 1.22, "Ho": 1.23, "Er": 1.24, "Tm": 1.25,
    "Yb": 1.1, "Lu": 1.27, "Hf": 1.3, "Ta": 1.5, "W": 2.36, "Re": 1.9,
    "Os": 2.2, "Ir": 2.20, "Pt": 2.28, "Au": 2.54, "Hg": 2.00, "Tl": 1.62,
    "Pb": 2.33, "Bi": 2.02, "Po": 2.0, "At": 2.2, "Fr": 0.7, "Ra": 0.9,
    "Ac": 1.1, "Th": 1.3, "Pa": 1.5, "U": 1.38, "Np": 1.36, "Pu": 1.28,
    "Am": 1.3, "Cm": 1.3, "Bk": 1.3, "Cf": 1.3, "Es": 1.3, "Fm": 1.3,
    "Md": 1.3, "No": 1.3, "Lr": 1.3,
}

# Empirical (Slater) atomic radii in Å; calculated radii fill the gaps
# (H, noble gases, late actinides). 0.0 where nothing sensible exists.
_RADII: Dict[str, float] = {
    "H": 0.25, "He": 0.49, "Li": 1.45, "Be": 1.05, "B": 0.85, "C": 0.70,
    "N": 0.65, "O": 0.60, "F": 0.50, "Ne": 0.38, "Na": 1.80, "Mg": 1.50,
    "Al": 1.25, "Si": 1.10, "P": 1.00, "S": 1.00, "Cl": 1.00, "Ar": 0.71,
    "K": 2.20, "Ca": 1.80, "Sc": 1.60, "Ti": 1.40, "V": 1.35, "Cr": 1.40,
    "Mn": 1.40, "Fe": 1.40, "Co": 1.35, "Ni": 1.35, "Cu": 1.35, "Zn": 1.35,
    "Ga": 1.30, "Ge": 1.25, "As": 1.15, "Se": 1.15, "Br": 1.15, "Kr": 0.88,
    "Rb": 2.35, "Sr": 2.00, "Y": 1.80, "Zr": 1.55, "Nb": 1.45, "Mo": 1.45,
    "Tc": 1.35, "Ru": 1.30, "Rh": 1.35, "Pd": 1.40, "Ag": 1.60, "Cd": 1.55,
    "In": 1.55, "Sn": 1.45, "Sb": 1.45, "Te": 1.40, "I": 1.40, "Xe": 1.08,
    "Cs": 2.60, "Ba": 2.15, "La": 1.95, "Ce": 1.85, "Pr": 1.85, "Nd": 1.85,
    "Pm": 1.85, "Sm": 1.85, "Eu": 1.85, "Gd": 1.80, "Tb": 1.75, "Dy": 1.75,
    "Ho": 1.75, "Er": 1.75, "Tm": 1.75, "Yb": 1.75, "Lu": 1.75, "Hf": 1.55,
    "Ta": 1.45, "W": 1.35, "Re": 1.35, "Os": 1.30, "Ir": 1.35, "Pt": 1.35,
    "Au": 1.35, "Hg": 1.50, "Tl": 1.90, "Pb": 1.80, "Bi": 1.60, "Po": 1.90,
    "At": 1.27, "Rn": 1.20, "Fr": 2.60, "Ra": 2.15, "Ac": 1.95, "Th": 1.80,
    "Pa": 1.80, "U": 1.75, "Np": 1.75, "Pu": 1.75, "Am": 1.75, "Cm": 1.76,
}


class ElementProps(NamedTuple):
    z: int
    group: int
    period: int
    en: float
    mass: float
    radius: float


def _period_of(z: int) -> int:
    for period, hi in enumerate((2, 10, 18, 36, 54, 86, 118), start=1):
        if z <= hi:
            return period
    return 0


def _group_of(z: int) -> int:
    """IUPAC group 1-18; f-block elements report group 3 (pymatgen convention)."""
    if z == 1:
        return 1
    if z == 2:
        return 18
    if z <= 18:  # periods 2-3
        offset = z - 2 if z <= 10 else z - 10
        return offset if offset <= 2 else offset + 10
    if z <= 54:  # periods 4-5
        return (z - 18) if z <= 36 else (z - 36)
    if z <= 86:  # period 6; La-Lu → 3
        if 57 <= z <= 71:
            return 3
        return z - 54 if z < 57 else z - 68
    if 89 <= z <= 103:  # actinides → 3
        return 3
    return z - 86 if z < 89 else z - 100


@functools.lru_cache(maxsize=256)
def element_props(symbol: str) -> ElementProps:
    """Six per-site scalars: (Z, group, period, EN, mass, radius).

    Mirrors reference `_element_props` (fetch.py:69-96). Defers to pymatgen
    for exact parity when available; unknown symbols raise KeyError.
    """
    sym = _normalize(symbol)
    try:  # optional exact-parity path
        from pymatgen.core import Element  # type: ignore

        el = Element(sym)
        period = getattr(el, "period", None) or getattr(el, "row", 0)
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            en = float(getattr(el, "X", 0.0) or 0.0)
        radius = getattr(el, "covalent_radius", None)
        if radius is None:
            radius = getattr(el, "atomic_radius", None)
        if radius is None:
            radius = getattr(el, "atomic_radius_calculated", 0.0)
        return ElementProps(
            int(el.Z), int(getattr(el, "group", 0) or 0), int(period or 0),
            en, float(getattr(el, "atomic_mass", 0.0) or 0.0), float(radius or 0.0),
        )
    except ImportError:
        pass
    z = Z_OF[sym]
    return ElementProps(
        z=z,
        group=_group_of(z),
        period=_period_of(z),
        en=float(_PAULING_EN.get(sym, 0.0)),
        mass=float(_MASSES[z - 1]),
        radius=float(_RADII.get(sym, 0.0)),
    )


def _normalize(symbol: str) -> str:
    """Strip oxidation-state suffixes ('Fe2+' → 'Fe') and fix case."""
    core = "".join(ch for ch in symbol if ch.isalpha())
    if core in Z_OF:
        return core
    cap = core.capitalize()
    if cap in Z_OF:
        return cap
    raise KeyError(f"Unknown element symbol: {symbol!r}")
