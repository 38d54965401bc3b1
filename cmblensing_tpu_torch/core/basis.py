"""Basis system for flat-sky fields.

The reference (src/generic.jl:43-103) encodes bases as a tree of Julia
types (Map/Fourier x I/QU/EB with Basis2Prod/Basis3Prod). Here a basis
is a hashable frozen dataclass carried as *static* pytree metadata, so
basis dispatch resolves at trace time and costs nothing inside jit.

A basis is (pol, space):
  pol   in {"I", "QU", "EB", "IQU", "IEB"}
  space in {"map", "fourier"}

Functional bases (reference src/generic.jl:88-98):
  lense_basis    — basis in which lensing is a pixel remapping (QU map)
  deriv_basis    — basis in which derivatives are diagonal (QU fourier)
  harmonic_basis — nearest harmonic basis (EB stays EB)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class Basis:
    pol: str    # "I", "QU", "EB", "IQU", "IEB"
    space: str  # "map" or "fourier"

    @property
    def ncomp(self) -> int:
        return {"I": 1, "QU": 2, "EB": 2, "IQU": 3, "IEB": 3}[self.pol]

    @property
    def spin(self):
        # (0,), (2,), or (0, 2)
        return {"I": (0,), "QU": (2,), "EB": (2,), "IQU": (0, 2), "IEB": (0, 2)}[self.pol]

    @property
    def is_map(self) -> bool:
        return self.space == "map"

    @property
    def is_fourier(self) -> bool:
        return self.space == "fourier"

    def with_space(self, space: str) -> "Basis":
        return dataclasses.replace(self, space=space)

    def with_pol(self, pol: str) -> "Basis":
        return dataclasses.replace(self, pol=pol)

    def __repr__(self):
        names = {
            ("I", "map"): "Map", ("I", "fourier"): "Fourier",
            ("QU", "map"): "QUMap", ("QU", "fourier"): "QUFourier",
            ("EB", "map"): "EBMap", ("EB", "fourier"): "EBFourier",
            ("IQU", "map"): "IQUMap", ("IQU", "fourier"): "IQUFourier",
            ("IEB", "map"): "IEBMap", ("IEB", "fourier"): "IEBFourier",
        }
        return names[(self.pol, self.space)]


MAP = Basis("I", "map")
FOURIER = Basis("I", "fourier")
QU_MAP = Basis("QU", "map")
QU_FOURIER = Basis("QU", "fourier")
EB_MAP = Basis("EB", "map")
EB_FOURIER = Basis("EB", "fourier")
IQU_MAP = Basis("IQU", "map")
IQU_FOURIER = Basis("IQU", "fourier")
IEB_MAP = Basis("IEB", "map")
IEB_FOURIER = Basis("IEB", "fourier")

ALL_BASES = [MAP, FOURIER, QU_MAP, QU_FOURIER, EB_MAP, EB_FOURIER,
             IQU_MAP, IQU_FOURIER, IEB_MAP, IEB_FOURIER]


def lense_basis(b: Basis) -> Basis:
    """Basis in which lensing acts pixelwise (reference src/generic.jl:88-90)."""
    return {"I": MAP, "QU": QU_MAP, "EB": QU_MAP,
            "IQU": IQU_MAP, "IEB": IQU_MAP}[b.pol]


def deriv_basis(b: Basis) -> Basis:
    """Basis in which derivative operators are diagonal (src/generic.jl:91-93)."""
    return {"I": FOURIER, "QU": QU_FOURIER, "EB": QU_FOURIER,
            "IQU": IQU_FOURIER, "IEB": IQU_FOURIER}[b.pol]


def harmonic_basis(b: Basis) -> Basis:
    """Nearest harmonic basis (src/generic.jl:94-98)."""
    return b.with_space("fourier")


# generic promotion rules for algebra between fields of unlike bases
# (reference src/generic.jl:185-202)
_PROMOTION = {
    frozenset([("I", "map"), ("I", "fourier")]): MAP,
    frozenset([("QU", "map"), ("QU", "fourier")]): QU_MAP,
    frozenset([("EB", "map"), ("EB", "fourier")]): EB_FOURIER,
    frozenset([("QU", "map"), ("EB", "map")]): QU_MAP,
    frozenset([("QU", "fourier"), ("EB", "fourier")]): QU_FOURIER,
    frozenset([("QU", "map"), ("EB", "fourier")]): QU_MAP,
    frozenset([("QU", "fourier"), ("EB", "map")]): QU_FOURIER,
    frozenset([("IQU", "map"), ("IQU", "fourier")]): IQU_MAP,
    frozenset([("IEB", "map"), ("IEB", "fourier")]): IEB_FOURIER,
    frozenset([("IQU", "map"), ("IEB", "map")]): IQU_MAP,
    frozenset([("IQU", "fourier"), ("IEB", "fourier")]): IQU_FOURIER,
    frozenset([("IQU", "map"), ("IEB", "fourier")]): IQU_MAP,
    frozenset([("IQU", "fourier"), ("IEB", "map")]): IQU_FOURIER,
}


def promote_basis(b1: Basis, b2: Basis) -> Basis:
    if b1 == b2:
        return b1
    key = frozenset([(b1.pol, b1.space), (b2.pol, b2.space)])
    try:
        return _PROMOTION[key]
    except KeyError:
        raise ValueError(f"Can't promote fields in {b1} and {b2} bases.") from None
