"""Feature validators (geomesa-convert SimpleFeatureValidator analog):
post-transform checks that drop invalid features as failures instead of
ingesting them. Configured via converter options:

    {"options": {"validators": ["has-geo", "has-dtg"]}}
"""

from __future__ import annotations

from typing import Callable

from ..features.sft import SimpleFeatureType

__all__ = ["build_validators", "validate"]


def _has_geo(sft: SimpleFeatureType) -> Callable[[dict], str | None]:
    geom = sft.geom_field

    def check(values: dict) -> str | None:
        if geom is None or values.get(geom) is None:
            return "null geometry"
        return None
    return check


def _has_dtg(sft: SimpleFeatureType) -> Callable[[dict], str | None]:
    dtg = sft.dtg_field

    def check(values: dict) -> str | None:
        if dtg is None or values.get(dtg) is None:
            return "null date"
        return None
    return check


def _bounds_geo(sft: SimpleFeatureType) -> Callable[[dict], str | None]:
    """Geometry inside the whole world (the 'index' validator's bounds
    check — z-indexing needs lon/lat in range)."""
    geom = sft.geom_field

    def check(values: dict) -> str | None:
        g = values.get(geom) if geom else None
        if g is None:
            return None  # has-geo handles nullness
        e = g.envelope
        if not (-180.0 <= e.xmin <= e.xmax <= 180.0
                and -90.0 <= e.ymin <= e.ymax <= 90.0):
            return "geometry out of bounds"
        return None
    return check


_REGISTRY = {
    "has-geo": _has_geo,
    "has-dtg": _has_dtg,
    "index": lambda sft: _composite([_has_geo(sft), _has_dtg(sft),
                                     _bounds_geo(sft)]),
    "bounds-geo": _bounds_geo,
    "none": lambda sft: (lambda values: None),
}


def _composite(checks):
    def check(values):
        for c in checks:
            err = c(values)
            if err:
                return err
        return None
    return check


def build_validators(names, sft: SimpleFeatureType):
    checks = []
    for n in names:
        if n not in _REGISTRY:
            raise ValueError(f"unknown validator {n!r} "
                             f"(have {sorted(_REGISTRY)})")
        checks.append(_REGISTRY[n](sft))
    return checks


def validate(checks, values: dict) -> str | None:
    """First error message, or None if the feature passes."""
    for c in checks:
        err = c(values)
        if err:
            return err
    return None
