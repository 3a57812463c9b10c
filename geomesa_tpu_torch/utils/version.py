"""Version-skew detection.

Analog of the reference's distributed version check
(ProjectVersionIterator + GeoMesaDataStore.checkProjectVersion,
index/geotools/GeoMesaDataStore.scala:304-318): stores stamp the
framework version into their durable metadata at schema-create time;
on open, the recorded version is compared against the running package
and a mismatch warns (minor skew) or raises (major skew) — the single-
controller equivalent of client/server jar skew. The port's version
equals the JAX package's (``geomesa_tpu_torch.__version__``), so a root
written by either opens in the other."""

from __future__ import annotations

import warnings

from .. import __version__
from .metadata import MetadataCatalog, VERSION_KEY

__all__ = ["stamp_version", "check_version", "VersionMismatch"]


class VersionMismatch(RuntimeError):
    pass


def _parse(v: str) -> tuple[int, int]:
    parts = (v.split(".") + ["0", "0"])[:2]
    return int(parts[0]), int(parts[1])


def stamp_version(catalog: MetadataCatalog, type_name: str):
    catalog.insert(type_name, VERSION_KEY, __version__)


def check_version(catalog: MetadataCatalog, type_name: str,
                  strict: bool = False) -> str | None:
    """Compare recorded vs running version. Returns the recorded
    version (None if never stamped). Major skew raises; minor skew
    warns (or raises when strict)."""
    recorded = catalog.read(type_name, VERSION_KEY)
    if recorded is None:
        return None
    check_version_string(recorded, type_name, strict)
    return recorded


def check_version_string(recorded: str, type_name: str,
                         strict: bool = False):
    if recorded == __version__:
        return
    rmaj, rmin = _parse(recorded)
    cmaj, cmin = _parse(__version__)
    msg = (f"type {type_name!r} written by geomesa-tpu {recorded}, "
           f"running {__version__}")
    if rmaj != cmaj or strict:
        raise VersionMismatch(msg)
    if rmin != cmin:
        warnings.warn(msg, stacklevel=2)
