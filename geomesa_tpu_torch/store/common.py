"""Shared store-layer helpers."""

from __future__ import annotations

import numpy as np

__all__ = ["sort_order"]


def sort_order(batch, sort_by: str, sort_desc: bool = False,
               idx: np.ndarray | None = None,
               hidden: np.ndarray | None = None) -> np.ndarray:
    """Stable argsort of a batch's rows (or the row subset ``idx``) by an
    attribute column — the SortingSimpleFeatureIterator analog
    (reference utils/iterators/SortingSimpleFeatureIterator:22). Returns
    positions into ``idx`` (or into the batch when ``idx`` is None).

    ``hidden`` (aligned with idx) marks rows whose sort value the
    caller is not authorized to see: they sort as NULL (last), so the
    returned order cannot leak hidden values."""
    col = batch.col(sort_by)
    keys = getattr(col, "values", None)
    if keys is None:
        keys = getattr(col, "millis", None)
    if keys is None:
        codes = getattr(col, "codes", None)
        if codes is not None:
            # dictionary-encoded strings: the vocab is sorted, so code
            # order IS lexicographic order; nulls (-1) sort last
            keys = np.where(codes < 0, np.iinfo(codes.dtype).max, codes)
    if keys is None:
        raise ValueError(f"cannot sort by {sort_by}")
    if idx is not None:
        keys = keys[idx]
    if hidden is not None and hidden.any():
        keys = np.where(hidden, np.inf if keys.dtype.kind == "f"
                        else np.iinfo(keys.dtype).max, keys)
        # ints saturate rather than NaN; ties among hidden rows keep
        # the stable (scan) order, revealing nothing
    order = np.argsort(keys, kind="stable")
    if sort_desc:
        order = order[::-1]
    return order
