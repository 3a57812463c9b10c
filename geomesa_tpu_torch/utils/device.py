"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller names another
device; a missing card is an error, never a silent move to the CPU."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "cuda_index", "device_scope"]


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the store runs on the GPU unless the "
            "caller passes device='cpu' explicitly")
    return dev


def cuda_index(store) -> int | None:
    """The CUDA device index of a store's rows (None: on the host or a
    store without a device, such as a remote client). A store on
    ``cuda`` without an index holds its tensors on the current device
    of the thread that built it: call this on that thread."""
    dev = getattr(store, "device", None)
    if getattr(dev, "type", None) != "cuda":
        return None
    if dev.index is not None:
        return dev.index
    return torch.cuda.current_device()


def device_scope(index: int | None):
    """``index`` (from ``cuda_index``) as this thread's current CUDA
    device; torch keeps the current device per thread and a new thread
    starts on device 0. A no-op for None."""
    if index is None:
        return contextlib.nullcontext()
    return torch.cuda.device(index)
