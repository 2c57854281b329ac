"""The device an entry point runs on.

Every entry point of the port (``Decoder``, ``Coder``, ``Encoder``, the
``sim`` factories, the CLI) runs on the card unless the caller asks for
the CPU: its ``device`` defaults to ``"cuda"`` and goes through
:func:`resolve_device`, which raises on a machine without CUDA instead of
falling back to the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "cuda_index", "indexed", "resolve_device"]

#: the device of every entry point unless the caller names another
DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for a CUDA device on a machine
    without CUDA."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available; pass device=\"cpu\" for the CPU")
    return device


def cuda_index(device) -> int:
    """The index of CUDA ``device`` (the current device's when it names
    none); raises for any other device."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"expected a CUDA device, got {device}")
    return device.index if device.index is not None else torch.cuda.current_device()


def indexed(device) -> torch.device:
    """``device`` as a torch.device that names its index: a CUDA device
    without one as the current device, any other as it is."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
