"""The device an entry point runs on.

Every entry point of the port (``Decoder``, ``Coder``, ``Encoder``, the
``sim`` factories, the CLI) runs on the card unless the caller asks for
the CPU: its ``device`` defaults to ``"cuda"`` and goes through
:func:`resolve_device`, which raises on a machine without CUDA instead of
falling back to the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

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
