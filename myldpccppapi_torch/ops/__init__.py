"""Operators: channel, modulation, packing, golden, the BP decoders (torch
path, edge list, learned weights), bit flipping, the error-impulse probe
and the CUDA kernel wrappers."""
from . import (bitflip, bp, bp_edgelist, channel, golden, impulse,
               modulation, packing)

__all__ = ["bitflip", "bp", "bp_edgelist", "channel", "golden", "impulse",
           "modulation", "packing"]
