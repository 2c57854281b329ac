"""Operators: channel, packing, golden, decoders and the CUDA kernel wrapper."""
