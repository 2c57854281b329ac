"""Configuration objects."""
from .config import DecoderConfig

__all__ = ["DecoderConfig"]
