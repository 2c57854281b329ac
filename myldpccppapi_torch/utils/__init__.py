"""Configs, profiling/metrics, and small host utilities."""
from .config import DecoderConfig, RunConfig
from .profiling import PhaseTimer, emit_metrics, iterations_histogram, recording, span, trace

__all__ = [
    "DecoderConfig",
    "PhaseTimer",
    "RunConfig",
    "emit_metrics",
    "iterations_histogram",
    "recording",
    "span",
    "trace",
]
