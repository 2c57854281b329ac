"""Arithmetic that more than one per-layer metric reader uses."""
from __future__ import annotations

from portbench import roofline

__all__ = ["kernel_roofline_pct"]


def kernel_roofline_pct(ctx: dict, kernel: str):
    """The slice's least decode time over the device time of ``kernel``'s
    launches in the slice, in %; None without the kernel's launches, the
    reference's sweeps or the card's peaks."""
    tr, peaks, code = ctx["trace"], ctx["peaks"], ctx["code"]
    spent = tr.kernel_ns(kernel) / 1e9
    if spent <= 0 or peaks is None or not ctx["slice_sets"]:
        return None
    least = sum(roofline.least_seconds(
        roofline.decode_ops(code["edges"], ctx["ref_sweeps"][s]),
        roofline.decode_bytes(code["n"], code["batch"]), peaks)
        for s in ctx["slice_sets"])
    return 100.0 * least / spent
