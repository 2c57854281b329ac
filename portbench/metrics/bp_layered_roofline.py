"""Kernel A's port's share of its roofline (``csrc/bp_layered.cu``): the least
time of the traced slice's decodes (``portbench/roofline.py``, from the
reference's sweeps of the slice's realizations) over the summed device time
of the kernel's launches in the slice, in %."""
from portbench.metrics_common import kernel_roofline_pct


def read(ctx):
    return kernel_roofline_pct(ctx, "bp_layered_kernel")
