"""The long-code kernels' launches per call in the traced slice: the port's
counters ``decode_qc_long.launches + decode_qc_long.global_launches``,
read around each call."""


def read(ctx):
    calls = len(ctx["slice_sets"])
    return ctx["slice_launches"] / calls if calls else None
