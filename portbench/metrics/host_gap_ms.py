"""The mean, over the slice's calls, of the time inside a call (the
``portbench.call`` span: submit to synchronised) that no device activity
covers, in ms."""


def read(ctx):
    gaps = ctx["trace"].host_gap_ns("call")
    return sum(gaps) / len(gaps) / 1e6 if gaps else None
