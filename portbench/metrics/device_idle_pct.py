"""One minus the union of the device's kernel and copy intervals over the
traced slice's wall time, in %."""


def read(ctx):
    tr = ctx["trace"]
    if tr.window_ns <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_ns / tr.window_ns)
