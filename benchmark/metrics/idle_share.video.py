"""The share of the traced window with no operation on the device (the
union of the profiler's device intervals), %."""


def read(run):
    t = run.trace_summary
    if t is None or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
