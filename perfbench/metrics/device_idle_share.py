"""The share of the profiled steps' window in which no operation ran on the
device (kernels, copies, sets), from the profiler's trace."""


def read(run):
    p = run.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
