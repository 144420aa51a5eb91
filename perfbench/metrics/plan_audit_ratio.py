"""The window's peak device memory over the plan's estimate (the
planner's Eqs. 7-16 with the paper's xi; per device where the plan gives
one)."""


def read(run):
    est = run.plan.est_bytes_per_device or run.plan.est_bytes
    if run.window.peak_bytes is None or not est:
        return None
    return run.window.peak_bytes / est
