"""The 90th percentile of the window's step times: each the gap between
CUDA events recorded at consecutive step ends (the first from the
window's start), with no synchronise inside the window."""

import statistics


def read(run):
    ms = run.window.step_ms
    if len(ms) < 2:
        return ms[0]
    return statistics.quantiles(ms, n=10, method="inclusive")[8]
