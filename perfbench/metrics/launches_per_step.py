"""Kernels launched a step: the device kernels in the profiled steps that
follow the traced window, over their number."""


def read(run):
    p = run.profile
    return p["launches"] / p["steps"] if p else None
