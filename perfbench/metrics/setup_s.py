"""Seconds from the process's start to the first timed step: imports, the
kernels' build on a checkout's first run, weights, batches, plan, the
checked and warm steps."""


def read(run):
    return run.setup_s
