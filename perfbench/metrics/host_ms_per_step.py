"""The host's clock from a step's start to the return of its last call,
with no synchronise, as a mean over the traced window's steps.  Where the
device is behind, a full launch queue makes the host wait, and the wait
counts."""


def read(run):
    h = run.window.host_ms
    return sum(h) / len(h) if h else None
