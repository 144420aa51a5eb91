"""``torch.cuda.max_memory_allocated()`` over the window, after a reset at
its start, in GiB."""


def read(run):
    if run.window.peak_bytes is None:
        return None
    return run.window.peak_bytes / 2**30
