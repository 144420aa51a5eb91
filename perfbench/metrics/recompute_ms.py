"""Device milliseconds a step inside the program's ``row_recompute``
ranges in the profiled steps: the rows the engines run again in the
backward (2PS's price for its memory).  Read from the capture the program
keeps while ``obs.profiling()`` runs (``repro_torch.obs.last_capture``:
each range's CUDA events, put on the host's clock), over the profiled
steps; nothing where the program keeps no capture or no such range."""


def read(run):
    if not run.profile:
        return None
    from repro_torch import obs
    last = getattr(obs, "last_capture", None)
    cap = last() if last else None
    ms = cap.device_ms("row_recompute") if cap else None
    return None if ms is None else ms / run.profile["steps"]
