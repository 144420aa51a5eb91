"""Device milliseconds a step inside the program's ``dwconv`` ranges in the
profiled steps: the depthwise convolutions' forward calls and their
gradients (ConvNeXt's 7x7), recomputed rows and halos included.  Read
from the capture the program keeps while ``obs.profiling()`` runs
(``repro_torch.obs.last_capture``: each range's CUDA events, put on the
host's clock); nothing where the program keeps no capture or opens no
such range."""


def device_ms(run):
    """The profiled steps' ``dwconv`` device milliseconds, or None."""
    if not run.profile:
        return None
    from repro_torch import obs
    last = getattr(obs, "last_capture", None)
    cap = last() if last else None
    return cap.device_ms("dwconv") if cap else None


def read(run):
    ms = device_ms(run)
    return None if ms is None else ms / run.profile["steps"]
