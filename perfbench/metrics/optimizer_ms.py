"""Device milliseconds a step inside the program's ``sgd_update`` range
(``optim/adamw.py``: the whole SGD update over every leaf) in the
profiled steps, from the capture the program keeps while
``obs.profiling()`` runs (``repro_torch.obs.last_capture``), over the
profiled steps; nothing where the program keeps no capture or no such
range."""


def read(run):
    if not run.profile:
        return None
    from repro_torch import obs
    last = getattr(obs, "last_capture", None)
    cap = last() if last else None
    ms = cap.device_ms("sgd_update") if cap else None
    return None if ms is None else ms / run.profile["steps"]
