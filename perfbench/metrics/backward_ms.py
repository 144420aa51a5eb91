"""Mean per step of the backward (``torch.autograd.grad`` through the
engine's custom backward): CUDA events the benchmark records around the
call in the traced window."""


def read(run):
    ph = run.window.phase_ms
    return ph.get("backward") if ph else None
