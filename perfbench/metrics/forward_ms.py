"""Mean per step of the forward (trunk through the plan's engine, head,
loss): CUDA events the benchmark records around the call in the traced
window."""


def read(run):
    ph = run.window.phase_ms
    return ph.get("forward") if ph else None
