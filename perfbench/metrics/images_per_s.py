"""Images of every step completed in the window, over the window's seconds
(the host's clock, the window closed by a synchronise)."""


def read(run):
    return run.window.images / run.window.seconds
