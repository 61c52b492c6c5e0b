"""Device idle while the host's main thread was inside the model step
(``occ.step*`` and the ranges nested in it, but for the feed's), in ms per
step of the window (``idle.per_step_ms``)."""

from gnnbench import idle


def read(record):
    return idle.per_step_ms(record, "step")
