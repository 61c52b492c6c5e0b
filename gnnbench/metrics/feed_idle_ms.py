"""Device idle while the host's main thread was in the C++ sampling
service's feed (``occ.feed.*``: its wait, copy, upload, cache tail and
submit), in ms per step of the window (``idle.per_step_ms``)."""

from gnnbench import idle


def read(record):
    return idle.per_step_ms(record, "feed")
