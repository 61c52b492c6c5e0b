"""Device idle that no span of the program explains: the host's main
thread in a harness range (``gnnbench.*``) or in none, in ms per step of
the window (``idle.per_step_ms``)."""

from gnnbench import idle


def read(record):
    return idle.per_step_ms(record, "loop")
