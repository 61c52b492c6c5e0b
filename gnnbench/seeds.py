"""Sub-seeds of a run's ``--seed``: one independent stream for each thing
the benchmark makes, so that adding a stream changes no other."""

from __future__ import annotations

import numpy as np

STREAMS = ("graph", "weights", "program", "traffic")


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for ``stream`` (one of ``STREAMS``) of the run
    ``seed``, any whole number >= 0."""
    if seed < 0:
        raise ValueError(f"--seed must be >= 0, got {seed}")
    state = np.random.SeedSequence([seed, STREAMS.index(stream)])
    return int(state.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def program_seed(seed: int) -> int:
    """The seed handed to the port (its samplers' and draws' streams): 31
    bits, which every seed argument of the port takes."""
    return sub_seed(seed, "program") % (2**31 - 1)
