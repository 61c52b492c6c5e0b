"""The device's idle time in the traced window, by the layer of the
program its host was in: ``trace.Trace.gaps`` names each idle stretch by
the innermost range on the main thread, and a range's name gives its
layer. The port's feed spans (``occ.feed.*``) are the C++ sampling
service's; the harness's own ranges (``gnnbench.*``) and no range at all
are the host loop's, idle that no span of the program explains; every
other range (``occ.step*``, the port's layer ranges, torch's own such as
``Optimizer.step#Adam.step``) is the model step's. The three layers' idle
sums to the window's."""

from __future__ import annotations

from gnnbench.trace import OUTSIDE

FEED, HARNESS = "occ.feed.", "gnnbench."
LAYERS = ("step", "feed", "loop")


def layer(name: str) -> str:
    """The layer of the range ``name``: ``step``, ``feed`` or ``loop``."""
    if name.startswith(FEED):
        return "feed"
    if name.startswith(HARNESS) or name == OUTSIDE:
        return "loop"
    return "step"


def per_step_ms(record, which: str):
    """The idle milliseconds of layer ``which``, per step of the window;
    None without a trace or a step."""
    tr, steps = record["trace"], record["steps"]
    if tr is None or not steps:
        return None
    return 1e3 * sum(s for name, s in tr.gaps.items()
                     if layer(name) == which) / steps
