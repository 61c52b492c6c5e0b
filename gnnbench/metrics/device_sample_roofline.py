"""``device_sample``'s kernels' share of their roofline over the window: the
least time their calls could take on the card (``flops``: each call's
bytes over the memory rate or its operations over the f32 rate; the
window's steps times the mean of the set-up's counted steps) over their
device time in the trace."""

FAMILY = "device_sample"


def read(record):
    bound = record["kernel_bound_s"].get(FAMILY)
    seconds, calls = record["trace"].op_seconds(*record["kernels"][FAMILY])
    if not bound or not calls or seconds <= 0:
        return None
    return 100.0 * bound / seconds
