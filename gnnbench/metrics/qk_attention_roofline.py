"""``qk_attention``'s kernels' share of their roofline over the window:
the least time their calls could take on the card (``models/unimp.py``'s
``qk_attention_bound``: each call's bytes over the memory rate or its
operations over the f32 rate; the window's steps times the mean of the
set-up's counted steps) over their device time in the trace. The
kernels' names (``qk_attn_fwd*``, ``qk_attn_bwd*``, staged and ``_any``)
are matched here."""

FAMILY = "qk_attention"
NEEDLES = ("qk_attn_fwd", "qk_attn_bwd")


def read(record):
    bound = record["kernel_bound_s"].get(FAMILY)
    tr = record["trace"]
    if not bound or tr is None:
        return None
    seconds, calls = tr.op_seconds(*NEEDLES)
    if not calls or seconds <= 0:
        return None
    return 100.0 * bound / seconds
