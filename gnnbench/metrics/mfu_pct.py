"""The whole step's share of the card's f32 peak: the model's forward and
backward FLOPs on valid rows (``flops.step_flops``; the window's steps
times the mean of the set-up's counted steps, which draw from the same
traffic) over the traced window's seconds times the peak."""


def read(record):
    tr = record["trace"]
    if tr is None or tr.busy_s <= 0 or not record["flops"]:
        return None
    return 100.0 * record["flops"] / (tr.window_s * record["peak_flops"])
