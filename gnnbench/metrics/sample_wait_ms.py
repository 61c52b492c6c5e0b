"""Host time the loop waited for the next batch from the C++ sampling
service, mean per step of the window."""


def read(record):
    xs = record["sample_wait_s"]
    return 1e3 * sum(xs) / len(xs) if xs else None
