"""The C++ sampling service's worker time sampling a batch, mean over the
batches it made during the window (the service's own counters,
``NativeSplitSampler.stats``)."""


def read(record):
    st = record["stats"]
    if not st.get("cxx_samples"):
        return None
    return 1e3 * st["cxx_sample_s"] / st["cxx_samples"]
