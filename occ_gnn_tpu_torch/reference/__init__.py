"""Plain references of the port's models: their equations in plain
``torch`` over sampled slot lists, with no kernel, cache or batching of
the port, which tests hold the port's models to."""
