"""The plain reference that decides ``correct``: the models' equations in
plain PyTorch over a step's sampled computation graph (``samples.Refs``),
their loss, gradients and Adam, and the judge of the port's samples as
samples of the benchmark's graph. It imports nothing of the port and
takes nothing the port made but the outputs it judges."""
