"""occ_gnn_tpu_torch — the PyTorch / CUDA port of occ_gnn_tpu for NVIDIA
Hopper (H100).

The JAX package beside it is the reference: each module here keeps the
name and layout of its JAX counterpart, and the tests hold the two
together. Every TPU kernel becomes a kernel written by hand for Hopper
under ``csrc/``, built with ``nvcc`` at its first launch; importing the
package builds and loads nothing.

Layer map (the slice ported so far: single-chip GraphSAGE training):

    train CLI            occ_gnn_tpu_torch.train
    training step        occ_gnn_tpu_torch.training
    models               occ_gnn_tpu_torch.models.sage
    padded block ops     occ_gnn_tpu_torch.ops.{blocks,segment}
    Hopper kernel        occ_gnn_tpu_torch.ops.segment_sum_sorted
                         (csrc/segment_sum_sorted.cu)
    sampler              occ_gnn_tpu_torch.sampling.neighbor
    dataset layer        occ_gnn_tpu_torch.data.{graph,binary_format,synthetic}
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
