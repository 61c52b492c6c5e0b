"""occ_gnn_tpu_torch — the PyTorch / CUDA port of occ_gnn_tpu for NVIDIA
Hopper (H100).

The JAX package beside it is the reference: each module here keeps the
name and layout of its JAX counterpart, and the tests hold the two
together. Every TPU kernel becomes a kernel written by hand for Hopper
under ``csrc/``, built with ``nvcc`` at its first launch; importing the
package builds and loads nothing.

Layer map (ported so far: split-parallel SAGE/GCN at one partition, and
single-chip GraphSAGE):

    train CLI            occ_gnn_tpu_torch.train (--mode split|single)
    split models, step   occ_gnn_tpu_torch.parallel.model
    split layer ops      occ_gnn_tpu_torch.parallel.split
    feature cache        occ_gnn_tpu_torch.cache.{feature_cache,autosize}
    split samplers       occ_gnn_tpu_torch.sampling.{native,slicer}
                         (csrc/occ_sampler.cpp, built with g++)
    single-chip step     occ_gnn_tpu_torch.training, models.sage
    padded block ops     occ_gnn_tpu_torch.ops.{blocks,segment}
    Hopper kernel        occ_gnn_tpu_torch.ops.segment_sum_sorted:
                         segment_sum_sorted and the fused gather,
                         gather_segment_sum (csrc/segment_sum_sorted.cu,
                         built with nvcc)
    host sampler         occ_gnn_tpu_torch.sampling.neighbor
    dataset layer        occ_gnn_tpu_torch.data.{graph,binary_format,synthetic}
    profile summary      occ_gnn_tpu_torch.utils.profile
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
