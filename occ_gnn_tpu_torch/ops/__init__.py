from occ_gnn_tpu_torch.ops.blocks import Block, SampledBatch
from occ_gnn_tpu_torch.ops.segment import (
    segment_mean,
    segment_sum,
    spmm_mean,
    spmm_sum,
    spmm_sym,
)
from occ_gnn_tpu_torch.ops.segment_sum_sorted import segment_sum_sorted

__all__ = [
    "Block",
    "SampledBatch",
    "segment_sum",
    "segment_mean",
    "segment_sum_sorted",
    "spmm_sum",
    "spmm_mean",
    "spmm_sym",
]
