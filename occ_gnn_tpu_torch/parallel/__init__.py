from occ_gnn_tpu_torch.parallel.model import (
    SplitGCN,
    SplitSAGE,
    make_device_csr,
    make_split_forward,
    make_split_train_step,
)
from occ_gnn_tpu_torch.parallel.split import (
    SplitBatch,
    SplitLayer,
    shuffle_merge,
)

__all__ = [
    "SplitBatch",
    "SplitLayer",
    "SplitSAGE",
    "SplitGCN",
    "make_device_csr",
    "make_split_forward",
    "make_split_train_step",
    "shuffle_merge",
]
