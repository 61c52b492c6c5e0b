from occ_gnn_tpu_torch.cache.autosize import (
    auto_cache_percentage,
    hbm_budget_bytes,
    resolve_cache_percentage,
)
from occ_gnn_tpu_torch.cache.feature_cache import (
    CachePlan,
    SingleChipCache,
    SplitFeatureCache,
)

__all__ = [
    "CachePlan",
    "SingleChipCache",
    "SplitFeatureCache",
    "auto_cache_percentage",
    "hbm_budget_bytes",
    "resolve_cache_percentage",
]
