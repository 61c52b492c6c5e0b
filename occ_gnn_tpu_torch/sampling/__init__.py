from occ_gnn_tpu_torch.sampling.neighbor import (
    NeighborSampler,
    measure_capacities,
    plan_capacities,
)

__all__ = ["NeighborSampler", "plan_capacities", "measure_capacities"]
