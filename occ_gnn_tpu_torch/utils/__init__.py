from occ_gnn_tpu_torch.utils.timers import PhaseTimers

__all__ = ["PhaseTimers"]
