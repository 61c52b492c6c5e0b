from occ_gnn_tpu_torch.models.sage import SAGEModel


def get_model(name: str, in_dim: int, hidden: int, num_classes: int,
              num_layers: int, **kw):
    """Model factory over the JAX package's names (gcn|sage|gat)."""
    name = name.lower()
    if name in ("sage", "graphsage"):
        return SAGEModel(in_dim, hidden, num_classes, num_layers, **kw)
    if name in ("gcn", "gat"):
        raise NotImplementedError(
            f"model {name!r} is not ported yet: single-chip GCN/GAT are "
            f"ROADMAP.md queue 1 item 9, split GAT item 8")
    raise ValueError(f"unknown model: {name}")


__all__ = ["SAGEModel", "get_model"]
