from occ_gnn_tpu_torch.models.gat import GATModel
from occ_gnn_tpu_torch.models.gcn import GCNModel
from occ_gnn_tpu_torch.models.sage import SAGEModel


def get_model(name: str, in_dim: int, hidden: int, num_classes: int,
              num_layers: int, **kw):
    """Model factory over the JAX package's names (gcn|sage|gat); ``kw``
    goes to the model (``num_heads`` for GAT, ``dropout``, ``generator``)."""
    name = name.lower()
    if name in ("sage", "graphsage"):
        return SAGEModel(in_dim, hidden, num_classes, num_layers, **kw)
    if name == "gcn":
        return GCNModel(in_dim, hidden, num_classes, num_layers, **kw)
    if name == "gat":
        return GATModel(in_dim, hidden, num_classes, num_layers, **kw)
    raise ValueError(f"unknown model: {name}")


__all__ = ["GATModel", "GCNModel", "SAGEModel", "get_model"]
