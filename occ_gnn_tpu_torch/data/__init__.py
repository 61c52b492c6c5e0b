from occ_gnn_tpu_torch.data.graph import Graph, from_edge_list
from occ_gnn_tpu_torch.data.binary_format import load_graph, read_meta, save_graph
from occ_gnn_tpu_torch.data.partition import edge_cut_fraction, partition_graph
from occ_gnn_tpu_torch.data.synthetic import block_graph, random_graph

__all__ = [
    "Graph",
    "from_edge_list",
    "save_graph",
    "load_graph",
    "read_meta",
    "partition_graph",
    "edge_cut_fraction",
    "random_graph",
    "block_graph",
]
