"""Dataset converters to the binary graph format, without JAX.

    python -m occ_gnn_tpu_torch.data.convert edgelist --input edges.txt \\
        --name el --root ./data
    python -m occ_gnn_tpu_torch.data.convert synth --name synth8 --root ./data
    python -m occ_gnn_tpu_torch.data.convert ogb --name ogbn-arxiv --root ./data

The port's copy of the JAX package's converters and their command line
(``occ_gnn_tpu/data/convert.py:26-137``), built on the port's own
``from_edge_list``, ``block_graph``, ``partition_graph`` and
``save_graph``: the same arguments write the same files, which either
package's ``load_graph`` reads. ``edgelist`` reads a whitespace edge list
(``#`` comments) and draws features and labels from ``--seed``; ``synth``
writes a ``block_graph``. Both attach a partition map. ``ogb`` needs the
``ogb`` package and its dataset download; without the package it stops
with the JAX converter's message. Nothing here downloads anything else.
"""

from __future__ import annotations

import argparse

import numpy as np

from occ_gnn_tpu_torch.data.binary_format import save_graph
from occ_gnn_tpu_torch.data.graph import from_edge_list
from occ_gnn_tpu_torch.data.partition import partition_graph
from occ_gnn_tpu_torch.data.synthetic import block_graph

OGB_MISSING = ("ogb is not installed in this environment; use the "
               "'edgelist' or 'synth' converters, or install ogb where "
               "network access is available")


def convert_ogb(name: str, root: str, partitions: int, mode: str) -> str:
    try:
        from ogb.nodeproppred import NodePropPredDataset
    except ImportError as e:
        raise SystemExit(OGB_MISSING) from e
    ds = NodePropPredDataset(name=name)
    graph_data, labels = ds[0]
    num_nodes = int(graph_data["num_nodes"])
    src, dst = graph_data["edge_index"]
    feats = np.asarray(graph_data["node_feat"], dtype=np.float32)
    labels = np.asarray(labels).reshape(-1).astype(np.int32)
    labels = np.where(labels < 0, 0, labels)
    g = from_edge_list(src, dst, num_nodes, feats, labels,
                       int(labels.max()) + 1)
    split = ds.get_idx_split()
    for mask, key in (("train_mask", "train"), ("val_mask", "valid"),
                      ("test_mask", "test")):
        m = np.zeros(num_nodes, bool)
        m[split[key]] = True
        setattr(g, mask, m)
    partition_graph(g, partitions, mode=mode)
    return save_graph(g, root, name)


def convert_edgelist(path: str, root: str, name: str, partitions: int,
                     mode: str, feature_dim: int = 128,
                     num_classes: int = 16, seed: int = 0) -> str:
    """A SNAP-style whitespace edge list; features and labels are drawn
    from ``seed``."""
    edges = np.loadtxt(path, dtype=np.int64, comments="#")
    src, dst = edges[:, 0], edges[:, 1]
    num_nodes = int(max(src.max(), dst.max())) + 1
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((num_nodes, feature_dim)).astype(np.float32)
    labels = rng.integers(0, num_classes, num_nodes).astype(np.int32)
    g = from_edge_list(src, dst, num_nodes, feats, labels, num_classes)
    g.default_masks(seed)
    partition_graph(g, partitions, mode=mode)
    return save_graph(g, root, name)


def convert_synth(name: str, root: str, partitions: int, mode: str,
                  num_nodes: int = 100_000, num_blocks: int = 4,
                  avg_degree: int = 10, cross_fraction: float = 0.1,
                  feature_dim: int = 128, seed: int = 0) -> str:
    g = block_graph(num_nodes=num_nodes, num_blocks=num_blocks,
                    avg_degree=avg_degree, cross_fraction=cross_fraction,
                    feature_dim=feature_dim, seed=seed)
    partition_graph(g, partitions, mode=mode)
    return save_graph(g, root, name)


def main(argv=None):
    p = argparse.ArgumentParser("dataset converter")
    sub = p.add_subparsers(dest="cmd", required=True)
    po = sub.add_parser("ogb")
    po.add_argument("--name", required=True)
    pe = sub.add_parser("edgelist")
    pe.add_argument("--input", required=True)
    pe.add_argument("--name", required=True)
    pe.add_argument("--feature-dim", type=int, default=128)
    pe.add_argument("--num-classes", type=int, default=16)
    ps = sub.add_parser("synth")
    ps.add_argument("--name", required=True)
    ps.add_argument("--num-nodes", type=int, default=100_000)
    ps.add_argument("--num-blocks", type=int, default=4)
    ps.add_argument("--avg-degree", type=int, default=10)
    ps.add_argument("--cross-fraction", type=float, default=0.1)
    ps.add_argument("--feature-dim", type=int, default=128)
    for sp in (po, pe, ps):
        sp.add_argument("--root", default="./data")
        sp.add_argument("--partitions", type=int, default=4)
        sp.add_argument("--partition-mode", default="greedy")
    args = p.parse_args(argv)
    if args.cmd == "ogb":
        out = convert_ogb(args.name, args.root, args.partitions,
                          args.partition_mode)
    elif args.cmd == "edgelist":
        out = convert_edgelist(args.input, args.root, args.name,
                               args.partitions, args.partition_mode,
                               args.feature_dim, args.num_classes)
    else:
        out = convert_synth(args.name, args.root, args.partitions,
                            args.partition_mode, args.num_nodes,
                            args.num_blocks, args.avg_degree,
                            args.cross_fraction, args.feature_dim)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
