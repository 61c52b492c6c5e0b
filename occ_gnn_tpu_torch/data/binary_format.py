"""On-disk binary dataset format with checksum validation.

The same files as the JAX package's ``data/binary_format.py``, so a graph
written by either package loads in the other:

    <root>/<name>/meta.txt              key=value metadata + checksums
    <root>/<name>/indptr.bin            int64[num_nodes+1]
    <root>/<name>/indices.bin           int64[num_edges]
    <root>/<name>/features.bin          float32[num_nodes * feature_dim]
    <root>/<name>/labels.bin            int32[num_nodes]
    <root>/<name>/partition_map.bin     int32[num_nodes]        (optional)
    <root>/<name>/{train,val,test}_mask.bin  uint8[num_nodes]   (optional)

Checksums are checked at load time so that converter and trainer can
never silently disagree about the bytes.
"""

from __future__ import annotations

import os

import numpy as np

from occ_gnn_tpu_torch.data.graph import Graph

_META = "meta.txt"
_INT_KEYS = ("num_nodes", "num_edges", "feature_dim", "num_classes",
             "csum_indptr", "csum_edges", "csum_labels", "csum_partition",
             "num_partitions")


def _csum_int(a: np.ndarray) -> int:
    # Sum in int64 with wraparound — cheap, order-independent, catches
    # truncation/reordering of id arrays.
    return int(np.sum(a.astype(np.int64, copy=False), dtype=np.int64))


def _csum_float(a: np.ndarray) -> float:
    return float(np.sum(a.astype(np.float64, copy=False)))


def save_graph(graph: Graph, root: str, name: str) -> str:
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    graph.indptr.tofile(os.path.join(d, "indptr.bin"))
    graph.indices.tofile(os.path.join(d, "indices.bin"))
    graph.features.tofile(os.path.join(d, "features.bin"))
    graph.labels.tofile(os.path.join(d, "labels.bin"))
    meta = {
        "num_nodes": graph.num_nodes,
        "num_edges": graph.num_edges,
        "feature_dim": graph.feature_dim,
        "num_classes": graph.num_classes,
        "csum_indptr": _csum_int(graph.indptr),
        "csum_edges": _csum_int(graph.indices),
        "csum_features": _csum_float(graph.features),
        "csum_labels": _csum_int(graph.labels),
    }
    if graph.partition_map is not None:
        graph.partition_map.tofile(os.path.join(d, "partition_map.bin"))
        meta["csum_partition"] = _csum_int(graph.partition_map)
        meta["num_partitions"] = int(graph.partition_map.max()) + 1
    if graph.train_mask is not None:
        for split in ("train", "val", "test"):
            mask = getattr(graph, f"{split}_mask")
            mask.astype(np.uint8).tofile(os.path.join(d, f"{split}_mask.bin"))
    with open(os.path.join(d, _META), "w") as fp:
        for k, v in meta.items():
            fp.write(f"{k}={v}\n")
    return d


def read_meta(root: str, name: str) -> dict:
    """Parse meta.txt into ints, the feature checksum as a float."""
    meta = {}
    with open(os.path.join(root, name, _META)) as fp:
        for line in fp:
            k, v = line.strip().split("=", 1)
            if k in _INT_KEYS:
                meta[k] = int(v)
            elif k == "csum_features":
                meta[k] = float(v)
            else:
                meta[k] = v
    return meta


def _check(ok: bool, what: str, d: str) -> None:
    if not ok:
        raise ValueError(f"{what} mismatch in {d}: the files are damaged or "
                         f"were written by another converter run")


def load_graph(root: str, name: str, validate: bool = True,
               mmap_features: bool = False) -> Graph:
    """``mmap_features=True`` maps features.bin instead of reading it into
    RAM — for tables larger than host memory, where each batch's gather
    touches only the rows it needs."""
    d = os.path.join(root, name)
    meta = read_meta(root, name)
    n, e = meta["num_nodes"], meta["num_edges"]
    indptr = np.fromfile(os.path.join(d, "indptr.bin"), dtype=np.int64)
    indices = np.fromfile(os.path.join(d, "indices.bin"), dtype=np.int64)
    if mmap_features:
        features = np.memmap(
            os.path.join(d, "features.bin"), dtype=np.float32, mode="r",
            shape=(n, meta["feature_dim"]),
        )
    else:
        features = np.fromfile(
            os.path.join(d, "features.bin"), dtype=np.float32
        ).reshape(n, meta["feature_dim"])
    labels = np.fromfile(os.path.join(d, "labels.bin"), dtype=np.int32)
    if validate:
        _check(indptr.shape[0] == n + 1, "indptr length", d)
        _check(indices.shape[0] == e, "indices length", d)
        _check(_csum_int(indptr) == meta["csum_indptr"], "indptr checksum", d)
        _check(_csum_int(indices) == meta["csum_edges"], "edge checksum", d)
        _check(_csum_int(labels) == meta["csum_labels"], "label checksum", d)
        if not mmap_features:
            got = _csum_float(features)
            _check(abs(got - meta["csum_features"])
                   <= 1e-3 * max(1.0, abs(got)), "feature checksum", d)
    g = Graph(
        indptr=indptr,
        indices=indices,
        features=features,
        labels=labels,
        num_classes=meta["num_classes"],
    )
    pm_path = os.path.join(d, "partition_map.bin")
    if os.path.exists(pm_path):
        pm = np.fromfile(pm_path, dtype=np.int32)
        if validate:
            _check(_csum_int(pm) == meta["csum_partition"],
                   "partition checksum", d)
        g.partition_map = pm
    if os.path.exists(os.path.join(d, "train_mask.bin")):
        for split in ("train", "val", "test"):
            mask = np.fromfile(os.path.join(d, f"{split}_mask.bin"),
                               dtype=np.uint8).astype(bool)
            setattr(g, f"{split}_mask", mask)
    return g
