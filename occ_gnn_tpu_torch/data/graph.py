"""Host-side graph container (numpy; the port's own copy of the JAX
package's ``data/graph.py``, same fields and semantics).

The whole training graph lives on the host as a CSR over *in*-neighbors:
``indices[indptr[v]:indptr[v+1]]`` are the message sources for node ``v``
(messages flow neighbor -> node, the sampling direction of the OCC-GNN
reference's loaders). Nothing here touches torch: device placement happens
per batch in ``training.gather_features``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Graph:
    """Host-side graph with node data.

    Attributes:
      indptr:  int64[num_nodes + 1] CSR row pointers (in-neighbors).
      indices: int64[num_edges] CSR column indices (message sources).
      features: float32[num_nodes, feature_dim].
      labels: int32[num_nodes].
      num_classes: number of label classes.
      train_mask / val_mask / test_mask: bool[num_nodes] splits.
      partition_map: int32[num_nodes] node -> partition id, or None.
      true_feature_dim: the pre-padding feature width, set by
        ``pad_feature_dim``.
    """

    indptr: np.ndarray
    indices: np.ndarray
    features: np.ndarray
    labels: np.ndarray
    num_classes: int
    train_mask: np.ndarray | None = None
    val_mask: np.ndarray | None = None
    test_mask: np.ndarray | None = None
    partition_map: np.ndarray | None = None
    true_feature_dim: int | None = None

    def __post_init__(self):
        self.indptr = np.ascontiguousarray(self.indptr, dtype=np.int64)
        self.indices = np.ascontiguousarray(self.indices, dtype=np.int64)
        if not isinstance(self.features, np.memmap):
            # memmap'd features stay lazy (papers100M-scale ingest)
            self.features = np.ascontiguousarray(
                self.features, dtype=np.float32
            )
        self.labels = np.ascontiguousarray(self.labels, dtype=np.int32)
        if self.partition_map is not None:
            self.partition_map = np.ascontiguousarray(
                self.partition_map, dtype=np.int32
            )
        if self.indptr.ndim != 1 or self.indices.ndim != 1:
            raise ValueError("indptr and indices must be 1-D")
        if self.features.shape[0] != self.num_nodes:
            raise ValueError(f"features have {self.features.shape[0]} rows, "
                             f"graph has {self.num_nodes} nodes")
        if self.labels.shape != (self.num_nodes,):
            raise ValueError(f"labels shape {self.labels.shape} != "
                             f"({self.num_nodes},)")
        if int(self.indptr[0]) != 0 or int(self.indptr[-1]) != self.num_edges:
            raise ValueError("indptr must start at 0 and end at num_edges")

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return self.indices.shape[0]

    @property
    def feature_dim(self) -> int:
        return self.features.shape[1]

    def in_degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.indices,
                           minlength=self.num_nodes).astype(np.int64)

    def train_nodes(self) -> np.ndarray:
        if self.train_mask is None:
            return np.arange(self.num_nodes, dtype=np.int64)
        return np.nonzero(self.train_mask)[0].astype(np.int64)

    def default_masks(self, seed: int = 0) -> None:
        """80/10/10 random splits (the reference's utils.py semantics)."""
        rng = np.random.default_rng(seed)
        a = rng.random(self.num_nodes)
        self.train_mask = a < 0.80
        self.val_mask = (a >= 0.80) & (a < 0.90)
        self.test_mask = a >= 0.90

    def pad_feature_dim(self, multiple: int = 128) -> "Graph":
        """Zero-pad features so feature_dim is a multiple of ``multiple``.

        The zero columns are inert for the math: they add nothing to the
        matmuls and their weight rows get zero gradient. No-op if already
        aligned. Materializes features (not for mmap'd tables)."""
        H = self.feature_dim
        pad = (-H) % multiple
        if pad == 0:
            return self
        if isinstance(self.features, np.memmap):
            raise ValueError("cannot pad mmap'd features in place; pad at "
                             "conversion time instead")
        feats = np.zeros((self.num_nodes, H + pad), dtype=np.float32)
        feats[:, :H] = self.features
        return dataclasses.replace(
            self, features=feats,
            true_feature_dim=self.true_feature_dim or H,
        )


def from_edge_list(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    features: np.ndarray,
    labels: np.ndarray,
    num_classes: int,
) -> Graph:
    """Build an in-neighbor CSR graph from a (src -> dst) edge list."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.add.at(indptr, dst + 1, 1)
    indptr = np.cumsum(indptr)
    return Graph(
        indptr=indptr,
        indices=src,
        features=features,
        labels=labels,
        num_classes=num_classes,
    )
