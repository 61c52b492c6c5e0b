"""The quiver baseline, as the port's ``train.train_quiver`` composes it
at one shard: ``sampling/device_sampler.DeviceSampleTrainer`` draws each
layer's neighbours on the device, gathers the deepest rows' means, and
runs the dense SAGE layers, the backward and Adam there. The window's
loop is ``DeviceSampleTrainer.train_epoch``'s: one ``step`` a batch, the
counts added up on the device and read once, when the window closes. The
batches are the benchmark's: each epoch a seeded permutation of the
training nodes cut into full batches."""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from gnnbench import flops, models
from gnnbench.drivers.common import (
    bitmap_count,
    first_moment_grad,
    load_weights,
    weights_now,
)
from gnnbench.reference.samples import judge_quiver


class QuiverProgram:
    buildables = ("device_sample",)
    builds_sampler = False

    def __init__(self, cfg, traffic, graph, weights, program_seed,
                 traffic_seed, device, ranks):
        from occ_gnn_tpu_torch.data.graph import Graph
        from occ_gnn_tpu_torch.sampling.device_sampler import (
            DeviceSampleTrainer,
        )

        if int(traffic["partitions"]) != 1 or ranks.world != 1:
            raise ValueError("the quiver driver runs one shard in one "
                             "process")
        if not traffic["drop_last"]:
            raise ValueError("the quiver driver hands the port full batches")
        self.cfg, self.device = cfg, torch.device(device)
        self.batch_size = int(traffic["batch_size"])
        self.fanouts = [int(f) for f in traffic["fanouts"]]
        g = Graph(indptr=graph.indptr, indices=graph.indices,
                  features=graph.features, labels=graph.labels,
                  num_classes=graph.num_classes, train_mask=graph.train_mask,
                  val_mask=graph.val_mask, test_mask=graph.test_mask)
        self.labels = graph.labels
        self.nodes = graph.train_nodes()
        self.num_nodes = g.num_nodes
        self.spec = models.load(cfg)
        dims = (g.feature_dim, int(cfg["hidden"]), g.num_classes,
                int(cfg["num_layers"]))
        self.model = self.spec.dense_model(
            cfg, dims, torch.Generator().manual_seed(0)).to(self.device)
        load_weights(self.model, weights)
        t = time.perf_counter()
        self.opt = torch.optim.Adam(self.model.parameters(),
                                    lr=float(cfg["lr"]))
        self.setup_s = {"optimizer_s": time.perf_counter() - t}
        t = time.perf_counter()
        self.drv = DeviceSampleTrainer(g, self.fanouts, self.batch_size,
                                       self.model, self.opt,
                                       seed=program_seed,
                                       dtype=torch.float32,
                                       device=self.device)
        self.setup_s["features_and_csr_s"] = time.perf_counter() - t
        self.rng = np.random.default_rng(traffic_seed)
        self.batches = self._epochs()
        self.total = None
        self.counting = False
        self.keep = False
        self.last = None
        self._counts: list = []
        self._frontiers = None
        sample = self.drv.sample

        def recorded(targets, local=0):
            self._frontiers = sample(targets, local)
            return self._frontiers

        # The benchmark's own observer of each step's frontiers, for the
        # checked steps' judge and the traced run's set-up counts.
        self.drv.sample = recorded
        self.widths = self.spec.widths(cfg)

    def _epochs(self):
        B = self.batch_size
        while True:
            order = self.nodes[self.rng.permutation(self.nodes.shape[0])]
            for i in range(0, order.shape[0] - B + 1, B):
                chunk = order[i:i + B]
                yield (chunk.astype(np.int32).reshape(1, B),
                       self.labels[chunk].astype(np.int32).reshape(1, B))

    def step(self):
        targets, labels = next(self.batches)
        t0 = time.perf_counter()
        with record_function("gnnbench.launch"):
            loss, c, t = self.drv.step(targets, labels)
        t1 = time.perf_counter()
        self.total = t if self.total is None else self.total + t
        frontiers, self._frontiers = self._frontiers, None
        if self.counting:
            with record_function("gnnbench.count"):
                self._counts.append(self._count(frontiers))
        self.last = (targets, labels, loss, frontiers) if self.keep else None
        return None, t1 - t0

    def finish(self) -> int:
        counted = 0 if self.total is None else int(self.total)
        self.total = None
        return counted

    def checked(self, n: int) -> dict:
        losses, samples, grad1 = [], [], None
        self.keep = True
        for i in range(n):
            self.step()
            targets, labels, loss, frontiers = self.last
            losses.append(float(loss))
            samples.append({"frontiers": [f.cpu() for f in frontiers],
                            "targets": torch.from_numpy(targets[0].copy()),
                            "labels": torch.from_numpy(labels[0].copy())})
            if i == 0:
                grad1 = first_moment_grad(self.model, self.opt)
        self.keep, self.last = False, None
        final = weights_now(self.model)
        self.finish()
        return {"losses": losses, "grad1": grad1, "final": final,
                "samples": samples}

    def _count(self, frontiers) -> torch.Tensor:
        """Each hop's frontier entries with a neighbour, then the deepest
        frontier's distinct rows, on the device."""
        indptr = self.drv.csr[0]
        live = [(indptr[f.long() + 1] > indptr[f.long()]).sum()
                for f in frontiers[:-1]]
        return torch.stack(live + [bitmap_count(frontiers[-1],
                                                self.num_nodes)])

    def _layers(self) -> list:
        """The dense layers' counts, innermost first: every row valid."""
        B, fo = self.batch_size, self.fanouts
        sizes = [B]
        for k in fo:
            sizes.append(sizes[-1] * (1 + k))
        out = []
        for i, (h_in, h_out) in enumerate(self.widths):
            m = len(fo) - 1 - i
            d, k = sizes[m], fo[m] + 1
            out.append(flops.LayerCounts(K=k, D=d, V=d * k, R=sizes[m + 1],
                                         S=sizes[m + 1], h_in=h_in,
                                         h_out=h_out))
        return out

    def counts(self) -> list:
        return [self._layers() for _ in self._counts]

    def kernel_bounds(self) -> list:
        """Each counted step's ``device_sample`` bound seconds."""
        if not self._counts:
            return []
        B, fo = self.batch_size, self.fanouts
        h = int(self.cfg["feature_dim"])
        out = []
        for row in torch.stack(self._counts).cpu().tolist():
            sizes, t = [B], 0.0
            for lvl, k in enumerate(fo):
                t += flops.draw_bound(sizes[-1], k, int(row[lvl]))
                sizes.append(sizes[-1] * (1 + k))
            t += flops.gather_mean_bound(sizes[-2], fo[-1], h, int(row[-1]))
            out.append({"device_sample": t})
        return out

    def judge(self, gi, samples, train_mask, graph_labels):
        found_all, refs, labels = {}, [], []
        for s in samples:
            found, r = judge_quiver(gi, s["frontiers"], s["targets"],
                                    self.fanouts)
            t = r.targets if r is not None else s["targets"].long().to(
                gi.indptr.device)
            found["target_not_training"] = int((~train_mask[t]).sum())
            found["label"] = int((s["labels"].to(t.device).long()
                                  != graph_labels[t].long()).sum())
            for k, v in found.items():
                found_all[k] = found_all.get(k, 0) + v
            refs.append(r)
            labels.append(graph_labels[t].long())
        return found_all, refs, labels

    def stats(self) -> dict:
        return {}

    def close(self):
        self.drv.sample = None
        del self.drv, self.opt, self.model


Program = QuiverProgram
