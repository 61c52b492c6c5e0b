"""Split-parallel training, as the port's ``train.train_split`` composes
it at one partition: the C++ sampling service (``sampling/native.
NativeSplitSampler``) over a fully replicated feature cache
(``cache/feature_cache.SplitFeatureCache``), the first layer synthesised
on the device from a resident CSR, and ``parallel/model.
make_split_train_step`` with Adam. The window's loop is the trainer's
lag-1 pipeline: take the next batch, read the step before's counts, then
launch the step."""

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
from gnnbench.reference.samples import judge_split

KERNELS = ("dense_gather_sum", "gat_attention", "device_sample")


class SplitProgram:
    buildables = KERNELS
    builds_sampler = True

    def __init__(self, cfg, traffic, graph, weights, program_seed,
                 traffic_seed, device, ranks):
        t = time.perf_counter()
        self.setup_s = {}
        from occ_gnn_tpu_torch.cache import CachePlan, SplitFeatureCache
        from occ_gnn_tpu_torch.cache.autosize import resolve_cache_percentage
        from occ_gnn_tpu_torch.data.graph import Graph
        from occ_gnn_tpu_torch.parallel import dist
        from occ_gnn_tpu_torch.parallel.model import (
            make_device_csr,
            make_split_train_step,
        )
        from occ_gnn_tpu_torch.sampling.native import NativeSplitSampler
        from occ_gnn_tpu_torch.sampling.slicer import plan_split_capacities

        t = self._lap("port_imports_s", t)
        if int(traffic["partitions"]) != 1 or ranks.world != 1:
            raise ValueError("the split driver runs one partition in one "
                             "process")
        self.cfg, self.device = cfg, torch.device(device)
        self.batch_size = int(traffic["batch_size"])
        self.fanouts = [int(f) for f in traffic["fanouts"]]
        g = Graph(indptr=graph.indptr, indices=graph.indices,
                  features=graph.features, labels=graph.labels,
                  num_classes=graph.num_classes, train_mask=graph.train_mask,
                  val_mask=graph.val_mask, test_mask=graph.test_mask)
        self.num_nodes = g.num_nodes
        pmap = np.zeros(g.num_nodes, dtype=np.int32)
        caps = plan_split_capacities(self.batch_size, self.fanouts,
                                     g.num_nodes, 1)
        pct = resolve_cache_percentage(
            traffic["cache_per"], g, pmap, 1, dtype_bytes=4,
            refresh_cap=caps["frame_caps"][0], device=self.device)
        t = self._lap("graph_and_caps_s", t)
        plan = CachePlan(g, pmap, 1, pct, refresh_cap=caps["frame_caps"][0])
        t = self._lap("cache_plan_s", t)
        if traffic["innermost"] == "device" and not plan.replicated:
            raise RuntimeError(f"the cache came out at {pct:.4f} of the "
                               "graph, not replicated: the device-sampled "
                               "first layer needs it whole")
        self.cache = SplitFeatureCache(plan, dtype=torch.float32,
                                       device=self.device, partitions=(0, 1))
        t = self._lap("cache_fill_s", t)
        self.csr = make_device_csr(g, self.device)
        t = self._lap("csr_s", t)
        dims = (g.feature_dim, int(cfg["hidden"]), g.num_classes,
                len(self.fanouts))
        if int(cfg["num_layers"]) != len(self.fanouts):
            raise ValueError("one fan-out a layer")
        self.spec = models.load(cfg)
        self.model = self.spec.split_model(
            cfg, dims, torch.Generator().manual_seed(0)).to(self.device)
        load_weights(self.model, weights)
        self.sampler = NativeSplitSampler(
            g, g.train_nodes(), pmap, 1, self.fanouts, self.batch_size,
            capacities=dict(caps), seed=program_seed,
            drop_last=bool(traffic["drop_last"]), cache=self.cache,
            num_workers=int(traffic["num_workers"]), replace=True,
            innermost=traffic["innermost"], emit_range=(0, 1),
            scatter_plans=self.model.needs_scatter_plans,
            device=self.device)
        t = self._lap("model_and_sampler_s", t)
        self.opt = torch.optim.Adam(self.model.parameters(),
                                    lr=float(cfg["lr"]))
        t = self._lap("optimizer_s", t)
        ranks = dist.single_process(1, self.device)
        self.step_fn = make_split_train_step(self.model, self.opt,
                                             csr=self.csr, ranks=ranks)
        self.gens = [torch.Generator(self.device).manual_seed(
            dist.rank_seed(program_seed ^ 0xD0C5, 0))]
        self.batches = self._epochs()
        self.pending = None
        self.counted = 0
        self.counting = False
        self.keep = False
        self.last = None
        self._counts: list = []
        self._parts = None
        forward = self.model.forward_partitions

        def recorded(parts, xs, generator=None):
            self._parts = parts
            return forward(parts, xs, generator)

        # The benchmark's own observer of the layers each step ran
        # (with the device-synthesised first layer), for the checked
        # steps' judge and the traced run's set-up counts.
        self.model.forward_partitions = recorded
        self.widths = self.spec.widths(cfg)

    def _lap(self, name: str, t: float) -> float:
        now = time.perf_counter()
        self.setup_s[name] = now - t
        return now

    def _epochs(self):
        while True:
            yield from self.sampler

    def step(self):
        t0 = time.perf_counter()
        with record_function("gnnbench.sample_wait"):
            batch = next(self.batches)
        t1 = time.perf_counter()
        if self.pending is not None:
            with record_function("gnnbench.read_counts"):
                self._read(self.pending)
        t2 = time.perf_counter()
        with record_function("gnnbench.launch"):
            loss, c, t = self.step_fn(batch, self.cache.frames,
                                      sample_generator=self.gens)
        t3 = time.perf_counter()
        self.pending = (c, t)
        parts, self._parts = self._parts, None
        if self.counting:
            with record_function("gnnbench.count"):
                self._counts.append(self._count(parts))
        self.last = (batch, loss, parts) if self.keep else None
        return t1 - t0, t3 - t2

    def _read(self, pending):
        c, t = pending
        int(c)
        self.counted += int(t)

    def finish(self) -> int:
        if self.pending is not None:
            self._read(self.pending)
            self.pending = None
        counted, self.counted = self.counted, 0
        return counted

    def checked(self, n: int) -> dict:
        losses, samples, grad1 = [], [], None
        self.keep = True
        for i in range(n):
            self.step()
            batch, loss, parts = self.last
            losses.append(float(loss))
            samples.append(self._sample(parts, batch))
            if i == 0:
                grad1 = first_moment_grad(self.model, self.opt)
        self.keep, self.last = False, None
        final = weights_now(self.model)
        self.finish()
        return {"losses": losses, "grad1": grad1, "final": final,
                "samples": samples}

    def _sample(self, parts, batch) -> dict:
        """The step's layers in global ids, on the host: for each layer,
        innermost first, its nodes and their slots (-1 empty)."""
        layers = []
        in_global = None
        for lyr in parts[0]:
            src_cap = lyr.src_cap
            if in_global is None:
                in_global = torch.arange(src_cap, device=self.device)
                in_global[src_cap - 1] = -1
            if in_global.numel() != src_cap:
                raise RuntimeError(f"a layer of {src_cap} input rows follows "
                                   f"one of {in_global.numel()} outputs")
            valid = lyr.owned_mask.bool()
            nodes = in_global[lyr.self_idx[valid].long()]
            cols = lyr.owned_idx[valid].long()
            rows = lyr.nbr_idx[:, cols].t().long()
            slots = torch.where(rows == src_cap - 1, -1, in_global[rows])
            out = torch.full((valid.numel(),), -1, dtype=torch.int64,
                             device=self.device)
            out[valid] = nodes
            layers.append((nodes.cpu(), slots.cpu()))
            in_global = out
        last = parts[0][-1]
        valid = last.owned_mask.bool()
        return {"layers": layers,
                "labels": batch.labels[0][valid].cpu(),
                "targets": batch.target_nodes[0][valid].cpu()}

    def _count(self, parts) -> torch.Tensor:
        """``[layers, 4]``: D, V, R, S of each layer of the step, on the
        device."""
        rows = []
        prev_d = None
        for lyr in parts[0]:
            pad = lyr.src_cap - 1
            d = lyr.owned_mask.sum()
            v = (lyr.nbr_idx != pad).sum()
            r = bitmap_count(lyr.nbr_idx, lyr.src_cap)
            s = (prev_d + 1) if prev_d is not None else r
            rows.append(torch.stack([d, v, r, s]))
            prev_d = d
        return torch.stack(rows)

    def counts(self) -> list:
        """Each counted step's ``LayerCounts``, innermost first."""
        if not self._counts:
            return []
        all_counts = torch.stack(self._counts).cpu().tolist()
        out = []
        for step in all_counts:
            layers = []
            for i, (d, v, r, s) in enumerate(step):
                h_in, h_out = self.widths[i]
                k = self.fanouts[len(self.fanouts) - 1 - i] + 1
                layers.append(flops.LayerCounts(K=k, D=d, V=v, R=r, S=s,
                                                h_in=h_in, h_out=h_out))
            out.append(layers)
        return out

    def kernel_bounds(self) -> list:
        """Each counted step's kernel bound seconds, by kernel family."""
        return [self.spec.split_kernel_bounds(layers, self.cfg)
                for layers in self.counts()]

    def judge(self, gi, samples, train_mask, graph_labels):
        found_all, refs, labels = {}, [], []
        for s in samples:
            found, r = judge_split(gi, s["layers"], s["labels"],
                                   self.fanouts, self.batch_size, train_mask,
                                   graph_labels)
            t = s["targets"].to(gi.indptr.device).long()
            found["targets"] = int(t.numel() != r.targets.numel()) or int(
                (t != r.targets).sum())
            for k, v in found.items():
                found_all[k] = found_all.get(k, 0) + v
            refs.append(r)
            labels.append(graph_labels[r.targets].long())
        return found_all, refs, labels

    def stats(self) -> dict:
        st = self.sampler.stats()
        return {"cxx_sample_s": st["sample_s_total"],
                "cxx_samples": st["samples"]}

    def close(self):
        self.sampler.close()
        self.model.forward_partitions = None
        del self.step_fn, self.opt, self.model, self.cache, self.csr
        del self.sampler, self.batches


Program = SplitProgram
