"""The port's spans (``utils/timers.span``) in a profiler trace, on the
CPU: one training step of the split and of the quiver path opens
``occ.step`` once, with its phases inside it once each and in order; each
batch of the C++ service's feed shows its wait, copy and upload in order,
between the consumer's own ranges; ``occ_wait`` returns when the service
is closed; with no profiler a span opens nothing; and a span lies on the
trace's clock, unix-epoch nanoseconds. One test, marked ``card``, runs on
the CUDA card only: ``python -m pytest --noconftest
tests/test_torch_trace_spans.py -m card``."""

import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from occ_gnn_tpu_torch.cache import CachePlan, SplitFeatureCache
from occ_gnn_tpu_torch.data import random_graph
from occ_gnn_tpu_torch.models import SAGEModel
from occ_gnn_tpu_torch.parallel.model import (
    SplitSAGE,
    make_device_csr,
    make_split_train_step,
)
from occ_gnn_tpu_torch.sampling.device_sampler import DeviceSampleTrainer
from occ_gnn_tpu_torch.sampling.native import NativeSplitSampler
from occ_gnn_tpu_torch.utils import PhaseTimers, timers
from occ_gnn_tpu_torch.utils.profile import NAMED_RANGES

GRAPH_KW = dict(num_nodes=400, avg_degree=6, feature_dim=8, num_classes=4,
                seed=2)
FANOUTS, BATCH, HIDDEN = [3, 3], 32, 8
MARK = "test.mark"
SPLIT_PHASES = ["occ.step.layers", "occ.step.forward", "occ.step.loss",
                "occ.step.backward", "occ.step.optimizer"]
QUIVER_PHASES = ["occ.step.upload", "occ.step.forward", "occ.step.loss",
                 "occ.step.backward", "occ.step.optimizer"]
FEED = "occ.feed."
PORT = Path(__file__).resolve().parent.parent / "occ_gnn_tpu_torch"


@pytest.fixture(scope="module")
def graph():
    return random_graph(**GRAPH_KW)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda", 0)


def _ranges(prof) -> list:
    """``(start_ns, end_ns, name)`` of the named ranges on the thread that
    opened ``MARK``, in order of start (then the outer first)."""
    events = [e for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation() and e.device_type() ==
              torch.autograd.DeviceType.CPU]
    main = {e.start_thread_id() for e in events if e.name() == MARK}
    assert len(main) == 1
    out = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in events if e.start_thread_id() in main]
    return sorted(out, key=lambda r: (r[0], -r[1]))


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _check_steps(ranges, phases, steps):
    """Each ``occ.step`` holds ``phases``, once each, in order and apart;
    no phase lies outside a step."""
    opened = [r for r in ranges if r[2] == "occ.step"]
    assert len(opened) == steps
    for step in opened:
        mine = [r for r in ranges if r[2] in phases and _inside(r, step)]
        assert [r[2] for r in mine] == phases
        for a, b in zip(mine, mine[1:]):
            assert a[1] <= b[0]
    assert sum(r[2] in phases for r in ranges) == steps * len(phases)
    return opened


def _native(g, num_workers=2):
    pmap = np.zeros(g.num_nodes, np.int32)
    plan = CachePlan(g, pmap, 1, 1.0, refresh_cap=8)
    return NativeSplitSampler(g, g.train_nodes(), pmap, 1, FANOUTS, BATCH,
                              seed=3, cache=plan, num_workers=num_workers,
                              innermost="device", device="cpu")


def _split_step(g, sampler):
    model = SplitSAGE(g.feature_dim, HIDDEN, g.num_classes, len(FANOUTS),
                      generator=torch.Generator().manual_seed(1))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = make_split_train_step(model, opt, csr=make_device_csr(g, "cpu"))
    frames = SplitFeatureCache(sampler.cache_plan, device="cpu").frames
    gen = torch.Generator().manual_seed(7)
    return lambda batch: step(batch, frames, sample_generator=gen)


def _quiver(g, device="cpu"):
    model = SAGEModel(g.feature_dim, HIDDEN, g.num_classes,
                      len(FANOUTS)).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    trainer = DeviceSampleTrainer(g, FANOUTS, BATCH, model, opt, seed=4,
                                  device=device)
    return trainer, trainer.epoch_batches(g.train_nodes())


def test_split_step_opens_its_phases_in_order(graph):
    sampler = _native(graph)
    step = _split_step(graph, sampler)
    batch = sampler.sample_batch(graph.train_nodes()[:BATCH])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(MARK):
            step(batch)
    sampler.close()
    ranges = _ranges(prof)
    (opened,) = _check_steps(ranges, SPLIT_PHASES, 1)
    layers = next(r for r in ranges if r[2] == "occ.step.layers")
    synth = [r for r in ranges if r[2] == "synthesize_device_innermost"]
    assert synth and all(_inside(r, layers) for r in synth)
    assert all(_inside(r, opened) for r in ranges
               if r[2].startswith("occ.step."))


def test_quiver_step_opens_its_phases_in_order(graph):
    trainer, batches = _quiver(graph)
    targets, labels = next(batches)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(MARK):
            trainer.step(targets, labels)
    ranges = _ranges(prof)
    _check_steps(ranges, QUIVER_PHASES, 1)
    forward = next(r for r in ranges if r[2] == "occ.step.forward")
    for name in ("quiver_draw", "quiver_gather", "dense_sage_forward"):
        found = [r for r in ranges if r[2] == name]
        assert len(found) == 1 and _inside(found[0], forward), name


def test_feed_spans_come_in_order_between_the_consumers_ranges(graph):
    sampler = _native(graph)
    step = _split_step(graph, sampler)
    batches = iter(sampler)
    n = 5
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(MARK):
            for _ in range(n):
                batch = next(batches)
                with record_function("test.consumer"):
                    step(batch)
    batches.close()
    sampler.close()
    ranges = _ranges(prof)
    consumers = [r for r in ranges if r[2] == "test.consumer"]
    feed = [r for r in ranges if r[2].startswith(FEED)]
    assert len(consumers) == n
    for f in feed:
        assert not any(f[0] < c[1] and c[0] < f[1] for c in consumers), f
    _check_steps(ranges, SPLIT_PHASES, n)
    # Between one consumer range and the next: the batch's submits, then
    # one wait, copy and upload for each sample taken from the service,
    # then the cache tail's apply. A sample that finished out of turn was
    # taken, and parked, in an earlier interval: its own interval then
    # takes none.
    edges = [ranges[0][0]] + [c[1] for c in consumers]
    for k in range(n):
        names = [f[2][len(FEED):] for f in feed
                 if edges[k] <= f[0] and f[1] <= consumers[k][0]]
        taken = " ".join(x for x in names if x != "submit")
        assert re.fullmatch(r"(wait copy upload )*cache", taken), names
        assert "submit" in names[: names.index(taken.split()[0])]
    # Every delivered sample was taken from the service once.
    assert sum(f[2] == FEED + "wait" for f in feed) >= n
    assert sum(f[2] == FEED + "submit" for f in feed) >= n


def test_occ_wait_returns_on_a_closed_service(graph):
    sampler = _native(graph, num_workers=1)
    lib, handle = sampler._lib, sampler._handle
    got = []
    waiter = threading.Thread(target=lambda: got.append(lib.occ_wait(handle)))
    waiter.start()
    time.sleep(0.2)
    assert waiter.is_alive()  # nothing was submitted
    sampler.close()
    waiter.join(timeout=10)
    assert not waiter.is_alive() and got == [-1]


def test_occ_wait_leaves_the_sample_to_occ_next(graph):
    sampler = _native(graph, num_workers=1)
    nodes = graph.train_nodes()[:BATCH]
    want = sampler.sample_batch(nodes)
    sampler._submit(np.ascontiguousarray(nodes))
    assert sampler._lib.occ_wait(sampler._handle) == 0
    assert sampler._lib.occ_wait(sampler._handle) == 0  # still queued
    got = sampler._pop()
    np.testing.assert_array_equal(got.target_nodes.numpy(),
                                  want.target_nodes.numpy())
    sampler.close()


def test_without_a_profiler_a_span_opens_nothing(graph, monkeypatch):
    opened = []

    def counting(name):
        opened.append(name)
        return record_function(name)

    monkeypatch.setattr(timers, "record_function", counting)
    trainer, batches = _quiver(graph)
    tm = PhaseTimers()
    for _ in range(2):
        with tm.phase("train_step"):
            trainer.step(*next(batches))
    assert opened == []
    assert tm.as_dict()["train_step"] > 0.0
    with profile(activities=[ProfilerActivity.CPU]):
        with tm.phase("train_step"):
            trainer.step(*next(batches))
    assert opened[0] == "train_step" and "occ.step" in opened


def test_a_span_lies_on_the_unix_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(MARK):
            before = time.time_ns()
            with timers.span("occ.step"):
                torch.ones(64).sum()
            after = time.time_ns()
    (step,) = [r for r in _ranges(prof) if r[2] == "occ.step"]
    assert before <= step[0] <= step[1] <= after


def test_every_named_span_is_in_the_profile_summary():
    """``utils/profile.NAMED_RANGES`` lists each name literal the port
    hands to ``span``, ``record_function`` or a phase timer."""
    call = re.compile(r'(?:\bspan|\brecord_function|\.phase)\(\s*"([^"]+)"')
    names = set()
    for path in PORT.rglob("*.py"):
        names |= set(call.findall(path.read_text()))
    assert {"occ.step", "occ.feed.wait", "gat_attention_tiled"} <= names
    assert sorted(names - set(NAMED_RANGES)) == []


@pytest.mark.card
def test_each_step_opens_before_its_first_kernel(card, graph):
    trainer, batches = _quiver(graph, card)
    trainer.step(*next(batches))  # builds and warms the kernels
    torch.cuda.synchronize(card)
    n = 4
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(MARK):
            for _ in range(n):
                trainer.step(*next(batches))
                with record_function("test.sync"):
                    torch.cuda.synchronize(card)
    ranges = _ranges(prof)
    steps = [r for r in ranges if r[2] == "occ.step"]
    syncs = [r for r in ranges if r[2] == "test.sync"]
    kernels = sorted(e.start_ns() for e in prof.profiler.kineto_results
                     .events() if e.device_type() ==
                     torch.autograd.DeviceType.CUDA
                     and not e.is_user_annotation())
    assert len(steps) == len(syncs) == n
    # After a synchronise no kernel of the step before runs: the step's
    # first kernel is the first to start after the previous synchronise.
    floors = [ranges[0][0]] + [s[1] for s in syncs[:-1]]
    for step, floor, sync in zip(steps, floors, syncs):
        first = min(k for k in kernels if floor <= k <= sync[1])
        assert step[0] <= first
