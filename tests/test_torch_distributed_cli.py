"""The port's split CLI at P > 1 on the CPU, one gloo process per partition.

  * ``--partitions 2`` through the one-host launcher equals a two-process
    ``--distributed`` run (the JAX flag names, a ``file://`` store)
    exactly, on both ranks;
  * training converges at ``--partitions 4`` with the replicated cache
    and device innermost, without a cache, and with the numpy sampler;
  * a JAX checkpoint resumes at ``--partitions 2`` with the refreshing
    cache and matches JAX's resumed run after one more epoch;
  * a forced capacity overflow makes both ranks re-plan together;
  * the backend and device choices never fall back silently, and ranks
    that disagree on their inputs stop.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from occ_gnn_tpu import train as jax_train
from occ_gnn_tpu.data import block_graph as jax_block_graph
from occ_gnn_tpu.utils import PhaseTimers as JaxTimers
from occ_gnn_tpu_torch import train
from occ_gnn_tpu_torch.parallel import dist

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--graph", "community", "--num-nodes", "2000", "--avg-degree", "8",
         "--feature-dim", "16", "--fan-out", "3,3", "--batch-size", "128",
         "--num-epochs", "2", "--mode", "split", "--num-hidden", "16",
         "--num-workers", "1", "--cpu"]
SMOKE = ["--graph", "community", "--mode", "split", "--fan-out", "5,5",
         "--batch-size", "256", "--num-nodes", "3000", "--num-epochs", "2",
         "--cpu"]


def _last_json(out: str) -> dict:
    for line in reversed(out.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise AssertionError(f"no JSON line in output:\n{out[-2000:]}")


def _distributed(argv, tmp_path, seeds=(0, 0)):
    """``argv`` as two processes joined by a ``file://`` store (rank r
    with ``--seed seeds[r]``); returns their (exit code, output) in rank
    order."""
    store = f"file://{tmp_path}/store"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "occ_gnn_tpu_torch.train", *argv, "--json",
         "--seed", str(seed), "--distributed", "--coordinator-address",
         store, "--num-processes", "2", "--process-id", str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=dict(os.environ)) for r, seed in enumerate(seeds)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def test_launcher_equals_distributed_processes(tmp_path):
    # Two processes of one partition each; tails on.
    argv = SMALL + ["--partitions", "2", "--cache-per", "0.1",
                    "--cpu-devices", "1"]
    launched = train.main(argv)
    outs = _distributed(argv, tmp_path)
    ranks = []
    for code, out in outs:
        assert code == 0, out[-3000:]
        ranks.append(_last_json(out))
    assert [m["rank"] for m in ranks] == [0, 1]
    for m in ranks + [launched]:
        assert m["partitions"] == 2 and m["backend"] == "gloo"
        assert m["tail_batches"] == m["steps"] > 0
        for key in ("acc", "loss", "steps", "shuffle", "cache_pct"):
            assert m[key] == launched[key], key
    assert launched["rank"] == 0


@pytest.mark.parametrize("variant", [
    ["--cache-per", "auto"],
    ["--cache-per", "0"],
    ["--sampler", "numpy"],
], ids=["auto-device", "no-cache", "numpy"])
def test_converges_at_four_partitions(variant, tmp_path):
    auto = variant == ["--cache-per", "auto"]
    extra = ["--profile-dir", str(tmp_path)] if auto else ["--eval"]
    m = train.main(SMOKE + variant + ["--partitions", "4", "--cpu-devices",
                                      "1"] + extra)
    assert m["partitions"] == 4 and m["steps"] == 20
    assert m["acc"] >= 0.95, m
    steps = m["steps"]
    if auto:
        # Replicated cache: layer 0 is synthesized on each rank (no
        # shuffle); layer 1 shuffles forward and backward.
        assert m["innermost"] == "device" and m["cache_pct"] == 1.0
        assert m["shuffle"]["forward"] == m["shuffle"]["backward"] == steps
        for r in range(4):
            assert (tmp_path / f"rank{r}" / "trace.json").stat().st_size > 0
        named = m["profile"]["named_ms"]
        assert named["shuffle_merge"]["calls"] == 1
        assert named["_ShuffleMergeBackward"]["calls"] == 1
    else:
        # Both layers shuffle forward; layer 0 has no backward (the input
        # frame takes no gradient).
        assert m["shuffle"]["forward"] == 2 * steps
        assert m["shuffle"]["backward"] == steps
        # The evaluation counts are global: every val and test node once.
        g = train.resolve_graph(train.build_argparser().parse_args(SMOKE))
        assert m["val_count"] == int(g.val_mask.sum())
        assert m["test_count"] == int(g.test_mask.sum())
        assert m["val_acc"] >= 0.9 and m["test_acc"] >= 0.9, m
    assert m["shuffle"]["bytes_sent"] > 0


def test_resume_of_a_jax_checkpoint_matches_jax(tmp_path):
    """JAX trains one epoch at P = 2 and saves; then JAX and the port both
    resume from that file for one more epoch, on the same C++ batches."""
    argv = ["--graph", "community", "--mode", "split", "--fan-out", "4,4",
            "--batch-size", "128", "--num-nodes", "1500", "--num-hidden",
            "16", "--cache-per", "0.25", "--innermost", "host",
            "--partitions", "2", "--num-workers", "1", "--seed", "3",
            "--cpu"]
    jg_kw = dict(num_nodes=1500, num_blocks=8, avg_degree=10,
                 feature_dim=128, seed=3)
    jparse = jax_train.build_argparser().parse_args
    jax_train.train_split(
        jparse(argv + ["--num-epochs", "1", "--save-dir", str(tmp_path)]),
        jax_block_graph(**jg_kw), [4, 4], JaxTimers())
    ck = str(tmp_path / "split_epoch.npz")
    resumed = argv + ["--num-epochs", "2", "--resume", ck]
    jm = jax_train.train_split(jparse(resumed), jax_block_graph(**jg_kw),
                               [4, 4], JaxTimers())
    tm = train.main(resumed)
    train_nodes = jax_block_graph(**jg_kw).train_nodes().shape[0]
    assert tm["steps"] == -(-train_nodes // 128)  # one more epoch
    assert tm["tail_batches"] == tm["steps"]
    assert abs(tm["loss"] - jm["loss"]) <= 1e-4, (tm["loss"], jm["loss"])
    assert abs(tm["acc"] - jm["acc"]) <= 0.002, (tm["acc"], jm["acc"])


def test_forced_overflow_replans_on_both_ranks(tmp_path):
    # Budgets at half the measured maxima overflow at once; both ranks
    # see every partition's verdict, re-plan at 1.5x together and finish.
    argv = SMALL + ["--partitions", "2", "--measure-caps", "--caps-margin",
                    "0.5", "--num-epochs", "1"]
    outs = _distributed(argv, tmp_path)
    ranks = []
    for code, out in outs:
        assert code == 0, out[-3000:]
        assert "re-planning with 1.5x budgets" in out
        ranks.append(_last_json(out))
    assert ranks[0]["replans"] == ranks[1]["replans"] >= 1
    for key in ("acc", "loss", "steps", "shuffle"):
        assert ranks[0][key] == ranks[1][key], key


def test_ranks_that_disagree_stop(tmp_path):
    # Two ranks started with different seeds hold different graphs and
    # weights: the start-up agreement check stops both.
    outs = _distributed(SMALL + ["--partitions", "2", "--num-epochs", "1"],
                        tmp_path, seeds=(0, 1))
    for code, out in outs:
        assert code != 0
        assert "the ranks disagree on" in out and "weights" in out


def test_backend_choice_never_falls_back(monkeypatch):
    # The choice follows the card count alone: gloo on the CPU and where
    # ranks share a card (NCCL refuses two ranks on one), NCCL where every
    # rank has a card of its own.
    assert dist.choose_backend(4, cpu=True) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert dist.choose_backend(2, cpu=False) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert dist.choose_backend(4, cpu=False) == "nccl"
    assert dist.choose_backend(4, cpu=True) == "gloo"


def test_rank_devices_and_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert dist.rank_device(3, cpu=False) == torch.device("cuda", 1)
    assert dist.rank_device(3, cpu=True) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device.*--cpu"):
        dist.rank_device(0, cpu=False)
    # The launcher stops before it spawns anything.
    with pytest.raises(SystemExit, match="no CUDA device"):
        train.main([a for a in SMALL if a != "--cpu"] + ["--partitions", "2"])
