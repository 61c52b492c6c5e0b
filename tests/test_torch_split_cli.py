"""The port's split CLI on the CPU: it converges on the community smoke
graph in all four variants of the split path, its evaluation equals the
JAX trainer's with the same weights, the flags it does not read yet stop
with their ROADMAP item, and a process that runs it loads no JAX. Also
the single path's sampling under --sample-without-replacement, which
follows the JAX trainer."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

from occ_gnn_tpu import train as jax_train
from occ_gnn_tpu.data import block_graph as jax_block_graph
from occ_gnn_tpu.parallel.model import SplitSAGE as JaxSplitSAGE
from occ_gnn_tpu.sampling import neighbor as jax_neighbor
from occ_gnn_tpu.utils import PhaseTimers as JaxTimers
from occ_gnn_tpu_torch import train
from occ_gnn_tpu_torch.data import block_graph
from occ_gnn_tpu_torch.sampling import neighbor as tnb
from occ_gnn_tpu_torch.utils import PhaseTimers
from occ_gnn_tpu_torch.utils.checkpoint import params_from_jax

REPO = Path(__file__).resolve().parent.parent
SMOKE = ["--graph", "community", "--mode", "split", "--fan-out", "5,5",
         "--batch-size", "256", "--num-nodes", "3000", "--num-epochs", "2",
         "--cpu"]


@pytest.mark.parametrize("variant", [
    ["--cache-per", "auto"],
    ["--cache-per", "0"],
    ["--sampler", "numpy"],
    ["--cache-per", "0.25", "--innermost", "host"],
], ids=["auto-device", "no-cache", "numpy", "refreshing-host"])
def test_split_cli_converges(variant, capsys):
    # One partition: --cpu-devices 1 (by default --cpu holds 8, as JAX).
    metrics = train.main(SMOKE + variant + ["--cpu-devices", "1"])
    out = capsys.readouterr().out
    assert metrics["mode"] == "split" and metrics["partitions"] == 1
    assert metrics["steps"] == 20  # 2 epochs of 10 batches
    assert metrics["acc"] >= 0.95, metrics  # the JAX CLI reaches ~1.0
    auto = variant == ["--cache-per", "auto"]
    assert ("innermost layer: device-sampled" in out) == auto
    assert metrics["innermost"] == ("device" if auto else "host")
    refreshing = "0.25" in variant
    assert metrics["tail_batches"] == (20 if refreshing else 0)
    assert {"sample", "train_step"} <= set(metrics["phases"])
    native = "numpy" not in variant
    assert ("cxx_sample" in metrics["phases"]) == native
    assert metrics["peak_rss_mb"] > 0


def test_eval_accuracy_equals_jax():
    """One epoch from the same weights with the same C++ batches, then
    --eval on val and test: the port's accuracies are JAX's within
    0.002."""
    argv = ["--graph", "community", "--mode", "split", "--fan-out", "4,4",
            "--batch-size", "128", "--num-nodes", "1500", "--num-hidden",
            "16", "--num-epochs", "1", "--innermost", "host", "--eval",
            "--cpu", "--cpu-devices", "1", "--seed", "3"]
    jargs = jax_train.build_argparser().parse_args(argv + ["--partitions",
                                                           "1"])
    jg = jax_block_graph(num_nodes=1500, num_blocks=8, avg_degree=10,
                         feature_dim=128, seed=3)
    jm = jax_train.train_split(jargs, jg, [4, 4], JaxTimers())
    params = JaxSplitSAGE(128, 16, jg.num_classes, 2).init(
        jax.random.PRNGKey(3))
    targs = train.build_argparser().parse_args(argv)
    tg = block_graph(num_nodes=1500, num_blocks=8, avg_degree=10,
                     feature_dim=128, seed=3)
    tm = train.train_split(targs, tg, [4, 4], PhaseTimers(),
                           init_state=params_from_jax(params))
    for key in ("acc", "val_acc", "test_acc"):
        assert abs(tm[key] - jm[key]) <= 0.002, (key, tm[key], jm[key])
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-4)


@pytest.mark.parametrize("flag", [
    ["--cpu-devices", "4"], ["--infer-nodes", "all"], ["--output", "p.npy"],
], ids=lambda f: f[0])
def test_split_flags_not_ported_name_their_roadmap_item(flag):
    # Split reads --cpu-devices under --cpu only: on the card each process
    # holds the partitions of its card.
    cpu = [] if flag[0] == "--cpu-devices" else ["--cpu"]
    with pytest.raises(SystemExit, match=f"{flag[0]}.* is not ported.*ROADMAP"):
        train.main(["--graph", "community", "--mode", "split", *cpu, *flag])


@pytest.mark.parametrize("partitions", [1, 2])
def test_split_run_loads_no_jax(partitions):
    """A split run, and at 2 partitions each of the ranks it spawns, loads
    neither JAX nor the JAX package: every process reports its imports
    (PYTHONPROFILEIMPORTTIME, inherited by the spawned ranks)."""
    argv = SMOKE[:-3] + ["--num-epochs", "1", "--cpu", "--cpu-devices", "1",
                         "--partitions", str(partitions)]
    code = f"from occ_gnn_tpu_torch import train\ntrain.main({argv!r})\n"
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPROFILEIMPORTTIME": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "innermost layer" not in proc.stdout  # --cache-per 0 default
    imported = [line.rsplit("|", 1)[-1].strip()
                for line in proc.stderr.splitlines()
                if line.startswith("import time:")]
    # The launching process, and each rank, imported the trainer.
    assert imported.count("occ_gnn_tpu_torch.train") == (
        1 if partitions == 1 else 3)
    assert ("distributed: rank 1/2" in proc.stdout) == (partitions == 2)
    assert not [m for m in imported
                if m.split(".")[0] in ("jax", "jaxlib", "occ_gnn_tpu")]


def test_single_without_replacement_samples_as_jax(monkeypatch):
    """--sample-without-replacement reaches the capacity measurement only;
    both trainers then sample with replacement, the same batches."""
    argv = ["--graph", "community", "--mode", "single", "--fan-out", "3,3",
            "--batch-size", "64", "--num-nodes", "600", "--num-hidden", "8",
            "--num-epochs", "1", "--measure-caps",
            "--sample-without-replacement", "--cpu"]
    seen = {"jax": [], "port": []}
    replace = []

    def recorder(cls, key):
        orig = cls.sample_batch

        def sample_batch(self, batch):
            replace.append(self.replace)
            out = orig(self, batch)
            seen[key].append(np.asarray(out.input_nodes))
            return out

        monkeypatch.setattr(cls, "sample_batch", sample_batch)

    recorder(jax_neighbor.NeighborSampler, "jax")
    recorder(tnb.NeighborSampler, "port")
    jg = jax_block_graph(num_nodes=600, num_blocks=8, avg_degree=10,
                         feature_dim=128, seed=0)
    jax_train.train_single(jax_train.build_argparser().parse_args(argv), jg,
                           [3, 3], JaxTimers(), use_cache=False)
    tg = block_graph(num_nodes=600, num_blocks=8, avg_degree=10,
                     feature_dim=128, seed=0)
    train.train_single(train.build_argparser().parse_args(argv), tg, [3, 3],
                       PhaseTimers())
    assert len(seen["port"]) == len(seen["jax"]) > 2
    assert all(replace)
    for a, b in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(a, b)


def test_profile_dir_records_one_steady_step(tmp_path):
    metrics = train.main(SMOKE[:-3] + ["--num-epochs", "1", "--cpu",
                                       "--cpu-devices", "1",
                                       "--profile-dir", str(tmp_path)])
    assert (tmp_path / "trace.json").stat().st_size > 0
    prof = metrics["profile"]
    assert prof["window_ms"] > 0 and 0.0 <= prof["device_idle_share"] <= 1.0
    # the fifth step of ten: one train step, three aggregations (two
    # layers forward, one backward: layer 0 reads the frame, no gradient)
    named = prof["named_ms"]
    assert named["train_step"]["calls"] == named["sample"]["calls"] == 1
    assert named["local_aggregate_dense"]["calls"] == 2
    assert named["_DenseAggregateBackward"]["calls"] == 1
