"""The port's CLI on the CPU, and the package's independence from JAX."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "occ_gnn_tpu_torch"
TRAIN = ["-m", "occ_gnn_tpu_torch.train", "--graph", "community", "--mode",
         "single", "--fan-out", "5,5", "--batch-size", "256", "--num-nodes",
         "3000", "--num-epochs", "2"]


def _run(args, **env):
    return subprocess.run([sys.executable, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, **env})


def test_cli_single_sage_converges_on_cpu():
    proc = _run(TRAIN + ["--cpu", "--json"])
    assert proc.returncode == 0, proc.stderr
    metrics = json.loads(proc.stdout.strip().splitlines()[-1])
    assert metrics["mode"] == "single" and metrics["steps"] > 0
    assert metrics["acc"] >= 0.95, metrics  # the JAX CLI reaches 0.998


def test_cli_without_cpu_and_without_gpu_fails_clearly():
    # No visible GPU whatever the machine has: the CLI must not fall back.
    proc = _run(TRAIN, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "--cpu" in proc.stderr


@pytest.mark.parametrize("mode", ["pa-cache", "ddp", "quiver", "infer"])
def test_new_modes_without_cpu_and_without_gpu_fail_clearly(mode):
    extra = ["--partitions", "2"] if mode in ("ddp", "quiver") else []
    proc = _run(["-m", "occ_gnn_tpu_torch.train", "--graph", "community",
                 "--mode", mode, *extra], CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "--cpu" in proc.stderr


# Each optional flag of the JAX CLI with a value away from its default.
FLAG_VALUES = {
    "num_epochs": ["--num-epochs", "3"], "limit_train": ["--limit-train", "64"],
    "dropout": ["--dropout", "0.5"], "measure_caps": ["--measure-caps"],
    "sample_without_replacement": ["--sample-without-replacement"],
    "cache_per": ["--cache-per", "0.5"], "partitions": ["--partitions", "2"],
    "partition_mode": ["--partition-mode", "metis"],
    "sampler": ["--sampler", "numpy"], "innermost": ["--innermost", "host"],
    "caps_margin": ["--caps-margin", "1.2"],
    "num_workers": ["--num-workers", "4"], "dtype": ["--dtype", "bfloat16"],
    "save_dir": ["--save-dir", "ck"], "resume": ["--resume", "ck/a.npz"],
    "eval": ["--eval"], "profile_dir": ["--profile-dir", "tr"],
    "infer_nodes": ["--infer-nodes", "all"], "output": ["--output", "p.npy"],
    "cpu_devices": ["--cpu-devices", "4"], "distributed": ["--distributed"],
    "coordinator_address": ["--coordinator-address", "localhost:1234"],
    "num_processes": ["--num-processes", "2"],
    "process_id": ["--process-id", "1"],
}


@pytest.mark.parametrize("mode", ["split", "single", "pa-cache", "ddp",
                                  "quiver", "infer"])
def test_flag_a_mode_does_not_read_stops_the_cli(mode):
    """Every optional flag that the JAX trainer's ``mode`` does not read
    stops the port's CLI under that mode, before any work."""
    from occ_gnn_tpu_torch import train

    assert set(FLAG_VALUES) == set(train._MODES_READING)
    unread = [d for d, modes in train._MODES_READING.items()
              if mode not in modes]
    # --cpu-devices gives the partitions or shards of a process under
    # --cpu.
    assert ("cpu_devices" in unread) == (mode in ("single", "pa-cache"))
    for dest in unread:
        flag = FLAG_VALUES[dest]
        with pytest.raises(SystemExit, match=f"{flag[0]} is not ported"):
            train.main(["--graph", "community", "--mode", mode, "--cpu",
                        *flag])


UNPORTED_FLAGS = [
    ["--cache-per", "auto"], ["--partitions", "2"],
    ["--partition-mode", "metis"], ["--sampler", "numpy"],
    ["--innermost", "host"], ["--caps-margin", "1.2"],
    ["--num-workers", "4"], ["--dtype", "bfloat16"], ["--save-dir", "ck"],
    ["--resume", "ck/a.npz"], ["--eval"], ["--profile-dir", "tr"],
    ["--infer-nodes", "all"], ["--output", "p.npy"], ["--cpu-devices", "4"],
    ["--distributed"], ["--coordinator-address", "localhost:1234"],
    ["--num-processes", "2"], ["--process-id", "1"],
]


@pytest.mark.parametrize("flag", UNPORTED_FLAGS, ids=lambda f: f[0])
def test_flags_not_ported_name_their_roadmap_item(flag):
    from occ_gnn_tpu_torch import train

    with pytest.raises(SystemExit, match=f"{flag[0]} is not ported.*ROADMAP"):
        train.main(["--graph", "community", "--mode", "single", "--cpu",
                    *flag])


def test_every_phase_is_timed_once_a_step():
    import torch

    from occ_gnn_tpu_torch import train
    from occ_gnn_tpu_torch.data import block_graph
    from occ_gnn_tpu_torch.utils import PhaseTimers

    class Recorder(PhaseTimers):
        def __init__(self):
            super().__init__()
            self.names = []

        def phase(self, name):
            self.names.append(name)
            return super().phase(name)

    args = train.build_argparser().parse_args(
        ["--graph", "community", "--mode", "single", "--fan-out", "3,3",
         "--batch-size", "64", "--num-hidden", "16", "--num-epochs", "2",
         "--cpu"])
    g = block_graph(num_nodes=400, num_blocks=4, avg_degree=5,
                    feature_dim=8, seed=0)
    timers = Recorder()
    metrics = train.train_single(args, g, [3, 3], timers, torch.device("cpu"))
    assert metrics["steps"] > 2
    for name in ("sample", "feature_load", "train_step"):
        assert timers.names.count(name) == metrics["steps"], name


def test_port_imports_no_jax():
    code = ("import importlib, pkgutil, sys, occ_gnn_tpu_torch as p\n"
            "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
            "'occ_gnn_tpu_torch.')]\n"
            "for m in mods: importlib.import_module(m)\n"
            "print(len(mods), 'jax' in sys.modules, "
            "any(k.startswith('occ_gnn_tpu.') or k == 'occ_gnn_tpu' "
            "for k in sys.modules))")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr
    count, has_jax, has_jax_pkg = proc.stdout.split()
    assert int(count) >= 15
    assert (has_jax, has_jax_pkg) == ("False", "False")


def test_port_sources_do_not_reference_jax():
    pattern = re.compile(r"\bocc_gnn_tpu\.|^\s*(import jax|from jax)", re.M)
    sources = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert not offenders
