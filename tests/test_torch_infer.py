"""``--mode infer`` in the port against the JAX package's ``run_infer``.

One checkpoint (JAX's ``--mode split --save-dir``, or the port's) is read
by both CLIs with the same flags: both samplers are one code (numpy, or
the same C++ source), so the batches are equal, and the count, the
accuracy and the prediction arrays must be equal (tolerance 0: the
logits of the two packages agree to ~1e-6, far from any tie on this
graph). The port at two ranks must give what it gives at one.
"""

import numpy as np
import pytest

from occ_gnn_tpu import train as jax_train
from occ_gnn_tpu_torch import train

COMMON = ["--graph", "community", "--num-nodes", "1500", "--fan-out", "4,4",
          "--batch-size", "128", "--num-hidden", "16", "--num-epochs", "2",
          "--feature-dim", "16", "--cpu", "--cpu-devices", "1", "--seed",
          "3"]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """JAX's and the port's split checkpoints of the same flags."""
    jdir = tmp_path_factory.mktemp("jax_ck")
    pdir = tmp_path_factory.mktemp("port_ck")
    jax_train.main(COMMON + ["--mode", "split", "--partitions", "1",
                             "--save-dir", str(jdir)])
    train.main(COMMON + ["--mode", "split", "--save-dir", str(pdir)])
    return {"jax": str(jdir / "split_epoch.npz"),
            "port": str(pdir / "split_epoch.npz")}


def _infer(main, ckpt, out, extra=()):
    metrics = main(COMMON + ["--mode", "infer", "--resume", ckpt,
                             "--output", str(out), *extra])
    return metrics, np.load(out)


@pytest.mark.parametrize("origin,sampler", [
    ("jax", "native"), ("jax", "numpy"), ("port", "native")])
def test_infer_equals_jax(checkpoints, tmp_path, origin, sampler):
    extra = ["--partitions", "1", "--sampler", sampler,
             "--infer-nodes", "test"]
    jm, jpred = _infer(jax_train.main, checkpoints[origin],
                       tmp_path / "jax.npy", extra)
    tm, tpred = _infer(train.main, checkpoints[origin],
                       tmp_path / "port.npy", extra)
    assert tm["mode"] == "infer" and tm["count"] == jm["count"] > 0
    assert tm["acc"] == jm["acc"] and tm["acc"] > 0.5
    assert tpred.dtype == np.int32 and tpred.shape == (1500,)
    np.testing.assert_array_equal(tpred, jpred)
    assert (tpred >= 0).sum() == tm["count"]


def test_two_ranks_equal_one(checkpoints, tmp_path):
    one, p1 = _infer(train.main, checkpoints["jax"], tmp_path / "p1.npy",
                     ["--infer-nodes", "val"])
    two, p2 = _infer(train.main, checkpoints["jax"], tmp_path / "p2.npy",
                     ["--infer-nodes", "val", "--partitions", "2"])
    assert (two["count"], two["acc"]) == (one["count"], one["acc"])
    assert two["partitions"] == 2 and one["partitions"] == 1
    np.testing.assert_array_equal(p2, p1)


def test_all_nodes(checkpoints, tmp_path):
    metrics, preds = _infer(train.main, checkpoints["port"],
                            tmp_path / "all.npy", ["--infer-nodes", "all"])
    assert metrics["count"] == 1500 and (preds >= 0).all()
    assert metrics["acc"] > 0.5


def test_requires_resume():
    argv = COMMON + ["--mode", "infer"]
    with pytest.raises(SystemExit, match="requires --resume"):
        jax_train.main(argv)
    with pytest.raises(SystemExit, match="requires --resume"):
        train.main(argv)
