"""The port's entry points (``occ_gnn_tpu_torch.entry``) against the JAX
package's ``__graft_entry__``.

  * ``entry()``: the 3-layer SAGE forward of the tiny graph's first batch
    at JAX's weights (carried across by ``utils.checkpoint``): logits
    within 1e-4 of scale of JAX's ``entry()``;
  * ``dryrun_multichip(4, device="cpu")``: one process holding 4
    partitions runs the three steps and prints three finite losses;
  * its first step (the C++ service, a refreshing 0.05 cache) equals
    JAX's ``make_split_train_step`` on a 4-device mesh at the same batch
    and weights: loss and gradients within 1e-4 of scale;
  * importing the module in a fresh process loads neither JAX nor the JAX
    package, and without a card and a device it stops.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax

import __graft_entry__ as jax_entry
from occ_gnn_tpu.cache import CachePlan as JaxCachePlan
from occ_gnn_tpu.cache import SplitFeatureCache as JaxSplitFeatureCache
from occ_gnn_tpu.data import partition_graph as jax_partition_graph
from occ_gnn_tpu.parallel.model import SplitSAGE as JaxSplitSAGE
from occ_gnn_tpu.parallel.model import make_split_train_step as jax_step
from occ_gnn_tpu.parallel.split import make_mesh
from occ_gnn_tpu.sampling.native import NativeSplitSampler as JaxNative
from occ_gnn_tpu_torch import entry
from occ_gnn_tpu_torch.data.partition import partition_graph
from occ_gnn_tpu_torch.parallel.model import SplitSAGE
from occ_gnn_tpu_torch.utils.checkpoint import params_from_jax

REPO = Path(__file__).resolve().parent.parent
# f32 sums in another order, through three layers: 1e-4 of the scale.
SCALE_TOL = 1e-4


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / (scale if scale > 0 else 1.0))


def test_entry_forward_matches_jax():
    jfn, (jparams, jbatch, jx0) = jax_entry.entry()
    jlogits = np.asarray(jax.jit(jfn)(jparams, jbatch, jx0))
    fn, (params, batch, x0) = entry.entry("cpu")
    np.testing.assert_array_equal(batch.input_nodes.numpy(),
                                  np.asarray(jbatch.input_nodes))
    np.testing.assert_array_equal(x0.numpy(), np.asarray(jx0))
    own = fn(params, batch, x0)
    assert own.shape == jlogits.shape and torch.isfinite(own).all()
    logits = fn(params_from_jax(jparams), batch, x0).numpy()
    assert _rel(logits, jlogits) <= SCALE_TOL


def test_dryrun_prints_three_finite_losses(capsys):
    losses = entry.dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert len(losses) == 3 and np.isfinite(losses).all()
    printed = re.findall(r"dryrun_multichip\(4\)( GAT| device-innermost)?: "
                         r"loss=([-0-9.]+)", out)
    assert [tag for tag, _ in printed] == ["", " GAT", " device-innermost"]
    assert [float(v) for _, v in printed] == pytest.approx(losses, abs=1e-4)


def test_dryrun_sage_step_matches_jax():
    """The dry run's first step at JAX's weights, with SGD at lr 1 so the
    update is the gradient, against JAX's step on a 4-device mesh."""
    n = 4
    jg = jax_entry._tiny_graph(num_nodes=800, avg_degree=6, feature_dim=32,
                               num_classes=8)
    g = entry.dryrun_graph()
    np.testing.assert_array_equal(g.features, jg.features)
    jpmap = jax_partition_graph(jg, n, mode="greedy", attach=False)
    pmap = partition_graph(g, n, mode="greedy")
    np.testing.assert_array_equal(pmap, jpmap)
    jcache = JaxSplitFeatureCache(JaxCachePlan(jg, jpmap, n, 0.05,
                                               refresh_cap=512))
    js = JaxNative(jg, jg.train_nodes(), jpmap, n, entry.DRYRUN_FANOUTS,
                   entry.DRYRUN_BATCH, seed=0, cache=jcache, num_workers=1)
    try:
        jbatch = next(iter(js))
    finally:
        js.close()
    jm = JaxSplitSAGE(jg.feature_dim, 32, jg.num_classes, 2)
    params = jm.init(jax.random.PRNGKey(0))
    opt = optax.sgd(1.0)
    new, _, jloss, jcorrect, jcount = jax_step(jm, opt, make_mesh(n))(
        params, opt.init(params), jbatch, jcache.frames)
    model = SplitSAGE(g.feature_dim, 32, g.num_classes, 2)
    model.load_state_dict(params_from_jax(params))
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    loss, correct, count = entry.sage_step(
        g, pmap, n, "cpu", model, torch.optim.SGD(model.parameters(), lr=1.0))
    assert (int(count), int(correct)) == (int(jcount), int(jcorrect))
    assert int(count) > 0
    assert _rel(float(loss), float(jloss)) <= SCALE_TOL
    for name, p in model.named_parameters():
        layer, leaf = name.split("/")
        jgrad = np.asarray(params[layer][leaf]) - np.asarray(new[layer][leaf])
        grad = (before[name] - p.detach()).numpy()
        assert _rel(grad, jgrad) <= SCALE_TOL, name


def test_entry_module_loads_no_jax_and_needs_a_device():
    code = ("import sys, occ_gnn_tpu_torch.entry\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'occ_gnn_tpu')]\n"
            "print('BAD', bad)\n"
            "from occ_gnn_tpu_torch.entry import entry\n"
            "entry()\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert "BAD []" in proc.stdout, proc.stdout + proc.stderr
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
