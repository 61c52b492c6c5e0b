"""Tests of the benchmark. The marker ``card`` tags a test that needs the
CUDA card; it skips elsewhere, deciding inside the ``card`` fixture,
never at import. On the card: ``python3 -m pytest gnnbench/tests -m card``.
Nothing here imports JAX."""

from __future__ import annotations

import pytest

from gnnbench import spec

# The tiny sizes the CPU runs use: every width cut, the structure kept.
TINY_CONFIG = dict(num_nodes=3000, num_undirected_edges=30000,
                   feature_dim=16, num_classes=5, train_nodes=700,
                   val_nodes=100, test_nodes=2000, hidden=8)
TINY_TRAFFIC = dict(batch_size=64, fanouts=[3, 3, 4], warmup_steps=4)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs the CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda", 0)


def tiny_cell(name: str) -> spec.Cell:
    """The cell ``name`` of ``BENCHMARK.json`` at a size the CPU runs in
    seconds."""
    cell = spec.cell(name)
    cell.config = {**cell.config, **TINY_CONFIG}
    cell.traffic = {**cell.traffic, **TINY_TRAFFIC}
    if "num_workers" in cell.traffic:
        cell.traffic["num_workers"] = 2
    return cell


def workloads() -> list[str]:
    return [w["name"] for w in spec.load_benchmark()["workloads"]]
