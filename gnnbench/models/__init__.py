"""One file a model the benchmark knows, found by the configuration's
``model`` (``models/<model>.py``): its weights' layout, its layers'
widths, its FLOPs a step and its kernels' bounds (the yardstick's), and
the port's model objects the drivers compose. Its plain equations are
``reference/<model>.py``, which imports nothing of the port."""

from __future__ import annotations

import importlib


def load(cfg: dict):
    """The model's file; the configuration has to state the form the
    port builds (the file's ``FORM``), where it departs from its source."""
    model = importlib.import_module(f"gnnbench.models.{cfg['model']}")
    wrong = {k: cfg.get(k) for k, v in model.FORM.items() if cfg.get(k) != v}
    if wrong:
        raise ValueError(f"the port's {cfg['model']} is built with "
                         f"{model.FORM}; the configuration states {wrong}")
    return model
