"""The turn runner of the A/B tools (``tools/dense_ab.py``,
``tools/gat_ab.py``): one subcommand of a tool in two checkouts, each in a
process of its own, in turns on one card (parent, change, change, parent),
the change being the checkout the tools lie in."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

CHANGE = Path(__file__).resolve().parent.parent


def call(argv, cwd, log) -> str:
    """Run ``argv`` in ``cwd`` with its output into the file ``log``;
    print its time, and on failure the log's tail, then stop. Returns the
    output."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    with open(log, "w") as f:
        rc = subprocess.run(argv, cwd=cwd, stdout=f, stderr=subprocess.STDOUT,
                            env=env).returncode
    print(f"{' '.join(argv[1:3])} in {cwd}: rc {rc}, "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    if rc != 0:
        print(open(log).read()[-4000:])
        raise SystemExit(rc)
    return open(log).read()


def print_tagged(text: str, tag: str) -> None:
    """The lines of ``text`` that start with ``tag``."""
    for line in text.splitlines():
        if line.startswith(tag + " "):
            print(line, flush=True)


def in_turns(parent: str, out: str, prefix: str, setup, turn,
             after=None) -> int:
    """In a temporary root (a graph takes ~1.3 GB; removed after): print
    the card, run ``setup(root)`` once, then ``turn(cwd, root, tag)`` with
    tags parent0, change1, change2 and parent3 in the parent's checkout
    and this one, then ``after(root)`` where given."""
    os.makedirs(out, exist_ok=True)
    root = tempfile.mkdtemp(prefix=prefix)
    try:
        sys.path.insert(0, str(CHANGE))
        import chip_smoke as cs

        print(f"card: {cs.card_line()}", flush=True)
        setup(root)
        turns = [("parent", parent), ("change", str(CHANGE)),
                 ("change", str(CHANGE)), ("parent", parent)]
        for i, (side, cwd) in enumerate(turns):
            turn(cwd, root, f"{side}{i}")
        if after is not None:
            after(root)
        return 0
    finally:
        shutil.rmtree(root, ignore_errors=True)
