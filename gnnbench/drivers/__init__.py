"""One driver a traffic ``mode``, found by name (``drivers/<mode>.py``).

A driver's ``Program(cfg, traffic, graph, weights, program_seed,
traffic_seed, device, ranks)`` composes the port's objects for the mode
in one of the cell's processes (``run.Ranks``: its rank, their number
and where they meet; ``run.py`` starts one a chip unless the traffic
names its ``processes``), keeps the seconds of its parts in
``setup_s``, and has:

- ``step()``: one step of the window's loop, the call and the feed, as
  the port's trainer composes them; returns ``(sample_wait_s,
  launch_s)``, ``sample_wait_s`` None where nothing is waited for;
- ``checked(n)``: the first ``n`` steps through ``step()``, returning the
  readings ``check.py`` compares (the losses, the first step's gradient
  from the optimizer's state, the weights after the last) and each
  step's sample for the judge;
- ``finish()``: the closing reads of the steps since the last
  ``finish()``; returns the training targets the port counted in them;
- ``counts()`` and ``kernel_bounds()``: each step's ``LayerCounts`` and
  kernel bound seconds, of the steps run while ``counting`` was True (a
  traced run's set-up steps: the window holds no counting);
- ``judge(gi, steps)``: the samples judged, ``(violations, refs, labels)``;
- ``buildables`` (the kernels it needs built), ``builds_sampler``,
  ``stats()`` (the program's counters) and ``close()``.
"""
