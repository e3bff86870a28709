"""The benchmark of ``repro_torch``: graph jobs back to back on a cell's
cards.

A run makes its cell's graph on the device from ``--seed``, bulk-loads it
with ``repro_torch.core.load_graph``, warms one job, then runs jobs back to
back for the window (one analyst, a closed loop with one job in flight)
through ``repro_torch.core.run_host`` on one chip, or through
``repro_torch.core.sharded.run_sharded`` over one rank a chip where the
cell asks for several, and judges a seeded sample of the jobs' answers
against a plain reference. ``BENCHMARK.json`` at the root of
the checkout names the cells; everything that belongs to one configuration,
one traffic mix, one algorithm or one metric is a file of its own here,
found by its name:

- ``configs/<config>.json``: the graph (generator and sizes);
- ``generators/<generator>.py``: the draw of a configuration's graph;
- ``traffic/<mix>.json``: the jobs (program, arguments, plan, limits);
- ``draws/<draw>.py``: an argument drawn for each job of a mix;
- ``algorithms/<algorithm>.py``: the plain reference of an algorithm, its
  control, its comparison and the edges each superstep has to send;
- ``metrics/<metric>.py``: the reader of one metric.

Run: ``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout.
"""
