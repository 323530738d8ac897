"""The benchmark of ``fsrl_torch`` on the GPU.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Everything that belongs to one configuration, traffic mix or
per-layer metric sits in a file of its own, found by its name:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: a cell's env batch, horizon and dispatch
  settings;
* ``limits/<cell>.json``: the limits of the comparison that decides
  ``correct``, with the readings they were set from;
* ``metrics/<metric>.py``: the reader of one per-layer metric;
* ``drivers/<driver>.py``: how a configuration's program is built and
  driven (named by the configuration's ``driver``);
* ``reference/<algorithm>.py``: the plain reference (named by the
  configuration's ``algorithm``);
* ``flops/<algorithm>.py`` and ``flops/k2.py``: the frozen FLOP and byte
  arithmetic; ``peaks.json``: the card's published peaks.

Nothing here imports JAX or the JAX package.
"""
