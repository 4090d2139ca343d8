"""The benchmark of ``rusty_compression_tpu_torch``, the PyTorch/CUDA port.

``python3 benchmark/run.py --workload <config>.<traffic> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on
the card it is started on and prints one JSON line. Everything that belongs
to one configuration, traffic mix, cell or per-layer metric sits in a file
of its own, found by its name:

* ``configs/<config>.json``: the data (BEM Laplace blocks) and its source;
* ``traffic/<traffic>.json``: the port's entry, its arguments and the kind
  of output the check judges;
* ``cells/<config>.<traffic>.json``: the numbers the check compares, their
  limits, the readings each limit was set from, and the control;
* ``metrics/<metric>.py``: a reader of one per-layer metric from the
  traced run's records;
* ``checks/<output>.py``: the numbers judged on one kind of output;
* ``reference/``: the plain references (no kernel, nothing of the port).

``core/`` holds what every cell shares: the loader, the data generator,
the closed-loop window, the trace reduction, the frozen peaks and panel
bounds, and the guard against JAX.
"""
