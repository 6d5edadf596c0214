"""The benchmark of ``muggled_dpt_tpu_torch`` (the PyTorch and CUDA port) on an
NVIDIA H100.

``python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Everything
that belongs to one configuration, traffic mix, metric or family sits in a
file of its own, found by the name that ``BENCHMARK.json`` gives:

* ``configs/<config>.json``: the model's widths, its source and its family;
* ``traffic/<traffic>.json``: batch, max side, frame size, frame pool, loop;
* ``limits/<workload>.json``: each number ``correct`` compares, with its limit
  and the readings the limit was set from;
* ``metrics/<metric>.py``: the reader of one metric (``UNIT``, ``LAYER``,
  ``MOVES``, ``read(record)``);
* ``weights/<family>.py``, ``reference/<family>.py``, ``counts/<family>.py``:
  the original-layout weights made on the card from the seed, the plain
  float32 reference, and the operation and byte counts.

Nothing here imports ``jax`` or the JAX package, and nothing under
``reference/`` imports the port."""
