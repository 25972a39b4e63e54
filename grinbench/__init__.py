"""The benchmark of ``volumeraytracer_tpu_torch`` on an NVIDIA H100.

``python grinbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix,
driver or per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

  configs/<config>.json          the field, its sizes, source and cuts
  traffic/<traffic>.json         the rays or camera and the driver's name
  drivers/<driver>.py            set-up, window and check of one entry point
  limits/<cell>.json             the limit of each number the check compares
  layer_metrics/<metric>.py      the reader of one per-layer metric
  rooflines/<family>.py          the operations and bytes of a kernel family

The plain reference under ``reference/`` imports neither the program nor
JAX.
"""
