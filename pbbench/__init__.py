"""The benchmark of longreadselfcorrect_tpu_torch's pbcorrect on one GPU.

``python3 pbbench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once.  A cell names a
configuration (``configs/<name>.json``: genome, read model, coverage and
pbcorrect's flags) and a traffic mix (``traffic/<name>.json``: which reads
the window corrects, in what order, in batches of how many); each per-layer
metric has a reader of its own in ``metrics/<name>.py``.  ``reference/`` is
the plain host corrector that decides ``correct``.
"""
