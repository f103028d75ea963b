"""The port's benchmark: a harness driven by data.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` against the PyTorch
and CUDA package ``repro_torch`` on the card it is started on.  Each
configuration, cell, traffic kind, metric reader and reference family
is a file of its own, found by its name.
"""
