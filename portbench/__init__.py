"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  Cells, configurations, traffic mixes and metric readers are found
by name in files of their own (``configs/``, ``traffic/``, ``clients/``,
``references/``, ``metrics/``), so a new cell is new files.  Nothing
here imports JAX or the JAX package; only clients import ``repro_torch``,
and only the references judge it.
"""
