"""The benchmark of ``dlwp_cs_tpu_torch`` on NVIDIA GPUs.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Everything a cell needs is found by name: its configuration under
``configs/``, its traffic under ``traffic/`` (read by the load it names
under ``loads/``), its correctness limits under ``workloads/``, each
metric's reader under ``e2e/`` or ``metrics/``, the FLOP counts of a model
kind under ``flops/`` and the kernels counted as 3x3 convs under
``kernels/``.  ``reference/`` is the plain PyTorch reference.
"""
