"""The port's kernel tools: timing and probe scripts for the H100.

The counterparts of the reference's ``tools/conv_micro.py``,
``tools/kernel_variants.py`` and ``tools/mosaic_bisect{,2,3}.py``, each run
as ``python -m dlwp_cs_tpu_torch.tools.<name>`` on the card, or with
``--device cpu --small`` through the kernels' plain versions at small sizes
(where they print no times).  :mod:`~dlwp_cs_tpu_torch.tools.timing` holds
the timing they share with ``chip_smoke.py``;
:mod:`~dlwp_cs_tpu_torch.tools.probes` the probe kernels' wrappers and plain
versions.
"""
