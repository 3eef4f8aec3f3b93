"""The port's tools: kernel timing and probe scripts, and the measurement
tools, for the H100.

The counterparts of the reference's ``tools/conv_micro.py``,
``tools/kernel_variants.py`` and ``tools/mosaic_bisect{,2,3}.py`` (the
kernels), and of its measurement tools ``tools/capacity_bench.py`` (the
train step across model scales), ``trainer_wallclock.py`` (``Trainer.fit``
and its input pipeline), ``serve_bench.py`` (the batched rollout, ``auto``
against int8), ``ensemble_bench.py`` (folded members against sequential
rollouts) and ``scaling_bench.py`` (the train step over meshes), each run
as ``python -m dlwp_cs_tpu_torch.tools.<name>`` on the card, or with
``--device cpu --small`` through the plain versions at small sizes (where
they print no times).  :mod:`~dlwp_cs_tpu_torch.tools.timing` holds the
timing they share with ``chip_smoke.py``;
:mod:`~dlwp_cs_tpu_torch.tools.probes` the probe kernels' wrappers and plain
versions; :mod:`~dlwp_cs_tpu_torch.tools.xchg_probe` times a round trip of
the band-row exchange's signals between ranks sharing the card, spinning
in a kernel and as stream waits.
"""
