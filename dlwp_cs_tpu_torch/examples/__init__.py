"""The example workflows, the counterparts of the reference's
``examples/01..07``: build a predictor store, train, forecast, verify,
fine-tune on sequences, serve over HTTP, and run an ensemble and export.

Each module is a command with the reference script's arguments plus
``--device`` (default: the GPU, which must exist)::

    python -m dlwp_cs_tpu_torch.examples.01_build_dataset --workdir W --grid 24
    python -m dlwp_cs_tpu_torch.examples.02_train --workdir W
    ...

and each ``main(argv=None)`` is a thin layer over functions of its module
that take the store, the model directory or the estimator as arguments, so
that a program can chain the steps in one process (the module names start
with a digit: ``importlib.import_module("dlwp_cs_tpu_torch.examples.
02_train")``).  The steps chain through ``--workdir``: ``predictors_cs.h5``
(HDF5, which needs h5py), ``model/``, ``forecast.npz`` and
``rollout_artifact/``.
"""
