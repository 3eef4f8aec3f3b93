#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels, run its kernel tools, serve and
train the flagship U-Net and the ConvLSTM on one GPU, build a predictor
store from lat-lon fields on it and train from that store, serve the U-Net
quantized to int8, run the lat-lon models and the registry, serve ensembles of
the U-Net, exported artifacts as CUDA-graph replays and the HTTP front end,
serve the U-Net spatially sharded over 4 ranks that share the GPU,
through gloo and through CUDA IPC, with a rank-0 front end, and train it
under data-parallel and spatial meshes of those 4 ranks, and chain the
seven example workflows at full width, and run the five measurement tools.

    python3 chip_smoke.py [--out DIR]

Run from the repository root on a machine with an NVIDIA Hopper card
(sm_90a), ``nvcc`` and PyTorch built for CUDA.  Phases:

1. print the card's name and power limit (``nvidia-smi``), torch and CUDA;
2. build the kernels from ``dlwp_cs_tpu_torch/csrc``, one ``nvcc`` per
   source, all at once: the fused cubed-sphere conv, its backward (the dx
   and dw kernels), the xring conv's ring-fix kernels (the fixes and the
   fused select + apply), the band-row exchange and the band conv fused
   with it, the conv on the tensor cores (kn2row, im2col), the probes,
   the int8 base conv and the device collectives (send, reduce, unpack);
3. at each conv shape of the flagship C48 U-Net (and one n=96 shape with
   many row tiles), at batch 1, 8 and 16, in float32 (3xTF32) and bfloat16,
   both on the tensor cores: hold the forward kernel against its plain torch
   version, and time the kernel, the plain version and ``F.conv2d`` (one
   face-grouped cuDNN call on the padded faces) with CUDA events over
   CUDA-graph replays, beside the least time the card could take;
4. the same for the dx and dw kernels at each conv shape at the training
   batch 16, against ``torch.ops.aten.convolution_backward`` of that cuDNN
   conv (its dgrad is the padded-input cotangent, its wgrad summed over each
   face group the kernel gradient); then the tensor-core kernels against
   the CUDA-core instances they replaced (``ops/conv_variants.py``), both
   held against the plain version and timed in turns (old, new, new, old),
   beside cuDNN and the bound: #1 at batch 1, 8, 16 and n=96 and #8 and #9
   on a rank's block, #4 and #5 (dw) at the step's shapes, in bfloat16 and
   float32 (3xTF32); #12 at conv_micro's levels, #14 there in both types;
5. the ring-fix kernels at each distinct conv shape of the flagship U-Net
   and the ConvLSTM's two gate-conv shapes, at batch 1 and 16, in float32
   and bfloat16: the ring blocks on the tensor cores (#6, #7) and the
   CUDA-core kernels they replaced (``ops/conv_variants.py``), all held
   against their plain versions (#7 also bitwise against itself: the
   corner handoff) and timed in turns (old, new, new, old) beside the
   plain versions and the bounds (``ring_summary``: a ConvLSTM call's and
   step's 4 gate convs); beside them the whole xring conv (two cuDNN SAME
   convs, the ghost strips, the fused kernel, the bias), the fused conv
   kernel and one face-grouped cuDNN call on the same shape;
5a. shapes past a kernel's plan: the wrappers' plans (``fused_fits``,
   ``xring_fits``) keep every flagship shape on its kernels and refuse
   (1, 6, 128, 128, 32) -> 32 in float32 with a gradient (the dw plan),
   where ``cs_conv`` takes the ring-fix composition: one training step
   there launches no kernel and matches the plain path; then a CUDA graph
   of the fused ring apply captured at batch 1 and replayed after its
   arrival counts grew to a second buffer, an eager batch-16 call ran on
   that one and other memory was allocated: bitwise repeatable, equal to
   the plain version, every count buffer alive and zero;
5b. run the kernel tools' entry points once each (``dlwp_cs_tpu_torch.tools``:
   ``conv_micro``, ``kernel_variants`` and its ``--chain``, ``mosaic_bisect``
   in bfloat16 and float32), the path of kernels #3 and #12-#16, with every
   launch count set to 0 before and read after.  The tools hold each
   kernel's output on their own inputs against its plain version (#12 also
   bitwise against #1, every probe of #16 at the reference scripts' shapes
   with its plain and library times); #12's and #16's lines come from
   these rows.  Then: #3 (kn2row) and #13 (im2col) on the tensor cores,
   bfloat16, at each conv shape of the flagship U-Net at batch 1, at
   conv_micro's levels and the decoder's shape at batch 16, and past the
   first designs' plans (Cout = 256, the packed layout's 128 channels at
   batch 4, n = 48 with 128 -> 128 at batch 1), against their plain
   versions and #1 on the same strips and bitwise against themselves,
   timed beside #1, the face-grouped cuDNN call and the bound, each in
   turns (old, new, new, old) with the kernel of its first design where
   that plans the shape (``npack_summary``, ``im2col_summary``); #14 (dx with the raw
   ring) at conv_micro's levels in float32 and bfloat16, its interior and
   ring bitwise equal to #4's, timed beside ``F.conv_transpose2d``; #15 in
   both types bitwise equal to 3·x (also at C = 39, 3 and 24), timed in
   turns with the kernel its redesign replaced, beside ``x * 3``; every
   #16 probe in both types against its plain version and bitwise against
   itself, timed in turns with the kernel its redesign replaced (the
   ``_v1`` probes), beside its library call and bound (``probe_summary``);
6. serve 14-day forecasts (28 calls of 6 h x 2) through ``ForecastService``
   in bfloat16 and float32 of the flagship C48 U-Net (filters 32/64/128,
   12 -> 8 channels, seeded weights; 280 conv kernel launches per
   forecast) and of the full-width ConvLSTM (filters 32/32, 3x3 gates, 1x1
   head, backend ``xring``; 112 launches of the fused ring kernel): finite
   fields, the first two model calls equal to the plain path on the card, 8
   concurrent submits coalesced into at most 2 dispatches and equal to
   direct forecasts;
6a. serve 14-day perturbed-IC ensembles of the flagship U-Net in bfloat16
   and float32 (``ForecastService.forecast_ensemble``, 8 members folded
   into one rollout at batch 8: 280 launches of #1 per ensemble, each at
   batch 8): finite mean, spread and members; the control member against
   ``forecast`` of the same window (bitwise equality recorded; within 1e-4
   / 1e-2 std); the first two model calls against the plain path on the
   card; 3 concurrent ``submit_ensemble`` calls with one key in one
   dispatch, equal to ``forecast_ensemble`` of the stacked windows with the
   same seed; ``DLWPEstimator.forecast`` from a seeded ``MemoryStore`` (2
   inits, 4 steps) against ``ForecastService.forecast`` of the same
   windows; the wall time, the device's busy time and idle share in one
   profiled ensemble, the launches;
7. at each 3x3 shape of the flagship U-Net cut into 4 row bands (h = 12,
   6, 3 at n = 48, 24, 12) and into 2x2 tiles (24^2, 12^2, 6^2), at batch 1
   and 8, in float32 and bfloat16: hold the band and tile launches of the
   forward kernel (#8, #9) against its plain version on the same block and
   ghost strips, and time them beside the plain version, one face-grouped
   cuDNN call on the padded block and the bound;
8. train both models in bfloat16 and float32 at batch 16 with Adam (lr
   1e-3) on MSE: a ``MemoryStore`` of seeded fields -> ``SeriesDataset`` ->
   ``prefetch_to_device`` -> ``Trainer.fit`` for 20 optimizer steps (U-Net:
   10 forward, 10 dw and 9 dx launches a step; ConvLSTM: 4 fused ring
   kernel launches a step and no backward kernel); step 1's gradients
   finite and non-zero for every parameter, equal to the plain path's on
   the card and bitwise repeatable; 20 finite losses; a loss that falls
   when the trainer fits one fixed batch; the step time and the device's
   busy and idle time in one profiled step; for the float32 U-Net, step 1's
   gradients also through the plain path in float64, each float32 path's
   error against them per tensor, and the leaky-ReLU pre-activations whose
   sign differs between the runs; in the float32 U-Net's profiled step, no
   device time in the CUDA-core dx and dw kernels; in the ConvLSTM's
   profiled forecasts and steps, device time in the ring blocks and none
   in the CUDA-core ring kernels;
8a. export (``serve/export.py``): the flagship U-Net in bfloat16 and
   float32 at window batch buckets 1 and 8, the ConvLSTM (``xring``) in
   bfloat16 at bucket 1, each a ``torch.export`` program of one model call
   per bucket calling kernels #1 / #7 as operators (``ops/library.py``),
   loaded with no estimator; each bucket's first 14-day forecast runs the
   program eagerly, captures the 28 calls as one CUDA graph and replays
   it (280 / 112 launches while capturing, none from the host after); the
   exported forecast against the live service's (bitwise equality
   recorded; within 1e-6 std in float32, 2**-6 of the largest normalized
   output in bfloat16), replays bitwise repeatable; the seconds to export,
   load and capture; wall medians of the exported and the live forecast
   (also through the operators) in turns; one profiled exported and live
   forecast each (busy time, idle share, the kernels in the replay, the
   host's CUDA calls);
8b. HTTP (``serve/http.py``): a ``ForecastHTTPServer`` on an ephemeral
   port over the bfloat16 U-Net; 8 concurrent ``forecast_request`` calls
   in one dispatch, bitwise equal to the direct batch; 3 ``ensemble_request``
   calls with one seed in one dispatch, bitwise equal to the stacked call;
   one request's round trip;
8c. the data pipeline (``remap/``, ``data/``): build the exact
   conservative weights ERA5 1 degree (181 x 360, poles included) <-> C48
   with the C++ generator (compiled with the kernels, above); make the
   analytic sources of ``dlwp_cs_tpu_torch/examples/01_build_dataset.py``
   (``synthetic_sources``: z500, z1000,
   tau300-700, t2m and two constants) for 120 days at 6 h on that grid;
   the example's ``build_store`` remaps them on the card
   (``Preprocessor.data_to_series``, 256 times a batch, no kernel launch),
   twice (bitwise equal): the store that 9b chains from, held against ``RemapWeights.apply_numpy``
   on the host (every time, the constants, the mean and std); one batch's
   remap timed with CUDA events beside the plain version's host time; the
   store written and opened as HDF5 where h5py imports, else
   ``write_store``'s ``ImportError`` checked and the ``MemoryStore`` kept;
   ``DLWPEstimator.fit`` of the flagship bf16 U-Net, 10 steps at batch 16
   from the store's head (#1, #4, #5 counted); a 14-day forecast from its
   first window (280 launches of #1) remapped back to 181 x 360 on the card
   (``remap_cs_to_ll``) and held against the plain version;
8d. quantized serving (``ops/quant.py``): the int8 base conv
   (``csrc/cs_conv3x3_int8.cu``) at each flagship conv shape, batch 1 and
   8, bf16 and f32 out, bitwise against its plain version, timed beside
   it, ``torch._int_mm`` on the gathered columns (the gather apart) and #1;
   ``ForecastService(quantize=True)`` of the flagship U-Net, bf16 and f32:
   14-day forecasts and 8-member ensembles (280 launches of the int8
   kernel each, no #1 and no cuDNN convolution), two forecasts bitwise
   equal, the first two calls bitwise equal to the plain version's, the
   error against the live service in std units, walls in turns with it
   and one profiled forecast; the int8 ConvLSTM (bf16, 112 launches)
   beside the ``xring`` one of the same weights;
8e. the lat-lon models and the registry: ``LatLonUNet(UNetConfig())`` on
   a 96 x 192 grid (a forward at batch 1, an Adam step at batch 2), the
   lat-lon ConvLSTM layer over 4 steps and the reference registry's
   docstring spec at C48 (#1 in the forward, #1 and #5 in a train step),
   bf16 and f32, each timed and held against its CPU run of the same
   weights (f32 1e-4, bf16 2**-6 of the largest output);
8f. the barotropic baseline: the Rossby-Haurwitz case 14 days (672 RK4
   steps of 30 min) in f32 on the card at T42 (65 x 130) and T85 (130 x
   260), the first day against the CPU's float64 run (1e-4 of the largest
   |zeta|), the reference test's criteria at day 14, the wall time, steps/s
   and one profiled day;
8g. the utilities: ``utils.trace`` around a bf16 step (the trace names #1,
   #4 and #5), ``Timer.time_fn`` of a model call, ``conv_roofline`` beside
   ``tools/timing.py::bound`` at the U-Net's conv shapes, and each plot
   drawn to a PNG under ``--out`` (or, without matplotlib, its
   ``ImportError`` checked);
9. spawn 4 ranks in a gloo group on the card (kernel libraries built
   before) and, in bfloat16 and float32, serve 14-day forecasts of the
   flagship U-Net (the same seeded weights on every rank): at batch 1
   through ``make_spatial_apply`` driven by ``TimeSeriesEstimator`` on a
   (1, 4) mesh with ``band_conv="pallas"`` (280 launches of #8 per rank),
   with ``band_impl="rdma", band_conv="pallas"`` (280 of #10 and 280 of
   #8: the band rows by remote copies into the neighbours' buffers, mapped
   by CUDA IPC, the waits for them held in the GPU's front end) and with
   ``band_conv="overlap"`` (280 of #11: the band conv with the band-row
   exchange around its two passes, nothing else), and on a (1,
   2, 2) mesh (280 of #9), and at batch 3 through
   ``ForecastService(mesh=create_mesh(data=2, spatial=2))`` (the band
   ring-fix conv, data-axis padding, no kernel), then its ensemble of 3
   members on data = 2 (padded by one window, the perturbations handed in)
   and its rank-0 front end (3 ``submit`` calls on rank 0 while ranks 1-3
   ``follow()``: one dispatch, bitwise equal to the collective forecast of
   the same windows); each held, on every rank,
   against the one-card forecast in units of the field's std (the kernel
   paths, #11's included, which sums every output in #8's order, to 1e-6
   in float32 and 2**-6 of the value in bfloat16, the service to 1e-3 and
   2**-3), with the wall time of 4 ranks sharing one card and the
   collectives each rank issued, every one on the card (``host_calls ==
   0``; the send, reduce and unpack kernels of ``csrc/cs_collectives.cu``
   launched; the front end's broadcasts of host inputs counted apart);
   before them, on every rank, the exchange probe (``tools/xchg_probe.py``:
   a round trip to both ring neighbours, spinning in a kernel and as
   stream waits, in turns), the collectives phase (every ``ppermute``,
   ``all_gather`` and ``psum`` one model call issues on 4 bands and on
   2 x 2 tiles in both dtypes, and the data-axis gradient bucket, each
   through the device transport bitwise against the plain version over
   gloo on fresh inputs, timed with CUDA events around 20 back-to-back
   calls in turns with the plain version), then #10 and #11 at each
   flagship conv shape on 4 bands, batch 1 and 8, both dtypes: #10
   bitwise against the ``ppermute`` pair, #11 against its plain version
   and bitwise against #8 on the exchanged strips, their device times per
   call (at batch 1 in turns with their first designs, ``*_v1``, one
   cooperative kernel that spins, time slices of the other ranks
   included; at batch 8 the first designs held against the same
   references, untimed), the plain versions' and cuDNN's times and the
   bounds; and the host time of one ghost-strip ``all_gather``, of one
   band and one tile conv with its exchange, of the band rows by the
   ``ppermute`` pair and by #10, of a band conv with #10 and of a #11
   conv; then a group of 2 ranks: the probe, #10 and #11 at the same
   shapes on 2 bands at batch 1, and the collectives phase on 2 bands;
9a. spawn 4 ranks sharing the card again and train the flagship U-Net at
   global batch 16, in bfloat16 and float32, under ``MESH_TRAIN_PATHS``:
   ``data=4`` through the data-parallel step (#1, #4, #5 on each rank's
   block of 4), 4 row bands through the spatial step with
   ``band_conv="pallas"`` (#8), with ``band_impl="rdma"`` too (#10 + #8)
   and with ``band_conv="overlap"`` (#11), 2x2 tiles (#9) and ``data=2 x
   spatial=2`` with the area-weighted loss (#8); the band and tile
   kernels' backward is the ring-fix composition's.  Per path: one SGD
   step at learning rate 2**20, each rank's all-reduced gradients (the
   parameters' change over 2**20) against the one-card
   ``Trainer.train_step``'s on the same batch within 1e-4 (float32) and
   2**-6 (bfloat16) of each tensor's largest entry, every parameter
   moved, the parameters bitwise equal on every rank; then 4 Adam steps
   (launch counts set to 0 before, read after: 10 of #1, 9 of #4, 10 of
   #5 a step under ``data=4``, 10 of the block kernel a step on bands and
   tiles), a falling loss, bitwise equal parameters, each rank's step
   times and collectives (every one on the card); then one
   ``Trainer(mesh=data 4).fit``
   epoch (3 steps) on a seeded ``MemoryStore`` fed by
   ``prefetch_to_device(sharding=mesh)`` and one
   ``make_sharded_sequence_train_step`` step (sequence 2) on 4 bands; last,
   9b's ``05_sequence_train --mesh 2x2`` on the head of 8c's store (the
   group is started once for both);
9b. the example workflows (``dlwp_cs_tpu_torch.examples``, the counterparts
   of ``examples/01..07``) chained in this process at full width, every
   launch count set to 0 before each step and read after: 01 is 8c's
   ``build_store`` (the C48 store of 480 times, exact conservative
   weights), its ``MemoryStore`` handed to each step (the line says
   whether 8c could write and read it as ``predictors_cs.h5``); 02 trains the flagship U-Net in bfloat16 (2 epochs at batch 16: 10
   forward, 9 dx and 10 dw launches a step, 10 forward a validation batch)
   and the ConvLSTM (filters 32/32, its default conv backend, float32, 1
   epoch: 4 forward, 3 dx and 4 dw launches a step) and saves the models;
   03 forecasts 14 days from 4 inits (280 launches of #1 at batch 4); 04
   scores them against persistence and climatology (RMSE, ACC; the plots,
   or their ``ImportError`` naming matplotlib); 05 fine-tunes on sequences
   of 3 (float32, filters 32/64/128, batch 8, 2 steps, the store's first 64
   times) on one card and
   under ``--mesh 2x2`` on 4 ranks sharing the card (run by 9a's group;
   the band ring-fix conv: no kernel), its per-step losses within 1e-4 of
   the one card's; 06
   serves its self-test (3 concurrent HTTP requests of 28 calls) live and
   from 07's artifact; 07 runs an 8-member 14-day ensemble (CRPS, RMSE of
   the mean and spread at days 1, 3, 5 and 14) and the export round trip,
   the exported forecast bitwise equal to the live one; each step's wall
   seconds and launches, and the phase's seconds beside its 120 s budget
   (printed, not checked);
9c. the measurement tools (``dlwp_cs_tpu_torch.tools``, the counterparts
   of the reference's ``tools/capacity_bench``, ``trainer_wallclock``,
   ``serve_bench``, ``ensemble_bench`` and ``scaling_bench``): first the
   forward kernel with its weights streamed with each chunk (#1 under
   ``fwd_plan(..., stream=True)``) at the three bfloat16 shapes of the capacity sweep
   whose resident plan refuses ((12, 512 -> 512), (24, 768 -> 256), (24,
   512 -> 256) at batch 8, and in float32) and at the flagship's conv
   shapes (batch 1 and 16 in bfloat16, 1 in float32): against its plain
   version, bitwise equal to the resident mode wherever that plans, timed
   beside the resident mode, the plain version, cuDNN and the bound; then
   each tool's ``main`` at full width with its repeats and steps cut
   (``BENCH_RUNS``; every count set to 0 before each and read after) and
   the trainer's store path on a ``MemoryStore``: every capacity
   configuration keeps its 3x3 convs on #1/#4/#5 (``fallback == []``, a
   step launching #1 once a conv, streamed exactly at the convs whose
   resident plan refuses, as ``cs_conv3x3.stream_launches`` counts them a
   step and over the run), the trainer 10/9/10 launches a step,
   the 28-call rollouts 280 launches of #1 (auto) or of the int8 base
   conv (int8, within ``QUANT_TOL_STD`` of auto), the folded ensembles'
   member 0 bitwise equal to the batch-1 rollout, the scaling rows 1x1,
   4x1 and 2x2 (4 ranks sharing the card, so marked; every collective of
   theirs on the card);
10. print whether ``nvidia-cuda-mps-control`` is on the PATH and the card
   count (the route for measuring #10 and #11; nothing is started), the
   #3/#13 tables, the ensemble, export, HTTP, front-end and mesh-training
   lines again, the kernel line (JSON, with each kernel's launches per
   step and the ranks' step times under the mesh-training paths), the card line, and last ``{"ok": true, "device":
   {...}}``; before them, the seconds each phase took.

Any failed check raises, in any rank, so the script exits non-zero and
prints no result.
Details go to ``DIR/chip_smoke.json`` (default ``chip_smoke_out``).  TF32 is
off for cuDNN and matmuls throughout: every float32 result here is compared
(the xring conv's SAME convs run in full float32 whatever the flags say).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import importlib
import importlib.util
import json
from concurrent.futures import ThreadPoolExecutor
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))

# (n, Cin, Cout) of the 10 3x3 convs of one flagship C48 U-Net call, in order
FLAGSHIP_CONVS = [
    (48, 12, 32), (48, 32, 32),      # enc0
    (24, 32, 64), (24, 64, 64),      # enc1
    (12, 64, 128), (12, 128, 128),   # enc2 (bottleneck)
    (24, 192, 64), (24, 64, 64),     # dec1 (after the skip concat)
    (48, 96, 32), (48, 32, 32),      # dec0
]
EXTRA_SHAPES = [(96, 64, 64)]  # several row tiles per face
# (n, Cin, Cout) of the ConvLSTM's gate convs: [x_t (4 variables +
# insolation + 2 constants), h (32)] -> 4 x 32 gates, then [h1, h2]; one
# model call runs each twice (2 input times)
CONVLSTM_GATES = [(48, 39, 128), (48, 64, 128)]
CONVLSTM_CALL = [CONVLSTM_GATES[0]] * 2 + [CONVLSTM_GATES[1]] * 2
STEPS = 28  # 14 days of 2 x 6 h per call
# sharded forecasts at batch 1: (name, mesh, make_spatial_apply options)
SHARDED_PATHS = [
    ("band", "band", dict(band_conv="pallas")),  # #8, the ppermute pair
    ("tile", "tile", dict(band_conv="pallas")),  # #9
    ("band_rdma", "band", dict(band_impl="rdma", band_conv="pallas")),  # #10 + #8
    ("band_overlap", "band", dict(band_conv="overlap")),  # #11
]
TRAIN_BATCH = 16
TRAIN_STEPS = 20
# the device names of the port's kernels on the serving and training paths
# (the conv and dx kernels on the tensor cores in both dtypes, the dw kernel
# there in bfloat16 (cs_conv3x3_dw_tc_kernel) and as 3xTF32 in float32
# (cs_conv3x3_dw_tf32_kernel), the ring blocks of the fixes and the fused
# apply on them (cs_ring_fixes_tc_kernel, cs_xring_tc_kernel), the int8
# base conv of the quantized path (cs_conv3x3_int8_kernel); cs_conv3x3_kernel, cs_conv3x3_dx_kernel, cs_conv3x3_dw_kernel,
# cs_ring_fixes_kernel and cs_xring_apply_kernel are the CUDA-core timing
# rows, which no path runs).  The profiler's names hold the template
# arguments, so each is matched as a substring: none of these is a
# substring of another (checked in main).
KERNEL_NAMES = ("cs_conv3x3_kernel", "cs_conv3x3_tc_kernel", "cs_conv3x3_dx_kernel",
                "cs_conv3x3_dx_tc_kernel", "cs_conv3x3_dw_kernel", "cs_conv3x3_dw_tc_kernel",
                "cs_conv3x3_dw_tf32_kernel", "cs_ring_fixes_kernel", "cs_xring_apply_kernel",
                "cs_ring_fixes_tc_kernel", "cs_xring_tc_kernel", "cs_conv3x3_int8_kernel")
# the CUDA-core timing rows of the backward and of the ring, which no path runs
CUDA_CORE_BACKWARD = ("cs_conv3x3_dx_kernel", "cs_conv3x3_dw_kernel")
CUDA_CORE_RING = ("cs_ring_fixes_kernel", "cs_xring_apply_kernel")
SHARDS = 4  # ranks of the sharded phase: 4 row bands, or 2 x 2 tiles
PROBE_ROUNDS = 200  # round trips of each way of tools/xchg_probe.py, per turn
MESH_MEMBERS = 3  # the mesh ensemble's members: data = 2 pads one window
# the sharded forecasts against the one-card one over 14 days, per point
# |diff| <= rel * |ref| + abs in units of the field's std.  The service's
# band ring-fix conv sums float32 in another order and rounds bfloat16 at
# other points, carried through 28 calls.  Kernels #8, #9 and #11 sum each
# output as #1 does: 1e-6 in float32, and in bfloat16 2**-6 of the value (two
# to four bfloat16 ulps).  (rel, abs) by (path, dtype):
SHARDED_TOL = {("service", "float32"): (0.0, 1e-3), ("service", "bfloat16"): (0.0, 2.0**-3),
               ("kernel", "float32"): (0.0, 1e-6), ("kernel", "bfloat16"): (2.0**-6, 1e-6)}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def conv_inputs(n, cin, cout, b, dtype, gen):
    """``(x, ext, ks, bs)`` of one whole-face conv on the card, drawn from
    ``gen``: weights scaled by ``(9 Cin)**-0.5``, biases by 0.1."""
    from dlwp_cs_tpu_torch.ops.halo import ext_strips

    dev = torch.device("cuda")
    x = torch.randn((b, 6, n, n, cin), generator=gen, device=dev).to(dtype)
    scale = (9 * cin) ** -0.5
    ks = [(torch.randn((3, 3, cin, cout), generator=gen, device=dev) * scale).to(dtype)
          for _ in range(2)]
    bs = [(torch.randn((cout,), generator=gen, device=dev) * 0.1).to(dtype) for _ in range(2)]
    return x, ext_strips(x), ks, bs


def conv_case(n, cin, cout, b, dtype, gen):
    from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3, cs_conv3x3_plain
    from dlwp_cs_tpu_torch.ops.padding import cs_pad
    from dlwp_cs_tpu_torch.tools.timing import bf16_excess, bound, face_grouped, graph_ms

    x, ext, ks, bs = conv_inputs(n, cin, cout, b, dtype, gen)
    args = (x, ext, *ks, *bs)
    ours = cs_conv3x3(*args)
    ref = cs_conv3x3_plain(*args)
    torch.cuda.synchronize()
    err = float((ours.float() - ref.float()).abs().max())
    if dtype == torch.float32:
        tol = "1e-4 abs"
        ok = err <= 1e-4
    else:
        tol = "2**-7*|ref| + 1e-4"
        ok = bf16_excess(ours, ref) <= 1e-4
    # one cuDNN call computing the same function: the padded faces (built
    # outside the timed region) through a conv grouped by face
    p, w = face_grouped(cs_pad(x, 1), ks)
    bias = torch.cat([bs[0]] * 4 + [bs[1]] * 2)
    lib = F.conv2d(p, w, bias, groups=6)
    lib = lib.reshape(b, 6, cout, n, n).permute(0, 1, 3, 4, 2)
    lib_err = float((lib.float() - ref.float()).abs().max())
    before = cs_conv3x3.launches
    ms = graph_ms(lambda: cs_conv3x3(*args), 20)
    cs_conv3x3.launches = before  # timing launches are not the main path's
    plain_ms = graph_ms(lambda: cs_conv3x3_plain(*args), 3)
    library_ms = graph_ms(lambda: F.conv2d(p, w, bias, groups=6), 20)
    item = x.element_size()
    nbytes = item * (x.numel() + ext.numel() + 2 * ks[0].numel() + 2 * cout
                     + b * 6 * n * n * cout)
    ops = 2 * b * 6 * n * n * 9 * cin * cout
    return {
        "n": n, "cin": cin, "cout": cout, "batch": b, "dtype": str(dtype).split(".")[-1],
        "max_abs_err": err, "tolerance": tol, "ok": ok, "library_max_abs_err": lib_err,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **bound(nbytes, ops, dtype),
    }


def bwd_case(n, cin, cout, b, dtype, gen):
    """The dx and dw kernels at one conv shape: ``(dx_case, dw_case)``."""
    from dlwp_cs_tpu_torch.ops.halo import ext_strips
    from dlwp_cs_tpu_torch.ops.hopper_conv import (
        cs_conv3x3_dw,
        cs_conv3x3_dw_plain,
        cs_conv3x3_dx,
        cs_conv3x3_dx_plain,
    )
    from dlwp_cs_tpu_torch.ops.padding import cs_pad
    from dlwp_cs_tpu_torch.tools.timing import bf16_excess, bound, face_grouped, graph_ms

    dev = torch.device("cuda")
    x = torch.randn((b, 6, n, n, cin), generator=gen, device=dev).to(dtype)
    g = torch.randn((b, 6, n, n, cout), generator=gen, device=dev).to(dtype)
    scale = (9 * cin) ** -0.5
    ks = [(torch.randn((3, 3, cin, cout), generator=gen, device=dev) * scale).to(dtype)
          for _ in range(2)]
    ext = ext_strips(x)
    launches = (cs_conv3x3_dx.launches, cs_conv3x3_dw.launches)
    dx, d_ext = cs_conv3x3_dx(g, *ks)
    dw = cs_conv3x3_dw(x, ext, g)
    ref_dx, ref_ext = cs_conv3x3_dx_plain(g, *ks)
    ref_dw = cs_conv3x3_dw_plain(x, ext, g)
    torch.cuda.synchronize()
    dx_err = max(float((a.float() - r.float()).abs().max())
                 for a, r in ((dx, ref_dx), (d_ext, ref_ext)))
    if dtype == torch.float32:
        dx_tol, dx_ok = "1e-4 abs", dx_err <= 1e-4
    else:
        dx_tol = "2**-7*|ref| + 1e-4"
        dx_ok = max(bf16_excess(dx, ref_dx), bf16_excess(d_ext, ref_ext)) <= 1e-4
    # f32 sums over every pixel of a face group, in another order
    dw_err = max(float((a - r).abs().max()) for a, r in zip(dw, ref_dw))
    dw_scale = max(float(r.abs().max()) for r in ref_dw)
    dw_ok = dw_err <= 1e-5 * dw_scale
    # one cuDNN call each: convolution_backward of the face-grouped conv on
    # the padded faces (dgrad = the padded-input cotangent; wgrad per face)
    p, w = face_grouped(cs_pad(x, 1), ks)
    go = g.permute(0, 2, 3, 1, 4).reshape(b, n, n, 6 * cout).permute(0, 3, 1, 2)
    conv_bwd = torch.ops.aten.convolution_backward

    def lib(mask):
        return conv_bwd(go, p, w, [6 * cout], [1, 1], [0, 0], [1, 1], False, [0, 0], 6, mask)

    lib_dk = lib([False, True, True])[1].reshape(6, cout, cin, 3, 3).permute(0, 3, 4, 2, 1)
    lib_dw_err = float((lib_dk[:4].float().sum(0) - ref_dw[0]).abs().max())
    ms_dx = graph_ms(lambda: cs_conv3x3_dx(g, *ks), 10)
    ms_dw = graph_ms(lambda: cs_conv3x3_dw(x, ext, g), 10)
    cs_conv3x3_dx.launches, cs_conv3x3_dw.launches = launches  # not the main path's
    plain_dx = graph_ms(lambda: cs_conv3x3_dx_plain(g, *ks), 2)
    plain_dw = graph_ms(lambda: cs_conv3x3_dw_plain(x, ext, g), 2)
    lib_dx = graph_ms(lambda: lib([True, False, False]), 10)
    lib_dw = graph_ms(lambda: lib([False, True, True]), 10)
    item = x.element_size()
    ops = 2 * b * 6 * n * n * 9 * cin * cout
    common = {"n": n, "cin": cin, "cout": cout, "batch": b,
              "dtype": str(dtype).split(".")[-1]}
    out = []
    for kind, err, tol, ok, ms, plain_ms, lib_ms, nbytes, extra in (
        ("dx", dx_err, dx_tol, dx_ok, ms_dx, plain_dx, lib_dx,
         item * (g.numel() + 2 * ks[0].numel() + dx.numel() + d_ext.numel()), {}),
        ("dw", dw_err, "1e-5 * max|ref|", dw_ok, ms_dw, plain_dw, lib_dw,
         item * (x.numel() + ext.numel() + g.numel()) + 4 * (2 * ks[0].numel() + 2 * cout),
         {"ref_abs_max": dw_scale, "library_dk_eq_max_abs_err": lib_dw_err}),
    ):
        out.append(dict(common, kernel=kind, max_abs_err=err, tolerance=tol, ok=ok, ms=ms,
                        plain_ms=plain_ms, library_ms=lib_ms, **bound(nbytes, ops, dtype),
                        **extra))
    return out


def ring_case(n, cin, d, b, dtype, gen):
    """The ring-fix kernels (#6 fixes, #7 fused apply) at one gate-conv
    shape, against their plain versions, each timed in turns (old, new,
    new, old) with the CUDA-core kernel it replaced (``ops/conv_variants.py``:
    ``ring_fixes_cudacore``, ``xring_fused_apply_cudacore``), which is held
    against the plain version too; the whole xring conv beside the fused
    conv kernel and one face-grouped cuDNN call on the same shape."""
    from dlwp_cs_tpu_torch.ops import conv_variants as cv
    from dlwp_cs_tpu_torch.ops.halo import ext_strips
    from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3
    from dlwp_cs_tpu_torch.ops.ring_kernel import (
        cs_conv3x3_xring,
        ring_fixes,
        ring_fixes_plain,
        ring_plan,
        xring_fused_apply,
        xring_fused_apply_plain,
    )
    from dlwp_cs_tpu_torch.ops.padding import cs_pad
    from dlwp_cs_tpu_torch.ops.ringfix import _same_conv
    from dlwp_cs_tpu_torch.tools.timing import bf16_excess, bound, face_grouped, graph_ms

    dev = torch.device("cuda")
    x = torch.randn((b, 6, n, n, cin), generator=gen, device=dev).to(dtype)
    scale = (9 * cin) ** -0.5
    ks = [(torch.randn((3, 3, cin, d), generator=gen, device=dev) * scale).to(dtype)
          for _ in range(2)]
    bs = [(torch.randn((d,), generator=gen, device=dev) * 0.1).to(dtype) for _ in range(2)]
    ext = ext_strips(x)
    bases = [_same_conv(x, k) for k in ks]
    wrappers = (ring_fixes, xring_fused_apply, cs_conv3x3, cv.ring_fixes_cudacore,
                cv.xring_fused_apply_cudacore)
    launches = [w.launches for w in wrappers]
    fixes, corners = ring_fixes(ext, *ks)
    out = xring_fused_apply(*bases, ext, *ks)
    again = xring_fused_apply(*bases, ext, *ks)
    old6 = cv.ring_fixes_cudacore(ext, *ks)
    old7 = cv.xring_fused_apply_cudacore(*bases, ext, *ks)
    ref_fixes, ref_corners = ring_fixes_plain(ext, *ks)
    ref_out = xring_fused_apply_plain(*bases, ext, *ks)
    torch.cuda.synchronize()
    pairs6 = ((fixes, ref_fixes), (corners, ref_corners))
    old_pairs6 = ((old6[0], ref_fixes), (old6[1], ref_corners))
    err6 = max(float((a.float() - r.float()).abs().max()) for a, r in pairs6)
    err7 = float((out.float() - ref_out.float()).abs().max())
    old_err6 = max(float((a.float() - r.float()).abs().max()) for a, r in old_pairs6)
    old_err7 = float((old7.float() - ref_out.float()).abs().max())
    if dtype == torch.float32:
        tol = "1e-4 abs"
        ok6, ok7 = err6 <= 1e-4 and old_err6 <= 1e-4, err7 <= 1e-4 and old_err7 <= 1e-4
    else:
        tol = "2**-7*|ref| + 1e-4"
        ok6 = max(bf16_excess(a, r) for a, r in pairs6 + old_pairs6) <= 1e-4
        ok7 = max(bf16_excess(out, ref_out), bf16_excess(old7, ref_out)) <= 1e-4
    # the corner handoff: two launches give the same output, bit for bit
    ok7 = ok7 and bool(torch.equal(out, again))
    ms6, old6_ms, runs6 = _turns(lambda: ring_fixes(ext, *ks),
                                 lambda: cv.ring_fixes_cudacore(ext, *ks), 20)
    ms7, old7_ms, runs7 = _turns(lambda: xring_fused_apply(*bases, ext, *ks),
                                 lambda: cv.xring_fused_apply_cudacore(*bases, ext, *ks), 20)
    plain6 = graph_ms(lambda: ring_fixes_plain(ext, *ks), 3)
    plain7 = graph_ms(lambda: xring_fused_apply_plain(*bases, ext, *ks), 3)
    # the whole xring conv (forward) beside kernel #1 and cuDNN on this shape
    with torch.no_grad():
        xring_ms = graph_ms(lambda: cs_conv3x3_xring(x, *ks, *bs), 10)
    fused_ms = graph_ms(lambda: cs_conv3x3(x, ext, *ks, *bs), 10)
    p, w = face_grouped(cs_pad(x, 1), ks)
    bias = torch.cat([bs[0]] * 4 + [bs[1]] * 2)
    cudnn_ms = graph_ms(lambda: F.conv2d(p, w, bias, groups=6), 20)
    for wr, count in zip(wrappers, launches):  # timing launches are not the main path's
        wr.launches = count
    item = x.element_size()
    ops = 2 * b * 6 * (12 * n + 4) * cin * d
    taps = 2 * 8 * cin * d  # the 8 outer taps of each weight group
    plans = {kind: ring_plan(dtype, b, n, cin, d, torch.cuda.get_device_properties(0)
                             .multi_processor_count, apply=kind == "apply")
             for kind in ("fixes", "apply")}
    common = {"n": n, "cin": cin, "cout": d, "batch": b,
              "dtype": str(dtype).split(".")[-1], "tolerance": tol}
    cases = []
    for kind, err, old_err, ok, ms, old_ms, runs, plain_ms, nbytes in (
        ("fixes", err6, old_err6, ok6, ms6, old6_ms, runs6, plain6,
         item * (ext.numel() + taps + fixes.numel() + corners.numel())),
        # one base read (the face's own), the output written
        ("apply", err7, old_err7, ok7, ms7, old7_ms, runs7, plain7,
         item * (2 * out.numel() + ext.numel() + taps)),
    ):
        g = plans[kind]
        cases.append(dict(common, kernel=kind, max_abs_err=err, cudacore_max_abs_err=old_err,
                          ok=ok, ms=ms, cudacore_ms=old_ms, runs_old_new_new_old=runs,
                          plain_ms=plain_ms, library_ms=None, **bound(nbytes, ops, dtype),
                          plan={"spb": g.spb, "dn": g.dn, "ring_blocks": g.nring,
                                "copy_blocks": g.ncopy, "smem": g.smem},
                          xring_conv_ms=xring_ms, fused_conv_ms=fused_ms,
                          cudnn_conv_ms=cudnn_ms))
    return cases


def ring_summary(cases):
    """#6 and #7 per ConvLSTM model call (its 4 gate convs, batch 1) and per
    train step (the same 4 at batch 16), bfloat16 and float32: the ring
    blocks' and the CUDA-core kernels' times (in turns), the plain
    version's and the bound."""
    rows = {}
    for kind, tag in (("apply", "#7"), ("fixes", "#6")):
        for dtype in ("bfloat16", "float32"):
            for b, what in ((1, "call, batch 1"), (TRAIN_BATCH, "step, batch 16")):
                by = {(c["n"], c["cin"], c["cout"]): c for c in cases if c["kernel"] == kind
                      and c["dtype"] == dtype and c["batch"] == b}
                cs = [by[s] for s in CONVLSTM_CALL]
                name = f"{tag}{' f32' if dtype == 'float32' else ''} {what}"
                rows[name] = {key: sum(c[key] for c in cs)
                              for key in ("ms", "cudacore_ms", "plain_ms", "bound_ms")}
    return rows


def block_case(kind, n, cin, cout, b, dtype, gen):
    """Kernel #8 (``kind`` band: n/4 rows x n columns) or #9 (tile: n/2 x
    n/2) at one conv shape of the flagship U-Net, against its plain version
    on the same block and ghost strips; beside it one face-grouped cuDNN
    call on the padded block."""
    from dlwp_cs_tpu_torch.ops.hopper_conv import (
        _padded_faces,
        cs_conv3x3_band,
        cs_conv3x3_plain,
        cs_conv3x3_tile,
    )
    from dlwp_cs_tpu_torch.tools.timing import bf16_excess, bound, face_grouped, graph_ms

    wrapper = cs_conv3x3_band if kind == "band" else cs_conv3x3_tile
    rows, cols = (n // SHARDS, n) if kind == "band" else (n // 2, n // 2)
    dev = torch.device("cuda")
    x = torch.randn((b, 6, rows, cols, cin), generator=gen, device=dev).to(dtype)
    # exchanged ghost strips: S/N rows whole, W/E at positions 1..rows
    ext = torch.randn((b, 6, 4, cols + 2, cin), generator=gen, device=dev)
    ext[:, :, 2:, 0] = 0
    ext[:, :, 2:, rows + 1 :] = 0
    ext = ext.to(dtype)
    scale = (9 * cin) ** -0.5
    ks = [(torch.randn((3, 3, cin, cout), generator=gen, device=dev) * scale).to(dtype)
          for _ in range(2)]
    bs = [(torch.randn((cout,), generator=gen, device=dev) * 0.1).to(dtype) for _ in range(2)]
    args = (x, ext, *ks, *bs)
    before = wrapper.launches
    ours = wrapper(*args)
    ref = cs_conv3x3_plain(*args)
    torch.cuda.synchronize()
    err = float((ours.float() - ref.float()).abs().max())
    if dtype == torch.float32:
        tol, ok = "1e-4 abs", err <= 1e-4
    else:
        tol, ok = "2**-7*|ref| + 1e-4", bf16_excess(ours, ref) <= 1e-4
    p, w = face_grouped(_padded_faces(x, ext), ks)
    bias = torch.cat([bs[0]] * 4 + [bs[1]] * 2)
    ms = graph_ms(lambda: wrapper(*args), 20)
    wrapper.launches = before  # timing launches are not the main path's
    plain_ms = graph_ms(lambda: cs_conv3x3_plain(*args), 3)
    library_ms = graph_ms(lambda: F.conv2d(p, w, bias, groups=6), 20)
    item = x.element_size()
    nbytes = item * (x.numel() + ext.numel() + 2 * ks[0].numel() + 2 * cout
                     + b * 6 * rows * cols * cout)
    ops = 2 * b * 6 * rows * cols * 9 * cin * cout
    return {
        "kernel": kind, "n": n, "rows": rows, "cols": cols, "cin": cin, "cout": cout,
        "batch": b, "dtype": str(dtype).split(".")[-1], "max_abs_err": err, "tolerance": tol,
        "ok": ok, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        **bound(nbytes, ops, dtype),
    }


def mma_cases(n, cin, cout, b, gen):
    """Kernels #3 (kn2row) and #13 (im2col) at one conv shape in bfloat16
    (the only type they take): each against its plain version and against
    kernel #1 on the same strips, one bf16 ulp of |ref| + 1e-4, bitwise
    against itself, and timed in turns (old, new, new, old) with the kernel
    of its first design (``cs_conv3x3_npack_v1``, ``cs_conv3x3_im2col_v1``,
    held too; where that design's plan refuses the shape, its entries are
    None); each timed beside #1, the face-grouped cuDNN call and the bound,
    which is #1's (the same function)."""
    from dlwp_cs_tpu_torch.ops.conv_variants import (
        cs_conv3x3_im2col,
        cs_conv3x3_im2col_plain,
        cs_conv3x3_im2col_v1,
        cs_conv3x3_npack,
        cs_conv3x3_npack_plain,
        cs_conv3x3_npack_v1,
        im2col_taps,
        mma_plan,
        npack_plan,
        npack_taps,
    )
    from dlwp_cs_tpu_torch.ops.halo import ext_strips
    from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3
    from dlwp_cs_tpu_torch.ops.padding import cs_pad
    from dlwp_cs_tpu_torch.tools.timing import bf16_excess, bound, face_grouped, graph_ms

    dev, dtype = torch.device("cuda"), torch.bfloat16
    x = torch.randn((b, 6, n, n, cin), generator=gen, device=dev).to(dtype)
    scale = (9 * cin) ** -0.5
    ks = [(torch.randn((3, 3, cin, cout), generator=gen, device=dev) * scale).to(dtype)
          for _ in range(2)]
    bs = [(torch.randn((cout,), generator=gen, device=dev) * 0.1).to(dtype) for _ in range(2)]
    ext = ext_strips(x)
    wrappers = (cs_conv3x3, cs_conv3x3_npack, cs_conv3x3_npack_v1, cs_conv3x3_im2col,
                cs_conv3x3_im2col_v1)
    launches = [w.launches for w in wrappers]
    conv1 = cs_conv3x3(x, ext, *ks, *bs)
    conv1_ms = graph_ms(lambda: cs_conv3x3(x, ext, *ks, *bs), 20)
    p, w = face_grouped(cs_pad(x, 1), ks)
    bias = torch.cat([bs[0]] * 4 + [bs[1]] * 2)
    library_ms = graph_ms(lambda: F.conv2d(p, w, bias, groups=6), 20)
    nbytes = x.element_size() * (x.numel() + ext.numel() + 2 * ks[0].numel() + 2 * cout
                                 + b * 6 * n * n * cout)
    ops = 2 * b * 6 * n * n * 9 * cin * cout
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = []
    for kind, wrapper, v1, plain, taps in (
        ("npack", cs_conv3x3_npack, cs_conv3x3_npack_v1, cs_conv3x3_npack_plain, npack_taps),
        ("im2col", cs_conv3x3_im2col, cs_conv3x3_im2col_v1, cs_conv3x3_im2col_plain,
         im2col_taps),
    ):
        tw = [taps(k) for k in ks]
        ours = wrapper(x, ext, *tw, *bs)
        ref = plain(x, ext, *tw, *bs)
        torch.cuda.synchronize()
        ok = bf16_excess(ours, ref) <= 1e-4 and bf16_excess(ours, conv1) <= 1e-4
        ok = ok and bool(torch.equal(wrapper(x, ext, *tw, *bs), ours))
        case = {
            "kernel": kind, "n": n, "cin": cin, "cout": cout, "batch": b, "dtype": "bfloat16",
            "max_abs_err": float((ours.float() - ref.float()).abs().max()),
            "vs_conv_kernel_max_abs_err": float((ours.float() - conv1.float()).abs().max()),
            "tolerance": "2**-7*|ref| + 1e-4 (plain and #1); bitwise repeat",
            "plain_ms": graph_ms(lambda: plain(x, ext, *tw, *bs), 3),
            "library_ms": library_ms, "conv_kernel_ms": conv1_ms,
            **bound(nbytes, ops, dtype),
        }
        if kind == "npack":
            case["plan"] = npack_plan(b, n, cin, cout, sms)._asdict()
        try:  # the first design's plan, as its wrapper runs it
            mma_plan(kind, b, n, cin, cout, sms)
            v1_refuses = False
        except ValueError:
            v1_refuses = True
        if v1_refuses:
            case.update(ms=graph_ms(lambda: wrapper(x, ext, *tw, *bs), 20), v1_ms=None,
                        v1_max_abs_err=None, runs_old_new_new_old=None)
        else:
            old = v1(x, ext, *tw, *bs)
            ok = ok and bf16_excess(old, ref) <= 1e-4
            ms, old_ms, runs = _turns(lambda: wrapper(x, ext, *tw, *bs),
                                      lambda: v1(x, ext, *tw, *bs), 20)
            case.update(ms=ms, v1_ms=old_ms, runs_old_new_new_old=runs,
                        v1_max_abs_err=float((old.float() - ref.float()).abs().max()))
        case["ok"] = ok
        cases.append(case)
    for wr, count in zip(wrappers, launches):  # timing launches are not the main path's
        wr.launches = count
    return cases


def mma_summary(cases, kind):
    """#3 (``kind`` "npack") or #13 ("im2col") against its first design's
    kernel (timed in turns), per group of shapes: a flagship model call's
    10 convs at batch 1, each of conv_micro's levels and the decoder's
    shape at batch 16, the shapes the first design cannot take; ms new / v1
    / cuDNN / plain / bound."""
    from dlwp_cs_tpu_torch.tools.conv_micro import LEVELS

    by = {(c["n"], c["cin"], c["cout"], c["batch"]): c for c in cases if c["kernel"] == kind}
    groups = {"model call, batch 1": [by[s + (1,)] for s in FLAGSHIP_CONVS]}
    for key in LEVELS + [(48, 96, 32, TRAIN_BATCH)]:
        groups["(%d, %d, %d), batch %d" % key] = [by[key]]
    for key, c in by.items():
        if c["v1_ms"] is None:
            groups["(%d, %d, %d), batch %d (v1 refuses)" % key] = [c]
    out = {}
    for name, rows in groups.items():
        out[name] = {k: (None if any(r[k] is None for r in rows) else sum(r[k] for r in rows))
                     for k in ("ms", "v1_ms", "library_ms", "plain_ms", "bound_ms")}
    return out


def dx_ring_cases(gen):
    """Kernel #14 at conv_micro's levels, float32 and bfloat16: against its
    plain version (f32 1e-4; bf16 one ulp + 1e-4), its interior bitwise
    equal to #4's dx, its S/N rows and its W/E columns at rows 1..n bitwise
    equal to #4's d_ext; timed beside #4, the plain version, the bound and
    one ``F.conv_transpose2d`` of dout on the face-grouped layout, which
    gives the whole (n+2)^2 cotangent."""
    from dlwp_cs_tpu_torch.ops.conv_variants import cs_conv3x3_dx_ring, cs_conv3x3_dx_ring_plain
    from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3_dx
    from dlwp_cs_tpu_torch.tools.conv_micro import LEVELS
    from dlwp_cs_tpu_torch.tools.timing import bf16_excess, bound, face_grouped, graph_ms

    dev = torch.device("cuda")
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for n, cin, cout, b in LEVELS:
            g = torch.randn((b, 6, n, n, cout), generator=gen, device=dev).to(dtype)
            ks = [(torch.randn((3, 3, cin, cout), generator=gen, device=dev)
                   * (9 * cout) ** -0.5).to(dtype) for _ in range(2)]
            launches = (cs_conv3x3_dx_ring.launches, cs_conv3x3_dx.launches)
            dx, dring = cs_conv3x3_dx_ring(g, *ks)
            dx4, d_ext = cs_conv3x3_dx(g, *ks)
            ref_dx, ref_ring = cs_conv3x3_dx_ring_plain(g, *ks)
            torch.cuda.synchronize()
            err = max(float((a.float() - r.float()).abs().max())
                      for a, r in ((dx, ref_dx), (dring, ref_ring)))
            if dtype == torch.float32:
                tol, close = "1e-4 abs", err <= 1e-4
            else:
                tol = "2**-7*|ref| + 1e-4"
                close = max(bf16_excess(dx, ref_dx), bf16_excess(dring, ref_ring)) <= 1e-4
            same = (torch.equal(dx, dx4) and torch.equal(dring[:, :, :2], d_ext[:, :, :2])
                    and torch.equal(dring[:, :, 2:, 1 : n + 1], d_ext[:, :, 2:, 1 : n + 1]))
            # one cuDNN call: the transposed conv of dout (B, 6*Cout, n, n) by
            # the face-grouped kernels gives the padded cotangent (B, 6*Cin, n+2, n+2)
            go = g.permute(0, 2, 3, 1, 4).reshape(b, n, n, 6 * cout).permute(0, 3, 1, 2)
            go = go.contiguous(memory_format=torch.channels_last)
            _, w = face_grouped(g.new_zeros((b, 6, 1, 1, cin)), ks)
            frame = F.conv_transpose2d(go, w, groups=6)
            frame = frame.reshape(b, 6, cin, n + 2, n + 2).permute(0, 1, 3, 4, 2)
            lib_err = float((frame[:, :, 1 : n + 1, 1 : n + 1].float() - ref_dx.float())
                            .abs().max())
            nbytes = g.element_size() * (g.numel() + 2 * ks[0].numel() + dx.numel()
                                         + dring.numel())
            ops = 2 * b * 6 * n * n * 9 * cin * cout
            cases.append({
                "n": n, "cin": cin, "cout": cout, "batch": b, "dtype": str(dtype).split(".")[-1],
                "max_abs_err": err, "tolerance": tol, "equal_to_dx_kernel": same,
                "library_max_abs_err": lib_err, "ok": close and same,
                "ms": graph_ms(lambda: cs_conv3x3_dx_ring(g, *ks), 10),
                "dx_kernel_ms": graph_ms(lambda: cs_conv3x3_dx(g, *ks), 10),
                "plain_ms": graph_ms(lambda: cs_conv3x3_dx_ring_plain(g, *ks), 2),
                "library_ms": graph_ms(lambda: F.conv_transpose2d(go, w, groups=6), 10),
                **bound(nbytes, ops, dtype),
            })
            cs_conv3x3_dx_ring.launches, cs_conv3x3_dx.launches = launches
    return cases


def lane_store_cases(gen):
    """Kernel #15 at the kernel_variants tool's shape (16, 6, 48, 48, 32), in
    float32 and bfloat16: bitwise equal to 3·x, as is the kernel its
    redesign replaced (``lane_store_v1``), with which it is timed in turns
    (old, new, new, old); beside its plain version, ``x * 3`` and the bound
    (x read once, the output written once from and to HBM).  Timed twice:
    L2-warm (CUDA-graph replays; the bf16 pass fits in the 50 MB L2, so the
    HBM bound does not bind there) and with a cold L2 (``cold_ms``), the
    times the bound is held against.  Then bitwise 3·x, without times, at
    C = 39 and 3 (the element path) and 24."""
    from dlwp_cs_tpu_torch.tools.probes import lane_store, lane_store_plain, lane_store_v1
    from dlwp_cs_tpu_torch.tools.timing import bound, cold_ms, graph_ms

    cases, launches = [], (lane_store.launches, lane_store_v1.launches)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((16, 6, 48, 48, 32), generator=gen, device="cuda").to(dtype)
        out = lane_store(x)
        again = lane_store(x)
        old = lane_store_v1(x)
        ref = lane_store_plain(x)
        torch.cuda.synchronize()
        equal = all(bool(torch.equal(t, 3 * x)) for t in (out, again, old, ref))
        nbytes, ops = 2 * x.numel() * x.element_size(), 2 * x.numel()
        ms, old_ms, runs = _turns(lambda: lane_store(x), lambda: lane_store_v1(x), 20)
        cold, old_cold, cold_runs = _turns(lambda: lane_store(x), lambda: lane_store_v1(x), 20,
                                           cold_ms)
        cases.append({
            "shape": list(x.shape), "dtype": str(dtype).split(".")[-1], "equal_to_3x": equal,
            "ok": equal, "max_abs_err": float((out.float() - 3 * x.float()).abs().max()),
            "ms": ms, "v1_ms": old_ms, "runs_old_new_new_old": runs,
            "plain_ms": graph_ms(lambda: lane_store_plain(x), 5),
            "library_ms": graph_ms(lambda: x * 3, 20),
            "cold_ms": cold, "v1_cold_ms": old_cold, "cold_runs_old_new_new_old": cold_runs,
            "plain_cold_ms": cold_ms(lambda: lane_store_plain(x), 5),
            "library_cold_ms": cold_ms(lambda: x * 3, 20),
            **bound(nbytes, ops, dtype),
        })
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((2, 6, 48, 48, 39), (3, 6, 24, 24, 3), (1, 6, 7, 7, 24)):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            checks.append({"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                           "ok": bool(torch.equal(lane_store(x), 3 * x))})
    lane_store.launches, lane_store_v1.launches = launches
    return cases, checks


def probe_cases():
    """#16: every probe of the probe tool at the reference scripts' shapes,
    in bfloat16 and float32, held against its plain version at the tool's
    gate (``mosaic_bisect.compare``) and timed in turns (old, new, new, old)
    with the kernel its redesign replaced (``tools/probes.py``'s
    ``PROBES_V1``, held too; the bias probe has none), beside the one
    PyTorch call and the bound.  Launches here are not the main path's."""
    from dlwp_cs_tpu_torch.tools import mosaic_bisect as mb
    from dlwp_cs_tpu_torch.tools import probes
    from dlwp_cs_tpu_torch.tools.timing import bound, graph_ms

    old_of = {probes.PROBES[k].name: v for k, v in probes.PROBES_V1.items()}
    wrappers = [*probes.PROBES.values(), *probes.PROBES_V1.values()]
    counts = [w.launches for w in wrappers]
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, probe, args in mb._cases(torch.device("cuda"), dtype, False):
            old = old_of.get(probe.name)
            got, ref = probe(*args), probe.plain(*args)
            again = probe(*args)
            err, tol, ok = mb.compare(name, got, ref)
            ok = ok and bool(torch.equal(got, again))  # two calls, bit for bit
            row = {"name": name, "probe": probe.name, "dtype": str(dtype).split(".")[-1],
                   "shapes": [tuple(a.shape) for a in args], "max_abs_err": err,
                   "tolerance": tol}
            if old is not None:
                old_err, _, old_ok = mb.compare(name, old(*args), ref)
                ms, old_ms, runs = _turns(lambda: probe(*args), lambda: old(*args), 20)
                row.update(v1_max_abs_err=old_err, v1_ms=old_ms, runs_old_new_new_old=runs)
                ok = ok and old_ok
            else:
                ms = graph_ms(lambda: probe(*args), 20)
            library, _ = mb.library_call(probe, args)
            row.update(ok=ok, ms=ms, plain_ms=graph_ms(lambda: probe.plain(*args), 5),
                       library_ms=graph_ms(library, 20),
                       **bound(sum(a.numel() * a.element_size() for a in (*args, got)),
                               mb._ops(probe, args, got), dtype))
            rows.append(row)
    for w, count in zip(wrappers, counts):
        w.launches = count
    return rows


def probe_summary(rows):
    """Per probe and dtype: the new and the v1 kernels' times (in turns),
    the library call's and the bound, summed over bisect3's three dw
    shapes."""
    out = {}
    for r in rows:
        key = f"{r['probe']} {r['dtype']}"
        acc = out.setdefault(key, {"ms": 0.0, "v1_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0})
        for k in acc:
            acc[k] += r.get(k) or 0.0
    return out


def _turns(new, old, reps, timer=None, with_old=True, old_reps=None):
    """``(new_ms, old_ms, runs)``: the two kernels timed in turns, old, new,
    new, old (``timer``, by default CUDA-graph replays, ``reps`` calls
    each, ``old_reps`` for ``old`` where given), each the mean of its two
    runs.  Without ``with_old`` only the two runs of ``new`` (``old_ms``
    None)."""
    from dlwp_cs_tpu_torch.tools.timing import graph_ms

    timer = timer or graph_ms
    if not with_old:
        n1, n2 = timer(new, reps), timer(new, reps)
        return (n1 + n2) / 2, None, [n1, n2]
    o1 = timer(old, old_reps or reps)
    n1 = timer(new, reps)
    n2 = timer(new, reps)
    o2 = timer(old, old_reps or reps)
    return (n1 + n2) / 2, (o1 + o2) / 2, [o1, n1, n2, o2]


# F4: a whole-face 3x3 conv whose dw plan refuses (float32, n = 128,
# Cin = Cout = 32, with a gradient) takes the ring-fix composition
REFUSED_SHAPE = (1, 128, 32, 32)


def refused_shape_phase(gen):
    """F4: the wrappers' plans (``fused_fits``, ``xring_fits``) keep every
    flagship shape of both models on its kernel (U-Net: forward, dx and dw
    at batch 1 and 16 in both dtypes; ConvLSTM: the xring kernel at its
    gates) and refuse ``REFUSED_SHAPE``, where ``cs_conv`` takes the
    ring-fix composition; one float32 training step there through
    ``cs_conv`` (forward, backward, SGD) launches no kernel at all (every
    count set to 0 before, read after) and matches the plain path (the
    fused conv's plain version through autograd): outputs 1e-4, gradients
    and updated weights 1e-5 of the largest entry."""
    from dlwp_cs_tpu_torch.ops.conv import cs_conv
    from dlwp_cs_tpu_torch.ops.halo import ext_strips
    from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3_plain, fused_fits
    from dlwp_cs_tpu_torch.ops.ring_kernel import xring_fits

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kept = [fused_fits(dt, b, n, cin, cout, sms, True, True)
            for dt in (torch.float32, torch.bfloat16) for b in (1, TRAIN_BATCH)
            for n, cin, cout in FLAGSHIP_CONVS + EXTRA_SHAPES]
    kept += [xring_fits(dt, b, n, cin, d, sms)
             for dt in (torch.float32, torch.bfloat16) for b in (1, TRAIN_BATCH)
             for n, cin, d in CONVLSTM_GATES]
    check(all(kept), f"a flagship shape leaves its kernel: {kept}")
    b, n, cin, cout = REFUSED_SHAPE
    route = "kernel" if fused_fits(torch.float32, b, n, cin, cout, sms, True, True) else "ringfix"
    check(route == "ringfix", f"{REFUSED_SHAPE} float32 with a gradient routes to {route}")
    x0 = torch.randn((b, 6, n, n, cin), generator=gen, device=dev)
    weights = [torch.randn((3, 3, cin, cout), generator=gen, device=dev) * (9 * cin) ** -0.5
               for _ in range(2)] + [torch.randn((cout,), generator=gen, device=dev) * 0.1
                                     for _ in range(2)]
    kernels = all_kernels()
    paths = {}
    for name in ("route", "plain"):
        x = x0.clone().requires_grad_(True)
        params = [w.clone().requires_grad_(True) for w in weights]
        opt = torch.optim.SGD(params, lr=0.1)
        counts = {k: w.launches for k, w in kernels.items()}
        for w in kernels.values():
            w.launches = 0
        t = time.perf_counter()
        if name == "route":
            out = cs_conv(x, params[0], params[1], bias_eq=params[2], bias_pole=params[3])
        else:
            out = cs_conv3x3_plain(x, ext_strips(x), *params)
        out.square().mean().backward()
        opt.step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) * 1e3
        launched = {k: w.launches for k, w in kernels.items() if w.launches}
        for k, w in kernels.items():
            w.launches = counts[k]
        check(not launched, f"the {name} step at {REFUSED_SHAPE} launched {launched}")
        paths[name] = ([out.detach(), x.grad] + [p.grad for p in params]
                       + [p.detach() for p in params], step_ms)
    out_err = float((paths["route"][0][0] - paths["plain"][0][0]).abs().max())
    rel = [float((a - r).abs().max()) / float(r.abs().max())
           for a, r in zip(paths["route"][0][1:], paths["plain"][0][1:])]
    check(out_err <= 1e-4 and max(rel) <= 1e-5,
          f"ring-fix step vs plain: output {out_err}, gradients and weights {rel}")
    return {"shape": list(REFUSED_SHAPE), "dtype": "float32", "route": route,
            "flagship_routes": len(kept), "launches": 0, "max_abs_err": out_err,
            "grad_and_weight_rel_err": rel, "tolerance": "1e-4 abs; 1e-5 of the largest entry",
            "step_ms": paths["route"][1], "plain_step_ms": paths["plain"][1]}


def graph_replay_phase(gen):
    """F5: a CUDA graph of the fused apply (#7, a wrapper of its own)
    captured at batch 1 at the ConvLSTM's second gate shape, then its
    arrival counts grown past the first buffer (a second buffer), an eager
    call at batch 16 on it, then 16 MB of other allocations filled with -1;
    two replays agree bitwise, equal the plain version (one bf16 ulp of
    |ref| + 1e-4; float32 1e-4), and every count buffer is still zero."""
    from dlwp_cs_tpu_torch.ops.halo import ext_strips
    from dlwp_cs_tpu_torch.ops.ring_kernel import (
        _RING_LIB,
        _XringApplyKernel,
        xring_fused_apply_plain,
    )
    from dlwp_cs_tpu_torch.tools.timing import bf16_excess

    dev = torch.device("cuda")
    n, cin, d = CONVLSTM_GATES[1]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        kernel = _XringApplyKernel("xring_fused_apply_graph", _RING_LIB)

        def inputs(b):
            x = torch.randn((b, 6, n, n, cin), generator=gen, device=dev).to(dtype)
            ks = [(torch.randn((3, 3, cin, d), generator=gen, device=dev)
                   * (9 * cin) ** -0.5).to(dtype) for _ in range(2)]
            bases = [torch.randn((b, 6, n, n, d), generator=gen, device=dev).to(dtype)
                     for _ in range(2)]
            return (*bases, ext_strips(x), *ks)

        small, big = inputs(1), inputs(TRAIN_BATCH)
        kernel(*small)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kernel(*small)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = kernel(*small)
        bufs = kernel._count_buffers[small[2].device]
        kernel._counters(small[2].device, bufs[0].numel() + 1)
        out16 = kernel(*big)
        junk = torch.full((1 << 22,), -1, dtype=torch.int32, device=dev)
        graph.replay()
        first = out.clone()
        graph.replay()
        torch.cuda.synchronize()
        ref, ref16 = xring_fused_apply_plain(*small), xring_fused_apply_plain(*big)
        err = max(float((a.float() - r.float()).abs().max()) for a, r in ((first, ref),
                                                                          (out16, ref16)))
        if dtype == torch.float32:
            close = err <= 1e-4
        else:
            close = max(bf16_excess(first, ref), bf16_excess(out16, ref16)) <= 1e-4
        row = {"dtype": str(dtype).split(".")[-1], "count_buffers": [t.numel() for t in bufs],
               "replays_bitwise_equal": bool(torch.equal(out, first)), "max_abs_err": err,
               "counts_zero": not any(bool(t.any()) for t in bufs)}
        row["ok"] = (close and row["replays_bitwise_equal"] and row["counts_zero"]
                     and len(bufs) == 2)
        check(row["ok"], f"the fused apply's graph after its counters grew: {row}")
        rows.append(row)
        del graph, junk
    return rows


def tc_cases(gen):
    """The tensor-core kernels against the CUDA-core instances they replaced
    (``ops/conv_variants.py``: ``cs_conv3x3_cudacore``,
    ``cs_conv3x3_dx_cudacore``, ``cs_conv3x3_dw_cudacore``), timed in turns
    in this call, each beside one cuDNN call and the bound: #1 at each
    flagship conv shape at batch 1, 8 and 16 and at n = 96, in bfloat16 and
    float32 (3xTF32; cuDNN with TF32 off); #4 and #5 (dw) at the training
    step's shapes at batch 16 and #8 and #9 on a rank's block (4 row bands,
    2 x 2 tiles) at batch 1, in both dtypes; #12 (#1 on strips computed
    before the call) in bfloat16 and #14 (the dx kernel's raw ring) in both
    at conv_micro's levels.  Both instances are held against the
    plain version at the kernel's tolerance (bfloat16 one bf16 ulp of
    |ref| + 1e-4; float32 1e-4; dw 1e-5 of the largest entry).  Launches
    here are not the main path's: every count is put back."""
    from dlwp_cs_tpu_torch.ops import conv_variants as cv
    from dlwp_cs_tpu_torch.ops import hopper_conv as hc
    from dlwp_cs_tpu_torch.ops.halo import ext_strips
    from dlwp_cs_tpu_torch.ops.padding import cs_pad
    from dlwp_cs_tpu_torch.tools.conv_micro import LEVELS
    from dlwp_cs_tpu_torch.tools.timing import bf16_excess, bound, face_grouped, graph_ms

    wrappers = [hc.cs_conv3x3, hc.cs_conv3x3_band, hc.cs_conv3x3_tile, hc.cs_conv3x3_dx,
                hc.cs_conv3x3_dw, cv.cs_conv3x3_kernel_only, cv.cs_conv3x3_dx_ring,
                cv.cs_conv3x3_cudacore, cv.cs_conv3x3_dx_cudacore, cv.cs_conv3x3_dw_cudacore]
    counts = [w.launches for w in wrappers]
    dev, bf = torch.device("cuda"), torch.bfloat16
    cases = []

    def rand(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def close(ours, ref, dtype):
        if dtype == torch.float32:
            return float((ours - ref).abs().max()) <= 1e-4
        return bf16_excess(ours, ref) <= 1e-4

    def forward(kind, new, n, cin, cout, b, rows, cols, reps, dtype=bf):
        x = rand(b, 6, rows, cols, cin, dtype=dtype)
        ks = [rand(3, 3, cin, cout, scale=(9 * cin) ** -0.5, dtype=dtype) for _ in range(2)]
        bs = [rand(cout, scale=0.1, dtype=dtype) for _ in range(2)]
        if rows == cols == n:
            ext = ext_strips(x)
        else:  # exchanged strips: S/N rows whole, W/E at positions 1..rows
            ext = torch.randn((b, 6, 4, cols + 2, cin), generator=gen, device=dev)
            ext[:, :, 2:, 0] = 0
            ext[:, :, 2:, rows + 1 :] = 0
            ext = ext.to(dtype)
        args = (x, ext, *ks, *bs)
        ours, theirs = new(*args), cv.cs_conv3x3_cudacore(*args)
        ref = hc.cs_conv3x3_plain(*args)
        torch.cuda.synchronize()
        new_ms, old_ms, runs = _turns(lambda: new(*args),
                                      lambda: cv.cs_conv3x3_cudacore(*args), reps)
        p, w = face_grouped(hc._padded_faces(x, ext), ks)
        bias = torch.cat([bs[0]] * 4 + [bs[1]] * 2)
        nbytes = x.element_size() * (x.numel() + ext.numel() + 2 * ks[0].numel() + 2 * cout
                                     + b * 6 * rows * cols * cout)
        cases.append({
            "kernel": kind, "dtype": str(dtype).split(".")[-1], "n": n, "rows": rows,
            "cols": cols, "cin": cin, "cout": cout,
            "batch": b, "ms": new_ms, "cudacore_ms": old_ms, "runs_old_new_new_old": runs,
            "library_ms": graph_ms(lambda: F.conv2d(p, w, bias, groups=6), reps),
            "max_abs_err": float((ours.float() - ref.float()).abs().max()),
            "cudacore_max_abs_err": float((theirs.float() - ref.float()).abs().max()),
            "ok": close(ours, ref, dtype) and close(theirs, ref, dtype),
            **bound(nbytes, 2 * b * 6 * rows * cols * 9 * cin * cout, dtype),
        })

    def backward(kind, n, cin, cout, b, reps, dtype=bf):
        raw = kind == "#14"
        g = rand(b, 6, n, n, cout, dtype=dtype)
        ks = [rand(3, 3, cin, cout, scale=(9 * cout) ** -0.5, dtype=dtype) for _ in range(2)]
        new = cv.cs_conv3x3_dx_ring if raw else hc.cs_conv3x3_dx
        plain = cv.cs_conv3x3_dx_ring_plain if raw else hc.cs_conv3x3_dx_plain
        ours, theirs, ref = new(g, *ks), cv.cs_conv3x3_dx_cudacore(g, *ks, raw=raw), plain(g, *ks)
        torch.cuda.synchronize()
        new_ms, old_ms, runs = _turns(lambda: new(g, *ks),
                                      lambda: cv.cs_conv3x3_dx_cudacore(g, *ks, raw=raw), reps)
        # one cuDNN call: the transposed conv of dout by the face-grouped
        # kernels, the whole (n+2)^2 padded-input cotangent
        go = g.permute(0, 2, 3, 1, 4).reshape(b, n, n, 6 * cout).permute(0, 3, 1, 2)
        go = go.contiguous(memory_format=torch.channels_last)
        _, w = face_grouped(g.new_zeros((b, 6, 1, 1, cin)), ks)
        nbytes = g.element_size() * (g.numel() + 2 * ks[0].numel() + b * 6 * n * n * cin
                                     + b * 6 * 4 * (n + 2) * cin)
        cases.append({
            "kernel": kind, "dtype": str(dtype).split(".")[-1], "n": n, "cin": cin,
            "cout": cout, "batch": b,
            "ms": new_ms, "cudacore_ms": old_ms, "runs_old_new_new_old": runs,
            "library_ms": graph_ms(lambda: F.conv_transpose2d(go, w, groups=6), reps),
            "max_abs_err": max(float((a.float() - r.float()).abs().max())
                               for a, r in zip(ours, ref)),
            "cudacore_max_abs_err": max(float((a.float() - r.float()).abs().max())
                                        for a, r in zip(theirs, ref)),
            "ok": all(close(a, r, dtype) for pair in (ours, theirs) for a, r in zip(pair, ref)),
            **bound(nbytes, 2 * b * 6 * n * n * 9 * cin * cout, dtype),
        })

    def weights(n, cin, cout, b, reps, dtype=bf):
        """#5, the dw kernel: the weight and bias gradients, f32."""
        x, g = rand(b, 6, n, n, cin, dtype=dtype), rand(b, 6, n, n, cout, dtype=dtype)
        ext = ext_strips(x)
        ours, theirs = hc.cs_conv3x3_dw(x, ext, g), cv.cs_conv3x3_dw_cudacore(x, ext, g)
        again = hc.cs_conv3x3_dw(x, ext, g)
        ref = hc.cs_conv3x3_dw_plain(x, ext, g)
        torch.cuda.synchronize()
        new_ms, old_ms, runs = _turns(lambda: hc.cs_conv3x3_dw(x, ext, g),
                                      lambda: cv.cs_conv3x3_dw_cudacore(x, ext, g), reps)
        # one cuDNN call: the wgrad (and bias grad) of the face-grouped conv
        p, w = face_grouped(cs_pad(x, 1), [x.new_zeros((3, 3, cin, cout))] * 2)
        go = g.permute(0, 2, 3, 1, 4).reshape(b, n, n, 6 * cout).permute(0, 3, 1, 2)
        conv_bwd = torch.ops.aten.convolution_backward
        scale = max(float(r.abs().max()) for r in ref)

        def err(got):
            return max(float((a - r).abs().max()) for a, r in zip(got, ref))

        ops = 2 * b * 6 * n * n * 9 * cin * cout
        nbytes = (x.element_size() * (x.numel() + ext.numel() + g.numel())
                  + 4 * 2 * (9 * cin * cout + cout))
        cases.append({
            "kernel": "#5", "dtype": str(dtype).split(".")[-1], "n": n, "cin": cin, "cout": cout,
            "batch": b,
            "ms": new_ms, "cudacore_ms": old_ms, "runs_old_new_new_old": runs,
            "library_ms": graph_ms(lambda: conv_bwd(go, p, w, [6 * cout], [1, 1], [0, 0],
                                                    [1, 1], False, [0, 0], 6,
                                                    [False, True, True]), reps),
            "max_abs_err": err(ours), "cudacore_max_abs_err": err(theirs), "ref_abs_max": scale,
            "bitwise_repeatable": all(torch.equal(a, c) for a, c in zip(ours, again)),
            "ok": err(ours) <= 1e-5 * scale and err(theirs) <= 1e-5 * scale
                  and all(torch.equal(a, c) for a, c in zip(ours, again)),
            **bound(nbytes, ops, dtype),
        })

    shapes = sorted(set(FLAGSHIP_CONVS), key=FLAGSHIP_CONVS.index)
    for dtype in (bf, torch.float32):
        for b in (1, 8, TRAIN_BATCH):
            for n, cin, cout in shapes + EXTRA_SHAPES:
                forward("#1", hc.cs_conv3x3, n, cin, cout, b, n, n, 20, dtype)
        for n, cin, cout in shapes:
            forward("#8", hc.cs_conv3x3_band, n, cin, cout, 1, n // SHARDS, n, 20, dtype)
            forward("#9", hc.cs_conv3x3_tile, n, cin, cout, 1, n // 2, n // 2, 20, dtype)
    for dtype in (bf, torch.float32):
        for n, cin, cout in shapes[1:]:
            backward("#4", n, cin, cout, TRAIN_BATCH, 10, dtype)
        for n, cin, cout in shapes:
            weights(n, cin, cout, TRAIN_BATCH, 10, dtype)
        for n, cin, cout, b in LEVELS:
            backward("#14", n, cin, cout, b, 10, dtype)
    for n, cin, cout, b in LEVELS:
        forward("#12", cv.cs_conv3x3_kernel_only, n, cin, cout, b, n, n, 20)
    for w, count in zip(wrappers, counts):
        w.launches = count
    return cases


def tc_summary(cases):
    """Per row of PERF.md: the new (tensor-core) and the old (CUDA-core)
    times, cuDNN's and the bound, summed over one model call's 10 convs (#1
    at batch 1 and 8, a training step's 10 at batch 16, #8, #9), a step's 9
    (#4) or 10 (#5) or conv_micro's three levels (#12, #14); bfloat16 and
    float32 (#12 bfloat16 only)."""
    def pick(kind, b=None, dx=False, dtype="bfloat16"):
        by = {(c["n"], c["cin"], c["cout"]): c for c in cases
              if c["kernel"] == kind and c["dtype"] == dtype and (b is None or c["batch"] == b)}
        if kind in ("#12", "#14"):
            return list(by.values())
        return [by[s] for s in (FLAGSHIP_CONVS[1:] if dx else FLAGSHIP_CONVS)]

    rows = {"#1 call, batch 1": pick("#1", 1), "#1 call, batch 8": pick("#1", 8),
            "#1 step, batch 16": pick("#1", TRAIN_BATCH), "#4 step, batch 16": pick("#4", dx=True),
            "#5 step, batch 16": pick("#5"),
            "#8 call, batch 1": pick("#8"), "#9 call, batch 1": pick("#9"),
            "#12, conv_micro's levels": pick("#12"), "#14, conv_micro's levels": pick("#14")}
    for b in (1, 8, TRAIN_BATCH):
        rows[f"#1 f32 call, batch {b}"] = pick("#1", b, dtype="float32")
    rows["#4 f32 step, batch 16"] = pick("#4", dx=True, dtype="float32")
    rows["#5 f32 step, batch 16"] = pick("#5", dtype="float32")
    rows["#14 f32, conv_micro's levels"] = pick("#14", dtype="float32")
    rows["#8 f32 call, batch 1"] = pick("#8", dtype="float32")
    rows["#9 f32 call, batch 1"] = pick("#9", dtype="float32")
    for b in (1, 8, TRAIN_BATCH):
        for dtype, tag in (("bfloat16", ""), ("float32", " f32")):
            rows[f"#1{tag} at n=96, batch {b}"] = [
                c for c in cases if c["kernel"] == "#1" and c["dtype"] == dtype and c["n"] == 96
                and c["batch"] == b]
    return {name: {key: sum(c[key] for c in cs) for key in
                   ("ms", "cudacore_ms", "library_ms", "bound_ms")} for name, cs in rows.items()}


# the kernels of this slice's path (the kernel tools), by wrapper name
TOOL_KERNELS = ("cs_conv3x3_npack", "cs_conv3x3_im2col", "cs_conv3x3_kernel_only",
                "cs_conv3x3_dx_ring", "lane_store", "probe_assemble", "probe_rows_int",
                "probe_rows_slice", "probe_col_int", "probe_col_newaxis", "probe_select",
                "probe_dot", "probe_shifted_dots", "probe_bias", "probe_dw_reshape",
                "probe_dw_batched")
TOOL_RUNS = (("conv_micro", []), ("kernel_variants", []), ("kernel_variants", ["--chain"]),
             ("mosaic_bisect", []), ("mosaic_bisect", ["--dtype", "float32"]))


def tools_main_path():
    """This slice's main path: each kernel tool's entry point run once on
    the card, as ``python -m dlwp_cs_tpu_torch.tools.<name>`` runs it (the
    tools print their rows and raise on a failed check: each kernel's row
    against its plain version on the same inputs, #12 bitwise against #1,
    each probe against its plain version); every count set to 0 before and
    read after.  Counts are wrapper calls, the calls captured into each
    timing CUDA graph included and its replays not.  Returns the launches
    of every kernel, the wall seconds and each run's rows."""
    import importlib

    kernels = all_kernels()
    for k in kernels.values():
        k.launches = 0
    t = time.perf_counter()
    results = {}
    for name, argv in TOOL_RUNS:
        print(f"$ python -m dlwp_cs_tpu_torch.tools.{name} {' '.join(argv)}".rstrip(), flush=True)
        mod = importlib.import_module(f"dlwp_cs_tpu_torch.tools.{name}")
        results[" ".join([name, *argv])] = rows = []
        check(mod.main(argv, rows) == 0, f"tools.{name} {argv} returned non-zero")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = {name: k.launches for name, k in kernels.items()}
    idle = [name for name in TOOL_KERNELS if launches[name] == 0]
    check(not idle, f"the kernel tools launched no {idle}")
    return launches, seconds, results


def f64_gradients(cfg, model, trainer, params, xb, yb, grads, plain):
    """Step 1's gradients once more through the plain path in float64, from
    the same parameters and batch cast to float64 (the model's output is
    still cast to float32 at its end, a 6e-8 relative rounding).  The
    leaky ReLU has a kink at 0: a pre-activation within rounding of 0 may
    take the other slope (0.1 or 1) in a float32 run than in float64, which
    moves the gradients of every layer upstream of it by far more than
    rounding.  So three float64 references: with its own kinks, and with
    the kinks (the signs of the pre-activations, by forward hooks on the
    convs) of the float32 kernel run and of the float32 plain run, forced.
    Returns per tensor each float32 path's largest error against each,
    relative to the tensor's largest entry, and per layer the
    pre-activations of another sign between the runs."""
    import dataclasses

    from dlwp_cs_tpu_torch.models import build_model
    from dlwp_cs_tpu_torch.train import model_apply, value_and_grad

    model64 = build_model(dataclasses.replace(cfg.resolved_model(), compute_dtype="float64"),
                          cfg.data.input_channels, device="cuda",
                          generator=torch.Generator().manual_seed(0))
    layers = [name for name in model.convs if name != "head"]
    slope = cfg.resolved_model().activation_slope

    def run(net, vg, *args, kinks=None):
        """(gradients, {layer: pre-activation}) of one step; ``kinks``:
        ``{layer: pre > 0}`` of another run, whose slopes the leaky ReLU
        takes here."""
        pre, order = {}, []

        def record(name, out):  # a forward hook that returns None keeps the output
            pre[name] = out.detach()
            order.append(name)

        hooks = [net.convs[name].register_forward_hook(
            lambda mod, inp, out, name=name: record(name, out)) for name in layers]
        act = net.act
        if kinks is not None:
            net.act = lambda z: z * torch.where(kinks[order[-1]], 1.0, slope).to(z.dtype)
        try:
            out = vg(*args)[1]
        finally:
            for h in hooks:
                h.remove()
            net.act = act
        return out, pre

    vg = value_and_grad(trainer.apply_fn, trainer.loss_fn)
    vg64 = value_and_grad(model_apply(model64), trainer.loss_fn)
    params64 = {k: v.detach().double().requires_grad_(True) for k, v in params.items()}
    args64 = (params64, xb.double(), yb.double())
    _, pre_k = run(model, vg, params, xb, yb)
    with plain_convs():
        _, pre_p = run(model, vg, params, xb, yb)
        g64, pre_64 = run(model64, vg64, *args64)
        g64_k, _ = run(model64, vg64, *args64, kinks={n: v > 0 for n, v in pre_k.items()})
        g64_p, _ = run(model64, vg64, *args64, kinks={n: v > 0 for n, v in pre_p.items()})
    torch.cuda.synchronize()

    def rel(a, ref):
        return float((a.double() - ref).abs().max()) / float(ref.abs().max())

    per_tensor = {k: {
        "kernel_vs_f64": rel(grads[k], g64[k]), "plain_vs_f64": rel(plain[k], g64[k]),
        "kernel_vs_f64_same_kinks": rel(grads[k], g64_k[k]),
        "plain_vs_f64_same_kinks": rel(plain[k], g64_p[k]),
        "kernel_vs_plain": float((grads[k] - plain[k]).abs().max() / plain[k].abs().max()),
    } for k in grads}
    flips = {name: {
        "kernel_vs_f64": int(((pre_k[name] > 0) != (pre_64[name] > 0)).sum()),
        "plain_vs_f64": int(((pre_p[name] > 0) != (pre_64[name] > 0)).sum()),
        "kernel_vs_plain": int(((pre_k[name] > 0) != (pre_p[name] > 0)).sum()),
        "values": pre_64[name].numel(),
    } for name in layers}
    return {"per_tensor": per_tensor, "sign_flips": flips}


@contextlib.contextmanager
def plain_convs():
    """Route the models' 3x3 convs through the kernels' plain versions: the
    fused conv (differentiable by autograd, so the U-Net's backward is plain
    too), the xring conv's fused ring kernel (its backward is torch) and the
    int8 base conv."""
    from dlwp_cs_tpu_torch.ops import conv as conv_mod
    from dlwp_cs_tpu_torch.ops import quant as quant_mod
    from dlwp_cs_tpu_torch.ops import ring_kernel as ring_mod
    from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3_plain

    saved = (conv_mod.cs_conv3x3_fused, ring_mod.xring_fused_apply,
             quant_mod.cs_conv3x3_int8_base)
    conv_mod.cs_conv3x3_fused = cs_conv3x3_plain
    ring_mod.xring_fused_apply = ring_mod.xring_fused_apply_plain
    quant_mod.cs_conv3x3_int8_base = quant_mod.cs_conv3x3_int8_plain
    try:
        yield
    finally:
        (conv_mod.cs_conv3x3_fused, ring_mod.xring_fused_apply,
         quant_mod.cs_conv3x3_int8_base) = saved


def all_kernels():
    """Every kernel wrapper, by name: the nine of the serving, training and
    sharded paths, the int8 base conv of the quantized path, then the kernel
    tools' (``TOOL_KERNELS``)."""
    from dlwp_cs_tpu_torch.ops import conv_variants
    from dlwp_cs_tpu_torch.ops.hopper_conv import (
        cs_conv3x3,
        cs_conv3x3_band,
        cs_conv3x3_dw,
        cs_conv3x3_dx,
        cs_conv3x3_tile,
    )
    from dlwp_cs_tpu_torch.ops.quant import cs_conv3x3_int8_base
    from dlwp_cs_tpu_torch.ops.ring_kernel import ring_fixes, xring_fused_apply
    from dlwp_cs_tpu_torch.parallel.overlap_band import band_conv3x3_overlap
    from dlwp_cs_tpu_torch.parallel.rdma_halo import band_exchange_rdma
    from dlwp_cs_tpu_torch.tools import probes

    tools = [getattr(conv_variants, name, None) or getattr(probes, name)
             for name in TOOL_KERNELS]
    return {k.name: k for k in (cs_conv3x3, cs_conv3x3_dx, cs_conv3x3_dw, ring_fixes,
                                xring_fused_apply, cs_conv3x3_band, cs_conv3x3_tile,
                                band_exchange_rdma, band_conv3x3_overlap,
                                cs_conv3x3_int8_base, *tools)}


def collective_kernels():
    """The device collectives' three kernel wrappers (send, reduce,
    unpack), by name."""
    from dlwp_cs_tpu_torch.parallel.device_collectives import KERNELS

    return dict(KERNELS)


def collective_counts():
    """This process's collectives so far: ``(calls, device_calls,
    host_calls)``."""
    from dlwp_cs_tpu_torch.parallel import collectives

    return collectives.calls, collectives.device_calls, collectives.host_calls


def collective_delta(before):
    """The collectives issued since :func:`collective_counts` gave
    ``before``: all, on the device, staged through the host."""
    now = collective_counts()
    return dict(zip(("calls", "device_calls", "host_calls"),
                    (a - b for a, b in zip(now, before))))


def model_config(kind, dtype_name):
    """The full-width model of ``kind``: the flagship U-Net (its kernel
    path) or the ConvLSTM (``ConvLSTMConfig()`` defaults, backend xring)."""
    from dlwp_cs_tpu_torch.models import ConvLSTMConfig, UNetConfig

    if kind == "unet":
        return UNetConfig(compute_dtype=dtype_name)
    return ConvLSTMConfig(compute_dtype=dtype_name, conv_backend="xring")


# launches of each kernel per model call (forecast) and per train step
PER_CALL = {"unet": {"cs_conv3x3": 10}, "convlstm": {"xring_fused_apply": 4}}
# the device kernel each serving wrapper launches (its profiler name)
KERNEL_OF = {"cs_conv3x3": "cs_conv3x3_tc_kernel", "xring_fused_apply": "cs_xring_tc_kernel"}
PER_STEP = {"unet": {"cs_conv3x3": 10, "cs_conv3x3_dw": 10, "cs_conv3x3_dx": 9},
            "convlstm": {"xring_fused_apply": 4}}


def want_launches(per, count):
    return {name: per.get(name, 0) * count for name in all_kernels()}


def profiled_run_ms(fn):
    """One run of ``fn`` under ``torch.profiler``: ``(wall, busy, kernels,
    n_kernels)``, the run's own host wall clock in ms, the device time of
    all its kernels and that of each of the port's kernels by name
    (``KERNEL_NAMES``) in ms, and the number of kernels the device ran
    (memory copies and sets not counted); all but ``wall`` are None where
    the profiler records no device time.  Only device activity is traced,
    which keeps the profiler's host overhead (in ``wall``) small."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    total = 0.0
    count = 0
    ours = dict.fromkeys(KERNEL_NAMES, 0.0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:  # kernels only, not the ops launching them
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        total += us
        if not e.key.startswith(("Memcpy", "Memset")):
            count += e.count
        for name in KERNEL_NAMES:
            if name in e.key:
                ours[name] += us / 1e3
    return (wall, total / 1e3, ours, count) if total > 0 else (wall, None, None, None)


def check_ring_blocks(kernel_ms, what):
    """The ConvLSTM's fused ring kernel ran as the ring blocks on the
    tensor cores: device time in ``cs_xring_tc_kernel``, none in the
    CUDA-core ring kernels."""
    ran = {k: kernel_ms[k] for k in (*CUDA_CORE_RING, "cs_xring_tc_kernel")}
    check(not any(ran[k] for k in CUDA_CORE_RING) and ran["cs_xring_tc_kernel"] > 0,
          f"{what}'s ring kernels (ms): {ran}")


def serve_phase(kind, dtype_name, rng):
    """Serve 14-day forecasts of the full-width model of ``kind``."""
    from dlwp_cs_tpu_torch import DataConfig, DLWPEstimator, ExperimentConfig
    from dlwp_cs_tpu_torch import ForecastService

    kernels = all_kernels()
    cfg = ExperimentConfig(data=DataConfig(), model=model_config(kind, dtype_name))
    d = cfg.data
    check((d.grid_n, d.input_channels, d.output_channels) == (48, 12, 8), "flagship shape")
    mean = np.asarray([5500.0, 1000.0, 3500.0, 280.0], np.float32)  # z500, z1000, tau, t2m
    std = np.asarray([300.0, 100.0, 150.0, 15.0], np.float32)
    stats = {"mean": mean, "std": std, "insol_mean": 340.0, "insol_std": 420.0}
    est = DLWPEstimator(cfg, device="cuda", seed=0).load_state(stats)
    const = rng.normal(size=(6, 48, 48, 2)).astype(np.float32)
    windows = (rng.normal(size=(8, 2, 6, 48, 48, 4)) * std + mean).astype(np.float32)
    t0 = 9668.5 + 0.25 * np.arange(8)  # 2026-06-21 12 UTC onwards
    svc = ForecastService(est, constants=const, max_batch=8, max_wait_ms=200.0)

    svc.forecast(windows[0], t0[0], steps=STEPS)  # warm-up
    for k in kernels.values():
        k.launches = 0
    fc = svc.forecast(windows[0], t0[0], steps=STEPS)
    launches = {name: k.launches for name, k in kernels.items()}
    want = want_launches(PER_CALL[kind], STEPS)
    check(launches == want, f"launches {launches}, want {want}")
    check(fc.fields.shape == (1, 2 * STEPS, 6, 48, 48, 4), f"shape {fc.fields.shape}")
    check(bool(np.isfinite(fc.fields).all()), "non-finite forecast fields")
    times = []
    for _ in range(3):
        t = time.perf_counter()
        svc.forecast(windows[0], t0[0], steps=STEPS)
        times.append((time.perf_counter() - t) * 1e3)
    profiled_run_ms(lambda: svc.forecast(windows[0], t0[0], steps=2))  # tracer warm-up
    prof_ms, busy_ms, kernel_ms, n_kernels = profiled_run_ms(
        lambda: svc.forecast(windows[0], t0[0], steps=STEPS))
    idle = None if busy_ms is None else 1.0 - busy_ms / prof_ms
    if kind == "convlstm" and kernel_ms is not None:
        check_ring_blocks(kernel_ms, f"the profiled {dtype_name} ConvLSTM forecast")

    # the first two model calls against the plain path on the card
    normed = (windows[:1] - mean) / std
    two = svc.forecast(normed, t0[0], steps=2, normalized=True).fields
    with plain_convs():
        two_plain = svc.forecast(normed, t0[0], steps=2, normalized=True).fields
    err2 = float(np.abs(two - two_plain).max())
    scale = float(np.abs(two_plain).max())
    tol2 = 1e-4 * scale if dtype_name == "float32" else 2.0**-6 * scale
    check(err2 <= tol2, f"first two calls differ from the plain path: {err2} > {tol2}")

    # 8 concurrent single-member requests coalesce and equal direct forecasts
    batches0 = svc.stats.batches
    futs = [svc.submit(windows[i], t0[i], steps=STEPS) for i in range(8)]
    results = [f.result(timeout=300) for f in futs]
    dispatches = svc.stats.batches - batches0
    check(dispatches <= 2, f"8 submits took {dispatches} dispatches")
    sub_err = 0.0
    for i, r in enumerate(results):
        direct = svc.forecast(windows[i], t0[i], steps=STEPS).fields
        sub_err = max(sub_err, float((np.abs(r.fields - direct) / std).max()))
    # the kernels' sums do not depend on the batch or the tile plan; only
    # library calls (the head's matmul, the xring conv's cuDNN SAME convs)
    # may pick another algorithm per batch
    sub_tol = 1e-4 if dtype_name == "float32" else 1e-2
    check(sub_err <= sub_tol, f"coalesced vs direct: {sub_err} std > {sub_tol}")
    svc.close()
    return {
        "model": kind, "dtype": dtype_name, "launches_per_forecast": launches,
        "rollout_ms": times, "rollout_ms_median": statistics.median(times),
        "profiled_rollout_ms": prof_ms, "device_busy_ms": busy_ms,
        "kernel_device_ms": kernel_ms, "device_kernels": n_kernels,
        "device_idle_share": idle, "first_two_calls_max_abs_err": err2, "first_two_calls_tolerance": tol2,
        "submit_dispatches": dispatches, "submit_vs_direct_max_err_in_std": sub_err,
        "submit_tolerance_in_std": sub_tol,
        "field_abs_max": float(np.abs(fc.fields).max()),
    }


ENS_MEMBERS = 8  # ensemble members: each ensemble forecast runs #1 at batch 8


def ensemble_phase(dtype_name, rng):
    """Serve 14-day perturbed-IC ensembles of the flagship U-Net and the
    estimator's forecast facade, through the port's entry points."""
    from dlwp_cs_tpu_torch import DataConfig, DLWPEstimator, ExperimentConfig
    from dlwp_cs_tpu_torch import ForecastService
    from dlwp_cs_tpu_torch.data import MemoryStore

    kernels = all_kernels()
    cfg = ExperimentConfig(data=DataConfig(), model=model_config("unet", dtype_name))
    d = cfg.data
    mean = np.asarray([5500.0, 1000.0, 3500.0, 280.0], np.float32)
    std = np.asarray([300.0, 100.0, 150.0, 15.0], np.float32)
    stats = {"mean": mean, "std": std, "insol_mean": 340.0, "insol_std": 420.0}
    est = DLWPEstimator(cfg, device="cuda", seed=0).load_state(stats)
    const = rng.normal(size=(6, 48, 48, 2)).astype(np.float32)
    windows = (rng.normal(size=(3, 2, 6, 48, 48, 4)) * std + mean).astype(np.float32)
    t0 = 9668.5 + 0.25 * np.arange(3)
    svc = ForecastService(est, constants=const, max_batch=4, max_wait_ms=500.0)
    args = dict(steps=STEPS, members=ENS_MEMBERS, amplitude=0.05)

    def ensemble():
        return svc.forecast_ensemble(windows[0], t0[0], keep_members=True,
                                     generator=torch.Generator().manual_seed(0), **args)

    ensemble()  # warm-up
    for k in kernels.values():
        k.launches = 0
    ens = ensemble()
    launches = {name: k.launches for name, k in kernels.items()}
    want = want_launches(PER_CALL["unet"], STEPS)
    check(launches == want, f"ensemble launches {launches}, want {want}")
    lead = 2 * STEPS
    check(ens.mean.shape == ens.spread.shape == (1, lead, 6, 48, 48, 4)
          and ens.members.shape == (1, ENS_MEMBERS, lead, 6, 48, 48, 4),
          f"ensemble shapes {ens.mean.shape} {ens.members.shape}")
    check(all(bool(np.isfinite(a).all()) for a in (ens.mean, ens.spread, ens.members)),
          "non-finite ensemble fields")
    check(bool((ens.spread[:, -1].mean(axis=(0, 1, 2, 3)) > 0).all()),
          "the members did not spread")
    times = []
    for _ in range(3):
        t = time.perf_counter()
        ensemble()
        times.append((time.perf_counter() - t) * 1e3)
    profiled_run_ms(lambda: svc.forecast_ensemble(windows[0], t0[0], steps=2,
                                                  members=ENS_MEMBERS))  # tracer warm-up
    prof_ms, busy_ms, kernel_ms, n_kernels = profiled_run_ms(ensemble)
    idle = None if busy_ms is None else 1.0 - busy_ms / prof_ms

    # the control member (batch 8) against the forecast of its window
    # (batch 1): #1 sums each output in one K order whatever the batch;
    # library calls (the 1x1 head's matmul) may pick another algorithm
    fc = svc.forecast(windows[0], t0[0], steps=STEPS).fields
    control = ens.members[:, 0]
    control_equal = bool(np.array_equal(control, fc))
    control_err = float((np.abs(control - fc) / std).max())
    tol_std = 1e-4 if dtype_name == "float32" else 1e-2
    check(control_err <= tol_std, f"control member vs forecast: {control_err} std > {tol_std}")

    # the first two model calls against the plain path on the card
    normed = (windows[:1] - mean) / std
    kw = dict(steps=2, members=ENS_MEMBERS, normalized=True, keep_members=True)
    two = svc.forecast_ensemble(normed, t0[0], generator=torch.Generator().manual_seed(1), **kw)
    with plain_convs():
        two_plain = svc.forecast_ensemble(normed, t0[0],
                                          generator=torch.Generator().manual_seed(1), **kw)
    err2 = float(np.abs(two.members - two_plain.members).max())
    scale = float(np.abs(two_plain.members).max())
    tol2 = 1e-4 * scale if dtype_name == "float32" else 2.0**-6 * scale
    check(err2 <= tol2, f"ensemble's first two calls differ from the plain path: {err2} > {tol2}")

    # three concurrent requests with one key: one dispatch (a bucket of 4),
    # equal to the ensemble of the three stacked windows with the same seed
    batches0 = svc.stats.batches
    futs = [svc.submit_ensemble(windows[i], t0[i], seed=3, keep_members=True, **args)
            for i in range(3)]
    results = [f.result(timeout=600) for f in futs]
    dispatches = svc.stats.batches - batches0
    check(dispatches == 1, f"3 ensemble submits took {dispatches} dispatches")
    stacked = svc.forecast_ensemble(windows, t0, keep_members=True,
                                    generator=torch.Generator().manual_seed(3), **args)
    sub_equal = all(np.array_equal(r.members[0], stacked.members[i])
                    for i, r in enumerate(results))
    sub_err = max(float((np.abs(r.members[0] - stacked.members[i]) / std).max())
                  for i, r in enumerate(results))
    check(sub_err <= tol_std, f"coalesced ensembles vs stacked: {sub_err} std > {tol_std}")

    # the estimator's facade from a seeded store against the service
    steps4 = 4
    store = MemoryStore.from_raw(
        (rng.normal(size=(6, 6, 48, 48, 4)) * std + mean).astype(np.float32),
        9668.5 + 0.25 * np.arange(6), d.variables, constants=const,
        constant_names=d.constants)
    idx = np.asarray([1, 4])
    est_fc = est.forecast(store, init_indices=idx, steps=steps4).fields.cpu().numpy()
    win = np.stack([(store.fields[i - 1 : i + 1] - mean) / std for i in idx])
    svc_fc = svc.forecast(win, store.times[idx], steps=steps4, normalized=True).fields
    est_equal = bool(np.array_equal(est_fc, svc_fc))
    est_err = float(np.abs(est_fc - svc_fc).max())
    check(est_err <= tol_std, f"estimator forecast vs service: {est_err} > {tol_std}")
    svc.close()
    return {
        "dtype": dtype_name, "members": ENS_MEMBERS, "steps": STEPS,
        "launches_per_ensemble": launches, "ensemble_ms": times,
        "ensemble_ms_median": statistics.median(times), "profiled_ensemble_ms": prof_ms,
        "device_busy_ms": busy_ms, "kernel_device_ms": kernel_ms, "device_kernels": n_kernels,
        "device_idle_share": idle,
        "control_bitwise_equal_to_forecast": control_equal,
        "control_vs_forecast_max_err_in_std": control_err, "tolerance_in_std": tol_std,
        "first_two_calls_max_abs_err": err2, "first_two_calls_tolerance": tol2,
        "submit_dispatches": dispatches, "submit_bitwise_equal_to_stacked": sub_equal,
        "submit_vs_stacked_max_err_in_std": sub_err,
        "estimator_bitwise_equal_to_service": est_equal,
        "estimator_vs_service_max_abs_err": est_err,
        "spread_mean_last_lead": [float(v) for v in ens.spread[0, -1].mean(axis=(0, 1, 2))],
    }


# the export phase: (model, dtype, window batch buckets)
EXPORT_CASES = (("unet", "bfloat16", (1, 8)), ("unet", "float32", (1, 8)),
                ("convlstm", "bfloat16", (1,)))
# host-side CUDA calls that put work on the device: a kernel launch, a
# graph launch, a copy or a set
RUNTIME_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpyAsync",
                 "cudaMemcpy", "cudaMemsetAsync", "cudaMemset")


def dispatch_counts(fn):
    """One run of ``fn`` traced on the host and the device: ``(host, device)``,
    the host's CUDA calls that put work on the device by name
    (``RUNTIME_CALLS``; empty where the profiler records none), and the
    device's kernels: each of the port's by name (``KERNEL_NAMES``) and all
    (``"all"``, memory copies and sets not counted)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    host, device = {}, dict.fromkeys(KERNEL_NAMES + ("all",), 0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            if not e.key.startswith(("Memcpy", "Memset")):
                device["all"] += e.count
            for name in KERNEL_NAMES:
                if name in e.key:
                    device[name] += e.count
        elif e.key in RUNTIME_CALLS:
            host[e.key] = host.get(e.key, 0) + e.count
    return host, device


def export_phase(kind, dtype_name, buckets, rng, workdir):
    """Export the full-width model of ``kind`` (``serve/export.py``), load
    the artifact with no estimator, and serve 14-day forecasts from it at
    each bucket: the first request runs the program eagerly and captures the
    rollout as one CUDA graph, later ones replay it.  Each is held against
    the live service's forecast of the same windows and timed beside it in
    the same run; one exported forecast is profiled (busy time, idle share,
    the kernels in the replay, the host's CUDA calls)."""
    from dlwp_cs_tpu_torch import DataConfig, DLWPEstimator, ExperimentConfig
    from dlwp_cs_tpu_torch import ForecastService
    from dlwp_cs_tpu_torch.ops.library import use_library_ops
    from dlwp_cs_tpu_torch.serve import ExportedForecaster, export_forecaster

    kernels = all_kernels()
    name = next(iter(PER_CALL[kind]))
    kernel = kernels[name]
    cfg = ExperimentConfig(data=DataConfig(), model=model_config(kind, dtype_name))
    mean = np.asarray([5500.0, 1000.0, 3500.0, 280.0], np.float32)
    std = np.asarray([300.0, 100.0, 150.0, 15.0], np.float32)
    stats = {"mean": mean, "std": std, "insol_mean": 340.0, "insol_std": 420.0}
    est = DLWPEstimator(cfg, device="cuda", seed=0).load_state(stats)
    const = rng.normal(size=(6, 48, 48, 2)).astype(np.float32)
    windows = (rng.normal(size=(max(buckets), 2, 6, 48, 48, 4)) * std + mean).astype(np.float32)
    t0 = 9668.5 + 0.25 * np.arange(max(buckets))
    svc = ForecastService(est, constants=const)
    path = os.path.join(workdir, f"{kind}_{dtype_name}")
    t = time.perf_counter()
    export_forecaster(est, path, steps=STEPS, batch_sizes=buckets, constants=const)
    export_s = time.perf_counter() - t
    t = time.perf_counter()
    exp = ExportedForecaster(path)
    load_s = time.perf_counter() - t
    out = {"model": kind, "dtype": dtype_name, "steps": STEPS, "export_seconds": export_s,
           "load_seconds": load_s, "buckets": []}
    for b in buckets:
        w, tt = windows[:b], t0[:b]
        live = svc.forecast(w, tt, steps=STEPS)  # also the live path's warm-up at b
        launches = kernel.launches
        t = time.perf_counter()
        first = exp.forecast(w, tt)  # eager run, capture, first replay
        capture_s = time.perf_counter() - t
        # the eager run and the capture launch every call's kernels once each
        captured = kernel.launches - launches
        want = 2 * PER_CALL[kind][name] * STEPS
        check(captured == want, f"export {kind} {dtype_name} b{b}: {captured} launches, want "
              f"{want}")
        again = exp.forecast(w, tt)
        check(kernel.launches - launches == want, "a replay launched kernels from the host")
        check(np.array_equal(again.fields, first.fields),
              f"export {kind} {dtype_name} b{b}: replays differ")
        check(first.fields.shape == (b, 2 * STEPS, 6, 48, 48, 4)
              and bool(np.isfinite(first.fields).all()), f"exported fields {first.fields.shape}")
        bitwise = bool(np.array_equal(first.fields, live.fields))
        err = float((np.abs(first.fields - live.fields) / std).max())
        norm_live = (live.fields - mean) / std
        tol = 1e-6 if dtype_name == "float32" else 2.0**-6 * float(np.abs(norm_live).max())
        check(err <= tol, f"export {kind} {dtype_name} b{b}: {err} std from live > {tol}")
        # wall times in turns: live, exported, exported, live; the live path
        # also through the registered operators (ops/library.py)
        live_ms, exp_ms, op_ms = [], [], []
        for fn, times in ((lambda: svc.forecast(w, tt, steps=STEPS), live_ms),
                          (lambda: exp.forecast(w, tt), exp_ms),
                          (lambda: exp.forecast(w, tt), exp_ms),
                          (lambda: svc.forecast(w, tt, steps=STEPS), live_ms)):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        with use_library_ops():
            t = time.perf_counter()
            svc.forecast(w, tt, steps=STEPS)
            op_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        svc.forecast(w, tt, steps=STEPS)
        live_ms.append((time.perf_counter() - t) * 1e3)
        for _ in range(2):
            t = time.perf_counter()
            exp.forecast(w, tt)
            exp_ms.append((time.perf_counter() - t) * 1e3)
        # the replay alone (host clock to its end), the rest of a forecast
        # being host work: copies, padding, denormalization
        graph = exp._graphs[STEPS, b].graph
        replay_ms = []
        for _ in range(3):
            t = time.perf_counter()
            graph.replay()
            torch.cuda.synchronize()
            replay_ms.append((time.perf_counter() - t) * 1e3)
        prof_ms, busy_ms, kernel_ms, n_kernels = profiled_run_ms(lambda: exp.forecast(w, tt))
        live_prof = profiled_run_ms(lambda: svc.forecast(w, tt, steps=STEPS))
        host, device = dispatch_counts(lambda: exp.forecast(w, tt))
        live_host, live_device = dispatch_counts(lambda: svc.forecast(w, tt, steps=STEPS))
        check(device[KERNEL_OF[name]] == PER_CALL[kind][name] * STEPS,
              f"the profiled replay ran {device[KERNEL_OF[name]]} {KERNEL_OF[name]}")
        out["buckets"].append({
            "batch": b, "capture_seconds": capture_s, "launches_eager_and_capture": captured,
            "bitwise_equal_to_live": bitwise, "max_err_in_std": err, "tolerance_in_std": tol,
            "exported_ms": exp_ms, "exported_ms_median": statistics.median(exp_ms),
            "live_ms": live_ms, "live_ms_median": statistics.median(live_ms),
            "replay_ms": replay_ms, "replay_ms_median": statistics.median(replay_ms),
            "live_through_operators_ms": op_ms,
            "live_through_operators_ms_median": statistics.median(op_ms),
            "profiled_exported_ms": prof_ms, "device_busy_ms": busy_ms,
            "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / prof_ms,
            "kernel_device_ms": kernel_ms, "device_kernels": n_kernels,
            "profiled_live_ms": live_prof[0], "live_device_busy_ms": live_prof[1],
            "live_device_idle_share": None if live_prof[1] is None
            else 1.0 - live_prof[1] / live_prof[0],
            "host_calls_per_forecast": host, "device_kernels_per_forecast": device,
            "live_host_calls_per_forecast": live_host,
            "live_device_kernels_per_forecast": live_device,
            "graphs": len(exp._graphs),
        })
    return out


def http_phase(rng):
    """The HTTP front end over the bf16 flagship U-Net: 8 concurrent
    ``forecast_request`` and 3 ``ensemble_request`` calls (one key) to a
    ``ForecastHTTPServer`` on an ephemeral port, each coalesced into one
    dispatch and bitwise equal to the direct call of the same batch; one
    request's round trip alone (the batcher waiting its default 5 ms for
    peers)."""
    import threading

    from dlwp_cs_tpu_torch.serve import (
        ForecastHTTPServer,
        ForecastService,
        ensemble_request,
        forecast_request,
    )

    est = flagship_estimator("bfloat16")
    mean, std = est.stats["mean"], est.stats["std"]
    const = rng.normal(size=(6, 48, 48, 2)).astype(np.float32)
    windows = (rng.normal(size=(8, 2, 6, 48, 48, 4)) * std + mean).astype(np.float32)
    t0 = 9668.5 + 0.25 * np.arange(8)
    svc = ForecastService(est, constants=const, max_batch=8)  # waits 5 ms for peers
    srv = ForecastHTTPServer(svc, port=0).start()
    try:
        direct = svc.forecast(windows, t0, steps=STEPS).fields  # also the warm-up at batch 8
        one = forecast_request("127.0.0.1", srv.port, windows[0], t0[0], STEPS)  # warm-up
        rt = []
        for _ in range(3):
            t = time.perf_counter()
            forecast_request("127.0.0.1", srv.port, windows[0], t0[0], STEPS)
            rt.append((time.perf_counter() - t) * 1e3)
        svc.max_wait_s = 1.0  # the bursts below coalesce whatever the threads' timing
        results, errors = {}, []

        def call(i, fn, *args, **kw):
            try:
                results[i] = fn("127.0.0.1", srv.port, *args, **kw)
            except Exception as e:  # noqa: BLE001 — reported by the check below
                errors.append(e)

        batches = svc.stats.batches
        t = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i, forecast_request, windows[i], t0[i],
                                                       STEPS)) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        burst_ms = (time.perf_counter() - t) * 1e3
        fc_dispatches = svc.stats.batches - batches
        check(not errors and len(results) == 8, f"HTTP forecasts failed: {errors}")
        check(fc_dispatches == 1, f"8 HTTP forecasts took {fc_dispatches} dispatches")
        # one dispatch of 8: each row's sums are those of the direct batch
        fc_bitwise = all(np.array_equal(results[i][0][0], direct[i]) for i in range(8))
        check(fc_bitwise, "HTTP forecasts differ from the direct batch")
        check(np.array_equal(one[0], svc.forecast(windows[0], t0[0], steps=STEPS).fields),
              "an HTTP forecast differs from the direct call")
        # 3 ensembles with one key, started 50 ms apart so that they queue in
        # order: one dispatch of a bucket of 4, equal to the stacked call
        # padded alike (the last window repeated) with the same seed
        args = dict(members=4, amplitude=0.05, seed=7, keep_members=True)
        results.clear()
        batches = svc.stats.batches
        threads = []
        for i in range(3):
            threads.append(threading.Thread(target=call, args=(i, ensemble_request, windows[i],
                                                               t0[i], STEPS), kwargs=args))
            threads[-1].start()
            time.sleep(0.05)
        for th in threads:
            th.join(timeout=600)
        ens_dispatches = svc.stats.batches - batches
        check(not errors and len(results) == 3, f"HTTP ensembles failed: {errors}")
        check(ens_dispatches == 1, f"3 HTTP ensembles took {ens_dispatches} dispatches")
        stacked = svc.forecast_ensemble(
            np.concatenate([windows[:3], windows[2:3]]), np.append(t0[:3], t0[2]),
            steps=STEPS, members=4, amplitude=0.05, keep_members=True,
            generator=torch.Generator().manual_seed(7))
        ens_bitwise = all(np.array_equal(results[i][k][0], getattr(stacked, k)[i])
                          for i in range(3) for k in ("mean", "spread", "members"))
        check(ens_bitwise, "HTTP ensembles differ from the stacked call")
    finally:
        srv.stop()
    return {"forecast_dispatches": fc_dispatches, "forecast_bitwise_equal": fc_bitwise,
            "burst_ms": burst_ms, "round_trip_ms": rt,
            "round_trip_ms_median": statistics.median(rt),
            "ensemble_dispatches": ens_dispatches, "ensemble_bitwise_equal": ens_bitwise,
            "requests": svc.stats.requests, "batches": svc.stats.batches}


def train_phase(kind, dtype_name, rng):
    """Train the full-width model of ``kind`` on the card through the port's
    entry points."""
    from dlwp_cs_tpu_torch.data import MemoryStore, SeriesDataset, prefetch_to_device
    from dlwp_cs_tpu_torch.geometry.cubed_sphere import CubedSphere
    from dlwp_cs_tpu_torch.models import DataConfig, ExperimentConfig, build_model
    from dlwp_cs_tpu_torch.models.config import TrainConfig
    from dlwp_cs_tpu_torch.train import Trainer, value_and_grad

    kernels = all_kernels()
    tcfg = TrainConfig(batch_size=TRAIN_BATCH, optimizer="adam", learning_rate=1e-3,
                       loss="mse", max_epochs=1, metrics_every=TRAIN_STEPS)
    cfg = ExperimentConfig(data=DataConfig(), model=model_config(kind, dtype_name),
                           train=tcfg)
    d = cfg.data
    # seeded synthetic fields, 6-hourly, enough windows for 20 batches
    n_times = TRAIN_BATCH * TRAIN_STEPS + d.input_time_steps + d.output_time_steps - 1
    mean = np.asarray([5500.0, 1000.0, 3500.0, 280.0], np.float32)
    std = np.asarray([300.0, 100.0, 150.0, 15.0], np.float32)
    fields = (rng.standard_normal((n_times, 6, 48, 48, 4), dtype=np.float32) * std + mean)
    store = MemoryStore.from_raw(
        fields, 9000.0 + 0.25 * np.arange(n_times), d.variables,
        constants=rng.standard_normal((6, 48, 48, 2), dtype=np.float32),
        constant_names=d.constants)
    lat, lon = CubedSphere(d.grid_n).cell_latlon
    ds = SeriesDataset(store, d, lat=lat, lon=lon, batch_size=TRAIN_BATCH, shuffle=True)
    check(len(ds) == TRAIN_STEPS, f"{len(ds)} batches, want {TRAIN_STEPS}")
    model = build_model(cfg.resolved_model(), d.input_channels, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, tcfg)
    x0, y0 = ds.make_batch(ds._starts[:TRAIN_BATCH])
    xb, yb = torch.from_numpy(x0).cuda(), torch.from_numpy(y0).cuda()
    state0 = trainer.init(x0)

    # step 1's gradients: finite and non-zero everywhere, bitwise repeatable,
    # equal to the plain path's on the card
    vg = value_and_grad(trainer.apply_fn, trainer.loss_fn)
    loss_k, grads = vg(state0.params, xb, yb)
    _, again = vg(state0.params, xb, yb)
    with plain_convs():
        loss_p, plain = vg(state0.params, xb, yb)
    torch.cuda.synchronize()
    for name, gr in grads.items():
        check(bool(torch.isfinite(gr).all()) and float(gr.abs().max()) > 0,
              f"gradient of {name} is not finite and non-zero")
    repeat = all(torch.equal(grads[k], again[k]) for k in grads)
    check(repeat, "two identical steps gave different gradients")
    # per tensor, relative to its largest entry: f32 sums in another order
    # (f32); bf16 activations whose roundings may flip and carry through
    # the layers (bf16)
    grad_tol = 1e-3 if dtype_name == "float32" else 2.0**-4
    grad_err, worst = max((float((grads[k] - plain[k]).abs().max() / plain[k].abs().max()), k)
                          for k in grads)
    f64 = None
    if kind == "unet" and dtype_name == "float32":
        # A leaky-ReLU pre-activation within rounding of 0 takes the other
        # slope in one float32 run than in the other and moves every
        # gradient upstream of it far past rounding (1.37e-3 of a tensor's
        # largest entry once).  So each float32 path is held against the
        # float64 step with its own kinks forced: rounding, 1e-5 per tensor.
        f64 = f64_gradients(cfg, model, trainer, state0.params, xb, yb, grads, plain)
        flips = {name: (f["kernel_vs_f64"], f["plain_vs_f64"], f["kernel_vs_plain"])
                 for name, f in f64["sign_flips"].items()}
        print("train unet float32 step-1 gradients, max |err| / max |f64 ref| per tensor "
              "(kernel path, plain path; against f64 with the path's own kinks: kernel, "
              "plain): " + ", ".join(
                  f"{k} {v['kernel_vs_f64']:.3g} {v['plain_vs_f64']:.3g} "
                  f"{v['kernel_vs_f64_same_kinks']:.3g} {v['plain_vs_f64_same_kinks']:.3g}"
                  for k, v in f64["per_tensor"].items()), flush=True)
        print("train unet float32 leaky-ReLU pre-activations of another sign per layer "
              f"(kernel vs f64, plain vs f64, kernel vs plain): {flips}", flush=True)
        against, check_tol = "the float64 step with the same kinks", 1e-5
        check_err, check_worst = max(
            (max(v["kernel_vs_f64_same_kinks"], v["plain_vs_f64_same_kinks"]), k)
            for k, v in f64["per_tensor"].items())
    else:
        against, check_tol, check_err, check_worst = "the plain path", grad_tol, grad_err, worst
    check(check_err <= check_tol,
          f"step-1 gradients vs {against}: {check_err} > {check_tol} ({check_worst})")

    # the main path: 20 optimizer steps from the store through the trainer
    for k in kernels.values():
        k.launches = 0
    t = time.perf_counter()
    state = trainer.fit(state0, lambda: prefetch_to_device(iter(ds)), verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    launches = {name: k.launches for name, k in kernels.items()}
    want = want_launches(PER_STEP[kind], TRAIN_STEPS)
    check(launches == want, f"launches {launches}, want {want}")
    check(state.step == TRAIN_STEPS, f"{state.step} steps")
    losses = [r["loss"] for r in trainer.history.steps]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), f"losses {losses}")

    # the trainer fits one fixed batch: the loss falls
    fixed = Trainer(model, tcfg)
    fixed.fit(fixed.init(x0), [(xb, yb)] * TRAIN_STEPS, verbose=False)
    fit_losses = [r["loss"] for r in fixed.history.steps]
    check(all(np.isfinite(fit_losses)) and np.mean(fit_losses[-5:]) < fit_losses[0],
          f"fixed-batch losses do not fall: {fit_losses}")

    # step time (host clock, synchronised), then one profiled step
    times = []
    for i in range(10):
        t = time.perf_counter()
        state, _ = trainer.train_step(state, xb, yb)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t) * 1e3)
    profiled_run_ms(lambda: trainer.train_step(state, xb, yb))  # tracer warm-up
    prof_ms, busy_ms, kernel_ms, n_step = profiled_run_ms(
        lambda: trainer.train_step(state, xb, yb))
    if kind == "unet" and kernel_ms is not None:
        # the backward on the tensor cores: no device time in the CUDA-core
        # dx and dw kernels, some in the dw kernel of this dtype
        dw_name = "cs_conv3x3_dw_tf32_kernel" if dtype_name == "float32" else \
            "cs_conv3x3_dw_tc_kernel"
        ran = {k: kernel_ms[k] for k in (*CUDA_CORE_BACKWARD, "cs_conv3x3_dx_tc_kernel",
                                         dw_name)}
        check(not any(ran[k] for k in CUDA_CORE_BACKWARD) and ran[dw_name] > 0
              and ran["cs_conv3x3_dx_tc_kernel"] > 0,
              f"the profiled {dtype_name} step's backward kernels (ms): {ran}")
    if kind == "convlstm" and kernel_ms is not None:
        check_ring_blocks(kernel_ms, f"the profiled {dtype_name} ConvLSTM step")
    # the step less its forward and backward: the gradient norm and Adam
    n_grad = profiled_run_ms(lambda: vg(state.params, xb, yb))[3]
    n_opt = None if n_step is None or n_grad is None else n_step - n_grad
    return {
        "model": kind, "dtype": dtype_name, "batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
        "launches": launches, "fit_seconds": fit_s, "losses": losses,
        "fixed_batch_losses": fit_losses, "step1_loss": float(loss_k),
        "step1_plain_loss": float(loss_p), "grad_vs_plain_rel_err": grad_err,
        "grad_worst_tensor": worst,
        "grad_check": {"against": against, "rel_err": check_err, "tensor": check_worst,
                       "tolerance": check_tol},
        "grads_bitwise_repeatable": repeat, "f64_reference": f64,
        "step_ms": times, "step_ms_median": statistics.median(times),
        "profiled_step_ms": prof_ms, "device_busy_ms": busy_ms,
        "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / prof_ms,
        "kernel_device_ms": kernel_ms, "device_kernels_per_step": n_step,
        "device_kernels_forward_backward": n_grad, "device_kernels_optimizer": n_opt,
    }


def flagship_estimator(dtype_name):
    """The flagship C48 U-Net's estimator on the card, seeded weights, with
    the serve phases' normalization stats."""
    from dlwp_cs_tpu_torch import DataConfig, DLWPEstimator, ExperimentConfig

    cfg = ExperimentConfig(data=DataConfig(), model=model_config("unet", dtype_name))
    mean = np.asarray([5500.0, 1000.0, 3500.0, 280.0], np.float32)
    std = np.asarray([300.0, 100.0, 150.0, 15.0], np.float32)
    stats = {"mean": mean, "std": std, "insol_mean": 340.0, "insol_std": 420.0}
    return DLWPEstimator(cfg, device="cuda", seed=0).load_state(stats)


# the data phase: ERA5's 1 degree grid (poles included) -> C48, 120 days
# at 6 h, the remap's batch, the plain version's sample, the training head
DATA_GRID = (181, 360)
DATA_DAYS, DATA_STEP_HOURS = 120.0, 6.0
DATA_BATCH = 256
DATA_PLAIN_TIMES = 32
DATA_TRAIN_STEPS = 10
DATA_TOL = 1e-5  # of each variable's largest |value|: float32 sums in another order


class StoreHead:
    """The first ``t`` times of a store, its fields read lazily as an
    ``H5Store``'s are: the data phase trains 10 steps from the head of the
    480-time store."""

    def __init__(self, store, t):
        self._fields = store.fields
        self.shape = (t,) + tuple(store.fields.shape[1:])
        self.fields = self
        self.times = np.asarray(store.times)[:t]
        for k in ("mean", "std", "variables", "constants", "constant_names", "attrs"):
            setattr(self, k, getattr(store, k))

    def __getitem__(self, idx):
        return self._fields[idx]


def data_phase(workdir):
    """The data pipeline on the card: exact conservative ERA5 1 degree <->
    C48 weights built here, the analytic sources remapped into a 480-time
    store by ``examples/01_build_dataset.build_store`` (the store that the
    examples phase chains from, built once) and held against the plain
    version, the store written and opened as HDF5 where h5py imports, the
    flagship bf16 U-Net trained 10 steps from it, and a 14-day forecast
    remapped back to 181 x 360.  Returns the phase's readings and the
    store, in memory."""
    from dlwp_cs_tpu_torch import DataConfig, DLWPEstimator, ExperimentConfig
    from dlwp_cs_tpu_torch.data import MemoryStore, open_store, write_store
    from dlwp_cs_tpu_torch.models.config import TrainConfig
    from dlwp_cs_tpu_torch.remap import apply_remap, conservative_weights, remap_cs_to_ll
    from dlwp_cs_tpu_torch.tools.timing import bound

    (h, w), n = DATA_GRID, 48
    out = {"grid": [h, w], "n": n}
    weights = {}
    for mode in ("ll2cs", "cs2ll"):
        t = time.perf_counter()
        weights[mode] = conservative_weights(mode, n_lat=h, n_lon=w, n_cs=n,
                                             lat_centered=False, cache_dir=workdir)
        lengths = np.bincount(weights[mode].rows, minlength=weights[mode].shape[0])
        out[mode] = {"seconds": time.perf_counter() - t, "nnz": int(len(weights[mode].rows)),
                     "shape": list(weights[mode].shape),
                     "row_nnz_min_mean_max": [int(lengths.min()), float(lengths.mean()),
                                              int(lengths.max())]}
    ll2cs, cs2ll = weights["ll2cs"], weights["cs2ll"]
    ex01 = _examples()["01"]
    t = time.perf_counter()
    # the example's analytic sources on the grid of the weights (its poles
    # included)
    sources, constants, lats, lons, times = ex01.synthetic_sources(
        h, w, DATA_DAYS, DATA_STEP_HOURS, cell_centered=False)
    out["sources_seconds"] = time.perf_counter() - t
    kernels = all_kernels()
    runs = []
    for _ in range(2):
        for k in kernels.values():
            k.launches = 0
        t = time.perf_counter()
        # the weights come from the cache that the generation above filled
        store = ex01.build_store(sources, constants, lats, lons, times, grid=n,
                                 remap="conservative", cache_dir=workdir, device="cuda")
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t, store))
        launches = {name: k.launches for name, k in kernels.items() if k.launches}
        check(not launches, f"01's build_store launched {launches}")
    store = runs[0][1]
    out["preprocessor_seconds"] = [r[0] for r in runs]
    out["fields_shape"] = list(store.fields.shape)
    out["second_run_bitwise_equal"] = bool(
        np.array_equal(store.fields, runs[1][1].fields)
        and np.array_equal(store.constants, runs[1][1].constants)
        and np.array_equal(store.mean, runs[1][1].mean)
        and np.array_equal(store.std, runs[1][1].std))
    check(out["second_run_bitwise_equal"], "two Preprocessor runs on the card differ")
    check(tuple(store.fields.shape) == (len(times), 6, n, n, 4) and bool(
        np.isfinite(store.fields).all()), f"store fields {store.fields.shape} not finite")

    # the plain version on the host: every time of every variable (the
    # stats need them all), the constants standardized as the port does
    plain = np.empty(store.fields.shape, np.float32)
    t = time.perf_counter()
    for ci, name in enumerate(store.variables):
        for lo in range(0, len(times), 96):
            blk = np.asarray(sources[name][lo:lo + 96], np.float32).reshape(-1, h * w)
            plain[lo:lo + 96, ..., ci] = ll2cs.apply_numpy(blk).reshape(-1, 6, n, n)
    out["plain_seconds"] = time.perf_counter() - t
    errs = {}
    for ci, name in enumerate(store.variables):
        err = float(np.abs(store.fields[:DATA_PLAIN_TIMES, ..., ci]
                           - plain[:DATA_PLAIN_TIMES, ..., ci]).max())
        errs[name] = err / float(np.abs(plain[..., ci]).max())
        errs[name + " (all times)"] = float(
            np.abs(store.fields[..., ci] - plain[..., ci]).max() / np.abs(plain[..., ci]).max())
    for k, (cname, cfield) in enumerate(constants.items()):
        cube = ll2cs.apply_numpy(np.asarray(cfield, np.float32).reshape(1, -1)).reshape(6, n, n)
        sd = cube.std()
        cube = (cube - cube.mean()) / (sd if sd > 1e-12 else 1.0)
        errs[cname] = float(np.abs(store.constants[..., k] - cube).max() / np.abs(cube).max())
    out["max_err_of_largest"] = errs
    check(max(errs.values()) <= DATA_TOL, f"store vs the plain version: {errs} > {DATA_TOL}")
    ref = MemoryStore.from_raw(plain, times, store.variables)
    out["mean_rel_err"] = float(np.max(np.abs(store.mean - ref.mean) / np.abs(ref.mean)))
    out["std_rel_err"] = float(np.max(np.abs(store.std - ref.std) / ref.std))
    check(max(out["mean_rel_err"], out["std_rel_err"]) <= 1e-6,
          f"store stats vs plain: mean {out['mean_rel_err']}, std {out['std_rel_err']}")

    # one 256-time batch: the card's remap (CUDA events) and the plain one
    blk = np.asarray(sources["z500"][:DATA_BATCH], np.float32).reshape(DATA_BATCH, -1)
    xd = torch.from_numpy(blk).cuda()
    first = apply_remap(ll2cs, xd)
    check(torch.equal(first, apply_remap(ll2cs, xd)), "the card's remap is not repeatable")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        apply_remap(ll2cs, xd)
    end.record()
    end.synchronize()
    out["remap_batch_ms"] = start.elapsed_time(end) / 10
    t = time.perf_counter()
    want = ll2cs.apply_numpy(blk)
    out["plain_batch_ms"] = (time.perf_counter() - t) * 1e3
    out["remap_batch_max_abs_err"] = float((first.cpu() - torch.from_numpy(want)).abs().max())
    nnz = len(ll2cs.rows)
    out.update(bound(blk.nbytes + want.nbytes + nnz * 8 + (ll2cs.shape[0] + 1) * 8,
                     2 * nnz * DATA_BATCH, torch.float32))

    # HDF5 where h5py imports; without it write_store must name h5py
    try:
        import h5py  # noqa: F401
        has_h5py = True
    except ImportError:
        has_h5py = False
    if has_h5py:
        write_store(os.path.join(workdir, "predictors_cs.h5"), store)
        train_store = open_store(os.path.join(workdir, "predictors_cs.h5"))
        check(np.array_equal(train_store.load().fields, store.fields), "HDF5 store differs")
        out["store_branch"] = "hdf5 (write_store, open_store)"
    else:
        try:
            write_store(os.path.join(workdir, "predictors_cs.h5"), store)
            raised = None
        except ImportError as e:
            raised = str(e)
        check(raised is not None and "h5py" in raised,
              f"write_store without h5py raised {raised!r}, not an ImportError naming h5py")
        train_store = store
        out["store_branch"] = f"memory (no h5py: write_store raised ImportError: {raised})"

    # the flagship bf16 U-Net: 10 steps at batch 16 from the head of the store
    d = DataConfig()
    tcfg = TrainConfig(batch_size=TRAIN_BATCH, optimizer="adam", learning_rate=1e-3,
                       loss="mse", max_epochs=1, metrics_every=DATA_TRAIN_STEPS)
    cfg = ExperimentConfig(data=d, model=model_config("unet", "bfloat16"), train=tcfg)
    check(tuple(store.variables) == d.variables and store.constant_names == d.constants,
          f"store {store.variables} {store.constant_names} is not the flagship's")
    head = StoreHead(train_store, TRAIN_BATCH * DATA_TRAIN_STEPS + d.input_time_steps
                     + d.output_time_steps - 1)
    est = DLWPEstimator(cfg, device="cuda", seed=0)
    for k in kernels.values():
        k.launches = 0
    t = time.perf_counter()
    est.fit(head, verbose=False)
    torch.cuda.synchronize()
    out["fit_seconds"] = time.perf_counter() - t
    out["train_launches"] = {name: k.launches for name, k in kernels.items()}
    want_fit = want_launches(PER_STEP["unet"], DATA_TRAIN_STEPS)
    check(out["train_launches"] == want_fit,
          f"data phase fit launches {out['train_launches']}, want {want_fit}")
    out["losses"] = [r["loss"] for r in est._last_history.steps]
    check(len(out["losses"]) == DATA_TRAIN_STEPS and all(np.isfinite(out["losses"])),
          f"losses {out['losses']}")

    # a 14-day forecast from the first window, remapped back on the card
    for k in kernels.values():
        k.launches = 0
    t = time.perf_counter()
    fc = est.forecast(train_store, init_indices=[d.input_time_steps - 1], steps=STEPS)
    torch.cuda.synchronize()
    out["forecast_ms"] = (time.perf_counter() - t) * 1e3
    out["forecast_launches"] = kernels["cs_conv3x3"].launches
    check(out["forecast_launches"] == PER_CALL["unet"]["cs_conv3x3"] * STEPS,
          f"forecast launches {out['forecast_launches']}")
    mean = torch.as_tensor(np.asarray(store.mean, np.float32), device="cuda")
    std = torch.as_tensor(np.asarray(store.std, np.float32), device="cuda")
    fields = (fc.fields * std + mean).movedim(-1, 2)  # (1, 56, C, 6, n, n)
    check(bool(torch.isfinite(fields).all()), "forecast not finite")
    t = time.perf_counter()
    ll = remap_cs_to_ll(cs2ll, fields, h, w)
    torch.cuda.synchronize()
    out["remap_back_ms"] = (time.perf_counter() - t) * 1e3
    check(ll.device.type == "cuda" and tuple(ll.shape) == (1, 2 * STEPS, 4, h, w),
          f"remapped forecast {ll.device} {tuple(ll.shape)}")
    host = fields.cpu().numpy().reshape(-1, 6 * n * n)
    back = cs2ll.apply_numpy(host).reshape(ll.shape)
    ll = ll.cpu().numpy()
    out["remap_back_max_err_of_largest"] = {
        name: float(np.abs(ll[:, :, ci] - back[:, :, ci]).max() / np.abs(back[:, :, ci]).max())
        for ci, name in enumerate(store.variables)}
    check(max(out["remap_back_max_err_of_largest"].values()) <= DATA_TOL,
          f"forecast remap vs plain: {out['remap_back_max_err_of_largest']}")
    if has_h5py:
        train_store.close()
    return out, store


def exchange_ms(meshes):
    """Host ms per call, 20 calls after one warm-up, on this rank: one
    ``all_gather`` of a ghost-row strip (1, 6, 1, 48, 32) over the 4 bands,
    and one band and one tile conv (n=48, 32 -> 32, batch 1, bf16) with
    their halo exchanges; the band rows of that band conv by the
    ``ppermute`` pair and by kernel #10; the band conv with #10 as its
    band-row transport; kernel #11 with its seam exchange.  Launches here
    are not the main path's."""
    from dlwp_cs_tpu_torch.parallel.collectives import all_gather
    from dlwp_cs_tpu_torch.parallel.halo import use_band_exchange
    from dlwp_cs_tpu_torch.parallel.hopper_band import make_sharded_pallas_conv3x3
    from dlwp_cs_tpu_torch.parallel.hopper_tile import make_tile_pallas_conv3x3
    from dlwp_cs_tpu_torch.parallel.mesh import SPATIAL_AXIS, local_block
    from dlwp_cs_tpu_torch.parallel.overlap_band import make_overlap_conv3x3
    from dlwp_cs_tpu_torch.parallel.rdma_halo import band_exchange_plain, band_exchange_rdma

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((1, 6, 48, 48, 32), generator=gen, device=dev).to(torch.bfloat16)
    w = [(torch.randn((3, 3, 32, 32), generator=gen, device=dev) * 0.06).to(torch.bfloat16)
         for _ in range(2)] + [torch.zeros(32, device=dev, dtype=torch.bfloat16)] * 2

    def per_call(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / reps

    strip = x[:, :, :1].contiguous()
    out = {"all_gather_ms": per_call(lambda: all_gather(strip, meshes["band"], SPATIAL_AXIS))}
    for kind, make in (("band", make_sharded_pallas_conv3x3), ("tile", make_tile_pallas_conv3x3)):
        conv, block = make(meshes[kind]), local_block(x, meshes[kind])
        out[f"{kind}_conv_ms"] = per_call(lambda: conv(block, *w))
    # the band rows of one conv: the ppermute pair, kernel #10; the band conv
    # with #10 as its band-row transport, and kernel #11 with its seam exchange
    band = local_block(x, meshes["band"])
    out["ppermute_pair_ms"] = per_call(lambda: band_exchange_plain(band, 1, mesh=meshes["band"]))
    out["rdma_exchange_ms"] = per_call(lambda: band_exchange_rdma(band, 1, mesh=meshes["band"]))
    conv = make_sharded_pallas_conv3x3(meshes["band"])
    with use_band_exchange("rdma"):
        out["rdma_band_conv_ms"] = per_call(lambda: conv(band, *w))
    conv = make_overlap_conv3x3(meshes["band"])
    out["overlap_conv_ms"] = per_call(lambda: conv(band, *w))
    return out


def rank_ms(fn, reps):
    """Device ms per call of ``fn`` on this rank: ``reps`` calls enqueued
    back to back between CUDA events, after one call.  For the kernels that
    wait on the other ranks, whose launches a CUDA graph would freeze (each
    call takes the next epoch)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps):
    """Host ms per call of ``fn`` ending in a device synchronise, after one
    call (for the paths that stage collectives through the host)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def remote_cases(mesh, b, dtype, convs: bool = True, v1_turns: bool = True):
    """Kernels #10 and (with ``convs``) #11 on this rank's band at each
    flagship conv shape (batch ``b``): #10 on the conv's input against the
    ``ppermute`` pair
    (equal), #11 against its plain version on the same seam strips and
    received rows (f32 1e-4; bf16 one ulp + 1e-4) and against #8 on the
    exchanged strips; each kernel's device time per call, with
    ``v1_turns`` in turns with its first design (``*_v1``, held against
    the same references at every shape: its time includes the other ranks'
    time slices, which it waits out spinning; without, ``v1_ms`` is None
    and the kernel's own time is two runs), the plain versions' times, one
    face-grouped cuDNN call on the padded band and the bounds.  A
    collective call; launches here are not the main path's."""
    from dlwp_cs_tpu_torch.ops.hopper_conv import _padded_faces
    from dlwp_cs_tpu_torch.parallel.collectives import axis_index, axis_size
    from dlwp_cs_tpu_torch.parallel.halo import halo_pieces
    from dlwp_cs_tpu_torch.parallel.hopper_band import band_conv3x3, band_ext
    from dlwp_cs_tpu_torch.parallel.mesh import SPATIAL_AXIS, local_block
    from dlwp_cs_tpu_torch.parallel.overlap_band import (
        _seam_ext,
        band_conv3x3_overlap,
        band_conv3x3_overlap_plain,
        band_conv3x3_overlap_v1,
    )
    from dlwp_cs_tpu_torch.parallel.rdma_halo import (
        band_exchange_plain,
        band_exchange_rdma,
        band_exchange_rdma_v1,
    )
    from dlwp_cs_tpu_torch.tools.timing import (
        HBM_BYTES_PER_S, bf16_excess, bound, face_grouped, graph_ms)

    dev = torch.device("cuda")
    s = axis_index(mesh, SPATIAL_AXIS)
    xchg, conv = [], []
    for n, cin, cout in sorted(set(FLAGSHIP_CONVS), key=FLAGSHIP_CONVS.index):
        gen = torch.Generator(device=dev).manual_seed(n * 1000 + cin * 7 + cout)
        x = local_block(torch.randn((b, 6, n, n, cin), generator=gen, device=dev).to(dtype),
                        mesh)
        ks = [(torch.randn((3, 3, cin, cout), generator=gen, device=dev)
               * (9 * cin) ** -0.5).to(dtype) for _ in range(2)]
        bs = [(torch.randn((cout,), generator=gen, device=dev) * 0.1).to(dtype)
              for _ in range(2)]
        h, item = x.shape[2], x.element_size()
        slab = b * 6 * n * cin * item
        # #10 on this conv's input (width 1)
        ours = band_exchange_rdma(x, 1, mesh=mesh)
        old = band_exchange_rdma_v1(x, 1, mesh=mesh)
        ref = band_exchange_plain(x, 1, mesh=mesh)
        torch.cuda.synchronize()
        err10 = max(float((a.float() - r.float()).abs().max()) for a, r in zip(ours, ref))
        equal10 = all(torch.equal(a, r) for a, r in zip(ours, ref))
        equal_v1 = all(torch.equal(a, r) for a, r in zip(old, ref))
        ms10, v1_10, turns10 = _turns(lambda: band_exchange_rdma(x, 1, mesh=mesh),
                                      lambda: band_exchange_rdma_v1(x, 1, mesh=mesh), 20,
                                      timer=rank_ms, with_old=v1_turns)
        plain10 = host_ms(lambda: band_exchange_plain(x, 1, mesh=mesh), 5)
        t_bytes = 4 * slab / HBM_BYTES_PER_S * 1e3  # 2 boundary slabs read, 2 written
        xchg.append({
            "n": n, "cin": cin, "cout": cout, "batch": b, "rows": h,
            "dtype": str(dtype).split(".")[-1], "max_abs_err": err10, "equal": equal10,
            "v1_equal": equal_v1, "ok": equal10 and equal_v1, "ms": ms10, "v1_ms": v1_10,
            "turns_ms": turns10, "plain_ms": plain10, "library_ms": None,
            "bound_ms": t_bytes, "bound_by": "bytes", "bytes": 4 * slab, "ops": 0})
        if not convs:
            continue
        # #11 on the same band, and #8 on the exchanged strips
        seam, wecols = _seam_ext(x, mesh=mesh)
        below, above = band_exchange_plain(x, 1, mesh=mesh)
        first, last = s == 0, s == axis_size(mesh, SPATIAL_AXIS) - 1
        ref = band_conv3x3_overlap_plain(x, seam, wecols, below, above, *ks, *bs,
                                         first=first, last=last)
        ours = band_conv3x3_overlap.fused(x, seam, wecols, *ks, *bs, mesh=mesh)
        old = band_conv3x3_overlap_v1.fused(x, seam, wecols, *ks, *bs, mesh=mesh)
        k8 = band_conv3x3(x, *ks, *bs, mesh=mesh)
        torch.cuda.synchronize()
        err = float((ours.float() - ref.float()).abs().max())
        if dtype == torch.float32:
            tol, ok = "1e-4 abs", err <= 1e-4
        else:
            tol, ok = "2**-7*|ref| + 1e-4", bf16_excess(ours, ref) <= 1e-4
        ext = band_ext(*halo_pieces(x, 1, mesh=mesh))
        p, w = face_grouped(_padded_faces(x, ext), ks)
        bias = torch.cat([bs[0]] * 4 + [bs[1]] * 2)
        ms11, v1_11, turns11 = _turns(
            lambda: band_conv3x3_overlap.fused(x, seam, wecols, *ks, *bs, mesh=mesh),
            lambda: band_conv3x3_overlap_v1.fused(x, seam, wecols, *ks, *bs, mesh=mesh), 20,
            timer=rank_ms, with_old=v1_turns)
        plain11 = graph_ms(lambda: band_conv3x3_overlap_plain(
            x, seam, wecols, below, above, *ks, *bs, first=first, last=last), 3)
        library_ms = graph_ms(lambda: F.conv2d(p, w, bias, groups=6), 20)
        # the band, the seam strips, the two rows received, weights; the output
        nbytes = item * (x.numel() + seam.numel() + wecols.numel() + 2 * ks[0].numel()
                         + 2 * cout + b * 6 * h * n * cout) + 2 * slab
        ops = 2 * b * 6 * h * n * 9 * cin * cout
        conv.append({
            "n": n, "cin": cin, "cout": cout, "batch": b, "rows": h,
            "dtype": str(dtype).split(".")[-1], "max_abs_err": err, "tolerance": tol,
            "ok": ok and bool(torch.equal(ours, k8)) and bool(torch.equal(old, k8)),
            "vs_band_kernel_max_abs_err": float((ours.float() - k8.float()).abs().max()),
            "equal_to_band_kernel": bool(torch.equal(ours, k8)),
            "v1_equal_to_band_kernel": bool(torch.equal(old, k8)),
            "ms": ms11, "v1_ms": v1_11, "turns_ms": turns11, "plain_ms": plain11,
            "library_ms": library_ms,
            **bound(nbytes, ops, dtype)})
    return xchg, conv


COLLECTIVE_REPS = 20  # back-to-back device calls a timing run, four runs in turns
PLAIN_REPS = 5  # the gloo plain version's calls a run (1-25 ms each)


def captured_collectives(run):
    """The device collectives ``run()`` issues, as ``{key: [op, group,
    shape, dtype, args, count]}`` in the order first met: what a sharded
    model call hands the transport."""
    import torch.distributed as dist

    from dlwp_cs_tpu_torch.parallel import device_collectives as dc

    seen, saved = {}, {op: getattr(dc, op) for op in ("psum", "all_gather", "ppermute")}

    def wrap(op):
        def inner(x, group, *args):
            key = (op, tuple(dist.get_process_group_ranks(group)), tuple(x.shape), x.dtype,
                   args)
            seen.setdefault(key, [op, group, tuple(x.shape), x.dtype, args, 0])[-1] += 1
            return saved[op](x, group, *args)
        return inner

    for op in saved:
        setattr(dc, op, wrap(op))
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for op, fn in saved.items():
            setattr(dc, op, fn)
    return seen


def collective_cases(captured, where, seed):
    """Each captured collective on fresh seeded inputs (each rank its own):
    the device transport against the plain version over gloo (bitwise),
    each timed with CUDA events around ``COLLECTIVE_REPS`` back-to-back
    calls, in turns with the plain version (plain, device, device, plain),
    beside the bound: the bytes its kernels read and write over the HBM
    rate.  A collective call of every rank of the groups."""
    import torch.distributed as dist

    from dlwp_cs_tpu_torch.parallel import device_collectives as dc
    from dlwp_cs_tpu_torch.tools.timing import HBM_BYTES_PER_S

    gen = torch.Generator(device="cuda").manual_seed(seed + dist.get_rank())
    out = []
    for key, (op, group, shape, dtype, args, count) in captured.items():
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        S = dist.get_world_size(group)
        launches0 = {k: w.launches for k, w in dc.KERNELS.items()}
        ours = getattr(dc, op)(x, group, *args)
        launched = {k: w.launches - launches0[k] for k, w in dc.KERNELS.items()}
        ref = getattr(dc, op + "_plain")(x, group, *args)
        torch.cuda.synchronize()
        equal = bool(torch.equal(ours, ref))
        ms, plain_ms, turns = _turns(lambda: getattr(dc, op)(x, group, *args),
                                     lambda: getattr(dc, op + "_plain")(x, group, *args),
                                     COLLECTIVE_REPS, timer=rank_ms, old_reps=PLAIN_REPS)
        slab = x.numel() * x.element_size()
        me = dist.get_rank(group)
        if op == "ppermute":
            pairs = dict(args[0])
            sends = int(me in pairs and pairs[me] != me)
            reads = int(me in {d for _, d in args[0]})
        else:
            sends, reads = S - 1, S
        # the send's read of x and stores, the unpack's or reduce's reads and
        # its output
        nbytes = slab * (sends > 0) + slab * sends + slab * reads + ours.numel() * ours.element_size()
        out.append({
            "where": where, "op": op, "ranks": S, "shape": list(shape),
            "dtype": str(dtype).split(".")[-1], "args": repr(args), "per_model_call": count,
            "equal": equal, "ok": equal, "max_abs_err": float((ours.float() - ref.float()).abs().max())
            if ours.numel() else 0.0,
            "launches_per_call": launched, "ms": ms, "plain_ms": plain_ms, "turns_ms": turns,
            "bytes": nbytes, "ops": 0, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None})
    return out


def collectives_phase_rank(meshes, model, dtype_names):
    """The collectives phase on this rank: the collectives one sharded
    model call issues through each mesh of ``meshes`` (``{name: mesh}``;
    ``make_spatial_apply`` with #8 / #9), in each dtype, and the data-axis
    gradient bucket of ``model`` (a float32 vector of its parameters and the
    loss, as ``parallel.sharding.psum_bucket`` sums it), held against the
    plain version and timed (:func:`collective_cases`)."""
    import torch.distributed as dist

    from dlwp_cs_tpu_torch.models import DataConfig
    from dlwp_cs_tpu_torch.parallel import make_spatial_apply

    d = DataConfig()
    cases = []
    for dtype_name in dtype_names:
        net = model(dtype_name)
        x = torch.randn((1, 6, 48, 48, d.input_channels),
                        generator=torch.Generator().manual_seed(5)).cuda()
        for name, mesh in meshes.items():
            fn = make_spatial_apply(net, mesh, band_conv="pallas")
            cases += collective_cases(captured_collectives(lambda: fn(x)), name, 50)
    bucket = sum(p.numel() for p in model(dtype_names[0]).parameters()) + 1
    cases += collective_cases(
        {"bucket": ["psum", dist.group.WORLD, (bucket,), torch.float32, (), 1]}, "bucket", 60)
    return cases


def sharded_rank(dtype_names, windows, t0, const, pert):
    """One rank of the sharded serve phase (a spawned process of a gloo
    group of ``SHARDS`` ranks sharing the card): per dtype, a 14-day forecast
    at batch 1 through kernel #8 on row bands, through #9 on 2 x 2 tiles,
    through #8 with #10 moving the band rows, and through #11, then the mesh
    service at batch 3, its ensemble of ``MESH_MEMBERS`` members on
    ``data = 2`` (padded by one window) with the perturbations ``pert``, and
    its rank-0 front end (3 submits on rank 0 while the others follow());
    before them the exchange probe, kernels #10 and #11 at every flagship
    band shape and the collectives phase (:func:`collectives_phase_rank`
    on the band and tile meshes and the data-axis bucket).  Returns the
    fields, the launches of every kernel and the collectives per forecast
    (on the device, through the host), the wall times and the kernel
    cases."""
    import torch.distributed as dist

    from dlwp_cs_tpu_torch import ForecastService, TimeSeriesEstimator
    from dlwp_cs_tpu_torch.parallel import create_mesh, make_spatial_apply

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = all_kernels()
    coll = collective_kernels()
    meshes = {"band": create_mesh(data=1, spatial=SHARDS),
              "tile": create_mesh(data=1, spatial=2, spatial_x=2),
              "service": create_mesh(data=2, spatial=2)}
    from dlwp_cs_tpu_torch.tools.xchg_probe import probe_rank

    models = {}

    def model(dtype_name):
        if dtype_name not in models:
            models[dtype_name] = flagship_estimator(dtype_name).model
        return models[dtype_name]

    seconds, t_step = {}, time.perf_counter()

    def lap(name):  # this rank's seconds per part of the phase
        nonlocal t_step
        now = time.perf_counter()
        seconds[name], t_step = now - t_step, now

    out = {"probe": probe_rank(PROBE_ROUNDS), "exchange": exchange_ms(meshes), "xchg": [],
           "overlap": [], "seconds": seconds}
    lap("probe, exchange")
    out["collectives"] = collectives_phase_rank({k: meshes[k] for k in ("band", "tile")},
                                                model, dtype_names)
    lap("collectives")
    for b in (1, 8):
        for dtype in (torch.float32, torch.bfloat16):
            xchg, conv = remote_cases(meshes["band"], b, dtype, v1_turns=b == 1)
            out["xchg"] += xchg
            out["overlap"] += conv
    lap("#10, #11")
    for dtype_name in dtype_names:
        est = flagship_estimator(dtype_name)
        lat, lon = est.cs.cell_latlon
        mean, std = est.stats["mean"], est.stats["std"]
        for kind, mesh_kind, opts in SHARDED_PATHS:
            ts = TimeSeriesEstimator(
                model=make_spatial_apply(est.model, meshes[mesh_kind], **opts),
                data_cfg=est.config.data, lat=lat, lon=lon, constants=const,
                insol_mean=est.stats["insol_mean"], insol_std=est.stats["insol_std"],
                device=est.device)
            normed = (windows[:1] - mean) / std
            ts.predict(normed, t0[:1], steps=2)  # warm-up
            for k in (*kernels.values(), *coll.values()):
                k.launches = 0
            calls = collective_counts()
            t = time.perf_counter()
            fields = ts.predict(normed, t0[:1], steps=STEPS).fields.cpu().numpy()
            wall = (time.perf_counter() - t) * 1e3
            out[kind, dtype_name] = {
                "fields": fields, "wall_ms": wall, "collectives": collective_delta(calls),
                "launches": {name: k.launches for name, k in kernels.items()},
                "collective_launches": {name: k.launches for name, k in coll.items()}}
        # the front end's 3 submits fill its batch of 3 (padded to 4 over
        # data, as the collective call's 3 windows are): no wait for peers
        svc = ForecastService(est, constants=const, mesh=meshes["service"], max_batch=3,
                              max_wait_ms=1000.0)
        svc.forecast(windows[:3], t0[:3], steps=1)  # warm-up
        padded = svc.stats.padded_mesh
        for k in (*kernels.values(), *coll.values()):
            k.launches = 0
        calls = collective_counts()
        t = time.perf_counter()
        fc = svc.forecast(windows[:3], t0[:3], steps=STEPS)
        wall = (time.perf_counter() - t) * 1e3
        out["service", dtype_name] = {
            "fields": fc.fields, "wall_ms": wall, "collectives": collective_delta(calls),
            "padded_mesh": svc.stats.padded_mesh - padded,
            "launches": {name: k.launches for name, k in kernels.items()},
            "collective_launches": {name: k.launches for name, k in coll.items()}}
        # an ensemble under data = 2: one window, MESH_MEMBERS members,
        # padded by one window; the perturbations handed in
        padded = svc.stats.padded_mesh
        calls = collective_counts()
        t = time.perf_counter()
        ens = svc.forecast_ensemble(windows[0], t0[0], steps=STEPS, members=MESH_MEMBERS,
                                    perturbations=pert, keep_members=True)
        out["mesh_ensemble", dtype_name] = {
            "members": ens.members, "mean": ens.mean, "spread": ens.spread,
            "wall_ms": (time.perf_counter() - t) * 1e3,
            "padded_mesh": svc.stats.padded_mesh - padded, "collectives": collective_delta(calls)}
        # the rank-0 front end: rank 0 submits 3 requests, the others follow
        batches, broadcasts = svc.stats.batches, svc.stats.host_broadcasts
        calls = collective_counts()
        t = time.perf_counter()
        if dist.get_rank() == 0:
            futs = [svc.submit(windows[i], t0[i], steps=STEPS) for i in range(3)]
            fields = np.concatenate([f.result(timeout=900).fields for f in futs])
            wall = (time.perf_counter() - t) * 1e3
            svc.close()
            front = {"fields": fields, "wall_ms": wall}
        else:
            front = {"runs": svc.follow(), "errors": [repr(e) for e in svc.follow_errors]}
            svc.close()
        front["dispatches"] = svc.stats.batches - batches
        front["collectives"] = collective_delta(calls)
        front["host_broadcasts"] = svc.stats.host_broadcasts - broadcasts
        out["front", dtype_name] = front
        lap(f"forecasts {dtype_name}")
    return out


def pair_rank(dtype_names):
    """One rank of a group of 2 sharing the card: the exchange probe, then
    kernels #10 and #11 at every flagship conv input cut into 2 bands,
    batch 1, both dtypes, against their references, with their times (the
    first designs in turns); then the collectives phase on 2 bands and the
    data-axis bucket."""
    from dlwp_cs_tpu_torch.parallel import create_mesh
    from dlwp_cs_tpu_torch.tools.xchg_probe import probe_rank

    probe = probe_rank(PROBE_ROUNDS)
    mesh = create_mesh(data=1, spatial=2)
    xchg, conv = [], []
    for dtype in (torch.float32, torch.bfloat16):
        x, c = remote_cases(mesh, 1, dtype)
        xchg += x
        conv += c
    models = {}

    def model(dtype_name):
        if dtype_name not in models:
            models[dtype_name] = flagship_estimator(dtype_name).model
        return models[dtype_name]

    return {"probe": probe, "xchg": xchg, "overlap": conv,
            "collectives": collectives_phase_rank({"band": mesh}, model, dtype_names)}


def sharded_phase(rng, workdir):
    """Serve the flagship U-Net over ``SHARDS`` ranks sharing the card and
    hold every rank's forecasts against the one-card forecasts."""
    from dlwp_cs_tpu_torch import ForecastService
    from dlwp_cs_tpu_torch.parallel.launch import spawn_group

    t_phase = time.perf_counter()
    dtype_names = ("bfloat16", "float32")
    const = rng.normal(size=(6, 48, 48, 2)).astype(np.float32)
    mean = np.asarray([5500.0, 1000.0, 3500.0, 280.0], np.float32)
    std = np.asarray([300.0, 100.0, 150.0, 15.0], np.float32)
    windows = (rng.normal(size=(3, 2, 6, 48, 48, 4)) * std + mean).astype(np.float32)
    t0 = 9668.5 + 0.25 * np.arange(3)
    from dlwp_cs_tpu_torch.rollout import ic_perturbations

    pert = ic_perturbations(torch.Generator().manual_seed(4), windows[:1].shape,
                            MESH_MEMBERS).numpy()
    one_card = {}
    for dtype_name in dtype_names:
        svc = ForecastService(flagship_estimator(dtype_name), constants=const)
        normed = (windows[:1] - mean) / std
        one_card["kernel", dtype_name] = svc.forecast(
            normed, t0[0], steps=STEPS, normalized=True).fields
        one_card["service", dtype_name] = svc.forecast(windows, t0, steps=STEPS).fields
        one_card["ensemble", dtype_name] = svc.forecast_ensemble(
            windows[0], t0[0], steps=STEPS, members=MESH_MEMBERS, perturbations=pert,
            keep_members=True).members
    one_card_s = time.perf_counter() - t_phase
    t = time.perf_counter()
    ranks = spawn_group(sharded_rank, SHARDS, dtype_names, windows, t0, const, pert,
                        workdir=os.path.join(workdir, "four"))
    group_s = time.perf_counter() - t
    pair = spawn_group(pair_rank, 2, dtype_names, workdir=os.path.join(workdir, "two"))
    exchange = [r["exchange"] for r in ranks]
    seconds = {"one card": one_card_s, "group": group_s,
               "rank 0": ranks[0]["seconds"], "pair": time.perf_counter() - t - group_s}
    kernels = all_kernels()
    # kernel launches per model call of each path
    want = {"band": {"cs_conv3x3_band": 10}, "tile": {"cs_conv3x3_tile": 10}, "service": {},
            "band_rdma": {"cs_conv3x3_band": 10, "band_exchange_rdma": 10},
            "band_overlap": {"band_conv3x3_overlap": 10}}
    results = []
    for dtype_name in dtype_names:
        for kind, per_call in want.items():
            path = "kernel" if per_call else "service"
            ref = one_card[path, dtype_name]
            rel, tol = SHARDED_TOL[path, dtype_name]
            errs, excess, walls = [], [], []
            for rank, r in enumerate(ranks):
                got = r[kind, dtype_name]
                launches = {name: per_call.get(name, 0) * STEPS for name in kernels}
                check(got["launches"] == launches,
                      f"rank {rank} {kind} {dtype_name}: launches {got['launches']}, "
                      f"want {launches}")
                check(got["fields"].shape == ref.shape and np.isfinite(got["fields"]).all(),
                      f"rank {rank} {kind} {dtype_name}: fields {got['fields'].shape}")
                scale = 1.0 if per_call else std  # normalized fields have std 1
                diff = np.abs(got["fields"] - ref) / scale
                errs.append(float(diff.max()))
                excess.append(float((diff - rel * np.abs(ref) / scale).max()))
                walls.append(got["wall_ms"])
                if not per_call:
                    check(got["padded_mesh"] == 1, f"padded_mesh {got['padded_mesh']}")
                # every collective of the forecast on the card, none staged
                # through the host; the send, reduce and unpack kernels launched
                co = got["collectives"]
                check(co["host_calls"] == 0 and co["device_calls"] > 0
                      and all(v > 0 for v in got["collective_launches"].values()),
                      f"rank {rank} {kind} {dtype_name}: collectives {co}, launches "
                      f"{got['collective_launches']}")
            check(max(excess) <= tol, f"{kind} {dtype_name}: sharded vs one-card "
                  f"|diff| exceeds {rel}*|ref| by {max(excess)} std > {tol}")
            results.append({
                "path": kind, "dtype": dtype_name, "batch": 1 if per_call else 3,
                "launches_per_rank": ranks[0][kind, dtype_name]["launches"],
                "collective_launches_per_rank": [r[kind, dtype_name]["collective_launches"]
                                                 for r in ranks],
                "collectives_per_rank": [r[kind, dtype_name]["collectives"] for r in ranks],
                "max_err_in_std": max(errs), "tolerance_in_std": f"{rel:.3g}*|ref| + {tol:.3g}",
                "wall_ms_per_rank": walls,
            })
    # the mesh ensemble and the rank-0 front end, against one card; the
    # front end's dispatch against the collective forecast of the same
    # windows (both pad the 3 windows to 4 over data, repeating the last)
    front = []
    for dtype_name in dtype_names:
        _, tol = SHARDED_TOL["service", dtype_name]
        ens_err = max(float((np.abs(r["mesh_ensemble", dtype_name]["members"]
                                    - one_card["ensemble", dtype_name]) / std).max())
                      for r in ranks)
        check(ens_err <= tol, f"mesh ensemble {dtype_name}: {ens_err} std from one card")
        check(all(r["mesh_ensemble", dtype_name]["padded_mesh"] == 1 for r in ranks),
              "the mesh ensemble padded other than one window")
        # the service's collectives on the card; the front end's broadcasts
        # of host inputs (serve/service.py) on gloo, counted apart
        for what in ("mesh_ensemble", "front"):
            cos = [r[what, dtype_name]["collectives"] for r in ranks]
            check(all(co["host_calls"] == 0 and co["device_calls"] > 0 for co in cos),
                  f"{what} {dtype_name}: collectives {cos}")
        check(all(r["front", dtype_name]["host_broadcasts"] > 0 for r in ranks),
              f"front end {dtype_name}: host broadcasts "
              f"{[r['front', dtype_name]['host_broadcasts'] for r in ranks]}")
        lead = ranks[0]["front", dtype_name]
        check(lead["dispatches"] == 1, f"3 submits on rank 0 took {lead['dispatches']} "
              "dispatches")
        check(all(r["front", dtype_name]["runs"] == 1 and not r["front", dtype_name]["errors"]
                  for r in ranks[1:]), "a follower missed the dispatch or failed")
        front_err = float((np.abs(lead["fields"] - one_card["service", dtype_name]) / std).max())
        check(front_err <= tol, f"front end {dtype_name}: {front_err} std from one card")
        front_equal = bool(np.array_equal(lead["fields"],
                                          ranks[0]["service", dtype_name]["fields"]))
        check(front_equal, f"front end {dtype_name}: differs from the collective forecast")
        front.append({
            "dtype": dtype_name, "dispatches": lead["dispatches"], "wall_ms": lead["wall_ms"],
            "follower_runs": [r["front", dtype_name]["runs"] for r in ranks[1:]],
            "vs_one_card_max_err_in_std": front_err,
            "bitwise_equal_to_collective": front_equal,
            "ensemble_members": MESH_MEMBERS,
            "ensemble_padded_mesh": ranks[0]["mesh_ensemble", dtype_name]["padded_mesh"],
            "ensemble_vs_one_card_max_err_in_std": ens_err,
            "ensemble_wall_ms": [r["mesh_ensemble", dtype_name]["wall_ms"] for r in ranks],
            "tolerance_in_std": tol,
            "ensemble_collectives_per_rank": [r["mesh_ensemble", dtype_name]["collectives"]
                                              for r in ranks],
            "front_collectives_per_rank": [r["front", dtype_name]["collectives"] for r in ranks],
            "front_host_broadcasts_per_rank": [r["front", dtype_name]["host_broadcasts"]
                                               for r in ranks],
        })
    from dlwp_cs_tpu_torch.tools.xchg_probe import summary

    remote = {"xchg4": [c for r in ranks for c in r["xchg"]],
              "overlap4": [c for r in ranks for c in r["overlap"]],
              "xchg2": [c for r in pair for c in r["xchg"]],
              "overlap2": [c for r in pair for c in r["overlap"]],
              "probe": {2: {"ranks": [r["probe"] for r in pair],
                            **summary([r["probe"] for r in pair])},
                        4: {"ranks": [r["probe"] for r in ranks],
                            **summary([r["probe"] for r in ranks])}}}
    bad = [c for key, cases in remote.items() if key != "probe" for c in cases if not c["ok"]]
    check(not bad, f"kernel #10 or #11 disagrees with its plain version: {bad}")
    # per rank, per shape: #10's case (input rows) and #11's, rank 0 first
    remote["per_rank"] = [{"xchg": r["xchg"], "overlap": r["overlap"]} for r in ranks]
    # the collectives phase: every case bitwise equal to the plain version
    # on every rank of 4 and of 2
    coll = {4: [r["collectives"] for r in ranks], 2: [r["collectives"] for r in pair]}
    bad = [c for cases in coll.values() for rank in cases for c in rank if not c["ok"]]
    check(not bad, f"a device collective differs from its plain version: {bad}")
    check(all(rank for cases in coll.values() for rank in cases), "no collective captured")
    remote["phase_seconds"] = seconds
    return results, exchange, group_s, remote, front, coll


# training under a mesh, 4 ranks sharing the card: (name, mesh (data,
# spatial, spatial_x), make_spatial_train_step options (None: the
# data-parallel step), loss, launches of each kernel per step on every rank)
MESH_TRAIN_PATHS = [
    ("dp", (4, 1, 1), None, "mse",
     {"cs_conv3x3": 10, "cs_conv3x3_dx": 9, "cs_conv3x3_dw": 10}),
    ("band", (1, 4, 1), dict(band_conv="pallas"), "mse", {"cs_conv3x3_band": 10}),
    ("band_rdma", (1, 4, 1), dict(band_impl="rdma", band_conv="pallas"), "mse",
     {"cs_conv3x3_band": 10, "band_exchange_rdma": 10}),
    ("band_overlap", (1, 4, 1), dict(band_conv="overlap"), "mse", {"band_conv3x3_overlap": 10}),
    ("tile", (1, 2, 2), dict(band_conv="pallas"), "mse", {"cs_conv3x3_tile": 10}),
    ("weighted", (2, 2, 1), dict(band_conv="pallas"), "area", {"cs_conv3x3_band": 10}),
]
MESH_TRAIN_ADAM = 4  # Adam steps a path
MESH_FIT_BATCHES = 3  # the Trainer.fit epoch on data = 4
MESH_SEQ_BATCH = 4  # the sharded sequence step's global batch (sequence = 2)
# the all-reduced SGD gradients against the one-card step's, per tensor,
# relative to its largest entry
MESH_GRAD_TOL = {"float32": 1e-4, "bfloat16": 2.0**-6}
MESH_SGD_LR = 2.0**20


def _digest(params):
    """SHA-256 of every parameter's bytes, in order: equal on two ranks iff
    their parameters are bitwise equal."""
    import hashlib

    h = hashlib.sha256()
    for p in params.values():
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def mesh_train_rank(dtype_names, seed, ex_head):
    """One rank of the mesh-training phase (a gloo group of ``SHARDS`` ranks
    sharing the card), per dtype: for each path of ``MESH_TRAIN_PATHS``, one
    SGD step (learning rate ``MESH_SGD_LR``) on the global batch, its all-reduced
    gradients (the parameters' change) against the one-card
    ``Trainer.train_step``'s on the same batch, then ``MESH_TRAIN_ADAM`` Adam
    steps with every launch count set to 0 before and read after, their
    losses and host times; then one ``Trainer(mesh=data 4).fit`` epoch on a
    seeded ``MemoryStore`` fed by ``prefetch_to_device(sharding=mesh)`` and
    one ``make_sharded_sequence_train_step`` step (sequence 2) on 4 bands;
    last, the examples phase's ``05_sequence_train --mesh 2x2`` on
    ``ex_head`` (:func:`examples_mesh_rank`: this group spares that phase
    a group of its own).  Returns errors, losses, times, launches,
    collectives and the digests of the parameters (the parent compares the
    ranks')."""
    from dlwp_cs_tpu_torch.data import MemoryStore, SeriesDataset, prefetch_to_device
    from dlwp_cs_tpu_torch.geometry.cubed_sphere import CubedSphere
    from dlwp_cs_tpu_torch.models import DataConfig, build_model
    from dlwp_cs_tpu_torch.models.config import TrainConfig
    from dlwp_cs_tpu_torch.ops.losses import AreaWeightedLoss, mse
    from dlwp_cs_tpu_torch.parallel import (
        create_mesh,
        make_dp_train_step,
        make_spatial_train_step,
        shard_batch,
    )
    from dlwp_cs_tpu_torch.train import (
        Trainer,
        init_state,
        make_optimizer,
        make_sequence_loss,
        make_sharded_sequence_train_step,
        model_apply,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = all_kernels()
    coll = collective_kernels()
    meshes = {}

    def mesh(shape):  # every rank creates the meshes in the same order
        if shape not in meshes:
            meshes[shape] = create_mesh(data=shape[0], spatial=shape[1], spatial_x=shape[2])
        return meshes[shape]

    def reset():
        for k in (*kernels.values(), *coll.values()):
            k.launches = 0
        return collective_counts()

    def coll_launches(per=1):
        return {k: v.launches / per for k, v in coll.items()}

    d = DataConfig()
    cs = CubedSphere(d.grid_n)
    rng = np.random.default_rng(seed)  # the same draws on every rank
    x = rng.standard_normal((TRAIN_BATCH, 6, 48, 48, d.input_channels), dtype=np.float32)
    xb = torch.from_numpy(x).cuda()
    yb = 0.5 * xb[..., : d.output_channels]
    n_times = TRAIN_BATCH * MESH_FIT_BATCHES + d.input_time_steps + d.output_time_steps - 1
    fields = rng.standard_normal((n_times, 6, 48, 48, 4), dtype=np.float32) * 10.0 + 280.0
    const = rng.standard_normal((6, 48, 48, 2), dtype=np.float32)
    window = rng.standard_normal((MESH_SEQ_BATCH, d.input_time_steps, 6, 48, 48, 4),
                                 dtype=np.float32)
    targets = rng.standard_normal((MESH_SEQ_BATCH, 2, 6, 48, 48, d.output_channels),
                                  dtype=np.float32)
    t0 = 9668.5 + 0.25 * np.arange(MESH_SEQ_BATCH)
    lat, lon = cs.cell_latlon
    out = {}
    for dtype_name in dtype_names:
        model = build_model(model_config("unet", dtype_name), d.input_channels, device="cuda",
                            generator=torch.Generator().manual_seed(0))
        apply = model_apply(model)
        for name, shape, opts, loss_kind, _ in MESH_TRAIN_PATHS:
            area = loss_kind == "area"
            loss_fn = AreaWeightedLoss("mse", cs.area_weights) if area else mse
            m = mesh(shape)
            batch = shard_batch((xb, yb), m) if opts is None else (xb, yb)

            def make(opt):
                if opts is None:
                    return make_dp_train_step(apply, opt, loss_fn, m)
                return make_spatial_train_step(apply, opt, loss_fn, m, **opts)

            # one SGD step at learning rate 2**20: each parameter's change is
            # its all-reduced gradient scaled by a power of two, rounded once
            # relative to the gradient; against the one-card step's
            one = Trainer(model, TrainConfig(optimizer="sgd", learning_rate=MESH_SGD_LR,
                                             area_weighted_loss=area),
                          area_weights=cs.area_weights if area else None)
            state0 = one.init(xb)
            ref, _ = one.train_step(state0, xb, yb)
            sgd, _ = make(one.optimizer)(state0, *batch)
            errs = {}
            for k, p0 in state0.params.items():
                g_ref = (p0 - ref.params[k]).detach()
                g = (p0 - sgd.params[k]).detach()
                errs[k] = float((g - g_ref).abs().max() / g_ref.abs().max())
            worst = max(errs, key=errs.get)
            # Adam steps: the main path of this phase, counted
            adam = make_optimizer(TrainConfig(learning_rate=1e-3))
            step = make(adam)
            state = init_state(dict(state0.params), adam)
            losses, times = [], []
            calls = reset()
            for _ in range(MESH_TRAIN_ADAM):
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, metrics = step(state, *batch)
                losses.append(float(metrics["loss"]))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            out[name, dtype_name] = {
                "grad_rel_err": errs[worst], "grad_worst_tensor": worst,
                "grads_nonzero": all(float((p0 - sgd.params[k]).detach().abs().max()) > 0
                                     for k, p0 in state0.params.items()),
                "losses": losses, "step_ms": times,
                "launches": {k: v.launches for k, v in kernels.items()},
                "collective_launches_per_step": coll_launches(MESH_TRAIN_ADAM),
                "collectives_per_step": {k: v / MESH_TRAIN_ADAM
                                         for k, v in collective_delta(calls).items()},
                "digest_sgd": _digest(sgd.params), "digest": _digest(state.params),
            }
        # one Trainer.fit epoch on data = 4, each rank fed its blocks
        store = MemoryStore.from_raw(fields, 9000.0 + 0.25 * np.arange(n_times), d.variables,
                                     constants=const, constant_names=d.constants)
        ds = SeriesDataset(store, d, lat=lat, lon=lon, batch_size=TRAIN_BATCH)
        m4 = mesh((4, 1, 1))
        trainer = Trainer(model, TrainConfig(batch_size=TRAIN_BATCH, learning_rate=1e-3,
                                             max_epochs=1), mesh=m4)
        state = trainer.init(xb)
        calls = reset()
        t = time.perf_counter()
        state = trainer.fit(state, lambda: prefetch_to_device(iter(ds), sharding=m4),
                            verbose=False)
        torch.cuda.synchronize()
        out["fit", dtype_name] = {
            "seconds": time.perf_counter() - t, "steps": state.step,
            "losses": [r["loss"] for r in trainer.history.steps],
            "launches": {k: v.launches for k, v in kernels.items()},
            "collective_launches": coll_launches(), "collectives": collective_delta(calls),
            "digest": _digest(state.params)}
        # one sharded sequence step (sequence 2) on 4 bands: the band
        # ring-fix conv, no kernel; its loss beside the one-card sequence loss
        kw = dict(lat=lat, lon=lon, constants=const, insol_mean=300.0, insol_std=400.0,
                  sequence=2)
        seq_step = make_sharded_sequence_train_step(apply, d, adam, mesh((1, 4, 1)), **kw)
        state = init_state(dict(state0.params), adam)
        with torch.no_grad():
            one_card = float(make_sequence_loss(apply, d, **kw)(
                state.params, *(torch.from_numpy(np.asarray(a, np.float32)).cuda()
                                for a in (window, t0, targets))))
        calls = reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = seq_step(state, window, t0, targets)
        loss = float(metrics["loss"])
        out["sequence", dtype_name] = {
            "loss": loss, "one_card_loss": one_card, "step_ms": (time.perf_counter() - t) * 1e3,
            "launches": {k: v.launches for k, v in kernels.items()},
            "collective_launches": coll_launches(), "collectives": collective_delta(calls),
            "digest": _digest(state.params)}
    out["examples 05 --mesh"] = examples_mesh_rank(ex_head, dict(EX_SEQ, device=None))
    return out


def mesh_train_phase(workdir, ex_head):
    """Train the flagship U-Net under the meshes of ``MESH_TRAIN_PATHS`` on
    ``SHARDS`` ranks sharing the card and check every rank's results; the
    ranks then run ``05_sequence_train --mesh 2x2`` on ``ex_head``, whose
    per-rank results (checked by the examples phase) come back third."""
    from dlwp_cs_tpu_torch.parallel.launch import spawn_group

    dtype_names = ("bfloat16", "float32")
    t = time.perf_counter()
    ranks = spawn_group(mesh_train_rank, SHARDS, dtype_names, 6, ex_head,
                        workdir=os.path.join(workdir, "mesh_train"))
    group_s = time.perf_counter() - t
    names = list(all_kernels())
    paths = []
    for dtype_name in dtype_names:
        tol = MESH_GRAD_TOL[dtype_name]
        for name, shape, opts, _, per_step in MESH_TRAIN_PATHS:
            rows = [r[name, dtype_name] for r in ranks]
            want = {k: per_step.get(k, 0) * MESH_TRAIN_ADAM for k in names}
            for rank, row in enumerate(rows):
                check(row["launches"] == want, f"mesh train {name} {dtype_name} rank {rank}: "
                      f"launches {row['launches']}, want {want}")
                check(row["grads_nonzero"], f"mesh train {name} {dtype_name} rank {rank}: a "
                      "parameter got no gradient")
                check(row["grad_rel_err"] <= tol, f"mesh train {name} {dtype_name} rank {rank}: "
                      f"gradients vs one card {row['grad_rel_err']} > {tol} in "
                      f"{row['grad_worst_tensor']}")
                losses = row["losses"]
                check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                      f"mesh train {name} {dtype_name} rank {rank}: losses {losses}")
            for key in ("digest_sgd", "digest"):
                check(len({row[key] for row in rows}) == 1,
                      f"mesh train {name} {dtype_name}: parameters differ across ranks ({key})")
            for rank, row in enumerate(rows):
                co = row["collectives_per_step"]
                check(co["host_calls"] == 0 and co["device_calls"] > 0
                      and row["collective_launches_per_step"]["collective_send"] > 0,
                      f"mesh train {name} {dtype_name} rank {rank}: collectives a step {co}")
            paths.append({
                "path": name, "mesh": shape, "options": opts, "dtype": dtype_name,
                "launches_per_step": {k: v // MESH_TRAIN_ADAM for k, v in want.items() if v},
                "grad_rel_err_per_rank": [row["grad_rel_err"] for row in rows],
                "grad_tolerance": tol, "losses_rank0": rows[0]["losses"],
                "step_ms_per_rank": [row["step_ms"] for row in rows],
                "step_ms_median_per_rank": [statistics.median(row["step_ms"]) for row in rows],
                "collectives_per_step": [row["collectives_per_step"] for row in rows],
                "collective_launches_per_step": [row["collective_launches_per_step"]
                                                 for row in rows],
                "bitwise_equal_across_ranks": True,
            })
        fits = [r["fit", dtype_name] for r in ranks]
        want = {k: 0 for k in names}
        want.update({k: v * MESH_FIT_BATCHES for k, v in MESH_TRAIN_PATHS[0][4].items()})
        for rank, f in enumerate(fits):
            check(f["steps"] == MESH_FIT_BATCHES and len(f["losses"]) == MESH_FIT_BATCHES
                  and all(np.isfinite(f["losses"])), f"fit {dtype_name} rank {rank}: {f}")
            check(f["launches"] == want, f"fit {dtype_name} rank {rank}: launches "
                  f"{f['launches']}, want {want}")
        check(len({f["digest"] for f in fits}) == 1, f"fit {dtype_name}: parameters differ "
              "across ranks")
        for what, rows in (("fit", fits), ("sequence", [r["sequence", dtype_name]
                                                         for r in ranks])):
            cos = [q["collectives"] for q in rows]
            check(all(co["host_calls"] == 0 and co["device_calls"] > 0 for co in cos),
                  f"mesh train {what} {dtype_name}: collectives {cos}")
        seqs = [r["sequence", dtype_name] for r in ranks]
        check(all(np.isfinite(q["loss"]) and q["loss"] == seqs[0]["loss"] for q in seqs),
              f"sequence {dtype_name}: losses {[q['loss'] for q in seqs]}")
        check(all(not any(q["launches"].values()) for q in seqs),
              f"sequence {dtype_name}: a kernel launched on the ring-fix path")
        check(len({q["digest"] for q in seqs}) == 1, f"sequence {dtype_name}: parameters "
              "differ across ranks")
        paths.append({
            "path": "fit", "mesh": (4, 1, 1), "dtype": dtype_name, "steps": MESH_FIT_BATCHES,
            "seconds_per_rank": [f["seconds"] for f in fits], "losses_rank0": fits[0]["losses"],
            "launches_per_step": {k: v // MESH_FIT_BATCHES for k, v in want.items() if v},
            "collectives_per_rank": [f["collectives"] for f in fits],
            "collective_launches_per_rank": [f["collective_launches"] for f in fits],
            "bitwise_equal_across_ranks": True,
        })
        paths.append({
            "path": "sequence", "mesh": (1, 4, 1), "dtype": dtype_name, "sequence": 2,
            "batch": MESH_SEQ_BATCH, "loss": seqs[0]["loss"],
            "one_card_loss": seqs[0]["one_card_loss"],
            "step_ms_per_rank": [q["step_ms"] for q in seqs],
            "collectives_per_rank": [q["collectives"] for q in seqs],
            "collective_launches_per_rank": [q["collective_launches"] for q in seqs],
            "bitwise_equal_across_ranks": True,
        })
    return paths, group_s, [r["examples 05 --mesh"] for r in ranks]


# the quantized serving phase (ops/quant.py): the int8 base conv at each
# flagship conv shape, then the flagship U-Net and the ConvLSTM served in int8
QUANT_BATCHES = (1, ENS_MEMBERS)


def int8_conv_case(n, cin, cout, b, dtype, gen):
    """The int8 base conv at one shape, bitwise against its plain version on
    the card; its time (CUDA-graph replays) beside the plain version's, that
    of ``torch._int_mm`` on the gathered columns (the gather timed apart)
    and #1's on the same shape in ``dtype``."""
    from dlwp_cs_tpu_torch.ops.halo import ext_strips
    from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3
    from dlwp_cs_tpu_torch.ops.quant import (
        cs_conv3x3_int8_base,
        cs_conv3x3_int8_plain,
        quantize_kernel,
        quantize_tensor,
    )
    from dlwp_cs_tpu_torch.tools.timing import bound, graph_ms

    dev = torch.device("cuda")
    x = torch.randn((b, 6, n, n, cin), generator=gen, device=dev).to(dtype)
    ks = [(torch.randn((3, 3, cin, cout), generator=gen, device=dev) * (9 * cin) ** -0.5)
          .to(dtype) for _ in range(2)]
    qx, sx = quantize_tensor(x)
    (qke, ske), (qkp, skp) = quantize_kernel(ks[0]), quantize_kernel(ks[1])
    args = (qx, torch.stack([qke, qkp]), torch.stack([sx * ske, sx * skp]), dtype)
    ours = cs_conv3x3_int8_base(*args)
    ref = cs_conv3x3_int8_plain(*args)
    torch.cuda.synchronize()
    # the library's int8 product: every face's 3x3 windows gathered into
    # columns (K = 9 Cin, padded to a multiple of 8) against both groups'
    # kernels side by side (N = 2 Cout, padded likewise), the reference's
    # two full-face convs as one s8 x s8 -> s32 matrix product
    k8, n8 = -(-9 * cin // 8) * 8, -(-2 * cout // 8) * 8
    qxp = F.pad(qx, (0, 0, 1, 1, 1, 1))

    def gather():
        cols = torch.cat([qxp[:, :, dy:dy + n, dx:dx + n] for dy in range(3) for dx in range(3)],
                         dim=-1)
        return F.pad(cols.reshape(-1, 9 * cin), (0, k8 - 9 * cin))

    cols = gather()
    w = F.pad(torch.cat([qke.reshape(9 * cin, cout), qkp.reshape(9 * cin, cout)], dim=1),
              (0, n8 - 2 * cout, 0, k8 - 9 * cin))
    sums = torch._int_mm(cols, w).reshape(b, 6, n, n, n8)
    lib = torch.cat([(sums[:, :4, ..., :cout].float() * args[2][0]).to(dtype),
                     (sums[:, 4:, ..., cout:2 * cout].float() * args[2][1]).to(dtype)], dim=1)
    kernel = cs_conv3x3_int8_base
    before = kernel.launches
    ms = graph_ms(lambda: kernel(*args), 20)
    kernel.launches = before  # timing launches are not the main path's
    plain_ms = graph_ms(lambda: cs_conv3x3_int8_plain(*args), 3)
    gather_ms = graph_ms(gather, 20)
    library_ms = graph_ms(lambda: torch._int_mm(cols, w), 20)
    ext, zero = ext_strips(x), torch.zeros(cout, dtype=dtype, device=dev)
    before = cs_conv3x3.launches
    conv_ms = graph_ms(lambda: cs_conv3x3(x, ext, *ks, zero, zero), 20)
    cs_conv3x3.launches = before
    nbytes = (qx.numel() + args[1].numel() + 4 * args[2].numel()
              + ours.numel() * ours.element_size())
    ops = 2 * b * 6 * n * n * 9 * cin * cout  # the selected group only
    return {
        "n": n, "cin": cin, "cout": cout, "batch": b, "dtype": str(dtype).split(".")[-1],
        "bitwise_equal": bool(torch.equal(ours, ref)),
        "max_abs_err": float((ours.float() - ref.float()).abs().max()),
        "library_bitwise_equal": bool(torch.equal(lib, ref)), "ok": bool(torch.equal(ours, ref)),
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "gather_ms": gather_ms,
        "conv_kernel_ms": conv_ms, **bound(nbytes, ops, torch.int8),
    }


def device_kernel_keys(fn):
    """The names of the device kernels that one run of ``fn`` launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA})


def quant_phase(dtype_name, rng):
    """``ForecastService(quantize=True)``: 14-day forecasts and an 8-member
    ensemble of the flagship U-Net, beside the live service of the same
    estimator, through the port's entry points."""
    from dlwp_cs_tpu_torch import ForecastService

    kernels = all_kernels()
    est = flagship_estimator(dtype_name)
    mean, std = est.stats["mean"], est.stats["std"]
    const = rng.normal(size=(6, 48, 48, 2)).astype(np.float32)
    window = (rng.normal(size=(2, 6, 48, 48, 4)) * std + mean).astype(np.float32)
    t0 = 9668.5
    live = ForecastService(est, constants=const)
    svc = ForecastService(est, constants=const, quantize=True)
    check(svc.quantized and svc.info()["quantized"] and not live.quantized, "quantized flags")

    def forecast(s):
        return s.forecast(window, t0, steps=STEPS).fields

    def ensemble(s):
        return s.forecast_ensemble(window, t0, steps=STEPS, members=ENS_MEMBERS,
                                   amplitude=0.05, generator=torch.Generator().manual_seed(0))

    for s in (svc, live):  # warm-up
        forecast(s)
        ensemble(s)
    launches = {}
    for what, fn in (("forecast", forecast), ("ensemble", ensemble)):
        for k in kernels.values():
            k.launches = 0
        fn(svc)
        launches[what] = {name: k.launches for name, k in kernels.items()}
        want = want_launches({"cs_conv3x3_int8_base": 10}, STEPS)
        check(launches[what] == want, f"quantized {what} launches {launches[what]}, want {want}")
    fc_q, again, fc = forecast(svc), forecast(svc), forecast(live)
    check(fc_q.shape == (1, 2 * STEPS, 6, 48, 48, 4) and bool(np.isfinite(fc_q).all()),
          f"quantized forecast {fc_q.shape}, finite {np.isfinite(fc_q).all()}")
    repeat = bool(np.array_equal(fc_q, again))
    check(repeat, "two quantized forecasts differ")
    err = np.abs(fc_q - fc) / std
    ens_q, ens = ensemble(svc), ensemble(live)
    check(bool(np.isfinite(ens_q.mean).all()), "non-finite quantized ensemble")
    ens_err = np.abs(ens_q.mean - ens.mean) / std
    # wall times in turns: live, quantized, quantized, live
    walls = {"forecast": {"live": [], "quantized": []}, "ensemble": {"live": [], "quantized": []}}
    for what, fn in (("forecast", forecast), ("ensemble", ensemble)):
        for name, s in (("live", live), ("quantized", svc), ("quantized", svc), ("live", live)):
            t = time.perf_counter()
            fn(s)
            walls[what][name].append((time.perf_counter() - t) * 1e3)
    profiled_run_ms(lambda: svc.forecast(window, t0, steps=2))  # tracer warm-up
    prof_ms, busy_ms, kernel_ms, n_kernels = profiled_run_ms(lambda: forecast(svc))
    idle = None if busy_ms is None else 1.0 - busy_ms / prof_ms
    if kernel_ms is not None:
        check(kernel_ms["cs_conv3x3_int8_kernel"] > 0 and not kernel_ms["cs_conv3x3_tc_kernel"],
              f"the quantized forecast's conv kernels (ms): {kernel_ms}")
    # no 3x3 conv through cuDNN or #1: no device kernel of a convolution but ours
    keys = device_kernel_keys(lambda: svc.forecast(window, t0, steps=2))
    convs = [k for k in keys if any(s in k.lower() for s in ("conv", "cudnn", "fprop"))
             and "cs_conv3x3_int8_kernel" not in k]
    check(not convs, f"the quantized forecast ran other conv kernels: {convs}")
    # the first two calls against the quantized model on the plain version
    normed = (window[None] - mean) / std
    two = svc.forecast(normed, t0, steps=2, normalized=True).fields
    with plain_convs():
        two_plain = svc.forecast(normed, t0, steps=2, normalized=True).fields
    plain_equal = bool(np.array_equal(two, two_plain))
    check(plain_equal, "the first two quantized calls differ from the plain version's: "
          f"{float(np.abs(two - two_plain).max())}")
    svc.close()
    live.close()
    return {
        "dtype": dtype_name, "launches": launches, "bitwise_repeatable": repeat,
        "first_two_calls_bitwise_equal_to_plain": plain_equal,
        "vs_live_max_err_in_std": float(err.max()),
        "vs_live_rms_err_in_std_per_variable": [float(v) for v in
                                                np.sqrt((err ** 2).mean(axis=(0, 1, 2, 3, 4)))],
        "vs_live_max_err_in_std_first_call": float(err[:, :2].max()),
        "ensemble_mean_vs_live_max_err_in_std": float(ens_err.max()),
        "forecast_ms": walls["forecast"], "ensemble_ms": walls["ensemble"],
        "forecast_ms_median": {k: statistics.median(v) for k, v in walls["forecast"].items()},
        "ensemble_ms_median": {k: statistics.median(v) for k, v in walls["ensemble"].items()},
        "profiled_forecast_ms": prof_ms, "device_busy_ms": busy_ms, "kernel_device_ms": kernel_ms,
        "device_kernels": n_kernels, "device_idle_share": idle,
    }


def quant_convlstm_phase(rng):
    """``ConvLSTMConfig(conv_backend="int8")`` in bfloat16: a 14-day forecast
    (4 launches of the int8 kernel a call), beside the ``xring`` model of the
    same seeded weights."""
    from dlwp_cs_tpu_torch import DataConfig, DLWPEstimator, ExperimentConfig, ForecastService
    from dlwp_cs_tpu_torch.models import ConvLSTMConfig

    kernels = all_kernels()
    mean = np.asarray([5500.0, 1000.0, 3500.0, 280.0], np.float32)
    std = np.asarray([300.0, 100.0, 150.0, 15.0], np.float32)
    stats = {"mean": mean, "std": std, "insol_mean": 340.0, "insol_std": 420.0}
    const = rng.normal(size=(6, 48, 48, 2)).astype(np.float32)
    window = (rng.normal(size=(2, 6, 48, 48, 4)) * std + mean).astype(np.float32)
    out = {}
    for backend in ("int8", "xring"):
        cfg = ExperimentConfig(data=DataConfig(), model=ConvLSTMConfig(
            compute_dtype="bfloat16", conv_backend=backend))
        svc = ForecastService(DLWPEstimator(cfg, device="cuda", seed=1).load_state(stats),
                              constants=const)
        svc.forecast(window, 9668.5, steps=STEPS)  # warm-up
        for k in kernels.values():
            k.launches = 0
        t = time.perf_counter()
        out[backend] = svc.forecast(window, 9668.5, steps=STEPS).fields
        out[backend + "_ms"] = (time.perf_counter() - t) * 1e3
        out[backend + "_launches"] = {name: k.launches for name, k in kernels.items()}
        svc.close()
    want = want_launches({"cs_conv3x3_int8_base": 4}, STEPS)
    check(out["int8_launches"] == want, f"int8 ConvLSTM launches {out['int8_launches']}")
    check(bool(np.isfinite(out["int8"]).all()), "non-finite quantized ConvLSTM forecast")
    err = np.abs(out["int8"] - out["xring"]) / std
    return {"launches": out["int8_launches"], "forecast_ms": out["int8_ms"],
            "xring_forecast_ms": out["xring_ms"], "vs_xring_max_err_in_std": float(err.max()),
            "vs_xring_max_err_in_std_first_call": float(err[:, :2].max())}


# the lat-lon phase: a global 1.875 degree grid (96 x 192; both sides divide
# by 4, the U-Net's two pools), the training batch of its Adam step, and the
# tolerance of each card run against its CPU run of the same weights
LATLON_GRID = (96, 192)
LATLON_BATCH = 2
LATLON_TOL = {"float32": 1e-4, "bfloat16": 2.0**-6}
# the reference registry's docstring spec at C48 with 32 features
SPEC_DOC = [("CubeSphereConv2D", (), {"features": 32}),
            ("LeakyReLU", (), {"negative_slope": 0.1}),
            ("AvgPool", (2,), {}),
            ("CubeSphereConv2D", (), {"features": 4, "kernel_size": (1, 1)})]


def latlon_phase(dtype_name):
    """``LatLonUNet(UNetConfig())`` at full width on the lat-lon grid (a
    forward and one Adam step through the port's train step),
    ``CubeSphereConvLSTM(cell_cls=LatLonConvLSTMCell)`` over 4 steps, and a
    ``SequentialSpec`` at C48 (a forward and a train step, #1/#4/#5
    counted), each timed and held against its run on the CPU with the same
    weights."""
    from dlwp_cs_tpu_torch.models import (
        CubeSphereConvLSTM,
        DataConfig,
        ExperimentConfig,
        LatLonConvLSTMCell,
        LatLonUNet,
        SequentialSpec,
        UNetConfig,
    )
    from dlwp_cs_tpu_torch.models.config import TrainConfig
    from dlwp_cs_tpu_torch.train.train_step import (
        init_state,
        make_loss_fn,
        make_optimizer,
        make_train_step,
        model_apply,
        params_of,
    )

    kernels = all_kernels()
    dtype = getattr(torch, dtype_name)
    tol = LATLON_TOL[dtype_name]
    rng = np.random.default_rng(7)
    tcfg = TrainConfig(optimizer="adam", learning_rate=1e-3, loss="mse")
    results = {}

    def held(name, build, inputs, train=False):
        """Run the model that ``build(device)`` makes on ``inputs`` on the
        card (after a warm-up; host wall, synchronised) and on the CPU; hold
        the outputs, or with ``train`` (inputs and targets) one Adam step's
        loss and gradient norm, together.  Returns the card run's launches."""
        def run(device):
            model = build(device)
            args = [torch.from_numpy(a).to(device) for a in inputs]
            if not train:
                with torch.no_grad():
                    return model(*args)
            opt = make_optimizer(tcfg)
            step = make_train_step(model_apply(model), opt, make_loss_fn(tcfg))
            state = init_state(params_of(model), opt)
            _, metrics = step(state, *args)
            return torch.stack([metrics["loss"], metrics["grad_norm"]])

        run("cuda")  # warm-up
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run("cuda")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launches = {k: v.launches for k, v in kernels.items() if v.launches}
        ref = run("cpu")
        out, ref = out.float().cpu(), ref.float()
        err, scale = float((out - ref).abs().max()), float(ref.abs().max())
        bound_ = tol * (ref.abs() if train else scale)
        check(bool(((out - ref).abs() <= bound_).all()) and bool(torch.isfinite(out).all()),
              f"latlon {name} {dtype_name}: card vs CPU {err} (of {scale}, tol {tol})")
        results[name] = {"ms": ms, "max_abs_err": err, "scale": scale, "tolerance": tol,
                         "launches": launches}
        return launches

    h, w = LATLON_GRID
    cfg = ExperimentConfig(data=DataConfig(), model=UNetConfig(compute_dtype=dtype_name))
    ucfg, cin = cfg.resolved_model(), cfg.data.input_channels
    x = rng.standard_normal((LATLON_BATCH, h, w, cin), dtype=np.float32)
    y = rng.standard_normal((LATLON_BATCH, h, w, ucfg.output_channels), dtype=np.float32)

    def unet(device):
        return LatLonUNet(ucfg, cin, device=device, generator=torch.Generator().manual_seed(0))

    held("unet_forward", unet, [x[:1]])
    held("unet_adam_step", unet, [x, y], train=True)

    xs = rng.standard_normal((1, 4, h, w, 7), dtype=np.float32)

    def lstm(device):
        layer = CubeSphereConvLSTM(7, 32, cell_cls=LatLonConvLSTMCell, return_sequences=True,
                                   dtype=dtype, generator=torch.Generator().manual_seed(1))
        return layer.to(device)

    held("convlstm_4_steps", lstm, [xs])

    spec = [(name, args, dict(kw, dtype=dtype) if name == "CubeSphereConv2D" else kw)
            for name, args, kw in SPEC_DOC]
    xc = rng.standard_normal((4, 6, 48, 48, cin), dtype=np.float32)
    yc = rng.standard_normal((4, 6, 24, 24, 4), dtype=np.float32)

    def sequential(device):
        return SequentialSpec(spec, cin, device=device, generator=torch.Generator().manual_seed(2))

    fwd = held("sequential_forward", sequential, [xc])
    step = held("sequential_train_step", sequential, [xc, yc], train=True)
    check(fwd == {"cs_conv3x3": 1} and step == {"cs_conv3x3": 1, "cs_conv3x3_dw": 1},
          f"SequentialSpec launches: forward {fwd}, train step {step}")
    return {"dtype": dtype_name, "grid": LATLON_GRID, **results}


# the barotropic baseline and the utilities


def flagship_step_setup(dtype_name, rng):
    """The flagship U-Net at the training batch on the card: ``(trainer,
    state, x, y)`` with seeded weights and a seeded normalized batch."""
    from dlwp_cs_tpu_torch.models import DataConfig, ExperimentConfig, build_model
    from dlwp_cs_tpu_torch.models.config import TrainConfig
    from dlwp_cs_tpu_torch.train import Trainer

    tcfg = TrainConfig(batch_size=TRAIN_BATCH, optimizer="adam", learning_rate=1e-3, loss="mse")
    cfg = ExperimentConfig(data=DataConfig(), model=model_config("unet", dtype_name), train=tcfg)
    d = cfg.data
    model = build_model(cfg.resolved_model(), d.input_channels, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, tcfg)
    x = rng.standard_normal((TRAIN_BATCH, 6, 48, 48, d.input_channels), dtype=np.float32)
    y = rng.standard_normal((TRAIN_BATCH, 6, 48, 48, cfg.resolved_model().output_channels),
                            dtype=np.float32)
    return trainer, trainer.init(x), torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


# the barotropic baseline: T42 and T85 on their default Gaussian grids, 14
# days of 30-minute RK4 steps, a snapshot a day
BARO_CASES = (42, 85)
BARO_DT, BARO_STEPS, BARO_SAVE = 1800.0, 672, 48
BARO_TOL = 1e-4  # the first day in f32 on the card vs f64 on the CPU, of the max |zeta|


def barotropic_phase():
    """``rossby_haurwitz_vorticity()`` integrated 14 days in float32 on the
    card at T42 and T85: the first day against the same in float64 on the
    CPU, the reference test's criteria over 14 days, the wall time and one
    profiled day."""
    from dlwp_cs_tpu_torch.barotropic import BarotropicModel, SphericalHarmonics

    out = []
    for lmax in BARO_CASES:
        model = BarotropicModel(SphericalHarmonics(lmax, device="cuda"), dt=BARO_DT)
        z0 = model.rossby_haurwitz_vorticity()
        z0_card = torch.as_tensor(z0, dtype=torch.float32, device="cuda")
        model.integrate(z0_card, 2, save_every=2)  # warm-up: tables, cuFFT plans
        torch.cuda.synchronize()
        t = time.perf_counter()
        snaps = model.integrate(z0_card, BARO_STEPS, save_every=BARO_SAVE)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
        host = BarotropicModel(SphericalHarmonics(lmax, device="cpu"), dt=BARO_DT)
        day64 = host.integrate(z0, BARO_SAVE, save_every=BARO_SAVE)[0]
        scale = float(day64.abs().max())
        err = float((snaps[0].cpu().double() - day64).abs().max()) / scale
        check(err <= BARO_TOL, f"T{lmax} day 1 f32 on the card vs f64: {err} of the max")
        final = snaps[-1].cpu().double().numpy()
        corr = float(np.corrcoef(final.ravel(), z0.ravel())[0, 1])
        amp = float(np.abs(final).max() / np.abs(z0).max())
        check(snaps.shape == (BARO_STEPS // BARO_SAVE, model.sht.nlat, model.sht.nlon)
              and bool(torch.isfinite(snaps).all()) and amp < 5 and corr > 0.5,
              f"T{lmax} 14 days: shape {tuple(snaps.shape)}, max |zeta| {amp} x the "
              f"initial, correlation with t0 {corr}")
        profiled_run_ms(lambda: model.integrate(z0_card, 2, save_every=2))  # tracer warm-up
        prof_ms, busy_ms, _, n_kernels = profiled_run_ms(
            lambda: model.integrate(z0_card, BARO_SAVE, save_every=BARO_SAVE))
        out.append({
            "lmax": lmax, "grid": [model.sht.nlat, model.sht.nlon], "steps": BARO_STEPS,
            "dt_s": BARO_DT, "wall_s": wall_s, "steps_per_s": BARO_STEPS / wall_s,
            "day1_vs_f64_rel_err": err, "tolerance": BARO_TOL,
            "final_max_over_initial": amp, "final_corr_with_t0": corr,
            "profiled_day_ms": prof_ms, "device_busy_ms": busy_ms,
            "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / prof_ms,
            "device_kernels_per_day": n_kernels,
        })
    return out


def utils_phase(out_dir, rng):
    """``utils.trace`` around one bf16 train step of the flagship U-Net (the
    trace must name #1, #4 and #5), ``Timer.time_fn`` of a model call,
    ``conv_roofline`` beside ``tools/timing.py::bound`` at the U-Net's conv
    shapes, and each plot drawn to a PNG where matplotlib imports."""
    from dlwp_cs_tpu_torch import plot
    from dlwp_cs_tpu_torch.tools.timing import bound
    from dlwp_cs_tpu_torch.utils import Timer, conv_roofline, trace

    from dlwp_cs_tpu_torch.train import History

    trainer, state, xb, yb = flagship_step_setup("bfloat16", rng)
    state, m0 = trainer.train_step(state, xb, yb)  # warm-up
    torch.cuda.synchronize()
    with trace(os.path.join(out_dir, "trace")) as path:
        state, m1 = trainer.train_step(state, xb, yb)
        torch.cuda.synchronize()
    losses = [float(m0["loss"]), float(m1["loss"])]
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    named = {k: any(k in name for name in names)
             for k in ("cs_conv3x3_tc_kernel", "cs_conv3x3_dx_tc_kernel",
                       "cs_conv3x3_dw_tc_kernel")}
    check(all(named.values()), f"the trace of a bf16 step names {named}")
    x1 = xb[:1]
    with torch.no_grad():
        call_s = Timer.time_fn(lambda: trainer.model(x1), iters=20, warmup=3)
    roof = []
    for n, cin, cout in sorted(set(FLAGSHIP_CONVS), key=FLAGSHIP_CONVS.index):
        r = conv_roofline(batch=1, n=n, cin=cin, cout=cout, dtype_bytes=2)
        # tools/timing.py counts #1's own reads: x, its ghost strips, both
        # weight groups and biases, the output
        nbytes = 2 * (6 * n * n * cin + 6 * 4 * (n + 2) * cin + 2 * 9 * cin * cout + 2 * cout
                      + 6 * n * n * cout)
        b = bound(nbytes, 2 * 6 * n * n * 9 * cin * cout, torch.bfloat16)
        roof.append({"n": n, "cin": cin, "cout": cout, "roofline_ms": r["t_light_s"] * 1e3,
                     "roofline_bound": r["bound"], "timing_bound_ms": b["bound_ms"],
                     "timing_bound_by": b["bound_by"]})
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        matplotlib = None
    pngs = []
    if matplotlib is None:
        try:
            plot.plot_cube_faces(np.zeros((6, 4, 4)))
        except ImportError as e:
            check("matplotlib" in str(e), f"plot's ImportError does not name matplotlib: {e}")
            plots = f"no matplotlib: {e}"
        else:
            raise RuntimeError("plot_cube_faces ran without matplotlib")
    else:
        import matplotlib.pyplot as plt

        with torch.no_grad():
            field = trainer.model(x1)[0, ..., 0].float()
        lats, lons = np.linspace(-89.0, 89.0, 90), np.arange(0.0, 360.0, 2.0)
        lead = np.arange(1, 29) * 12.0
        figs = {
            "cube_faces": lambda p: plot.plot_cube_faces(field, title="U-Net call", out_path=p),
            "latlon_map": lambda p: plot.plot_latlon_map(
                np.cos(np.radians(lats))[:, None] * np.sin(np.radians(lons))[None, :], lats,
                lons, projection="mollweide", out_path=p),
            "error_curves": lambda p: plot.plot_error_curves(
                lead, {"model": np.sqrt(lead)}, out_path=p),
            "history": lambda p: plot.plot_history(History(epochs=[
                {"epoch": i, "train_loss": v} for i, v in enumerate(losses)]), out_path=p),
            "rank_histogram": lambda p: plot.plot_rank_histogram(
                rng.integers(5, 15, size=9), out_path=p),
            "spread_error": lambda p: plot.plot_spread_error(
                lead, np.sqrt(lead), 0.9 * np.sqrt(lead), members=8, out_path=p),
        }
        for name, draw in figs.items():
            p = os.path.join(out_dir, f"plot_{name}.png")
            plt.close(draw(p))
            check(os.path.getsize(p) > 1000, f"{p} is empty")
            pngs.append(p)
        plots = f"{len(pngs)} PNGs"
    return {"trace": os.path.basename(path), "trace_names": named,
            "model_call_ms": call_s * 1e3, "roofline": roof, "plots": plots, "pngs": pngs}


# the examples phase: the seven example workflows (dlwp_cs_tpu_torch.examples)
# chained at full width: the flagship C48 U-Net (filters 32/64/128, bf16
# compute, f32 parameters) trained, forecast, scored, fine-tuned, served,
# run as an ensemble and exported, from a store built on a 1 degree grid
EX_EPOCHS = 2
EX_SEQ = dict(sequence=3, batch=8, filters=(32, 64, 128), steps=2)  # f32, as the reference
EX_SEQ_TIMES = 64  # 05 runs on the store's first 64 times: the ranks get a 14 MB store
EX_MESH = (2, 2)  # data x spatial: 4 ranks sharing the card
EX_MESH_TOL = 1e-4  # per-step loss, relative: tests/test_torch_parallel_train.py's f32
EX_LEAD_DAYS = (1, 3, 5, 14)
EX_PHASE_S = 120.0


def _examples():
    return {name[:2]: importlib.import_module(f"dlwp_cs_tpu_torch.examples.{name}")
            for name in ("01_build_dataset", "02_train", "03_forecast", "04_evaluate",
                         "05_sequence_train", "06_serve", "07_ensemble_export")}


def examples_head(store):
    """05's store: the first ``EX_SEQ_TIMES`` times of ``store`` (each mesh
    rank gets its own copy)."""
    return dataclasses.replace(store, fields=store.fields[:EX_SEQ_TIMES],
                               times=store.times[:EX_SEQ_TIMES])


def examples_mesh_rank(store, kwargs):
    """One rank of ``05_sequence_train --mesh 2x2``, run by the mesh-train
    group's ranks: the example's own rank function with the launch counts
    set to 0 before and read after."""
    kernels = all_kernels()
    for k in kernels.values():
        k.launches = 0
    calls = collective_counts()
    t = time.perf_counter()
    losses = _examples()["05"].mesh_rank(store, *EX_MESH, kwargs)["losses"]
    torch.cuda.synchronize()
    return {"losses": losses, "seconds": time.perf_counter() - t,
            "launches": {name: k.launches for name, k in kernels.items()},
            "collectives": collective_delta(calls)}


def examples_phase(workdir, out_dir, store, data, mesh05):
    """The examples' functions chained in one process on the card, each with
    every launch count set to 0 before it and read after, from ``store``:
    the C48 store that 01's ``build_store`` made in the data phase (exact
    conservative weights; ``data``: that phase's readings).  02 trains the
    bf16 U-Net and the f32 ConvLSTM, 03 forecasts 14 days from 4 inits, 04
    scores them (the plots where matplotlib imports, else their
    ImportError), 05 fine-tunes on one card, held against ``mesh05``: each
    rank's result of ``--mesh 2x2`` in the mesh-train group (4 ranks
    sharing the card, on the same head of the store), 06 serves the self-test live and from 07's
    artifact, 07 runs the 8-member ensemble and the export round trip."""
    from dlwp_cs_tpu_torch.data import SeriesDataset
    from dlwp_cs_tpu_torch.estimator import DLWPEstimator
    from dlwp_cs_tpu_torch.geometry import CubedSphere
    from dlwp_cs_tpu_torch.serve import ForecastService

    ex = _examples()
    kernels = all_kernels()
    names = list(kernels)
    t_phase = time.perf_counter()
    out, logs = {}, []

    def log(*a):
        logs.append(" ".join(str(v) for v in a))

    def run(key, fn, want=None):
        """``fn()`` with the counts set to 0 before and read after; its wall
        seconds and launches under ``key``; ``want``: the exact launches
        (kernels not named: 0)."""
        for k in kernels.values():
            k.launches = 0
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        launches = {name: k.launches for name, k in kernels.items()}
        out[key] = {"seconds": time.perf_counter() - t,
                    "launches": {k: v for k, v in launches.items() if v}}
        if want is not None:
            full = {name: want.get(name, 0) for name in names}
            check(launches == full, f"examples {key}: launches {out[key]['launches']}, "
                  f"want {want}")
        return result

    out["store_route"] = (f"the data phase's store, {data['store_branch']}; its MemoryStore "
                          "handed to each step in this process")
    print(f"examples: store route {out['store_route']}", flush=True)

    # 01: the data phase's first build_store run, launch counts zeroed before
    # it and checked after (none)
    out["01"] = {"seconds": data["preprocessor_seconds"][0], "launches": {}}
    out["store_shape"] = list(store.fields.shape)

    # 02: the flagship U-Net, bf16, then the ConvLSTM (its default conv backend)
    lat, lon = CubedSphere(48).cell_latlon
    val_frac = 0.15

    def trained(key, cfg, per_step, per_call):
        """``ex02.train`` of ``cfg`` and the model it saves; the launches
        are ``per_step`` a train step and ``per_call`` a validation call."""
        wd = os.path.join(workdir, key)
        result = {}

        def fit():
            trainer, state, stats = ex["02"].train(store, cfg, workdir=wd, val_frac=val_frac,
                                                   device="cuda", verbose=False)
            result.update(trainer=trainer, state=state, stats=stats)
            return ex["02"].save_model(os.path.join(wd, "model"), state, cfg, stats)

        n_val = len(SeriesDataset(ex["02"].chronological_split(store, val_frac)[1], cfg.data,
                                  lat=lat, lon=lon, batch_size=cfg.train.batch_size))
        model_dir = run(key, fit)  # launches checked below, once the step count is known
        trainer = result["trainer"]
        steps, epochs = len(trainer.history.steps), len(trainer.history.epochs)
        expect = {k: v * steps for k, v in per_step.items()}
        expect["cs_conv3x3"] += per_call * epochs * n_val
        got = out[key]["launches"]
        check(got == {k: v for k, v in expect.items() if v},
              f"examples {key}: launches {got}, want {expect}")
        losses = [r["loss"] for r in trainer.history.steps]
        check(steps > 0 and all(np.isfinite(losses)), f"examples {key}: losses {losses}")
        step_ms = [r["step_s"] * 1e3 for r in trainer.history.steps]
        out[key].update(steps=steps, epochs=epochs, val_batches_per_epoch=n_val,
                        step_ms_median=statistics.median(step_ms),
                        epoch_losses=[(r["train_loss"], r["val_loss"])
                                      for r in trainer.history.epochs],
                        model_dir=str(model_dir))
        return model_dir

    unet_cfg = ex["02"].experiment_config(store, filters=(32, 64, 128), batch=TRAIN_BATCH,
                                          bf16=True, epochs=EX_EPOCHS)
    model_dir = trained("02", unet_cfg, PER_STEP["unet"], PER_CALL["unet"]["cs_conv3x3"])
    lstm_cfg = ex["02"].experiment_config(store, model="convlstm", filters=(32, 32),
                                          batch=TRAIN_BATCH, epochs=1)
    # under the default backend the ConvLSTM's 3x3 gate convs run the fused
    # kernels: 4 forward, 4 dw and 3 dx a step (the first layer's first
    # input is data with a zero state)
    trained("02 convlstm", lstm_cfg, {"cs_conv3x3": 4, "cs_conv3x3_dw": 4, "cs_conv3x3_dx": 3},
            4)

    # 03: 14 days from the 4 last verifiable inits, one rollout at batch 4
    est = DLWPEstimator.load(model_dir, device="cuda")
    calls = int(round(14 * 24 / (est.config.data.step_hours * est.config.data.output_time_steps)))
    fc = run("03", lambda: ex["03"].forecast_from_tail(est, store, days=14, inits=4),
             {"cs_conv3x3": PER_CALL["unet"]["cs_conv3x3"] * calls})
    check(fc["fields"].shape == (4, 2 * calls, 6, 48, 48, 4)
          and bool(np.isfinite(fc["fields"]).all()), f"03 fields {fc['fields'].shape}")
    out["03"]["fields_shape"] = list(fc["fields"].shape)

    # 04: the scores; the plots where matplotlib imports
    scores = run("04", lambda: ex["04"].score(fc["fields"], fc["lead_hours"],
                                               fc["init_times"], store), {})
    for k in ("rmse", "persistence", "climatology", "acc"):
        check(bool(np.isfinite(scores[k]).all()), f"04 {k} not finite")
    leads = list(scores["lead_hours"])
    out["04"]["at_days"] = {
        var: {d: {k: float(scores[k][leads.index(24.0 * d), vi])
                  for k in ("rmse", "persistence", "climatology", "acc")}
              for d in EX_LEAD_DAYS}
        for vi, var in enumerate(store.variables)}
    out["04"]["table_z500"] = ex["04"].format_table(scores, 0)
    try:
        ex["04"].plot_scores(scores, list(store.variables), 0, out_dir)
        out["04"]["plots"] = "rmse_curves.png, forecast_map.png"
    except ImportError as e:  # the card machine has no matplotlib
        check(importlib.util.find_spec("matplotlib") is None and "matplotlib" in str(e),
              f"04's plots raised {e!r}")
        out["04"]["plots"] = f"no matplotlib: ImportError: {e}"

    # 05: sequence fine-tuning (f32, as the reference) on one card, against
    # the mesh-train group's 2 x 2 run on the same head of the store
    head = examples_head(store)
    per_app = PER_STEP["unet"]
    seq, n_steps = EX_SEQ["sequence"], EX_SEQ["steps"]
    one = run("05", lambda: ex["05"].sequence_train(head, device="cuda", log=log, **EX_SEQ),
              {"cs_conv3x3": per_app["cs_conv3x3"] * seq * n_steps,
               "cs_conv3x3_dw": per_app["cs_conv3x3_dw"] * seq * n_steps,
               # every application after the first takes an input that
               # carries a gradient: its first conv runs dx too
               "cs_conv3x3_dx": (per_app["cs_conv3x3_dx"] * seq + seq - 1) * n_steps})
    one_losses = one["losses"]
    check(len(one_losses) == n_steps and all(np.isfinite(one_losses)),
          f"05 losses {one_losses}")
    out["05"]["losses"] = one_losses
    errs = []
    for rank, r in enumerate(mesh05):
        check(not any(r["launches"].values()),
              f"05 --mesh rank {rank} launched {r['launches']} (the band ring-fix conv)")
        co = r["collectives"]
        check(co["host_calls"] == 0 and co["device_calls"] > 0,
              f"05 --mesh rank {rank}: collectives {co}")
        err = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], one_losses))
        errs.append(err)
        check(len(r["losses"]) == n_steps and err <= EX_MESH_TOL,
              f"05 --mesh rank {rank}: losses {r['losses']} vs one card {one_losses}")
    out["05 --mesh"] = {"seconds": max(r["seconds"] for r in mesh05), "launches": {},
                        "losses_rank0": mesh05[0]["losses"], "rel_err_per_rank": errs,
                        "tolerance": EX_MESH_TOL,
                        "rank_seconds": [r["seconds"] for r in mesh05],
                        "collectives_per_rank": [r["collectives"] for r in mesh05]}

    # 06 live, 07, then 06 from 07's artifact
    def selftest(make, steps):
        svc = make()
        try:
            got = ex["06"].selftest(svc, store, steps=steps, log=log)
        finally:
            svc.close()
        check(got["ok"] and len(got["results"]) == 3, "06 selftest failed")
        for fields, lead, _ in got["results"].values():
            check(fields.shape == (1, 2 * steps, 6, 48, 48, 4), f"06 fields {fields.shape}")
        st = got["stats"]
        return {"requests": st.requests, "batches": st.batches, "mean_batch": st.mean_batch,
                "device_seconds": st.device_seconds}

    live = run("06", lambda: selftest(lambda: ex["06"].live_service(est, store), STEPS))
    check(out["06"]["launches"] == {"cs_conv3x3": PER_CALL["unet"]["cs_conv3x3"] * STEPS
                                    * live["batches"]}, f"06 launches {out['06']['launches']}")
    out["06"]["stats"] = live
    svc = ForecastService(est, constants_store=store)
    ens = run("07", lambda: ex["07"].ensemble_scores(svc, store, steps=STEPS, members=ENS_MEMBERS,
                                                     seed=0, device="cuda", log=log),
              {"cs_conv3x3": PER_CALL["unet"]["cs_conv3x3"] * STEPS})
    check(bool(np.isfinite(ens["ensemble"].mean).all())
          and all(bool(np.isfinite(ens[k]).all()) for k in ("crps", "rmse", "spread")),
          "07 ensemble not finite")
    lead = list(ens["lead_hours"])
    out["07"]["at_days"] = {d: {k: float(ens[k][lead.index(24.0 * d)])
                                for k in ("crps", "rmse", "spread")} for d in EX_LEAD_DAYS}
    artifact = os.path.join(workdir, "rollout_artifact")
    trip = run("07 export", lambda: ex["07"].export_round_trip(
        est, svc, store, artifact, steps=STEPS, window=ens["window"], t0=ens["t0"], log=log))
    svc.close()
    check(trip["maxdiff"] == 0.0, f"07 exported vs live maxdiff {trip['maxdiff']} (want 0)")
    check(set(out["07 export"]["launches"]) == {"cs_conv3x3"},
          f"07 export launches {out['07 export']['launches']}")
    out["07 export"].update(maxdiff=trip["maxdiff"], size_kib=trip["size_kib"])
    art = run("06 --artifact", lambda: selftest(
        lambda: ex["06"].artifact_service(artifact, device="cuda"), STEPS))
    check(set(out["06 --artifact"]["launches"]) == {"cs_conv3x3"},
          f"06 --artifact launches {out['06 --artifact']['launches']}")
    out["06 --artifact"]["stats"] = art
    # reported against its budget, not checked: the wall clock moves with the
    # host, not with the port
    out["phase_seconds"] = time.perf_counter() - t_phase
    out["log"] = logs
    return out


def examples_lines(r):
    """The examples phase's summary lines."""
    def launches(key):
        return r[key]["launches"] or "none"

    lines = [f"examples 01: {r['01']['seconds']:.1f} s (the data phase's build_store); store "
             f"{r['store_shape']} ({r['store_route']}); launches {launches('01')}"]
    for key, what in (("02", "unet bfloat16"), ("02 convlstm", "convlstm float32")):
        e = r[key]
        lines.append(f"examples {key} ({what}): {e['seconds']:.1f} s; {e['steps']} steps over "
                     f"{e['epochs']} epochs ({e['val_batches_per_epoch']} validation batches an "
                     f"epoch), step {e['step_ms_median']:.2f} ms median; epoch losses "
                     f"{e['epoch_losses']}; launches {launches(key)}")
    lines.append(f"examples 03: {r['03']['seconds']:.2f} s; fields {r['03']['fields_shape']}; "
                 f"launches {launches('03')}")
    z = r["04"]["at_days"]["z500"]
    lines.append(f"examples 04: {r['04']['seconds']:.2f} s; z500 RMSE (persistence, "
                 "climatology), ACC: " + "; ".join(
                     f"day {d} {v['rmse']:.2f} ({v['persistence']:.2f}, {v['climatology']:.2f}), "
                     f"{v['acc']:.3f}" for d, v in z.items())
                 + f"; plots {r['04']['plots']}; launches {launches('04')}")
    m = r["05 --mesh"]
    lines.append(f"examples 05: one card {r['05']['seconds']:.1f} s, losses "
                 f"{['%.6f' % v for v in r['05']['losses']]}, launches {launches('05')}; --mesh "
                 f"{EX_MESH[0]}x{EX_MESH[1]} (the mesh-train group's 4 ranks sharing the card) "
                 f"{m['seconds']:.1f} s in the ranks, "
                 f"losses {['%.6f' % v for v in m['losses_rank0']]}, vs one card "
                 f"{max(m['rel_err_per_rank']):.3g} relative (tol {m['tolerance']:.0e}), "
                 f"launches none; collectives rank 0 device {m['collectives_per_rank'][0]['device_calls']}"
                 f", host {m['collectives_per_rank'][0]['host_calls']}")
    for key in ("06", "06 --artifact"):
        st = r[key]["stats"]
        lines.append(f"examples {key}: {r[key]['seconds']:.2f} s; requests {st['requests']}, "
                     f"batches {st['batches']}, mean batch {st['mean_batch']:.2f}, device "
                     f"{st['device_seconds']:.3f} s; launches {launches(key)}")
    lines.append(f"examples 07: {r['07']['seconds']:.2f} s; {ENS_MEMBERS} members x {STEPS} "
                 "calls; CRPS, RMSE of the mean, spread: " + "; ".join(
                     f"day {d} {v['crps']:.3f}, {v['rmse']:.3f}, {v['spread']:.3f}"
                     for d, v in r["07"]["at_days"].items()) + f"; launches {launches('07')}; "
                 f"export round trip {r['07 export']['seconds']:.2f} s, exported vs live maxdiff "
                 f"{r['07 export']['maxdiff']:.3g}, {r['07 export']['size_kib']:.0f} KiB, "
                 f"launches {launches('07 export')}")
    lines.append(f"examples phase: {r['phase_seconds']:.1f} s (budget {EX_PHASE_S:.0f}, "
                 f"{'within' if r['phase_seconds'] <= EX_PHASE_S else 'OVER'}; 01's build "
                 "timed in the data phase)")
    return lines



# the measurement tools' phase: the forward kernel with its weights streamed
# with each chunk (#1 under fwd_plan(..., stream=True)) at the capacity
# sweep's shapes whose resident plan refuses in bfloat16 and at the
# flagship's conv shapes, then the five tools' mains (the reference's
# tools/capacity_bench, trainer_wallclock, serve_bench, ensemble_bench and
# scaling_bench) at full width with their repeats and steps cut
STREAM_REFUSED = [(12, 512, 512), (24, 768, 256), (24, 512, 256)]  # (n, Cin, Cout), batch 8
BENCH_RUNS = (("capacity_bench", ["--repeats", "2"]),
              ("trainer_wallclock", ["--steps", "32", "--epochs", "3"]),
              ("serve_bench", ["--repeats", "2", "--calls", "1"]),
              ("ensemble_bench", ["--repeats", "2"]),
              ("scaling_bench", ["--configs", "1x1,4x1,2x2", "--iters", "2"]))
# the int8 rollout against the auto one of the same window, in standard
# deviations of the fields: the quant phase measures 0.030-0.032 over 14
# days on an H100; a wrong scale or a dropped ring term gives O(1)
QUANT_TOL_STD = 0.1


def forced_forward(x, ext, k_eq, k_pole, b_eq, b_pole, stream):
    """#1 under the plan of the weight mode ``stream`` (streamed or
    resident), whatever the paths would choose, launched through its entry
    point as ``tools/tc_sweep.py`` launches a plan of its choosing; raises
    ``ValueError`` where that mode has no plan."""
    from dlwp_cs_tpu_torch.ops.cuda_build import DTYPES
    from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3, fwd_plan

    b, _, n, _, cin = x.shape
    cout = k_eq.shape[-1]
    dev = cs_conv3x3._device(x)
    plan = fwd_plan(x.dtype, b, n, n, cin, cout, cs_conv3x3._sm_count[dev], stream=stream)
    out = torch.empty((b, 6, n, n, cout), dtype=x.dtype, device=x.device)
    cs_conv3x3._launch("cs_conv3x3_launch", dev, DTYPES[x.dtype], dev,
                       *(t.data_ptr() for t in (x, ext, k_eq, k_pole, b_eq, b_pole, out)),
                       b, n, n, cin, cout, *plan.args(), int(stream), sizes=11)
    return out


def streamed_case(n, cin, cout, b, dtype, gen):
    """#1 with streamed weights at one shape (:func:`forced_forward`):
    against its plain version, bitwise against the resident mode where
    that plans (``resident_ms`` then its time) and against the wrapper's
    own plan, and timed beside the plain version, the face-grouped cuDNN
    call and the bound, as :func:`conv_case`."""
    from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3, cs_conv3x3_plain, fwd_plan
    from dlwp_cs_tpu_torch.ops.padding import cs_pad
    from dlwp_cs_tpu_torch.tools.timing import bf16_excess, bound, face_grouped, graph_ms

    x, ext, ks, bs = conv_inputs(n, cin, cout, b, dtype, gen)
    args = (x, ext, *ks, *bs)
    before = cs_conv3x3.launches, cs_conv3x3.stream_launches.copy()
    ours = forced_forward(*args, True)
    ref = cs_conv3x3_plain(*args)
    torch.cuda.synchronize()
    err = float((ours.float() - ref.float()).abs().max())
    ok = err <= 1e-4 if dtype == torch.float32 else bf16_excess(ours, ref) <= 1e-4
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    auto = fwd_plan(dtype, b, n, n, cin, cout, sms)
    try:
        resident = forced_forward(*args, False)
    except ValueError:  # its plan refuses: the paths stream
        resident = None
        ok = ok and auto.geom.stream
    else:
        ok = ok and not auto.geom.stream
    equal = None if resident is None else bool(torch.equal(resident, ours))
    ok = (ok and equal is not False and bool(torch.equal(forced_forward(*args, True), ours))
          and bool(torch.equal(cs_conv3x3(*args), ours)))
    p, w = face_grouped(cs_pad(x, 1), ks)
    bias = torch.cat([bs[0]] * 4 + [bs[1]] * 2)
    ms = graph_ms(lambda: forced_forward(*args, True), 20)
    resident_ms = None if resident is None else graph_ms(
        lambda: forced_forward(*args, False), 20)
    # comparison launches are not a path's
    cs_conv3x3.launches, cs_conv3x3.stream_launches = before
    nbytes = x.element_size() * (x.numel() + ext.numel() + 2 * ks[0].numel() + 2 * cout
                                 + b * 6 * n * n * cout)
    return {
        "n": n, "cin": cin, "cout": cout, "batch": b, "dtype": str(dtype).split(".")[-1],
        "max_abs_err": err, "tolerance": "1e-4 abs" if dtype == torch.float32
        else "2**-7*|ref| + 1e-4", "ok": ok, "plan": list(fwd_plan(
            dtype, b, n, n, cin, cout, sms, stream=True).args()),
        "paths_stream": auto.geom.stream, "bitwise_equal_to_resident": equal,
        "ms": ms, "resident_ms": resident_ms,
        "plain_ms": graph_ms(lambda: cs_conv3x3_plain(*args), 3),
        "library_ms": graph_ms(lambda: F.conv2d(p, w, bias, groups=6), 20),
        **bound(nbytes, 2 * b * 6 * n * n * 9 * cin * cout, dtype),
    }


def bench_tools_phase(gen):
    """#1's streamed weights (:func:`streamed_case`: the three refused
    bfloat16 shapes at batch 8, and in float32; the flagship's 8 conv shapes
    at batch 1 and 16 in bfloat16, at batch 1 in float32), then each tool's
    ``main`` as ``python -m dlwp_cs_tpu_torch.tools.<name>`` runs it (every
    count set to 0 before and read after), the trainer's store path on a
    ``MemoryStore`` of the CLI's size (this machine has no h5py), and the
    checks: no capacity configuration leaves the kernels and #1 launches
    once a 3x3 conv, the folded ensemble's member 0 equals the batch-1
    rollout, the int8 rollout stays within ``QUANT_TOL_STD`` of ``auto``,
    and each tool launched its kernels."""
    from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3, fwd_plan
    from dlwp_cs_tpu_torch.tools import trainer_wallclock
    from dlwp_cs_tpu_torch.tools.capacity_bench import unet_convs

    kernels = all_kernels()
    flagship = sorted(set(FLAGSHIP_CONVS), key=FLAGSHIP_CONVS.index)
    shapes = ([(n, ci, co, 8, d) for d in (torch.bfloat16, torch.float32)
               for n, ci, co in STREAM_REFUSED]
              + [(n, ci, co, b, torch.bfloat16) for b in (1, TRAIN_BATCH)
                 for n, ci, co in flagship]
              + [(n, ci, co, 1, torch.float32) for n, ci, co in flagship])
    streamed = [streamed_case(n, ci, co, b, d, gen) for n, ci, co, b, d in shapes]
    bad = [c for c in streamed if not c["ok"]]
    check(not bad, f"the streamed forward disagrees with its plain version or the resident "
          f"mode, or the paths' plan streams where the resident one plans: {bad}")
    refused = [c for c in streamed if c["dtype"] == "bfloat16" and c["batch"] == 8]
    check(all(c["paths_stream"] for c in refused),
          f"a refused bf16 shape has a resident plan: {refused}")

    rows, launches, seconds, stream_launches = {}, {}, {}, {}
    for name, argv in BENCH_RUNS:
        print(f"$ python -m dlwp_cs_tpu_torch.tools.{name} {' '.join(argv)}", flush=True)
        mod = importlib.import_module(f"dlwp_cs_tpu_torch.tools.{name}")
        for k in kernels.values():
            k.launches = 0
        cs_conv3x3.stream_launches.clear()
        t = time.perf_counter()
        rows[name] = out = []
        check(mod.main(argv, out) == 0, f"tools.{name} returned non-zero")
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        launches[name] = {k: v.launches for k, v in kernels.items() if v.launches}
        stream_launches[name] = cs_conv3x3.stream_launches.copy()
    # the store path: SeriesDataset -> prefetch_to_device -> Trainer.fit
    for k in kernels.values():
        k.launches = 0
    cs_conv3x3.stream_launches.clear()
    t = time.perf_counter()
    store = trainer_wallclock.synthetic_store(48, 32 * TRAIN_BATCH + 8)
    rows["trainer_wallclock --store"] = [trainer_wallclock.wallclock(
        steps=32, epochs=3, store=store, workers=6, device=torch.device("cuda"))]
    seconds["trainer_wallclock --store"] = time.perf_counter() - t
    launches["trainer_wallclock --store"] = {k: v.launches for k, v in kernels.items()
                                             if v.launches}
    stream_launches["trainer_wallclock --store"] = cs_conv3x3.stream_launches.copy()

    cap = rows["capacity_bench"]
    check(len(cap) == 6, f"capacity configurations measured: {[r['label'] for r in cap]}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    run_want = collections.Counter()  # streamed launches the capacity run should make
    for r in cap:
        lw = r["launches"]
        check(r["fallback"] == [] and lw["cs_conv3x3"] == r["conv3x3"]
              and lw["cs_conv3x3_dx"] == r["conv3x3"] - 1 and lw["cs_conv3x3_dw"] == r["conv3x3"],
              f"capacity {r['label']}: fallback {r['fallback']}, launches a step {lw} for "
              f"{r['conv3x3']} 3x3 convs")
        # a step's streamed launches: one a conv whose resident plan refuses
        want = collections.Counter(
            (n, n, ci, co) for n, ci, co in unet_convs(r["n"], r["filters"], 12)
            if fwd_plan(torch.bfloat16, r["batch"], n, n, ci, co, sms).geom.stream)
        got = collections.Counter({(s["n"], s["n"], s["cin"], s["cout"]): s["launches"]
                                   for s in r["streamed"]})
        check(got == want, f"capacity {r['label']}: streamed launches a step {dict(got)}, "
              f"want {dict(want)}")
        run_want.update({k: v * r["steps_run"] for k, v in want.items()})
    check({(n, ci, co) for n, _, ci, co in run_want} == set(STREAM_REFUSED),
          f"the capacity sweep streams at {sorted(run_want)}, want {STREAM_REFUSED}")
    check(stream_launches["capacity_bench"] == run_want,
          f"streamed launches in the capacity run {dict(stream_launches['capacity_bench'])}, "
          f"want {dict(run_want)}")
    for key in ("trainer_wallclock", "trainer_wallclock --store"):
        (r,) = rows[key]
        check(all(np.isfinite(r["losses"])) and r["steady_ms"] > 0, f"{key}: {r}")
        lw = launches[key]
        n_steps = r["epochs"] * r["steps"]  # 10 forward, 9 dx and 10 dw launches a step
        want = {"cs_conv3x3": 10 * n_steps, "cs_conv3x3_dx": 9 * n_steps,
                "cs_conv3x3_dw": 10 * n_steps}
        check(lw == want, f"{key} launches {lw}, want {want}")
    steps = STEPS
    for r in rows["serve_bench"]:
        lw = r["launches"]
        want = ({"cs_conv3x3": 10 * steps, "cs_conv3x3_int8_base": 0} if r["backend"] == "auto"
                else {"cs_conv3x3": 0, "cs_conv3x3_int8_base": 10 * steps})
        check(lw == want, f"serve {r['backend']} b={r['batch']} launches {lw}, want {want}")
        if r["backend"] == "int8":
            check(r["max_err_vs_auto_in_std"] <= QUANT_TOL_STD,
                  f"int8 rollout b={r['batch']}: {r['max_err_vs_auto_in_std']} std from auto "
                  f"> {QUANT_TOL_STD}")
    for r in rows["ensemble_bench"][1:]:
        check(r["member0_bitwise_equal_to_rollout"] and r["launches"]["cs_conv3x3"] == 10 * steps,
              f"ensemble {r['what']}: member 0 bitwise {r['member0_bitwise_equal_to_rollout']}, "
              f"launches {r['launches']}")
    sc = rows["scaling_bench"]
    check([tuple(r["mesh_shape"]) for r in sc] == [(1, 1), (4, 1), (2, 2)]
          and all(r["step_seconds"] > 0 for r in sc)
          and [r["ranks_share_one_card"] for r in sc] == [False, True, True],
          f"scaling rows {sc}")
    check(launches["scaling_bench"].get("cs_conv3x3", 0) > 0,
          f"scaling 1x1 launches {launches['scaling_bench']}")
    check(all(r["host_collectives"] == 0 and r["device_collectives"] > 0 for r in sc[1:]),
          f"scaling rows' collectives {[(r['device_collectives'], r['host_collectives']) for r in sc]}")
    check(not any(stream_launches[k] for k in stream_launches if k != "capacity_bench"),
          f"a tool other than the capacity sweep streamed: {stream_launches}")
    return {"streamed": streamed, "rows": rows, "launches": launches, "seconds": seconds,
            "stream_launches": {k: [{"n": s[0], "cin": s[2], "cout": s[3], "launches": c}
                                    for s, c in sorted(v.items())]
                                for k, v in stream_launches.items()},
            "quant_tolerance_in_std": QUANT_TOL_STD}


def bench_tools_lines(r):
    """The phase's lines for the end of the output."""
    def counts(entries):
        return [(e["n"], e["cin"], e["cout"], e["launches"]) for e in entries]

    lines = []
    for c in r["streamed"]:
        res = ("resident refuses" if c["resident_ms"] is None else
               f"resident {c['resident_ms']:.4f} ms, bitwise {c['bitwise_equal_to_resident']}")
        lines.append(f"#1 streamed {c['n']} {c['cin']} {c['cout']} b{c['batch']} {c['dtype']} "
                     f"plan {c['plan']}: {c['ms']:.4f} ms ({res}); plain {c['plain_ms']:.4f}, "
                     f"cuDNN {c['library_ms']:.4f}, bound {c['bound_ms']:.5f} "
                     f"({c['bound_by']}); vs plain {c['max_abs_err']:.3g}")
    for c in r["rows"]["capacity_bench"]:
        lines.append(f"capacity {c['label']}: step {c['step_ms']:.2f} ms (spread "
                     f"{c['spread_ms']:.2f}), {c['gridpoints_per_s'] / 1e6:.2f} M gp/s, "
                     f"{c['tflops_per_s']:.2f} TFLOP/s, {c['pct_of_bf16_peak']:.2f} % of peak; "
                     f"launches a step {c['launches']}, streamed {counts(c['streamed'])}, "
                     f"steps run {c['steps_run']}; fallback {c['fallback']}")
    lines.append("streamed launches (n, Cin, Cout, launches) in the capacity run: "
                 f"{counts(r['stream_launches']['capacity_bench'])}")
    for key in ("trainer_wallclock", "trainer_wallclock --store"):
        (c,) = r["rows"][key]
        lines.append(f"{key}: {c['steps']} steps an epoch, ms a step per epoch "
                     f"{['%.2f' % v for v in c['per_step_ms']]}, steady {c['steady_ms']:.2f}; "
                     f"mean dispatch {c['dispatch_ms']:.2f} ms, data wait "
                     f"{c['data_wait_ms']:.3f} ms")
    for c in r["rows"]["serve_bench"]:
        err = ("" if c["max_err_vs_auto_in_std"] is None
               else f", vs auto {c['max_err_vs_auto_in_std']:.3g} std")
        lines.append(f"serve {c['backend']} b={c['batch']}: {c['rollout_ms']:.1f} ms a "
                     f"{c['steps']}-call rollout, {c['forecasts_per_s']:.1f} forecasts/s"
                     f"{err}")
    for c in r["rows"]["ensemble_bench"]:
        if "ms" in c:
            lines.append(f"ensemble tool {c['what']}: {c['ms']:.1f} ms")
        else:
            lines.append(f"ensemble tool {c['what']}: folded {c['folded_ms']:.1f} ms, "
                         f"sequential {c['sequential_ms']:.1f} ms, speedup "
                         f"{c['speedup']:.2f}x; member 0 bitwise "
                         f"{c['member0_bitwise_equal_to_rollout']}")
    for c in r["rows"]["scaling_bench"]:
        lines.append(f"scaling {c['mesh_shape']}: step {c['step_seconds'] * 1e3:.1f} ms, "
                     f"{c['gridpoints_per_s'] / 1e6:.3f} M gp/s, per rank "
                     f"{c['gridpoints_per_s_per_chip'] / 1e6:.3f} M, efficiency "
                     f"{c['efficiency_vs_single']:.3f}; ranks share one card "
                     f"{c['ranks_share_one_card']}; collectives on the device "
                     f"{c['device_collectives']}, host_calls {c['host_collectives']}")
    lines.append("bench tools seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in r["seconds"].items()))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chip_smoke_out"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "dlwp_cs_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    check(not [(a, b) for a in KERNEL_NAMES for b in KERNEL_NAMES if a != b and a in b],
          "a kernel name is a substring of another")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t_main, stamps = time.perf_counter(), []

    def stamp(name):
        """Close the phase ``name``: the seconds since the last stamp."""
        now = time.perf_counter() - t_main
        stamps.append((name, now - sum(v for _, v in stamps)))

    from dlwp_cs_tpu_torch.remap import build_csremap

    libraries = list({id(k.library): k.library for k in (
        *all_kernels().values(), *collective_kernels().values())}.values())
    t = time.perf_counter()
    # one nvcc per source, and the remap weight generator, all at once
    with ThreadPoolExecutor(len(libraries) + 1) as pool:
        for fut in [pool.submit(lib.build) for lib in libraries] + [pool.submit(build_csremap)]:
            fut.result()
    build_s = time.perf_counter() - t
    regs = {lib.source.name: [ln.strip() for ln in lib.build_log.splitlines()
                              if "registers" in ln or "Function properties" in ln]
            for lib in libraries}
    print(f"build: {build_s:.2f} s; {regs}", flush=True)
    stamp("build")

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    print("n Cin Cout B dtype | max_abs_err (tol) | kernel_ms plain_ms library_ms bound_ms")
    shapes = sorted(set(FLAGSHIP_CONVS), key=FLAGSHIP_CONVS.index) + EXTRA_SHAPES
    for dtype in (torch.float32, torch.bfloat16):
        for b in (1, 8, TRAIN_BATCH):
            for n, cin, cout in shapes:
                c = conv_case(n, cin, cout, b, dtype, gen)
                cases.append(c)
                print(f"{n} {cin} {cout} {b} {c['dtype']} | {c['max_abs_err']:.3g} "
                      f"({c['tolerance']}) | {c['ms']:.4f} {c['plain_ms']:.4f} "
                      f"{c['library_ms']:.4f} {c['bound_ms']:.5f} {c['bound_by']}",
                      flush=True)
    bad = [c for c in cases if not c["ok"]]
    check(not bad, f"kernel disagrees with its plain version: {bad}")

    stamp("conv")
    bwd = []
    print("backward: kernel n Cin Cout B dtype | max_abs_err (tol) | "
          "kernel_ms plain_ms library_ms bound_ms")
    for dtype in (torch.float32, torch.bfloat16):
        for n, cin, cout in sorted(set(FLAGSHIP_CONVS), key=FLAGSHIP_CONVS.index):
            for c in bwd_case(n, cin, cout, TRAIN_BATCH, dtype, gen):
                bwd.append(c)
                print(f"{c['kernel']} {n} {cin} {cout} {TRAIN_BATCH} {c['dtype']} | "
                      f"{c['max_abs_err']:.3g} ({c['tolerance']}) | {c['ms']:.4f} "
                      f"{c['plain_ms']:.4f} {c['library_ms']:.4f} {c['bound_ms']:.5f} "
                      f"{c['bound_by']}", flush=True)
    bad = [c for c in bwd if not c["ok"]]
    check(not bad, f"backward kernel disagrees with its plain version: {bad}")

    stamp("backward")
    tc = tc_cases(gen)
    bad = [c for c in tc if not c["ok"]]
    check(not bad, f"a tensor-core kernel or its CUDA-core instance disagrees with its plain "
          f"version: {bad}")
    tc_sum = tc_summary(tc)
    print("tensor cores vs the CUDA-core instance (timed in turns, old new new old):"
          " ms new / old / cuDNN / bound", flush=True)
    for name, r in tc_sum.items():
        print(f"{name}: {r['ms']:.4f} / {r['cudacore_ms']:.4f} / {r['library_ms']:.4f} / "
              f"{r['bound_ms']:.5f}", flush=True)

    stamp("tc")
    ring = []
    print("ring: kernel n Cin D B dtype | max_abs_err (tol) | kernel_ms cudacore_ms plain_ms "
          "bound_ms | xring conv, fused conv kernel, cuDNN ms")
    ring_shapes = sorted(set(FLAGSHIP_CONVS), key=FLAGSHIP_CONVS.index) + CONVLSTM_GATES
    for dtype in (torch.float32, torch.bfloat16):
        for b in (1, TRAIN_BATCH):
            for n, cin, d in ring_shapes:
                for c in ring_case(n, cin, d, b, dtype, gen):
                    ring.append(c)
                    print(f"{c['kernel']} {n} {cin} {d} {b} {c['dtype']} | "
                          f"{c['max_abs_err']:.3g} ({c['tolerance']}) | {c['ms']:.4f} "
                          f"{c['cudacore_ms']:.4f} {c['plain_ms']:.4f} {c['bound_ms']:.5f} "
                          f"{c['bound_by']} | "
                          f"{c['xring_conv_ms']:.4f} {c['fused_conv_ms']:.4f} "
                          f"{c['cudnn_conv_ms']:.4f}", flush=True)
    bad = [c for c in ring if not c["ok"]]
    check(not bad, f"ring kernel disagrees with its plain version: {bad}")
    ring_sum = ring_summary(ring)
    print("ring blocks vs the CUDA-core kernels (timed in turns, old new new old): "
          "ms new / old / plain / bound", flush=True)
    for name, r in ring_sum.items():
        print(f"{name}: {r['ms']:.4f} / {r['cudacore_ms']:.4f} / {r['plain_ms']:.4f} / "
              f"{r['bound_ms']:.5f}", flush=True)
    stamp("ring")
    refused = refused_shape_phase(gen)
    print(f"F4: {refused['flagship_routes']} flagship shapes on their kernels; "
          f"{refused['shape']} float32 with a gradient -> {refused['route']}: a step launched "
          f"{refused['launches']} kernels, vs plain {refused['max_abs_err']:.3g} (gradients and "
          f"weights {max(refused['grad_and_weight_rel_err']):.3g} of max); "
          f"{refused['step_ms']:.1f} ms (plain {refused['plain_step_ms']:.1f})", flush=True)
    replays = graph_replay_phase(gen)
    for r in replays:
        print(f"F5 {r['dtype']}: count buffers {r['count_buffers']}, replays bitwise "
              f"{r['replays_bitwise_equal']}, vs plain {r['max_abs_err']:.3g}, counts zero "
              f"{r['counts_zero']}", flush=True)

    stamp("F4, F5")
    # the kernel tools: their entry points (this slice's main path), then
    # each of their kernels against its plain version, timed
    tool_launches, tools_s, tool_rows = tools_main_path()
    print(f"tools: {len(TOOL_RUNS)} runs in {tools_s:.1f} s; launches "
          f"{ {k: tool_launches[k] for k in TOOL_KERNELS} }", flush=True)
    mma = []
    print("tools: kernel n Cin Cout B | max_abs_err (vs #1) | kernel_ms plain_ms #1_ms "
          "library_ms bound_ms")
    from dlwp_cs_tpu_torch.tools.conv_micro import LEVELS
    from dlwp_cs_tpu_torch.tools.timing import HBM_BYTES_PER_S, PEAK_OPS, bound
    mma_shapes = ([s + (1,) for s in sorted(set(FLAGSHIP_CONVS), key=FLAGSHIP_CONVS.index)]
                  + LEVELS + [(48, 96, 32, TRAIN_BATCH)]
                  # past the first designs' plans: Cout = 256, the packed
                  # layout's 128 channels, and n = 48 with 128 -> 128
                  + [(48, 64, 256, 1), (48, 128, 128, 4), (48, 128, 128, 1)])
    for n, cin, cout, b in mma_shapes:
        for c in mma_cases(n, cin, cout, b, gen):
            mma.append(c)
            old = "" if c.get("v1_ms") is None else f" (v1 {c['v1_ms']:.4f})"
            print(f"{c['kernel']} {n} {cin} {cout} {b} | {c['max_abs_err']:.3g} "
                  f"({c['vs_conv_kernel_max_abs_err']:.3g}) | {c['ms']:.4f}{old} "
                  f"{c['plain_ms']:.4f} {c['conv_kernel_ms']:.4f} {c['library_ms']:.4f} "
                  f"{c['bound_ms']:.5f}", flush=True)
    summaries = {kind: mma_summary(mma, kind) for kind in ("npack", "im2col")}
    # the tables a reader compares are printed again just before the result
    # lines, so that the end of the output holds them
    recap = []
    for kind, label in (("npack", "#3"), ("im2col", "#13")):
        recap.append(f"{label} vs the first design's {kind} kernel (timed in turns, old new "
                     "new old): ms new / v1 / cuDNN / plain / bound")
        for name, r in summaries[kind].items():
            recap.append(f"{name}: " + " / ".join(
                "-" if r[k] is None else f"{r[k]:.4f}"
                for k in ("ms", "v1_ms", "library_ms", "plain_ms", "bound_ms")))
    print("\n".join(recap), flush=True)
    # #12 at conv_micro's levels, as the tool's run measured it
    only = [{"ms": r["kernel"], "plain_ms": r["kernel_plain_ms"],
             "library_ms": r["kernel_library_ms"], "max_abs_err": r["kernel_max_abs_err"],
             **bound(r["bytes"], r["ops"], torch.bfloat16)} for r in tool_rows["conv_micro"]]
    for r, c in zip(tool_rows["conv_micro"], only):
        print(f"kernel_only {r['n']} {r['cin']} {r['cout']} {r['batch']} | equal to #1 "
              f"{r['kernel_equals_fused']}, vs plain {c['max_abs_err']:.3g} | ext "
              f"{r['ext']:.4f} kernel {c['ms']:.4f} pallas {r['pallas']:.4f} plain "
              f"{c['plain_ms']:.4f} cuDNN {c['library_ms']:.4f} bound {c['bound_ms']:.5f}",
              flush=True)
    ring_dx = dx_ring_cases(gen)
    for c in ring_dx:
        print(f"dx_ring {c['n']} {c['cin']} {c['cout']} {c['batch']} {c['dtype']} | "
              f"{c['max_abs_err']:.3g} ({c['tolerance']}), equal to #4 {c['equal_to_dx_kernel']} "
              f"| {c['ms']:.4f} (#4 {c['dx_kernel_ms']:.4f}) {c['plain_ms']:.4f} "
              f"{c['library_ms']:.4f} {c['bound_ms']:.5f}", flush=True)
    stores, store_checks = lane_store_cases(gen)
    # #16 at the reference scripts' shapes in bfloat16, as the probe tool's
    # run measured and checked them
    probe_rows = [dict(r, **bound(r["bytes"], r["ops"], torch.bfloat16))
                  for r in tool_rows["mosaic_bisect"]]
    for c in stores + probe_rows:
        old = f" (v1 {c['v1_ms']:.4f})" if "shape" in c else ""
        cold = (f" | cold L2 {c['cold_ms']:.5f} (v1 {c['v1_cold_ms']:.5f}) "
                f"{c['plain_cold_ms']:.4f} {c['library_cold_ms']:.5f}" if "shape" in c else "")
        print(f"{c.get('name', 'lane_store')} {c.get('shapes', c.get('shape'))} {c['dtype']} | "
              f"{c['max_abs_err']:.3g} | {c['ms']:.4f}{old} {c['plain_ms']:.4f} "
              f"{c['library_ms']:.4f} {c['bound_ms']:.5f}{cold}", flush=True)
    print("lane_store bitwise 3x at C, dtype: "
          f"{[(c['shape'][-1], c['dtype'], c['ok']) for c in store_checks]}", flush=True)
    probes_turns = probe_cases()
    probe_sum = probe_summary(probes_turns)
    print("#16 probes vs their v1 kernels (timed in turns, old new new old): ms new / v1 / "
          "library / bound", flush=True)
    for name, r in probe_sum.items():
        print(f"{name}: {r['ms']:.4f} / {r['v1_ms']:.4f} / {r['library_ms']:.4f} / "
              f"{r['bound_ms']:.5f}", flush=True)
    bad = [c for c in mma + ring_dx + stores + store_checks + probes_turns if not c["ok"]]
    check(not bad, f"a kernel of the tools disagrees with its plain version: {bad}")

    stamp("tools")
    blocks = []
    print("block: kernel n rows x cols Cin Cout B dtype | max_abs_err (tol) | kernel_ms "
          "plain_ms library_ms bound_ms")
    for dtype in (torch.float32, torch.bfloat16):
        for b in (1, 8):
            for kind in ("band", "tile"):
                for n, cin, cout in sorted(set(FLAGSHIP_CONVS), key=FLAGSHIP_CONVS.index):
                    c = block_case(kind, n, cin, cout, b, dtype, gen)
                    blocks.append(c)
                    print(f"{kind} {n} {c['rows']}x{c['cols']} {cin} {cout} {b} {c['dtype']} | "
                          f"{c['max_abs_err']:.3g} ({c['tolerance']}) | {c['ms']:.4f} "
                          f"{c['plain_ms']:.4f} {c['library_ms']:.4f} {c['bound_ms']:.5f} "
                          f"{c['bound_by']}", flush=True)
    bad = [c for c in blocks if not c["ok"]]
    check(not bad, f"band or tile kernel disagrees with its plain version: {bad}")

    stamp("blocks")
    # one generator per model, drawn in the same order for each: serve
    # bf16, f32, then train bf16, f32 (the U-Net's draws are PR 2's)
    serve, train, ensembles = {}, {}, {}
    for kind, seed in (("unet", 0), ("convlstm", 1)):
        rng = np.random.default_rng(seed)
        for dtype_name in ("bfloat16", "float32"):
            s = serve_phase(kind, dtype_name, rng)
            serve[kind, dtype_name] = s
            print(f"serve {kind} {dtype_name}: 14-day rollout {s['rollout_ms_median']:.2f} ms "
                  f"(runs {['%.2f' % t for t in s['rollout_ms']]}); profiled rollout "
                  f"{s['profiled_rollout_ms']:.2f} ms: device busy {s['device_busy_ms']} ms "
                  f"(idle share {s['device_idle_share']}), kernels "
                  f"{s['kernel_device_ms']} ms; device kernels {s['device_kernels']}; "
                  f"{s['launches_per_forecast']} launches, first two calls vs plain "
                  f"{s['first_two_calls_max_abs_err']:.3g} "
                  f"(tol {s['first_two_calls_tolerance']:.3g}), "
                  f"8 submits in {s['submit_dispatches']} dispatches, vs direct "
                  f"{s['submit_vs_direct_max_err_in_std']:.3g} std", flush=True)
        if kind == "unet":
            for dtype_name in ("bfloat16", "float32"):
                e = ensemble_phase(dtype_name, np.random.default_rng(3))
                ensembles[dtype_name] = e
                recap.append(f"ensemble unet {dtype_name}: {e['members']} members x {e['steps']} "
                      f"calls in {e['ensemble_ms_median']:.2f} ms median (runs "
                      f"{['%.2f' % t for t in e['ensemble_ms']]}); profiled "
                      f"{e['profiled_ensemble_ms']:.2f} ms: device busy {e['device_busy_ms']} "
                      f"ms (idle share {e['device_idle_share']}), kernels "
                      f"{e['kernel_device_ms']} ms; device kernels {e['device_kernels']}; "
                      f"{e['launches_per_ensemble']} launches; control member vs forecast "
                      f"bitwise {e['control_bitwise_equal_to_forecast']} "
                      f"({e['control_vs_forecast_max_err_in_std']:.3g} std); first two calls "
                      f"vs plain {e['first_two_calls_max_abs_err']:.3g} (tol "
                      f"{e['first_two_calls_tolerance']:.3g}); 3 submits in "
                      f"{e['submit_dispatches']} dispatch, vs stacked bitwise "
                      f"{e['submit_bitwise_equal_to_stacked']} "
                      f"({e['submit_vs_stacked_max_err_in_std']:.3g} std); estimator vs "
                      f"service bitwise {e['estimator_bitwise_equal_to_service']} "
                      f"({e['estimator_vs_service_max_abs_err']:.3g})")
                print(recap[-1], flush=True)
        for dtype_name in ("bfloat16", "float32"):
            r = train_phase(kind, dtype_name, rng)
            train[kind, dtype_name] = r
            print(f"train {kind} {dtype_name}: batch {r['batch']}, {r['steps']} steps in "
                  f"{r['fit_seconds']:.2f} s; step {r['step_ms_median']:.2f} ms median "
                  f"(runs {['%.2f' % t for t in r['step_ms']]}); profiled step "
                  f"{r['profiled_step_ms']:.2f} ms: device busy {r['device_busy_ms']} ms "
                  f"(idle share {r['device_idle_share']}), kernels {r['kernel_device_ms']} ms; "
                  f"device kernels per step {r['device_kernels_per_step']} (forward+backward "
                  f"{r['device_kernels_forward_backward']}, norm+optimizer "
                  f"{r['device_kernels_optimizer']}); "
                  f"launches {r['launches']}; loss {r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}; "
                  f"fixed batch {r['fixed_batch_losses'][0]:.4f} -> "
                  f"{np.mean(r['fixed_batch_losses'][-5:]):.4f}; step-1 grads vs plain "
                  f"{r['grad_vs_plain_rel_err']:.3g} of max in {r['grad_worst_tensor']}; "
                  f"checked against {r['grad_check']['against']}: "
                  f"{r['grad_check']['rel_err']:.3g} in {r['grad_check']['tensor']} (tol "
                  f"{r['grad_check']['tolerance']:.3g}), "
                  f"bitwise repeatable {r['grads_bitwise_repeatable']}", flush=True)

    stamp("serve, ensemble, train")
    # exported artifacts (serve/export.py) replayed as one CUDA graph per
    # forecast, beside the live service in the same run
    exports = []
    with tempfile.TemporaryDirectory() as workdir:  # the artifacts
        for kind, dtype_name, buckets in EXPORT_CASES:
            e = export_phase(kind, dtype_name, buckets, np.random.default_rng(4), workdir)
            exports.append(e)
            for r in e["buckets"]:
                recap.append(
                    f"export {kind} {dtype_name} batch {r['batch']}: export "
                    f"{e['export_seconds']:.1f} s, load {e['load_seconds']:.2f} s, eager run + "
                    f"capture + first replay {r['capture_seconds']:.2f} s; 14-day forecast "
                    f"{r['exported_ms_median']:.2f} ms median (the replay alone "
                    f"{r['replay_ms_median']:.2f}; live {r['live_ms_median']:.2f}, "
                    f"live through the operators {r['live_through_operators_ms_median']:.2f}); "
                    f"profiled exported {r['profiled_exported_ms']:.2f} ms: busy "
                    f"{r['device_busy_ms']} ms (idle share {r['device_idle_share']}); live "
                    f"{r['profiled_live_ms']:.2f} ms: busy {r['live_device_busy_ms']} ms (idle "
                    f"share {r['live_device_idle_share']}); host CUDA calls per forecast "
                    f"{r['host_calls_per_forecast']} (live {r['live_host_calls_per_forecast']});"
                    f" device kernels {r['device_kernels_per_forecast']['all']} (live "
                    f"{r['live_device_kernels_per_forecast']['all']}); vs live bitwise "
                    f"{r['bitwise_equal_to_live']} ({r['max_err_in_std']:.3g} std, tol "
                    f"{r['tolerance_in_std']:.3g})")
                print(recap[-1], flush=True)
    stamp("export")
    web = http_phase(np.random.default_rng(5))
    recap.append(
        f"http: 8 concurrent /forecast in {web['forecast_dispatches']} dispatch ({web['burst_ms']:.1f}"
        f" ms), bitwise equal to the direct batch {web['forecast_bitwise_equal']}; 3 /ensemble "
        f"in {web['ensemble_dispatches']} dispatch, bitwise equal to the stacked call "
        f"{web['ensemble_bitwise_equal']}; one round trip {web['round_trip_ms_median']:.1f} ms "
        f"median (runs {['%.1f' % t for t in web['round_trip_ms']]})")
    print(recap[-1], flush=True)

    stamp("http")
    # the data pipeline: weights built here, the Preprocessor's remap on the
    # card, then training and a forecast from the store it built
    with tempfile.TemporaryDirectory() as workdir:  # the weights and the store
        t = time.perf_counter()
        data, ex_store = data_phase(workdir)  # ex_store: the examples chain from it
        data["phase_seconds"] = time.perf_counter() - t
    recap.append(
        f"data: ERA5 {data['grid'][0]}x{data['grid'][1]} <-> C{data['n']} exact conservative "
        f"weights ll2cs {data['ll2cs']['seconds']:.2f} s ({data['ll2cs']['nnz']} nonzeros, "
        f"{data['ll2cs']['row_nnz_min_mean_max']} per row), cs2ll {data['cs2ll']['seconds']:.2f} s "
        f"({data['cs2ll']['nnz']}); Preprocessor {data['fields_shape']} in "
        f"{['%.2f' % v for v in data['preprocessor_seconds']]} s on the card, second run "
        f"bitwise {data['second_run_bitwise_equal']}; vs plain (of each variable's largest) "
        f"{max(data['max_err_of_largest'].values()):.3g}, mean {data['mean_rel_err']:.3g}, std "
        f"{data['std_rel_err']:.3g} (rel); remap of a {DATA_BATCH}-time batch "
        f"{data['remap_batch_ms']:.3f} ms on the card (bound {data['bound_ms']:.4f} ms, "
        f"{data['bound_by']}), plain {data['plain_batch_ms']:.1f} ms on the host; store "
        f"{data['store_branch']}; fit {DATA_TRAIN_STEPS} steps in {data['fit_seconds']:.2f} s, "
        f"launches {data['train_launches']}, loss {data['losses'][0]:.4f} -> "
        f"{data['losses'][-1]:.4f}; 14-day forecast {data['forecast_ms']:.1f} ms "
        f"({data['forecast_launches']} launches of #1), remapped to {data['grid'][0]}x"
        f"{data['grid'][1]} on the card in {data['remap_back_ms']:.1f} ms, vs plain "
        f"{max(data['remap_back_max_err_of_largest'].values()):.3g}; phase "
        f"{data['phase_seconds']:.1f} s")
    print(recap[-1], flush=True)

    stamp("data")
    # quantized serving (ops/quant.py): the int8 base conv at each flagship
    # conv shape, then the U-Net served in int8 beside the live service, and
    # the int8 ConvLSTM
    t = time.perf_counter()
    int8_cases = []
    print("int8: n Cin Cout B dtype | bitwise (library bitwise) | kernel_ms plain_ms "
          "int_mm_ms (gather_ms) #1_ms bound_ms")
    for dtype in (torch.bfloat16, torch.float32):
        for b in QUANT_BATCHES:
            for n, cin, cout in sorted(set(FLAGSHIP_CONVS), key=FLAGSHIP_CONVS.index):
                c = int8_conv_case(n, cin, cout, b, dtype, gen)
                int8_cases.append(c)
                print(f"int8 {n} {cin} {cout} {b} {c['dtype']} | {c['bitwise_equal']} "
                      f"({c['library_bitwise_equal']}) | {c['ms']:.4f} {c['plain_ms']:.4f} "
                      f"{c['library_ms']:.4f} ({c['gather_ms']:.4f}) {c['conv_kernel_ms']:.4f} "
                      f"{c['bound_ms']:.5f} {c['bound_by']}", flush=True)
    bad = [c for c in int8_cases if not c["ok"]]
    check(not bad, f"the int8 kernel differs from its plain version: {bad}")
    quant = {d: quant_phase(d, np.random.default_rng(8)) for d in ("bfloat16", "float32")}
    quant_lstm = quant_convlstm_phase(np.random.default_rng(9))
    quant_s = time.perf_counter() - t
    for d, q in quant.items():
        recap.append(
            f"quant unet {d}: 14-day forecast {q['forecast_ms_median']['quantized']:.1f} ms "
            f"median (live {q['forecast_ms_median']['live']:.1f}; runs {q['forecast_ms']}), "
            f"{ENS_MEMBERS}-member ensemble {q['ensemble_ms_median']['quantized']:.1f} ms (live "
            f"{q['ensemble_ms_median']['live']:.1f}); profiled {q['profiled_forecast_ms']:.1f} ms: "
            f"busy {q['device_busy_ms']} ms (idle share {q['device_idle_share']}), kernels "
            f"{q['kernel_device_ms']}; device kernels {q['device_kernels']}; int8 launches "
            f"{q['launches']['forecast']['cs_conv3x3_int8_base']} a forecast, "
            f"{q['launches']['ensemble']['cs_conv3x3_int8_base']} an ensemble; vs live max "
            f"{q['vs_live_max_err_in_std']:.3g} std (first call "
            f"{q['vs_live_max_err_in_std_first_call']:.3g}, rms per variable "
            f"{['%.3g' % v for v in q['vs_live_rms_err_in_std_per_variable']]}), ensemble mean "
            f"{q['ensemble_mean_vs_live_max_err_in_std']:.3g} std; first two calls bitwise equal "
            f"to the plain version {q['first_two_calls_bitwise_equal_to_plain']}; bitwise "
            f"repeatable {q['bitwise_repeatable']}")
        print(recap[-1], flush=True)
    recap.append(
        f"quant convlstm bfloat16: 14-day forecast {quant_lstm['forecast_ms']:.1f} ms (xring "
        f"{quant_lstm['xring_forecast_ms']:.1f}), int8 launches "
        f"{quant_lstm['launches']['cs_conv3x3_int8_base']}; vs xring max "
        f"{quant_lstm['vs_xring_max_err_in_std']:.3g} std (first call "
        f"{quant_lstm['vs_xring_max_err_in_std_first_call']:.3g}); phase {quant_s:.1f} s")
    print(recap[-1], flush=True)

    stamp("quant")
    # the lat-lon models and the registry, on the card against the CPU
    t = time.perf_counter()
    latlon = [latlon_phase(d) for d in ("bfloat16", "float32")]
    latlon_s = time.perf_counter() - t
    for r in latlon:
        recap.append(f"latlon {r['dtype']} ({r['grid'][0]}x{r['grid'][1]}): " + "; ".join(
            f"{k} {v['ms']:.1f} ms, vs CPU {v['max_abs_err']:.3g} of {v['scale']:.3g} "
            f"(tol {v['tolerance']:.3g}), launches {v['launches']}"
            for k, v in r.items() if isinstance(v, dict)) + f"; phase {latlon_s:.1f} s")
        print(recap[-1], flush=True)

    stamp("latlon")
    # the barotropic baseline and the utilities (profiling, plots)
    t = time.perf_counter()
    baro = barotropic_phase()
    baro_s = time.perf_counter() - t
    for r in baro:
        recap.append(
            f"barotropic T{r['lmax']} ({r['grid'][0]}x{r['grid'][1]}, f32): {r['steps']} RK4 "
            f"steps (14 days) in {r['wall_s']:.2f} s, {r['steps_per_s']:.1f} steps/s; day 1 vs "
            f"f64 on the CPU {r['day1_vs_f64_rel_err']:.3g} of the max (tol {r['tolerance']:.0e}); "
            f"day 14 max {r['final_max_over_initial']:.3g}x the initial, correlation with t0 "
            f"{r['final_corr_with_t0']:.3f}; profiled day {r['profiled_day_ms']:.1f} ms: busy "
            f"{r['device_busy_ms']} ms (idle share {r['device_idle_share']}), "
            f"{r['device_kernels_per_day']} device kernels; phase {baro_s:.1f} s")
        print(recap[-1], flush=True)
    os.makedirs(args.out, exist_ok=True)
    t = time.perf_counter()
    util = utils_phase(args.out, np.random.default_rng(12))
    utils_s = time.perf_counter() - t
    recap.append(
        f"utils: trace {util['trace']} names {util['trace_names']}; Timer.time_fn of a bf16 "
        f"model call {util['model_call_ms']:.3f} ms; conv_roofline vs tools/timing.py::bound "
        f"(ms, batch 1, bf16) " + ", ".join(
            f"({r['n']},{r['cin']},{r['cout']}) {r['roofline_ms']:.5f} {r['timing_bound_ms']:.5f}"
            for r in util["roofline"]) + f"; plots: {util['plots']}; phase {utils_s:.1f} s")
    print(recap[-1], flush=True)

    stamp("barotropic, utils")
    with tempfile.TemporaryDirectory() as workdir:  # the groups' FileStores
        sharded, exchange, group_s, remote, front, coll = sharded_phase(
            np.random.default_rng(2), workdir)
    for r in front:
        recap.append(
            f"mesh front end {r['dtype']} (4 ranks sharing one card, data 2 x spatial 2): 3 "
            f"submits on rank 0 in {r['dispatches']} dispatch ({r['wall_ms']:.1f} ms), followed "
            f"by ranks 1-3 ({r['follower_runs']}), vs one card {r['vs_one_card_max_err_in_std']:.3g}"
            f" std, bitwise equal to the collective call {r['bitwise_equal_to_collective']}; "
            f"ensemble of {r['ensemble_members']} padded by {r['ensemble_padded_mesh']}, vs one "
            f"card {r['ensemble_vs_one_card_max_err_in_std']:.3g} std (tol "
            f"{r['tolerance_in_std']:.3g})")
        print(recap[-1], flush=True)
    stamp("sharded, collectives")
    # the route by which the band-exchange kernels (#10, #11) can be
    # measured: CUDA MPS on this machine (look only)
    mps = {"nvidia_cuda_mps_control": shutil.which("nvidia-cuda-mps-control"),
           "device_count": torch.cuda.device_count()}
    recap.append(f"item 17d route: nvidia-cuda-mps-control {mps['nvidia_cuda_mps_control']}, "
                 f"{mps['device_count']} card(s)")
    print(recap[-1], flush=True)
    probe = remote["probe"]
    recap.append(
        "exchange probe (tools/xchg_probe.py, ranks sharing one card, ms per round trip to "
        "both ring neighbours, the slowest rank's mean of two turns): " + "; ".join(
            f"{k} ranks spin {probe[k]['spin_ms']:.4f}, stream wait {probe[k]['stream_ms']:.4f}"
            for k in (2, 4)))
    print(recap[-1], flush=True)
    print("remote: kernel ranks n rows Cin Cout B dtype | max_abs_err | kernel_ms v1_ms "
          "plain_ms library_ms bound_ms (rank 0; v1 in turns; #11: max |#11 - #8|)")
    for key, name, ranks_n in (("xchg2", "#10", 2), ("xchg4", "#10", 4), ("overlap2", "#11", 2),
                               ("overlap4", "#11", 4)):
        for c in remote[key][: len(remote[key]) // ranks_n]:  # rank 0's
            extra = (f" | vs #8 {c['vs_band_kernel_max_abs_err']:.3g}"
                     if "vs_band_kernel_max_abs_err" in c else "")
            lib = "-" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
            v1 = "-" if c["v1_ms"] is None else f"{c['v1_ms']:.4f}"
            print(f"{name} {ranks_n} {c['n']} {c['rows']} {c['cin']} {c['cout']} {c['batch']} "
                  f"{c['dtype']} | {c['max_abs_err']:.3g} | {c['ms']:.4f} {v1} "
                  f"{c['plain_ms']:.4f} {lib} {c['bound_ms']:.5f}{extra}", flush=True)
    for key, name, ranks_n in (("xchg2", "#10", 2), ("xchg4", "#10", 4), ("overlap2", "#11", 2),
                               ("overlap4", "#11", 4)):
        for b in (1, 8):
            for dt in ("float32", "bfloat16"):
                rows = [c for c in remote[key][: len(remote[key]) // ranks_n]
                        if c["batch"] == b and c["dtype"] == dt]
                if not rows:  # 2 ranks: batch 1 only
                    continue
                per = {(c["n"], c["cin"], c["cout"]): c for c in rows}
                call = [per[s_] for s_ in FLAGSHIP_CONVS]
                v1 = ("" if b != 1 else
                      f", first design (v1, in turns) {sum(c['v1_ms'] for c in call):.3f} ms "
                      f"(per call {min(c['v1_ms'] for c in rows):.4f}-"
                      f"{max(c['v1_ms'] for c in rows):.4f})")
                recap.append(
                    f"{name} on {ranks_n} ranks sharing one card, batch {b} {dt}, a model "
                    f"call's 10 (rank 0): {sum(c['ms'] for c in call):.3f} ms; per call "
                    f"{min(c['ms'] for c in rows):.4f}-{max(c['ms'] for c in rows):.4f}{v1}")
                print(recap[-1], flush=True)
    for r in sharded:
        print(f"sharded {r['path']} {r['dtype']} batch {r['batch']}: vs one card "
              f"{r['max_err_in_std']:.3g} std (tol {r['tolerance_in_std']}); 14-day "
              f"forecast {max(r['wall_ms_per_rank']):.1f} ms wall, 4 ranks sharing one card "
              f"over CUDA IPC; launches per rank {r['launches_per_rank']}; collectives per "
              f"rank on the device {[c['device_calls'] for c in r['collectives_per_rank']]}, "
              f"host_calls {[c['host_calls'] for c in r['collectives_per_rank']]}; collective "
              f"kernel launches rank 0 {r['collective_launches_per_rank'][0]}", flush=True)
    print("collectives: ranks where op shape dtype (per model call) | bitwise | device_ms "
          "plain_ms bound_ms (rank 0; CUDA events around 20 calls, in turns with gloo)")
    for world in (2, 4):
        for c in coll[world][0]:
            print(f"collective {world} {c['where']} {c['op']} {c['shape']} {c['dtype']} "
                  f"({c['per_model_call']}) | {c['equal']} | {c['ms']:.4f} {c['plain_ms']:.4f} "
                  f"{c['bound_ms']:.6f}", flush=True)
        for where in sorted({c["where"] for c in coll[world][0]}):
            for dt in ("bfloat16", "float32"):
                rows = [c for c in coll[world][0] if c["where"] == where and c["dtype"] == dt]
                if not rows:
                    continue
                n = sum(c["per_model_call"] for c in rows)
                recap.append(
                    f"collectives on {world} ranks sharing one card, {where} {dt} (rank 0): "
                    f"{n} a model call in {sum(c['ms'] * c['per_model_call'] for c in rows):.3f}"
                    f" ms on the device (gloo {sum(c['plain_ms'] * c['per_model_call'] for c in rows):.3f}"
                    f" ms); per call {min(c['ms'] for c in rows):.4f}-"
                    f"{max(c['ms'] for c in rows):.4f} ms (gloo {min(c['plain_ms'] for c in rows):.3f}"
                    f"-{max(c['plain_ms'] for c in rows):.3f}); bitwise equal to the plain "
                    f"version on every rank")
                print(recap[-1], flush=True)
    print(f"sharded phase seconds: {remote['phase_seconds']}", flush=True)
    print(f"sharded group: {group_s:.1f} s from spawn to the last rank's exit; per rank, "
          f"ms per all_gather of one ghost strip, per band and per tile conv with its "
          f"exchange, per band-row exchange (ppermute pair, #10), per band conv with #10 "
          f"and per #11 conv (4 ranks sharing one card over gloo + CUDA IPC): {exchange}",
          flush=True)

    stamp("sharded lines")
    # training under a mesh, 4 ranks sharing the card
    with tempfile.TemporaryDirectory() as workdir:  # the group's FileStore
        mesh_train, mesh_train_s, ex_mesh05 = mesh_train_phase(workdir, examples_head(ex_store))
    for r in mesh_train:
        if r["path"] == "fit":
            line_ = (f"mesh train fit {r['dtype']} (data 4, Trainer.fit, one epoch of "
                     f"{r['steps']} steps from a MemoryStore through prefetch_to_device("
                     f"sharding=mesh)): losses {['%.4f' % v for v in r['losses_rank0']]}; "
                     f"seconds per rank {['%.2f' % v for v in r['seconds_per_rank']]}; launches "
                     f"per step {r['launches_per_step']}; collectives per rank (device, "
                     f"host_calls) {[(c['device_calls'], c['host_calls']) for c in r['collectives_per_rank']]}"
                     f"; bitwise equal across ranks")
        elif r["path"] == "sequence":
            line_ = (f"mesh train sequence {r['dtype']} (data 1 x spatial 4, sequence 2, "
                     f"batch {r['batch']}, the band ring-fix conv): loss {r['loss']:.5f} (one "
                     f"card {r['one_card_loss']:.5f}); step ms per rank "
                     f"{['%.1f' % v for v in r['step_ms_per_rank']]}; collectives per rank "
                     f"(device, host_calls) "
                     f"{[(c['device_calls'], c['host_calls']) for c in r['collectives_per_rank']]}"
                     f"; bitwise equal across ranks")
        else:
            line_ = (f"mesh train {r['path']} {r['dtype']} mesh {r['mesh']}: SGD gradients vs "
                     f"one card {max(r['grad_rel_err_per_rank']):.3g} of each tensor's max "
                     f"(tol {r['grad_tolerance']:.3g}); Adam losses "
                     f"{r['losses_rank0'][0]:.5f} -> {r['losses_rank0'][-1]:.5f}; step ms "
                     f"median per rank {['%.1f' % v for v in r['step_ms_median_per_rank']]}; "
                     f"launches per step {r['launches_per_step']}; collectives a step rank 0 "
                     f"device {r['collectives_per_step'][0]['device_calls']:.0f}, host_calls "
                     f"{r['collectives_per_step'][0]['host_calls']:.0f}, collective kernel "
                     f"launches {r['collective_launches_per_step'][0]}; bitwise equal across "
                     f"ranks")
        recap.append(line_)
        print(line_, flush=True)
    print(f"mesh train group: {mesh_train_s:.1f} s from spawn to the last rank's exit",
          flush=True)

    stamp("mesh train")
    # the example workflows chained at full width from the data phase's
    # store (train, forecast, scores, sequence fine-tuning, serving, ensemble
    # and export)
    with tempfile.TemporaryDirectory() as workdir:  # the models, the artifact
        examples = examples_phase(workdir, args.out, ex_store, data, ex_mesh05)
    for line_ in examples_lines(examples):
        recap.append(line_)
        print(line_, flush=True)

    stamp("examples")
    # the measurement tools (dlwp_cs_tpu_torch.tools) and #1's streamed
    # weights at the capacity sweep's wide shapes
    t = time.perf_counter()
    bench = bench_tools_phase(gen)
    bench["phase_seconds"] = time.perf_counter() - t
    for line_ in bench_tools_lines(bench):
        recap.append(line_)
        print(line_, flush=True)

    stamp("bench tools")
    recap.append("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in stamps)
                 + f"; total {time.perf_counter() - t_main:.1f}")
    print(recap[-1], flush=True)
    def line(name, source, replaces, launches, per_path, errs, peak=torch.bfloat16):
        """One kernel's entry: times summed over the convs of one model call
        (forward) or one train step (backward) in bfloat16; operations at the
        tensor cores' ``peak`` rate."""
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(errs),
            "ms": sum(c["ms"] for c in per_path),
            "plain_ms": sum(c["plain_ms"] for c in per_path),
            "bound_ms": sum(c["bound_ms"] for c in per_path),
            "bound_by": "bytes" if sum(c["bytes"] / HBM_BYTES_PER_S for c in per_path)
            >= sum(c["ops"] / PEAK_OPS[peak] for c in per_path) else "operations",
            "library_ms": None if any(c["library_ms"] is None for c in per_path)
            else sum(c["library_ms"] for c in per_path),
        }

    # forward: one model call (its 10 convs) at the serving batch 1;
    # launches are the bfloat16 forecast's
    fwd = {(c["n"], c["cin"], c["cout"]): c for c in cases
           if c["batch"] == 1 and c["dtype"] == "bfloat16"}
    # backward: one train step at batch 16 (dw on all 10 convs, dx on the 9
    # whose input is not data); launches are the bfloat16 training run's
    back = {(c["kernel"], c["n"], c["cin"], c["cout"]): c for c in bwd
            if c["dtype"] == "bfloat16"}
    # ring kernels: the 4 gate convs of one ConvLSTM model call at batch 1;
    # launches are the bfloat16 ConvLSTM forecast's (#6 is not on its path)
    gates = {(c["kernel"], c["n"], c["cin"], c["cout"]): c for c in ring
             if c["batch"] == 1 and c["dtype"] == "bfloat16"}
    unet_fc = serve["unet", "bfloat16"]["launches_per_forecast"]
    lstm_fc = serve["convlstm", "bfloat16"]["launches_per_forecast"]
    unet_tr = train["unet", "bfloat16"]["launches"]
    src_bwd = "dlwp_cs_tpu_torch/csrc/cs_conv3x3_bwd.cu"
    src_ring = "dlwp_cs_tpu_torch/csrc/cs_ring.cu"
    kernels = [
        line("cs_conv3x3", "dlwp_cs_tpu_torch/csrc/cs_conv3x3.cu",
             "dlwp_cs_tpu/ops/pallas_conv.py:131", unet_fc["cs_conv3x3"],
             [fwd[s] for s in FLAGSHIP_CONVS], [c["max_abs_err"] for c in cases]),
        line("cs_conv3x3_dx", src_bwd, "dlwp_cs_tpu/ops/pallas_conv.py:628",
             unet_tr["cs_conv3x3_dx"],
             [back[("dx",) + s] for s in FLAGSHIP_CONVS[1:]],
             [c["max_abs_err"] for c in bwd if c["kernel"] == "dx"]),
        line("cs_conv3x3_dw", src_bwd, "dlwp_cs_tpu/ops/pallas_conv.py:656",
             unet_tr["cs_conv3x3_dw"],
             [back[("dw",) + s] for s in FLAGSHIP_CONVS],
             [c["max_abs_err"] for c in bwd if c["kernel"] == "dw"]),
        line("ring_fixes", src_ring, "dlwp_cs_tpu/ops/ring_kernel.py:54",
             lstm_fc["ring_fixes"], [gates[("fixes",) + s] for s in CONVLSTM_CALL],
             [c["max_abs_err"] for c in ring if c["kernel"] == "fixes"]),
        line("xring_fused_apply", src_ring, "dlwp_cs_tpu/ops/ring_kernel.py:187",
             lstm_fc["xring_fused_apply"], [gates[("apply",) + s] for s in CONVLSTM_CALL],
             [c["max_abs_err"] for c in ring if c["kernel"] == "apply"]),
    ]
    # bands and tiles: one model call's 10 convs on one rank's block at the
    # serving batch 1 in bfloat16; launches per rank of the bf16 forecasts
    blk = {(c["kernel"], c["n"], c["cin"], c["cout"]): c for c in blocks
           if c["batch"] == 1 and c["dtype"] == "bfloat16"}
    per_rank = {(r["path"], r["dtype"]): r["launches_per_rank"] for r in sharded}
    for kind, name, replaces in (
        ("band", "cs_conv3x3_band", "dlwp_cs_tpu/parallel/pallas_band.py:111"),
        ("tile", "cs_conv3x3_tile", "dlwp_cs_tpu/parallel/pallas_tile.py:92"),
    ):
        kernels.append(line(name, "dlwp_cs_tpu_torch/csrc/cs_conv3x3.cu", replaces,
                            per_rank[kind, "bfloat16"][name],
                            [blk[(kind,) + s] for s in FLAGSHIP_CONVS],
                            [c["max_abs_err"] for c in blocks if c["kernel"] == kind]))
    # #10 and #11: one model call's 10 convs on rank 0's band of 4, batch 1,
    # bfloat16 (#10 moves each conv's input rows), with the first design's
    # time (in turns, the other ranks' time slices in it); launches per rank
    # of the bf16 forecasts
    rank0 = remote["per_rank"][0]
    for key, name, src, replaces, path in (
        ("xchg", "band_exchange_rdma", "dlwp_cs_tpu_torch/csrc/cs_band_xchg.cu",
         "dlwp_cs_tpu/parallel/rdma_halo.py:49", "band_rdma"),
        ("overlap", "band_conv3x3_overlap", "dlwp_cs_tpu_torch/csrc/cs_band_overlap.cu",
         "dlwp_cs_tpu/parallel/overlap_band.py:110", "band_overlap"),
    ):
        per_shape = {(c["n"], c["cin"], c["cout"]): c for c in rank0[key]
                     if c["batch"] == 1 and c["dtype"] == "bfloat16"}
        errs = [c["max_abs_err"] for k in (key + "2", key + "4") for c in remote[k]]
        kernels.append(line(name, src, replaces, per_rank[path, "bfloat16"][name],
                            [per_shape[s] for s in FLAGSHIP_CONVS], errs))
        kernels[-1]["v1_ms"] = sum(per_shape[s]["v1_ms"] for s in FLAGSHIP_CONVS)
    # the device collectives (no TPU counterpart: XLA's collectives): the
    # collectives one bf16 model call on 4 bands issues, on rank 0 of 4
    # sharing the card, each timed whole (its stream waits included) and
    # counted once per call in its model call; launches per rank of the bf16
    # #8 band forecast and per mesh-train step
    band4 = [c for c in coll[4][0] if c["where"] == "band" and c["dtype"] == "bfloat16"]
    band2 = [c for c in coll[2][0] if c["where"] == "band" and c["dtype"] == "bfloat16"]
    per_rank_coll = {(r["path"], r["dtype"]): r["collective_launches_per_rank"][0]
                     for r in sharded}
    for name, op_of, replaces in (
        ("collective_send", None, "dlwp_cs_tpu/parallel/halo.py:177"),
        ("collective_reduce", ("psum",), "dlwp_cs_tpu/parallel/halo.py:204"),
        ("collective_unpack", ("all_gather", "ppermute"), "dlwp_cs_tpu/parallel/halo.py:211"),
    ):
        def used(c):
            return c["launches_per_call"][name] > 0 and (op_of is None or c["op"] in op_of)

        def weighted(cases):
            return [dict(c, ms=c["ms"] * c["per_model_call"],
                         plain_ms=c["plain_ms"] * c["per_model_call"],
                         bound_ms=c["bound_ms"] * c["per_model_call"],
                         bytes=c["bytes"] * c["per_model_call"]) for c in cases if used(c)]

        kernels.append(line(name, "dlwp_cs_tpu_torch/csrc/cs_collectives.cu", replaces,
                            per_rank_coll["band", "bfloat16"][name], weighted(band4),
                            [c["max_abs_err"] for w in coll.values() for c in w[0]]))
        kernels[-1]["replaces_note"] = ("no TPU kernel: XLA's collectives (lax.ppermute, "
                                        "all_gather, psum under shard_map)")
        kernels[-1]["library_note"] = "no single call: NCCL refuses ranks sharing one card"
        kernels[-1]["two_ranks_ms"] = sum(c["ms"] for c in weighted(band2))
        kernels[-1]["launches_per_forecast"] = {
            f"{path} {dt}": lw[name] for (path, dt), lw in per_rank_coll.items()}
        kernels[-1]["mesh_train_launches_per_step"] = {
            f"{r['path']} {r['dtype']}": r["collective_launches_per_step"][0][name]
            for r in mesh_train if "collective_launches_per_step" in r}
    # the kernel tools' kernels; launches per run of the tools (TOOL_RUNS):
    # wrapper calls, those captured into a timing CUDA graph included, its
    # replays not.
    # #3 and #13: one model call's 10 convs at batch 1, as #1's line
    per_conv = {(c["kernel"], c["n"], c["cin"], c["cout"]): c for c in mma if c["batch"] == 1}
    for kind, name, replaces in (
        ("npack", "cs_conv3x3_npack", "dlwp_cs_tpu/ops/pallas_conv.py:213"),
        ("im2col", "cs_conv3x3_im2col", "tools/kernel_variants.py:194"),
    ):
        kernels.append(line(name, "dlwp_cs_tpu_torch/csrc/cs_conv3x3_mma.cu", replaces,
                            tool_launches[name], [per_conv[(kind,) + s] for s in FLAGSHIP_CONVS],
                            [c["max_abs_err"] for c in mma if c["kernel"] == kind]))
    # #12 and #14: conv_micro's three levels at batch 16 (bf16); #15: one call
    kernels.append(line("cs_conv3x3_kernel_only", "dlwp_cs_tpu_torch/csrc/cs_conv3x3.cu",
                        "tools/conv_micro.py:143", tool_launches["cs_conv3x3_kernel_only"], only,
                        [c["max_abs_err"] for c in only]))
    kernels.append(line("cs_conv3x3_dx_ring", src_bwd, "tools/kernel_variants.py:345",
                        tool_launches["cs_conv3x3_dx_ring"],
                        [c for c in ring_dx if c["dtype"] == "bfloat16"],
                        [c["max_abs_err"] for c in ring_dx]))
    src_probes = "dlwp_cs_tpu_torch/csrc/cs_probes.cu"
    # #15 against its HBM bound: the cold-L2 times
    kernels.append(line("lane_store", src_probes, "tools/kernel_variants.py:427",
                        tool_launches["lane_store"],
                        [dict(c, ms=c["cold_ms"], plain_ms=c["plain_cold_ms"],
                              library_ms=c["library_cold_ms"])
                         for c in stores if c["dtype"] == "bfloat16"],
                        [c["max_abs_err"] for c in stores]))
    # #16: each probe at the reference scripts' shapes (bisect3's three dw
    # shapes summed)
    for name, replaces in (
        ("probe_assemble", "tools/mosaic_bisect.py:27"),
        ("probe_select", "tools/mosaic_bisect.py:43"),
        ("probe_dot", "tools/mosaic_bisect.py:54"),
        ("probe_shifted_dots", "tools/mosaic_bisect.py:66"),
        ("probe_bias", "tools/mosaic_bisect.py:85"),
        ("probe_rows_int", "tools/mosaic_bisect2.py:24"),
        ("probe_rows_slice", "tools/mosaic_bisect2.py:24"),
        ("probe_col_int", "tools/mosaic_bisect2.py:24"),
        ("probe_col_newaxis", "tools/mosaic_bisect2.py:24"),
        ("probe_dw_reshape", "tools/mosaic_bisect3.py:23"),
        ("probe_dw_batched", "tools/mosaic_bisect3.py:35"),
    ):
        rows = [c for c in probe_rows if c["probe"] == name]
        kernels.append(line(name, src_probes, replaces, tool_launches[name], rows,
                            [c["max_abs_err"] for c in rows]))
    # the int8 base conv (no TPU counterpart): one quantized model call's 10
    # convs at batch 1, bfloat16 out; launches are the bf16 quantized forecast's
    q8 = {(c["n"], c["cin"], c["cout"]): c for c in int8_cases
          if c["batch"] == 1 and c["dtype"] == "bfloat16"}
    kernels.append(line("cs_conv3x3_int8_base", "dlwp_cs_tpu_torch/csrc/cs_conv3x3_int8.cu", "",
                        quant["bfloat16"]["launches"]["forecast"]["cs_conv3x3_int8_base"],
                        [q8[s] for s in FLAGSHIP_CONVS], [c["max_abs_err"] for c in int8_cases],
                        peak=torch.int8))
    kernels[-1]["replaces_note"] = "no TPU counterpart"
    # this slice's training under a mesh, bf16: launches per step and each
    # rank's median step time, per path that launches the kernel
    for entry in kernels:
        entry["mesh_train"] = [
            {"path": r["path"], "launches_per_step": r["launches_per_step"][entry["name"]],
             "step_ms_median_per_rank": r["step_ms_median_per_rank"]}
            for r in mesh_train if r["dtype"] == "bfloat16"
            and entry["name"] in r.get("launches_per_step", {}) and "step_ms_median_per_rank" in r]
    # the example workflows: each kernel's launches per example
    for entry in kernels:
        entry["examples"] = {key: r["launches"][entry["name"]] for key, r in examples.items()
                             if isinstance(r, dict) and entry["name"] in r.get("launches", {})}
    # the measurement tools: each kernel's launches per tool run; #1's
    # streamed weights at the capacity sweep's refused bf16 shapes (batch 8)
    # with their launches a capacity step
    for entry in kernels:
        entry["bench_tools"] = {key: lw[entry["name"]] for key, lw in bench["launches"].items()
                                if entry["name"] in lw}
    def shape_launches(entries, c):
        """The launches of ``entries`` (``[{"n", "cin", "cout", "launches"}]``)
        at the shape of ``c``."""
        return sum(e["launches"] for e in entries
                   if (e["n"], e["cin"], e["cout"]) == (c["n"], c["cin"], c["cout"]))

    # the streamed launches as cs_conv3x3.stream_launches counted them: in
    # the counted step of each capacity configuration, and in the whole run
    kernels[0]["streamed"] = [
        {k: c[k] for k in ("n", "cin", "cout", "batch", "plan", "max_abs_err", "ms",
                           "plain_ms", "library_ms", "bound_ms", "bound_by")}
        | {"launches_per_capacity_step": {
            r["label"]: shape_launches(r["streamed"], c)
            for r in bench["rows"]["capacity_bench"] if shape_launches(r["streamed"], c)},
           "launches_in_capacity_run": shape_launches(
               bench["stream_launches"]["capacity_bench"], c)}
        for c in bench["streamed"] if c["dtype"] == "bfloat16" and c["batch"] == 8]
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "build_seconds": build_s, "registers": regs, "conv_cases": cases,
                   "bwd_cases": bwd, "ring_cases": ring, "block_cases": blocks,
                   "serve": list(serve.values()), "train": list(train.values()),
                   "ensemble": list(ensembles.values()),
                   "sharded": sharded, "sharded_exchange_ms": exchange,
                   "sharded_group_seconds": group_s, "remote_cases": remote,
                   "collective_cases": {str(k): v for k, v in coll.items()},
                   "tool_launches": tool_launches, "tools_seconds": tools_s,
                   "tool_rows": tool_rows, "mma_cases": mma,
                   "kernel_only_cases": only, "dx_ring_cases": ring_dx,
                   "lane_store_cases": stores, "lane_store_checks": store_checks,
                   "im2col_summary": summaries["im2col"],
                   "npack_summary": summaries["npack"], "refused_shape": refused,
                   "graph_replays": replays, "probe_cases": probe_rows,
                   "tc_cases": tc, "tc_summary": tc_sum, "ring_summary": ring_sum,
                   "probe_turn_cases": probes_turns, "probe_summary": probe_sum,
                   "export": exports, "http": web, "mesh_front_end": front, "mps": mps,
                   "mesh_train": mesh_train, "mesh_train_group_seconds": mesh_train_s,
                   "data": data, "int8_cases": int8_cases, "quant": list(quant.values()),
                   "quant_convlstm": quant_lstm, "quant_seconds": quant_s,
                   "latlon": latlon, "latlon_seconds": latlon_s,
                   "barotropic": baro, "barotropic_seconds": baro_s,
                   "utils": util, "utils_seconds": utils_s, "examples": examples,
                   "bench_tools": bench, "phase_seconds": dict(stamps), "kernels": kernels},
                  f, indent=1)
    print("\n".join(recap))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
