"""A run with the timed path broken underneath comes out not correct: an
answer altered where it is produced (the ensemble mean, the spread), the
mean and spread taken over half of the members, and a rollout step that
returns its window unchanged.  One chip, so no exchange between chips to
leave out."""

from __future__ import annotations

import time

import pytest

from benchmark.run import run_cell
from benchmark.spec import Bench


def _run(root, cell):
    return run_cell(Bench(root), cell, 2**32 + 5, 0.5, False, device="cpu",
                    t_process=time.perf_counter())


@pytest.mark.parametrize("cell", ["unet-tiny.ens-tiny", "convlstm-tiny.ens-tiny"])
def test_sound_tiny_runs_are_correct(tiny_root, cell):
    assert _run(tiny_root, cell)["correct"] is True


def test_altered_ensemble_mean(tiny_root, monkeypatch):
    import dlwp_cs_tpu_torch.rollout.ensemble as ens

    orig = ens._mean_spread

    def altered(fields):
        mean, spread = orig(fields)
        return mean + 1e-3, spread

    monkeypatch.setattr(ens, "_mean_spread", altered)
    out = _run(tiny_root, "unet-tiny.ens-tiny")
    assert out["correct"] is False and out["checks"]["mean_err"]["value"] > 5e-4


def test_altered_ensemble_spread(tiny_root, monkeypatch):
    import dlwp_cs_tpu_torch.rollout.ensemble as ens

    orig = ens._mean_spread
    monkeypatch.setattr(ens, "_mean_spread", lambda f: (orig(f)[0], orig(f)[1] * 1.01))
    assert _run(tiny_root, "convlstm-tiny.ens-tiny")["correct"] is False


@pytest.mark.parametrize("cell", ["unet-tiny.ens-tiny", "convlstm-tiny.ens-tiny"])
def test_mean_and_spread_over_half_the_members(tiny_root, monkeypatch, cell):
    import dlwp_cs_tpu_torch.rollout.ensemble as ens

    orig = ens._mean_spread
    monkeypatch.setattr(ens, "_mean_spread", lambda f: orig(f[:, : (f.shape[1] + 1) // 2]))
    assert _run(tiny_root, cell)["correct"] is False


@pytest.mark.parametrize("cell", ["unet-tiny.ens-tiny", "convlstm-tiny.ens-tiny"])
def test_step_that_keeps_its_window(tiny_root, monkeypatch, cell):
    import dlwp_cs_tpu_torch.rollout.estimator as est

    orig = est.advance_window
    monkeypatch.setattr(est, "advance_window",
                        lambda window, out, t_out: (window, orig(window, out, t_out)[1]))
    out = _run(tiny_root, cell)
    assert out["correct"] is False and out["checks"]["mean_err"]["value"] > 1e-3
