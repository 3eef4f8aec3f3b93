"""Probabilistic verification of ensemble forecasts, on tensors.

The counterpart of ``dlwp_cs_tpu.verify.ensemble``, in torch where the
reference uses ``jnp``, so the scores reduce on the device that holds the
members (:class:`~dlwp_cs_tpu_torch.rollout.ensemble.EnsembleForecast`):

* :func:`crps_ensemble`: the continuous ranked probability score, fair
  (Ferro 2014) or standard, by the O(M log M) sorted Gini form rather than
  the O(M^2) pairwise differences.
* :func:`spread_error`: the RMSE of the ensemble mean and the mean spread
  per lead time (a reliable M-member ensemble has RMSE ~= spread *
  sqrt((M+1)/M)).
* :func:`rank_histogram`: verification-rank (Talagrand) histogram counts.

Inputs may be tensors or numpy arrays. Each function takes ``device``
(default: the GPU, as every entry point of the port) and reduces there;
the CPU tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch

from dlwp_cs_tpu_torch.device import resolve_device

__all__ = ["crps_ensemble", "rank_histogram", "spread_error"]


def _move_members_last(members, truth, member_axis, device):
    dev = resolve_device(device)
    members = torch.movedim(torch.as_tensor(members, device=dev), member_axis, -1)
    truth = torch.as_tensor(truth, device=dev)
    if truth.shape != members.shape[:-1]:
        raise ValueError(
            f"truth shape {tuple(truth.shape)} must equal members shape without the "
            f"member axis {tuple(members.shape[:-1])}"
        )
    return members, truth


def crps_ensemble(members, truth, *, member_axis: int = 1, fair: bool = True,
                  device=None):
    """Pointwise CRPS of an M-member ensemble against scalar truth.

    ``members``: the ensemble with its member axis at ``member_axis``
    (default 1, the ``EnsembleForecast.members`` layout ``(B, M, L, 6, n,
    n, C)``); ``truth``: the same shape without that axis.  Returns the CRPS
    per point (truth's shape).

    Estimator: ``E|X - y| - c * sum_{i,j} |x_i - x_j|`` with ``c = 1/(2 M
    (M-1))`` (fair) or ``1/(2 M^2)`` (standard); the pair sum by the sorted
    Gini identity ``sum_{i,j}|x_i - x_j| = 2 * sum_i (2i - M + 1) x_(i)``
    (ascending, i from 0).
    """
    members, truth = _move_members_last(members, truth, member_axis, device)
    m = members.shape[-1]
    mae = (members - truth[..., None]).abs().mean(dim=-1)
    if m == 1:
        return mae
    srt = torch.sort(members, dim=-1).values
    coef = 2.0 * torch.arange(m, dtype=srt.dtype, device=srt.device) - (m - 1)
    gini = 2.0 * (coef * srt).sum(dim=-1)  # sum_{i,j} |x_i - x_j|
    denom = 2.0 * m * (m - 1) if fair else 2.0 * m * m
    return mae - gini / denom


def spread_error(members, truth, *, member_axis: int = 1, lead_axis=None, device=None):
    """Spread-skill pair ``(rmse_of_mean, mean_spread)``: two ``(n_leads,)``
    curves, reduced over every axis but ``lead_axis`` (default: the axis
    after the member axis, ``EnsembleForecast.members``'s lead axis), the
    spread the quadratic mean of the ddof=1 member spread."""
    members, truth = _move_members_last(members, truth, member_axis, device)
    if members.shape[-1] < 2:
        raise ValueError(
            "spread_error needs >= 2 members (a ddof=1 spread is undefined for one)"
        )
    if lead_axis is None:
        # with the member axis moved last, the axis that followed it has
        # the member axis's old index
        lead_axis = member_axis % members.ndim
        if lead_axis >= members.ndim - 1:
            raise ValueError("no axis follows the member axis; pass lead_axis explicitly")
    mean = members.mean(dim=-1)
    var = members.var(dim=-1, correction=1)
    reduce_axes = tuple(a for a in range(mean.ndim) if a != lead_axis)
    rmse = torch.sqrt(torch.square(mean - truth).mean(dim=reduce_axes))
    spread = torch.sqrt(var.mean(dim=reduce_axes))
    return rmse, spread


def rank_histogram(members, truth, *, member_axis: int = 1, device=None):
    """Verification-rank histogram counts ``(M + 1,)``: the rank of truth in
    each sorted M-member ensemble (0: below every member, M: above every
    member), over all points.  A member equal to truth counts as above it
    (strict ``<``)."""
    members, truth = _move_members_last(members, truth, member_axis, device)
    m = members.shape[-1]
    ranks = (members < truth[..., None]).sum(dim=-1)
    return torch.bincount(ranks.reshape(-1), minlength=m + 1)
