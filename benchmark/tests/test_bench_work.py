"""The FLOP and byte counts against hand counts."""

from __future__ import annotations

import pytest

from benchmark import work
from benchmark.spec import Bench
from benchmark.tests.conftest import REPO


@pytest.fixture(scope="module")
def bench():
    return Bench(REPO)


def _layers(bench, cfg):
    c = bench.cell(f"{cfg}.ens51-14d")["model"]
    return bench.flops(c["kind"]).conv_layers(c)


def test_unet_forward_flops(bench):
    px48, px24, px12 = 6 * 48 * 48, 6 * 24 * 24, 6 * 12 * 12
    macs = (px48 * 9 * (12 * 32 + 32 * 32 + 96 * 32 + 32 * 32)
            + px24 * 9 * (32 * 64 + 64 * 64 + 192 * 64 + 64 * 64)
            + px12 * 9 * (64 * 128 + 128 * 128) + px48 * 32 * 8)
    layers = _layers(bench, "unet-c48")
    assert work.forward_flops(layers, 1) == 2 * macs == 3_160_276_992
    assert work.forward_flops(layers, 51) == 51 * 2 * macs


def test_convlstm_forward_flops(bench):
    px = 6 * 48 * 48
    macs = px * (9 * (2 * 39 * 128 + 2 * 64 * 128) + 32 * 8)
    layers = _layers(bench, "convlstm-c48")
    assert work.forward_flops(layers, 1) == 2 * macs
    assert work.forward_flops(layers, 51) == 51 * 2 * macs


def test_conv_bound_by_hand():
    layers = [(48, 96, 32, 3, 2), (48, 32, 8, 1, 1)]  # the 1x1 head is not a 3x3 conv
    rows, peak, bw = 51, 165e12, 3.35e12
    cells = rows * 6 * 48 * 48
    fl = 2 * cells * 9 * 96 * 32
    nbytes = 4 * (cells * (96 + 32) + 2 * 9 * 96 * 32)
    want = 2 * max(fl / peak, nbytes / bw)  # the conv runs twice a call
    got = work.conv3x3_bound_s(layers, rows, peak_flops=peak, bytes_per_s=bw, dtype="float32")
    assert got == pytest.approx(want, rel=1e-12)
    assert fl / peak > nbytes / bw  # this conv is bound by its FLOPs
