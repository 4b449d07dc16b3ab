"""The operation and byte counts of ``counts.py`` on hand-worked shapes."""

import pytest
import torch

from portbench import counts


def test_least_seconds_takes_the_larger_bound():
    assert counts.least_seconds(3.35e12, 0.0) == pytest.approx(1.0)
    assert counts.least_seconds(0.0, 67e12) == pytest.approx(1.0)
    assert counts.least_seconds(3.35e12, 134e12) == pytest.approx(2.0)


def test_s2dnet_convolutions():
    # 2 x 3 pixels: 2 FLOPs a multiply-add of each convolution
    macs = 3 * 64 * 9 + 64 * 64 * 9 + 64 * 64 + 64 * 128 * 25
    b, f = counts.s2dnet(2, 3)
    assert f == 2 * 6 * macs
    assert b == 4 * 6 * (3 + 128)


def test_k1_counts_shared_taps_once():
    C = 8
    rows = torch.zeros((16, 16, C), dtype=torch.bfloat16)   # one patch
    H, W = 16, 16
    row_base = torch.zeros(3, dtype=torch.int32)
    # two queries in one cell share all 16 taps; a third, 8 px away,
    # needs its own 16
    r = torch.tensor([5.2, 5.7, 5.2])
    c = torch.tensor([5.2, 5.9, 13.2])
    b, f = counts.k1(rows, H, W, C, row_base, r, c, l2=True)
    assert b == 32 * C * 2 + 12 * 3 + 12 * 3 * C
    assert f == 3 * C * (16 * 6 + 12)


def test_k1_clamps_taps_to_the_patch():
    rows = torch.zeros((16, 16, 1), dtype=torch.float32)
    b, _ = counts.k1(rows, 16, 16, 1, torch.zeros(1, dtype=torch.int32),
                     torch.tensor([0.1]), torch.tensor([0.1]), l2=False)
    # taps -1..2 clamp to 0..2 on each axis: 3 x 3 distinct pixels
    assert b == 9 * 4 + 12 + 12


def test_k2_and_k3():
    H = torch.zeros((5, 4, 4))
    g = torch.zeros((5, 4))
    b, f = counts.k2(H, g, iters=15, damp=g)
    assert b == 4 * (5 * 16 + 2 * 5 * 4 + 5 * 4)
    assert f == 15 * 5 * (2 * 16 + 10 * 4)
    ins = [torch.zeros(10), torch.zeros(3, dtype=torch.int32)]
    outs = (torch.zeros(2), torch.zeros(6))
    assert counts.k3(ins, outs) == (40 + 12 + 8 + 24, 0.0)
