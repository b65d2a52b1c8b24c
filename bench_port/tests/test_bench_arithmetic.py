"""The rate and tail arithmetic on hand-made timings."""

import pytest

from bench_port import harness


def test_rate_and_p90():
    scans = [0.9] * 36 + [1.5] * 4
    window = sum(scans) + 3 * 0.05  # three restores inside the window
    assert harness.realtime_x(len(scans), window) == pytest.approx(40 * 0.1 / window)
    assert harness.quantile(scans, 0.9) == pytest.approx(0.9 + 0.1 * 0.6)  # between order stats 36 and 37


def test_a_stall_moves_both():
    scans = [0.9] * 36 + [1.5] * 4
    stalled = list(scans)
    stalled[10] += 5.0
    stalled[11] += 5.0
    stalled[12] += 5.0
    stalled[13] += 5.0
    stalled[14] += 5.0
    r0 = harness.realtime_x(len(scans), sum(scans))
    r1 = harness.realtime_x(len(stalled), sum(stalled))
    assert r1 < r0 * 0.65
    assert harness.quantile(stalled, 0.9) > harness.quantile(scans, 0.9) + 0.5


def test_normals_share_ignores_the_sign():
    import torch

    from bench_port import compare

    g = torch.Generator().manual_seed(5)
    n = torch.nn.functional.normalize(torch.randn(100, 3, dtype=torch.float64, generator=g), dim=1)
    mask = torch.ones(100, dtype=torch.bool)
    assert compare.normals_share(n, -n, mask) == 0.0
    # ten normals tilted by 30 degrees (1 - cos = 0.134), the rest by 4 (0.0024)
    axis = torch.nn.functional.normalize(torch.linalg.cross(n, n.roll(1, dims=1), dim=1), dim=1)
    deg = torch.full((100, 1), 4.0, dtype=torch.float64)
    deg[:10] = 30.0
    rad = torch.deg2rad(deg)
    tilted = torch.cos(rad) * n + torch.sin(rad) * axis
    assert compare.normals_share(n, tilted, mask) == pytest.approx(0.1)
    mask[:10] = False
    assert compare.normals_share(n, tilted, mask) == 0.0


def test_ate_is_blind_to_the_frame_and_sees_a_stop():
    import numpy as np

    from bench_port import compare, generator

    truth = generator.truth(dict(mode="loop", p0=[0.0, 0.0, 1.4], loop_amp=[3.8, 2.6, 0.25], t_still=0.6,
                                 t_ramp=1.5))
    stamps = truth.t_start + 0.1 * np.arange(60)
    gt = np.asarray([truth.pose(s).position for s in stamps])
    c, s_ = np.cos(0.7), np.sin(0.7)
    R = np.array([[c, -s_, 0.0], [s_, c, 0.0], [0.0, 0.0, 1.0]])
    assert compare.ate_m(stamps, gt @ R.T + [1.0, -2.0, 0.5], truth) < 1e-9
    stopped = gt.copy()
    stopped[20:] = gt[19]
    assert compare.ate_m(stamps, stopped, truth) > 0.3


def test_merge_keeps_a_nan():
    import math

    from bench_port import compare

    assert math.isnan(compare.merge([dict(a=1.0), dict(a=float("nan")), dict(a=2.0)])["a"])
    assert compare.merge([dict(a=1.0), dict(a=3.0)])["a"] == 3.0
