"""K6 (trajectory/continuous.py window_tables, csrc/k6_window_tables.cu) on
a CUDA card against the path it replaces, torch.func's jacfwd and vmap over
the window's table builder (continuous._window_tables), run on the same
card, at WindowShapes(n_ctrl=6, n_dense=501):

  - tab and tabs to f32 rounding (both round f64 poses once to f32, the
    f64 values differing in the last bits: another summation order);
  - dtab per parameter relative to that parameter's largest entry;
  - extra and j_extra to f64 rounding, relative to their scale;
  - two calls give the same bits, in both modes;

in the regimes whose branches the kernel mirrors: window-scale random
parameters, zero relative rotations (axang2quat's series, identical
control orientations: slerp's `close` lerp), an identity chain
(quat2axang's small-|v| branch), equal consecutive control orientations
within a moving window, a negative quaternion dot (orientations across
pi), and the tiniest sample interval (no NaN).

This file imports neither jax nor the reference package:

    python -m pytest --noconftest -m gpu tests/test_torch_window_tables_card.py

Every test is marked `gpu` and skips without a card.
"""

import numpy as np
import pytest
import torch

from dmsa_lidar_slam_tpu_torch.ops import cuda_lib
from dmsa_lidar_slam_tpu_torch.trajectory import continuous as ct
from tests.torch_parity import nn, require_cuda
from tests.torch_window import REGIMES, candidates, check_batch, check_tables, window_problem


def _same_bits(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(nn(x), nn(y))


@pytest.mark.gpu
@pytest.mark.parametrize("use_imu", [True, False])
@pytest.mark.parametrize("regime", REGIMES)
def test_k6_jacobian_mode_on_card(regime, use_imu):
    require_cuda()
    shapes, data, params = window_problem(5, regime, device="cuda")
    before = cuda_lib.LAUNCHES["window_tables"]
    got = ct.window_tables(params, data, shapes, use_imu)
    again = ct.window_tables(params, data, shapes, use_imu)
    assert cuda_lib.LAUNCHES["window_tables"] == before + 2
    want = ct.window_tables_ref(params, data, shapes, use_imu)
    torch.cuda.synchronize()
    check_tables(got, want)
    _same_bits(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("use_imu", [True, False])
@pytest.mark.parametrize("regime", REGIMES)
def test_k6_batch_mode_on_card(regime, use_imu):
    require_cuda()
    shapes, data, params = window_problem(6, regime, device="cuda")
    cands = candidates(params, 6)
    got = ct.window_tables_batch(cands, data, shapes, use_imu)
    again = ct.window_tables_batch(cands, data, shapes, use_imu)
    want = ct.window_tables_batch_ref(cands, data, shapes, use_imu)
    torch.cuda.synchronize()
    check_batch(got, want)
    _same_bits(got, again)
    # candidate 0 is the unstepped params: the jacobian mode's table
    tab, extra, _, _ = ct.window_tables(params, data, shapes, use_imu)
    np.testing.assert_array_equal(nn(got[0][0]), nn(tab))
    np.testing.assert_array_equal(nn(got[1][0]), nn(extra))


@pytest.mark.gpu
def test_k6_enqueues_one_kernel_and_no_copy():
    """Each mode is one kernel on the card: no host read, no copy from a
    host list (under set_sync_debug_mode a blocking copy raises)."""
    require_cuda()
    from torch.profiler import ProfilerActivity, profile

    shapes, data, params = window_problem(7, device="cuda")
    cands = candidates(params, 7)
    ct.window_tables(params, data, shapes, True)
    ct.window_tables_batch(cands, data, shapes, True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ct.window_tables(params, data, shapes, True)
        ct.window_tables_batch(cands, data, shapes, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()  # those launches finish before the profile starts
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ct.window_tables(params, data, shapes, True)
        ct.window_tables_batch(cands, data, shapes, True)
        torch.cuda.synchronize()
    on_card = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [n for n in on_card if not n.startswith(("Memcpy", "Memset"))]
    assert len(kernels) == 2 and all("window_tables" in n for n in kernels), on_card
    assert not [n for n in on_card if n.startswith("Memcpy")], on_card
