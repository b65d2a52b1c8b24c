"""K7 (map/keyframes.py keyframe_tables, csrc/k7_keyframe_tables.cu) on a
CUDA card against the path it replaces, torch.func's jacfwd and vmap over
the submap's table builder (keyframes._kf_tables), run on the same card, at
the bench's submap (S = 48, P = 282) and the upstream ring (S = 100,
P = 594):

  - tab and tabs to f32 rounding (both round f64 poses once to f32, the
    f64 values differing in the last bits: another summation order);
  - dtab per parameter relative to that parameter's largest entry;
  - extra and j_extra to f64 rounding, relative to their scale;
  - two calls give the same bits, in both modes;
  - each mode is one kernel and no copy;
  - a submap solve on the card calls K7 twice an iteration
    (submap.gn.tables_kernel = 2 x submap.gn.iters);
  - the structured path's make_structured (the host pipeline's) launches
    K7 for the submap and K6 for the window once a call;

in every regime of tests/torch_keyframes.py and the four combinations of
the gravity and odometry terms.

This file imports neither jax nor the reference package:

    python -m pytest --noconftest -m gpu tests/test_torch_keyframe_tables_card.py

Every test is marked `gpu` and skips without a card.
"""

import numpy as np
import pytest
import torch

from dmsa_lidar_slam_tpu_torch.dmsa import optimizer as opt
from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm
from dmsa_lidar_slam_tpu_torch.ops import cuda_lib
from dmsa_lidar_slam_tpu_torch.pipeline.metrics import Metrics
from dmsa_lidar_slam_tpu_torch.trajectory import continuous as ct
from tests.torch_keyframes import FLAGS, REGIMES, keyframe_problem, scene_submap
from tests.torch_parity import nn, require_cuda
from tests.torch_window import candidates, check_batch, check_tables, window_problem


def _same_bits(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(nn(x), nn(y))


@pytest.mark.gpu
@pytest.mark.parametrize("s", [48, 100])
@pytest.mark.parametrize("regime", REGIMES)
def test_k7_jacobian_mode_on_card(regime, s):
    require_cuda()
    shapes, data, params = keyframe_problem(5, regime, s=s, ppk=8, device="cuda")
    for flags in FLAGS:
        before = cuda_lib.LAUNCHES["keyframe_tables"]
        got = kfm.keyframe_tables(params, data, shapes, *flags)
        again = kfm.keyframe_tables(params, data, shapes, *flags)
        assert cuda_lib.LAUNCHES["keyframe_tables"] == before + 2
        want = kfm.keyframe_tables_ref(params, data, shapes, *flags)
        torch.cuda.synchronize()
        check_tables(got, want)
        _same_bits(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [48, 100])
@pytest.mark.parametrize("regime", REGIMES)
def test_k7_batch_mode_on_card(regime, s):
    require_cuda()
    shapes, data, params = keyframe_problem(6, regime, s=s, ppk=8, device="cuda")
    cands = candidates(params, 6)
    for flags in FLAGS:
        got = kfm.keyframe_tables_batch(cands, data, shapes, *flags)
        again = kfm.keyframe_tables_batch(cands, data, shapes, *flags)
        want = kfm.keyframe_tables_batch_ref(cands, data, shapes, *flags)
        torch.cuda.synchronize()
        check_batch(got, want)
        _same_bits(got, again)
        # candidate 0 is the unstepped params: the jacobian mode's table
        tab, extra, _, _ = kfm.keyframe_tables(params, data, shapes, *flags)
        np.testing.assert_array_equal(nn(got[0][0]), nn(tab))
        np.testing.assert_array_equal(nn(got[1][0]), nn(extra))


@pytest.mark.gpu
def test_k7_enqueues_one_kernel_and_no_copy():
    """Each mode is one kernel on the card: no host read, no copy from a
    host list (under set_sync_debug_mode a blocking copy raises)."""
    require_cuda()
    from torch.profiler import ProfilerActivity, profile

    shapes, data, params = keyframe_problem(7, device="cuda")
    cands = candidates(params, 7)
    kfm.keyframe_tables(params, data, shapes, True, True)
    kfm.keyframe_tables_batch(cands, data, shapes, True, True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kfm.keyframe_tables(params, data, shapes, True, True)
        kfm.keyframe_tables_batch(cands, data, shapes, True, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()  # those launches finish before the profile starts
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        kfm.keyframe_tables(params, data, shapes, True, True)
        kfm.keyframe_tables_batch(cands, data, shapes, True, True)
        torch.cuda.synchronize()
    on_card = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [n for n in on_card if not n.startswith(("Memcpy", "Memset"))]
    assert len(kernels) == 2 and all("keyframe_tables" in n for n in kernels), on_card
    assert not [n for n in on_card if n.startswith("Memcpy")], on_card


@pytest.mark.gpu
def test_submap_solve_on_card_calls_k7_twice_an_iteration():
    """opt.optimize(name="submap") with the submap's TabularProblem, as
    pipeline/fused.py do_submap runs it: every iteration's tables and
    candidate tables are K7's."""
    require_cuda()
    shapes, data, params0 = scene_submap(3, device="cuda")
    settings = opt.OptimSettings(num_iter=4, min_num_points_per_set=6, min_num_gaussians=10, step_length_optim=0.3)
    m = Metrics()
    before = cuda_lib.LAUNCHES["keyframe_tables"]
    res = opt.optimize(kfm.make_forward(shapes, True, True, True), params0, data, settings, 0.25,
                       tabular_fn=kfm.make_tabular(shapes, True, True, True), metrics=m, name="submap")
    iters = m.counters["submap.gn.iters"]
    assert iters == int(res.num_iters) >= 1
    assert m.counters["submap.gn.tables_kernel"] == 2 * iters
    assert cuda_lib.LAUNCHES["keyframe_tables"] == before + 2 * iters


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["window", "keyframe"])
def test_structured_on_card_launches_its_table_kernel_once(kind):
    """make_structured on CUDA tensors takes its tables and their Jacobian
    from K6 (window) or K7 (submap): one launch a call, none of the other."""
    require_cuda()
    if kind == "window":
        shapes, data, params = window_problem(3, device="cuda")
        structured, mine, other = ct.make_structured(shapes, True), "window_tables", "keyframe_tables"
    else:
        shapes, data, params = keyframe_problem(3, s=48, ppk=8, device="cuda")
        structured, mine, other = kfm.make_structured(shapes, True, True, True), "keyframe_tables", "window_tables"
    before = dict(cuda_lib.LAUNCHES)
    out, contract, j_extra = structured(params, data)
    jp = contract(torch.ones_like(out.points))
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[mine] == before[mine] + 1
    assert cuda_lib.LAUNCHES[other] == before[other]
    assert j_extra.shape == (out.extra.shape[0], params.shape[0])
    assert bool(jp.isfinite().all()) and bool(out.points.isfinite().all())
