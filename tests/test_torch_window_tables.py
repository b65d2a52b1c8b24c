"""K6's wrapper (trajectory/continuous.py window_tables) and the optimizer's
use of it, on the CPU:

  - the reference path (torch.func's jacfwd and vmap over the window's
    table builder) returns the kernel's layout and dtypes in both modes;
  - the window's TabularProblem supplies the entries, as the submap's
    does (K7), and past K6's control poses the window keeps them and K6
    raises;
  - optimize on CPU tensors takes torch.func as before, bit for bit a
    TabularProblem without the entry, and never launches K6;
  - the window's forward read from the table is make_forward's, bit for
    bit;
  - K6's source, built for the host (tests/cuda_host.py), against the
    reference in every regime of tests/torch_window.py, in both modes and
    with and without IMU residuals.
"""

import numpy as np
import pytest
import torch

from dmsa_lidar_slam_tpu_torch.dmsa import optimizer as opt
from dmsa_lidar_slam_tpu_torch.io.synthetic import room_scene, sample_scene_points
from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm
from dmsa_lidar_slam_tpu_torch.ops import cuda_lib
from dmsa_lidar_slam_tpu_torch.core import rotations as rot
from dmsa_lidar_slam_tpu_torch.trajectory import continuous as ct
from tests import torch_window as tw
from tests.cuda_host import build_host
from tests.torch_parity import nn


@pytest.mark.parametrize("use_imu", [True, False])
def test_reference_path_has_the_kernel_layout(use_imu):
    shapes, data, params = tw.window_problem(1)
    p_dim, rows, e = params.shape[0], shapes.n_dense + 1, (shapes.n_ctrl - 1 if use_imu else 0)
    tab, extra, dtab, j_extra = ct.window_tables(params, data, shapes, use_imu)
    assert (tab.shape, tab.dtype) == ((rows, 8), torch.float32)
    assert (extra.shape, extra.dtype) == ((e,), torch.float64)
    assert (dtab.shape, dtab.dtype) == ((p_dim, rows, 8), torch.float32)
    assert (j_extra.shape, j_extra.dtype) == ((p_dim, e), torch.float64)
    assert torch.equal(tab[-1], torch.tensor([1.0, 0, 0, 0, 0, 0, 0, 0]))
    assert not tab[:, 7].any() and not dtab[:, -1].any() and not dtab[:, :, 7].any()
    cands = tw.candidates(params, 1)
    tabs, extras = ct.window_tables_batch(cands, data, shapes, use_imu)
    k = cands.shape[0]
    assert (tabs.shape, tabs.dtype) == ((k, rows, 8), torch.float32)
    assert (extras.shape, extras.dtype) == ((k, e), torch.float64)
    assert torch.allclose(tabs[0], tab) and torch.allclose(extras[0], extra)


def test_window_and_submap_supply_all_three_entries():
    shapes = ct.WindowShapes(n_window_pts=64, n_static=16)
    window = ct.make_tabular(shapes, True)
    assert None not in (window.tables_jac, window.tables_batch, window.forward_tab)
    submap = kfm.make_tabular(kfm.MapShapes(n_keyframes=4, n_pts_per_kf=64), True, True, True)
    assert None not in (submap.tables_jac, submap.tables_batch, submap.forward_tab)


def test_past_the_kernels_control_poses_the_window_keeps_the_entry_and_k6_raises():
    """No quiet fall-back: a window with more control poses than K6 takes
    still gets K6's entry, and K6 refuses it (before it touches a card)."""
    shapes, data, params = tw.window_problem(8, n_ctrl=ct.K6_MAX_CTRL + 1, n_dense=16 * ct.K6_MAX_CTRL + 1)
    assert ct.make_tabular(shapes, True).tables_jac is not None
    with pytest.raises(ValueError, match="control poses"):
        ct._k6_launch(params, 0, data, shapes, True, None, None, None, None)


def test_grid_consts_have_storage_after_torch_func(monkeypatch):
    """K6 reads the grid operators by pointer: they stay plain tensors when
    torch.func made the window's tables first (continuous._uniform_consts,
    filled inside jacfwd, caches wrapped tensors without storage)."""
    monkeypatch.setattr(ct, "_CONST_CACHE", {})
    ct.grid_consts.cache_clear()
    shapes, data, params = tw.window_problem(2)
    torch.func.jacfwd(lambda p: ct._window_tables(p, data, shapes, True))(params)
    for t in ct.grid_consts(shapes, torch.device("cpu")):
        assert t.data_ptr() != 0


def _scene_window(seed, n_pts=3000, n_static=500, n_dense=101):
    """A window of room points (scaled room, enough cells for P = 30) seen
    from the tables at known params, and params perturbed from them."""
    shapes0, data, params = tw.window_problem(seed, n_dense=n_dense)
    shapes = ct.WindowShapes(n_window_pts=n_pts, n_static=n_static, n_ctrl=shapes0.n_ctrl, n_dense=n_dense)
    rng = np.random.default_rng(seed)
    world = torch.as_tensor(sample_scene_points(rng, n_pts + n_static, planes=room_scene(0.45)),
                            dtype=torch.float32)
    world = world + 0.005 * torch.as_tensor(rng.standard_normal(world.shape), dtype=torch.float32)
    tab, _ = ct._window_tables(params, data, shapes, True)
    tidx = torch.as_tensor(rng.integers(0, n_dense, n_pts))
    q = tab[tidx, 0:4]
    local = rot.quat_rotate(torch.cat([q[:, :1], -q[:, 1:]], dim=1), world[:n_pts] - tab[tidx, 4:7])
    data = data._replace(
        local_pts=local, pt_mask=torch.ones(n_pts, dtype=torch.bool),
        pt_ring=torch.as_tensor(rng.integers(0, 16, n_pts), dtype=torch.int32), pt_tform_idx=tidx,
        static_pts=world[n_pts:], static_mask=torch.ones(n_static, dtype=torch.bool),
        static_ring=torch.as_tensor(rng.integers(0, 16, n_static), dtype=torch.int32),
    )
    params0 = params + 0.004 * torch.as_tensor(rng.standard_normal(params.shape[0]))
    return shapes, data, params0


def test_optimize_on_cpu_takes_torch_func_bit_for_bit(monkeypatch):
    shapes, data, params0 = _scene_window(3)
    settings = opt.OptimSettings(num_iter=3, min_num_points_per_set=6, min_num_gaussians=10, step_length_optim=0.3)
    fwd = ct.make_forward(shapes, True)
    with_entry = ct.make_tabular(shapes, True)
    without = opt.TabularProblem(with_entry.n_table, with_entry.tables, with_entry.point_arrays)
    calls = {"jacfwd": 0, "vmap": 0}
    for name in calls:
        real = getattr(torch.func, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(torch.func, name, counted)
    launches = cuda_lib.LAUNCHES["window_tables"]
    got = opt.optimize(fwd, params0, data, settings, 0.25, tabular_fn=with_entry)
    used = dict(calls)
    want = opt.optimize(fwd, params0, data, settings, 0.25, tabular_fn=without)
    assert cuda_lib.LAUNCHES["window_tables"] == launches
    iters = int(got.num_iters)
    assert iters >= 2 and int(got.stop_reason) != opt.STOP_TOO_FEW_GAUSSIANS
    assert used["jacfwd"] >= iters and used["vmap"] >= iters
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_forward_from_the_table_is_make_forward():
    shapes, data, params = _scene_window(4, n_pts=400, n_static=50)
    tab, extra = ct._window_tables(params, data, shapes, True)
    got = ct.make_tabular(shapes, True).forward_tab(tab, extra, data)
    want = ct.make_forward(shapes, True)(params, data)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.fixture(scope="module")
def k6_host(tmp_path_factory):
    """csrc/k6_window_tables.cu built with g++ under tests/cuda_host_emu.h."""
    return build_host("k6_window_tables.cu", "k6_window_tables", cuda_lib._SIGNATURES["k6_window_tables"],
                      tmp_path_factory.mktemp("k6_host"))


def _host_call(lib, params, data, shapes, use_imu, n_sets):
    """k6_window_tables on host buffers, as continuous.window_tables launches it."""
    c, d = shapes.n_ctrl, shapes.n_dense
    p_dim, e = 6 * (c - 1), (c - 1 if use_imu else 0)
    a_mat, left, right, u = ct.grid_consts(shapes, torch.device("cpu"))
    ops = [data.anchor_orient, data.anchor_transl, a_mat, left, right, u, data.dt, data.ctrl_stamps, data.gravity,
           data.preint_rot, data.preint_vel, data.preint_pos, data.cov_inv, data.balancing_imu]
    ops = [t.contiguous() for t in ops]
    params = params.contiguous()
    rows = d + 1
    if n_sets:
        outs = [torch.zeros(n_sets, rows, 8), torch.zeros(n_sets, e, dtype=torch.float64), None, None]
    else:
        outs = [torch.zeros(rows, 8), torch.zeros(e, dtype=torch.float64), torch.zeros(p_dim, rows, 8),
                torch.zeros(p_dim, e, dtype=torch.float64)]
    ptr = [None if t is None else t.data_ptr() for t in outs]
    err = lib.k6_window_tables(params.data_ptr(), n_sets, p_dim, c, d, int(use_imu),
                               *[t.data_ptr() for t in ops], *ptr, None)
    assert err == 0
    return [t for t in outs if t is not None]


@pytest.mark.parametrize("use_imu", [True, False])
@pytest.mark.parametrize("regime", tw.REGIMES)
def test_k6_source_on_the_host(k6_host, regime, use_imu):
    shapes, data, params = tw.window_problem(5, regime)
    got = _host_call(k6_host, params, data, shapes, use_imu, 0)
    tw.check_tables(got, ct.window_tables_ref(params, data, shapes, use_imu))
    cands = tw.candidates(params, 6)
    got = _host_call(k6_host, cands, data, shapes, use_imu, cands.shape[0])
    tw.check_batch(got, ct.window_tables_batch_ref(cands, data, shapes, use_imu))
    np.testing.assert_array_equal(nn(got[0][0]), nn(_host_call(k6_host, params, data, shapes, use_imu, 0)[0]))
