"""K7's wrapper (map/keyframes.py keyframe_tables) and the optimizer's use
of it, on the CPU:

  - the reference path (torch.func's jacfwd and vmap over the submap's
    table builder) returns the kernel's layout and dtypes in both modes;
  - optimize on CPU tensors takes torch.func as before, bit for bit a
    TabularProblem without the entries, and never launches K7;
  - the submap's forward read from the table is make_forward's, bit for
    bit, with and without the split channel;
  - past K7's keyframes the submap keeps the entry and K7 raises;
  - K7's source, built for the host (tests/cuda_host.py), against the
    reference in every regime of tests/torch_keyframes.py, at S = 2, 5, 48
    and the kernel's maximum, in both modes and the four combinations of
    the gravity and odometry terms.
"""

import numpy as np
import pytest
import torch

from dmsa_lidar_slam_tpu_torch.dmsa import optimizer as opt
from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm
from dmsa_lidar_slam_tpu_torch.ops import cuda_lib
from dmsa_lidar_slam_tpu_torch.pipeline.metrics import Metrics
from tests import torch_keyframes as tk
from tests.cuda_host import build_host
from tests.torch_parity import nn
from tests.torch_window import candidates, check_batch, check_tables


@pytest.mark.parametrize("use_gravity,use_odometry", tk.FLAGS)
def test_reference_path_has_the_kernel_layout(use_gravity, use_odometry):
    shapes, data, params = tk.keyframe_problem(1, s=6)
    s, p_dim = shapes.n_keyframes, params.shape[0]
    rows, e = s + 1, (s if use_gravity else 0) + (s - 1 if use_odometry else 0)
    tab, extra, dtab, j_extra = kfm.keyframe_tables(params, data, shapes, use_gravity, use_odometry)
    assert (tab.shape, tab.dtype) == ((rows, 8), torch.float32)
    assert (extra.shape, extra.dtype) == ((e,), torch.float64)
    assert (dtab.shape, dtab.dtype) == ((p_dim, rows, 8), torch.float32)
    assert (j_extra.shape, j_extra.dtype) == ((p_dim, e), torch.float64)
    assert torch.equal(tab[-1], torch.tensor([1.0, 0, 0, 0, 0, 0, 0, 0]))
    assert not tab[:, 7].any() and not dtab[:, -1].any() and not dtab[:, :, 7].any()
    cands = candidates(params, 1)
    tabs, extras = kfm.keyframe_tables_batch(cands, data, shapes, use_gravity, use_odometry)
    k = cands.shape[0]
    assert (tabs.shape, tabs.dtype) == ((k, rows, 8), torch.float32)
    assert (extras.shape, extras.dtype) == ((k, e), torch.float64)
    assert torch.equal(tabs[0], tab) and torch.equal(extras[0], extra)


def test_past_the_kernels_keyframes_the_submap_keeps_the_entry_and_k7_raises():
    """No quiet fall-back: a submap of more keyframes than K7 takes still
    gets K7's entry, and K7 refuses it (before it touches a card)."""
    shapes, data, params = tk.keyframe_problem(8, s=kfm.K7_MAX_KF + 1, ppk=4)
    assert kfm.make_tabular(shapes, True, False).tables_jac is not None
    with pytest.raises(ValueError, match="keyframes"):
        kfm._k7_launch(params, 0, data, shapes, True, False, None, None, None, None)


def test_optimize_on_cpu_takes_torch_func_bit_for_bit(monkeypatch):
    shapes, data, params0 = tk.scene_submap(3)
    settings = opt.OptimSettings(num_iter=3, min_num_points_per_set=6, min_num_gaussians=10, step_length_optim=0.3)
    fwd = kfm.make_forward(shapes, True, True, True)
    with_entry = kfm.make_tabular(shapes, True, True, True)
    without = opt.TabularProblem(with_entry.n_table, with_entry.tables, with_entry.point_arrays)
    calls = {"jacfwd": 0, "vmap": 0}
    for name in calls:
        real = getattr(torch.func, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(torch.func, name, counted)
    launches = cuda_lib.LAUNCHES["keyframe_tables"]
    got = opt.optimize(fwd, params0, data, settings, 0.25, tabular_fn=with_entry)
    used = dict(calls)
    want = opt.optimize(fwd, params0, data, settings, 0.25, tabular_fn=without)
    assert cuda_lib.LAUNCHES["keyframe_tables"] == launches
    iters = int(got.num_iters)
    assert iters >= 2 and int(got.stop_reason) != opt.STOP_TOO_FEW_GAUSSIANS
    assert used["jacfwd"] >= iters and used["vmap"] >= iters
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_tables_kernel_counter_reads_zero_on_the_cpu():
    """submap.gn.tables_kernel counts K7's calls: none on CPU tensors."""
    shapes, data, params0 = tk.scene_submap(3)
    settings = opt.OptimSettings(num_iter=2, min_num_points_per_set=6, min_num_gaussians=10, step_length_optim=0.3)
    m = Metrics()
    opt.optimize(kfm.make_forward(shapes, True, True, True), params0, data, settings, 0.25,
                 tabular_fn=kfm.make_tabular(shapes, True, True, True), metrics=m, name="submap")
    assert m.counters["submap.gn.iters"] >= 1 and m.counters["submap.gn.tables_kernel"] == 0


@pytest.mark.parametrize("use_split", [True, False])
@pytest.mark.parametrize("use_gravity,use_odometry", tk.FLAGS)
def test_forward_from_the_table_is_make_forward(use_gravity, use_odometry, use_split):
    shapes, data, params = tk.keyframe_problem(4, "inactive", s=7, ppk=50)
    tab, extra = kfm._kf_tables(params, data, shapes, use_gravity, use_odometry)
    got = kfm.make_tabular(shapes, use_gravity, use_odometry, use_split).forward_tab(tab, extra, data)
    want = kfm.make_forward(shapes, use_gravity, use_odometry, use_split)(params, data)
    assert (got.split_ids is None) == (not use_split)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


def test_without_use_split_the_optimizer_keeps_its_forward():
    """make_tabular's default leaves the forward to the optimizer (a forward
    with observation weights keeps them)."""
    shapes = kfm.MapShapes(n_keyframes=4, n_pts_per_kf=8)
    assert kfm.make_tabular(shapes, True, True).forward_tab is None


@pytest.fixture(scope="module")
def k7_host(tmp_path_factory):
    """csrc/k7_keyframe_tables.cu built with g++ under tests/cuda_host_emu.h."""
    return build_host("k7_keyframe_tables.cu", "k7_keyframe_tables", cuda_lib._SIGNATURES["k7_keyframe_tables"],
                      tmp_path_factory.mktemp("k7_host"))


def _host_call(lib, params, data, shapes, use_gravity, use_odometry, n_sets):
    """k7_keyframe_tables on host buffers, as keyframes.keyframe_tables
    launches it (every operand given: the kernel reads only its terms')."""
    s = shapes.n_keyframes
    p_dim, e = 6 * (s - 1), (s if use_gravity else 0) + (s - 1 if use_odometry else 0)
    ops = [data.anchor_orient, data.anchor_transl, data.kf_mask, data.grav_plausible, data.grav_meas, data.gravity,
           data.cov_grav_inv, data.balancing_grav, data.odom_rel_transl, data.odom_rel_orient,
           data.odom_transl_cov_inv, data.odom_orient_cov_inv, data.balancing_odom]
    ops = [t.contiguous() for t in ops]
    params = params.contiguous()
    rows = s + 1
    if n_sets:
        outs = [torch.zeros(n_sets, rows, 8), torch.zeros(n_sets, e, dtype=torch.float64), None, None]
    else:
        outs = [torch.zeros(rows, 8), torch.zeros(e, dtype=torch.float64), torch.zeros(p_dim, rows, 8),
                torch.zeros(p_dim, e, dtype=torch.float64)]
    ptr = [None if t is None else t.data_ptr() for t in outs]
    err = lib.k7_keyframe_tables(params.data_ptr(), n_sets, p_dim, s, int(use_gravity), int(use_odometry),
                                 *[t.data_ptr() for t in ops], *ptr, None)
    assert err == 0
    return [t for t in outs if t is not None]


@pytest.mark.parametrize("s", [2, 5, 48, kfm.K7_MAX_KF])
@pytest.mark.parametrize("regime", tk.REGIMES)
def test_k7_source_on_the_host(k7_host, regime, s):
    shapes, data, params = tk.keyframe_problem(5, regime, s=s, ppk=4)
    cands = candidates(params, 6)
    for use_gravity, use_odometry in tk.FLAGS:
        flags = (shapes, use_gravity, use_odometry)
        got = _host_call(k7_host, params, data, *flags, 0)
        check_tables(got, kfm.keyframe_tables_ref(params, data, *flags))
        batch = _host_call(k7_host, cands, data, *flags, cands.shape[0])
        check_batch(batch, kfm.keyframe_tables_batch_ref(cands, data, *flags))
        # candidate 0 is the unstepped params: the jacobian mode's table
        np.testing.assert_array_equal(nn(batch[0][0]), nn(got[0]))
        np.testing.assert_array_equal(nn(batch[1][0]), nn(got[1]))
