"""Checkpoint / resume of the port's host pipeline DmsaSlam
(pipeline/checkpoint.py: save_checkpoint / load_checkpoint), and host
checkpoints that cross between the port and the reference.  The same
configuration, sequence and tolerances as tests/test_torch_checkpoint.py
(the fused half); the host half's resumed run in the port takes the
reference's priorities as tests/test_torch_slam.py injects them.
"""

import numpy as np
import pytest

from dmsa_lidar_slam_tpu.pipeline import checkpoint as jck
from dmsa_lidar_slam_tpu.pipeline.slam import DmsaSlam as JaxDmsaSlam
from dmsa_lidar_slam_tpu_torch.pipeline import checkpoint as tck
from dmsa_lidar_slam_tpu_torch.pipeline.slam import DmsaSlam
from tests.test_torch_checkpoint import KF_POS_ATOL, RESUME_TO, SAVE_AT, _config, _drive, _equal_output, _sequence
from tests.torch_parity import jax_counter_priorities

_KF_ATTRS = ("local_pts", "local_normals", "pt_mask", "pt_ring", "grid_size", "orient_w", "transl_w", "stamps",
             "grav_meas", "grav_plausible", "odom_rel_orient", "odom_rel_transl", "count", "num_updates")


def _equal_host(a, b):
    for f in _KF_ATTRS:
        np.testing.assert_array_equal(getattr(a.kf_map, f), getattr(b.kf_map, f), err_msg=f)
    for name in ("scan_updates", "time_initialized", "submap_initialized", "received_imu", "_prng_counter"):
        assert getattr(a, name) == getattr(b, name), name
    assert len(a.scan_buffer) == len(b.scan_buffer)
    for s1, s2 in zip(a.scan_buffer, b.scan_buffer):
        for x, y in zip(s1, s2):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(a.buffered_scan, b.buffered_scan):
        np.testing.assert_array_equal(x, y)
    assert (a.old_window is None) == (b.old_window is None)
    if a.old_window is not None:
        for f in ("orient_w", "transl_w", "ctrl_stamps", "t0", "horizon"):
            np.testing.assert_array_equal(getattr(a.old_window, f), getattr(b.old_window, f), err_msg=f)
    for f in ("acc", "gyr", "stamps", "bias_gyr", "acc_init"):
        np.testing.assert_array_equal(getattr(a.imu_buffer, f), getattr(b.imu_buffer, f), err_msg=f)
    _equal_output(a.output, b.output)


@pytest.fixture(scope="module")
def port_host_saved(tmp_path_factory):
    slam = DmsaSlam(_config(), device="cpu")
    _drive(slam, _sequence(), 0, SAVE_AT)
    path = str(tmp_path_factory.mktemp("ck") / "port_host.npz")
    tck.save_checkpoint(slam, path)
    assert slam.kf_map.count >= 2 and slam.old_window is not None
    return slam, path


def test_host_roundtrip_in_the_port(port_host_saved):
    slam, path = port_host_saved
    resumed = tck.load_checkpoint(DmsaSlam(_config(), device="cpu"), path)
    _equal_host(resumed, slam)
    _drive(slam, _sequence(), SAVE_AT, RESUME_TO)
    _drive(resumed, _sequence(), SAVE_AT, RESUME_TO)
    assert resumed.kf_map.count == slam.kf_map.count
    _equal_host(resumed, slam)


def test_port_host_checkpoint_loads_into_the_reference(port_host_saved):
    _, path = port_host_saved
    port = tck.load_checkpoint(DmsaSlam(_config(), device="cpu"), path)
    _equal_host(jck.load_checkpoint(JaxDmsaSlam(_config()), path), port)


def test_reference_host_checkpoint_resumes_in_the_port(tmp_path):
    ref = JaxDmsaSlam(_config())
    _drive(ref, _sequence(), 0, SAVE_AT)
    path = str(tmp_path / "ref_host.npz")
    jck.save_checkpoint(ref, path)
    port = tck.load_checkpoint(DmsaSlam(_config(), device="cpu"), path)
    port.priorities = jax_counter_priorities
    _equal_host(port, ref)

    _drive(ref, _sequence(), SAVE_AT, RESUME_TO)
    _drive(port, _sequence(), SAVE_AT, RESUME_TO)
    n = ref.kf_map.count
    assert port.kf_map.count == n >= 2 and port._prng_counter == ref._prng_counter
    np.testing.assert_allclose(port.kf_map.stamps[:n], ref.kf_map.stamps[:n], atol=1e-9)
    np.testing.assert_allclose(port.kf_map.transl_w[:n], ref.kf_map.transl_w[:n], atol=KF_POS_ATOL)
    assert port.output.order_is_key == ref.output.order_is_key
