"""Checkpoint / resume of the port's fused pipeline (pipeline/checkpoint.py),
and fused checkpoints that cross between the port and the reference; the
host pipeline's half is tests/test_torch_checkpoint_host.py.

The pipelines run tests/test_torch_fused.py's small configuration (IMU
on, keyframes every 0.08 m, a 3-keyframe ring), on the CPU.

Tolerances, with their reasons:
  - a round trip in one package: every state leaf, host counter, buffer
    and ledger entry is equal bit for bit, and since the CPU ops are
    deterministic and the priorities are drawn from the checkpointed
    counters, the resumed run continues bit for bit as the uninterrupted
    one did;
  - a checkpoint written by one package and loaded by the other: every
    leaf and host array equal (the same .npz keys, leaf order and dtypes);
  - a run resumed in the port from the reference's checkpoint, against the
    reference's own continuation: tests/test_torch_fused.py's and
    tests/test_torch_slam.py's tolerances, with the reference's priorities
    injected as those files inject them (the jax PRNG cannot be matched bit
    for bit): equal event types and keyframe counts, keyframe positions
    within 1 cm.
"""

import numpy as np
import pytest

import jax

from dmsa_lidar_slam_tpu.io.synthetic import SyntheticSequence
from dmsa_lidar_slam_tpu.pipeline import checkpoint as jck
from dmsa_lidar_slam_tpu.pipeline import fused as jfused
from dmsa_lidar_slam_tpu_torch import convert
from dmsa_lidar_slam_tpu_torch.pipeline import checkpoint as tck
from dmsa_lidar_slam_tpu_torch.pipeline import fused as tfused
from tests.test_pipeline import small_config
from tests.torch_parity import jax_step_priorities

PTS = 700
SAVE_AT, RESUME_TO = 5, 7
KF_POS_ATOL = 1e-2


def _config():
    return small_config(use_imu=True, imu_factor_weight_submap=0.001, dist_new_keyframe=0.08, last_n_keyframes_for_optim=3)


def _sequence():
    return SyntheticSequence(rng=np.random.default_rng(11), noise_std=0.01, room_scale=0.45)


def _drive(slam, seq, start, stop):
    """Scans [start, stop) of seq with their IMU, as tests/test_torch_fused.py."""
    imu_cursor = seq.t_start - 0.2 if start == 0 else seq.t_start + start * seq.sweep
    for i in range(start, stop):
        t_end = seq.t_start + (i + 1) * seq.sweep
        ts, acc, gyr = seq.imu_samples(imu_cursor, t_end)
        slam.process_imu_batch(acc, gyr, ts)
        imu_cursor = t_end
        slam.process_scan(*seq.scan(i, PTS))


def _port_fused():
    return tfused.FusedDmsaSlam(_config(), flush_every=4, device="cpu")


def _port_leaves(slam):
    return convert.state_leaves(convert.state_to_numpy(slam.state))


def _equal_leaves(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, i
        np.testing.assert_array_equal(x, y, err_msg=f"leaf{i}")


def _equal_output(a, b):
    assert a.order_is_key == b.order_is_key
    assert len(a.static_keyframes) == len(b.static_keyframes)
    for (s1, t1, o1), (s2, t2, o2) in zip(a.static_keyframes, b.static_keyframes):
        assert s1 == s2
        np.testing.assert_array_equal(t1, t2)
        np.testing.assert_array_equal(o1, o2)
    assert len(a.non_keyframes) == len(b.non_keyframes)
    for n1, n2 in zip(a.non_keyframes, b.non_keyframes):
        assert (n1.stamp, n1.relative, n1.related_keyframe_id) == (n2.stamp, n2.relative, n2.related_keyframe_id)
        np.testing.assert_array_equal(n1.transl, n2.transl)
        np.testing.assert_array_equal(n1.orient, n2.orient)


_FUSED_HOST = ("scan_counter", "_flushed_upto", "time_initialized", "received_imu", "_prev_window_t0", "_stamp_base",
               "_scan_minmax", "_window_t0_history")


def _equal_fused_host(a, b):
    for name in _FUSED_HOST:
        assert getattr(a, name) == getattr(b, name), name
    assert a.config.use_imu == b.config.use_imu
    for x, y in zip(a.buffered_scan, b.buffered_scan):
        np.testing.assert_array_equal(x, y)
    for f in ("acc", "gyr", "stamps", "bias_gyr", "acc_init"):
        np.testing.assert_array_equal(getattr(a.imu_buffer, f), getattr(b.imu_buffer, f), err_msg=f)
    assert (a.imu_buffer.next_idx, a.imu_buffer.num_updates) == (b.imu_buffer.next_idx, b.imu_buffer.num_updates)
    _equal_output(a.output, b.output)


@pytest.fixture(scope="module")
def port_fused_saved(tmp_path_factory):
    """The port's fused run saved after SAVE_AT scans."""
    slam = _port_fused()
    _drive(slam, _sequence(), 0, SAVE_AT)
    path = str(tmp_path_factory.mktemp("ck") / "port_fused.npz")
    tck.save_fused_checkpoint(slam, path)
    assert slam.kf_count >= 2
    return slam, path


def test_fused_roundtrip_in_the_port(port_fused_saved):
    slam, path = port_fused_saved
    resumed = tck.load_fused_checkpoint(_port_fused(), path)
    assert resumed.state.scan_pts.device.type == "cpu"
    _equal_leaves(_port_leaves(resumed), _port_leaves(slam))
    _equal_fused_host(resumed, slam)
    # both continue bit for bit
    _drive(slam, _sequence(), SAVE_AT, RESUME_TO)
    _drive(resumed, _sequence(), SAVE_AT, RESUME_TO)
    slam._flush_events()
    resumed._flush_events()
    assert resumed.kf_count == slam.kf_count
    _equal_leaves(_port_leaves(resumed), _port_leaves(slam))
    _equal_output(resumed.output, slam.output)


def test_port_fused_checkpoint_loads_into_the_reference(port_fused_saved):
    _, path = port_fused_saved
    ref = jck.load_fused_checkpoint(jfused.FusedDmsaSlam(_config(), flush_every=4), path)
    port = tck.load_fused_checkpoint(_port_fused(), path)
    _equal_leaves(jax.tree.leaves(ref.state), _port_leaves(port))
    _equal_fused_host(ref, port)


def test_reference_fused_checkpoint_resumes_in_the_port(tmp_path):
    """The reference (its tabular path, DMSA_FUSED_TABULAR=1) runs SAVE_AT
    scans and saves; the port loads every leaf as saved and continues with
    the reference's priorities; the reference continues too."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMSA_FUSED_TABULAR", "1")
        ref = jfused.FusedDmsaSlam(_config(), flush_every=4)
    _drive(ref, _sequence(), 0, SAVE_AT)
    path = str(tmp_path / "ref_fused.npz")
    jck.save_fused_checkpoint(ref, path)
    port = tck.load_fused_checkpoint(_port_fused(), path)
    port.priorities = lambda seed: jax_step_priorities(seed, port.shapes)
    _equal_leaves(_port_leaves(port), jax.tree.leaves(ref.state))
    _equal_fused_host(port, ref)

    _drive(ref, _sequence(), SAVE_AT, RESUME_TO)
    _drive(port, _sequence(), SAVE_AT, RESUME_TO)
    ref._flush_events()
    port._flush_events()
    assert port.kf_count == ref.kf_count >= 2
    np.testing.assert_array_equal(port.state.events[:, 0].numpy(), np.asarray(ref.state.events)[:, 0])
    js, jt, _ = ref.keyframe_poses()
    ts, tt_, _ = port.keyframe_poses()
    np.testing.assert_allclose(ts, js, atol=1e-9)
    np.testing.assert_allclose(tt_, jt, atol=KF_POS_ATOL)
    assert port.output.order_is_key == ref.output.order_is_key


def test_wrong_kind_or_version_is_refused(port_fused_saved, tmp_path):
    z = dict(np.load(port_fused_saved[1]))
    z["meta"] = np.asarray(str(z["meta"]).replace('"kind": "fused", ', ''))
    host_like = str(tmp_path / "host_like.npz")
    np.savez(host_like, **z)
    with pytest.raises(ValueError, match="not a fused"):
        tck.load_fused_checkpoint(_port_fused(), host_like)
    z = dict(np.load(port_fused_saved[1]))
    z["meta"] = np.asarray(str(z["meta"]).replace('"version": 3', '"version": 2'))
    bad = str(tmp_path / "v2.npz")
    np.savez(bad, **z)
    with pytest.raises(ValueError, match="version 2"):
        tck.load_fused_checkpoint(_port_fused(), bad)
