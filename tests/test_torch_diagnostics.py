"""Port vs reference: the three diagnostics tools/bench_diag.py,
tools/diag_window_drift.py and tools/diag_imu_bias.py against their
counterparts tools/torch_bench_diag.py, tools/torch_diag_window_drift.py
and tools/torch_diag_imu_bias.py.

Each JAX tool runs as it is, its main() with its own argv, with `print`
in its module replaced by a recorder, so the test reads the values it
prints (the arrays and floats themselves where it prints them, the
formatted per-pose and per-scan lines otherwise); the window drift's test
is in tests/test_torch_diagnostics_drift.py, so that the two bench runs
take two test workers.  The bench tools run at
tests/test_torch_fused.py's small configuration and sequence, 12 scans of
800 points (bench_config / bench_sequence patched in the reference's
io.synthetic); the reference takes its tabular path (DMSA_FUSED_TABULAR=1)
and the port is fed the reference's PRNG bits, as in that file.

Tolerances, with their reasons:
  - the IMU factors at the true poses: the same f64 closed forms and
    preintegration, libm's last bits apart: the raw errors (~1e-13 at the
    truth) within 1e-9 absolute, the residuals and the information
    diagonal within rtol 1e-9;
  - bench_diag and window drift: tests/test_torch_fused.py's run
    tolerances: keyframe and retired counts, ledger poses and their kinds
    equal, every position (ATE, per-pose error, window control-pose error
    and its components) within KF_POS_ATOL = 1 cm, every angle within
    1e-2 rad (10 mrad), the keyframe rows' overlaps within OVERLAP_ATOL;
    each is compared at the precision the JAX tool prints.
"""

import importlib.util
import os
import re
import sys

import numpy as np
import pytest
import torch

from dmsa_lidar_slam_tpu.io import synthetic as jsyn
from dmsa_lidar_slam_tpu_torch.io import synthetic as tsyn
from dmsa_lidar_slam_tpu_torch.pipeline import fused as tfused
from tests.test_torch_fused import KF_POS_ATOL, N_SCANS, OVERLAP_ATOL, PTS, _config
from tests.torch_parity import jax_step_priorities

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANGLE_ATOL = 1e-2


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_tool(name, monkeypatch, argv=()):
    """Run the JAX tool's main(); the argument tuples of its prints."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))  # the tool sets it on import
    mod = _load(name)
    printed = []
    mod.print = lambda *args, **kw: printed.append(args)
    monkeypatch.setattr(sys, "argv", [name, *argv])
    mod.main()
    return printed


class _FewPoints:
    """A sequence whose scans take `pts` points whatever the caller asks."""

    def __init__(self, seq, pts):
        self._seq, self._pts = seq, pts

    def __getattr__(self, name):
        return getattr(self._seq, name)

    def scan(self, i, _n, n_rings=16):
        return self._seq.scan(i, self._pts, n_rings=n_rings)


def _small_sequence(module):
    return _FewPoints(module.SyntheticSequence(rng=np.random.default_rng(11), noise_std=0.01, room_scale=0.45), PTS)


def _patched_reference(monkeypatch):
    monkeypatch.setenv("DMSA_FUSED_TABULAR", "1")
    monkeypatch.setattr(jsyn, "bench_config", lambda use_imu=True: _config())
    monkeypatch.setattr(jsyn, "bench_sequence", lambda seed: _small_sequence(jsyn))


def _port_slam():
    slam = tfused.FusedDmsaSlam(_config(), flush_every=20, device="cpu")
    slam.priorities = lambda seed: jax_step_priorities(seed, slam.shapes)
    return slam


def _printed(printed, label):
    return next(args for args in printed if args and args[0] == label)


def test_imu_bias_matches_reference(monkeypatch):
    from tools.torch_diag_imu_bias import imu_bias

    printed = _run_jax_tool("diag_imu_bias", monkeypatch)
    got = imu_bias(torch.device("cpu"))
    assert float(_printed(printed, "resample timediff:")[1]) == got["timediff"]
    v = _printed(printed, "true v_lin:")
    np.testing.assert_array_equal(v[1], got["v_lin"])
    np.testing.assert_allclose(got["v_start"], v[3], rtol=1e-9, atol=1e-9)
    for label, key in (("rot_error:\n", "rot_error"), ("vel_error:\n", "vel_error"), ("pos_error:\n", "pos_error")):
        want = np.asarray(_printed(printed, label)[1])
        assert np.abs(want).max() < 1e-9  # zero-bias at the truth, in the reference
        np.testing.assert_allclose(got[key], want, rtol=0, atol=1e-9)
    for label, key in (("weighted residuals:", "residuals"), ("cov_inv diag magnitude:", "cov_inv_diag"),
                       ("residuals @ perturbed (0.01):", "residuals_perturbed")):
        np.testing.assert_allclose(got[key], np.asarray(_printed(printed, label)[1]), rtol=1e-9, atol=1e-9)
    assert np.all(got["residuals_perturbed"] > 1.0)  # the factors do react


def test_bench_diag_matches_reference(monkeypatch):
    from tools.torch_bench_diag import bench_diag

    _patched_reference(monkeypatch)
    printed = _run_jax_tool("bench_diag", monkeypatch, ["--scans", str(N_SCANS)])
    got = bench_diag(_port_slam(), _small_sequence(tsyn), N_SCANS, PTS)
    kf = _printed(printed, "keyframes:")
    assert (got["keyframes"], got["retired"]) == (kf[1], kf[3])
    assert got["retired"] >= 1
    np.testing.assert_allclose(got["kf_ate_m"], _printed(printed, "keyframe-only ATE:")[1], atol=KF_POS_ATOL)
    led = _printed(printed, "ledger poses:")
    assert got["ledger_poses"] == led[1]
    np.testing.assert_allclose(got["ledger_ate_m"], led[3], atol=KF_POS_ATOL)
    rows = [re.fullmatch(r"\s*(\d+) (KF|nk) t=\s*([-\d.]+) err=\s*([-\d.]+)", a[0]) for a in printed
            if len(a) == 1 and isinstance(a[0], str) and " t=" in a[0]]
    assert len(rows) == got["ledger_poses"] and all(rows)
    for (i, kind, t, err), m in zip(got["per_pose"], rows):
        assert (i, kind) == (int(m[1]), m[2])
        assert abs(t - float(m[3])) <= 5e-4
        assert abs(err - float(m[4])) <= KF_POS_ATOL + 5e-5
    reasons, counts = _printed(printed, "stop reasons (col16):")[1]
    assert got["stop_reasons"] == {float(r): int(c) for r, c in zip(reasons, counts)}
    np.testing.assert_allclose(got["overlaps"], _printed(printed, "overlaps:")[1], atol=OVERLAP_ATOL + 5e-3)


@pytest.fixture(autouse=True)
def _tools_importable(monkeypatch):
    monkeypatch.syspath_prepend(ROOT)
