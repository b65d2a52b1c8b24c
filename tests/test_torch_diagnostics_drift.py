"""Port vs reference: tools/diag_window_drift.py against
tools/torch_diag_window_drift.py, as tests/test_torch_diagnostics.py holds
the other two diagnostics (its docstring states the set-up and the
tolerances)."""

import re

import numpy as np

from dmsa_lidar_slam_tpu_torch.io import synthetic as tsyn
from tests.test_torch_diagnostics import (  # noqa: F401 (the fixture)
    ANGLE_ATOL, _patched_reference, _port_slam, _printed, _run_jax_tool, _small_sequence, _tools_importable)
from tests.test_torch_fused import KF_POS_ATOL, N_SCANS, OVERLAP_ATOL, PTS


def test_window_drift_matches_reference(monkeypatch):
    from tools.torch_diag_window_drift import window_drift

    _patched_reference(monkeypatch)
    printed = _run_jax_tool("diag_window_drift", monkeypatch, ["--scans", str(N_SCANS)])
    got = window_drift(_port_slam(), _small_sequence(tsyn), N_SCANS, PTS)
    num = r"([-+]?[\d.]+)"
    pat = re.compile(rf"scan\s+(\d+) etype=(\d) ov={num} perr0={num} perr5={num} alg=\[{num} {num}\] "
                     rf"crs=\[{num} {num}\] z=\[{num} {num}\] tilt=\[{num} {num}\] yaw=\[{num} {num}\]mrad")
    lines = [pat.fullmatch(a[0]) for a in printed if len(a) == 1 and str(a[0]).startswith("scan")]
    assert all(lines) and len(lines) == len(got["rows"]) >= N_SCANS - 4
    for r, m in zip(got["rows"], lines):
        v = [float(x) for x in m.groups()]
        assert (r["scan"], r["etype"]) == (int(v[0]), int(v[1]))
        assert abs(r["overlap"] - v[2]) <= OVERLAP_ATOL + 5e-3
        pos = [r["pos_err"][0], r["pos_err"][5], *r["along"], *r["cross"], *r["z"]]
        np.testing.assert_allclose(pos, v[3:11], atol=KF_POS_ATOL + 5e-4)
        np.testing.assert_allclose([*r["tilt_mrad"], *r["yaw_mrad"]], v[11:15], atol=1e3 * ANGLE_ATOL + 0.05)
        assert np.all(np.abs(r["yaw_err"]) < 0.1) and np.all(np.array(r["pos_err"]) < 0.15)
    ates = _printed(printed, "keyframe ATE:")
    np.testing.assert_allclose([got["kf_ate_m"], got["ledger_ate_m"]], [ates[1], ates[3]], atol=KF_POS_ATOL)
