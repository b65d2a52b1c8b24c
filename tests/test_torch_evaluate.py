"""Port vs reference: trajectory evaluation (pipeline/evaluate.py, a numpy
copy in the port).

Two TUM files are made from a numpy seed: a reference trajectory, and an
estimate of it with stamp jitter below the association window, one pose
missing, a rigid offset (rotation and translation, which the Umeyama
alignment removes) and position noise.  Both packages' ate, rpe and CLI
JSON must agree to 1e-12: the same numpy operations in the same order.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from dmsa_lidar_slam_tpu.pipeline import evaluate as jev
from dmsa_lidar_slam_tpu_torch.pipeline import evaluate as tev

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_tum(path, stamps, pos, quat):
    np.savetxt(path, np.column_stack([stamps, pos, quat]), fmt="%.9f", header="stamp tx ty tz qx qy qz qw")


@pytest.fixture
def tum_files(tmp_path):
    rng = np.random.default_rng(2024)
    n = 60
    stamps = 1000.0 + 0.1 * np.arange(n)
    pos = np.cumsum(rng.normal(0.05, 0.02, (n, 3)), axis=0)
    quat = Rotation.from_rotvec(0.1 * rng.standard_normal((n, 3))).as_quat()
    ref = str(tmp_path / "ref.txt")
    _write_tum(ref, stamps, pos, quat)

    offset = Rotation.from_rotvec([0.02, -0.01, 0.3])
    est_pos = offset.apply(pos) + [1.5, -0.4, 0.2] + 0.01 * rng.standard_normal((n, 3))
    est_quat = (offset * Rotation.from_quat(quat)).as_quat()
    est_stamps = stamps + rng.uniform(-0.008, 0.008, n)
    keep = np.ones(n, dtype=bool)
    keep[17] = False  # a missing pose
    est = str(tmp_path / "est.txt")
    _write_tum(est, est_stamps[keep], est_pos[keep], est_quat[keep])
    return est, ref


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-12, atol=1e-12, err_msg=k)


def test_ate_and_rpe_match_reference(tum_files):
    est, ref = tum_files
    a = tev.ate(est, ref)
    assert a["pairs"] == 59 and 0.005 < a["ate_rmse"] < 0.03  # the offset is aligned away
    _same(a, jev.ate(est, ref))
    for delta in (1, 5):
        _same(tev.rpe(est, ref, delta=delta), jev.rpe(est, ref, delta=delta))
    with pytest.raises(ValueError):
        tev.ate(est, ref, max_diff=1e-6)  # nothing associates


def test_cli_json_matches_reference(tum_files, capsys):
    est, ref = tum_files
    tev.main([est, ref])
    got = json.loads(capsys.readouterr().out)
    jev.main([est, ref])
    want = json.loads(capsys.readouterr().out)
    _same(got, want)
    res = subprocess.run(
        [sys.executable, "-m", "dmsa_lidar_slam_tpu_torch.pipeline.evaluate", est, ref, "--max-diff", "0.02"],
        cwd=ROOT, capture_output=True, text=True, check=True,
    )
    _same(json.loads(res.stdout), want)
