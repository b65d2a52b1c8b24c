"""Port vs reference: rotations, poses, interpolation, IMU preintegration
(f64 on both sides), plus the port's import boundary.

Tolerance: rtol 1e-10 / atol 1e-12 — the same closed forms in f64; the
only differences are summation order (log-depth scans are associated
differently) and libm last-bit differences.
"""

import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dmsa_lidar_slam_tpu.core import interpolation as jinterp
from dmsa_lidar_slam_tpu.core import poses as jposes
from dmsa_lidar_slam_tpu.core import rotations as jrot
from dmsa_lidar_slam_tpu.imu import preintegration as jpre
from dmsa_lidar_slam_tpu_torch.core import interpolation as tinterp
from dmsa_lidar_slam_tpu_torch.core import poses as tposes
from dmsa_lidar_slam_tpu_torch.core import rotations as trot
from dmsa_lidar_slam_tpu_torch.imu import preintegration as tpre
from tests.torch_parity import nn, tt

RTOL, ATOL = 1e-10, 1e-12


def close(a, b):
    np.testing.assert_allclose(nn(a), np.asarray(b), rtol=RTOL, atol=ATOL)


def _aa(rng, n, scale=1.0):
    aa = scale * rng.standard_normal((n, 3))
    aa[0] = 0.0  # identity
    aa[1] = [1e-8, 0.0, 0.0]  # series branch
    aa[2] = [np.pi - 1e-3, 0.0, 0.0]  # near pi
    return aa


ROT_CASES = {
    "axang2rotm": lambda m, aa, v: m.axang2rotm(aa),
    "axang2quat": lambda m, aa, v: m.axang2quat(aa),
    "quat2axang": lambda m, aa, v: m.quat2axang(m.axang2quat(aa)),
    "rotm2quat": lambda m, aa, v: m.rotm2quat(m.axang2rotm(aa)),
    "rotm2axang": lambda m, aa, v: m.rotm2axang(m.axang2rotm(aa)),
    "quat_rotate": lambda m, aa, v: m.quat_rotate(m.axang2quat(aa), v),
    "quat_rotate_vjp_q": lambda m, aa, v: m.quat_rotate_vjp_q(m.axang2quat(aa), v, 2.0 * v + 1.0),
    "quat_slerp": lambda m, aa, v: m.quat_slerp(m.axang2quat(aa), m.axang2quat(0.7 * aa + 0.2), 0.3),
    "slerp": lambda m, aa, v: m.slerp(aa, 0.5 * aa + 0.1, 0.7),
    "rodrigues_between": lambda m, aa, v: m.rodrigues_between(v, aa + 0.5),
    "skew": lambda m, aa, v: m.skew(aa),
}


@pytest.mark.parametrize("name", sorted(ROT_CASES))
def test_rotations(name):
    rng = np.random.default_rng(0)
    aa = _aa(rng, 64)
    v = rng.standard_normal((64, 3))
    fn = ROT_CASES[name]
    close(fn(trot, tt(aa), tt(v)), fn(jrot, jnp.asarray(aa), jnp.asarray(v)))


def test_poses_chain_roundtrip():
    rng = np.random.default_rng(1)
    orient = 0.3 * rng.standard_normal((11, 3))
    transl = rng.standard_normal((11, 3))
    jchain = jposes.PoseChain(jnp.asarray(orient), jnp.asarray(transl))
    tchain = tposes.PoseChain(tt(orient), tt(transl))
    jgp = jposes.relative2global(jchain)
    tgp = tposes.relative2global(tchain)
    close(tgp.orient, jgp.orient)
    close(tgp.transl, jgp.transl)
    jback = jposes.global2relative(jgp)
    tback = tposes.global2relative(tgp)
    close(tback.orient, jback.orient)
    close(tback.transl, jback.transl)
    close(tposes.params_from_chain(tchain), jposes.params_from_chain(jchain))
    p = tposes.params_from_chain(tchain)
    again = tposes.chain_from_params(p, tchain)
    close(again.orient, orient)


def test_interpolation():
    rng = np.random.default_rng(2)
    knots = np.sort(rng.uniform(0, 1, 6))
    knots[0] = 0.0
    y = rng.standard_normal((6, 3))
    orient = 0.4 * rng.standard_normal((6, 3))
    t_eval = np.concatenate([rng.uniform(-0.1, 1.1, 20), knots[2:4]])
    close(
        tinterp.barycentric_interp(tt(t_eval), tt(knots), tt(y)),
        jinterp.barycentric_interp(jnp.asarray(t_eval), jnp.asarray(knots), jnp.asarray(y)),
    )
    close(
        tinterp.barycentric_derivative(tt(t_eval), tt(knots), tt(y)),
        jinterp.barycentric_derivative(jnp.asarray(t_eval), jnp.asarray(knots), jnp.asarray(y)),
    )
    close(
        tinterp.interp_rotations(tt(t_eval), tt(knots), tt(orient)),
        jinterp.interp_rotations(jnp.asarray(t_eval), jnp.asarray(knots), jnp.asarray(orient)),
    )
    for a, b in zip(tinterp.uniform_grid_consts(251, 6, 50), jinterp.uniform_grid_consts(251, 6, 50)):
        np.testing.assert_array_equal(a, b)


def test_preintegration():
    rng = np.random.default_rng(3)
    K, L = 5, 50
    omega = 0.5 * rng.standard_normal((K, L, 3))
    acc = rng.standard_normal((K, L, 3)) + np.array([0.0, 0.0, 9.8])
    dt = 0.002
    cg, ca = 0.01**2 * np.eye(3), 0.3**2 * np.eye(3)
    # the reference jitted, as it runs (op by op it takes ~20 s on the CPU)
    js = jax.jit(jpre.preintegrate_intervals)(jnp.asarray(omega), jnp.asarray(acc), dt, jnp.asarray(cg), jnp.asarray(ca))
    ts = tpre.preintegrate_intervals(tt(omega), tt(acc), dt, tt(cg), tt(ca))
    for f in ("delta_rot", "delta_vel", "delta_pos"):
        close(getattr(ts, f), getattr(js, f))
    # the 9x9 covariance spans ~1e-12..1e-4: relative to its scale
    scale = float(np.abs(np.asarray(js.cov)).max())
    np.testing.assert_allclose(nn(ts.cov), np.asarray(js.cov), rtol=1e-9, atol=1e-12 * scale)

    a0, p0, v0 = 0.1 * rng.standard_normal(3), rng.standard_normal(3), rng.standard_normal(3)
    grav = np.array([0.0, 0.0, -9.805])
    dts = np.full(K, L * dt)
    ja, jp = jax.jit(jpre.dead_reckon_controls)(jnp.asarray(a0), jnp.asarray(p0), jnp.asarray(v0), js, jnp.asarray(dts), jnp.asarray(grav))
    ta, tp = tpre.dead_reckon_controls(tt(a0), tt(p0), tt(v0), ts, tt(dts), tt(grav))
    close(ta, ja)
    close(tp, jp)


def test_port_never_imports_jax():
    """Every module of the port (pkgutil.walk_packages), chip_smoke.py and
    the bag writer it uses, imported in a fresh process, pull in neither jax
    nor the reference package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dmsa_lidar_slam_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "assert len(names) > 40, names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke, tests.torch_bag\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'dmsa_lidar_slam_tpu'"
        " or m.startswith('dmsa_lidar_slam_tpu.')]\n"
        "assert not bad, bad\n"
    )
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("entry", ["FusedDmsaSlam", "state_from_numpy"])
def test_entry_points_default_to_the_card(entry):
    """Without device= an entry point asks for the card: with none it raises
    and never carries on on the CPU (DmsaSlam and runner.run: the slam and
    runner tests)."""
    import torch

    from dmsa_lidar_slam_tpu_torch import convert
    from dmsa_lidar_slam_tpu_torch.pipeline.fused import FusedDmsaSlam
    from dmsa_lidar_slam_tpu_torch.utils.device import DEFAULT_DEVICE

    assert DEFAULT_DEVICE == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    fn = {"FusedDmsaSlam": FusedDmsaSlam, "state_from_numpy": convert.state_from_numpy}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(None)
