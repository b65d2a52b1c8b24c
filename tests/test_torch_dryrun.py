"""The port's multi-chip dry run (parallel/dryrun.py) against the JAX
package's (__graft_entry__.py:66-217).

  - flagship_keyframe_map makes the reference's map bit for bit (the same
    numpy draws from seed 7) at 4 keyframes x 256 points, and its problem
    data and perturbed start are the reference's to f64 rounding of the
    same chain arithmetic (1e-12);
  - dryrun_multichip at 1, 2 and 4 gloo ranks (tests/torch_dist.py,
    through parallel.dryrun.dryrun_rank, as chip_smoke.py runs it) on a
    reduced map (8 keyframes x 512 points; at 4 x 512 the reference's
    thresholds leave fewer than min_num_gaussians cells): each backend
    improves on the start and lands within 0.02 m of the single-card
    optimizer (its own checks), the spatial shuffle drops nothing, the
    ranks' parameters are bit-identical, and the result does not depend on
    the mesh size beyond the reference's own bounds: the hash backend's
    parameters within tests/test_keyframe_dist.py:78's tolerance of the
    one-rank run, the spatial backend's keyframe positions within 0.02 m
    (the psum's order of the block sums is all that changes).
"""

import numpy as np
import pytest
import torch

from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm
from dmsa_lidar_slam_tpu_torch.parallel import dryrun
from tests import torch_dist

import __graft_entry__ as ge

REDUCED = (8, 512)
FIELDS = ("local_pts", "local_normals", "pt_mask", "pt_ring", "grid_size", "orient_w", "transl_w", "stamps",
          "grav_meas", "grav_plausible", "odom_rel_orient", "odom_rel_transl", "cov_grav_inv",
          "odom_transl_cov_inv", "odom_orient_cov_inv")


def test_flagship_map_is_the_reference_map():
    _, jmap, jrng = ge._flagship_keyframe_map(n_kf=4, pts_per_kf=256)
    _, tmap, trng = dryrun.flagship_keyframe_map(4, 256, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tmap, f), getattr(jmap, f), err_msg=f)
    assert jrng.bit_generator.state == trng.bit_generator.state
    jdata, jtrue = jmap.to_problem_data(0, 1.0, 100.0)
    tdata, ttrue = tmap.to_problem_data(0, 1.0, 100.0)
    np.testing.assert_allclose(ttrue, np.asarray(jtrue), rtol=0, atol=1e-12)
    for f in kfm.KeyframeMapData._fields:
        a, b = getattr(tdata, f).numpy(), np.asarray(getattr(jdata, f))
        if a.dtype == np.float64:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    _, _, p0, pt = dryrun.flagship_problem(4, 256, device="cpu")
    noise = jrng.normal(scale=0.01, size=jtrue.shape)
    noise[: 3 * 3] *= 0.3
    np.testing.assert_allclose(p0.numpy(), np.asarray(jtrue) + noise, rtol=0, atol=1e-12)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jtrue), rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    pending = {w: torch_dist.Ranks(dryrun.dryrun_rank, w, tmp, *REDUCED) for w in (1, 2, 4)}
    return {w: r.results() for w, r in pending.items()}


@pytest.mark.parametrize("world", [1, 2, 4])
def test_dryrun_multichip_on_gloo_ranks(runs, world):
    outs = runs[world]
    assert all(o["ranks"] == world for o in outs)
    for key in ("params_hash", "params_spatial"):
        assert all(torch.equal(o[key], outs[0][key]) for o in outs), key
    o = outs[0]
    assert o["overflow"] == 0 and o["err_hash_m"] < o["err_start_m"] and o["err_spatial_m"] < o["err_start_m"]
    assert max(o["parity_hash_m"], o["parity_spatial_m"]) < dryrun.PARITY_M
    one = runs[1][0]
    np.testing.assert_allclose(o["params_hash"].numpy(), one["params_hash"].numpy(), rtol=5e-3, atol=2e-3)
    shapes, data, _, _ = dryrun.flagship_problem(*REDUCED, device="cpu")

    def positions(p):
        return kfm.global_chain(p, data, shapes)[1].transl

    gap = float(torch.linalg.norm(positions(o["params_spatial"]) - positions(one["params_spatial"]), dim=1).max())
    assert gap < dryrun.PARITY_M
