"""Keyframe position error per Gauss-Newton iteration of the single-card
tabular optimizer on chip_smoke.py's phase (g) map: 100 keyframes x 4,096
points by default (P = 594), each keyframe pose perturbed by 5 mrad / 2 cm,
with chip_smoke.DIST_OPT's settings (the pipelines'), one iteration per
call.

    python3 tools/dist_convergence.py [--device cuda|cpu] [--iterations 30]
        [--keyframes 100] [--points 4096] [--reference]

Prints one JSON line: the position RMS error against the truth before and
after each iteration, and the valid Gaussian cells and stop reason of each
iteration (a stop other than 0 would end a num_iter call there).  On
the card the port's optimizer runs K1-K3; on the CPU their plain versions.
With --reference, the JAX package's optimizer runs the same numpy problem
on the CPU as well (its tabular path through its plain XLA versions, jax
imported by name there only), and the line holds both curves.  The
reference's plain K2 holds a [M, 7, P] f32 array (M = 2 x keyframes x
points), so keep --reference to a cut number of points per keyframe.
"""

import argparse
import importlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_smoke():
    """chip_smoke.py of this checkout (its problem builder)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_curve(smoke, shape, device, iterations):
    """The port's optimizer: (position RMS before and after each iteration,
    valid cells and stop reason of each)."""
    from dmsa_lidar_slam_tpu_torch.dmsa import optimizer as opt
    from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm

    data, params, truth_params = smoke.dist_problem(shape, device)
    shapes = kfm.MapShapes(*shape)
    o = smoke.DIST_OPT
    settings = opt.OptimSettings(num_iter=1, min_num_points_per_set=o["min_points"],
                                 step_length_optim=o["step_length"], max_step=o["max_step"], epsilon=o["epsilon"])
    fwd = kfm.make_forward(shapes, o["use_gravity"], o["use_odometry"], True)
    tabular = kfm.make_tabular(shapes, o["use_gravity"], o["use_odometry"])
    truth = smoke.kf_positions(data, truth_params, shape)
    errors = [smoke.position_rms(smoke.kf_positions(data, params, shape), truth)]
    cells, stops = [], []
    for _ in range(iterations):
        res = opt.optimize(fwd, params, data, settings, 0.25, tabular_fn=tabular)
        params = res.params
        errors.append(smoke.position_rms(smoke.kf_positions(data, params, shape), truth))
        cells.append(int(res.num_gaussians))
        stops.append(int(res.stop_reason))
    return errors, cells, stops


def reference_curve(smoke, shape, iterations):
    """The JAX package's optimizer on the CPU, on the same numpy problem."""
    import numpy as np

    from tests.torch_dist import keyframe_problem

    jax = importlib.import_module("jax")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jnp = importlib.import_module("jax.numpy")
    jopt = importlib.import_module("dmsa_lidar_slam_tpu.dmsa.optimizer")
    jkfm = importlib.import_module("dmsa_lidar_slam_tpu.map.keyframes")

    data, p0, pt = keyframe_problem(smoke.DIST_SEED, s=shape[0], ppk=shape[1], with_normals=True, extras=True,
                                    shared=False, pose_noise=smoke.DIST_POSE_NOISE)
    jd = jkfm.KeyframeMapData(**{k: jnp.asarray(v) for k, v in data.items()})
    shapes = jkfm.MapShapes(*shape)
    o = smoke.DIST_OPT
    settings = jopt.OptimSettings(num_iter=1, min_num_points_per_set=o["min_points"],
                                  step_length_optim=o["step_length"], max_step=o["max_step"], epsilon=o["epsilon"])
    fwd = jkfm.make_forward(shapes, o["use_gravity"], o["use_odometry"], True)
    tabular = jkfm.make_tabular(shapes, o["use_gravity"], o["use_odometry"])

    def positions(params):
        return np.asarray(jkfm.global_chain(params, jd, shapes)[1].transl)

    truth = positions(jnp.asarray(pt))
    params = jnp.asarray(p0)
    errors = [smoke.position_rms(positions(params), truth)]
    cells, stops = [], []
    for _ in range(iterations):
        res = jopt.optimize(fwd, params, jd, settings, 0.25, tabular_fn=tabular)
        params = res.params
        errors.append(smoke.position_rms(positions(params), truth))
        cells.append(int(res.num_gaussians))
        stops.append(int(res.stop_reason))
    return errors, cells, stops


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--iterations", type=int, default=30)
    parser.add_argument("--keyframes", type=int, default=None, help="default: chip_smoke.DIST_SHAPE's")
    parser.add_argument("--points", type=int, default=None, help="per keyframe; default: chip_smoke.DIST_SHAPE's")
    parser.add_argument("--reference", action="store_true", help="also run the JAX package on the CPU")
    args = parser.parse_args(argv)
    sys.path.insert(0, HERE)

    import torch

    from dmsa_lidar_slam_tpu_torch.utils.device import resolve

    smoke = _load_smoke()
    shape = (args.keyframes or smoke.DIST_SHAPE[0], args.points or smoke.DIST_SHAPE[1])
    device = resolve(args.device)
    errors, cells, stops = port_curve(smoke, shape, device, args.iterations)
    name = torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"
    out = dict(device=name, shape=shape, settings=smoke.DIST_OPT, kf_pos_rms_m=errors, valid_cells=cells,
               stop_reasons=stops)
    if args.reference:
        ref_errors, ref_cells, ref_stops = reference_curve(smoke, shape, args.iterations)
        out.update(reference_kf_pos_rms_m=ref_errors, reference_valid_cells=ref_cells, reference_stop_reasons=ref_stops)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
