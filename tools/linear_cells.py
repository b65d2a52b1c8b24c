#!/usr/bin/env python3
"""Linear cells: accepted Gaussian cells whose covariance has two
eigenvalues below the 1e-4 floor, on the CPU, in both packages.

    JAX_PLATFORMS=cpu python3 tools/linear_cells.py

Counts, in both packages on the same f32 points, the accepted
cells whose covariance has two eigenvalues (linear cells) or three below
the 1e-4 floor (f64 eigenvalues of the members' f64 covariance), and how
far each package's floored inverse is there from the other's and from the
exact f64 floored inverse (per cell, relative to the largest entry of the
reference's): in gaussians.build_cells (floored_inverse_sym6) on windows
of 5 consecutive scans (each scan preprocessed as DmsaSlam does on the
CPU, placed in the world by the analytic truth, at 2 and 5 times the
window's smallest preprocessing grid) over the 50 bench scans and the
first 60 long scans; and in the hash backend's cell build (info_from_cov,
floored_inverse_sym3) on phase (g)'s hash map (16 x 4,096 at 0.5 / 1.25 m,
65,536 slots) and phase (j)'s flagship map (32 x 2,048 at 0.4 / 1.0 m,
32,768 slots) at their start poses; and the same gaps on 400 drawn f32
linear cells, with the largest gap between the packages' sym_eigvals3.
One JSON line, also written to build/linear_cells.json.  The reference
and jax are imported by name (tools/e2e_parity._reference).
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.e2e_parity import _reference  # noqa: E402

COV_EIG_FLOOR = 1e-4


def _cell_stats(cov64, info_port, info_ref):
    """Counts and floored-inverse gaps over cells: cov64 [M, 3, 3] the
    members' f64 covariances, info_* [M, 3, 3] each package's floored
    inverse of its own f32 covariance."""
    w, v = np.linalg.eigh(cov64)
    below = (w < COV_EIG_FLOOR).sum(axis=1)
    exact = np.einsum("mij,mj,mkj->mik", v, 1.0 / np.maximum(w, COV_EIG_FLOOR), v)
    scale = np.maximum(np.abs(info_ref).max(axis=(1, 2)), 1e-30)

    def rel(a, b):
        return np.abs(a.astype(np.float64) - b.astype(np.float64)).max(axis=(1, 2)) / scale

    out = dict(cells=int(len(cov64)), planar=int((below == 1).sum()), linear=int((below == 2).sum()),
               three_below=int((below == 3).sum()))
    lin = below == 2
    for name, gap in (("port_vs_reference", rel(info_port, info_ref)), ("port_vs_exact", rel(info_port, exact)),
                      ("reference_vs_exact", rel(info_ref, exact))):
        out[name] = dict(all_max=float(gap.max(initial=0.0)), linear_max=float(gap[lin].max(initial=0.0)),
                         linear_over_1pct=int((gap[lin] > 1e-2).sum()), over_1pct=int((gap > 1e-2).sum()))
    return out


def _member_cov(pts, seg, n_seg):
    """f64 covariance [n_seg, 3, 3] of the points grouped by seg (-1: none),
    normalized by n - 1 as the cell builds do."""
    keep = seg >= 0
    p, s = pts[keep].astype(np.float64), seg[keep]
    n = np.bincount(s, minlength=n_seg).astype(np.float64)
    mean = np.stack([np.bincount(s, p[:, i], minlength=n_seg) for i in range(3)], 1) / np.maximum(n, 1)[:, None]
    d = p - mean[s]
    m2 = np.zeros((n_seg, 9))
    np.add.at(m2, s, (d[:, :, None] * d[:, None, :]).reshape(-1, 9))
    return m2.reshape(-1, 3, 3) / np.maximum(n - 1, 1)[:, None, None]


def _unpack6(a):
    return np.stack([a[:, [0, 1, 2]], a[:, [1, 3, 4]], a[:, [2, 4, 5]]], axis=1)


def window_cells(seq, data, config, scans_per_window=5):
    """gaussians.build_cells in both packages over windows of consecutive
    scans placed by the truth (module docstring)."""
    import torch
    from scipy.spatial.transform import Rotation

    from dmsa_lidar_slam_tpu_torch.ops import gaussians
    from dmsa_lidar_slam_tpu_torch.pipeline.slam import DmsaSlam

    jnp = _reference("jax.numpy")
    jgauss = _reference("dmsa_lidar_slam_tpu.ops.gaussians")
    slam = DmsaSlam(config, device="cpu")
    scans = [slam._preprocess(pts, stamps, rings) for pts, stamps, rings, *_ in data]
    totals = {}
    for w0 in range(0, len(scans) - scans_per_window + 1, scans_per_window):
        win = scans[w0:w0 + scans_per_window]
        parts = []
        for sc in win:
            u = seq._ramp_integral(sc.stamps - seq.t_start)
            rv = np.zeros((len(u), 3))
            rv[:, 2] = seq._yaw(u)
            parts.append(np.einsum("nij,nj->ni", Rotation.from_rotvec(rv).as_matrix(), sc.points) + seq._P(u))
        pts = np.concatenate(parts).astype(np.float32)
        rings = np.concatenate([sc.rings for sc in win]).astype(np.int32)
        mask = np.ones(len(pts), bool)
        min_grid = min(sc.grid_size for sc in win)
        for factor in (2.0, 5.0):
            grid = factor * min_grid
            tc = gaussians.build_cells(torch.as_tensor(pts), torch.as_tensor(mask), torch.as_tensor(rings), grid,
                                       config.min_num_points_gauss)
            jc = jgauss.build_cells(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(rings), grid,
                                    config.min_num_points_gauss)
            order, start, valid = tc.order.numpy(), tc.start.numpy(), tc.valid.numpy()
            same = valid & np.asarray(jc.valid) & (np.asarray(jc.start) == start)
            seg = np.full(len(pts), -1)
            seg[order] = np.where(same[start], start, -1)
            cov = _member_cov(pts, seg, len(pts))[same]
            st = _cell_stats(cov, _unpack6(tc.info6.numpy()[same]), _unpack6(np.asarray(jc.info6)[same]))
            st["valid_port"], st["valid_reference"] = int(valid.sum()), int(np.asarray(jc.valid).sum())
            _accumulate(totals, st)
    return totals


def _accumulate(totals, st):
    for k, v in st.items():
        if isinstance(v, dict):
            _accumulate(totals.setdefault(k, {}), v)
        elif k.endswith("_max"):
            totals[k] = max(totals.get(k, 0.0), v)
        else:
            totals[k] = totals.get(k, 0) + v


def hash_cells(points, mask, rings, grids, table, min_points=6):
    """The hash backend's cell build in both packages (the reference on a
    one-device mesh), at each grid."""
    import torch

    from dmsa_lidar_slam_tpu_torch.parallel import mesh as pmesh
    from dmsa_lidar_slam_tpu_torch.parallel import sharded

    jax = _reference("jax")
    jnp = _reference("jax.numpy")
    jsh = _reference("dmsa_lidar_slam_tpu.parallel.sharded")
    jmesh = _reference("dmsa_lidar_slam_tpu.parallel.mesh")
    P = _reference("jax.sharding").PartitionSpec
    totals = {}
    for grid in grids:
        g = torch.tensor(grid, dtype=torch.float32)
        cells, (cid, keep) = sharded.build_cells_sharded(torch.as_tensor(points), torch.as_tensor(mask),
                                                         torch.as_tensor(rings), g, min_points, table, pmesh.ONE_RANK)

        def build(p, m, r, gj):
            c, _ = jsh.build_cells_sharded(p, m, r, gj, min_points, table, "data")
            return c.info, c.valid

        f = jax.jit(jax.shard_map(build, mesh=jmesh.make_mesh("data", devices=jax.devices()[:1]),
                                  in_specs=(P("data"), P("data"), P("data"), P()), out_specs=(P(), P()),
                                  check_vma=False))
        j_info, j_valid = f(jnp.asarray(points), jnp.asarray(mask), jnp.asarray(rings), jnp.float32(grid))
        valid = cells.valid.numpy() & np.asarray(j_valid)
        seg = np.where(keep.numpy(), cid.numpy(), -1)
        cov = _member_cov(points, seg, table)[valid]
        st = _cell_stats(cov, cells.info.numpy()[valid], np.asarray(j_info)[valid])
        st["valid_port"], st["valid_reference"] = int(cells.valid.sum()), int(np.asarray(j_valid).sum())
        totals[str(grid)] = st
    return totals


def drawn_linear_cells(n=400, seed=0):
    """Both packages' floored inverses on n drawn f32 linear cells (one
    eigenvalue in [0.01, 4], two in [1e-8, 5e-5]; the draw of
    tests/test_torch_api_rest.py's f32_linear_below_floor case): the packed
    sym6 form, the 3x3 info_from_cov, and sym_eigvals3."""
    import torch

    from dmsa_lidar_slam_tpu_torch.ops import eig3, gaussians

    jnp = _reference("jax.numpy")
    jeig = _reference("dmsa_lidar_slam_tpu.ops.eig3")
    jgauss = _reference("dmsa_lidar_slam_tpu.ops.gaussians")
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    lam = np.exp(rng.uniform(np.log(1e-2), np.log(4.0), size=(n, 3)))
    lam[:, 1:] = np.exp(rng.uniform(np.log(1e-8), np.log(5e-5), size=(n, 2)))
    cov = np.einsum("nij,nj,nkj->nik", q, lam, q).astype(np.float32)
    a6 = np.stack([cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2], cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]], -1)
    six = [_unpack6(np.asarray(x)) for x in (eig3.floored_inverse_sym6(torch.as_tensor(a6), COV_EIG_FLOOR).numpy(),
                                             jeig.floored_inverse_sym6(jnp.asarray(a6), COV_EIG_FLOOR))]
    three = [gaussians.info_from_cov(torch.as_tensor(cov)).numpy(), np.asarray(jgauss.info_from_cov(jnp.asarray(cov)))]
    eig_gap = np.abs(eig3.sym_eigvals3(torch.as_tensor(cov)).numpy() - np.asarray(jeig.sym_eigvals3(jnp.asarray(cov))))
    cov64 = cov.astype(np.float64)
    return dict(cells=n, sym6=_cell_stats(cov64, *six), sym3=_cell_stats(cov64, *three),
                sym_eigvals3_max_abs_gap=float(eig_gap.max()))


def main():
    import torch

    from chip_smoke import DIST_GRIDS, DIST_HASH_SHAPE, HASH_OPT, bench_data, dist_problem, long_data
    from dmsa_lidar_slam_tpu_torch.io.synthetic import bench_config, long_config
    from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm
    from dmsa_lidar_slam_tpu_torch.parallel import dryrun

    torch.set_num_threads(4)
    out = {}
    seq, data = bench_data(50)
    out["build_cells_bench"] = window_cells(seq, data, bench_config())
    seq, data = long_data(60)
    out["build_cells_long_60"] = window_cells(seq, data, long_config())
    data, p0, _ = dist_problem(DIST_HASH_SHAPE, "cpu")
    fo = kfm.make_forward(kfm.MapShapes(*DIST_HASH_SHAPE), True, True, True)(p0, data)
    out["hash_g"] = hash_cells(fo.points.numpy(), fo.mask.numpy(), fo.ring_ids.numpy(), DIST_GRIDS,
                               HASH_OPT["table_size"])
    shapes, data, p0, _ = dryrun.flagship_problem(32, 2048, device="cpu")
    fo = kfm.make_forward(shapes, True, True, True)(p0, data)
    out["hash_j"] = hash_cells(fo.points.numpy(), fo.mask.numpy(), fo.ring_ids.numpy(),
                               (2.0 * dryrun.MIN_GRID, 5.0 * dryrun.MIN_GRID), 32768)
    out["drawn_linear"] = drawn_linear_cells()
    line = json.dumps(dict(device="cpu", floor=COV_EIG_FLOOR, **out))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "linear_cells.json"), "w") as f:
        f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
