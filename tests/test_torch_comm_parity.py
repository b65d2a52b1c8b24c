"""Collective parity: what the port's distributed keyframe adjustment sends
per Gauss-Newton iteration against what the JAX package's sends.

The port's two backends run on 4 gloo ranks (tests/torch_dist.py) over a
4 x 512-point keyframe problem, through the rank function that
tools/torch_comm_analysis.py runs (parallel.dryrun.collective_counts),
and parallel.mesh's collective counter records each collective:
primitive, payload shape, dtype, calls.  The reference's are counted as
tools/comm_analysis.py counts them, by walking the jaxpr of its
optimisers (the same shapes, a 4-device CPU mesh; `walk` is that tool's,
with the loop depth kept apart so that the set-up calls show).  Per iteration the two tables agree row for row, except for the
rows that differ by design, each pinned here and explained in PERF.md:
  - spatial backend: the cell count and the overflow ride in one int32[2]
    psum where the reference takes two int32[] psums (the same 8 bytes);
  - hash backend, per grid resolution: the build's count and point sums
    ride in one [T, 4] psum where the reference takes [T] and [T, 3]; the
    quadratic forms' psum carries the value beside its P tangents ([P + 1,
    T]) where the reference takes [T] and [P, T]; and the port never
    re-sends the build's counts and sums, which the reference's linearised
    residual (its [T] count and [T, 3] sums) and its line search (its [T]
    count) reduce again from the same frozen membership.
So the port sends no row the reference does not, and no more bytes per
iteration; neither package sends anything outside the loop.
"""

import collections

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from dmsa_lidar_slam_tpu.map import keyframes as jkfm
from dmsa_lidar_slam_tpu.parallel import keyframe_dist as jkd
from dmsa_lidar_slam_tpu.parallel import spatial as jsp
from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm
from dmsa_lidar_slam_tpu_torch.parallel import dryrun
from tests import torch_dist

COLLECTIVES = ("psum", "pmin", "pmax", "all_gather", "ppermute", "all_to_all", "reduce_scatter")
S, PPK, RANKS = 4, 512, 4
NUM_ITER, MIN_POINTS, TABLE = 6, 4, 4096
GRIDS = (0.5, 1.25)


def walk(jaxpr, mult, out, loop_iters, depth=0):
    """tools/comm_analysis.py's walk: out[(depth, prim, shapes)] += mult
    executions, a loop body counted loop_iters times (its `depth` > 0)."""
    from jax.extend.core import ClosedJaxpr, Jaxpr

    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if any(name.startswith(c) for c in COLLECTIVES):
            shapes = tuple((tuple(v.aval.shape), str(v.aval.dtype)) for v in eqn.invars if hasattr(v.aval, "shape"))
            out[(min(depth, 1), name, shapes)] += mult
        m, d = mult, depth
        if name in ("while", "scan"):
            m, d = mult * (eqn.params.get("length", None) or loop_iters), depth + 1
        sub = []
        for v in eqn.params.values():
            for x in v if isinstance(v, (list, tuple)) else [v]:
                if isinstance(x, ClosedJaxpr):
                    sub.append(x.jaxpr)
                elif isinstance(x, Jaxpr):
                    sub.append(x)
        for s in sub:
            walk(s, m, out, loop_iters, d)


def _rows(counts):
    """{(primitive, shape, dtype): executions} with the reference's
    psum_invariant named psum, one row per operand."""
    rows = collections.Counter()
    for (name, shapes), n in counts.items():
        prim = "psum" if name.startswith("psum") else name
        for shape, dtype in shapes:
            rows[(prim, tuple(shape), dtype)] += n
    return rows


def _nbytes(rows):
    return sum(n * int(np.prod(shape)) * np.dtype(dtype).itemsize for (_, shape, dtype), n in rows.items())


@pytest.fixture(scope="module")
def problem():
    data, params0, _ = torch_dist.keyframe_problem(3, s=S, ppk=PPK, with_normals=True)
    return data, params0


@pytest.fixture(scope="module")
def port(problem, tmp_path_factory):
    data, params0 = problem
    ranks = torch_dist.run_ranks(dryrun.collective_counts, RANKS, tmp_path_factory.mktemp("comm"),
                                 kfm.KeyframeMapData(**data), params0, GRIDS, NUM_ITER, MIN_POINTS, TABLE)
    counts = [{name: (c["rows"], c["setup"], c["iterations"]) for name, c in r.items()} for r in ranks]
    for c in counts[1:]:
        assert c == counts[0], "the ranks issued different collectives"
    return counts[0]


def _reference(backend, data, params0):
    """The reference's (per-iteration rows, set-up rows) of one backend."""
    mesh = Mesh(np.array(jax.devices()[:RANKS]), ("data",))
    shapes = jkfm.MapShapes(n_keyframes=S, n_pts_per_kf=PPK)
    pts = jnp.asarray(data["local_pts"].reshape(-1, 3))
    mask = jnp.asarray(data["pt_mask"].reshape(-1))
    rings = jnp.asarray(data["pt_ring"].reshape(-1))
    aux = jkd.KfAux(**{f: jnp.asarray(data[f]) for f in jkd.KfAux._fields})
    args = (jnp.asarray(params0), pts, mask, rings, aux, jnp.asarray(GRIDS))
    if backend == "hash":
        fn = jkd.make_keyframe_dist_optimize(mesh, shapes, num_iter=NUM_ITER, min_points=MIN_POINTS,
                                             table_size=TABLE, jit=True)
    else:
        fn = jsp.make_spatial_dist_optimize(mesh, shapes, num_iter=NUM_ITER, min_points=MIN_POINTS, use_split=True,
                                            jit=True)
        args = args + (jnp.asarray(data["local_normals"].reshape(-1, 3)),)
    out = collections.defaultdict(int)
    walk(jax.make_jaxpr(fn)(*args).jaxpr, 1, out, NUM_ITER)
    loop = {(n, s): c / NUM_ITER for (d, n, s), c in out.items() if d}
    setup = {(n, s): c for (d, n, s), c in out.items() if not d}
    return _rows(loop), _rows(setup)


def _port_rows(rows, iters):
    return collections.Counter({(r["primitive"], tuple(r["shape"]), r["dtype"]): r["calls"] / iters for r in rows})


def _by_design(backend, ref):
    """The reference's per-iteration rows turned into the port's by the
    differences the module docstring lists."""
    want = collections.Counter(ref)
    if backend == "spatial":
        assert want[("psum", (), "int32")] == 2
        del want[("psum", (), "int32")]
        want[("psum", (2,), "int32")] += 1
        return want
    p_dim, grids = 6 * (S - 1), len(GRIDS)
    for key, per_grid in ((("psum", (TABLE,), "float32"), 4), (("psum", (TABLE, 3), "float32"), 2),
                          (("psum", (p_dim, TABLE), "float32"), 1)):
        assert want[key] == per_grid * grids, (key, want[key])
        del want[key]
    want[("psum", (TABLE, 4), "float32")] += grids
    want[("psum", (p_dim + 1, TABLE), "float32")] += grids
    return want


@pytest.mark.parametrize("backend", ["hash", "spatial"])
def test_collectives_per_iteration_match_reference(backend, problem, port):
    data, params0 = problem
    ref_loop, ref_setup = _reference(backend, data, params0)
    loop_rows, setup_rows, iters = port[backend]
    assert iters >= 2, f"the {backend} optimisation stopped after {iters} iteration(s)"
    got = _port_rows(loop_rows, iters)
    assert got == _by_design(backend, ref_loop), (sorted(got.items()), sorted(ref_loop.items()))
    assert _nbytes(got) <= _nbytes(ref_loop)
    assert not setup_rows and not ref_setup
