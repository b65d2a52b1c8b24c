"""Fixed-order segment sums (ops/voxel.py: segments, segment_sum,
sorted_runs, run_sums) and their callers: gaussians.build_cells and segment_mean_cov,
and the hash backend's cell build (parallel/sharded.py).

Every segment adds its members one after another in their order, so:
  - each f32 sum is within (n - 1) * 2^-24 of the sum of its n terms'
    magnitudes of the exact (f64) sum: the first-order bound of a
    sequential f32 sum, each addition rounding by at most half an ulp of
    its running total;
  - the same call gives the same bits twice;
  - moving whole segments around in memory (each keeping its members'
    order) gives the same bits per segment.
The card's repeats are held in tests/test_torch_fixed_sums_card.py; the
parity of these functions with the JAX package stays in
tests/test_torch_api_rest.py, test_torch_structured.py and
test_torch_parallel_hash.py, at their tolerances.
"""

import numpy as np
import pytest
import torch

from dmsa_lidar_slam_tpu_torch.ops import gaussians, voxel
from dmsa_lidar_slam_tpu_torch.parallel import mesh as pmesh
from dmsa_lidar_slam_tpu_torch.parallel import sharded

U32 = 2.0**-24


def _runs(seed, n=6000, n_keys=400):
    """Sorted keys with runs of 1 to ~60 members, each position's run
    start, and f32 values [n, 5] far from 0 (running totals grow)."""
    rng = np.random.default_rng(seed)
    key = np.sort(rng.integers(0, n_keys, size=n))
    new = np.ones(n, bool)
    new[1:] = key[1:] != key[:-1]
    start = np.maximum.accumulate(np.where(new, np.arange(n), 0))
    values = (rng.standard_normal((n, 5)) * 3.0 + 20.0).astype(np.float32)
    return key, torch.as_tensor(start), values


def _all_runs(start):
    """sorted_runs with every row a member (no masked tail)."""
    return voxel.sorted_runs(start, torch.tensor(start.shape[0]))


def _within_sequential_bound(got, values, seg_of, n_seg, rounded=0):
    """got [S, D] f32 per-segment sums of values [N, D] (segment seg_of[i])
    within the sequential f32 bound of the exact sums, plus `rounded` f32
    roundings of the sum itself (a mean taken back to a sum)."""
    v = values.astype(np.float64)
    exact = np.zeros((n_seg, v.shape[1]))
    mag = np.zeros_like(exact)
    np.add.at(exact, seg_of, v)
    np.add.at(mag, seg_of, np.abs(v))
    count = np.bincount(seg_of, minlength=n_seg)[:, None]
    bound = (np.maximum(count - 1, 0) * U32 * mag + rounded * U32 * np.abs(exact)) * 1.0001
    assert np.all(np.abs(got.astype(np.float64) - exact) <= bound)


def _regroup(seg_of, rng):
    """An index array that moves the members to a random interleaving of
    the segments, each segment's members keeping their order."""
    shuffled = seg_of[rng.permutation(len(seg_of))]
    new_idx = np.empty(len(seg_of), np.int64)
    new_idx[np.argsort(shuffled, kind="stable")] = np.argsort(seg_of, kind="stable")
    return new_idx


@pytest.mark.parametrize("seed", [0, 1])
def test_run_sums(seed):
    key, start, values = _runs(seed)
    ordinal = np.cumsum(start.numpy() == np.arange(len(key))) - 1
    n_runs = ordinal[-1] + 1
    got = voxel.run_sums(torch.as_tensor(values), _all_runs(start)).numpy()
    first = start.numpy() == np.arange(len(key))
    _within_sequential_bound(got[first], values, ordinal, n_runs)
    np.testing.assert_array_equal(got, got[start.numpy()])  # every member holds its run's sum
    np.testing.assert_array_equal(voxel.run_sums(torch.as_tensor(values), _all_runs(start)).numpy(), got)
    # the runs in another order in memory: the same bits per run
    rng = np.random.default_rng(seed + 10)
    perm = rng.permutation(n_runs)
    blocks = [np.flatnonzero(ordinal == r) for r in perm]
    idx = np.concatenate(blocks)
    lengths = np.array([len(b) for b in blocks])
    start2 = np.repeat(np.concatenate([[0], np.cumsum(lengths)[:-1]]), lengths)
    got2 = voxel.run_sums(torch.as_tensor(values[idx]), _all_runs(torch.as_tensor(start2))).numpy()
    np.testing.assert_array_equal(got2, got[idx])


def test_run_sums_masked_tail_and_slabs():
    """Rows from num_members on join no run and read 0, the runs before
    them keep their bits; slabs stacked as gaussians.concat_cells stacks
    them sum slab by slab, each as alone."""
    key, start, values = _runs(3, n=3000, n_keys=200)
    whole = voxel.run_sums(torch.as_tensor(values), _all_runs(start)).numpy()
    m = int(start[2500])  # a run start: the tail is whole runs, as the masked run is
    cut = voxel.sorted_runs(start, torch.tensor(m))
    tail = voxel.run_sums(torch.as_tensor(values), cut).numpy()
    np.testing.assert_array_equal(tail[:m], whole[:m])
    assert not tail[m:].any()
    _, start_b, values_b = _runs(4, n=3000, n_keys=50)
    runs_a, runs_b = cut, _all_runs(start_b)
    stacked = voxel.Runs(offsets=torch.stack([runs_a.offsets, runs_b.offsets]),
                         ordinal=torch.cat([runs_a.ordinal, runs_b.ordinal + 3000]))
    both = voxel.run_sums(torch.as_tensor(np.concatenate([values, values_b])), stacked).numpy()
    np.testing.assert_array_equal(both[:3000], tail)
    np.testing.assert_array_equal(both[3000:], voxel.run_sums(torch.as_tensor(values_b), runs_b).numpy())
    # 1-D values take the same per-run sums as a column of 2-D ones
    np.testing.assert_array_equal(voxel.run_sums(torch.as_tensor(values[:, 2]), cut).numpy(), tail[:, 2])


def test_segment_sum_along_a_batch_dim():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 90, size=5000)
    values = (rng.standard_normal((3, 5000, 2)) + 7.0).astype(np.float32)
    seg = voxel.segments(torch.as_tensor(ids), 100)
    got = voxel.segment_sum(seg, torch.as_tensor(values), dim=1).numpy()
    assert got.shape == (3, 100, 2) and not got[:, 90:].any()
    for b in range(3):
        _within_sequential_bound(got[b], values[b], ids, 100)
    idx = _regroup(ids, rng)
    got2 = voxel.segment_sum(voxel.segments(torch.as_tensor(ids[idx]), 100), torch.as_tensor(values[:, idx]), dim=1)
    np.testing.assert_array_equal(got2.numpy(), got)


def test_segment_sum_forward_mode_and_vmap():
    """The tangent of a segment sum is the segment sum of the tangents, and
    vmap (the autodiff path's jvp over tangent blocks, its batched line
    search) gives each batch member's own sums."""
    key, start, values = _runs(5, n=800, n_keys=60)
    v = torch.as_tensor(values, dtype=torch.float64)
    tangents = torch.as_tensor(np.random.default_rng(6).standard_normal((4, 800, 5)))

    def f(x):
        return voxel.run_sums(x, _all_runs(start))

    jvps = torch.func.vmap(lambda t: torch.func.jvp(f, (v,), (t,))[1])(tangents)
    each = torch.stack([f(t) for t in tangents])
    np.testing.assert_array_equal(jvps.numpy(), each.numpy())
    np.testing.assert_array_equal(torch.func.vmap(f)(tangents).numpy(), each.numpy())


def test_segment_mean_cov_fixed_order():
    rng = np.random.default_rng(7)
    n, n_seg = 4000, 60
    pts = (rng.standard_normal((n, 3)) * np.array([2.0, 1.0, 0.05]) + 30.0).astype(np.float32)
    cell = rng.integers(0, n_seg, size=n)
    w = (rng.uniform(size=n) > 0.2).astype(np.float32)
    out = [x.numpy() for x in gaussians.segment_mean_cov(torch.as_tensor(pts), torch.as_tensor(cell),
                                                          torch.as_tensor(w), n_seg)]
    again = gaussians.segment_mean_cov(torch.as_tensor(pts), torch.as_tensor(cell), torch.as_tensor(w), n_seg)
    for a, b in zip(again, out):
        np.testing.assert_array_equal(a.numpy(), b)
    _within_sequential_bound(out[1] * out[0][:, None], pts * w[:, None], cell, n_seg, rounded=2)
    idx = _regroup(cell, rng)
    moved = gaussians.segment_mean_cov(torch.as_tensor(pts[idx]), torch.as_tensor(cell[idx]),
                                       torch.as_tensor(w[idx]), n_seg)
    for a, b in zip(moved, out):
        np.testing.assert_array_equal(a.numpy(), b)


def test_build_cells_repeats_and_ignores_run_placement():
    """build_cells sorts by voxel key, so any input order with the same
    order within each voxel gives the same cells bit for bit."""
    rng = np.random.default_rng(8)
    n = 6000
    pts = (rng.standard_normal((n, 3)) * np.array([3.0, 2.0, 0.03]) + np.array([12.0, -4.0, 1.5])).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1
    rings = rng.integers(0, 16, size=n).astype(np.int32)
    args = (torch.as_tensor(pts), torch.as_tensor(mask), torch.as_tensor(rings), 0.6, 6)
    cells = gaussians.build_cells(*args)
    again = gaussians.build_cells(*args)
    for f in cells._fields:
        a, b = getattr(again, f), getattr(cells, f)
        for x, y in zip(a if f == "runs" else (a,), b if f == "runs" else (b,)):
            np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=f)
    assert int(cells.num_valid) > 20
    hi, lo = voxel.voxel_keys(args[0], args[1], 0.6)
    key = voxel.combined_key(hi, lo).numpy()
    _, vox = np.unique(key, return_inverse=True)
    idx = _regroup(vox, rng)
    moved = gaussians.build_cells(torch.as_tensor(pts[idx]), torch.as_tensor(mask[idx]),
                                  torch.as_tensor(rings[idx]), 0.6, 6)
    for f in ("info6", "lamw6", "mu0", "weight", "count", "valid", "num_valid"):
        np.testing.assert_array_equal(getattr(moved, f).numpy(), getattr(cells, f).numpy(), err_msg=f)


def test_hash_build_fixed_order():
    """The hash backend's cell build: one sort of the slot ids serves every
    sum; any input order with the same order within each slot gives the
    same cells bit for bit, and the slot means are the sequential f32
    sums."""
    rng = np.random.default_rng(9)
    n, table = 5000, 512
    pts = rng.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1
    rings = rng.integers(0, 16, size=n).astype(np.int32)

    def build(p, m, r):
        return sharded.build_cells_sharded(torch.as_tensor(p), torch.as_tensor(m), torch.as_tensor(r), 0.9, 4,
                                           table, pmesh.ONE_RANK)

    cells, (cid, keep) = build(pts, mask, rings)
    again, _ = build(pts, mask, rings)
    fields = ("info", "weight", "valid", "num_valid", "count", "mean")
    for f in fields:
        np.testing.assert_array_equal(getattr(again, f).numpy(), getattr(cells, f).numpy(), err_msg=f)
    kept = keep.numpy()
    sums = cells.mean.numpy() * cells.count.numpy()[:, None]
    _within_sequential_bound(sums, pts * kept[:, None].astype(np.float32), cid.numpy(), table, rounded=2)
    idx = _regroup(cid.numpy(), rng)
    moved, _ = build(pts[idx], mask[idx], rings[idx])
    for f in fields:
        np.testing.assert_array_equal(getattr(moved, f).numpy(), getattr(cells, f).numpy(), err_msg=f)
