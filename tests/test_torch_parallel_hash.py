"""Port vs reference: the distributed backends' hashing and the owner
shuffle (parallel/spatial.py, parallel/sharded.py).

The port keeps the reference's uint32 arithmetic in int64 (the murmur
finalizer's multiplies split in 16-bit halves), so every hash is compared
bit for bit: the hash backend's cell ids and voxel check keys, and the
spatial backend's owners, on the same points made from a seed, including
negative and large coordinates and coordinates on voxel boundaries.  The
owner shuffle runs on 4 gloo ranks (tests/torch_dist.py) and on a 2-rank
subgroup; the reference on a 4-device (and 2-device) CPU mesh.  Received
rows, overflow counts and the slot owners' keep mask are equal bit for
bit: no floating-point arithmetic is involved.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from dmsa_lidar_slam_tpu.parallel import sharded as jsh
from dmsa_lidar_slam_tpu.parallel import spatial as jsp
from dmsa_lidar_slam_tpu_torch.ops import voxel
from dmsa_lidar_slam_tpu_torch.parallel import sharded, spatial
from tests import torch_dist

N, GRID, SMALL_CAP, TABLE = 2048, 0.7, 96, 64


def _points(seed=3, n=N, grid=GRID):
    """Uniform points in a 10 m cube, a share masked, plus points far out
    (+-2e4 m), negative ones and points on voxel boundaries (k * grid in
    f32, where the division may round either way)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-5, 5, size=(n, 3)).astype(np.float32)
    pts[:64] = rng.uniform(-2e4, 2e4, size=(64, 3))
    k = rng.integers(-40, 40, size=(256, 3)).astype(np.float32)
    pts[64:320] = k * np.float32(grid)
    pts[320:384] = -pts[320:384]
    mask = rng.uniform(size=n) > 0.1
    return pts, mask


@pytest.mark.parametrize("grid", [0.7, 0.3, 0.25])
def test_hashes_match_reference_bit_for_bit(grid):
    pts, mask = _points(grid=grid)
    jp, jm, jg = jnp.asarray(pts), jnp.asarray(mask), jnp.float32(grid)
    tp, tm, tg = torch.as_tensor(pts), torch.as_tensor(mask), torch.tensor(grid, dtype=torch.float32)
    for table in (TABLE, 65536):
        np.testing.assert_array_equal(sharded.hash_cell_ids(tp, tm, tg, table).numpy(),
                                      np.asarray(jsh.hash_cell_ids(jp, jm, jg, table)))
    for got, want in zip(sharded._voxel_check_keys(tp, tm, tg), jsh._voxel_check_keys(jp, jm, jg)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for n_dev in (1, 2, 3, 4, 8):
        np.testing.assert_array_equal(spatial.owner_of_voxels(tp, tm, tg, n_dev).numpy(),
                                      np.asarray(jsp.owner_of_voxels(jp, jm, jg, n_dev)))
    # the owners hash the voxel the cell build keys: the same floor(p / grid)
    c = voxel.voxel_coords(tp, tg) - (1 << 14)
    np.testing.assert_array_equal(c.numpy(), np.floor(pts / np.float32(grid)).astype(np.int32))


def _reference_shuffle(pts, mask, n_dev, cap):
    """The reference's shuffle on an n_dev-device mesh: per device its
    received rows and mask, and the overflow psum'd over the mesh.  The
    grid is an argument of the jitted function, as in the reference's
    optimizers: a constant grid would let XLA divide by multiplying with
    its reciprocal, which rounds points on voxel boundaries differently."""
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("data",))

    def body(p, m, g):
        owner = jsp.owner_of_voxels(p, m, g, n_dev)
        recv, rmask, ov = jsp.shuffle_to_owners(p, owner, n_dev, cap, "data")
        return recv, rmask, jax.lax.psum(ov, "data")

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"), P("data"), P()),
                           out_specs=(P("data"), P("data"), P())))
    recv, rmask, ov = fn(jnp.asarray(pts), jnp.asarray(mask), jnp.float32(GRID))
    return np.asarray(recv).reshape(n_dev, -1, 3), np.asarray(rmask).reshape(n_dev, -1), int(ov)


def _reference_keep(pts, mask, n_dev):
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("data",))

    def body(p, m, g):
        return jsh.elect_slot_owners(p, m, jsh.hash_cell_ids(p, m, g, TABLE), g, TABLE, "data")

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"), P("data"), P()), out_specs=P("data")))
    return np.asarray(fn(jnp.asarray(pts), jnp.asarray(mask), jnp.float32(GRID)))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    pts, mask = _points()
    return torch_dist.run_ranks(torch_dist.shuffle_and_elect, 4, tmp_path_factory.mktemp("hash"), pts, mask,
                                GRID, SMALL_CAP, TABLE)


def test_meshes(ranks4):
    """make_mesh over the world and over a subgroup: members, mesh ranks;
    make_mesh_2d(2, 2): rank d * 2 + m is in the data mesh of the ranks
    with model index m and the model mesh of those with data index d;
    psum and replicated over each."""
    for r, out in enumerate(ranks4):
        assert out["mesh"] == ((0, 1, 2, 3), r, "gloo", (0, 1), r if r < 2 else -1)
        assert ("pair" in out) == (r < 2)
        d, m = divmod(r, 2)
        data_ranks, model_ranks = (m, 2 + m), (2 * d, 2 * d + 1)
        assert out["grid"] == [(data_ranks, d, float(sum(data_ranks)), float(data_ranks[0])),
                               (model_ranks, m, float(sum(model_ranks)), float(model_ranks[0]))]


@pytest.mark.parametrize("name,n_dev", [("full", 4), ("pair", 2)])
def test_shuffle_roundtrip_exact(ranks4, name, n_dev):
    """Every unmasked point arrives at exactly one owner, the one its voxel
    hashes to, none duplicated, none dropped at the default cap; each rank
    receives the reference's rows in the reference's order (the default
    cap: twice the balanced share per sender and receiver)."""
    pts, mask = _points()
    recv = np.stack([ranks4[r][name]["recv"].numpy() for r in range(n_dev)])
    rmask = np.stack([ranks4[r][name]["rmask"].numpy() for r in range(n_dev)])
    assert ranks4[0][name]["overflow"] == 0
    got = recv[rmask]
    assert len(got) == int(mask.sum())
    want = pts[mask]
    np.testing.assert_array_equal(got[np.lexsort(got.T)], want[np.lexsort(want.T)])
    for d in range(n_dev):
        owner = spatial.owner_of_voxels(torch.as_tensor(recv[d]), torch.as_tensor(rmask[d]),
                                        torch.tensor(GRID, dtype=torch.float32), n_dev)
        assert bool((owner[torch.as_tensor(rmask[d])] == d).all())
    j_recv, j_rmask, j_ov = _reference_shuffle(pts, mask, n_dev, spatial.bucket_cap(N, n_dev))
    assert j_ov == 0
    np.testing.assert_array_equal(rmask, j_rmask)
    np.testing.assert_array_equal(recv, j_recv)


def test_overflow_counts_match_reference(ranks4):
    """At a cap below the balanced share, the points dropped (counted, not
    silent) equal the reference's count; the rows that fit are its rows."""
    pts, mask = _points()
    got = ranks4[0]["small_cap"]["overflow"]
    j_recv, j_rmask, j_ov = _reference_shuffle(pts, mask, 4, SMALL_CAP)
    assert got == j_ov > 0
    assert all(r["small_cap"]["overflow"] == got for r in ranks4)
    np.testing.assert_array_equal(np.stack([r["small_cap"]["rmask"].numpy() for r in ranks4]), j_rmask)
    np.testing.assert_array_equal(np.stack([r["small_cap"]["recv"].numpy() for r in ranks4]), j_recv)


def test_elect_slot_owners_matches_reference(ranks4):
    """The keep mask over 4 ranks equals the reference's on a 4-device mesh
    (a 64-slot table, so slots collide), and keeps one voxel per slot."""
    pts, mask = _points()
    keep = np.concatenate([r["keep"].numpy() for r in ranks4])
    np.testing.assert_array_equal(keep, _reference_keep(pts, mask, 4))
    g = torch.tensor(GRID, dtype=torch.float32)
    tp, tm = torch.as_tensor(pts), torch.as_tensor(mask)
    cid = sharded.hash_cell_ids(tp, tm, g, TABLE).numpy()
    key = voxel.combined_key(*voxel.voxel_keys(tp, tm, g)).numpy()
    assert keep.sum() < mask.sum()  # collisions dropped some voxels
    for slot in np.unique(cid[keep]):
        assert len(np.unique(key[keep & (cid == slot)])) == 1
