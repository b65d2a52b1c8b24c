"""K1 (csrc/k1_build.cu) built for the CPU and held against its plain version
where runs outgrow one chunk.

tests/cuda_host.py builds the source with g++ under tests/cuda_warp_emu.h
(each thread of a block a fiber; __syncthreads and the warp intrinsics
as barriers), so the kernels' own control flow runs here: the
key kernel, the build's short runs and long-run pieces, the search of the
sorted keys where a chunk opens inside a run, and the finish that sums
each long run's pieces in chunk order.  On tests/torch_k1.py's problems
(the masked tail of a submap view, a valid cell over more than 8 chunks,
runs laid on chunk bounds, and every run within one chunk) in both
layouts, the host build's keys equal voxel.voxel_keys', its packed rows
meet build_packed_ref at K1's tolerances (the host's f32 rounds otherwise
than the card's), its counts equal the plain version's, and the long-run
positions it writes and adds to a counter equal a count over the sorted
keys' runs.  It also counts long-run positions, the plain version's count
through fused_residuals.long_positions_into (the counter the optimizer
records as <name>.gn.k1_long_positions).  ~10 s.
"""

import ctypes

import numpy as np
import pytest
import torch

from dmsa_lidar_slam_tpu_torch.ops import cuda_lib
from dmsa_lidar_slam_tpu_torch.ops import fused_residuals as fr
from dmsa_lidar_slam_tpu_torch.ops import voxel
from dmsa_lidar_slam_tpu_torch.ops.gaussians import COV_EIG_FLOOR
from tests import torch_k1
from tests.cuda_host import build_host
from tests.torch_parity import nn

CASES = {
    "submap_tail": lambda layout: torch_k1.submap_case(1, n_kf=16, ppk=256, active=4, extent=2.0, layout=layout),
    "giant_cell": lambda layout: torch_k1.submap_case(2, n_kf=16, ppk=512, active=8, giant=2400, extent=2.0,
                                                      layout=layout),
    "boundary": lambda layout: torch_k1.boundary_case(3, layout=layout),
    "short": lambda layout: torch_k1.short_case(4, layout=layout),
}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_host("k1_build.cu", "k1_build", cuda_lib._SIGNATURES["k1_build"], tmp_path_factory.mktemp("k1"),
                     header="cuda_warp_emu.h", launches=3)
    for name in ("k1_build_rows12", "k1_voxel_keys", "k1_scratch_bytes"):
        fn = getattr(lib, name)
        fn.argtypes = cuda_lib._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def host_build_packed(lib, args, kw):
    """build_packed's card path, run through the host build on CPU tensors:
    (packed, nvalid, num_raw, long-run positions written, added to a
    counter that held 5)."""
    world, mask, rings, xs, tidx, grid, min_points, tab = args
    split, obs = kw.get("split_ids"), kw.get("obs_weight")
    n = world.shape[0]
    P = cuda_lib.ptr
    g_host, grid_ptr = fr._grid_operand(grid, world.device)
    key = torch.empty(n, dtype=torch.int64)
    assert lib.k1_voxel_keys(P(world), P(mask), None if split is None else P(split), n, g_host, grid_ptr, P(key),
                             None) == 0
    assert torch.equal(key, voxel.combined_key(*voxel.voxel_keys(world, mask, grid, channel=split)))
    key_s, order = torch.sort(key, stable=True)
    packed = torch.full((fr.PACK_ROWS, n), float("nan"))
    nbytes = ctypes.c_longlong()
    assert lib.k1_scratch_bytes(n, ctypes.byref(nbytes)) == 0
    aux = torch.empty(2 + -(-nbytes.value // 8), dtype=torch.int64)
    acc = torch.tensor(5, dtype=torch.int64)
    tail = (P(xs), P(tidx), P(rings), P(mask), P(key_s), P(order), n, min_points, COV_EIG_FLOOR, P(packed),
            aux.data_ptr() + 16, aux.data_ptr() + 8, P(aux), aux.data_ptr() + 12, P(acc), None)
    if tab is None or obs is not None:
        assert lib.k1_build_rows12(P(world), None if obs is None else P(obs), *tail) == 0
    else:
        assert lib.k1_build(P(fr.prep_tables(tab)), *tail) == 0
    words = aux.view(torch.int32)
    return packed, int(words[2]), int(aux[0]), int(words[3]), int(acc) - 5


@pytest.mark.parametrize("layout", ["compact", "rows12"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_host_build_matches_plain_version(host_lib, case, layout):
    args, kw = CASES[case](layout)
    pk, nv, nr, long_out, long_added = host_build_packed(host_lib, args, kw)
    pk_r, nv_r, nr_r = fr.build_packed_ref(*args, **kw)
    assert (nv, nr) == (int(nv_r), int(nr_r))
    torch_k1.cmp_packed(nn(pk), nn(pk_r))
    want = torch_k1.long_positions(args, kw)
    assert long_out == long_added == want
    n = args[0].shape[0]
    if case == "short":
        assert want == 0
    else:
        assert want > n // 4
    if case == "giant_cell":
        assert torch_k1.longest_valid_run(nn(pk)) > 8 * fr.K1_CHUNK


@pytest.mark.parametrize("layout", ["compact", "rows12"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_counts_long_run_positions(case, layout):
    """build_packed on CPU tensors (its plain version) adds to the innermost
    counter the positions in runs longer than K1_CHUNK, as a count over the
    sorted keys' runs gives them, and to no counter outside
    long_positions_into."""
    args, kw = CASES[case](layout)
    outer, inner = torch.tensor(0), torch.tensor(0)
    fr.build_packed(*args, **kw)
    with fr.long_positions_into(outer):
        with fr.long_positions_into(inner):
            fr.build_packed(*args, **kw)
            fr.build_packed(*args, **kw)
        fr.build_packed(*args, **kw)
    want = torch_k1.long_positions(args, kw)
    assert (int(inner), int(outer)) == (2 * want, want)
    if case == "boundary":
        runs = np.array(torch_k1.BOUNDARY_RUNS)
        assert want == runs[runs > fr.K1_CHUNK].sum() + 1024
