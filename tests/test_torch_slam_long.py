"""Port vs reference: the host-orchestrated pipeline DmsaSlam at the long
configuration's semantics (io/synthetic.long_config: no submap cap, so each
solve takes the suffix [minRelatedKeyId..end], the port's
pipeline/slam.py _keyframe_optimization; a keyframe ring that fills and
retires; raw scans over 128 rings; bench.py's sensor stressors), cut in
width and ring size as tests/test_torch_long.py cuts it.

Both pipelines run long_sequence(3), N_SCANS scans of PTS raw points over
128 rings, with long_config(**OVERRIDES) (tests/test_torch_long.py's:
600 points per scan, 1,024-point keyframe clouds, a 6-keyframe ring, a
keyframe every 0.1 m, 5-point cells; the raw cap at 2,048), and the
stressors in miniature (chip_smoke.apply_long_stressors): scan SHORT_SCAN
cut to 25% of its points, and the IMU dropped for bench.py's three scans
BENCH_DROPOUT (14-16), held in two parts:
  - the free runs drop the IMU of DROPOUT (14, 15) only, and are held over
    all N_SCANS scans;
  - the three-scan dropout is held step by step, as tests/test_torch_long.py
    holds its stressed steps: the reference continues from its own state
    before scan 16 (the data agree up to there) with scan 16's IMU dropped
    too, and the port replays each no-IMU window and the keyframe step
    after them (REPLAYED) from the reference's checkpoint
    (pipeline/checkpoint.py, which crosses between the packages) before
    each.
The port's downsamplings take the reference's own jax PRNG bits
(tests/torch_parity.jax_counter_priorities), as tests/test_torch_slam.py
does.  Each package's submap solves are recorded by
chip_smoke.record_submaps (scan, keyframes added, from_id, span).

Why the free runs take 2,000 points and two no-IMU scans: the no-IMU
windows run all 10 iterations at alpha 0.3 without converging, and carry a
difference in their starting state forward instead of damping it.  From
the reference's state each such step agrees within STEP_ATOL (the replay
below); in the free runs the states already differ by the cell-build
rounding of every earlier window, and with the third no-IMU scan that
difference grows until a later 0.1 m keyframe decision falls the other
way.  At 1,000 raw points the free runs keep the same discrete record but
drift beyond 1 cm.

Tolerances, with their reasons (tests/test_torch_slam.py's):
  - discrete outcomes are equal: keyframes added, the ring's count, the
    random draws, the submap solves with their from_ids and spans, the
    retirements into the output ledger; the run must retire a keyframe,
    solve a submap after the first retirement and reach a span of at least
    MIN_SPAN;
  - each window's Gauss-Newton run differs by the 2% cell-build rounding
    (tests/test_torch_structured.py), which feeds the next window's
    initial guess, so over the free runs keyframe and output positions
    agree within POS_ATOL (1 cm), and a replayed step's keyframes and
    window control positions within STEP_ATOL (5 mm, one replayed pipeline
    step, ROADMAP.md's "Not faults");
  - each pipeline's ATE under the reference's small-run gate (0.15 m).

The file takes ~2 min of CPU time: the port's structured window optimizer
takes ~2.5-4 s per scan here, and 22 scans are the fewest that reach the
ring's first retirement (scan 20) and a solve after it.
"""

import numpy as np
import pytest

from chip_smoke import apply_long_stressors, record_submaps, sequence_data
from dmsa_lidar_slam_tpu.io import synthetic as jsyn
from dmsa_lidar_slam_tpu.pipeline import checkpoint as jck
from dmsa_lidar_slam_tpu.pipeline.slam import DmsaSlam as JaxDmsaSlam
from dmsa_lidar_slam_tpu_torch.io import synthetic as tsyn
from dmsa_lidar_slam_tpu_torch.pipeline import checkpoint as tck
from dmsa_lidar_slam_tpu_torch.pipeline.slam import DmsaSlam
from tests.test_torch_long import LONG_OVERRIDES, RINGS
from tests.torch_parity import jax_counter_priorities

N_SCANS, PTS = 22, 2000
OVERRIDES = dict(LONG_OVERRIDES, raw_scan_cap=2048)
DROPOUT = (14, 15)
BENCH_DROPOUT = (14, 15, 16)
REPLAYED = (14, 15, 16, 17)
SHORT_SCAN = 20
POS_ATOL = 1e-2
STEP_ATOL = 5e-3
ATE_GATE = 0.15
MIN_SPAN = 3


def _step(slam, record):
    pts, stamps, rings, ts, acc, gyr = record
    slam.process_imu_batch(acc, gyr, ts)
    slam.process_scan(pts, stamps, rings)


def _after(slam, solves):
    """What a replayed step is held to: the discrete record, the keyframe
    positions and the window's control positions."""
    n = slam.kf_map.count
    return dict(count=n, updates=slam.kf_map.num_updates, retired=slam.output.num_static_keyframes,
                draws=slam._prng_counter, solves=list(solves), kf=np.array(slam.kf_map.transl_w[:n]),
                window=np.array(slam.old_window.transl_w))


def _reference(slam, data, start, stop, ckdir, saved, after):
    """Drive the reference over data[start:stop], its checkpoint written
    before each scan in `saved` and its state after each scan in REPLAYED
    kept in `after`."""
    solves = record_submaps(slam)
    for i in range(start, stop):
        if i in saved:
            jck.save_checkpoint(slam, str(ckdir / f"{i}.npz"))
        n0 = len(solves)
        _step(slam, data[i])
        if i in REPLAYED:
            after[i] = _after(slam, solves[n0:])
    return solves


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ckdir = tmp_path_factory.mktemp("slam_long")
    seq = jsyn.long_sequence(3)
    clean = sequence_data(seq, N_SCANS, PTS, RINGS)
    data = apply_long_stressors(clean, dropout=DROPOUT, every=SHORT_SCAN, after=SHORT_SCAN - 1)
    bench = apply_long_stressors(clean, dropout=BENCH_DROPOUT, every=SHORT_SCAN, after=SHORT_SCAN - 1)
    apart = BENCH_DROPOUT[-1]
    after = {}
    jslam = JaxDmsaSlam(jsyn.long_config(**OVERRIDES))
    jsolves = _reference(jslam, data, 0, N_SCANS, ckdir, [i for i in REPLAYED if i <= apart], after)
    after = {i: a for i, a in after.items() if i < apart}
    cont = jck.load_checkpoint(JaxDmsaSlam(jsyn.long_config(**OVERRIDES)), str(ckdir / f"{apart}.npz"))
    _reference(cont, bench, apart, max(REPLAYED) + 1, ckdir, REPLAYED, after)
    tslam = DmsaSlam(tsyn.long_config(**OVERRIDES), device="cpu")
    tslam.priorities = jax_counter_priorities
    tsolves = record_submaps(tslam)
    for record in data:
        _step(tslam, record)
    return dict(jslam=jslam, jsolves=jsolves, tslam=tslam, tsolves=tsolves, seq=seq, data=data, bench=bench,
                ckdir=ckdir, after=after)


def test_long_semantics_held(runs):
    jslam, jsolves, tslam = runs["jslam"], runs["jsolves"], runs["tslam"]
    K = tslam.map_shapes.n_keyframes
    assert tslam.config.submap_max_keyframes is None and K == 6
    assert jslam.output.num_static_keyframes >= 1, "the ring never retired a keyframe"
    assert max(s for *_, s in jsolves) >= MIN_SPAN, jsolves
    assert any(updates > K for _, updates, _, _ in jsolves), f"no solve after the first retirement: {jsolves}"


def test_same_keyframes_solves_and_retirements(runs):
    jslam, jsolves, tslam, tsolves = runs["jslam"], runs["jsolves"], runs["tslam"], runs["tsolves"]
    assert tslam.kf_map.count == jslam.kf_map.count == 6
    assert tslam.kf_map.num_updates == jslam.kf_map.num_updates
    assert tslam._prng_counter == jslam._prng_counter
    assert tsolves == jsolves
    assert tslam.output.num_static_keyframes == jslam.output.num_static_keyframes
    assert tslam.output.order_is_key == jslam.output.order_is_key
    n = jslam.kf_map.count
    np.testing.assert_allclose(tslam.kf_map.stamps[:n], jslam.kf_map.stamps[:n], atol=1e-9)


def test_positions_and_ate(runs, tmp_path):
    jslam, tslam, seq = runs["jslam"], runs["tslam"], runs["seq"]
    n = jslam.kf_map.count
    np.testing.assert_allclose(tslam.kf_map.transl_w[:n], jslam.kf_map.transl_w[:n], atol=POS_ATOL)
    jlines = open(jslam.save_poses(str(tmp_path / "jax"))).read().split("\n")
    tlines = open(tslam.save_poses(str(tmp_path / "torch"))).read().split("\n")
    j = np.array([[float(v) for v in l.split()] for l in jlines if l])
    t = np.array([[float(v) for v in l.split()] for l in tlines if l])
    assert t.shape == j.shape and len(t) > N_SCANS // 2
    np.testing.assert_allclose(t[:, 0], j[:, 0], atol=1e-6)
    np.testing.assert_allclose(t[:, 1:4], j[:, 1:4], atol=POS_ATOL)
    for poses in (j, t):
        assert jsyn.ate_rmse(poses[:, 0], poses[:, 1:4], seq) < ATE_GATE


def test_bench_dropout_replayed_from_reference_state(runs):
    """bench.py's three-scan dropout: each no-IMU window and the keyframe
    step after them, replayed by the port from the reference's checkpoint
    before it, with the reference's bits."""
    data, bench, after = runs["data"], runs["bench"], runs["after"]
    apart = BENCH_DROPOUT[-1]
    for a, b in zip(data[:apart], bench[:apart]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert all(len(bench[i][3]) == 0 for i in BENCH_DROPOUT) and len(data[apart][3]) > 0
    assert sorted(after) == list(REPLAYED)
    assert after[max(REPLAYED)]["solves"], "no keyframe step after the dropout"
    for i in REPLAYED:
        port = tck.load_checkpoint(DmsaSlam(tsyn.long_config(**OVERRIDES), device="cpu"),
                                   str(runs["ckdir"] / f"{i}.npz"))
        port.priorities = jax_counter_priorities
        solves = record_submaps(port)
        _step(port, bench[i])
        got, want = _after(port, solves), after[i]
        for k in ("count", "updates", "retired", "draws", "solves"):
            assert got[k] == want[k], (i, k, got[k], want[k])
        np.testing.assert_allclose(got["kf"], want["kf"], atol=STEP_ATOL, err_msg=f"keyframes after scan {i}")
        np.testing.assert_allclose(got["window"], want["window"], atol=STEP_ATOL, err_msg=f"window after scan {i}")
