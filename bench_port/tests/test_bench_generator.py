"""The frozen traffic generator: golden digests of a 3-scan stream, the
streams and analytic poses of each cell of BENCHMARK.json as the harness
makes them (pinned before the sensor rig was added), and the same bits as
the port's own generator and the stressors of its chip_smoke.py."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from bench_port import generator

BENCH = Path(__file__).resolve().parents[1]
LOOP = json.loads((BENCH / "traffic" / "loop.json").read_text())
GOLDEN = {
    3: "cbaf8af384bc1e3a6057f2d69076c1cbe25f462b45be3f8dcbf6987a0ee597fc",
    4: "4e566a82917e6bcd62d7bb4c3164e4032d8b363d8d358cb58d2c39178ff005e1",
}


# (configuration, mix): seed -> the stream's digest, "truth" -> the analytic
# poses' at TRUTH_STAMPS; the parent's values, taken before the rig existed
PINNED = {
    ("nc_os128", "loop"): {
        3: "2417a63949afc95d3d8cd88f11264f40e12dbfa462043864c7d6eb5ff059db16",
        4: "23f1f5069f7f6edf3222aedbb2511a6e0cf438686c258093e2b07d88ec6e90c5",
        "truth": "e9e0023f60aa27e719428658fed9b72d736f552be859d26bdccd0e5f6bfc8fb5",
    },
    ("nc_os64", "crawl"): {
        3: "52990697b9eca40f1901078c7b73aa45c34de03ad9c67b24a6e2d31474375461",
        4: "e9ff035fe8612c1f36d8675a255fa78df8b77aef285c175ec7ff78a81da8c392",
        "truth": "2c64ccb96a7e5a74595eaa8fff1cdf4e6681e4ffa901cdeeb910191d2af95c57",
    },
}
TRUTH_STAMPS = np.linspace(-0.5, 9.0, 20)  # after t_start: the still start, the ramp, the run


def _digest(data):
    h = hashlib.sha256()
    for rec in data:
        for a in rec:
            h.update(a.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed", sorted(GOLDEN))
def test_golden_digest(seed):
    data = generator.stream(seed, LOOP["sequence"], 3, 2048, 16, 400, LOOP["stressors"])
    assert _digest(data) == GOLDEN[seed]


@pytest.mark.parametrize("cell,key", [(c, k) for c, v in PINNED.items() for k in v])
def test_cells_read_the_pinned_streams(cell, key):
    """Each cell's configuration and mix, its rig included, as run_cell
    reads them: 3 scans of 2,048 points over the configuration's rings, or
    the analytic poses at 20 stamps."""
    cfg = json.loads((BENCH / "configs" / f"{cell[0]}.json").read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell[1]}.json").read_text())
    rig, st = generator.rig(cfg), cfg["stream"]
    if key == "truth":
        seq = generator.truth(traffic["sequence"], rig)
        data = [seq.pose(float(t)) for t in seq.t_start + TRUTH_STAMPS]
    else:
        data = generator.stream(key, traffic["sequence"], 3, 2048, st["rings"], st["imu_rate_hz"],
                                traffic["stressors"], rig=rig)
    assert _digest(data) == PINNED[cell][key]


def test_matches_the_ports_generator():
    from chip_smoke import apply_long_stressors, sequence_data
    from dmsa_lidar_slam_tpu_torch.io.synthetic import long_sequence

    ours = generator.stream(5, LOOP["sequence"], 39, 600, 128, 400, LOOP["stressors"])
    theirs = apply_long_stressors(sequence_data(long_sequence(5), 39, 600, 128))
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert len(ours[37][0]) == 150  # scan 37 truncated to 25%


def test_large_seed():
    a = generator.stream(2**31 + 12345, LOOP["sequence"], 2, 256, 16, 400, {})
    b = generator.stream(2**31 + 12345, LOOP["sequence"], 2, 256, 16, 400, {})
    assert _digest(a) == _digest(b)
