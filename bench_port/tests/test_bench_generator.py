"""The frozen traffic generator: golden digests of a 3-scan stream, and
the same bits as the port's own generator and the stressors of its
chip_smoke.py."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from bench_port import generator

LOOP = json.loads((Path(__file__).resolve().parents[1] / "traffic" / "loop.json").read_text())
GOLDEN = {
    3: "cbaf8af384bc1e3a6057f2d69076c1cbe25f462b45be3f8dcbf6987a0ee597fc",
    4: "4e566a82917e6bcd62d7bb4c3164e4032d8b363d8d358cb58d2c39178ff005e1",
}


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
