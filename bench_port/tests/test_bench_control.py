"""The control of the check that decides `correct`, at a size a test run
holds: the plain reference computed one step below each precision the
configuration states (float32 pose math for float64, TF32 matmuls for
float32 with TF32 off) takes the program's place, and the check must find
it not correct, while the program, checked in the same run, is correct.
At the cells' own sizes the control runs through bench_port/control.py;
PERF.md gives its readings."""

import pytest

from bench_port import compare, harness
from bench_port.tests import tiny


@pytest.mark.gpu
def test_control_is_not_correct(root, card):
    import torch

    loaded = tiny.loaded(root, segment=(8, 12))
    result, extras = harness.run_cell(root, "nc_os128.loop", 31337, 1e-3, 0, device="cuda", loaded=loaded,
                                      control=torch.float32)
    ok, checks = compare.verdict(extras["control_numbers"], loaded[2]["limits"])
    assert not ok, checks
    assert result["correct"], (result["checks"], extras["numbers"])
