"""The harness's run at a tiny size on the CPU (bench_port/tests/tiny.py):
the replay restores the state the segment starts from, the reference
agrees with the port's pure-torch path bit for bit, nothing of JAX is
loaded, and run.py refuses to run without a card."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench_port import compare, harness
from bench_port.tests import tiny

SEED = 2**31 + 77


@pytest.fixture(scope="module")
def dry(root):
    """One dry run (no card) of the tiny cell through two passes."""
    result, extras = harness.run_cell(root, "nc_os128.loop", SEED, 1e-3, 0, device="cpu",
                                      loaded=tiny.loaded(root, segment=(8, 10)))
    return result, extras


def test_replay_restores_identical_poses(root):
    """A pass from the checkpoint repeats the first pass bit for bit."""
    from dmsa_lidar_slam_tpu_torch.config import Config
    from dmsa_lidar_slam_tpu_torch.pipeline.checkpoint import load_fused_checkpoint, save_fused_checkpoint
    from dmsa_lidar_slam_tpu_torch.pipeline.fused import FusedDmsaSlam

    from bench_port import generator

    _, cfg, traffic, _ = tiny.loaded(root)
    data = generator.stream(SEED, traffic["sequence"], 11, 1000, 128, 400, {})
    pipeline = {k: (tuple(v) if isinstance(v, list) else v) for k, v in cfg["pipeline"].items()}
    slam = FusedDmsaSlam(Config(**pipeline), device="cpu")
    for rec in data[:8]:
        harness.feed(slam, rec)
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"bench_port_test_{os.getpid()}.npz")
    save_fused_checkpoint(slam, path)
    try:
        passes = []
        for _ in range(2):
            load_fused_checkpoint(slam, path)
            for rec in data[8:11]:
                harness.feed(slam, rec)
            passes.append((slam.state.ow_transl.clone(), slam.state.ow_orient.clone(), slam.state.kf.transl_w.clone()))
    finally:
        os.remove(path)
    for a, b in zip(*passes):
        assert torch.equal(a, b)


def test_dry_run_is_correct(dry):
    result, extras = dry
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "cpu"
    assert extras["passes"] >= 1 and result["attempted"] >= 1
    assert ["warm", "5"] in extras["checked_steps"]


def test_reference_matches_the_port_bit_for_bit(dry):
    """On the CPU the port runs its kernels' plain versions, which the
    reference copies: every number of the step-by-step check reads 0 (the
    trajectory's error against the analytic poses is no such number)."""
    _, extras = dry
    steps = {k: v for k, v in extras["numbers"].items() if k != "ate_m"}
    assert all(v == 0.0 for v in steps.values()), extras["numbers"]
    assert set(compare.COMPARED) <= set(extras["numbers"])


def test_no_jax_after_the_dry_path(root):
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from bench_port import harness\n"
        "from bench_port.tests import tiny\n"
        "harness.run_cell(%r, 'nc_os128.loop', 5, 1e-3, 0, device='cpu', loaded=tiny.loaded(%r, segment=(8, 9)))\n"
        "print('LOADED', harness.forbidden_modules())\n" % (root, root, root)
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "LOADED []"


def test_run_fails_without_a_card(root):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "nc_os128.loop", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=root, capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "dmsa_lidar_slam_tpu_torch_fake", object())
    assert "dmsa_lidar_slam_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.fake_sub", object())
    assert "jax.fake_sub" in harness.forbidden_modules()


@pytest.mark.gpu
def test_tiny_run_on_the_card(root, card):
    """The harness at the tiny size on the card: the kernels run, and the
    check holds them against the plain reference."""
    from dmsa_lidar_slam_tpu_torch.ops import cuda_lib

    cuda_lib.reset_launches()
    result, extras = harness.run_cell(root, "nc_os128.loop", SEED, 1e-3, 1, device="cuda",
                                      loaded=tiny.loaded(root, segment=(8, 12)))
    assert cuda_lib.LAUNCHES["build_packed"] > 0 and cuda_lib.LAUNCHES["min_sq_dist"] > 0
    assert result["correct"], (result["checks"], extras["numbers"])
    assert result["device"]["busy_s"] > 0
    assert np.isfinite(result["metrics"]["step.launches_per_scan"]["value"])
