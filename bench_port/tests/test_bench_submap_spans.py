"""The readers of the submap solve's child spans (submap.gn_iters,
submap.iter_ms; the spans themselves: tests/test_torch_metrics.py) on a
revisit-shaped run at the tiny size on the CPU: the loop mix past
the fill of the 6-keyframe ring, so that the window's one scan adds a
keyframe and solves the submap over 4 or more keyframes.  The run goes
through harness.run_cell, as the nc_os128.loop cell with a later warm-up,
from a temporary root holding BENCHMARK.json and the configuration cut to
the tiny size, and must be correct; the readers
read its Metrics.summary() and find nothing in a summary without a solve
(a program before the child spans, or a crawl window)."""

import json
from pathlib import Path

import numpy as np
import pytest

from bench_port import harness
from bench_port.tests import tiny

SEED = 2**31 + 1717
# the ring of 6 fills by scan 20 at the tiny size; from scan 17 each scan
# adds a keyframe and solves over 4 keyframes
WARMUP = 22
CHILDREN = ("submap.view", "submap.optimize", "submap.write_back")
READERS = ("submap.gn_iters", "submap.iter_ms")


@pytest.fixture(scope="module")
def revisit(root, tmp_path_factory):
    """(result, extras, the window's summary) of the tiny revisit run."""
    from dmsa_lidar_slam_tpu_torch.pipeline import metrics as pm

    tmp = tmp_path_factory.mktemp("revisit_root")
    (tmp / "BENCHMARK.json").write_text((Path(root) / "BENCHMARK.json").read_text())
    cfg = json.loads((Path(root) / "bench_port" / "configs" / "nc_os128.json").read_text())
    cfg["pipeline"].update(tiny.OVERRIDES)
    cfg["stream"].update(points_per_scan=1000)
    (tmp / "bench_port" / "configs").mkdir(parents=True)
    (tmp / "bench_port" / "configs" / "nc_os128.json").write_text(json.dumps(cfg))
    loaded = tiny.loaded(str(tmp), warmup=WARMUP, segment=(WARMUP, WARMUP + 2), prewarm=1, name="nc_os128.loop")
    summaries = []
    summary = pm.Metrics.summary

    def recorded(self):
        s = summary(self)
        summaries.append(s)
        return s

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pm.Metrics, "summary", recorded)
        result, extras = harness.run_cell(str(tmp), "nc_os128.loop", SEED, 1e-3, 0, device="cpu", loaded=loaded)
    # the harness reads the summary once, at the window's end
    return result, extras, summaries[0]


def test_revisit_shaped_run_is_correct(revisit):
    result, extras, s = revisit
    assert result["correct"], (result["checks"], extras["numbers"])
    steps = {k: v for k, v in extras["numbers"].items() if k != "ate_m"}
    assert all(v == 0.0 for v in steps.values()), extras["numbers"]
    assert extras["keyframe_scans"] >= 1
    # every solve of the window spans 4 or more of the ring's 6 keyframes
    solves = s["keyframe.submap"]["calls"]
    assert solves >= 1 and s["submap.span"]["count"] >= 4 * solves


def _run(stages):
    return dict(scan_s=[0.5], is_kf=[True], stages=stages, profile=None, rooflines=None)


def test_readers_read_the_summary(root, revisit):
    _, _, s = revisit
    iters = harness.read_metric("submap.gn_iters", _run(s))
    assert iters == s["submap.gn.iters"]["count"] / s["submap.optimize"]["calls"]
    assert 1 <= iters <= harness.load_cell(root, "nc_os128.loop")[1]["pipeline"]["num_iter_keyframe_optim"]
    ms = harness.read_metric("submap.iter_ms", _run(s))
    assert np.isfinite(ms) and ms > 0
    assert ms == pytest.approx(1e3 * s["submap.optimize"]["total_s"] / s["submap.gn.iters"]["count"], rel=1e-12)


@pytest.mark.parametrize("program", ["parent", "crawl"])
@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_a_solve(revisit, program, name):
    """A parent records submap.gn.* under keyframe.submap with no child
    spans; a crawl window runs no solve at all."""
    _, _, s = revisit
    if program == "parent":
        stages = {k: v for k, v in s.items() if k not in CHILDREN}
    else:
        stages = {k: v for k, v in s.items() if not k.startswith("submap.") and k != "keyframe.submap"}
    assert harness.read_metric(name, _run(stages)) is None


def test_readers_are_listed_for_the_loop_type_cells(root):
    manifest = harness.load_manifest(root)
    for name in READERS:
        for cell in ("nc_os128.loop", "hilti_xt32.handheld"):
            assert name in {m["name"] for m in harness.metrics_for(manifest, cell, "per_layer")}
        assert name not in {m["name"] for m in harness.metrics_for(manifest, "nc_os64.crawl", "per_layer")}
