"""BENCHMARK.json against the files it names: every cell resolves by name
to its configuration and mix, every per-layer metric to its reader, and
every name and unit keeps to the allowed characters."""

import json
import re
from pathlib import Path

import pytest

from bench_port import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_resolves(root, cell):
    entry, cfg, traffic, _ = harness.load_cell(root, cell)
    assert entry["name"] == f"{entry['config']}.{entry['traffic']}" == cell
    assert cfg["name"] == entry["config"] and traffic["name"] == entry["traffic"]
    assert entry["chips"] == 1
    lo, hi = traffic["segment"]
    assert traffic["warmup_scans"] == lo < hi
    # the width of the stream is never cut: the raw cap holds a whole sweep
    assert cfg["pipeline"]["raw_scan_cap"] == cfg["stream"]["points_per_scan"]
    conf = {c["name"]: c for c in MANIFEST["configs"]}[cell.split(".")[0]]
    assert sorted(conf["reduced"]) == sorted(cfg["reduced"]) == sorted(cfg["upstream"])
    e2e = harness.metrics_for(MANIFEST, cell, "end_to_end")
    assert {"setup_s", "realtime_x", "scan_ms_p90"} <= {m["name"] for m in e2e}
    assert harness.metrics_for(MANIFEST, cell, "per_layer")
    from bench_port import compare

    assert set(traffic["limits"]) == set(compare.COMPARED)


def test_names_and_units():
    names = [w["name"] for w in MANIFEST["workloads"]] + [c["name"] for c in MANIFEST["configs"]]
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w[k] for w in MANIFEST["workloads"] for k in ("config", "traffic")]
    names += [k for c in MANIFEST["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)


def test_per_layer_readers():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert (ROOT / "bench_port" / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        layers.setdefault(m["layer"], set()).add(m["name"].split(".")[0])
    # one layer, one name, letter for letter
    assert all(len(v) == 1 for v in layers.values()), layers
    for m in MANIFEST["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_readers_find_nothing_without_a_profile():
    run = dict(scan_s=[0.5, 0.6], is_kf=[False, False], stages={}, profile=None, rooflines=None)
    for m in MANIFEST["per_layer"]:
        v = harness.read_metric(m["name"], run)
        assert v is None or m["name"] == "window.scan_ms", (m["name"], v)
