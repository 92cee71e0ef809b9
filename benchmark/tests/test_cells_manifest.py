"""BENCHMARK.json against the benchmark's contract, and the files it names:
names, units, metrics each listed cell reports, configurations in use, and
that a cell, a traffic mix, a configuration or a metric is added by files
and entries alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark.harness import core, drivers, stats
from benchmark.tests._small import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
BENCH = core.Bench(REPO)


def test_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("benchmark/") and (REPO / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
        names.append(w["name"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m["name"]
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_moves_a_metric_each_listed_cell_reports():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and LINE.match(m["layer"])
        for cell in m["workloads"]:
            assert cell in cells
            assert m["moves"] in {x["name"] for x in BENCH.metrics(BENCH.cell(cell), False)}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    for w in MANIFEST["workloads"]:
        traced = BENCH.metrics(w, True)
        assert traced, w["name"]
        assert {"setup_s"} < {m["name"] for m in BENCH.metrics(w, False)}


def test_every_file_is_there_and_every_configuration_used():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    for w in MANIFEST["workloads"]:
        assert (REPO / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        limits = BENCH.limits(w)["limits"]
        assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert callable(BENCH.reader(m["name"]))
    for c in MANIFEST["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["precision"] == "float32" and cfg["assumed"]


def _ctx(**kw):
    ctx = {"cell": "x", "setup_s": 12.5, "window_s": 2.0, "submitted": {}, "completed": {},
           "host_reads": 0, "calls": [], "device_window_ms": None, "kernels": {}}
    ctx.update(kw)
    return ctx


@pytest.mark.parametrize("what", ["cell", "metric", "config", "kind"])
def test_added_by_files_and_entries_alone(tmp_path, what):
    """A new cell (its traffic mix and limits), configuration, metric or
    session kind in a copy of the benchmark is found by name, with no file
    edited but the manifest's new entries."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp_path / "benchmark"
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cell = {"name": "kitti05.crawl", "config": "kitti05_stereo", "traffic": "crawl", "chips": 1,
            "why": "0.05 m a frame: almost no keyframes"}
    if what == "config":
        cfg = json.loads((b / "configs" / "kitti05_stereo.json").read_text())
        cfg["name"] = "kitti00_stereo"
        (b / "configs" / "kitti00_stereo.json").write_text(json.dumps(cfg))
        man["configs"].append({"name": "kitti00_stereo", "source": "x",
                               "file": "benchmark/configs/kitti00_stereo.json", "reduced": [],
                               "why": "y"})
        cell = dict(cell, name="kitti00.corridor", config="kitti00_stereo", traffic="corridor")
    else:
        t = json.loads((b / "traffic" / "corridor.json").read_text())
        if what == "kind":
            (b / "sessions" / "live.py").write_text(
                "from benchmark.harness.drivers import DriveSession\n\n\n"
                "class Session(DriveSession):\n    layer = 'live'\n")
            t["session"] = "live"
        (b / "traffic" / "crawl.json").write_text(json.dumps(dict(t, step_m=0.05)))
    (b / "workloads" / f"{cell['name']}.json").write_text(
        (b / "workloads" / "kitti05.corridor.json").read_text())
    man["workloads"].append(cell)
    if what == "metric":
        (b / "metrics" / "graph.calls_per_s.py").write_text(
            "def read(ctx):\n    return len(ctx['calls']) / ctx['window_s'] or None\n")
        man["per_layer"].append({"name": "graph.calls_per_s", "unit": "calls/s",
                                 "better": "higher", "source": "host_clock",
                                 "layer": "graph frame program", "moves": "frames_per_s",
                                 "workloads": [cell["name"]]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    bench = core.Bench(tmp_path)
    found = bench.cell(cell["name"])
    assert bench.config(found)["name"] == cell["config"]
    assert bench.traffic(found)["step_m"] == (0.30 if what == "config" else 0.05)
    assert bench.limits(found)["limits"]
    traced = [m["name"] for m in bench.metrics(found, True)]
    if what == "kind":
        kind = drivers.load_kind(bench.traffic(found)["session"], b / "sessions")
        assert kind.layer == "live" and issubclass(kind, drivers.DriveSession)
    if what == "metric":
        assert "graph.calls_per_s" in traced
        calls = [{"layer": "graph", "kf": False, "device_ms": 1.0}] * 8
        assert bench.reader("graph.calls_per_s")(_ctx(calls=calls)) == 4.0
    else:
        assert "graph.calls_per_s" not in traced


def test_readers_leave_out_what_they_cannot_read():
    ctx = _ctx(submitted={1: 0.0, 2: 0.1}, completed={1: 0.25, 2: 0.3})
    for m in MANIFEST["per_layer"]:
        if m["name"] != "host.reads_per_frame":
            assert BENCH.reader(m["name"])(ctx) is None, m["name"]
    assert BENCH.reader("frames_per_s")(ctx) == 1.0
    assert BENCH.reader("frame_p95_ms")(ctx) == pytest.approx(stats.percentile([250, 200], 95))
    assert BENCH.reader("setup_s")(ctx) == 12.5
