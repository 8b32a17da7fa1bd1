"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name; a dummy cell, configuration and metric added as files
alone."""

import json
import os
import re

from gpubench.harness import run_cell
from gpubench.manifest import ROOT, Manifest, load_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = load_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] \
        + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in [w["why"] for w in BENCH["workloads"]] \
            + [c["source"] for c in BENCH["configs"]] \
            + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metrics_per_cell():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        cell = Manifest().cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])


def test_files_found_by_name():
    m = Manifest()
    for c in BENCH["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert os.path.exists(path)
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert callable(m.flops(c["name"]).per_unit)
    for w in BENCH["workloads"]:
        cell = m.cell(w["name"])
        entry = m.entry(cell)
        assert callable(entry.build) and callable(entry.call)
    for metric in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(m.reader(metric["name"]).read), metric["name"]


def test_dummy_cell_added_as_files(bench_copy, cpu):
    """A new configuration, cell and metric are new files and manifest
    entries; the harness runs them without an edit."""
    g = bench_copy / "gpubench"
    data = os.path.join(os.path.dirname(__file__), "data")
    (g / "configs" / "dummy.json").write_text(
        open(os.path.join(data, "tiny.json")).read())
    traffic = load_json(os.path.join(data, "tiny.models-b2.json"))
    traffic["config"] = "dummy"
    (g / "workloads" / "dummy.models-b2.json").write_text(json.dumps(traffic))
    (g / "flops" / "dummy.py").write_text(
        "from gpubench.flops.inklayer_default import per_unit, "
        "kernel_launches\n")
    (g / "metrics" / "requests_done.py").write_text(
        "def read(ctx, metric):\n    return float(ctx.window.completed)\n")
    bench = json.loads((bench_copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy", "source": "tests",
                             "file": "gpubench/configs/dummy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy.models-b2", "config": "dummy",
                               "traffic": "models-b2", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "requests_done", "unit": "requests",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["dummy.models-b2"]})
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(bench))
    m = Manifest(str(bench_copy))
    cell = m.cell("dummy.models-b2")
    res = run_cell(m, cell, 2 ** 31 + 12345, 3.0, False, cpu, 0.0)
    assert res["correct"], res["checks"]
    assert res["metrics"]["requests_done"]["value"] >= 1
    assert set(res["metrics"]) == {"setup_s", "requests_done"}
