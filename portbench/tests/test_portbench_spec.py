"""BENCHMARK.json against the contract it is written to: its keys, names,
units, bounds, and that every cell, configuration and metric it names
has the files the harness finds by name."""

import json
import re

from portbench.lib import spec
from portbench.tests.helpers import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_contract():
    raw = (ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == KEYS
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert all(_line(w) for w in b["command"]) and len(b["command"]) <= 32
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir()
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
        cfg = spec.read_json(ROOT / c["file"])
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not k.endswith(("_dim", "_rank", "_features", "_size"))
        names.add(c["name"])
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        mix = spec.traffic(ROOT, w["traffic"])
        assert (ROOT / "portbench" / "loops" / f"{mix['mode']}.py").is_file()
        cfg = spec.config(b, ROOT, w["config"])
        works = {p.stem for p in (ROOT / "portbench" / "work").glob("*.py")}
        assert set(cfg["sparse_ops"]) <= works
        assert set(spec.limits(ROOT, w["name"]))
        cells.add(w["name"])
    assert len(cells) == len(b["workloads"])
    assert {w["config"] for w in b["workloads"]} == names
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(cells) // 4)
    metrics = set()
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        metrics.add(m["name"])
    assert "setup_s" in metrics
    for cell in cells:
        got = {m["name"] for m in spec.metrics_for(b, "end_to_end", cell)}
        assert "setup_s" in got and len(got) >= 2
        assert spec.metrics_for(b, "per_layer", cell)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in metrics
        for cell in m.get("workloads", cells):
            moved = {e["name"] for e in spec.metrics_for(b, "end_to_end",
                                                         cell)}
            assert m["moves"] in moved
        assert spec.reader(ROOT, m["name"]).read
        metrics.add(m["name"])
    assert len(metrics) == len(b["end_to_end"]) + len(b["per_layer"])
