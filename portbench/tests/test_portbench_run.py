"""A run end to end on the CPU at a small size: the shape of its last
line, what it loads, and its refusals (no card, no program)."""

import json
import os
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

from portbench.tests.helpers import CELLS, ROOT, SMALL_GRAPH
from portbench.lib import env, runner, spec

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line(cell, trace, cpu):
    result = runner.run_cell(ROOT, cell, 2**33 + 5, 0.1, bool(trace), cpu,
                             time.perf_counter(), SMALL_GRAPH)
    obj = json.loads(runner.finish(
        result, {"platform": "cpu", "kind": "cpu", "count": 1}))
    keys = REQUIRED + (["breakdown"] if trace else []) + ["checks"]
    assert list(obj) == keys
    assert obj["correct"] is True and obj["failed"] == 0
    assert obj["attempted"] >= 1
    bench = spec.load_benchmark(ROOT)
    kind = "per_layer" if trace else "end_to_end"
    wanted = {m["name"] for m in spec.metrics_for(bench, kind, cell)}
    assert set(obj["metrics"]) <= wanted
    if not trace:
        assert set(obj["metrics"]) == wanted
    for m in obj["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert "memory_peak_bytes" in obj["device"]
    if trace:
        assert {"busy_s", "window_s"} <= set(obj["device"])
        assert set(obj["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in obj["checks"].values():
        assert set(c) == {"value", "limit"}


def _run(args, cwd, env_extra=None):
    e = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable] + args, cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=300)


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    assert proc.returncode != 0
    assert not lines or not lines[-1].startswith("{")


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal is for one without")
    _no_result(_run(["portbench/run.py", "--workload", CELLS[0], "--seed",
                     "1", "--seconds", "1"], ROOT))


def test_no_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(_run(["portbench/run.py", "--workload", CELLS[0], "--seed",
                     "1", "--seconds", "1"], tmp_path))
    # past the look for a card, the program is still missing
    proc = _run(["-c", "import sys; sys.path.insert(0, '.'); "
                 "from portbench.lib import env; env.import_program('.')"],
                tmp_path)
    assert proc.returncode != 0
    assert "dgsparse_tpu_torch" in proc.stderr


def test_run_loads_no_jax():
    code = (
        "import sys, time, torch; sys.path.insert(0, %r);"
        "from portbench.lib import env, runner;"
        "from pathlib import Path; env.prepare(Path(%r));"
        "runner.run_cell(Path(%r), 'gat-arxiv.train', 3, 0.05, True,"
        " torch.device('cpu'), time.perf_counter(), %r);"
        "print(env.forbidden_modules(),"
        " 'dgsparse_tpu_torch' in sys.modules)"
        % (str(ROOT), str(ROOT), str(ROOT), SMALL_GRAPH))
    proc = _run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_compared_whole(monkeypatch):
    assert env.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dgsparse_tpu_torch_extra",
                        types.ModuleType("dgsparse_tpu_torch_extra"))
    assert env.forbidden_modules() == []
    for name in ("jax.numpy", "dgsparse_tpu", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert env.forbidden_modules() == ["dgsparse_tpu", "flax", "jax"]


def test_references_import_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, %r); from pathlib import Path;"
        "from portbench.lib import spec;"
        "[spec.named(Path(%r), 'reference', p.stem)"
        " for p in sorted(Path(%r).glob('portbench/reference/*.py'))];"
        "print(sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('dgsparse_tpu_torch', 'dgsparse_tpu',"
        " 'jax')))" % (str(ROOT), str(ROOT), str(ROOT)))
    proc = _run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
