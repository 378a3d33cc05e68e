"""What a run reads, found by name: `BENCHMARK.json` at the checkout's root,
and the files under `portbench/` that belong to one thing each.

- a configuration: the `file` its entry in `BENCHMARK.json` names
  (`portbench/configs/<name>.json`)
- a traffic mix: `portbench/traffic/<name>.json`, data: its parameters
  and the "mode" that names its loop
- a loop, which drives the program with a mix: `portbench/loops/<mode>.py`
- a cell's correctness limits: `portbench/limits/<cell>.json`
- a graph or input generator: `portbench/graphs/<generator>.py`
- a model's plain reference: `portbench/reference/<model>.py`
- the program's side of a model: `portbench/models/<model>.py`
- an op's work count: `portbench/work/<op>.py`
- a per-layer metric's reader: `portbench/metrics/<name>.py`, or the
  reader of the part of the name before its first dot
  (`mfu.serve` and `mfu.train` are both read by `metrics/mfu.py`)

Adding any of these is adding a file; no file here names another.
"""

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import List

PKG = "portbench"


class SpecError(ValueError):
    """The benchmark's files do not name what a run asks for."""


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"no BENCHMARK.json at {root}")
    return read_json(path)


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SpecError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _by_name(bench["workloads"], name, "workload")


def config(bench: dict, root: Path, name: str) -> dict:
    entry = _by_name(bench["configs"], name, "config")
    cfg = read_json(Path(root) / entry["file"])
    cfg["name"] = name
    return cfg


def traffic(root: Path, name: str) -> dict:
    return read_json(Path(root) / PKG / "traffic" / f"{name}.json")


def limits(root: Path, cell_name: str) -> dict:
    """{number: limit} of a cell, from `limits/<cell>.json`, whose entries
    also keep the readings each limit was set from."""
    data = read_json(Path(root) / PKG / "limits" / f"{cell_name}.json")
    return {k: float(v["limit"]) for k, v in data.items()}


def metrics_for(bench: dict, kind: str, cell_name: str) -> List[dict]:
    """The `end_to_end` or `per_layer` metrics a cell reports: those that
    list it under `workloads`, and those with no such list."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def load_module(path: Path, name: str) -> ModuleType:
    """A module from a file, by path, registered as `name` (a file's name
    may hold characters a module name may not)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not Path(path).is_file():
        raise SpecError(f"no file {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def named(root: Path, kind: str, name: str) -> ModuleType:
    """`portbench/<kind>/<name>.py` as a module."""
    path = Path(root) / PKG / kind / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no {kind} file for {name!r} ({path})")
    return load_module(path, f"{PKG}_{kind}.{name}")


def reader(root: Path, metric: str) -> ModuleType:
    """The reader of a per-layer metric: `metrics/<metric>.py`, else that
    of the name's part before its first dot."""
    full = Path(root) / PKG / "metrics" / f"{metric}.py"
    return named(root, "metrics", metric if full.is_file()
                 else metric.split(".")[0])


def all_named(root: Path, kind: str) -> List[ModuleType]:
    """Every module of `portbench/<kind>/`, by file name order."""
    return [named(root, kind, p.stem)
            for p in sorted((Path(root) / PKG / kind).glob("*.py"))
            if p.stem != "__init__"]
