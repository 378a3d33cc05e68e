"""A configuration, a loop, a traffic mix that names it, a cell and a
per-layer metric added as new files (and entries in BENCHMARK.json) to a
copy of the checkout are found by name, with no edit to any file the
benchmark has."""

import json
import shutil
import subprocess
import sys

from portbench.tests.helpers import ROOT


def _tree(root):
    return {p.relative_to(root): p.read_bytes()
            for p in (root / "portbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_additions_need_no_edit(tmp_path):
    ignore = shutil.ignore_patterns("__pycache__")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=ignore)
    shutil.copytree(ROOT / "dgsparse_tpu_torch",
                    tmp_path / "dgsparse_tpu_torch", ignore=ignore)
    before = _tree(tmp_path)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"

    cfg = json.loads((pb / "configs" / "gcn-arxiv.json").read_text())
    cfg["graph"].update(num_nodes=500, undirected_pairs=2000)
    cfg["hidden_features"] = 16
    (pb / "configs" / "gcn-mini.json").write_text(json.dumps(cfg))
    # a new loop: fresh features uploaded from the host for each request
    (pb / "loops" / "forward-upload.py").write_text(
        "from pathlib import Path\n"
        "from portbench.lib import spec\n"
        "base = spec.named(Path(__file__).resolve().parents[2], 'loops',"
        " 'forward')\n"
        "class Loop(base.Loop):\n"
        "    uploads = 0\n"
        "    def request(self):\n"
        "        self.x = self.x.cpu().to(self.device)\n"
        "        Loop.uploads += 1\n"
        "        return super().request()\n")
    (pb / "traffic" / "serve-once.json").write_text(json.dumps(
        {"mode": "forward-upload", "warmup": 1, "samples": 2}))
    (pb / "limits" / "gcn-mini.serve-once.json").write_text(json.dumps(
        {"logits_gap": {"limit": 1e-4}}))
    (pb / "metrics" / "hidden_width.py").write_text(
        "def read(ctx):\n    return float(ctx.cfg['hidden_features'])\n")
    bench["configs"].append({"name": "gcn-mini", "source": "a test",
                             "file": "portbench/configs/gcn-mini.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "gcn-mini.serve-once",
                               "config": "gcn-mini",
                               "traffic": "serve-once", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "hidden_width", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "model step", "moves": "serve_ms",
                               "workloads": ["gcn-mini.serve-once"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "gcn-arxiv.serve" in m["workloads"]:
            m["workloads"].append("gcn-mini.serve-once")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = (
        "import sys, time, json, torch; sys.path.insert(0, '.');"
        "from pathlib import Path; from portbench.lib import env, runner;"
        "env.prepare(Path('.')); env.import_program(Path('.'));"
        "r = runner.run_cell(Path('.'), 'gcn-mini.serve-once', 5, 0.05,"
        " True, torch.device('cpu'), time.perf_counter());"
        "print(runner.finish(r, {'platform': 'cpu'}));"
        "from portbench.lib import spec;"
        "print(spec.named(Path('.'), 'loops', 'forward-upload').Loop.uploads)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    out = json.loads(lines[-2])
    assert int(lines[-1]) >= 2
    assert out["correct"] is True
    assert out["metrics"]["hidden_width"]["value"] == 16.0
    after = _tree(tmp_path)
    assert all(after[p] == b for p, b in before.items())
