"""The program's own spans in a profiler trace.

With its tracing on (`dgsparse_tpu_torch/utils/metrics.py`), each span
of the port is a host range `<name>#<id>` in the exported Chrome trace
(a `cpu_op` event; a `user_annotation` is read alike), joined to the
program's record of it (`metrics.spans()`: tags, parent, root) by the
id. `parse` reduces a traced window to what the per-layer readers of the
program's spans take:

- each outermost op span (a `dgsparse.op.<op>.<route>.<fwd|bwd>` range
  that no other op range on its thread encloses): its host seconds, the
  device time of every device operation launched inside it (matched by
  correlation id, as `trace.py` matches them), and its tags;
- the idle time of the window during which some `dgsparse.` span was
  open on the host (on any thread: the autograd engine's thread runs a
  backward while the caller's waits inside `dgsparse.step.backward`).

`setup_spans` picks the outermost set-up spans out of the program's
records.
"""

import bisect
from collections import defaultdict
from typing import Dict, List, Optional

from portbench.lib import trace

PROGRAM = "dgsparse."
OP = "dgsparse.op."
# the set-up the program can shorten: storage, normalisation, kernel and
# native library loads, the optimizer, rulebooks
SETUP = ("dgsparse.storage.", "dgsparse.adjacency.", "dgsparse.kernels.load.",
         "dgsparse.native.load", "dgsparse.setup.", "dgsparse.spconv.rulebook")


def split_name(name: str):
    """(span name, id) of a range name `<name>#<id>`, or (name, None)."""
    base, sep, sid = name.rpartition("#")
    if not sep or not sid.isdigit():
        return name, None
    return base, int(sid)


def _outermost(ranges: List[dict]) -> List[dict]:
    """Of one thread's ranges, those no other of them encloses."""
    out, end = [], float("-inf")
    for r in sorted(ranges, key=lambda e: (e["ts"], -e["dur"])):
        if r["ts"] >= end:
            out.append(r)
            end = r["ts"] + r["dur"]
        else:
            end = max(end, r["ts"] + r["dur"])
    return out


def _covering(starts, ranges, t) -> Optional[dict]:
    """The range of `ranges` (disjoint, sorted) that covers t, or None."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and ranges[i]["ts"] + ranges[i]["dur"] >= t:
        return ranges[i]
    return None


def parse(events: List[dict], records: List[dict]) -> dict:
    """The window's outermost op spans and its idle time under program
    spans; `records` are the program's span records (`metrics.spans()`),
    whose tags join the ranges by id."""
    tags = {r["id"]: r["tags"] for r in records}
    xs = [e for e in events if e.get("ph") == "X"]
    windows = [e for e in xs if e.get("cat") == "user_annotation"
               and e.get("name") == trace.WINDOW]
    if not windows:
        raise RuntimeError("the trace holds no window range")
    window = windows[0]
    w0, w1 = window["ts"], window["ts"] + window["dur"]
    program = [e for e in xs if e.get("cat") in trace.HOST_CATS
               and e.get("name", "").startswith(PROGRAM)
               and w0 <= e["ts"] <= w1]
    by_thread = defaultdict(list)
    for e in program:
        if e["name"].startswith(OP):
            by_thread[e["tid"]].append(e)
    outer = {tid: _outermost(rs) for tid, rs in by_thread.items()}
    starts = {tid: [r["ts"] for r in rs] for tid, rs in outer.items()}

    device = [e for e in xs if e.get("cat") in trace.DEVICE_CATS
              and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    launches = {e["args"]["correlation"]: e for e in xs
                if e.get("cat") in trace.LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    device_us: Dict[int, float] = defaultdict(float)
    unmatched = 0
    for e in device:
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            unmatched += 1
            continue
        tid = launch["tid"]
        r = _covering(starts[tid], outer[tid], launch["ts"]) \
            if tid in outer else None
        if r is not None:
            device_us[id(r)] += e["dur"]

    ops = []
    for rs in outer.values():
        for r in rs:
            name, sid = split_name(r["name"])
            op, route, phase = name[len(OP):].split(".")
            ops.append({"name": name, "id": sid, "op": op, "route": route,
                        "phase": phase, "tags": tags.get(sid),
                        "host_s": r["dur"] * 1e-6,
                        "device_s": device_us[id(r)] * 1e-6})

    busy = trace._union([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                         for e in device])
    open_ = trace._union([(e["ts"], e["ts"] + e["dur"]) for e in program])
    open_starts = [s for s, _ in open_]
    idle_us = idle_program_us = 0.0
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    for s, e in zip(edges[::2], edges[1::2]):
        if e > s:
            idle_us += e - s
            mid = (s + e) / 2
            i = bisect.bisect_right(open_starts, mid) - 1
            if i >= 0 and open_[i][1] >= mid:
                idle_program_us += e - s
    return {"ops": sorted(ops, key=lambda o: o["id"] or 0),
            "unmatched": unmatched, "window_s": (w1 - w0) * 1e-6,
            "idle_s": idle_us * 1e-6,
            "idle_program_s": idle_program_us * 1e-6}


def setup_spans(records: List[dict]) -> List[dict]:
    """The program's outermost set-up spans among `records`: those of a
    `SETUP` name under no other such span."""
    byid = {r["id"]: r for r in records}

    def setup(r):
        return r["name"].startswith(SETUP)

    def nested(r):
        p = byid.get(r["parent"])
        while p is not None:
            if setup(p):
                return True
            p = byid.get(p["parent"])
        return False

    return [r for r in records if setup(r) and not nested(r)]
