"""The traced window: `torch.profiler` over a fixed number of requests or
steps, with ranges the benchmark opens around the program's sparse ops,
reduced to the numbers the per-layer readers take.

Op ranges. For every op with a work count (`work/<op>.py` with
`TARGETS`), each target `module:name` (the name as the program's model
modules call it, and the op itself) is replaced, for the traced window
only, by a wrapper that opens the range `portbench.op.<op>.fwd` around
the call. Under autograd it also puts two identity functions into the
graph: one on the op's output, whose backward opens
`portbench.op.<op>.bwd`, and one on each input that needs a gradient,
whose backward closes it once all of them have run. So the backward's
range covers every autograd node of the op between the two. A call
inside another op's range opens none of its own. A target that cannot
be found, or an op the configuration runs (its "sparse_ops") with no call
in the traced window, or with no backward range in a loop that trains,
fails the run: the yardstick never drops an op in silence.

Device time. A device operation (kernel, memcpy, memset) belongs to the
range that was open on the thread that launched it, at the launch: its
`cudaLaunchKernel` (or `cuLaunchKernel`, `cudaMemcpyAsync`, ...) event,
matched by correlation id in the exported Chrome trace. Busy time is the
union of device operations' intervals in the window; an idle gap is
named after the host op (on any thread) that was innermost at its
middle.
"""

import bisect
import importlib
import json
import os
import tempfile
import threading
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch.autograd.profiler import record_function

PREFIX = "portbench.op."
WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10


class _Span:
    """A backward range, opened by the output's identity and closed when
    every input identity has run."""

    def __init__(self, name: str):
        self.name, self.pending, self.rf, self.ran = name, 0, None, False

    def open(self) -> None:
        if self.rf is None:
            self.rf = record_function(self.name)
            self.rf.__enter__()

    def close_one(self) -> None:
        self.pending -= 1
        if self.pending == 0 and self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.ran = True


class _Open(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, span):
        ctx.span = span
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.span.open()
        return g, None


class _Close(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, span):
        ctx.span = span
        span.pending += 1
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.span.close_one()
        return g, None


class OpRanges:
    """Within `with`, the work modules' targets wrapped; `calls` holds
    (op, shapes, backward span) of each call."""

    def __init__(self, works: Dict[str, object]):
        self.works = {op: w for op, w in works.items()
                      if getattr(w, "TARGETS", None)}
        self.calls: List[tuple] = []
        self.missing: List[str] = []
        self._saved = []
        self._depth = threading.local()

    def _wrap(self, op: str, work, fn):
        def wrapper(*args, **kwargs):
            if getattr(self._depth, "n", 0):
                return fn(*args, **kwargs)
            self._depth.n = 1
            try:
                span = None
                if torch.is_grad_enabled() and \
                        not torch.is_inference_mode_enabled():
                    span = _Span(f"{PREFIX}{op}.bwd")
                    args = tuple(
                        _Close.apply(a, span) if isinstance(a, torch.Tensor)
                        and a.requires_grad else a for a in args)
                with record_function(f"{PREFIX}{op}.fwd"):
                    out = fn(*args, **kwargs)
                if span is not None and span.pending:
                    out = _Open.apply(out, span)
                self.calls.append((op, work.shapes(args, kwargs, out), span))
                return out
            finally:
                self._depth.n = 0
        return wrapper

    def __enter__(self):
        for op, work in self.works.items():
            for target in work.TARGETS:
                mod_name, attr = target.split(":")
                try:
                    mod = importlib.import_module(mod_name)
                except ImportError:
                    self.missing.append(target)
                    continue
                fn = getattr(mod, attr, None)
                if fn is None:
                    self.missing.append(target)
                    continue
                self._saved.append((mod, attr, fn))
                setattr(mod, attr, self._wrap(op, work, fn))
        if self.missing:
            self.__exit__(None, None, None)
            raise RuntimeError(f"the op ranges' targets {self.missing} are "
                               "not in the program")
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()
        return False


def profile(iterate, n: int, device, works: Dict[str, object]) -> dict:
    """Run `iterate(n)` under the profiler and the op ranges; the parsed
    trace with the calls seen."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with OpRanges(works) as ranges:
        with torch_profile(activities=acts) as prof:
            with record_function(WINDOW):
                iterate(n)
    path = Path(tempfile.gettempdir()) / "portbench" / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        if path.exists():
            os.unlink(path)
    out = parse(events)
    out.update(calls=[(op, shapes, span is not None and span.ran)
                      for op, shapes, span in ranges.calls],
               iterations=n)
    return out


def require_ops(tr: dict, ops, trains: bool) -> None:
    """Raise unless each of `ops` was called in the traced window and, in
    a loop that trains, ran its backward range at least once."""
    called = {op for op, _, _ in tr["calls"]}
    backward = {op for op, _, ran in tr["calls"] if ran}
    lost = [op for op in ops if op not in called or
            (trains and op not in backward)]
    if lost:
        raise RuntimeError(f"the configuration's sparse ops {lost} left no "
                           "call (or, training, no backward) in the traced "
                           "window")


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(starts, spans, t) -> Optional[dict]:
    """The latest-starting of `spans` (sorted by start) that covers t."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 2000, -1), -1):
        if spans[j]["ts"] + spans[j].get("dur", 0) >= t:
            return spans[j]
    return None


def parse(events: List[dict]) -> dict:
    """The window, busy time, each op range's device time, the top device
    operations and the idle gaps by host activity, in seconds."""
    xs = [e for e in events if e.get("ph") == "X"]
    windows = [e for e in xs if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW]
    if not windows:
        raise RuntimeError("the trace holds no window range")
    w0 = windows[0]["ts"]
    w1 = w0 + windows[0]["dur"]
    device = [e for e in xs if e.get("cat") in DEVICE_CATS
              and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    launches = {e["args"]["correlation"]: e for e in xs
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    # op ranges by thread, sorted by start
    ranges = defaultdict(list)
    for e in xs:
        if e.get("cat") == "user_annotation" and \
                e.get("name", "").startswith(PREFIX):
            ranges[e["tid"]].append(e)
    starts = {}
    for tid, rs in ranges.items():
        rs.sort(key=lambda e: e["ts"])
        starts[tid] = [e["ts"] for e in rs]

    op_us = defaultdict(float)
    unmatched = 0
    names = defaultdict(float)
    for e in device:
        names[e["name"]] += e["dur"]
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            unmatched += 1
            continue
        tid = launch["tid"]
        if tid in ranges:
            r = _innermost(starts[tid], ranges[tid], launch["ts"])
            if r is not None:
                op_us[r["name"][len(PREFIX):]] += e["dur"]

    busy = _union([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                   for e in device])
    busy_us = sum(e - s for s, e in busy)
    host = sorted((e for e in xs if e.get("cat") in HOST_CATS
                   and e.get("name") != WINDOW), key=lambda e: e["ts"])
    host_starts = [e["ts"] for e in host]
    gaps = defaultdict(float)
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    for s, e in zip(edges[::2], edges[1::2]):
        if e > s:
            h = _innermost(host_starts, host, (s + e) / 2)
            gaps[h["name"] if h else "(no host op)"] += e - s
    top = sorted(names.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "op_device_s": {k: v * 1e-6 for k, v in op_us.items()},
            "device_events": len(device), "unmatched": unmatched,
            "device_ops": [[k, v * 1e-6] for k, v in top],
            "idle_gaps": [[k, v * 1e-6] for k, v in idle]}
