"""The port's tracing: op-level dispatch counters, spans and cache
counters, all switched together by `enable()` / `disable()`.

Dispatch counters are the counterpart of `dgsparse_tpu/utils/metrics.py`,
with its op names and tag keys. Each op records the route it actually
runs and the static shape of the work, so a user can ask which kernels a
model runs:

    from dgsparse_tpu_torch.utils import metrics
    metrics.enable()
    ... run the model ...
    print(metrics.summary())

The port is eager, so a call counts once per call. Tags come from shapes
and Python values only, never from a device tensor (that would
synchronize).

Spans (`span(name, **tags)`) time the program's work on the host, from
`time.perf_counter_ns`, where it happens: each public op after it has
chosen its route (`dgsparse.op.<op>.<route>.fwd`) and its backward
(`.bwd`, a child of the forward span), the models' forwards, the training
step and its phases, and set-up (storage construction, normalisation,
kernel loads, rulebooks, tier rebuilds). A span's parent is the span open
on its thread when it opened, or the one it is given; its root is the
outermost span it descends from, so every span of one request or step
shares one root id. While a `torch.profiler` window runs, an open span
is also a host range `<name>#<id>` of the profiler's trace, on the
device events' timeline and joined to its record here by the id: a C++
`RecordFunction` (`torch._C._profiler._RecordFunctionFast`, a `cpu_op`
event), since `torch.profiler.record_function` (a `user_annotation`)
costs several times a span's own host time. The newest `SPAN_CAP` spans
are kept (`spans()`), and running totals by name (`span_totals()`).

Cache counters (`count`, `cache_counters()`) are kept apart from the
dispatch counters, whose keys match the JAX package's: tier values built
or reused, kernel libraries built or loaded from the build cache, tuner
lookups that hit or miss.

Off, the default, `record`, `count` and `span` each cost one check of a
module-level bool; `span` then returns the shared `NULL_SPAN`, which
records nothing and adds no node to an autograd graph.
"""

import collections
import itertools
import threading
import time
from typing import Dict, List, Optional

from torch._C._profiler import _RecordFunctionFast as _Range
from torch.autograd import profiler as _profiler

# the number of finished spans kept, newest first to go last
SPAN_CAP = 100_000

_lock = threading.Lock()
_enabled = False
_counters: Dict[tuple, int] = {}
_counts: Dict[str, int] = {}
_spans: collections.deque = collections.deque(maxlen=SPAN_CAP)
_totals: Dict[str, List[int]] = {}      # name: [count, host ns, self ns]
_ids = itertools.count(1)
_local = threading.local()


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    with _lock:
        _counters.clear()
        _counts.clear()
        _spans.clear()
        _totals.clear()


def record(op: str, **tags) -> None:
    """Called by the op dispatchers; a no-op unless enabled."""
    if not _enabled:
        return
    key = (op,) + tuple(sorted(tags.items()))
    with _lock:
        _counters[key] = _counters.get(key, 0) + 1


def counters() -> Dict[tuple, int]:
    with _lock:
        return dict(_counters)


def count(name: str, n: int = 1) -> None:
    """Add n to the cache counter `name`; a no-op unless enabled."""
    if not _enabled:
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def cache_counters() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


def _thread() -> tuple:
    """This thread's open spans (innermost last) and its native id, read
    once: `threading.get_native_id()` is a system call, which on some
    hosts costs microseconds and slows the ops after it."""
    try:
        return _local.state
    except AttributeError:
        _local.state = ([], threading.get_native_id())
        return _local.state


class Span:
    """One span: `name`, `id`, `parent` and `root` ids, the native id of
    the `thread` it ran on, `start_ns` / `end_ns` on `perf_counter_ns`,
    and its `tags`. Use it in a `with` statement."""

    __slots__ = ("name", "id", "parent", "root", "thread", "start_ns",
                 "end_ns", "tags", "_given", "_child_ns", "_range")

    def __init__(self, name: str, parent: Optional["Span"], tags: dict):
        self.name, self.tags, self._given = name, tags, parent
        self.id = next(_ids)
        self.parent = self.root = self._range = None
        self._child_ns = 0

    def tag(self, **tags) -> None:
        """Add tags known only once the span is open."""
        self.tags.update(tags)

    def __enter__(self) -> "Span":
        stack, self.thread = _thread()
        parent = self._given or (stack[-1] if stack else None)
        if parent is None:
            self.root = self.id
        else:
            self.parent, self.root = parent.id, parent.root
        stack.append(self)
        if _profiler._is_profiler_enabled:
            self._range = _Range(f"{self.name}#{self.id}")
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        host = self.end_ns - self.start_ns
        stack = _thread()[0]
        stack.pop()         # spans are `with` blocks: last opened, first closed
        if stack:
            stack[-1]._child_ns += host
        with _lock:
            _spans.append(self)
            tot = _totals.get(self.name)
            if tot is None:
                tot = _totals[self.name] = [0, 0, 0]
            tot[0] += 1
            tot[1] += host
            tot[2] += host - self._child_ns
        return False

    def as_dict(self) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "root": self.root, "thread": self.thread,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "tags": dict(self.tags)}


class _NullSpan:
    """What `span` returns with tracing off: records nothing."""

    __slots__ = ()
    id = None

    def tag(self, **tags) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


def span(name: str, parent: Optional[Span] = None, **tags):
    """A span named `name` with `tags`, a child of `parent` where given
    (else of the span open on this thread); `NULL_SPAN` unless enabled."""
    if not _enabled:
        return NULL_SPAN
    return Span(name, parent, tags)


def current() -> Optional[Span]:
    """The innermost span open on this thread, or None (always None
    unless enabled)."""
    if not _enabled:
        return None
    stack = _thread()[0]
    return stack[-1] if stack else None


def backward_span(fwd: Optional[Span], **tags):
    """The span of an op's backward: `fwd`'s name with `.bwd` for `.fwd`,
    its tags and `tags`, a child of `fwd`. `NULL_SPAN` unless enabled and
    `fwd` is an op's forward span (an autograd Function's forward keeps
    `current()` for this)."""
    if not _enabled or fwd is None or not fwd.name.endswith(".fwd"):
        return NULL_SPAN
    return Span(fwd.name[:-4] + ".bwd", fwd, {**fwd.tags, **tags})


def spans() -> List[dict]:
    """The finished spans kept, oldest first, as dicts (`Span.as_dict`)."""
    with _lock:
        kept = list(_spans)
    return [s.as_dict() for s in kept]


def span_totals() -> Dict[str, dict]:
    """{name: {"count", "host_s", "self_s"}} over every finished span
    since the last `reset()`, kept or not; self time leaves out the
    children that ran on the span's thread."""
    with _lock:
        items = [(k, list(v)) for k, v in _totals.items()]
    return {k: {"count": n, "host_s": host * 1e-9, "self_s": own * 1e-9}
            for k, (n, host, own) in items}


def summary() -> str:
    with _lock:
        items = sorted(_counters.items())
    if not items:
        lines = ["(no dispatches recorded — is metrics.enable() on?)"]
    else:
        lines = []
        for (op, *tags), n in items:
            tag_s = " ".join(f"{k}={v}" for k, v in tags)
            lines.append(f"{op:14s} x{n:<5d} {tag_s}")
    totals = span_totals()
    if totals:
        lines.append("")
        lines.append(f"{'span':44s} {'count':>7s} {'host ms':>11s} "
                     f"{'self ms':>11s}")
        for name, t in sorted(totals.items()):
            lines.append(f"{name:44s} {t['count']:7d} "
                         f"{t['host_s'] * 1e3:11.3f} "
                         f"{t['self_s'] * 1e3:11.3f}")
    cache = cache_counters()
    if cache:
        lines.append("")
        lines.extend(f"{k:44s} {n:7d}" for k, n in sorted(cache.items()))
    return "\n".join(lines)
