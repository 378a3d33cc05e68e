"""Op-level dispatch counters.

Counterpart of `dgsparse_tpu/utils/metrics.py`, with its op names and tag
keys. Each op records the route it actually runs and the static shape of
the work, so a user can ask which kernels a model runs:

    from dgsparse_tpu_torch.utils import metrics
    metrics.enable()
    ... run the model ...
    print(metrics.summary())

The port is eager, so a call counts once per call. Tags come from shapes
and Python values only, never from a device tensor (that would
synchronize); with metrics off, `record` costs one bool check.
"""

import threading
from typing import Dict

_lock = threading.Lock()
_enabled = False
_counters: Dict[tuple, int] = {}


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    with _lock:
        _counters.clear()


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


def summary() -> str:
    with _lock:
        items = sorted(_counters.items())
    if not items:
        return "(no dispatches recorded — is metrics.enable() on?)"
    lines = []
    for (op, *tags), n in items:
        tag_s = " ".join(f"{k}={v}" for k, v in tags)
        lines.append(f"{op:14s} x{n:<5d} {tag_s}")
    return "\n".join(lines)
