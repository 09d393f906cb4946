"""Metrics, tracing, and profiling.

The reference's observability is print() + a wall-clock Timer
(reference: numbskull/timer.py:7-18, numbskull/factorgraph.py:156-168,
salt/src/numbskull_master.py:95-124 phase prints; SURVEY.md §5: "no
profiler integration"). Here:

- ``Metrics``: a process-local registry of counters and timings that every
  engine feeds (epochs run, variable updates, wall time per phase), dumped
  as one JSON object — the machine-readable replacement for the
  reference's experiment TSVs (salt/src/experiment_intro_degree.py:26-88).
- ``trace``: a context manager around ``jax.profiler.trace`` producing
  XPlane traces viewable in TensorBoard/XProf (device kernel timelines,
  fusion boundaries), replacing nothing in the reference because it had
  nothing.
- ``annotate``: named regions (jax.profiler.TraceAnnotation) so sweeps and
  exchanges are attributable inside a trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time


class Metrics:
    """Thread-safe counters + timing accumulators."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._timings: dict[str, dict] = {}

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            t = self._timings.setdefault(
                name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            t["count"] += 1
            t["total_s"] += seconds
            t["max_s"] = max(t["max_s"], seconds)

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def snapshot(self) -> dict:
        with self._lock:
            out = {"counters": dict(self._counters), "timings": {}}
            for k, t in self._timings.items():
                d = dict(t)
                d["mean_s"] = t["total_s"] / max(t["count"], 1)
                out["timings"][k] = d
            return out

    def dump(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timings.clear()


#: process-wide default registry used by the engines
metrics = Metrics()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture an XPlane profiler trace of the enclosed block (view with
    TensorBoard's profile plugin / XProf)."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named trace region (shows up on the profiler timeline)."""
    import jax
    return jax.profiler.TraceAnnotation(name)


def device_memory_stats() -> list[dict]:
    """Per-device memory stats (bytes in use, peak bytes in use, limit)
    where the backend exposes them; None entries otherwise."""
    import jax
    out = []
    for d in jax.devices():
        try:
            s = d.memory_stats() or {}
        except Exception:
            s = {}
        out.append({"device": str(d),
                    "bytes_in_use": s.get("bytes_in_use"),
                    "peak_bytes_in_use": s.get("peak_bytes_in_use"),
                    "bytes_limit": s.get("bytes_limit")})
    return out
