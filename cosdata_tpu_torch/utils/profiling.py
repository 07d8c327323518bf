"""Per-phase timing counters + a torch profiler hook.

The reference has only log/env_logger + ad-hoc println timers; here every
phase can be timed into a process-wide registry that the server exposes at
GET /metrics, and a device trace can be captured with ``torch.profiler``
(a Chrome trace, viewable in Perfetto or chrome://tracing).

Port of ``cosdata_tpu/utils/profiling.py``: ``Profiler`` and ``profiler``
are copied; ``device_trace`` uses ``torch.profiler`` where the reference
uses the jax profiler.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict


class _Counter:
    __slots__ = ("count", "total_s", "max_s")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0


class Profiler:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, _Counter] = defaultdict(_Counter)

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                c = self._counters[name]
                c.count += 1
                c.total_s += dt
                c.max_s = max(c.max_s, dt)

    def record(self, name: str, seconds: float):
        with self._lock:
            c = self._counters[name]
            c.count += 1
            c.total_s += seconds
            c.max_s = max(c.max_s, seconds)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                name: {
                    "count": c.count,
                    "total_s": round(c.total_s, 6),
                    "mean_s": round(c.total_s / c.count, 6) if c.count else 0.0,
                    "max_s": round(c.max_s, 6),
                }
                for name, c in sorted(self._counters.items())
            }

    def reset(self):
        with self._lock:
            self._counters.clear()


#: process-wide registry
profiler = Profiler()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a host + CUDA profile of the block into
    ``log_dir/trace.json`` (Chrome trace format); yields the profiler, whose
    ``key_averages()`` sums device time by kernel."""
    from pathlib import Path

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
