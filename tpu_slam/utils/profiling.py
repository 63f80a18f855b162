"""Tracing / profiling utilities.

Formalizes the reference's de-facto tracing — `std::chrono::steady_clock`
pairs around every stage with printed durations (SURVEY §5:
scan_match_icp.cc:71-83, hector_mapping.cc:91-134, spa2d.cpp stage timers) —
as reusable stage timers plus scans/sec counters and an optional
`jax.profiler` trace hook.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict



def sync(x) -> None:
    """Timing barrier: wait until every device array in ``x`` is ready."""
    import jax

    jax.block_until_ready(x)


class StageTimer:
    """Accumulating per-stage wall-clock timers.

    >>> t = StageTimer()
    >>> with t.stage("match"): ...
    >>> t.report()
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync_result=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_result is not None:
                sync(sync_result)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def mean_ms(self, name: str) -> float:
        return 1000.0 * self.totals[name] / max(self.counts[name], 1)

    def report(self) -> str:
        lines = [
            f"{k}: {self.mean_ms(k):.2f} ms/call ×{self.counts[k]}"
            f" (total {self.totals[k]:.2f}s)"
            for k in sorted(self.totals)
        ]
        return "\n".join(lines)


class ThroughputCounter:
    """scans/sec counter (the per-node Hz prints of the reference)."""

    def __init__(self):
        self.n = 0
        self.t0 = time.perf_counter()

    def tick(self, k: int = 1) -> None:
        self.n += k

    @property
    def per_sec(self) -> float:
        return self.n / max(time.perf_counter() - self.t0, 1e-9)


@contextlib.contextmanager
def device_trace(path: str):
    """jax.profiler trace wrapper (view in TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
