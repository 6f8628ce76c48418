"""Stage timing with reference-compatible ``[TIME]`` reports, plus optional
jax.profiler traces.

The reference brackets hot sections with std::chrono and prints running
averages (/root/reference/BatchMultiBevGen.cpp:732-759,
BatchTopPartRegistration.cpp:396-461).  StageTimer accumulates per-stage
wall-clock the same way; ``trace`` wraps a block in a jax.profiler trace for
device timeline inspection.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict


class StageTimer:
    def __init__(self) -> None:
        self.totals_ms: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    def add(self, name: str, ms: float, items: int = 1) -> None:
        """Thread-safe accumulation — used by AsyncWriter worker threads to
        report per-cloud writeback time into the same report."""
        with self._lock:
            self.totals_ms[name] += ms
            self.counts[name] += items

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 1):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, (time.perf_counter() - start) * 1e3, items)

    def average_ms(self, name: str) -> float:
        c = self.counts.get(name, 0)
        return self.totals_ms.get(name, 0.0) / c if c else 0.0

    def report_average(self, name: str, label: str) -> str:
        """A reference-style line, e.g.
        ``[TIME] Average preprocessing and BEV generation: 12.3``"""
        return f"[TIME] {label}: {self.average_ms(name)}"


@contextlib.contextmanager
def trace(name: str, enabled: bool = False, trace_dir: str = "/tmp/pctpu-trace"):
    """Optional jax.profiler trace around a block."""
    if not enabled:
        yield
        return
    import jax.profiler

    with jax.profiler.trace(trace_dir):
        with jax.profiler.TraceAnnotation(name):
            yield
