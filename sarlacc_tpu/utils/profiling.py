"""Lightweight pipeline profiling.

The reference has no tracing at all (SURVEY.md §5.1 — only #ifdef'd matrix
dumps); this is new work: wall-clock stage timers, DP-cell throughput
counters (GCUPS), and an optional hook into the JAX profiler for device
traces.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

__all__ = ["PipelineProfiler", "StageStats", "profiler", "get_profiler", "set_profiler"]


@dataclass
class StageStats:
    calls: int = 0
    seconds: float = 0.0
    items: int = 0
    cells: int = 0

    @property
    def gcups(self) -> float:
        return self.cells / self.seconds / 1e9 if self.seconds else 0.0


@dataclass
class PipelineProfiler:
    stages: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0, cells: int = 0):
        st = self.stages.setdefault(name, StageStats())
        t0 = time.perf_counter()
        try:
            yield st
        finally:
            dt = time.perf_counter() - t0
            st.seconds += dt
            st.calls += 1
            st.items += items
            st.cells += cells
            if _STAGE_LOG:
                import sys

                print(f"[stage] {name} +{dt:.3f}s", file=sys.stderr, flush=True)

    def report(self) -> str:
        lines = [f"{'stage':<28}{'calls':>7}{'sec':>10}{'items/s':>12}{'GCUPS':>9}"]
        for name, st in sorted(self.stages.items()):
            ips = st.items / st.seconds if st.seconds and st.items else 0.0
            lines.append(
                f"{name:<28}{st.calls:>7}{st.seconds:>10.3f}{ips:>12.1f}{st.gcups:>9.2f}"
            )
        from .membudget import budget_report

        lines.append(budget_report())
        return "\n".join(lines)

    @contextlib.contextmanager
    def device_trace(self, logdir: str):
        """Capture a jax profiler trace around a block (view with XProf)."""
        import jax

        jax.profiler.start_trace(logdir)
        try:
            yield
        finally:
            jax.profiler.stop_trace()


import os as _os

#: SARLACC_STAGE_LOG=1 prints each stage's wall time as it completes —
#: live observability for long runs.
_STAGE_LOG = bool(_os.environ.get("SARLACC_STAGE_LOG"))

_GLOBAL = PipelineProfiler()


def get_profiler() -> PipelineProfiler:
    return _GLOBAL


def set_profiler(p: PipelineProfiler) -> None:
    global _GLOBAL
    _GLOBAL = p


@contextlib.contextmanager
def profiler(name: str, items: int = 0, cells: int = 0):
    with _GLOBAL.stage(name, items=items, cells=cells) as st:
        yield st


def profiled(name: str):
    """Decorator: record wall time of every call under ``name``."""
    import functools

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with _GLOBAL.stage(name):
                return fn(*args, **kwargs)

        return inner

    return wrap
