"""Tracing / profiling (port of rend3_tpu/utils/profiling.py).

Reference has two layers (SURVEY.md §5): CPU `profiling::scope!` everywhere +
GPU timestamp queries per graph node, dumpable as a chrome://tracing trace
(scene_viewer 'P'). Here: `scope()` context managers feed an in-process
trace buffer with chrome-trace JSON export, `RendererStatistics` aggregates
per-scope totals, and `device_trace()` wraps `torch.profiler` (CUDA
activity when a card is present) and writes its chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List

__all__ = ["scope", "enable", "disable", "dump_chrome_trace", "RendererStatistics", "stats", "device_trace"]

_enabled = False
_events: List[dict] = []
_lock = threading.Lock()
_t0 = time.perf_counter()


def enable() -> None:
    global _enabled, _events, _t0
    _enabled = True
    _events = []
    _t0 = time.perf_counter()


def disable() -> None:
    global _enabled
    _enabled = False


@contextlib.contextmanager
def scope(name: str):
    """CPU scope (counterpart of profiling::scope!)."""
    if not _enabled:
        yield
        return
    start = time.perf_counter()
    try:
        yield
    finally:
        end = time.perf_counter()
        with _lock:
            _events.append(
                {
                    "name": name,
                    "ph": "X",
                    "ts": (start - _t0) * 1e6,
                    "dur": (end - start) * 1e6,
                    "pid": os.getpid(),
                    "tid": threading.get_ident() % 1_000_000,
                }
            )


def dump_chrome_trace(path: str) -> None:
    """Write accumulated scopes as a chrome://tracing JSON (reference:
    scene_viewer 'P' key dump)."""
    with _lock:
        data = {"traceEvents": list(_events)}
    with open(path, "w") as f:
        json.dump(data, f)


@dataclass
class RendererStatistics:
    """Aggregated per-scope timings (reference: util/typedefs.rs:15)."""

    totals_ms: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    def record(self, name: str, ms: float) -> None:
        self.totals_ms[name] = self.totals_ms.get(name, 0.0) + ms
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.totals_ms.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total:.2f} ms total, {total / max(n, 1):.3f} ms avg over {n}")
        return "\n".join(lines)


def stats() -> RendererStatistics:
    s = RendererStatistics()
    with _lock:
        for e in _events:
            s.record(e["name"], e["dur"] / 1000.0)
    return s


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler trace of the enclosed work, written as a chrome trace
    to `logdir`/trace.json (CUDA activity too when a card is present)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, acc_events=True) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
