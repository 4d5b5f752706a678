"""Tracing: the renderer's spans and counters (port of rend3_tpu/utils/profiling.py).

The reference has two layers (SURVEY.md §5): CPU `profiling::scope!`
everywhere plus GPU timestamp queries per graph node, dumpable as a
chrome://tracing trace (scene_viewer 'P'). Here:

- `scope(name)` is a span. Between `enable()` and `disable()` each one
  records its name, its start and end (`time.perf_counter_ns`), its parent
  (the innermost span open on its thread when it began) and its frame: the
  ordinal, since `enable()`, of the enclosing root span ROOT (the graph's
  `render_frame_tensor`), None outside one.
- `count(name, n)` adds to a counter, while enabled; `enable()` resets both.
- `stats()` sums each span name's time, self time (its time less the part
  its child spans cover) and calls, and holds the counters.
- While a torch.profiler is recording, every span also opens
  `torch.profiler.record_function(name)`, enabled or not: the spans land in
  the profiler's trace, on its clock, around the kernels they launched.
  `device_trace` writes that trace and `spans.json`, the kernels and copies
  each span launched.
- Off (disabled and no profiler recording), `scope` returns one shared
  no-op context manager and allocates nothing.

Span names: `Renderer::*` (the scene steps), `BaseRenderGraph::*` (the
frame and its upload), `graph::<stage>` (each stage of the frame),
`sync::<site>` (a call that blocks the host until the device is done: its
duration is the host's wait, its count the frame's device reads and
stream-synchronizing uploads), `kernel::<name>` (a hand-written kernel's
wrapper on the card from its launch preparation on: that call's host cost).
No name begins with `stage:` or `host:`, which benchmark ranges use.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List

from torch.autograd import profiler as _torch_profiler

__all__ = [
    "scope", "count", "enable", "disable", "dump_chrome_trace", "RendererStatistics", "stats", "device_trace",
    "current", "ROOT",
]

ROOT = "BaseRenderGraph::render_frame_tensor"

_enabled = False
# Each span: [name, start ns, end ns (None while open), parent span (None
# at the top), frame (None outside a root span), thread id].
_spans: List[list] = []
_counters: Dict[str, int] = {}
_frames = 0
_lock = threading.Lock()
_local = threading.local()
# Names opened as profiler ranges (device_trace maps launches to them).
_ranged: set = set()


def enable() -> None:
    """Start recording spans and counters, from none."""
    global _enabled, _spans, _counters, _frames
    with _lock:
        _spans, _counters, _frames = [], {}, 0
        _enabled = True


def disable() -> None:
    """Stop recording; what was recorded stays for stats() and the dump."""
    global _enabled
    _enabled = False


class _Off:
    """The shared no-op scope."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Span:
    __slots__ = ("name", "record", "ranged", "rec", "rf")

    def __init__(self, name: str, record: bool, ranged: bool):
        self.name, self.record, self.ranged = name, record, ranged
        self.rec = self.rf = None

    def __enter__(self):
        global _frames
        if self.ranged:
            _ranged.add(self.name)
            self.rf = _torch_profiler.record_function(self.name)
            self.rf.__enter__()
        if self.record:
            stack = _stack()
            parent = stack[-1] if stack else None
            with _lock:
                if self.name == ROOT:
                    frame = _frames
                    _frames += 1
                else:
                    frame = None if parent is None else parent[4]
                self.rec = [self.name, time.perf_counter_ns(), None, parent, frame, threading.get_ident()]
                _spans.append(self.rec)
            stack.append(self.rec)
        return None

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec[2] = time.perf_counter_ns()
            stack = _stack()
            if stack and stack[-1] is self.rec:
                stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def scope(name: str):
    """A span named `name` (counterpart of profiling::scope!); the shared
    no-op scope when tracing is off and no profiler is recording."""
    ranged = _torch_profiler._is_profiler_enabled
    if not (_enabled or ranged):
        return _OFF
    return _Span(name, _enabled, ranged)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while tracing is enabled."""
    if _enabled:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def current():
    """The name of the innermost span open on this thread, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1][0] if stack else None


def _closed() -> List[list]:
    with _lock:
        return [s for s in _spans if s[2] is not None]


def dump_chrome_trace(path: str) -> None:
    """Write the recorded spans as a chrome://tracing JSON (reference:
    scene_viewer 'P' key dump), each with its frame and its parent's index in
    `args`, and the counters. Times are Unix epoch microseconds: a
    torch.profiler chrome trace's are its `ts` plus its
    `baseTimeNanoseconds`, so the two can be laid side by side."""
    spans = _closed()
    offset = time.time_ns() - time.perf_counter_ns()
    index = {id(s): i for i, s in enumerate(spans)}
    pid = os.getpid()
    events = [
        {
            "name": s[0], "ph": "X", "ts": (s[1] + offset) / 1e3, "dur": (s[2] - s[1]) / 1e3, "pid": pid,
            "tid": s[5] % 1_000_000,
            "args": {"frame": s[4], "parent": index.get(id(s[3]), -1) if s[3] is not None else -1},
        }
        for s in spans
    ]
    end = max((e["ts"] + e["dur"] for e in events), default=(time.perf_counter_ns() + offset) / 1e3)
    with _lock:
        events += [{"name": k, "ph": "C", "ts": end, "pid": pid, "args": {"value": v}} for k, v in _counters.items()]
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


@dataclass
class RendererStatistics:
    """Aggregated per-span timings and the counters (reference:
    util/typedefs.rs:15)."""

    totals_ms: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    self_ms: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, int] = field(default_factory=dict)
    frames: int = 0

    def record(self, name: str, ms: float, self_ms: float = None) -> None:
        self.totals_ms[name] = self.totals_ms.get(name, 0.0) + ms
        self.counts[name] = self.counts.get(name, 0) + 1
        self.self_ms[name] = self.self_ms.get(name, 0.0) + (ms if self_ms is None else self_ms)

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.totals_ms.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name}: {total:.2f} ms total, {self.self_ms[name]:.2f} ms self, "
                f"{total / max(n, 1):.3f} ms avg over {n}"
            )
        lines += [f"{name}: {v}" for name, v in sorted(self.counters.items())]
        return "\n".join(lines)


def stats() -> RendererStatistics:
    """Per span name: time, self time and calls of the closed spans; the
    counters; the root spans begun (frames) since enable()."""
    spans = _closed()
    child_ns: Dict[int, int] = {}
    for s in spans:
        if s[3] is not None:
            child_ns[id(s[3])] = child_ns.get(id(s[3]), 0) + s[2] - s[1]
    out = RendererStatistics()
    for s in spans:
        dur = s[2] - s[1]
        out.record(s[0], dur / 1e6, (dur - child_ns.get(id(s), 0)) / 1e6)
    with _lock:
        out.counters = dict(_counters)
        out.frames = _frames
    return out


def _launches_by_span(events) -> dict:
    """{span name: {"kernels", "copies", "device_ms"}}: each device kernel
    and copy of a profile under the innermost program span open where it was
    launched, found by walking its launching runtime call's CPU parents up
    to the nearest program range ("(none)" where there is none)."""
    from torch.autograd import DeviceType

    launch = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("cu"):
            launch.setdefault(e.id, e)  # runtime calls, by correlation id
    out: Dict[str, dict] = {}
    for e in events:
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        p = launch.get(e.id)
        while p is not None and p.name not in _ranged:
            p = p.cpu_parent
        row = out.setdefault("(none)" if p is None else p.name, {"kernels": 0, "copies": 0, "device_ms": 0.0})
        row["copies" if e.name.startswith(("Memcpy", "Memset")) else "kernels"] += 1
        row["device_ms"] += e.time_range.elapsed_us() / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["device_ms"]))


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler trace of the enclosed work (CUDA activity too when a
    card is present), written as a chrome trace to `logdir`/trace.json, with
    `logdir`/spans.json: per program span, the kernels and copies launched
    while it was the innermost span open, and their device time."""
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
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump(_launches_by_span(prof.events()), f, indent=1)
