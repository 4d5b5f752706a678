"""Reduction of the torch.profiler traces of a traced run.

- device_summary, over a device-only profile (the profiler's host-side
  recording would slow the host it measures): busy_s, the union of the
  device's kernel and copy intervals; window_s, the frames' host-clock
  length; kernel launches and memcpy / memset operations; the device
  operations that took the most time; K1's summed bound
  (roofline.k1_bound_ms of each recorded launch) and its summed device time,
  launches matched in order on the one stream.
- idle_gaps, over a host and device profile of a few later frames: the
  device's idle time labelled by the harness's profiler range open on the
  host when the gap began (a port StageTimer stage "stage:<name>", the scene
  steps "host:scene", or "host:between stages"; the ranges' device-side
  copies, user annotations, are not device work)."""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict

from . import roofline

__all__ = ["device_summary", "idle_gaps", "union", "K1_KERNEL"]

# K1's CUDA kernel: the G-buffer instances of csrc/raster.cu's tiles_kernel.
K1_KERNEL = "tiles_kernel<true"


def union(intervals):
    """(busy length, [(gap start, gap end)]) of (start, end) intervals."""
    busy, gaps, cur = 0.0, [], None
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy, gaps


def _events(prof):
    """(device kernel and copy events, the harness's host ranges as
    (start, end, name)) of a profile, in microseconds."""
    from torch.autograd import DeviceType

    dev, ranges = [], []
    for e in prof.events():
        marked = e.name.startswith(("stage:", "host:"))
        if e.device_type == DeviceType.CUDA and not marked and not getattr(e, "is_user_annotation", False):
            dev.append(e)
        elif marked and e.device_type == DeviceType.CPU:
            ranges.append((e.time_range.start, e.time_range.end, e.name))
    return dev, sorted(ranges)


def device_summary(prof, window_s: float, frames: int, k1_calls: list) -> dict:
    """Busy time, launches, the top device operations and K1's bound and
    time of a device-only profile of `frames` frames lasting window_s."""
    dev, _ranges = _events(prof)
    busy_us, _gaps = union((e.time_range.start, e.time_range.end) for e in dev)
    per_op = Counter()
    copies = 0
    for e in dev:
        per_op[e.name] += e.time_range.elapsed_us()
        copies += e.name.startswith(("Memcpy", "Memset"))
    k1_dev = sorted((e for e in dev if K1_KERNEL in e.name), key=lambda e: e.time_range.start)
    k1 = None
    if k1_calls and len(k1_dev) == len(k1_calls):
        k1 = {"bound_ms": sum(roofline.k1_bound_ms(c) for c in k1_calls),
              "device_ms": sum(e.time_range.elapsed_us() for e in k1_dev) / 1e3}
    return {
        "busy_s": busy_us / 1e6, "window_s": window_s, "frames": frames, "kernels": len(dev) - copies,
        "copies": copies, "device_ops": [[n, us / 1e6] for n, us in per_op.most_common(10)],
        "k1": k1, "k1_launches": [len(k1_calls), len(k1_dev)],
    }


def idle_gaps(prof) -> list:
    """The device's idle time in a host and device profile, summed by the
    harness's host range open when each gap began: [[label, seconds], ...],
    the ten largest."""
    dev, ranges = _events(prof)
    _busy, gaps = union((e.time_range.start, e.time_range.end) for e in dev)
    starts = [r[0] for r in ranges]
    idle = defaultdict(float)
    for g0, g1 in gaps:
        # The harness's ranges do not nest: the last one to start before g0,
        # if it is still open.
        k = bisect.bisect_right(starts, g0) - 1
        idle[ranges[k][2] if k >= 0 and ranges[k][1] > g0 else "host:between stages"] += g1 - g0
    return [[n, us / 1e6] for n, us in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]
