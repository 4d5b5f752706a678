"""One run of one cell: set-up, the measured window, the trace, the check.

Everything a cell needs is found by name from BENCHMARK.json: the workload
names a configuration (its `file`, configs/<name>.json) and a traffic mix
(mixes/<traffic>.json); each per-layer metric is the reader
metrics/<name>.py. A configuration or a mix whose work the city and the
camera-and-movers generator cannot express names a generator file of its
own (generators/<name>.py, see `parts`). Adding a configuration, a mix, a
generator or a metric is adding files and entries; this file does not
change.

The window is a closed render loop (adapter.Port.frame): frames run back to
back for `seconds`, each waiting for the one before. `frame_ms` is the
window's wall time over the frames completed in it, `frame_p95_ms` the 95th
percentile (nearest rank) of every frame's time. `setup_s` runs from the
process's start to the first timed frame. With trace=1 the window's first
frames are profiled (_Trace), then some run plain, and the per-layer
readers read the profiles, the plain frames' times and what the port's
StageTimer and scopes recorded over the frames after.

After the window, the port is freed and the reference renders the frames
kept for the check (two drawn from the seed among the first SAMPLE_SPAN,
and the window's last); compare.judge decides `correct`.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
from contextlib import contextmanager

import numpy as np

from . import devtrace

__all__ = [
    "load_manifest", "find_cell", "load_file", "load_metric", "parts", "p95", "frame_stats", "run_cell", "FORBIDDEN",
]

DEVICE_FRAMES = 12
PLAIN_FRAMES = 12
LABEL_FRAMES = 4
SAMPLE_SPAN = 120
# Top-level modules no run may load: JAX and the JAX package (compared whole,
# since the port's name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "rend3_tpu")


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def load_manifest(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(root: str, manifest: dict, workload: str):
    """(cell, configuration dict, mix dict, end-to-end metrics, per-layer
    metrics) of one workload, each metric kept where its `workloads` key
    (if any) names the cell."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are {sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "mixes", cell["traffic"] + ".json")) as f:
        mix = json.load(f)

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return cell, config, mix, mine(manifest["end_to_end"]), mine(manifest["per_layer"])


def load_file(root: str, folder: str, name: str):
    """The module <folder>/<name>.py of the checkout's benchmark folder."""
    path = os.path.join(root, "benchmark", folder, name + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_{folder}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(root: str, name: str):
    """The reader module metrics/<name>.py."""
    return load_file(root, "metrics", name)


def parts(root: str, config: dict, mix: dict) -> tuple:
    """(build_scene, Traffic, Port, Reference) of a configuration and a mix.

    A configuration's "generator" names generators/<name>.py, which defines
    build_scene(config, seed) -> scene.Scene and may define Port (its
    submission to the port, adapter.Port's interface) and Reference (its
    plain reference, reference.Reference's). A mix's "generator" names the
    file that defines its Traffic (traffic.Traffic's interface). Without the
    key: the city (scene.py, adapter.py, reference.py) and traffic.py."""
    from . import adapter, reference, scene, traffic

    gen = load_file(root, "generators", config["generator"]) if "generator" in config else scene
    moves = load_file(root, "generators", mix["generator"]) if "generator" in mix else traffic
    return (gen.build_scene, moves.Traffic, getattr(gen, "Port", adapter.Port),
            getattr(gen, "Reference", reference.Reference))


def p95(values) -> float:
    """95th percentile by nearest rank: the smallest value with at least
    95% of the values at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def frame_stats(frame_s: list, wall_s: float) -> dict:
    return {"frame_ms": wall_s * 1e3 / len(frame_s), "frame_p95_ms": p95(frame_s) * 1e3}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sample_frames(seed: int) -> list:
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 3])
    return sorted(int(i) for i in rng.choice(SAMPLE_SPAN, size=2, replace=False))


class _K1Calls:
    """Records each K1 launch's bound inputs while installed over the port's
    cuda_kernels.call (the traced run's profiled frames only)."""

    def __init__(self, ck):
        self.ck, self.orig, self.calls = ck, ck.call, []

    def __enter__(self):
        def call(name, *tensors, ints=(), floats=()):
            if name == "k1_raster_resolve":
                setup, bbox, planes, offsets, ids, _out, bound, floor, counts = tensors
                self.calls.append({
                    "bbox": bbox, "offsets": offsets, "ids": ids, "width": int(ints[0]), "height": int(ints[1]),
                    "y0": int(ints[3]),
                    "in_bytes": [t.numel() * t.element_size() for t in (bound, floor) if t is not None],
                    "table_bytes": sum(t.numel() * t.element_size() for t in (setup, bbox, planes, offsets, ids, counts)
                                       if t is not None),
                })
            return self.orig(name, *tensors, ints=ints, floats=floats)

        self.ck.call = call
        return self

    def __exit__(self, *exc):
        self.ck.call = self.orig


class _Trace:
    """The traced window's phases, by frame index: the first DEVICE_FRAMES
    under a device-only profile (busy time, launches, K1's launches), the
    next PLAIN_FRAMES with no instrumentation (the frame time a user sees,
    against which the profiled frames' busy time is set), the next
    LABEL_FRAMES under a host and device profile with each StageTimer stage a
    profiler range (what the host did in each idle gap), the rest with a
    fresh StageTimer and the port's profiling scopes on, which the readers
    read."""

    def __init__(self, torch, device, port, StageTimer, profiling, traffic):
        from torch.profiler import ProfilerActivity, profile

        self.torch, self.cuda, self.port, self.profiling = torch, device == "cuda", port, profiling
        self.StageTimer, self.device = StageTimer, device
        host = [ProfilerActivity.CPU]
        dev = [ProfilerActivity.CUDA] if self.cuda else []
        self.acts = (dev or host, host + dev)
        self.profile = profile
        self.mark = torch.profiler.record_function
        self.timer = self._ranges_timer()
        port.graph.timer = self.timer
        # The profiler's first start (CUPTI's set-up) takes seconds: pay it here.
        for acts in self.acts:
            with profile(activities=acts):
                port.frame(traffic.period - 1, self.mark)
        self.prof = self.k1 = self.device_prof = self.labelled = None
        self.summary, self.gaps = None, []
        self.t = [None, None]
        self.frames = 0
        self.plain_s = []

    def _ranges_timer(self):
        torch, StageTimer = self.torch, self.StageTimer

        class Timer(StageTimer):
            """The port's StageTimer, each stage also a profiler range."""

            @contextmanager
            def __call__(self, name):
                with torch.profiler.record_function("stage:" + name), super().__call__(name):
                    yield

        return Timer(self.device)

    def before(self, i):
        if i == 0:
            self.prof = self.profile(activities=self.acts[0])
            self.prof.__enter__()
            if self.cuda:
                from rend3_tpu_torch.ops import cuda_kernels

                self.k1 = _K1Calls(cuda_kernels).__enter__()
            self.t[0] = time.perf_counter()
        elif i == DEVICE_FRAMES:
            self.port.graph.timer = None
        elif i == DEVICE_FRAMES + PLAIN_FRAMES:
            self.port.graph.timer = self.timer
            self.prof = self.profile(activities=self.acts[1])
            self.prof.__enter__()

    def mark_of(self, i):
        """The profiler range around frame i's steps 1-3; none on a plain frame."""
        return None if DEVICE_FRAMES <= i < DEVICE_FRAMES + PLAIN_FRAMES else self.mark

    def after(self, i, dt) -> bool:
        """Whether frame i (of dt seconds) belongs to a phase before the
        readers' frames."""
        if i < DEVICE_FRAMES:
            self.frames += 1
            if i == DEVICE_FRAMES - 1:
                self._close_device()
            return True
        if i < DEVICE_FRAMES + PLAIN_FRAMES:
            self.plain_s.append(dt)
            return True
        if i < DEVICE_FRAMES + PLAIN_FRAMES + LABEL_FRAMES:
            if i == DEVICE_FRAMES + PLAIN_FRAMES + LABEL_FRAMES - 1:
                self.prof.__exit__(None, None, None)
                self.labelled, self.prof = self.prof, None
                self.timer = self.StageTimer(self.device)
                self.port.graph.timer = self.timer
                self.profiling.enable()
            return True
        return False

    def _close_device(self):
        self.t[1] = time.perf_counter()
        if self.k1 is not None:
            self.k1.__exit__()
        self.prof.__exit__(None, None, None)
        self.device_prof, self.prof = self.prof, None

    def finish(self):
        """Closes a profile the window ended inside, then reduces the
        profiles (after the window, so their reduction takes none of it)."""
        if self.prof is not None:
            if self.t[1] is None:
                self._close_device()
            else:
                self.prof.__exit__(None, None, None)
                self.prof = None
        self.profiling.disable()
        if self.cuda and self.device_prof is not None:
            self.summary = devtrace.device_summary(self.device_prof, self.t[1] - self.t[0], self.frames,
                                                   self.k1.calls if self.k1 else [])
        if self.labelled is not None:
            self.gaps = devtrace.idle_gaps(self.labelled)
        self.device_prof = self.labelled = None

    def context(self, frame_s, scene_s) -> dict:
        stats = self.profiling.stats()
        return {
            "frames": len(frame_s), "frame_s": frame_s, "scene_s": scene_s, "plain_s": self.plain_s,
            "stages_ms": self.timer.ms() if frame_s else {},
            "scopes_ms": dict(stats.totals_ms), "profile": self.summary,
        }


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float = None) -> dict:
    """One run; returns the result line's dict (with "check" last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    manifest = load_manifest(root)
    cell, config, mix, e2e, per_layer = find_cell(root, manifest, workload)
    readers = {m["name"]: load_metric(root, m["name"]) for m in per_layer} if trace else {}
    account = {}

    t = time.perf_counter()
    import torch

    account["torch_import_s"] = time.perf_counter() - t
    cuda = device == "cuda"
    if cuda:
        t = time.perf_counter()
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"cell {workload} needs {cell['chips']} CUDA device(s); "
                             f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        torch.cuda.init()
        torch.empty(1, device="cuda")
        account["cuda_init_s"] = time.perf_counter() - t
    t = time.perf_counter()
    import rend3_tpu_torch  # noqa: F401
    from rend3_tpu_torch.routine.base import StageTimer
    from rend3_tpu_torch.utils import profiling

    from . import compare

    account["port_import_s"] = time.perf_counter() - t
    if cuda:
        t = time.perf_counter()
        from rend3_tpu_torch.ops import cuda_kernels

        built = not os.path.exists(cuda_kernels._library_path())
        cuda_kernels.library()
        account["kernel_library_build_s" if built else "kernel_library_load_s"] = time.perf_counter() - t

    t = time.perf_counter()
    build_scene, Traffic, Port, Reference = parts(root, config, mix)
    if config["samples"] not in Reference.SAMPLES:
        raise SystemExit(f"the reference renders {Reference.SAMPLES} samples a pixel, not {config['samples']}")
    scene = build_scene(config, seed)
    traffic = Traffic(mix, scene, seed)
    account["scene_build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    port = Port(scene, traffic, device)
    port.graph.occlusion_culling = bool(config["occlusion_culling"])
    account["submit_s"] = time.perf_counter() - t

    # Warm-up: the mix's own frames, the first one timed by stage (it uploads
    # every table and renders with no carried occlusion mask).
    warm = traffic.warmup_frames()
    t = time.perf_counter()
    port.graph.timer = StageTimer(device)
    port.frame(warm[0])
    first_stages = port.graph.timer.ms()
    port.graph.timer = None
    account["first_frame_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for f in warm[1:] + [traffic.period - 1]:
        port.frame(f)
    account["warmup_frames_s"] = time.perf_counter() - t
    account["warmup_frames"] = len(warm)

    trace_run = _Trace(torch, device, port, StageTimer, profiling, traffic) if trace else None
    keep_at = set(_sample_frames(seed))
    kept = {}
    frame_s, scene_s = [], []
    attempted = failed = 0
    setup_s = time.perf_counter() - t_start
    account = {"setup_s": setup_s, **account}
    t0 = time.perf_counter()
    last = None
    while time.perf_counter() - t0 < seconds:
        i = attempted
        attempted += 1
        if trace_run:
            trace_run.before(i)
        try:
            img, dt, ds = port.frame(i, trace_run and trace_run.mark_of(i))
        except Exception as e:  # a frame that raises counts as failed
            failed += 1
            log(f"frame {i} failed: {type(e).__name__}: {e}")
            continue
        if i in keep_at:
            kept[i] = img
        last = (i, img)
        if trace_run and trace_run.after(i, dt):
            continue  # a profiled frame: the readers read the frames after them
        frame_s.append(dt)
        scene_s.append(ds)
    wall = time.perf_counter() - t0
    if trace_run:
        trace_run.finish()
    if frame_s:
        q = np.percentile(np.asarray(frame_s) * 1e3, [0, 10, 50, 90, 99, 100])
        log("frame ms min / p10 / p50 / p90 / p99 / max: " + " / ".join(f"{v:.2f}" for v in q))
    found = forbidden_modules()
    if found:
        log(f"loaded after the window: {found}; no run may load JAX or the JAX package")
        raise SystemExit(3)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if last is not None:
        kept[last[0]] = last[1]
    result = {"correct": False, "attempted": attempted, "failed": failed, "metrics": {}, "device": {
        "platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": cell["chips"] if cuda else 0, "memory_peak_bytes": int(peak),
    }}

    if trace:
        ctx = trace_run.context(frame_s, scene_s)
        if ctx["profile"] is not None:
            p = ctx["profile"]
            result["device"]["busy_s"] = p["busy_s"]
            result["device"]["window_s"] = p["window_s"]
            result["breakdown"] = {"device_ops": p["device_ops"], "idle_gaps": trace_run.gaps}
            log("profiled {frames} frames in {window_s:.3f} s: {kernels} kernels, {copies} copies; K1 launches "
                "recorded / traced {k1_launches}".format(**p))
        for m in per_layer:
            v = readers[m["name"]].read(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    elif frame_s:
        stats = frame_stats(frame_s, wall)
        stats["setup_s"] = setup_s
        for m in e2e:
            result["metrics"][m["name"]] = {"value": stats[m["name"]], "unit": m["unit"]}
    log("set-up account (s): " + json.dumps({k: round(v, 4) if isinstance(v, float) else v
                                               for k, v in account.items()}))
    log("first frame's stages (ms): " + json.dumps({k: round(v, 3) for k, v in first_stages.items()}))
    log(f"window: {len(frame_s)} frames timed, {attempted} begun, {failed} failed, {wall:.3f} s; "
        f"last stats {port.graph.last_stats}")

    # The check, after the window: the port freed, the reference on the device.
    port.close()
    del port, last
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = Reference(scene, device)
    per_frame = []
    for i in sorted(kept):
        answer = ref.render(**traffic.state(i))
        nums = compare.frame_numbers(kept[i].to(answer["lo"].device), answer)
        per_frame.append(nums)
        log(f"frame {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in nums.items())
            + f"; pixels whose surface rounding decides {answer['ambiguous'] * 100:.4f}%")
    del ref
    ok, check = compare.judge(per_frame)
    log(f"check of {len(per_frame)} frames: {time.perf_counter() - t:.1f} s")
    result["correct"] = ok and failed == 0 and attempted > 0
    result["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in check.items()}
    for k, (v, lim) in check.items():
        log(f"check {k} {v:.6g} limit {lim}")
    return result
