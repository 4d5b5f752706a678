"""Time and trace the port's frame on a CUDA device.

    python -m rend3_tpu_torch.frame_profile [--scene flat|textured|representative|features] [--samples 1|4]
                                            [--frames N] [--trace-dir DIR]

Renders a 600-building city at 1920x1080 on the card and prints one JSON
line. The scene is `flat` (`bench.py --flat`: flat materials, one 2048²
shadow map, occlusion culling off, as the first slice timed it),
`textured` (scenes.textured_city: 24 albedo + 24 AO/metallic/roughness
textures with mips, 2048² and 1024² shadow maps, two-phase occlusion
culling on) or `representative` (the whole bench frame,
build_city_scene(representative=True): the textured city plus 340
alpha-tested foliage objects and 16 glass panes, occlusion culling on) or
`features` (scenes.feature_city: the representative frame with a 512²
skybox, 64 skinned columns, three registered material routines and an
"hdr" and an "srgb" pass), at 1 sample or 4 (MSAA, `--samples 4`). The
line holds:

- static_ms: median frame time (host clock around render_frame_tensor plus a
  synchronize) when the shadow map is cached;
- dynamic_ms: the same when a building moves every frame (in `features`,
  the columns' joints), so the shadow map is re-rasterized (the reference
  re-renders shadows every frame);
- stages_ms / peak_mib: the per-stage CUDA-event split and the peak device
  memory of one static frame; dynamic_stages_ms / dynamic_peak_mib /
  dynamic_stats: the same for one frame with a moved building;
- device_busy_ms / device_busy_share: summed kernel time over the frame
  time in a torch.profiler trace of static frames, and the kernels that
  take the most of it (with --trace-dir, the chrome trace is written to
  DIR/frame_trace_<scene>.json).

Needs a CUDA device; there is no CPU fall-back.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("flat", "textured", "representative", "features"), default="flat")
    ap.add_argument("--samples", type=int, choices=(1, 4), default=1)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("frame_profile needs a CUDA device")

    from . import scenes
    from .routine.base import BaseRenderGraphSettings, FrameRenderTarget, StageTimer
    from .testing import TestRunner
    from .utils import math as m3

    width, height = 1920, 1080
    runner = TestRunner(device="cuda")
    skybox_slot = None
    if args.scene == "textured":
        keep = scenes.textured_city(runner, n_buildings=600)
    elif args.scene == "features":
        keep, info = scenes.feature_city(runner, n_buildings=600)
        skybox_slot = info["sky"].idx
    else:
        keep = scenes.build_city_scene(runner, n_buildings=600, representative=args.scene == "representative")
    scenes.set_bench_camera(runner, width, height)
    # Objects: the ground, then the buildings; the last building moves.
    building = [h for h in keep if getattr(h, "kind", None) == "object"][600]
    graph = runner.base_graph
    graph.occlusion_culling = args.scene != "flat"
    target = FrameRenderTarget(width, height, args.samples)
    settings = BaseRenderGraphSettings(ambient_color=(0.08, 0.08, 0.1, 1.0))

    def frame():
        runner.renderer.swap_instruction_buffers()
        ev = runner.renderer.evaluate_instructions()
        return graph.render_frame_tensor(ev, target, settings, skybox_slot)

    def move(i):
        if args.scene == "features":
            scenes.pose_columns(runner, info["skeletons"], 0.1 * (i + 1))
            return
        runner.renderer.set_object_transform(
            building, m3.translation([24.0 + 0.01 * i, 25.0, -40.0]) @ m3.scale([3.0, 25.0, 3.0])
        )

    def timed(n, moving=False):
        out = []
        for i in range(n):
            if moving:
                move(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(3):
        frame()
    static = timed(args.frames)
    dynamic = timed(args.frames, moving=True)

    def staged():
        graph.timer = StageTimer("cuda")
        torch.cuda.reset_peak_memory_stats()
        frame()
        out = graph.timer.ms(), torch.cuda.max_memory_allocated() / 2**20, dict(graph.last_stats)
        graph.timer = None
        return out

    move(args.frames)
    dynamic_stages, dynamic_peak_mib, dynamic_stats = staged()
    frame()
    stages, peak_mib, _ = staged()

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n_prof = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_prof):
            frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_prof
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace_dir, f"frame_trace_{args.scene}_s{args.samples}.json"))
    kernels = []
    busy_us = 0.0
    for e in prof.key_averages():
        # Device-side events only: the CPU ops that launched them report
        # the same time again as their self device time.
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = e.self_device_time_total
        busy_us += dev_us
        kernels.append((dev_us / n_prof / 1e3, e.count // n_prof, e.key))
    kernels.sort(reverse=True)
    busy_ms = busy_us / n_prof / 1e3
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "scene": args.scene,
        "samples": args.samples,
        "static_ms": statistics.median(static),
        "static_all_ms": static,
        "dynamic_ms": statistics.median(dynamic),
        "dynamic_all_ms": dynamic,
        "stages_ms": stages,
        "peak_mib": peak_mib,
        "dynamic_stages_ms": dynamic_stages,
        "dynamic_peak_mib": dynamic_peak_mib,
        "dynamic_stats": dynamic_stats,
        "profiled_frame_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "top_device_ops": [
            {"ms_per_frame": round(ms, 4), "calls_per_frame": c, "name": k[:90]} for ms, c, k in kernels[:25]
        ],
        "stats": graph.last_stats,
    }))
    del keep
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
