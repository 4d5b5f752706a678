"""The bench line on the port: bench.py's Bistro-proxy frame at 1080p.

    python -m rend3_tpu_torch.bench [--flat] [--heavy] [--device cuda|cpu]

Port of bench.py:312-442. The scene is the city block of bench.py
(scenes.build_city_scene(representative=True): 600 textured buildings at
subdiv 3, alpha-tested foliage, blended glass, two shadowed lights) under
the bench camera, 1920x1080, 1 sample, ambient (0.08, 0.08, 0.1, 1),
two-phase occlusion culling on. Two warm-up frames through
render_frame_tensor settle the carried occlusion mask and the cached shadow
maps; then BaseRenderGraph.build_frame_callable uploads the frame once, and

- static_ms is utils.devbench.time_op of program(*args): the median of 8
  calls, each between two synchronizes (upload excluded, host included);
- shadow_pass_ms is time_op of the shadow-pass callable (every map of the
  plan re-rasterized on K2 and stacked for the PCF), what a frame pays
  when a caster moves every frame;
- dynamic_ms = static_ms + shadow_pass_ms, as bench.py:428-429 computes it.

stdout gets one JSON line with bench.py's keys (bench.py:418-440) and its
metric text; vs_baseline is 16 ms over the frame time. `steady_caps` and
`heavy_caps` are empty: the port sizes every buffer from the frame's real
counts and has no caps. `--flat` adds flat_scene_ms (the flat-material city,
occlusion culling on, as bench.py's measure(False)); `--heavy` adds heavy_ms
for 1,000 buildings at subdiv 12 (about 2.04M scene triangles). Progress,
each frame's stats, peak memory and the StageTimer split of one static frame
go to stderr. Nothing is retried and nothing falls back: a failure exits
nonzero. The device is the card unless `--device cpu` is given; without a
card the script raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

__all__ = ["METRIC", "HEAVY", "scene", "measure", "run", "main"]

METRIC = "bistro-proxy 1080p ms/frame (textured+cutout+blend+2 shadows, 1 chip)"
# --heavy's city (bench.py:432-439): buildings and the first subdivision.
HEAVY = (1000, 12)
AMBIENT = (0.08, 0.08, 0.1, 1.0)


def _stderr(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def scene(device, representative=True, n_buildings=600, subdiv=3, width=1920, height=1080):
    """(runner, keep, eval_output, target, settings): bench.py's city on a
    TestRunner on `device`, its camera at width / height, instructions
    evaluated; keep holds the scene's handles."""
    from . import scenes
    from .routine.base import BaseRenderGraphSettings, FrameRenderTarget
    from .testing import TestRunner

    runner = TestRunner(device=device)
    keep = scenes.build_city_scene(runner, n_buildings=n_buildings, subdiv=subdiv, representative=representative)
    scenes.set_bench_camera(runner, width, height)
    runner.renderer.swap_instruction_buffers()
    eval_output = runner.renderer.evaluate_instructions()
    settings = BaseRenderGraphSettings(ambient_color=AMBIENT)
    return runner, keep, eval_output, FrameRenderTarget(width, height, 1), settings


def measure(device, representative=True, n_buildings=600, subdiv=3, width=1920, height=1080, iters=8,
            log=_stderr) -> dict:
    """One scene of the bench (bench.py:324-398): two warm-up frames, then
    build_frame_callable and time_op of its program, then time_op of the
    shadow-pass callable. Returns {"ms", "shadow_ms", "stats"}."""
    import torch

    from .routine.base import StageTimer
    from .utils.devbench import time_op

    log(f"building scene (representative={representative}, n_buildings={n_buildings}, subdiv={subdiv})")
    runner, keep, ev, target, settings = scene(device, representative, n_buildings, subdiv, width, height)
    graph = runner.base_graph
    cuda = graph.renderer.device.type == "cuda"
    for k in (1, 2):
        t0 = time.perf_counter()
        graph.render_frame_tensor(ev, target, settings)
        if cuda:
            torch.cuda.synchronize()
        log(f"warm-up frame {k}: {(time.perf_counter() - t0) * 1e3:.3f} ms (synchronized)")
    program, args = graph.build_frame_callable(ev, target, settings)
    log(f"{args[1].tri_vlocal.shape[0]} triangles in the opaque table")
    ms = time_op(program, *args, iters=iters)
    log(f"measured {ms:.3f} ms (median of {iters} calls of program), stats {graph.last_stats}")
    graph.timer = StageTimer(graph.renderer.device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    program(*args)
    stages = graph.timer.ms()
    graph.timer = None
    peak = f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB" if cuda else "not measured on the CPU"
    log(f"one static frame: peak {peak}; stages (ms) " + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    shadow_ms = 0.0
    if graph._last_shadow_call is not None:
        fn, inputs = graph._last_shadow_call
        shadow_ms = time_op(fn, *inputs, iters=iters)
    log(f"shadow pass (every map on K2 + the PCF stack): {shadow_ms:.3f} ms")
    stats = dict(graph.last_stats)
    del keep
    return {"ms": ms, "shadow_ms": shadow_ms, "stats": stats}


def run(device="cuda", n_buildings=600, subdiv=3, width=1920, height=1080, iters=8, flat=False, heavy=False,
        log=_stderr) -> dict:
    """The bench line as a dict with bench.py's keys: the representative
    city at n_buildings / subdiv, plus the flat city (`flat`) and the heavy
    city (`heavy`: HEAVY's buildings and subdivision)."""
    main = measure(device, True, n_buildings, subdiv, width, height, iters, log=log)
    ms, shadow_ms = main["ms"], main["shadow_ms"]
    result = {
        "metric": METRIC,
        "value": round(ms, 3),
        "unit": "ms",
        "vs_baseline": round(16.0 / ms, 4),
        "static_ms": round(ms, 3),
        "shadow_pass_ms": round(shadow_ms, 3),
    }
    result["dynamic_ms"] = round(result["static_ms"] + result["shadow_pass_ms"], 3)
    result["steady_caps"] = {}
    result["stats"] = main["stats"]
    if flat:
        result["flat_scene_ms"] = round(measure(device, False, n_buildings, subdiv, width, height, iters,
                                                log=log)["ms"], 3)
    if heavy:
        hb, hs = HEAVY
        result["heavy_ms"] = round(measure(device, True, hb, hs, width, height, iters, log=log)["ms"], 3)
        result["heavy_caps"] = {}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--flat", action="store_true", help="also time the flat-material city")
    ap.add_argument("--heavy", action="store_true", help="also time 1,000 buildings at subdiv 12")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    t0 = time.perf_counter()

    def log(msg):
        print(f"[bench +{time.perf_counter() - t0:7.1f}s] {msg}", file=sys.stderr, flush=True)

    result = run(device=args.device, flat=args.flat, heavy=args.heavy, log=log)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
