"""Probe the map-free shadow resolve (K7, K8) on the bench scene.

    python3 -m rend3_tpu_torch.probe_shadow [--buildings N] [--reps N]

Port of tools/probe_shadow.py. Renders the representative bench scene
(scenes.build_city_scene(representative=True)) at 1920x1080 on the card
once, takes light 0's casters (the K2 setup table of its 2048² map) and the
light-space coordinates of the frame's opaque pixels (the shading chain's
shadow coordinates at the frame's own G-buffer), and prints the caster
count, the per-tile list lengths of both list builders (mean / p50 / p90 /
max), and the times of the list builders and of K7 and K8, then one JSON
line. `run` is the part
chip_smoke.py calls on a frame it rendered itself. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from .ops import lighting
from .ops import shadow as shadow_ops

__all__ = ["inputs", "run", "main"]


def inputs(captured):
    """Light 0's inputs from a graph's `captured` dict after a frame:
    (casters, sx, sy, hit, width, height, size, ref, in_bounds, factor),
    sx / sy / hit / ref / in_bounds / factor over sample 0's opaque pixels,
    padded with pixels not hit to whole 32x128 tiles (factor: light 0's
    shadow factor of the shading chain, K3 at the frame's own shadow
    coordinates)."""
    stris, _binned, _w, _h = captured["raster_depth"]
    gbuf, _materials, dir_lights, _points, uniforms, _bg, shadows = captured["deferred_shade"][:7]
    _k, sx, sy, ref, hit, in_bounds = lighting.shadow_coords(gbuf.data, uniforms.inv_view, dir_lights,
                                                             shadows.plan)[0]
    factor = lighting.shadow_factors(gbuf, dir_lights, uniforms, shadows)[0]
    h, w = sx.shape
    height, width = -(-h // shadow_ops.STILE_H) * shadow_ops.STILE_H, -(-w // shadow_ops.STILE_W) * shadow_ops.STILE_W

    def pad(t, fill):
        out = torch.full((height, width), fill, dtype=t.dtype, device=t.device)
        out[:h, :w] = t
        return out

    return (stris, pad(sx, 0.0), pad(sy, 0.0), pad(hit, False), width, height, shadows.plan[0][2], pad(ref, 0.0),
            pad(in_bounds, False), pad(factor, 1.0))


def _lengths(binned):
    n = (binned.offsets[1:] - binned.offsets[:-1]).double()
    return {
        "mean": float(n.mean()), "p50": float(n.quantile(0.5)), "p90": float(n.quantile(0.9)),
        "max": int(n.max()), "pairs": int(binned.ids.numel()),
    }


def _median_ms(fn, reps):
    fn()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def run(graph, reps=0, log=print):
    """K7 and K8 once each through shadow_occlusion / shadow_occlusion_lt on
    light 0 of `graph`'s last frame; logs the caster count and both
    builders' list lengths, and with reps > 0 the median CUDA-event times
    of the builders and of each kernel over its lists. Returns a dict with
    the inputs, lists, outputs and stats."""
    stris, sx, sy, hit, width, height, size = inputs(graph.captured)[:7]
    occ7 = shadow_ops.shadow_occlusion(stris, sx, sy, hit, width, height)
    occ8, overflow = shadow_ops.shadow_occlusion_lt(stris, sx, sy, hit, width, height, size)
    rects = shadow_ops.rect_lists(stris, sx, sy, hit, width, height)
    cells = shadow_ops.cell_lists(stris, sx, sy, hit, width, height, size)
    stats = {
        "casters": stris.count, "hit_pixels": int(hit.sum()), "map_size": size,
        "rect_lists": _lengths(rects), "cell_lists": _lengths(cells), "overflow": int(overflow),
    }
    log(f"map-free shadows, light 0 ({size}²): {stats['casters']} casters, {stats['hit_pixels']} hit pixels")
    for name in ("rect_lists", "cell_lists"):
        ls = stats[name]
        log(f"  {name}: per 32x128 tile mean {ls['mean']:.1f} p50 {ls['p50']:.0f} p90 {ls['p90']:.0f} "
            f"max {ls['max']} ({ls['pairs']} pairs)")
    if reps:
        args = (sx, sy, hit, width, height)
        stats["ms"] = {
            "rect_lists": _median_ms(lambda: shadow_ops.rect_lists(stris, *args), reps),
            "cell_lists": _median_ms(lambda: shadow_ops.cell_lists(stris, *args, size), reps),
            "k7": _median_ms(lambda: shadow_ops.occlusion_from_lists(stris, rects, *args, lt_form=False), reps),
            "k8": _median_ms(lambda: shadow_ops.occlusion_from_lists(stris, cells, *args, lt_form=True), reps),
        }
        log(f"  median ms: {json.dumps(stats['ms'])}")
    return {"stats": stats, "rects": rects, "cells": cells, "occ7": occ7, "occ8": occ8}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--buildings", type=int, default=600)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_shadow needs a CUDA device")

    from . import scenes
    from .routine.base import BaseRenderGraphSettings, FrameRenderTarget
    from .testing import TestRunner

    width, height = 1920, 1080
    runner = TestRunner(device="cuda")
    keep = scenes.build_city_scene(runner, n_buildings=args.buildings, representative=True)
    scenes.set_bench_camera(runner, width, height)
    graph = runner.base_graph
    graph.captured = {}
    runner.renderer.swap_instruction_buffers()
    graph.render_frame_tensor(
        runner.renderer.evaluate_instructions(), FrameRenderTarget(width, height, 1),
        BaseRenderGraphSettings(ambient_color=(0.08, 0.08, 0.1, 1.0)),
    )
    out = run(graph, reps=args.reps)
    print(json.dumps({"device": torch.cuda.get_device_name(0), **out["stats"]}))
    del keep
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
