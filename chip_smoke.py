"""Smoke test of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's three paths (rend3_tpu_torch) on the card through the
entry points a user calls (TestRunner / Renderer scene calls,
swap_instruction_buffers, evaluate_instructions, BaseRenderGraph.render_frame)
at 1920x1080: the flat city-block scene of `bench.py --flat`, the textured
city (the representative bench scene without its alpha-tested foliage and
alpha-blended glass), and the whole representative bench frame (foliage
through the cutout peels, glass through the blend peels), both with
two-phase occlusion culling. It checks every hand-written kernel of those
paths, K1 in each of its modes, against its plain PyTorch version.
Phases (each raises on failure; any failure exits nonzero):

1. environment: torch, CUDA and nvcc versions, the card's name and power limit;
2. build: compile csrc/*.cu with nvcc, one process per source (timed);
3. flat: three frames with occlusion culling off, as the first slice ran
   them (build the shadow map, reuse it, move a building so it is rebuilt),
   with launch counters zeroed just before and read just after;
   per-frame stage times (CUDA events), frame time and peak memory;
4. textured: an occlusion-off reference frame, then (counters zeroed) three
   frames with occlusion culling on: the first predicts every triangle, the
   second renders the carried mask, the third moves a building. Frames 1
   and 2 must equal the reference bit for bit, and frame 2 must rasterize
   fewer triangles than the reference;
5. representative: the whole bench frame, as phase 4: an occlusion-off
   reference frame, then (counters zeroed) three occlusion-on frames;
   frames 1 and 2 must equal the reference bit for bit, frame 2 must
   rasterize fewer opaque triangles than the reference, and the frames must
   run cutout peels and at least two blend peels over blend pixels;
6. kernels: K1, K2 and K3 on the inputs captured in the flat frames, K4 and
   K5 on those of the textured frames, K1's count and bound modes and K4
   on the cutout alpha test on those of the representative frames, against
   their plain versions on the card, with median times, the bound each
   kernel's bytes or operations set on the card, and the time of one
   PyTorch call computing the same function where there is one;
7. parity: the shadow golden scene, the textured-planes scene, the stacked
   cutout scene and the glass stack at 256x256 on the card and on the CPU.

The last two lines are the card (nvidia-smi) and one JSON object
{"ok": true, "device": {...}}; the line before them lists the kernels.
Without a CUDA device it prints why and exits 2.
"""

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

WIDTH, HEIGHT = 1920, 1080
# The H100 SXM's published peaks (NVIDIA's data sheet, at its 700 W limit):
# device memory 3.35 TB/s, f32 outside the tensor cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
KERNEL_NAMES = ("raster_resolve", "raster_count", "raster_bound", "raster_depth", "pcf5", "bilinear", "gather")


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_environment():
    import torch

    from rend3_tpu_torch.ops import cuda_kernels

    nvcc = subprocess.run([cuda_kernels._nvcc(), "--version"], capture_output=True, text=True)
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    log("nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    log(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    log("nvidia-smi: " + nvidia_smi_line())


def phase_build():
    from rend3_tpu_torch.ops import cuda_kernels

    t0 = time.perf_counter()
    cuda_kernels.build(verbose=True)
    cuda_kernels.library()
    log(f"build: {time.perf_counter() - t0:.2f} s ({cuda_kernels.last_build['path']})")
    for line in cuda_kernels.last_build["log"].splitlines()[:40]:
        log("  nvcc: " + line.strip())


def _launch_counts():
    from rend3_tpu_torch.ops import deferred, samplers

    counts = {**deferred.launches, **samplers.launches}
    return {name: counts[name] for name in KERNEL_NAMES}


def _reset_launch_counts():
    from rend3_tpu_torch.ops import deferred, samplers

    for d in (deferred.launches, samplers.launches):
        for k in d:
            d[k] = 0


def _frame_fn(runner, target, settings, device):
    """frame(label) renders one frame through the user's entry points and
    logs its host time, CUDA-event time, peak memory, stats and stages."""
    import torch

    from rend3_tpu_torch.routine.base import StageTimer

    graph = runner.base_graph
    cuda = torch.device(device).type == "cuda"

    def frame(label):
        runner.renderer.swap_instruction_buffers()
        ev = runner.renderer.evaluate_instructions()
        graph.timer = StageTimer(device)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        t0 = time.perf_counter()
        img = graph.render_frame(ev, target, settings)
        host_ms = (time.perf_counter() - t0) * 1e3
        dev_ms = None
        if cuda:
            e1.record()
            torch.cuda.synchronize()
            dev_ms = e0.elapsed_time(e1)
        stages = graph.timer.ms()
        graph.timer = None
        peak = torch.cuda.max_memory_allocated() / 2**20 if cuda else float("nan")
        log(
            f"frame {label}: host {host_ms:.3f} ms, device events {dev_ms} ms, peak {peak:.1f} MiB, "
            f"stats {graph.last_stats}"
        )
        log("  stages (ms): " + json.dumps({k: round(v, 4) for k, v in stages.items()}))
        return img

    return frame


def _check_image(img, width, height):
    import numpy as np

    if img.shape != (height, width, 4) or img.dtype != np.uint8:
        raise AssertionError(f"image {img.shape} {img.dtype}")
    lit = (img[..., :3] != 0).any(-1).mean()
    if lit < 0.5:
        raise AssertionError(f"only {lit:.3f} of the pixels differ from the background")


def _check_launched(counts, names):
    for name in names:
        if counts[name] == 0:
            raise AssertionError(f"kernel {name} was never launched by the main path")


def phase_slice(device="cuda", width=WIDTH, height=HEIGHT, n_buildings=600):
    """Three frames of the flat bench scene, occlusion culling off; returns
    (graph, counts, image)."""
    import numpy as np
    import torch

    from rend3_tpu_torch import scenes
    from rend3_tpu_torch.routine.base import BaseRenderGraphSettings, FrameRenderTarget
    from rend3_tpu_torch.testing import TestRunner
    from rend3_tpu_torch.utils import math as m3

    runner = TestRunner(device=device)
    keep = scenes.build_city_scene(runner, n_buildings=n_buildings, representative=False)
    scenes.set_bench_camera(runner, width, height)
    graph = runner.base_graph
    graph.occlusion_culling = False
    graph.captured = {}
    frame = _frame_fn(
        runner, FrameRenderTarget(width, height, 1), BaseRenderGraphSettings(ambient_color=(0.08, 0.08, 0.1, 1.0)),
        device,
    )
    building = [h for h in keep if getattr(h, "kind", None) == "object"][-1]
    cuda = torch.device(device).type == "cuda"

    _reset_launch_counts()
    img1 = frame("flat 1 (builds the shadow map)")
    k2_after_1 = _launch_counts()["raster_depth"]
    state1 = graph._shadow_cache[0]
    img2 = frame("flat 2 (cached shadow map)")
    if _launch_counts()["raster_depth"] != k2_after_1 or graph._shadow_cache[0] != state1:
        raise AssertionError("frame 2 did not reuse the cached shadow map")
    # A 50-unit tower halfway along the bench camera's line of sight.
    runner.renderer.set_object_transform(building, m3.translation([24.0, 25.0, -40.0]) @ m3.scale([3.0, 25.0, 3.0]))
    img3 = frame("flat 3 (a building moved)")
    counts = _launch_counts()
    if graph._shadow_cache[0] == state1 or (cuda and counts["raster_depth"] == k2_after_1):
        raise AssertionError("moving a building did not invalidate the shadow map")
    log(f"launches during the three flat frames: {counts}")
    if cuda:
        _check_launched(counts, ("raster_resolve", "raster_depth", "pcf5"))
    for img in (img1, img2, img3):
        _check_image(img, width, height)
    if not np.array_equal(img1, img2):
        raise AssertionError("two frames of a static scene differ")
    if np.array_equal(img1, img3):
        raise AssertionError("moving a building changed nothing")
    log(f"image: {img1.shape}, non-background {(img1[..., :3] != 0).any(-1).mean():.4f}, mean {img1.mean():.3f}")
    del keep
    return graph, counts, img1


def phase_textured(device="cuda", width=WIDTH, height=HEIGHT, n_buildings=600):
    """The textured city with two-phase occlusion culling: an occlusion-off
    reference frame, then three counted frames; returns (graph, counts,
    image)."""
    import numpy as np
    import torch

    from rend3_tpu_torch import scenes
    from rend3_tpu_torch.routine.base import BaseRenderGraphSettings, FrameRenderTarget
    from rend3_tpu_torch.testing import TestRunner
    from rend3_tpu_torch.utils import math as m3

    t0 = time.perf_counter()
    runner = TestRunner(device=device)
    keep = scenes.textured_city(runner, n_buildings=n_buildings)
    scenes.set_bench_camera(runner, width, height)
    tm = runner.renderer.d2_texture_manager
    log(f"textured city built in {time.perf_counter() - t0:.2f} s: {len(tm.data)} textures")
    graph = runner.base_graph
    graph.captured = {}
    frame = _frame_fn(
        runner, FrameRenderTarget(width, height, 1), BaseRenderGraphSettings(ambient_color=(0.08, 0.08, 0.1, 1.0)),
        device,
    )
    building = [h for h in keep if getattr(h, "kind", None) == "object"][-1]
    cuda = torch.device(device).type == "cuda"

    graph.occlusion_culling = False
    ref = frame("textured 0 (occlusion off, the reference)")
    s_off = graph.last_stats["main_survivors"]
    log(f"texture atlas {tuple(tm.evaluate().atlas.shape)} {tm.evaluate().atlas.dtype}")
    graph.occlusion_culling = True
    _reset_launch_counts()
    img1 = frame("textured 1 (occlusion on, predicts every triangle)")
    img2 = frame("textured 2 (occlusion on, the carried mask)")
    st = graph.last_stats
    s_on2 = st["main_survivors"] + st["resid_survivors"]
    runner.renderer.set_object_transform(building, m3.translation([24.0, 25.0, -40.0]) @ m3.scale([3.0, 25.0, 3.0]))
    img3 = frame("textured 3 (occlusion on, a building moved)")
    counts = _launch_counts()
    log(f"launches during the three textured frames: {counts}")
    log(f"frame 2 survivors: main + resid = {s_on2} vs {s_off} with occlusion off")
    if cuda:
        _check_launched(counts, ("raster_resolve", "raster_depth", "pcf5", "bilinear", "gather"))
    for img in (ref, img1, img2, img3):
        _check_image(img, width, height)
    if not s_on2 < s_off:
        raise AssertionError(f"occlusion culling did not cut the survivors ({s_on2} vs {s_off})")
    for k, img in ((1, img1), (2, img2)):
        if not np.array_equal(img, ref):
            n = int((img != ref).any(-1).sum())
            raise AssertionError(f"textured frame {k} differs from the occlusion-off frame at {n} pixels")
    if np.array_equal(img2, img3):
        raise AssertionError("moving a building changed nothing")
    log(f"image: {ref.shape}, non-background {(ref[..., :3] != 0).any(-1).mean():.4f}, mean {ref.mean():.3f}")
    del keep
    return graph, counts, ref


def phase_representative(device="cuda", width=WIDTH, height=HEIGHT, n_buildings=600):
    """The whole representative bench frame with two-phase occlusion
    culling: an occlusion-off reference frame, then three counted frames;
    returns (graph, counts, image)."""
    import numpy as np
    import torch

    from rend3_tpu_torch import scenes
    from rend3_tpu_torch.routine.base import BaseRenderGraphSettings, FrameRenderTarget
    from rend3_tpu_torch.testing import TestRunner
    from rend3_tpu_torch.utils import math as m3

    t0 = time.perf_counter()
    runner = TestRunner(device=device)
    keep = scenes.build_city_scene(runner, n_buildings=n_buildings, representative=True)
    scenes.set_bench_camera(runner, width, height)
    log(f"representative city built in {time.perf_counter() - t0:.2f} s")
    graph = runner.base_graph
    graph.captured = {}
    frame = _frame_fn(
        runner, FrameRenderTarget(width, height, 1), BaseRenderGraphSettings(ambient_color=(0.08, 0.08, 0.1, 1.0)),
        device,
    )
    # Objects: the ground, then the buildings; move the last building.
    building = [h for h in keep if getattr(h, "kind", None) == "object"][n_buildings]
    cuda = torch.device(device).type == "cuda"

    graph.occlusion_culling = False
    ref = frame("representative 0 (occlusion off, the reference)")
    s_off = graph.last_stats["main_survivors"]
    graph.occlusion_culling = True
    _reset_launch_counts()
    img1 = frame("representative 1 (occlusion on, predicts every triangle)")
    img2 = frame("representative 2 (occlusion on, the carried mask)")
    st = dict(graph.last_stats)
    s_on2 = st["main_survivors"] + st["resid_survivors"]
    runner.renderer.set_object_transform(building, m3.translation([24.0, 25.0, -40.0]) @ m3.scale([3.0, 25.0, 3.0]))
    img3 = frame("representative 3 (occlusion on, a building moved)")
    counts = _launch_counts()
    log(f"launches during the three representative frames: {counts}")
    log(f"frame 2 opaque survivors: main + resid = {s_on2} vs {s_off} with occlusion off")
    if cuda:
        _check_launched(counts, KERNEL_NAMES)
    for img in (ref, img1, img2, img3):
        _check_image(img, width, height)
    if not s_on2 < s_off:
        raise AssertionError(f"occlusion culling did not cut the survivors ({s_on2} vs {s_off})")
    if not (st["cut_survivors"] > 0 and st["cut_peels"] >= 1 and st["blend_px"] > 0 and st["blend_peels"] >= 2):
        raise AssertionError(f"frame 2 did not run the cutout and blend peels: {st}")
    for k, img in ((1, img1), (2, img2)):
        if not np.array_equal(img, ref):
            n = int((img != ref).any(-1).sum())
            raise AssertionError(f"representative frame {k} differs from the occlusion-off frame at {n} pixels")
    if np.array_equal(img2, img3):
        raise AssertionError("moving a building changed nothing")
    log(f"image: {ref.shape}, non-background {(ref[..., :3] != 0).any(-1).mean():.4f}, mean {ref.mean():.3f}")
    del keep
    return graph, counts, ref


def _median_ms(fn, reps):
    import torch

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


def _ulps(a, b):
    import torch

    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return (ia - ib).abs()


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _bound(bytes_moved, ops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the f32 operations over the f32 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _raster_fragments(tris, binned, width):
    """Pixels the raster kernels must test this run: per listed
    (tile, triangle) pair, the tile's pixels inside the triangle's bbox."""
    import torch

    from rend3_tpu_torch.ops import deferred as D

    offs = binned.offsets.long()
    tile = torch.repeat_interleave(torch.arange(offs.numel() - 1, device=offs.device), offs[1:] - offs[:-1])
    bb = tris.bbox[binned.ids.long()]
    n_cols = width // D.DTILE_W
    tx0 = (tile % n_cols) * D.DTILE_W
    ty0 = (tile // n_cols) * D.DTILE_H
    nx = (torch.minimum(torch.ceil(bb[:, 2]).long(), tx0 + D.DTILE_W) - torch.maximum(torch.floor(bb[:, 0]).long(), tx0))
    ny = (torch.minimum(torch.ceil(bb[:, 3]).long(), ty0 + D.DTILE_H) - torch.maximum(torch.floor(bb[:, 1]).long(), ty0))
    return int((nx.clamp_min(0) * ny.clamp_min(0)).sum())


# f32 operations per tested (pixel, triangle): three edge planes and the
# depth plane (a multiply, an fma and an add each), their sign and top-left
# tests and the depth range; per covered pixel K1's finalize evaluates 21
# planes (three operations each) and the four uv derivatives (about six).
RASTER_TEST_OPS = 24
K1_FINALIZE_OPS = 21 * 3 + 4 * 6


def _k1_bound(tris, planes, binned, w, h, extra_in=(), extra_out=()):
    import torch

    from rend3_tpu_torch.ops import deferred as D

    frags = _raster_fragments(tris, binned, w)
    bytes_moved = _nbytes(tris.setup, tris.bbox, planes, binned.offsets, binned.ids, *extra_in, *extra_out)
    bytes_moved += D.GB_CH * w * h * 4
    return _bound(bytes_moved, frags * RASTER_TEST_OPS + w * h * K1_FINALIZE_OPS)


def _k1_check(name, k, p, kc=None, pc=None):
    """K1 against its plain version: depth, hit, material (and counts)
    bit-exact, the other channels within 1 ulp. Returns the max abs error."""
    import torch

    from rend3_tpu_torch.ops import deferred as D

    for ch in (D.G_DEPTH, D.G_HIT, D.G_MAT):
        if not torch.equal(k[ch], p[ch]):
            n = int((k[ch] != p[ch]).sum())
            raise AssertionError(f"{name}: channel {ch} differs from the plain version at {n} pixels")
    if kc is not None and not torch.equal(kc, pc):
        raise AssertionError(f"{name}: counts differ from the plain version at {int((kc != pc).sum())} pixels")
    ulps = _ulps(k, p)
    max_ulp = int(ulps.max())
    err = float((k - p).abs().max())
    extra = "" if kc is None else f"; counts bit-exact, max {int(kc.max())}, {int((kc > 0).sum())} pixels counted"
    log(f"{name}: {int((ulps > 0).sum())} of {k.numel()} values differ; max {max_ulp} ulp, max abs {err:.3g}"
        f"; {int((k[D.G_HIT] > 0).sum())} hit pixels{extra}")
    if max_ulp > 1:
        raise AssertionError(f"{name} differs from its plain version by {max_ulp} ulp")
    return err


def phase_kernels(paths, timed=True):
    """Each kernel against its plain version on the captured 1080p inputs:
    K1-K3 from the flat frames, K4 and K5 from the textured ones, K1's
    count and bound modes and K4 on the cutout alpha test from the
    representative ones. `paths` maps each path's name to its (graph,
    launch counts)."""
    import torch

    from rend3_tpu_torch.ops import deferred as D
    from rend3_tpu_torch.ops import samplers as S

    cap = paths["flat"][0].captured
    tcap = paths["textured"][0].captured
    rcap = paths["representative"][0].captured
    rows = []

    # K1, opaque mode.
    tris, planes, binned, wp, hp = cap["raster_resolve"]
    err1 = _k1_check("K1", D.raster_resolve(tris, planes, binned, wp, hp).data,
                     D.raster_resolve_plain(tris, planes, binned, wp, hp))
    rows.append(("raster_resolve", "rend3_tpu_torch/csrc/raster.cu", "rend3_tpu/ops/deferred.py:505",
                 lambda: D.raster_resolve(tris, planes, binned, wp, hp),
                 lambda: D.raster_resolve_plain(tris, planes, binned, wp, hp), err1,
                 _k1_bound(tris, planes, binned, wp, hp), None))

    # K1, count mode: the cutout peel 0 (strict floor).
    c_tris, c_planes, c_binned, c_wp, c_hp, floor, strict = rcap["raster_count"]
    kg, kc = D.raster_resolve(c_tris, c_planes, c_binned, c_wp, c_hp, count_floor=floor, count_strict=strict)
    pg, pc = D.raster_resolve_plain(c_tris, c_planes, c_binned, c_wp, c_hp, count_floor=floor, count_strict=strict)
    errc = _k1_check(f"K1 count mode (strict={strict}, {c_tris.count} triangles)", kg.data, pg, kc, pc)
    rows.append(("raster_count", "rend3_tpu_torch/csrc/raster.cu", "rend3_tpu/ops/deferred.py:505",
                 lambda: D.raster_resolve(c_tris, c_planes, c_binned, c_wp, c_hp, count_floor=floor,
                                          count_strict=strict),
                 lambda: D.raster_resolve_plain(c_tris, c_planes, c_binned, c_wp, c_hp, count_floor=floor,
                                                count_strict=strict),
                 errc, _k1_bound(c_tris, c_planes, c_binned, c_wp, c_hp, (floor,), (kc,)), None))

    # K1, bound mode: the first later peel of the frame (cutout, or blend).
    b_tris, b_planes, b_binned, b_wp, b_hp, bnd = rcap["raster_bound"]
    errb = _k1_check(f"K1 bound mode ({b_tris.count} triangles)",
                     D.raster_resolve(b_tris, b_planes, b_binned, b_wp, b_hp, bound=bnd).data,
                     D.raster_resolve_plain(b_tris, b_planes, b_binned, b_wp, b_hp, bound=bnd))
    rows.append(("raster_bound", "rend3_tpu_torch/csrc/raster.cu", "rend3_tpu/ops/deferred.py:505",
                 lambda: D.raster_resolve(b_tris, b_planes, b_binned, b_wp, b_hp, bound=bnd),
                 lambda: D.raster_resolve_plain(b_tris, b_planes, b_binned, b_wp, b_hp, bound=bnd),
                 errb, _k1_bound(b_tris, b_planes, b_binned, b_wp, b_hp, (bnd,)), None))

    # K2: bit-exact.
    stris, sbinned, swp, shp = cap["raster_depth"]
    k = D.raster_depth(stris, sbinned, swp, shp)
    p = D.raster_depth_plain(stris, sbinned, swp, shp)
    if not torch.equal(k, p):
        raise AssertionError(f"K2 differs from the plain version at {int((k != p).sum())} texels")
    log(f"K2: bit-exact over {k.numel()} texels, {int((k > 0).sum())} covered")
    b2 = _bound(_nbytes(stris.setup, stris.bbox, sbinned.offsets, sbinned.ids, k),
                _raster_fragments(stris, sbinned, swp) * RASTER_TEST_OPS)
    rows.append(("raster_depth", "rend3_tpu_torch/csrc/raster.cu", "rend3_tpu/ops/deferred.py:382",
                 lambda: D.raster_depth(stris, sbinned, swp, shp),
                 lambda: D.raster_depth_plain(stris, sbinned, swp, shp), 0.0, b2, None))

    # K3: abs <= 1e-6. The maps are read only around valid queries (12 texels each).
    args = cap["pcf5"]
    k = S.sample_grid_pcf5(*args)
    p = S.sample_grid_pcf5_plain(*args)
    err3 = float((k - p).abs().max())
    n_valid = int(args[-1].sum())
    log(f"K3: max abs err {err3:.3g} over {k.numel()} pixels, {n_valid} valid")
    if not err3 <= 1e-6:
        raise AssertionError(f"K3 differs from the plain version by {err3}")
    b3 = _bound(_nbytes(*args[1:], k) + min(_nbytes(args[0]), n_valid * 12 * 4), n_valid * 60)
    rows.append(("pcf5", "rend3_tpu_torch/csrc/pcf5.cu", "rend3_tpu/ops/mxu_gather.py:424",
                 lambda: S.sample_grid_pcf5(*args), lambda: S.sample_grid_pcf5_plain(*args), err3, b3, None))

    # K4: exact or at most 1 ulp, on the textured frame's textures and on
    # the representative frame's cutout alpha test.
    def k4_check(label, a):
        k = S.sample_grid_bilinear(*a)
        p = S.sample_grid_bilinear_plain(*a)
        ulps = _ulps(k, p)
        err = float((k - p).abs().max())
        log(f"K4 ({label}): {int(a[1].numel())} queries ({int(a[-1].sum())} valid), atlas {tuple(a[0].shape)}; "
            f"{int((ulps > 0).sum())} of {k.numel()} values differ, max {int(ulps.max())} ulp, max abs {err:.3g}")
        if int(ulps.max()) > 1:
            raise AssertionError(f"K4 ({label}) differs from its plain version by {int(ulps.max())} ulp")
        return err

    a4 = tcap["bilinear"]
    err4 = k4_check("textures", a4)
    k4_check("cutout alpha test", rcap["bilinear_cutout"])
    n_valid = int(a4[-1].sum())
    b4 = _bound(_nbytes(*a4[1:]) + 16 * a4[1].numel() + min(_nbytes(a4[0]), n_valid * 4 * 8), n_valid * 40)
    rows.append(("bilinear", "rend3_tpu_torch/csrc/bilinear.cu", "rend3_tpu/ops/mxu_gather.py:645",
                 lambda: S.sample_grid_bilinear(*a4), lambda: S.sample_grid_bilinear_plain(*a4), err4, b4, None))

    # K5: bit-exact. Its library yardstick is advanced indexing of the same
    # taps (every Hi-Z tap lies inside the padded mip atlas, checked here).
    a5 = tcap["gather"]
    k = S.sample_grid(*a5)
    p = S.sample_grid_plain(*a5)
    if not torch.equal(k, p):
        raise AssertionError(f"K5 differs from the plain version at {int((k != p).sum())} values")
    img5, bx5, by5, valid5, offs5 = a5
    dx = torch.tensor([o[0] for o in offs5], device=bx5.device, dtype=torch.long)
    dy = torch.tensor([o[1] for o in offs5], device=bx5.device, dtype=torch.long)
    ys, xs = by5.long()[:, None] + dy, bx5.long()[:, None] + dx
    if int(ys.min()) < 0 or int(xs.min()) < 0 or int(ys.max()) >= img5.shape[0] or int(xs.max()) >= img5.shape[1]:
        raise AssertionError("a K5 tap lies outside the mip atlas; the indexing yardstick would not apply")
    lib = img5[ys, xs].T
    if not torch.equal(torch.where(valid5[None], lib, torch.zeros_like(lib)) + 0.0, k):
        raise AssertionError("K5's indexing yardstick does not compute the same taps")
    n_valid = int(valid5.sum())
    log(f"K5: bit-exact over {int(bx5.numel())} queries ({n_valid} live) x {len(offs5)} taps, "
        f"mip atlas {tuple(img5.shape)}")
    b5 = _bound(_nbytes(bx5, by5, valid5, k) + min(_nbytes(img5), n_valid * len(offs5) * 4), 0)
    rows.append(("gather", "rend3_tpu_torch/csrc/gather.cu", "rend3_tpu/ops/mxu_gather.py:279",
                 lambda: S.sample_grid(*a5), lambda: S.sample_grid_plain(*a5), 0.0, b5,
                 lambda: img5[by5.long()[:, None] + dy, bx5.long()[:, None] + dx]))

    kernels = []
    for name, src, repl, kfn, pfn, err, (bound_ms, bound_by), libfn in rows:
        ms = _median_ms(kfn, 20) if timed else None
        plain_ms = _median_ms(pfn, 5) if timed else None
        library_ms = _median_ms(libfn, 20) if timed and libfn is not None else None
        launches = sum(counts[name] for _g, counts in paths.values())
        log(f"{name}: kernel {ms} ms, plain {plain_ms} ms, library {library_ms} ms (median); "
            f"bound {bound_ms:.6f} ms ({bound_by}); {launches} launches on the three paths")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        })
    return kernels


def shadow_scene(runner):
    """The scene of tests/test_shadow.py (plane + cube, one light)."""
    import numpy as np

    from rend3_tpu_torch.types import Camera, Orthographic
    from rend3_tpu_torch.utils import math as m3

    keep = [runner.add_directional_light(np.array([-1.0, -1.0, 1.0], np.float32))]
    mat1 = runner.add_lit_material([0.25, 0.5, 0.75, 1.0])
    keep += [mat1, runner.plane(mat1, m3.rotation_x(-np.pi / 2))]
    runner.set_camera_data(
        Camera(
            projection=Orthographic(size=np.array([2.5, 2.5, 5.0], np.float32)),
            view=m3.look_at_lh([0.0, 1.0, -1.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
        )
    )
    mat2 = runner.add_lit_material([0.75, 0.5, 0.25, 1.0])
    keep += [mat2, runner.cube(mat2, m3.translation([0.25, 0.25, -0.25]) @ m3.scale(0.25))]
    return keep


def phase_parity(device="cuda"):
    import numpy as np

    from rend3_tpu_torch import scenes
    from rend3_tpu_torch.testing import FrameRenderSettings, TestRunner

    for name, build in (
        ("shadow", shadow_scene),
        ("textured planes", scenes.textured_planes),
        ("stacked cutout", scenes.stacked_cutout),
        ("glass stack", scenes.glass_stack),
    ):
        imgs = []
        for dev in (device, "cpu"):
            runner = TestRunner(device=dev)
            keep = build(runner)
            imgs.append(runner.render_frame(FrameRenderSettings(size=256)))
            del keep
        diff = int(np.abs(imgs[0].astype(np.int32) - imgs[1].astype(np.int32)).max())
        log(f"parity: {name} scene 256x256, {device} vs cpu max u8 diff {diff}")
        if diff > 1:
            raise AssertionError(f"card and CPU renders of the {name} scene differ by {diff}")


def main():
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import rend3_tpu_torch  # noqa: F401

        phase_environment()
        phase_build()
        paths = {}
        for name, phase in (("flat", phase_slice), ("textured", phase_textured),
                            ("representative", phase_representative)):
            graph, counts, _img = phase()
            paths[name] = (graph, counts)
        kernels = phase_kernels(paths)
        phase_parity()
        smi = nvidia_smi_line()
    except Exception:  # noqa: BLE001 - any failed phase fails the run
        traceback.print_exc()
        return 1
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
