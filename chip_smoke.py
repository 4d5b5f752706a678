"""Smoke test of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's paths (rend3_tpu_torch) on the card through the entry
points a user calls (TestRunner / Renderer scene calls,
swap_instruction_buffers, evaluate_instructions, BaseRenderGraph.render_frame,
routine.base.raster_scene, probe_shadow.run, the tools.probe_bf16_* probes)
at 1920x1080: the flat
city-block scene of `bench.py --flat`, the textured city (the
representative bench scene without its alpha-tested foliage and
alpha-blended glass), the whole representative bench frame (foliage through
the cutout peels, glass through the blend peels) at 1 and at 4 samples
(MSAA), all but the flat one with two-phase occlusion culling, the
visibility raster of the representative frame's opaque triangles, the
map-free shadow resolve of its light 0, the bf16 probes P1-P3, and the
feature city (the representative frame with a skybox, skinned columns,
registered material routines and injected passes) at 1 and 4 samples,
then the app layer (framework, overlay, glTF, animation and the examples)
at 1280x720, then the reference forward backend on the representative
city cut in depth, the host-loop micro-bench, row bands of the frame on
the one card, the bench line (rend3_tpu_torch.bench, with its 2.04M-triangle
heavy city) and the graft entry points (rend3_tpu_torch.graft_entry). It checks every hand-written kernel of those paths, K1 in
each of its modes, against its plain PyTorch version.
Phases (each raises on failure; any failure exits nonzero; each prints its
wall time):

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
6. msaa: the representative frame at 4 samples, as phase 5 (an
   occlusion-off reference frame, then three counted occlusion-on frames,
   1 and 2 equal to the reference bit for bit, 3 with a building moved);
7. visibility raster: raster_scene (K6) at 1 and at 4 samples over the
   representative frame's opaque clipped table, counted; K6 against its
   plain version (ids and depth bit-exact) and its depth and hit against
   K1's G-buffer of the same triangles at the same offsets (equal); at
   each sample count K6's device, call and plain times and its bound;
8. map-free shadows: probe_shadow.run (K7 and K8 once each) on light 0 of
   the representative frame, counted; each against its plain version at
   hit pixels (bit-exact), the number of values where K7 and K8 differ,
   and pcf5_from_occlusion of K8 against the frame's K3 factors where K3's
   query was valid (at most 1% differ by more than 1e-6); the lists'
   lengths (probe_shadow), their segments of the CUDA kernel's work, the
   distinct base texels and the (base texel, nearby caster) pairs;
9. probes: run() of tools.probe_bf16_dot, _kernel and _real (P1-P3) on
   the card, counted; every variant's output against its plain version on
   the card, bit for bit with NaN positions equal;
10. features (at 1, then 4 samples): scenes.feature_city, an occlusion-off
   reference frame (with a pass that counts the registered routines'
   G-buffer pixels), then (counters zeroed) three occlusion-on frames:
   frames 1 and 2 must equal the reference bit for bit, frame 3 moves the
   columns' joints and must rebuild the shadow maps; sky pixels, routine
   pixels, a K4 launch of the skybox in every frame and both injected
   passes in every frame are checked, and the archetype with no routine
   must draw nothing (registering a routine for it then makes it draw);
11. kernels: K1, K2 and K3 on the inputs captured in the flat frames (K3
   on the shading chain's queries at the frame's D1 inputs,
   lighting.chain_inputs), K4 (the same way) and K5 on those of the
   textured frames, D1 (ops/lighting.py, csrc/deferred_shade.cu) on the
   representative frame's opaque G-buffer and blend pixels, C1 (the same
   file) on its first cutout peel (timed as its raw launch) and on sample
   0's at 4 samples, K1's count and bound modes on
   those of the representative frames, K1 at
   an MSAA offset on those of the MSAA frames, K4 on the skybox query of
   the feature frame, K1 in every mode, K2 and K6 (at 1 and 4 samples) on
   the raster stress input (rend3_tpu_torch.testing.raster_stress_case),
   K7 and K8 on the shadow stress input (testing.shadow_stress_case), P3 on
   its stress input (testing.probe_lerp_stress_case) and P2's reduce at a
   width off its CTA's, K6-K8 on those of phases 7 and 8, P1-P3 on the
   probes' inputs, S1 and S2 (ops/shadow_front.py, csrc/shadow_front.cu)
   on the representative frame's shadow pass (rows, tile offsets and
   lists, and K2's maps on them), against their plain versions on the
   card, with the whole shadow pass's host time beside the PyTorch
   chain's; every example, band and bench frame that re-rasters a map also
   holds S1 / S2 to their plain version (_check_frame_kernels). Each kernel
   and library row is timed on the device: 20 calls captured in one CUDA
   graph, replayed between two CUDA events, the median of five replays over
   20 (P3, whose wrapper reads its step cells on the host, through its raw
   launch on a prepared output), beside the time of one call between two
   CUDA events (host included), the plain version's median, the bound each
   kernel's bytes or operations set on the card, and the time of one
   PyTorch call computing the same function where there is one; the launch
   floor (an empty kernel's device time in the same CUDA graphs, on one CTA
   and on K5's grid); the registers, spills, shared memory and resident
   CTAs per SM of every hand-written kernel; and rule 2's order of the
   kernels still to redesign (rend3_tpu_torch.testing.redesign_order), or
   that none is left. F1, the float32 fma forms (ops/fp.py fma32, dot3,
   ab_minus_cd; csrc/fma.cu), bit for bit with NaN positions equal against
   their plain versions (the float64 emulation): in each form on
   testing.fma_stress_case at 2^24 rows (one call is one device kernel that
   makes no float64 tensor, testing.f1_call_trace), and at every call site
   of the representative frames (fp.capture: the largest call of each form
   from each site, among them the Hi-Z test); each form's row timed at its
   largest site in ops/texture.py (the texture query, which the card's
   frames no longer call: D1 and C1 took it), ops/transform.py (the clip
   transform) and ops/geometry.py (setup), the fma row's library yardstick
   torch.addcmul(c, a, b) with whether its bits match;
12. parity: the shadow golden scene, the textured-planes scene, the stacked
   cutout scene and the glass stack at 256x256, test_msaa's triangle at
   64x64 and 4 samples, a 64x64 skybox scene, a skinned scene and the
   routine-registry scene, on the card and on the CPU: images within 1
   u8, every shadow map bit for bit;
13. framework: the app layer through its entry points at 1280x720 (the
   reference screenshots' size), each example's launches counted from
   zero and each kernel it launched (K1-K5, D1, C1) held against its plain
   version on the frame's captured inputs with phase 11's tolerances; every
   example frame is also rendered on the CPU and held to the card's within
   1 u8: the cube example through framework.render_single_frame, also
   against the JAX package's committed render cube.png (mae 0.005, SSIM
   0.99; K1, K2 and D1 launched; the largest u8 difference and the pixels
   more than 1 u8 off); the overlay example with OVERLAY_ON_DEVICE True
   and False (within 1 u8), and the overlay's bake, device pass and host
   compositor timed with CUDA events; textured_quad on a checker built in
   memory (D1 launched); testing.GltfAnimationApp (testing.make_test_gltf()
   through gltf.loader.load_gltf, posed by anim.pose_animation_frame at t
   = 0, half the duration and the duration through framework.start) with
   its load, pose and frame times and each frame's peak memory above what
   was allocated when it began, the rigid and skinned nodes moving between
   frames; and utils.profiling: both scopes in the chrome trace, and
   device_trace writing a trace of the card's kernels;
14. reference: the reference forward backend (REND3_TPU_RASTER=reference)
   on the representative city cut to REFERENCE_BUILDINGS buildings at
   1920x1080, at 1 and 4 samples (frame time, peak memory, stages), and
   shadow.sample_shadow_map / sample_shadow_maps (K5) on the 1-sample
   frame's maps at the deferred frame's light-space coordinates, launches
   counted over those frames and calls (K5's row of the kernels line adds
   them); K5 there against its plain version bit for bit, raster.rasterize
   on a 64-triangle soup at 1920x1080 card against CPU bit for bit, the
   forward frame at 320x180 card against CPU within 1 u8, and (a
   diagnostic) the pixels where the forward frame is more than 1 u8 off
   the deferred frame of the same scene (the forward frame draws cutouts
   as opaque);
15. bench_host: tools.bench_host at 50,000 objects on the card (swap +
   evaluate + the frame's host upload, 20 iterations), its median logged;
16. bands: row bands (rend3_tpu_torch.parallel.tiles) through
   build_tiled_frame_callable on the local mesh (n bands on the one card,
   in lockstep): the representative frame at 2, 4 and 8 bands, at MSAA 4
   with 4 bands, and the feature frame with 4 bands, two frames each (all
   predicted, then the carried mask), each bit for bit against the
   one-device frames of the same scene, with each frame's host time and
   peak memory beside the one-device frame's (a diagnostic); launches
   counted over the banded frames (K1 at a band's first row past 0 counts
   as raster_band, a row of the kernels line); K1 at every band's first row
   against its plain version on the band's captured inputs; one frame
   through a world-size-1 NCCL process group and the distributed mesh,
   bit for bit against the one-device frame;
17. bench: `python -m rend3_tpu_torch.bench --flat --heavy` in a child
   process (exit 0, exactly one stdout line with bench.py's keys, printed
   on a line of its own), then, counted, the representative city and the
   heavy city (1,000 buildings at subdiv 12, about 2.04M triangles) at
   1920x1080: two warm-up frames through render_frame_tensor, then three
   calls of build_frame_callable's program, each bit for bit the warm-up
   frame, the last logging each stage's peak memory (the clip stage's
   above the frame's start on a line of its own); for the representative
   city, the kernel launches, copies, float64 kernels and device busy time
   per static frame (the program) and per shadow pass, by torch.profiler
   over three calls each (tools.frame_launches.profile_calls); the heavy
   frame's K1 (opaque, count and bound modes), K2, K3, K4 and K5 against
   their plain versions on its captured inputs;
18. entry: rend3_tpu_torch.graft_entry, counted: entry()'s program on the
   rich scene at 256x256, then dryrun_multichip(n) for n = 2, 4, 8 bands,
   each bit for bit against the one-device program.

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
KERNEL_NAMES = (
    "raster_resolve", "raster_msaa", "raster_count", "raster_bound", "raster_band", "raster_depth", "pcf5", "bilinear",
    "gather", "raster_vis", "shadow_occ", "shadow_occ_lt", "probe_dot", "probe_reduce", "probe_lerp",
    "fma", "fma_dot3", "fma_ab_minus_cd", "shadow_setup", "shadow_tiles",
    "view_clip", "view_setup", "view_planes", "view_tiles", "deferred_shade", "cutout_alpha",
)
# F1's forms (ops/fp.py fma32, dot3, ab_minus_cd): every frame's clip,
# setup and light-space products launch all three.
F1_KERNELS = ("fma", "fma_dot3", "fma_ab_minus_cd")
# The form a deferred frame launches on the card with occlusion on: ab_minus_cd
# in the Hi-Z visibility mask. dot3 and the rest of ab_minus_cd left its
# front end with V1-V4, the light-space products and the shading's texture
# queries went into D1, the cutout alpha test's texture queries (fma) into
# C1.
F1_FRAME_KERNELS = ("fma_ab_minus_cd",)
# S1 and S2 (ops/shadow_front.py): every shadow pass on the card builds its
# maps' caster tables and tile lists with them, then K2 rasters.
SHADOW_KERNELS = ("shadow_setup", "shadow_tiles")
# V1-V4 (ops/view_front.py): every frame on the card builds its triangle
# sets' front-end tables with them.
VIEW_KERNELS = ("view_clip", "view_setup", "view_planes", "view_tiles")
# The kernels each frame path must launch (C1: the cutout alpha test; D1:
# the shading).
FRAME_KERNELS = ("raster_resolve", "raster_count", "raster_bound", "raster_depth", "cutout_alpha", "gather",
                 "deferred_shade", *F1_FRAME_KERNELS, *SHADOW_KERNELS, *VIEW_KERNELS)
MSAA_KERNELS = ("raster_msaa", "raster_count", "raster_bound", "raster_depth", "cutout_alpha", "gather",
                "deferred_shade", *F1_FRAME_KERNELS, *SHADOW_KERNELS, *VIEW_KERNELS)
# The kernels the feature frame must launch at 1 / 4 samples: C1 also with
# its registered cutout routine, K2 for the new pose's shadow maps, K4 and
# F1's fma for the skybox.
FEATURE_KERNELS = {1: (*FRAME_KERNELS, "bilinear", "fma"), 4: (*MSAA_KERNELS, "bilinear", "fma")}
PROBE_KERNELS = ("probe_dot", "probe_reduce", "probe_lerp")
# Buildings of the representative city in the reference phase (of 600): the
# forward frame rasterizes and shades in O(triangles x pixels).
REFERENCE_BUILDINGS = 40


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
    # ptxas -v: each kernel's registers, shared memory and spills.
    for line in cuda_kernels.last_build["log"].splitlines():
        if line.startswith("[") or "Compiling entry" in line or "spill" in line or "Used" in line:
            log("  nvcc: " + line.strip())


def _counters():
    from rend3_tpu_torch.ops import (deferred, fp, lighting, probe_bf16, raster_binned, samplers, shadow, shadow_front,
                                     view_front)

    return (deferred.launches, samplers.launches, raster_binned.launches, shadow.launches, probe_bf16.launches,
            fp.launches, shadow_front.launches, view_front.launches, lighting.launches)


def _launch_counts():
    counts = {k: v for d in _counters() for k, v in d.items()}
    return {name: counts[name] for name in KERNEL_NAMES}


def _reset_launch_counts():
    for d in _counters():
        for k in d:
            d[k] = 0


def _frame_fn(runner, target, settings, device, skybox_slot=None):
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
        img = graph.render_frame(ev, target, settings, skybox_slot)
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
        _check_launched(counts, ("raster_resolve", "raster_depth", "deferred_shade", *SHADOW_KERNELS, *VIEW_KERNELS))
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
        _check_launched(counts, ("raster_resolve", "raster_depth", "gather", "deferred_shade", *SHADOW_KERNELS))
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


def phase_representative(device="cuda", width=WIDTH, height=HEIGHT, n_buildings=600, samples=1):
    """The whole representative bench frame with two-phase occlusion
    culling, at 1 or 4 samples: an occlusion-off reference frame, then
    three counted frames; returns (graph, counts, image)."""
    import numpy as np
    import torch

    from rend3_tpu_torch import scenes
    from rend3_tpu_torch.ops import fp
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
        runner, FrameRenderTarget(width, height, samples),
        BaseRenderGraphSettings(ambient_color=(0.08, 0.08, 0.1, 1.0)), device,
    )
    name = "representative" if samples == 1 else f"msaa{samples}"
    # Objects: the ground, then the buildings; move the last building.
    building = [h for h in keep if getattr(h, "kind", None) == "object"][n_buildings]
    cuda = torch.device(device).type == "cuda"

    graph.occlusion_culling = False
    ref = frame(f"{name} 0 (occlusion off, the reference)")
    s_off = graph.last_stats["main_survivors"]
    graph.occlusion_culling = True
    _reset_launch_counts()
    fp.capture = {}  # F1's inputs at every call site of the counted frames, for phase 11
    try:
        img1 = frame(f"{name} 1 (occlusion on, predicts every triangle)")
        img2 = frame(f"{name} 2 (occlusion on, the carried mask)")
        st = dict(graph.last_stats)
        s_on2 = st["main_survivors"] + st["resid_survivors"]
        runner.renderer.set_object_transform(building,
                                             m3.translation([24.0, 25.0, -40.0]) @ m3.scale([3.0, 25.0, 3.0]))
        img3 = frame(f"{name} 3 (occlusion on, a building moved)")
    finally:
        graph.captured["fma_sites"], fp.capture = fp.capture, None
    counts = _launch_counts()
    log(f"launches during the three {name} frames: {counts}")
    log(f"frame 2 opaque survivors: main + resid = {s_on2} vs {s_off} with occlusion off")
    if cuda:
        _check_launched(counts, FRAME_KERNELS if samples == 1 else MSAA_KERNELS)
    if st["samples"] != samples:
        raise AssertionError(f"the frames rendered {st['samples']} samples, not {samples}")
    for img in (ref, img1, img2, img3):
        _check_image(img, width, height)
    if not s_on2 < s_off:
        raise AssertionError(f"occlusion culling did not cut the survivors ({s_on2} vs {s_off})")
    if not (st["cut_survivors"] > 0 and st["cut_peels"] >= 1 and st["blend_px"] > 0 and st["blend_peels"] >= 2):
        raise AssertionError(f"frame 2 did not run the cutout and blend peels: {st}")
    for k, img in ((1, img1), (2, img2)):
        if not np.array_equal(img, ref):
            n = int((img != ref).any(-1).sum())
            raise AssertionError(f"{name} frame {k} differs from the occlusion-off frame at {n} pixels")
    if np.array_equal(img2, img3):
        raise AssertionError("moving a building changed nothing")
    log(f"image: {ref.shape}, non-background {(ref[..., :3] != 0).any(-1).mean():.4f}, mean {ref.mean():.3f}")
    del keep
    return graph, counts, ref


def _same_with_nan(a, b):
    """Equal bit for bit where not NaN, NaN at the same places."""
    import torch

    na, nb = torch.isnan(a), torch.isnan(b)
    return a.shape == b.shape and torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def _check_probe_runs(name, runs, init):
    """Each run's output against its plain version: bit for bit where not
    NaN, NaN at the same places. Runs not NaN-initialised must also hold
    values (not NaN, not all zero), so that the comparison reads them."""
    import torch

    for r in runs:
        p = r.plain()
        if not _same_with_nan(r.out, p):
            n = int(((r.out != p) & ~(torch.isnan(r.out) & torch.isnan(p))).sum())
            raise AssertionError(f"{name} {r.name!r} (init {init}) differs from its plain version at {n} values")
        n_val = int((~torch.isnan(r.out)).sum())
        if init != "nan" and not (n_val > 0 and bool((r.out[~torch.isnan(r.out)] != 0).any())):
            raise AssertionError(f"{name} {r.name!r} (init {init}) holds no nonzero value to compare")
        log(f"{name} {r.name!r} ({'+'.join(r.kernels)}, init {init}): bit-exact against the plain version "
            f"over {r.out.numel()} values, {n_val} of them not NaN")


def phase_probes(device="cuda"):
    """The three bf16 probe entry points (P1-P3), counted; every variant
    against its plain version, as the entry points run it (NaN-initialised
    outputs) and again on zero-initialised outputs, where the variants that
    add into an output they never write first give values. Returns
    (counts, {module: runs})."""
    import torch

    from rend3_tpu_torch.tools import probe_bf16_dot, probe_bf16_kernel, probe_bf16_real

    _reset_launch_counts()
    runs = {}
    for mod in (probe_bf16_dot, probe_bf16_kernel, probe_bf16_real):
        name = mod.__name__.rsplit(".", 1)[1]
        log(f"python3 -m rend3_tpu_torch.tools.{name}:")
        runs[name] = mod.run(device, log=lambda line: log("  " + line))
    counts = _launch_counts()
    log(f"launches of the probes: {counts}")
    if torch.device(device).type == "cuda":
        _check_launched(counts, PROBE_KERNELS)
    for name, rs in runs.items():
        _check_probe_runs(name, rs, "nan" if name != "probe_bf16_dot" else "none")
    # P1 writes every output value; P2 and P3 once more from zeros.
    for mod in (probe_bf16_kernel, probe_bf16_real):
        name = mod.__name__.rsplit(".", 1)[1]
        _check_probe_runs(name, mod.run(device, init="zero", log=lambda _line: None), "zero")
    return counts, runs


def _magenta(img):
    """Pixels of exactly (255, 0, 255): the unregistered archetype's colour."""
    return int(((img[..., 0] == 255) & (img[..., 1] == 0) & (img[..., 2] == 255)).sum())


def phase_features(device="cuda", width=WIDTH, height=HEIGHT, n_buildings=600, samples=1, sky_size=512,
                   n_columns=64):
    """The feature city at `samples` samples: an occlusion-off reference
    frame, then three counted occlusion-on frames, the third with a new
    pose; returns (graph, counts, image)."""
    import numpy as np
    import torch

    from rend3_tpu_torch import scenes
    from rend3_tpu_torch.ops import deferred as D
    from rend3_tpu_torch.routine.base import BaseRenderGraphSettings, FrameRenderTarget
    from rend3_tpu_torch.routine.registry import unlit_routine
    from rend3_tpu_torch.testing import TestRunner

    t0 = time.perf_counter()
    runner = TestRunner(device=device)
    keep, info = scenes.feature_city(runner, n_buildings=n_buildings, sky_size=sky_size, n_columns=n_columns)
    scenes.set_bench_camera(runner, width, height)
    log(f"feature city built in {time.perf_counter() - t0:.2f} s: {len(info['skeletons'])} skinned columns, "
        f"routines {sorted(r.archetype for r in info['routines'])}")
    graph = runner.base_graph
    graph.captured = {}
    # The scene's passes, counted: unregistered and registered again wrapped.
    calls = {"hdr": 0, "srgb": 0}

    def counted(fn, stage):
        def run(img, gbuf, uniforms):
            calls[stage] += 1
            return fn(img, gbuf, uniforms)
        return run

    for fn, stage in zip(info["passes"], ("hdr", "srgb")):
        graph.unregister_pass(fn)
        graph.register_pass(counted(fn, stage), stage=stage)
    frame = _frame_fn(
        runner, FrameRenderTarget(width, height, samples),
        BaseRenderGraphSettings(ambient_color=(0.08, 0.08, 0.1, 1.0)), device, skybox_slot=info["sky"].idx,
    )
    name = f"features{samples}"
    cuda = torch.device(device).type == "cuda"
    routine_px = {}

    def mat_probe(img, gbuf, uniforms):
        g = gbuf.data
        m = torch.round(g[D.G_MAT])[g[D.G_HIT] > 0]
        routine_px["n"] = int((m >= graph.last_stats["pbr_slots"]).sum())  # global slots past the PBR table
        return img

    graph.occlusion_culling = False
    graph.register_pass(mat_probe, stage="hdr")
    ref = frame(f"{name} 0 (occlusion off, the reference)")
    graph.unregister_pass(mat_probe)
    s_off = graph.last_stats["main_survivors"]
    graph.occlusion_culling = True
    _reset_launch_counts()
    calls.update(hdr=0, srgb=0)
    img1 = frame(f"{name} 1 (occlusion on, predicts every triangle)")
    sky_k4 = [graph.last_stats["sky_k4_launches"]]
    img2 = frame(f"{name} 2 (occlusion on, the carried mask, same pose)")
    sky_k4.append(graph.last_stats["sky_k4_launches"])
    st = dict(graph.last_stats)
    s_on2 = st["main_survivors"] + st["resid_survivors"]
    k2_after_2 = _launch_counts()["raster_depth"]
    state2 = graph._shadow_cache[0]
    scenes.pose_columns(runner, info["skeletons"], 1.0)
    img3 = frame(f"{name} 3 (occlusion on, a new pose)")
    sky_k4.append(graph.last_stats["sky_k4_launches"])
    counts = _launch_counts()
    n_sky = int(graph.captured["bilinear_sky"][-1].sum())
    log(f"launches during the three {name} frames: {counts}; skybox K4 launches per frame {sky_k4}; "
        f"pass calls {calls}; {n_sky} sky queries in frame 3; {routine_px['n']} routine G-buffer pixels")
    log(f"frame 2 opaque survivors: main + resid = {s_on2} vs {s_off} with occlusion off")
    if cuda:
        _check_launched(counts, FEATURE_KERNELS[samples])
        if min(sky_k4) < 1:
            raise AssertionError(f"the skybox did not launch K4 in every frame: {sky_k4}")
        if counts["raster_depth"] <= k2_after_2:
            raise AssertionError("the new pose did not re-raster the shadow maps")
    if graph._shadow_cache[0] == state2:
        raise AssertionError("the new pose did not invalidate the shadow maps")
    if calls != {"hdr": 3, "srgb": 3}:
        raise AssertionError(f"the injected passes did not run once per frame: {calls}")
    if st["samples"] != samples or not n_sky or not routine_px["n"]:
        raise AssertionError(f"no sky pixels ({n_sky}) or no routine pixels ({routine_px['n']}), stats {st}")
    if not (st["cut_survivors"] > 0 and st["blend_px"] > 0):
        raise AssertionError(f"frame 2 did not run the cutout and blend peels: {st}")
    for img in (ref, img1, img2, img3):
        _check_image(img, width, height)
        if _magenta(img):
            raise AssertionError(f"the archetype with no routine drew {_magenta(img)} pixels")
    if not s_on2 < s_off:
        raise AssertionError(f"occlusion culling did not cut the survivors ({s_on2} vs {s_off})")
    for k, img in ((1, img1), (2, img2)):
        if not np.array_equal(img, ref):
            n = int((img != ref).any(-1).sum())
            raise AssertionError(f"{name} frame {k} differs from the occlusion-off frame at {n} pixels")
    if np.array_equal(img2, img3):
        raise AssertionError("the new pose changed nothing")
    # The control: with a routine, the hidden archetype's signs do draw.
    graph.register_routine(unlit_routine(info["classes"]["HiddenSignMaterial"]))
    shown = _magenta(frame(f"{name} control (a routine for the hidden archetype)"))
    log(f"the archetype with no routine drew 0 pixels; with a routine it draws {shown}")
    if not shown:
        raise AssertionError("the hidden archetype's signs are not in view: the check above proves nothing")
    log(f"image: {ref.shape}, non-background {(ref[..., :3] != 0).any(-1).mean():.4f}, mean {ref.mean():.3f}")
    del keep
    return graph, counts, ref


def _median_ms(fn, reps):
    """Median time of one call between two CUDA events: the call's device
    time and the host time of the wrapper around it (host included)."""
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


# Calls in one device-time measurement.
DEVICE_CALLS = 20


def _graph_ms(fn, n=DEVICE_CALLS, replays=5):
    """Device time of one call of fn: n calls captured in one CUDA graph
    (after three warm-up calls on a side stream and one warm-up replay),
    the graph replayed between two CUDA events, the median over `replays`
    replays divided by n. Raises if the graph shows no device time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / n)
    del graph
    ms = statistics.median(times)
    if not ms > 0.0:
        raise AssertionError(f"a CUDA graph of {n} calls shows no device time ({times})")
    return ms


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


def _raster_fragments(tris, binned, width, tile_h=32, tile_w=128, y0=0):
    """Pixels the raster kernels must test this run: per listed
    (tile, triangle) pair, the tile's pixels inside the triangle's bbox
    (tile rows from target row y0 on, a row band's first row)."""
    import torch

    offs = binned.offsets.long()
    tile = torch.repeat_interleave(torch.arange(offs.numel() - 1, device=offs.device), offs[1:] - offs[:-1])
    bb = tris.bbox[binned.ids.long()]
    n_cols = width // tile_w
    tx0 = (tile % n_cols) * tile_w
    ty0 = (tile // n_cols) * tile_h + y0
    nx = (torch.minimum(torch.ceil(bb[:, 2]).long(), tx0 + tile_w) - torch.maximum(torch.floor(bb[:, 0]).long(), tx0))
    ny = (torch.minimum(torch.ceil(bb[:, 3]).long(), ty0 + tile_h) - torch.maximum(torch.floor(bb[:, 1]).long(), ty0))
    return int((nx.clamp_min(0) * ny.clamp_min(0)).sum())


# f32 operations per tested (pixel, triangle): three edge planes and the
# depth plane (a multiply, an fma and an add each), their sign and top-left
# tests and the depth range; per covered pixel K1's finalize evaluates 21
# planes (three operations each) and the four uv derivatives (about six).
RASTER_TEST_OPS = 24
K1_FINALIZE_OPS = 21 * 3 + 4 * 6
# f32 operations per (base texel, nearby caster) pair of the map-free
# shadow occlusion: four planes at the base texel (three operations each),
# then per PCF offset four offset planes (three each), three edge tests,
# the depth test and the max.
OCC_PAIR_OPS = 4 * 3 + 12 * (4 * 3 + 5)


def _k1_bound(tris, planes, binned, w, h, extra_in=(), extra_out=(), y0=0):
    """K1's bound; its bound or floor images (extra_in) count only over the
    tiles whose lists are not empty, the only ones that need them; y0 as
    in raster_resolve."""
    from rend3_tpu_torch.ops import deferred as D

    frags = _raster_fragments(tris, binned, w, y0=y0)
    listed = float((binned.offsets[1:] > binned.offsets[:-1]).float().mean())
    bytes_moved = _nbytes(tris.setup, tris.bbox, planes, binned.offsets, binned.ids, *extra_out)
    bytes_moved += listed * _nbytes(*extra_in) + D.GB_CH * w * h * 4
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


def _k4_check(label, a):
    """K4 against its plain version: exact or at most 1 ulp. Returns the
    max abs error."""
    from rend3_tpu_torch.ops import samplers as S

    k = S.sample_grid_bilinear(*a)
    p = S.sample_grid_bilinear_plain(*a)
    ulps = _ulps(k, p)
    err = float((k - p).abs().max())
    log(f"K4 ({label}): {int(a[1].numel())} queries ({int(a[-1].sum())} valid), atlas {tuple(a[0].shape)}; "
        f"{int((ulps > 0).sum())} of {k.numel()} values differ, max {int(ulps.max())} ulp, max abs {err:.3g}")
    if int(ulps.max()) > 1:
        raise AssertionError(f"K4 ({label}) differs from its plain version by {int(ulps.max())} ulp")
    return err


# D1 against its plain version (the PyTorch chain) on the card, as
# tests/test_torch_cuda.py holds it: NaN at the same places, every other
# value bit for bit or within D1_REL where the device library's powf (the
# sRGB decode of vertex colours) rounds otherwise under D1's --fmad=false
# than in PyTorch's build, the u8 image within 1.
D1_REL = 2e-6


def _d1_check(label, args):
    """D1 (lighting.light_gbuffer) against light_gbuffer_plain on one
    call's captured arguments, within D1_REL and 1 u8. Returns the largest
    relative difference."""
    import torch

    from rend3_tpu_torch.ops import blit
    from rend3_tpu_torch.ops import lighting as L

    def u8(img):
        return blit.hdr_to_srgb_u8(blit.f16_roundtrip(img[None])[0]).to(torch.int32)

    got = L.light_gbuffer(*args)
    want = L.light_gbuffer_plain(*args).contiguous()
    nan = torch.isnan(want)
    diff = (got.view(torch.int32) != want.view(torch.int32)) & ~nan
    rel = ((got - want).abs() / want.abs().clamp_min(1e-30))[diff]
    rel_max = float(rel.max()) if rel.numel() else 0.0
    d8 = int((u8(got) - u8(want)).abs().max())
    hit = args[0].data[20] > 0
    log(f"D1 ({label}): {tuple(got.shape[:2])} pixels, {int(hit.sum())} hit, slots {tuple(args[8])}, "
        f"{0 if args[6] is None else len(getattr(args[6], 'plan', ()))} maps; {int(diff.sum())} of {diff.numel()} "
        f"values differ from the chain (channels {[int(x) for x in diff.reshape(-1, 4).sum(0)]}), max rel "
        f"{rel_max:.3g}, u8 max {d8}, NaN {int(nan.sum())}")
    if not torch.equal(torch.isnan(got), nan) or rel_max > D1_REL or d8 > 1:
        raise AssertionError(f"D1 ({label}) differs from its plain version beyond its tolerance")
    return rel_max


def _d1_bound(args):
    """D1's bound at one call's arguments: the G-buffer channels it reads
    (22 at a hit pixel, the hit flag and the background elsewhere), the
    RGBA it writes, and the distinct texels (8 bytes each) and map texels
    (4 bytes) the chain's valid queries touch, at 3.35 TB/s."""
    import torch

    from rend3_tpu_torch.ops import lighting as L
    from rend3_tpu_torch.ops import samplers as S

    g, bg = args[0].data, args[5]
    hit = g[20] > 0
    n, n_hit = hit.numel(), int(hit.sum())
    moved = n_hit * 22 * 4 + (n - n_hit) * (4 + (16 if bg.stride(1) else 0)) + n * 16
    ins = L.chain_inputs(*args)
    if "bilinear" in ins:
        atlas, bx, by, _fx, _fy, _wt, valid = ins["bilinear"]
        aw = atlas.shape[1]
        at = (by.long() * aw + bx.long())[valid]
        taps = torch.cat([at, at + 1, at + aw, at + aw + 1])
        moved += 8 * int(torch.unique(taps).numel())
    if "pcf5" in ins:
        stacked, bx, by, _fx, _fy, _ref, ok = ins["pcf5"]
        at = (by.long() * stacked.shape[1] + bx.long())[ok]
        taps = torch.cat([at + dy * stacked.shape[1] + dx for dx, dy in S.PCF5_OFFSETS])
        moved += 4 * int(torch.unique(taps).numel())
    return _bound(moved, 0)


def _d1_row(args, timed):
    """D1 on the representative frame's opaque G-buffer: checked, and its
    phase-11 row, timed as its raw launch (the wrapper also computes the
    per-light vectors with PyTorch ops)."""
    from rend3_tpu_torch.ops import cuda_kernels
    from rend3_tpu_torch.ops import lighting as L

    err = _d1_check("representative, opaque", args)
    tensors, ints = L.launch_args(*args, L.light_tensors(*args[2:5]))
    bound = _d1_bound(args)
    if timed:
        log(f"D1 (representative, opaque): wrapper {_graph_ms(lambda: L.light_gbuffer(*args))} ms (device, graph of "
            f"{DEVICE_CALLS} calls, the light vectors' PyTorch ops included)")
    return ("deferred_shade", "rend3_tpu_torch/csrc/deferred_shade.cu", "rend3_tpu/ops/lighting.py:50",
            lambda: L.light_gbuffer(*args), lambda: L.light_gbuffer_plain(*args), err, bound, None,
            lambda: cuda_kernels.call("d1_deferred_shade", *tensors, ints=ints))


def phase_visibility(graph, device="cuda"):
    """raster_scene (K6) at 1 and 4 samples over the opaque clipped table
    of `graph`'s last representative frame (occlusion plays no part:
    raster_scene culls the whole table). Returns (counts, kernel rows)."""
    import torch

    from rend3_tpu_torch.ops import deferred as D
    from rend3_tpu_torch.ops import geometry as G
    from rend3_tpu_torch.ops import raster as R
    from rend3_tpu_torch.ops import raster_binned as RB
    from rend3_tpu_torch.routine.base import raster_scene

    clip, valid, front_cw, width, height = graph.captured["opaque_table"]
    cases = (("1 sample", R.CENTER_OFFSET), ("4 samples", R.MSAA4_OFFSETS))
    _reset_launch_counts()
    vis = [
        raster_scene(clip, valid, width, height, cull_mode=G.CullMode.BACK, front_is_cw=front_cw,
                     sample_offsets=offs)
        for _label, offs in cases
    ]
    counts = _launch_counts()
    log(f"launches of the visibility raster: {counts}")
    if torch.device(device).type == "cuda":
        _check_launched(counts, ("raster_vis",))
    rows = []
    for (label, offs), v in zip(cases, vis):
        tris = G.cull_and_setup(clip, valid, width, height, cull_mode=G.CullMode.BACK, front_is_cw=front_cw,
                                subpixel=len(offs) == 1)
        wp, hp = -(-width // G.TILE_W) * G.TILE_W, -(-height // G.TILE_H) * G.TILE_H
        binned = G.bin_triangles(tris, wp, hp, tile_h=G.TILE_H, tile_w=G.TILE_W)
        k = RB.rasterize_binned(tris, binned, wp, hp, offs)
        p = RB.rasterize_binned_plain(tris, binned, wp, hp, offs)
        if not (torch.equal(k.tri, p.tri) and torch.equal(k.depth, p.depth)):
            n = int(((k.tri != p.tri) | (k.depth != p.depth)).sum())
            raise AssertionError(f"K6 ({label}) differs from its plain version at {n} samples")
        if not (torch.equal(v.tri, k.tri[:, :height, :width]) and torch.equal(v.depth, k.depth[:, :height, :width])):
            raise AssertionError(f"raster_scene ({label}) differs from K6 on the same tables")
        # K1 over the same survivors at 32x128 tiles: the same planes and tie
        # rule, so the same depth and coverage. Zero attribute planes: only
        # the depth and hit channels are compared.
        wp1, hp1 = -(-width // D.DTILE_W) * D.DTILE_W, -(-height // D.DTILE_H) * D.DTILE_H
        binned1 = G.bin_triangles(tris, wp1, hp1, tile_h=D.DTILE_H, tile_w=D.DTILE_W)
        planes0 = torch.zeros(tris.count, D.PLANES_W, device=tris.setup.device)
        for si, sofs in enumerate(offs):
            g = D.raster_resolve(tris, planes0, binned1, wp1, hp1, sofs=sofs).data
            if not (torch.equal(g[D.G_DEPTH, :height, :width], v.depth[si])
                    and torch.equal(g[D.G_HIT, :height, :width] > 0, v.tri[si] >= 0)):
                n = int((g[D.G_DEPTH, :height, :width] != v.depth[si]).sum())
                raise AssertionError(f"K6 ({label}) and K1 differ in depth or coverage (depth at {n} pixels)")
        kfn = lambda t=tris, b=binned, o=offs: RB.rasterize_binned(t, b, wp, hp, o)  # noqa: E731
        pfn = lambda t=tris, b=binned, o=offs: RB.rasterize_binned_plain(t, b, wp, hp, o)  # noqa: E731
        ms, call_ms, plain_ms = (_graph_ms(kfn), _median_ms(kfn, 20), _median_ms(pfn, 3)) if k.tri.is_cuda else (
            None, None, None)
        frags = _raster_fragments(tris, binned, wp, G.TILE_H, G.TILE_W)
        bound = _bound(_nbytes(tris.setup, tris.bbox, binned.offsets, binned.ids, k.depth, k.tri),
                       frags * len(offs) * RASTER_TEST_OPS)
        log(f"K6 ({label}): {tris.count} triangles, {int(binned.ids.numel())} 8x128 tile pairs; ids and depth "
            f"bit-exact against the plain version over {k.tri.numel()} samples, {int((k.tri >= 0).sum())} covered; "
            f"depth and coverage equal to K1's at the same offsets; kernel {ms} ms (device, CUDA graph), call "
            f"{call_ms} ms (host included, median), plain {plain_ms} ms (median); bound {bound[0]:.6f} ms "
            f"({bound[1]})")
        if len(offs) == len(R.MSAA4_OFFSETS):
            rows.append(("raster_vis", "rend3_tpu_torch/csrc/raster.cu", "rend3_tpu/ops/raster_pallas.py:54",
                         kfn, pfn, 0.0, bound, None))
    return counts, rows


def phase_mapfree(graph, device="cuda"):
    """probe_shadow.run (K7 and K8 once each) on light 0 of `graph`'s last
    representative frame. Returns (counts, kernel rows)."""
    import torch

    from rend3_tpu_torch import probe_shadow
    from rend3_tpu_torch.ops import shadow as SH

    _reset_launch_counts()
    res = probe_shadow.run(graph, log=log)
    counts = _launch_counts()
    log(f"launches of the map-free shadow resolve: {counts}")
    if torch.device(device).type == "cuda":
        _check_launched(counts, ("shadow_occ", "shadow_occ_lt"))
    stris, sx, sy, hit, width, height, size, ref, in_bounds, factor = probe_shadow.inputs(graph.captured)
    h = hit[None].expand(SH.N_OFF, -1, -1)
    plain = {
        "K7": SH.shadow_occlusion_plain(stris, sx, sy, hit),
        "K8": SH.shadow_occlusion_lt_plain(stris, sx, sy, hit),
    }
    for name, k in (("K7", res["occ7"]), ("K8", res["occ8"])):
        n = int(((k != plain[name]) & h).sum())
        if n:
            raise AssertionError(f"{name} differs from its plain version at {n} values at hit pixels")
    n78 = int(((res["occ7"] != res["occ8"]) & h).sum())
    log(f"K7, K8: bit-exact against their plain versions over {int(h.sum())} values at hit pixels "
        f"({int((res['occ8'][h] > 0).sum())} nonzero); K7 and K8 differ at {n78} of them")
    # K8 through the PCF5 blend against the frame's K3 factors, where K3's
    # query was valid: a hit pixel in bounds whose base texel lies in the map.
    bx, by = torch.floor(sx - 0.5), torch.floor(sy - 0.5)
    ok = hit & in_bounds & (bx >= 0) & (bx < size) & (by >= 0) & (by < size)
    pcf = SH.pcf5_from_occlusion(res["occ8"], sx, sy, ref)
    diff = (pcf - factor).abs()[ok]
    share = float((diff > 1e-6).float().mean()) if diff.numel() else 0.0
    log(f"pcf5_from_occlusion(K8) against K3 at {diff.numel()} valid pixels: {share:.6f} differ by more than "
        f"1e-6 (max {float(diff.max()) if diff.numel() else 0.0:.3g})")
    if not diff.numel() or share > 0.01:
        raise AssertionError(f"map-free PCF and K3 differ at a share of {share} of the valid pixels")
    pairs = SH.occlusion_pairs(stris, sx, sy, hit)
    texels = SH._base_texels(sx, sy, hit)[1].numel()
    for name in ("rects", "cells"):
        lens = res[name].offsets[1:] - res[name].offsets[:-1]
        segs = int(((lens + SH.OCC_SEG - 1) // SH.OCC_SEG).sum())
        log(f"  {name}: {segs} segments of at most {SH.OCC_SEG} entries over {int((lens > 0).sum())} listed tiles "
            f"of {lens.numel()}; the 4 longest lists {sorted(lens.tolist())[-4:]}")
    rows = []
    for name, lt, lists, occ, pfn in (
        ("shadow_occ", False, res["rects"], res["occ7"], SH.shadow_occlusion_plain),
        ("shadow_occ_lt", True, res["cells"], res["occ8"], SH.shadow_occlusion_lt_plain),
    ):
        bound = _bound(_nbytes(stris.setup, stris.bbox, lists.offsets, lists.ids, sx, sy, hit, occ),
                       pairs * OCC_PAIR_OPS)
        rows.append((name, "rend3_tpu_torch/csrc/shadow_occ.cu",
                     "rend3_tpu/ops/shadow.py:445" if lt else "rend3_tpu/ops/shadow.py:175",
                     lambda lists=lists, lt=lt: SH.occlusion_from_lists(stris, lists, sx, sy, hit, width, height,
                                                                        lt_form=lt),
                     lambda pfn=pfn: pfn(stris, sx, sy, hit), 0.0, bound, None))
    log(f"map-free shadows: {pairs} (base texel, nearby caster) pairs over {texels} distinct base texels of "
        f"{int(hit.sum())} hit pixels at these inputs")
    return counts, rows


def _c1_outputs(args):
    """C1's (gbuf, done, bound, searching) on one peel's captured arguments
    (the sample's G-buffer and done as they were before the test), the
    G-buffer written into a copy."""
    from rend3_tpu_torch.ops import cuda_kernels
    from rend3_tpu_torch.ops import lighting as L

    gc, gbuf, floor, done, materials, textures, active, extras = args
    verdict = L.routine_verdict(gc, extras) if extras else None
    tensors, ints = L.peel_launch_args(gc, gbuf.clone(), floor, done, materials, textures, active, verdict)
    cuda_kernels.call("c1_cutout_peel", *tensors, ints=ints)
    return tensors[1], tensors[4], tensors[5], int(tensors[6])


def _c1_check(label, args):
    """C1 against cutout_peel_step_plain on one peel's captured arguments
    (with a registered cutout routine's verdict where the frame has one):
    gbuf, done, bound and the searching count bit for bit. Returns the
    plain version's outputs and its K4 queries."""
    import torch

    from rend3_tpu_torch.ops import lighting as L

    gc, gbuf, floor, done, materials, textures, active, extras = args
    cap = {}
    want = L.cutout_peel_step_plain(gc, gbuf.clone(), floor, done, materials, textures, active, extras, cap)
    got = _c1_outputs(args)
    same = [torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                        w.view(torch.int32) if w.dtype == torch.float32 else w) for g, w in zip(got[:3], want[:3])]
    log(f"C1 ({label}): {gc.shape[1]}x{gc.shape[2]} pixels, {len(extras)} routines, "
        f"{int((~done & (gc[20] > 0)).sum())} hit and searching, "
        f"{int((want[0] != gbuf).any(0).sum())} replaced, {want[3]} still searching; gbuf / done / bound bit for bit "
        f"{same}, count {got[3]} (chain {want[3]})")
    if not all(same) or got[3] != want[3]:
        raise AssertionError(f"C1 ({label}) differs from its plain version")
    return want, cap.get("bilinear")


def _c1_bound(args, want, queries):
    """C1's bound at one peel (no routine): 18 bytes a pixel (depth, hit,
    floor and done read; done and bound written), 36 more a candidate (the
    9 channels the alpha test reads), 200 a replaced pixel (25 channels
    read and written) and the distinct texels (8 bytes each) of the chain's
    K4 queries, at 3.35 TB/s."""
    import torch

    gc, gbuf, floor, done = args[:4]
    n = done.numel()
    cand = int((~done & (gc[20] > 0) & (gc[0] > floor)).sum())
    replaced = int((want[0] != gbuf).any(0).sum())
    moved = 18 * n + 36 * cand + 200 * replaced
    if queries is not None:
        atlas, bx, by, _fx, _fy, _wt, valid = queries
        aw = atlas.shape[1]
        at = (by.long() * aw + bx.long())[valid]
        moved += 8 * int(torch.unique(torch.cat([at, at + 1, at + aw, at + aw + 1])).numel())
    return _bound(moved, 0)


def _c1_row(args):
    """C1 on the representative frame's first cutout peel: checked, and its
    phase-11 row, timed as its raw launch (the wrapper reads the count on
    the host), on a G-buffer copy it writes the same pixels of at every
    call."""
    from rend3_tpu_torch.ops import cuda_kernels
    from rend3_tpu_torch.ops import lighting as L

    want, queries = _c1_check("representative, first peel", args)
    gc, gbuf, floor, done, materials, textures, active, _extras = args
    bound = _c1_bound(args, want, queries)
    tensors, ints = L.peel_launch_args(gc, gbuf.clone(), floor, done, materials, textures, active)
    scratch = gbuf.clone()
    return ("cutout_alpha", "rend3_tpu_torch/csrc/deferred_shade.cu", "rend3_tpu/ops/lighting.py:203",
            lambda: L.cutout_peel_step(gc, scratch, floor, done, materials, textures, active),
            lambda: L.cutout_peel_step_plain(gc, gbuf, floor, done, materials, textures, active), 0.0, bound,
            None, lambda: cuda_kernels.call("c1_cutout_peel", *tensors, ints=ints))


def phase_kernels(paths, extra_rows=(), timed=True):
    """Each kernel against its plain version on the captured 1080p inputs:
    K1-K3 from the flat frames, K4 and K5 from the textured ones, K1's
    count and bound modes and C1 (the cutout alpha test) from the
    representative ones, K1 at an MSAA offset from the MSAA ones; then the
    rows of `extra_rows` (K6-K8, checked by their phases), all timed.
    `paths` maps each path's name to its (graph, launch counts); a row's
    launches are the sum of its kernel's counts over the paths."""
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

    # K1 at a non-centre MSAA sample offset (the MSAA frames' phase 1).
    m_tris, m_planes, m_binned, m_wp, m_hp, m_sofs = paths["msaa"][0].captured["raster_sample"]
    errm = _k1_check(f"K1 at sample offset {m_sofs}",
                     D.raster_resolve(m_tris, m_planes, m_binned, m_wp, m_hp, sofs=m_sofs).data,
                     D.raster_resolve_plain(m_tris, m_planes, m_binned, m_wp, m_hp, sofs=m_sofs))
    rows.append(("raster_msaa", "rend3_tpu_torch/csrc/raster.cu", "rend3_tpu/ops/deferred.py:505",
                 lambda: D.raster_resolve(m_tris, m_planes, m_binned, m_wp, m_hp, sofs=m_sofs),
                 lambda: D.raster_resolve_plain(m_tris, m_planes, m_binned, m_wp, m_hp, sofs=m_sofs), errm,
                 _k1_bound(m_tris, m_planes, m_binned, m_wp, m_hp), None))

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

    # S1 and S2 on the representative frame's shadow pass: the rows, lists
    # and maps of the plain version; each timed as its device launches
    # alone (S1: the counters' memset and S1; S2: the scan and the fill),
    # with the buffers and totals of a first call.
    if "shadow_front" in rcap and rcap["shadow_front"][2].is_cuda:  # S1 / S2 run on the card only
        rows += _shadow_front_rows(rcap["shadow_front"], paths["representative"][0], timed)
    # V1-V4 on the representative frame's main set: every site's tables
    # against the plain version, then each kernel timed as its device
    # launches alone (V1: count and fill; V2: cull, scan and setup).
    if rcap["view_cull"]["setup"][2].setup.is_cuda:
        rows += _view_front_rows(rcap, paths["representative"][0], timed)

    # D1 on the representative frame's opaque G-buffer (sample 0), its blend
    # pixels checked too.
    from rend3_tpu_torch.ops import lighting as L

    if rcap["deferred_shade"][0].data.is_cuda:
        rows.append(_d1_row(rcap["deferred_shade"], timed))
        _d1_check("representative, blend pixels", rcap["deferred_shade_blend"])
    # C1 on the representative frame's first cutout peel (sample 0); at
    # sample 0 of the MSAA frames and on the feature frame (a registered
    # cutout routine's verdict) checked too.
    if rcap["cutout_peel"][0].is_cuda:
        rows.append(_c1_row(rcap["cutout_peel"]))
        _c1_check("representative at 4 samples, sample 0's first peel", paths["msaa"][0].captured["cutout_peel"])
        fcap = paths["features"][0].captured["cutout_peel"]
        if not fcap[7]:
            raise AssertionError("the feature frame's cutout peel has no registered routine")
        _c1_check("feature city, a registered cutout routine, first peel", fcap)

    # K3: abs <= 1e-6, on the flat frame's shadow queries (D1 takes the same
    # taps; lighting.chain_inputs gives the chain's K3 arguments). The maps
    # are read only around valid queries (12 texels each).
    args = L.chain_inputs(*cap["deferred_shade"])["pcf5"]
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

    # K4: exact or at most 1 ulp, on the textured frame's texture queries
    # (the chain's, as for K3) and on the representative frame's cutout
    # alpha test.
    a4 = L.chain_inputs(*tcap["deferred_shade"])["bilinear"]
    err4 = _k4_check("textures", a4)
    if "bilinear_cutout" in rcap:  # the chain's alpha test (the CPU; on the card C1 took it)
        _k4_check("cutout alpha test", rcap["bilinear_cutout"])
    sky = paths["features"][0].captured["bilinear_sky"]
    _k4_check("skybox", sky)
    if timed:
        n_sky = int(sky[-1].sum())
        b_sky = _bound(_nbytes(*sky[1:]) + 16 * sky[1].numel() + min(_nbytes(sky[0]), n_sky * 4 * 8), n_sky * 40)
        log(f"K4 (skybox, store {tuple(sky[0].shape)}, {n_sky} sky queries): kernel "
            f"{_graph_ms(lambda: S.sample_grid_bilinear(*sky))} ms (device, CUDA graph), call "
            f"{_median_ms(lambda: S.sample_grid_bilinear(*sky), 20)} ms, plain "
            f"{_median_ms(lambda: S.sample_grid_bilinear_plain(*sky), 5)} ms (median); bound {b_sky[0]:.6f} ms "
            f"({b_sky[1]})")
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

    rows += phase_f1(rcap["fma_sites"], tris.setup.device)
    phase_stress(tris.setup.device)
    if tris.setup.is_cuda:
        log_kernel_info()
        if timed:
            from rend3_tpu_torch.ops import cuda_kernels

            q_ctas = (int(bx5.numel()) + 127) // 128
            for blocks, threads in ((1, 32), (q_ctas, 128)):
                ms = _graph_ms(lambda: cuda_kernels.call("launch_floor", ints=(blocks, threads)))
                log(f"launch_floor_ms {ms} (an empty kernel, {blocks} CTAs of {threads} threads; device, graph of "
                    f"{DEVICE_CALLS} calls)")

    kernels = []
    for row in rows + list(extra_rows):
        name, src, repl, kfn, pfn, err, (bound_ms, bound_by), libfn = row[:8]
        # The function timed on the device: the wrapper, or (row[8]) its raw
        # launch where the wrapper reads the device on the host.
        method = "graph" if len(row) == 8 else "graph of the raw launch"
        ms = _graph_ms(row[8] if len(row) > 8 else kfn) if timed else None
        call_ms = _median_ms(kfn, 20) if timed else None
        plain_ms = _median_ms(pfn, 5) if timed else None
        library_ms = _graph_ms(libfn) if timed and libfn is not None else None
        launches = sum(counts[name] for _g, counts in paths.values())
        log(f"{name}: kernel {ms} ms (device, {method} of {DEVICE_CALLS} calls), call {call_ms} ms (host included, "
            f"median), plain {plain_ms} ms (median), library {library_ms} ms (device, graph); "
            f"bound {bound_ms:.6f} ms ({bound_by}); {launches} launches on the measured paths")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "ms_method": f"{method} of {DEVICE_CALLS} calls", "call_ms": call_ms,
        })
    if timed:
        from rend3_tpu_torch import testing

        # Launches per main-path frame: the representative path's three counted frames.
        frame = {k: v / 3 for k, v in paths["representative"][1].items()}
        order = testing.redesign_order(kernels, frame)
        log("rule 2's order of the kernels still to redesign: " + "; ".join(
            f"{i + 1}. {k} ({name}: {why})" for i, (k, name, why) in enumerate(order)))
        if not order:
            log("rule 2 is done: every kernel has been redesigned for this card, or runs at half its bound or better "
                "and no library call beats it")
    return kernels


# f32 operations S1 spends on a (map, triangle) (the clip transform's 12
# dot3 + add, the near-plane tests) and on a survivor (the screen tests,
# the edges, the depth plane), an fma counting two; the clipping of the
# rare crossing triangles is left out.
S1_OPS_PER_TRI = 12 * 6 + 9
S1_OPS_PER_ROW = 160


def _shadow_front_rows(args, graph, timed):
    """S1 / S2 held to their plain version on `args` (a shadow pass's
    captured arguments), and their phase-11 rows; logs the whole pass's
    host time, S1 / S2 against the PyTorch chain."""
    import torch

    from rend3_tpu_torch.ops import deferred as D
    from rend3_tpu_torch.ops import shadow_front as SF
    from rend3_tpu_torch.testing import shadow_front_chain

    got, want = _shadow_front_check("representative", args)
    for g, w in zip(got, want):
        k = D.raster_depth(g.tris, g.binned, g.width, g.height)
        if not torch.equal(k, D.raster_depth(w.tris, w.binned, w.width, w.height)):
            raise AssertionError("K2 on S1 / S2's tables differs from K2 on the plain version's")
    sizes, cw, mvp, vis, tri_pos, tri_obj = args
    bufs = SF.ShadowFrontBuffers()
    SF.shadow_front(bufs, *args)
    L = len(sizes)
    totals = bufs.totals.tolist()
    surv, pairs = totals[:L], totals[L:]
    pair_base = [sum(pairs[:m]) for m in range(L)]
    T, V, P = tri_pos.shape[0], sum(surv), sum(pairs)
    n_tiles = sum(SF._n_tiles(s) for s in sizes)
    # Bytes: each input once (the corners, object ids, the MVPs and
    # visibility the maps read), each output once.
    b1 = _bound(_nbytes(tri_pos, tri_obj, mvp[:L], vis[:L]) + V * (64 + 16 + 8 + 1) + 4 * (L + n_tiles),
                L * T * S1_OPS_PER_TRI + V * S1_OPS_PER_ROW)
    b2 = _bound(4 * (L + n_tiles) + 16 * V + 4 * (n_tiles + L) + 4 * n_tiles + 4 * 2 * L + 4 * P, 0)

    def s1():
        SF.launch_setup(bufs, sizes, cw, mvp, vis, tri_pos, tri_obj)

    def s2():
        SF.launch_scan(bufs, sizes)
        SF.launch_fill(bufs, sizes, surv, pair_base)

    if timed:
        inputs = graph._last_shadow_call[1]
        log(f"shadow pass (representative, maps {sizes}, {T} triangles): S1 / S2 and K2 "
            f"{_median_ms(lambda: graph._shadow_pass(*inputs), 20)} ms, the PyTorch chain and K2 "
            f"{_median_ms(lambda: [D.raster_depth(*f) for f in shadow_front_chain(*inputs)], 20)} ms (host "
            f"included, median); S1 / S2 alone {_median_ms(lambda: SF.shadow_front(bufs, *args), 20)} ms")
    src = "rend3_tpu_torch/csrc/shadow_front.cu"
    repl = "none (XLA ops: rend3_tpu/routine/base.py:554-580)"
    return [
        ("shadow_setup", src, repl, s1, lambda: SF.shadow_front_plain(*args), 0.0, b1, None),
        ("shadow_tiles", src, repl, s2, lambda: SF.shadow_front_plain(*args), 0.0, b2, None),
    ]


# f32 operations V1 spends on a triangle (the clip transform's 12 dot3 +
# add, the near-plane tests), V2 on a clipped row (the screen tests) and on
# a survivor (the edges, the depth plane), V3 on a survivor (17 channels
# at 3 corners, 18 planes of 3 coefficients, the normal and tangent
# transforms), an fma counting two; the clipping of the crossing
# triangles is left out.
V1_OPS_PER_TRI = 12 * 6 + 9
V2_OPS_PER_ROW = 40
V2_OPS_PER_SURVIVOR = 120
V3_OPS_PER_SURVIVOR = 17 * 3 * 5 + 18 * 3 * 7 + 2 * 3 * (3 * 6 + 9 + 5)


def _view_front_rows(rcap, graph, timed):
    """V1-V4 held to their plain version at every call site of the
    representative frame (rcap: its captures), and their phase-11 rows on
    its main set; logs the front end's host time on the main set, V1-V4
    against the PyTorch chain."""
    import torch

    from rend3_tpu_torch.ops import deferred as D
    from rend3_tpu_torch.ops import geometry as G
    from rend3_tpu_torch.ops import transform as TR
    from rend3_tpu_torch.ops import view_front as VF

    _view_front_check("representative", rcap)
    args, table = rcap["view_clip"]["main"]
    (clip_rows, valid, width, height), kw, tris = rcap["view_cull"]["setup"]
    pargs, (wp, hp, y0), _t, planes, binned = rcap["view_planes"]["planes"]
    T, Tc, V, P = args[2].shape[0], clip_rows.shape[0], tris.count, int(binned.ids.numel())
    culled = VF.cull(clip_rows, valid, width, height, wp=wp, hp=hp, y0=y0, **kw)
    blk = torch.empty(T // VF.BLOCK + 2, dtype=torch.int32, device=clip_rows.device)
    n_cross = (Tc - T) // 3
    out = VF.clip(*args)
    n_objects = args[4].shape[0]
    # Bytes: each input once (corners through the position arena, object
    # ids and matrices), each output once.
    b1 = _bound(T * (12 + 4 + 36) + _nbytes(args[3], args[4], args[5]) + Tc * (48 + 36 + 8 + 1),
                T * V1_OPS_PER_TRI)
    b2 = _bound(Tc * (48 + 1) + V * (64 + 16 + 8 + 1) + _nbytes(culled.offsets),
                Tc * V2_OPS_PER_ROW + V * V2_OPS_PER_SURVIVOR)
    b3 = _bound(V * (8 + 1 + 48 + 36 + 8 + 12 + 4 + 24 + 64 + 3 * 17 * 4 + 4) + _nbytes(planes),
                V * V3_OPS_PER_SURVIVOR)
    b4 = _bound(V * 16 + _nbytes(binned.offsets, binned.ids), 0)
    log(f"view front end (representative main set, {T} triangles, {n_cross} crossing, {V} survivors, {P} list "
        f"entries, {n_objects} objects)")
    if timed:
        def chain():
            c = TR.clip_triangles(TR.gather_tri_clip(args[0], args[1], args[2], args[3][:, 0], args[4],
                                                     contract=True), args[5][args[2].long()], contract=True)
            t = G.cull_and_setup(c.clip, valid, width, height, contract=True, **kw)
            D.attribute_planes(t, c.clip, c.bary, c.orig, *pargs[1:], contract=True)
            G.bin_triangles(t, wp, hp, tile_h=D.DTILE_H, tile_w=D.DTILE_W, y0=y0)

        def card():
            c = VF.clip(*args)
            k = VF.cull(c.clip, valid, width, height, wp=wp, hp=hp, y0=y0, **kw)
            VF.planes(k, c, *pargs[1:])
            VF.tiles(k)

        log(f"view front end (representative main set): V1-V4 {_median_ms(card, 20)} ms, the PyTorch chain "
            f"{_median_ms(chain, 20)} ms (host included, median)")
    src = "rend3_tpu_torch/csrc/view_front.cu"
    return [
        ("view_clip", src, "none (XLA ops: rend3_tpu/ops/transform.py gather_tri_clip, clip_triangles)",
         lambda: VF.clip(*args), lambda: VF.clip_plain(*args), 0.0, b1, None,
         lambda: (VF.launch_clip_count(args, blk), VF.launch_clip_fill(args, blk, n_cross, out))),
        ("view_setup", src, "none (XLA ops: rend3_tpu/ops/geometry.py cull_and_setup)",
         lambda: VF.cull(clip_rows, valid, width, height, wp=wp, hp=hp, y0=y0, **kw),
         lambda: VF.cull_plain(clip_rows, valid, width, height, **kw), 0.0, b2, None,
         lambda: (VF.launch_cull(culled), VF.launch_setup(culled))),
        ("view_planes", src, "none (XLA ops: rend3_tpu/ops/deferred.py attribute_planes)",
         lambda: VF.planes(culled, table, *pargs[1:]), lambda: VF.planes_plain(tris, *pargs), 0.0, b3, None),
        ("view_tiles", src, "none (XLA ops: rend3_tpu/ops/geometry.py bin_triangles)",
         lambda: VF.tiles(culled), lambda: VF.tiles_plain(tris, wp, hp, y0), 0.0, b4, None),
    ]


def _view_front_check(label, cap):
    """The tables V1-V4 built at each call site of a frame on the card
    (cap: its captures) against the plain version on the site's inputs:
    bit for bit, in order."""
    import torch

    from rend3_tpu_torch.ops import view_front as VF

    def same(a, b):
        a, b = (t.view(torch.int32) if t.dtype == torch.float32 else t for t in (a, b))
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)

    sites = []
    for site, (args, table) in cap.get("view_clip", {}).items():
        if not all(same(a, b) for a, b in zip(table, VF.clip_plain(*args))):
            raise AssertionError(f"{label} V1 ({site}) differs from the plain version")
    for name, ((clip_rows, valid, width, height), kw, tris) in cap.get("view_cull", {}).items():
        if not all(same(a, b) for a, b in zip(tris, VF.cull_plain(clip_rows, valid, width, height, **kw))):
            raise AssertionError(f"{label} V2 ({name}) differs from the plain version")
        sites.append(f"{name} {tris.count}")
    for name, (args, (wp, hp, y0), tris, planes, binned) in cap.get("view_planes", {}).items():
        if not same(planes, VF.planes_plain(tris, *args)):
            raise AssertionError(f"{label} V3 ({name}) differs from the plain version")
        if not all(same(a, b) for a, b in zip(binned, VF.tiles_plain(tris, wp, hp, y0))):
            raise AssertionError(f"{label} V4 ({name}) differs from the plain version")
    log(f"{label} V1-V4: every table equals the plain version, in order (survivors: {', '.join(sites)})")


F1_SOURCE = "rend3_tpu_torch/csrc/fma.cu"
# No pallas_call emits an fma: the lines of the JAX frame whose sums
# XLA:CPU contracts into each form (the texture query, the clip transform,
# the screen-space area).
F1_REPLACES = {"fma": "rend3_tpu/ops/texture.py:518", "fma_dot3": "rend3_tpu/ops/transform.py:96",
               "fma_ab_minus_cd": "rend3_tpu/ops/geometry.py:121"}
# Each form's timed row: the frame's largest call from this file of the
# package (texture.texture_queries, the chain's texture and alpha-test
# queries; transform.gather_tri_clip; geometry's setup).
F1_TIMED_SITE = {"fma": "ops/texture.py", "fma_dot3": "ops/transform.py", "fma_ab_minus_cd": "ops/geometry.py"}
# f32 operations per output element (an fma counts two).
F1_OPS = {"fma": 2, "fma_dot3": 5, "fma_ab_minus_cd": 3}
F1_STRESS_ROWS = 1 << 24
# Rows a form is timed at where the frames make no call from its file.
F1_UNSITED_ROWS = 1 << 20


def _f1_same(label, k, p):
    """F1 against its plain version: bit for bit as int32 patterns, NaN
    positions equal (payloads free)."""
    import torch

    nan = torch.isnan(p)
    bad = (torch.isnan(k) != nan) | ((k.view(torch.int32) != p.view(torch.int32)) & ~nan)
    if bool(bad.any()):
        raise AssertionError(f"{label}: F1 differs from its plain version at {int(bad.sum())} of {k.numel()} values")


def _distinct_bytes(t):
    """Bytes of the distinct float32 elements of a tensor (a broadcast
    dimension, stride 0, holds one)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride != 0 else 1
    return 4 * n


def _f1_functions():
    """({form: its public function}, {form: its plain version}) of F1's forms."""
    from rend3_tpu_torch.ops import fp

    return ({"fma": fp.fma32, "fma_dot3": fp.dot3, "fma_ab_minus_cd": fp.ab_minus_cd},
            {"fma": fp.fma32_plain, "fma_dot3": fp.dot3_plain, "fma_ab_minus_cd": fp.ab_minus_cd_plain})


def _check_f1_sites(label, sites):
    """F1 against its plain version, bit for bit with NaN positions equal,
    on the inputs fp.capture recorded at each call site (`sites`); returns
    the forms checked."""
    public, plain = _f1_functions()
    for (form, site), xs in sorted(sites.items()):
        k = public[form](*xs)
        _f1_same(f"{label} {form} at {site}", k, plain[form](*xs))
        log(f"{label} {form} at {site}: {tuple(k.shape)} bit for bit, inputs {[tuple(x.shape) for x in xs]}")
    return {form for form, _site in sites}


def phase_f1(sites, device="cuda"):
    """F1 (ops/fp.py fma32, dot3, ab_minus_cd; csrc/fma.cu) against its
    plain versions, the float64 emulation, bit for bit with NaN positions
    equal: in each form on testing.fma_stress_case (2^24 rows on the card),
    where on the card one call must be one device kernel that makes no
    float64 tensor (testing.f1_call_trace); then at every call site of the
    representative frames (`sites`: fp.capture's record, the largest call
    of each form from each site). Returns each form's kernel row, timed at
    its largest site in F1_TIMED_SITE's file, with torch.addcmul(c, a, b)
    as the fma row's library yardstick (its bits compared, not required)."""
    import torch

    from rend3_tpu_torch import testing
    from rend3_tpu_torch.ops import fp

    public, plain = _f1_functions()
    cuda = torch.device(device).type == "cuda"
    n = F1_STRESS_ROWS if cuda else 4096
    traced = []
    for form in F1_KERNELS:
        xs = [torch.from_numpy(x).to(device) for x in testing.fma_stress_case(form, n, seed=11)]
        k = public[form](*xs)
        _f1_same(f"F1 {form} (stress)", k, plain[form](*xs))
        fin = torch.isfinite(k)
        log(f"F1 {form}: bit for bit against its plain version on testing.fma_stress_case, {n} rows "
            f"({int(torch.isnan(k).sum())} NaN, {int(torch.isinf(k).sum())} inf, "
            f"{int((fin & (k != 0) & (k.abs() < 2.0**-126)).sum())} subnormal, {int((k == 0).sum())} zero results)")
        traced.append((public[form], [x[:4096].clone() for x in xs]))
    if cuda:
        # Each form's call is one device kernel, its own instance, and makes no float64 tensor.
        kernels, dtypes = testing.f1_call_trace(traced)
        want = [f"_kernel<{fp._FORMS[form]}" for form in F1_KERNELS]
        if len(kernels) != len(want) or any(w not in k for w, k in zip(want, kernels)) or any(
                torch.float64 in d for d in dtypes):
            raise AssertionError(f"F1: the three calls launched {kernels} and made tensors of {dtypes}")
        for form, kernel, d in zip(F1_KERNELS, kernels, dtypes):
            log(f"F1 {form}: one call is one device kernel ({kernel[:90]}) and makes tensors of "
                f"{sorted({str(t) for t in d})} only")
    _check_f1_sites("F1", sites)
    rows = []
    for form in F1_KERNELS:
        cands = [(site, xs) for (f, site), xs in sites.items() if f == form and site.startswith(F1_TIMED_SITE[form])]
        if cands:
            site, xs = max(cands, key=lambda c: torch.broadcast_shapes(*(x.shape for x in c[1])).numel())
        else:  # no call from that file on the card's frames: the stress input's first rows
            site = f"testing.fma_stress_case[:{F1_UNSITED_ROWS}] (no call from {F1_TIMED_SITE[form]} on these frames)"
            xs = [torch.from_numpy(x).to(device) for x in testing.fma_stress_case(form, F1_UNSITED_ROWS, seed=11)]
        out = public[form](*xs)
        bytes_moved = sum(_distinct_bytes(x) for x in xs) + _nbytes(out)
        libfn = None
        if form == "fma":
            a, b, c = xs
            lib = torch.addcmul(c, a, b)
            nan = torch.isnan(out)
            diff = int(((lib.view(torch.int32) != out.view(torch.int32)) & ~nan).sum())
            log(f"F1 fma's library yardstick torch.addcmul(c, a, b) at {site}: its bits "
                f"{'equal' if diff == 0 else f'differ at {diff} of {out.numel()} values from'} F1's "
                f"(timed, not used: no PyTorch op promises a fused fma)")
            libfn = lambda a=a, b=b, c=c: torch.addcmul(c, a, b)  # noqa: E731
        log(f"F1 {form} row: timed at {site}, output {tuple(out.shape)}, {bytes_moved} distinct bytes read and "
            f"written")
        rows.append((form, F1_SOURCE, F1_REPLACES[form], lambda f=form, xs=xs: public[f](*xs),
                     lambda f=form, xs=xs: plain[f](*xs), 0.0, _bound(bytes_moved, out.numel() * F1_OPS[form]),
                     libfn))
    return rows


def phase_stress(device="cuda"):
    """K1 in every mode, K2 and K6 against their plain versions on
    testing.raster_stress_case: depth, hit, material and counts bit-exact,
    the other channels within 1 ulp; K2, and K6's ids and depth at 1 and 4
    samples, bit-exact. K7 and K8 on testing.shadow_stress_case: bit-exact
    at hit pixels. Then phase_probe_stress."""
    import torch

    from rend3_tpu_torch import testing
    from rend3_tpu_torch.ops import deferred as D
    from rend3_tpu_torch.ops import raster as R
    from rend3_tpu_torch.ops import raster_binned as RB
    from rend3_tpu_torch.ops import shadow as SH

    c = testing.raster_stress_case(device)
    lens = (c["binned"].offsets[1:] - c["binned"].offsets[:-1]).tolist()
    log(f"stress input: {c['tris'].count} triangles, tile lists {lens}")
    args = (c["tris"], c["planes"], c["binned"], c["width"], c["height"])
    for label, kw in (
        ("opaque", {}), ("MSAA offset", {"sofs": R.MSAA4_OFFSETS[1]}), ("bound", {"bound": c["bound"]}),
        ("count", {"count_floor": c["floor"]}), ("strict count", {"count_floor": c["floor"], "count_strict": True}),
        ("bound + strict count", {"bound": c["bound"], "count_floor": c["floor"], "count_strict": True}),
    ):
        k, p = D.raster_resolve(*args, **kw), D.raster_resolve_plain(*args, **kw)
        if "count_floor" in kw:
            _k1_check(f"K1 stress, {label}", k[0].data, p[0], k[1], p[1])
        else:
            _k1_check(f"K1 stress, {label}", k.data, p)
    for sofs in ((0.5, 0.5), R.MSAA4_OFFSETS[2]):
        k = D.raster_depth(*args[:1], *args[2:], sofs=sofs)
        if not torch.equal(k, D.raster_depth_plain(*args[:1], *args[2:], sofs=sofs)):
            raise AssertionError(f"K2 differs from its plain version on the stress input at offset {sofs}")
        log(f"K2 stress at offset {sofs}: bit-exact over {k.numel()} texels, {int((k > 0).sum())} covered")
    for samples, offs in ((1, R.CENTER_OFFSET), (4, R.MSAA4_OFFSETS)):
        vt, vb = c["vis"][samples]
        k = RB.rasterize_binned(vt, vb, c["width"], c["height"], offs)
        p = RB.rasterize_binned_plain(vt, vb, c["width"], c["height"], offs)
        if not (torch.equal(k.tri, p.tri) and torch.equal(k.depth, p.depth)):
            raise AssertionError(f"K6 differs from its plain version on the stress input at {samples} samples")
        lens = (vb.offsets[1:] - vb.offsets[:-1]).tolist()
        log(f"K6 stress at {samples} samples: ids and depth bit-exact over {k.tri.numel()} samples, "
            f"{int((k.tri >= 0).sum())} covered; 8x128 lists max {max(lens)}, {sum(lens)} entries")
    s = testing.shadow_stress_case(device)
    h = s["hit"][None].expand(SH.N_OFF, -1, -1)
    args = (s["tris"], s["sx"], s["sy"], s["hit"])
    for name, lists, lt, plain in (("K7", s["rects"], False, SH.shadow_occlusion_plain),
                                   ("K8", s["cells"], True, SH.shadow_occlusion_lt_plain)):
        k = SH.occlusion_from_lists(s["tris"], lists, *args[1:], s["width"], s["height"], lt_form=lt)
        n = int(((k != plain(*args)) & h).sum())
        if n:
            raise AssertionError(f"{name} differs from its plain version on the shadow stress input at {n} values")
        lens = (lists.offsets[1:] - lists.offsets[:-1]).tolist()
        log(f"{name} stress: bit-exact at {int(h.sum())} values at hit pixels ({int((k[h] > 0).sum())} nonzero); "
            f"tile lists {lens}")
    phase_probe_stress(device)


def phase_probe_stress(device="cuda"):
    """P3 against its plain version on testing.probe_lerp_stress_case (a
    tile list longer than the kernel's compaction round, an empty one, init
    steps mid-list or none, most pixels owned), in the x-lerp and the
    128-lane-sum modes; P2's reduce at a width its 32-column CTAs do not
    divide, written and accumulated: bit for bit, NaN positions too."""
    import numpy as np
    import torch

    from rend3_tpu_torch import testing
    from rend3_tpu_torch.ops import probe_bf16 as pb

    for label, kw in (("x-lerp, bf16, init steps, NaN output", {}),
                      ("x-lerp, f32, no init step, zero output", dict(bf16=False, init_steps=False, init="zero")),
                      ("128-lane sum, bf16, no init step, zero output", dict(xlerp=False, init_steps=False,
                                                                             init="zero"))):
        a = testing.probe_lerp_stress_case(device, **kw)
        k = pb.probe_lerp(**a)
        if not _same_with_nan(k, pb.probe_lerp_plain(**a)):
            raise AssertionError(f"P3 differs from its plain version on the stress input ({label})")
        log(f"P3 stress ({label}): bit-exact over {k.numel()} values, {int((~torch.isnan(k)).sum())} not NaN; "
            f"steps per tile {torch.bincount(a['st'], minlength=4).tolist()}")
    rng = np.random.RandomState(5)
    n = 1000
    r2, x = (torch.from_numpy(rng.rand(rows, n).astype(np.float32)).to(device) for rows in (512, 128))
    out = torch.full((pb.OUT_ROWS, n), float("nan"), device=device)
    out[:2] = torch.from_numpy(rng.rand(2, n).astype(np.float32)).to(device)
    for acc in (False, True):
        k = pb.probe_reduce(r2, x, out, accumulate=acc)
        if not _same_with_nan(k, pb.probe_reduce_plain(r2, x, out, accumulate=acc)):
            raise AssertionError(f"P2's reduce differs from its plain version at n = {n} (accumulate={acc})")
    log(f"P2 reduce at n = {n}: bit-exact, written and accumulated")


def log_kernel_info():
    """Registers, spills, shared memory and resident CTAs per SM (CUDA
    runtime) of each instance of K1 / K2's tiles_kernel, K6's vis_kernel,
    K7 / K8's occ_kernel, of P1's dot_kernel at the probes' K = 72, of
    K5's gather_kernel for the four Hi-Z taps, of P2's reduce_kernel, of
    P3's lerp_kernel (x-lerp and 128-lane sum), of F1's nine instances,
    of S1 / S2's three kernels, of V1-V4's seven, of D1 and of C1."""
    from rend3_tpu_torch.ops import cuda_kernels

    rows = [(f"{'vis' if name.startswith('K6') else 'tiles'}_kernel {name}", "raster_kernel_info", (i,))
            for i, name in enumerate(cuda_kernels.RASTER_INSTANCES)]
    rows += [(f"occ_kernel {name}", "occ_kernel_info", (i,)) for i, name in enumerate(cuda_kernels.OCC_INSTANCES)]
    rows += [(f"P1 dot_kernel {name}", "p1_kernel_info", (i, 72)) for i, name in enumerate(cuda_kernels.P1_INSTANCES)]
    rows.append(("K5 gather_kernel, 4 taps", "k5_kernel_info", (4,)))
    rows += [(name, "p23_kernel_info", (i,)) for i, name in enumerate(cuda_kernels.P23_INSTANCES)]
    rows += [(name, "f1_kernel_info", (i,)) for i, name in enumerate(cuda_kernels.F1_INSTANCES)]
    rows += [(name, "shadow_front_kernel_info", (i,)) for i, name in enumerate(cuda_kernels.SHADOW_FRONT_INSTANCES)]
    rows += [(name, "view_front_kernel_info", (i,)) for i, name in enumerate(cuda_kernels.VIEW_FRONT_INSTANCES)]
    rows += [(name, "d1_kernel_info", (i,)) for i, name in enumerate(cuda_kernels.D1_INSTANCES)]
    rows += [(name, "c1_kernel_info", (i,)) for i, name in enumerate(cuda_kernels.C1_INSTANCES)]
    for label, fn, args in rows:
        info = cuda_kernels.kernel_info(fn, *args)
        log(f"{label}: {info['registers']} registers, {info['local_bytes']} local (spill) bytes, "
            f"{info['smem']} bytes of static shared memory, {info['ctas_per_sm']} resident CTAs per SM of "
            f"{info['sms']} SMs")


def _probe_err(label, kfn, pfn):
    """Max abs difference of a P-kernel and its plain version, read from
    values: NaN positions must agree and some value must not be NaN."""
    import torch

    k, p = kfn(), pfn()
    nan = torch.isnan(k)
    if not torch.equal(nan, torch.isnan(p)) or bool(nan.all()):
        raise AssertionError(f"{label}: NaN positions differ from the plain version, or no value is not NaN")
    err = float((k[~nan] - p[~nan]).abs().max())
    log(f"{label}: max abs err {err} against the plain version over {int((~nan).sum())} values")
    if err != 0.0:
        raise AssertionError(f"{label} differs from its plain version by {err}")
    return err


def raw_launch(name, tensors, ints, out_index, pkg="rend3_tpu_torch"):
    """A kernel's launch without its wrapper (P3's wrapper checks its cells
    on the host, which reads the device, so no CUDA graph can capture it):
    a function that launches kernel `name` through package `pkg`'s
    cuda_kernels on a copy of tensors[out_index] (made once here, so each
    call updates it again) and returns the copy."""
    import importlib

    ck = importlib.import_module(f"{pkg}.ops.cuda_kernels")
    ts = list(tensors)
    res = ts[out_index] = ts[out_index].clone()

    def launch():
        ck.call(name, *ts, ints=ints)
        return res

    return launch


def lerp_needs(t, f, coords, st, sc, sf, out, *, mode, npb, gx, lt, hs, ws):
    """(bytes, operations) that P3's cell-mode x-lerp needs on this input:
    the texels its owned (step, pixel) pairs read (rows ry, ry + 1 by lanes
    rx, rx + 1 of the step's cell, 4 channels, each distinct texel once);
    coords where a step selects the pixel and f where one owns it; the step
    list; rows 0-3 of `out` read where no init step hit the tile, written
    everywhere, rows 4-7 written where one did. Steps before their tile's
    last init step add nothing that outlives it and are left out.
    Operations: per owned pair the y-weights (6) and per channel two
    two-hot columns (a product and an fma each) and the x-lerp (5); per
    selected pair not owned, its 4 adds of +0."""
    import torch

    from rend3_tpu_torch.ops import probe_bf16 as pb

    if mode & pb.LERP_GATE or not (mode & pb.LERP_YCELL and mode & pb.LERP_XLERP):
        raise ValueError("lerp_needs counts the cell-mode x-lerp only")
    nT, _three, npx = f.shape
    S = st.shape[0]
    T, cell, fl = st.long(), sc.long(), sf.long()
    idx = torch.arange(S, device=st.device)
    init = ((fl >> 4) & 1).bool() if mode & pb.LERP_INIT else torch.zeros_like(idx, dtype=torch.bool)
    last = torch.full((nT,), -1, dtype=torch.long, device=st.device)
    last = last.scatter_reduce(0, T[init], idx[init], "amax")
    band = torch.arange(npx, device=st.device) // npb
    sel = ((fl[:, None] >> band[None]) & 1).bool() & (idx >= last[T])[:, None]  # (S, npx)
    bx, by = coords[T, 0].long(), coords[T, 1].long()
    cy = cell // gx
    rx, ry = bx - ((cell - cy * gx) * lt)[:, None], by - (cy * lt)[:, None]
    own = (sel & (rx >= 0) & (rx < lt) & (ry >= 0) & (ry < lt)
           & (bx >= 0) & (bx + 1 < ws) & (by >= 0) & (by + 1 < hs))
    used = torch.zeros(t.shape[0], t.shape[1], pb.LANES, dtype=torch.bool, device=st.device)
    oc, oy, ox = cell[:, None].expand_as(own)[own], ry[own], rx[own]
    for dy in (0, 1):
        for dx in (0, 1):
            used[oc, oy + dy, ox + dx] = True
    tile_sel, tile_own = (torch.zeros(nT, npx, dtype=torch.int32, device=st.device).index_add_(0, T, m.int()) > 0
                          for m in (sel, own))
    hit = int((last >= 0).sum())
    row = npx * out.element_size()
    bytes_moved = (int(used.sum()) * pb.CHANNELS * t.element_size()
                   + int(tile_sel.sum()) * 2 * coords.element_size() + int(tile_own.sum()) * 3 * f.element_size()
                   + _nbytes(st, sc, sf) + pb.CHANNELS * row * ((nT - hit) + nT + hit))
    n_own = int(own.sum())
    ops = n_own * (6 + pb.CHANNELS * (2 * 3 + 5)) + (int(sel.sum()) - n_own) * pb.CHANNELS
    return bytes_moved, ops


def probe_rows(runs):
    """Kernel rows of P1-P3 (probe_dot on P1's f32 variant, probe_reduce on
    P2 v2's inputs, probe_lerp on P3's full bf16 variant, both on a
    zero-initialised output): each kernel alone, its plain version, its
    error read from values, bound and library call, and for P3 the raw
    launch its device time is taken from."""
    import torch

    from rend3_tpu_torch.ops import probe_bf16 as pb

    dot = runs["probe_bf16_dot"][0]
    a, b = dot.args["a"], dot.args["b"]
    K, M, N = a.shape[0], a.shape[1], b.shape[1]
    fns = (lambda: pb.probe_dot(a, b, bf16=False), lambda: pb.probe_dot_plain(a, b, bf16=False))
    rows = [("probe_dot", "rend3_tpu_torch/csrc/probe_bf16.cu", "tools/probe_bf16_dot.py:22",
             *fns, _probe_err("probe_dot", *fns),
             _bound(4 * (K * M + K * N + M * N), 2 * K * M * N), lambda: torch.matmul(a.T, b))]

    v2 = runs["probe_bf16_kernel"][1]
    t, y, x = (v2.args[k] for k in ("t", "y", "x"))
    out = torch.zeros_like(v2.args["out"])
    r2 = pb.probe_dot(t, y, bf16=True)
    n = r2.shape[1]
    fns = (lambda: pb.probe_reduce(r2, x, out, accumulate=True),
           lambda: pb.probe_reduce_plain(r2, x, out, accumulate=True))
    rows.append(("probe_reduce", "rend3_tpu_torch/csrc/probe_bf16.cu", "tools/probe_bf16_kernel.py:44",
                 *fns, _probe_err("probe_reduce", *fns),
                 _bound(_nbytes(r2, x) + 2 * 4 * 4 * n, 2 * r2.shape[0] * n),
                 lambda: torch.einsum("jp,cjp->cp", x, r2.view(4, 128, n))))

    real = runs["probe_bf16_real"][1]
    ra = dict(real.args)
    kw = {k: ra.pop(k) for k in ("mode", "npb", "gx", "lt", "hs", "ws")}
    args = (ra["t"], ra["f"], ra["coords"], ra["st"], ra["sc"], ra["sf"], torch.zeros_like(ra["out"]))
    bytes_moved, ops = lerp_needs(*args, **kw)
    fns = (lambda: pb.probe_lerp(*args, **kw), lambda: pb.probe_lerp_plain(*args, **kw))
    rows.append(("probe_lerp", "rend3_tpu_torch/csrc/probe_bf16.cu", "tools/probe_bf16_real.py:22",
                 *fns, _probe_err("probe_lerp", *fns), _bound(bytes_moved, ops), None,
                 raw_launch("p3_probe_lerp", *pb.lerp_launch_args(*args, **kw), 6)))
    log(f"P3 timing inputs: {len(ra['sf'])} steps; {bytes_moved} bytes and {ops} operations needed")
    return rows


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


def msaa_triangle(runner):
    """The scene of tests/test_msaa.py's 4-sample triangle."""
    import numpy as np

    from rend3_tpu_torch.types import Camera, Handedness, MeshBuilder, Object, RawProjection, StaticMeshKind

    mesh = MeshBuilder(
        np.array([[0.5, -0.5, 0.0], [-0.5, -0.5, 0.0], [0.0, 0.5, 0.0]], np.float32), Handedness.LEFT
    ).build()
    mesh_hdl = runner.add_mesh(mesh)
    mat = runner.add_unlit_material([0.25, 0.5, 0.75, 1.0])
    obj = runner.add_object(Object(mesh_kind=StaticMeshKind(mesh_hdl), material=mat))
    runner.set_camera_data(Camera(projection=RawProjection(np.eye(4)), view=np.eye(4)))
    return [mesh_hdl, mat, obj]


def skinned_scene(runner):
    """scenes.skinned_columns, then a new pose (rendered by the caller)."""
    from rend3_tpu_torch import scenes

    keep, skeletons = scenes.skinned_columns(runner)
    scenes.pose_columns(runner, skeletons, 0.8)
    return keep


def registry_scene(runner):
    """tests/test_routine_registry.py:55-71's scene with the unlit routine."""
    from rend3_tpu_torch import scenes
    from rend3_tpu_torch.routine.registry import unlit_routine

    flat = scenes.flat_material_class("FlatMaterial")
    runner.base_graph.register_routine(unlit_routine(flat))
    return scenes.registry_scene(runner, flat)


def phase_parity(device="cuda"):
    import numpy as np
    import torch

    from rend3_tpu_torch import scenes
    from rend3_tpu_torch.routine.base import FrameRenderTarget
    from rend3_tpu_torch.testing import FrameRenderSettings, TestRunner

    for name, build, size, samples in (
        ("shadow", shadow_scene, 256, 1),
        ("textured planes", scenes.textured_planes, 256, 1),
        ("stacked cutout", scenes.stacked_cutout, 256, 1),
        ("glass stack", scenes.glass_stack, 256, 1),
        ("msaa triangle", msaa_triangle, 64, 4),
        ("skybox", scenes.skybox_cube, 64, 4),
        ("skinned columns", skinned_scene, 64, 1),
        ("routine registry", registry_scene, 128, 1),
    ):
        imgs, maps = [], []
        for dev in (device, "cpu"):
            runner = TestRunner(device=dev)
            keep = build(runner)
            if build is scenes.skybox_cube:
                runner.renderer.swap_instruction_buffers()
                imgs.append(runner.base_graph.render_frame(
                    runner.renderer.evaluate_instructions(), FrameRenderTarget(size, size, samples),
                    skybox_slot=keep[-1].idx,
                ))
            else:
                imgs.append(runner.render_frame(FrameRenderSettings(size=size, samples=samples)))
            cache = runner.base_graph._shadow_cache
            maps.append([m.cpu() for m in cache[1][0]] if cache is not None else [])
            del keep
        diff = int(np.abs(imgs[0].astype(np.int32) - imgs[1].astype(np.int32)).max())
        log(f"parity: {name} scene {size}x{size} at {samples} sample(s), {device} vs cpu max u8 diff {diff}; "
            f"{len(maps[0])} shadow map(s) {[tuple(m.shape) for m in maps[0]]}")
        if diff > 1:
            raise AssertionError(f"card and CPU renders of the {name} scene differ by {diff}")
        # The maps are where near-ties show: card and CPU bit for bit.
        if len(maps[0]) != len(maps[1]) or any(
                not torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(*maps)):
            n = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum()) for a, b in zip(*maps))
            raise AssertionError(f"the {name} scene's shadow maps differ between card and CPU ({n} texels)")


EXAMPLE_W, EXAMPLE_H = 1280, 720  # the reference screenshots' size


def _shadow_front_check(label, args):
    """S1 and S2 (ops/shadow_front.shadow_front, in fresh buffers) against
    their plain version on a shadow pass's captured arguments: every map's
    rows in slot order bit for bit, the tile offsets, each tile's list as
    a set. Returns (S1 / S2's maps, the plain version's)."""
    from rend3_tpu_torch import testing
    from rend3_tpu_torch.ops import shadow_front as SF

    got = SF.shadow_front(SF.ShadowFrontBuffers(), *args)
    want = SF.shadow_front_plain(*args)
    faults = testing.shadow_front_diff(got, want)
    if faults:
        raise AssertionError(f"{label} S1 / S2 differ from the plain version: {faults}")
    log(f"{label} S1 / S2: rows, offsets and lists equal the plain version over {args[4].shape[0]} triangles, "
        f"maps {args[0]}: survivors {[g.tris.count for g in got]}, list entries {[g.binned.ids.numel() for g in got]}")
    return got, want


def _check_frame_kernels(label, cap):
    """Each kernel that an example frame launched, against its plain version
    on the inputs the frame captured, with phase 11's tolerances: K1 depth,
    hit and material bit-exact and the rest within 1 ulp, K2 and K5
    bit-exact, K3 within 1e-6, K4 within 1 ulp, D1 as _d1_check, C1 as
    _c1_check. Returns the names checked."""
    import torch

    from rend3_tpu_torch.ops import deferred as D
    from rend3_tpu_torch.ops import lighting as L
    from rend3_tpu_torch.ops import samplers as S

    checked = []
    if "raster_resolve" in cap:
        t = cap["raster_resolve"]
        _k1_check(f"{label} K1", D.raster_resolve(*t).data, D.raster_resolve_plain(*t))
        checked.append("raster_resolve")
    if "raster_depth" in cap:
        k, p = D.raster_depth(*cap["raster_depth"]), D.raster_depth_plain(*cap["raster_depth"])
        if not torch.equal(k, p):
            raise AssertionError(f"{label} K2 differs from the plain version at {int((k != p).sum())} texels")
        log(f"{label} K2: bit-exact over {k.numel()} texels, {int((k > 0).sum())} covered")
        checked.append("raster_depth")
    if "shadow_front" in cap and cap["shadow_front"][2].is_cuda:
        _shadow_front_check(label, cap["shadow_front"])
        checked += list(SHADOW_KERNELS)
    if any(table.clip.is_cuda for _args, table in cap.get("view_clip", {}).values()):
        _view_front_check(label, cap)
        checked += list(VIEW_KERNELS)
    for key in ("deferred_shade", "deferred_shade_blend"):
        if key in cap and cap[key][0].data.is_cuda:
            _d1_check(f"{label} {key}", cap[key])
            checked.append("deferred_shade")
    if "cutout_peel" in cap and cap["cutout_peel"][0].is_cuda:
        _c1_check(f"{label} first cutout peel", cap["cutout_peel"])
        checked.append("cutout_alpha")
    if "deferred_shade" in cap and isinstance(cap["deferred_shade"][6], L.ShadowMaps):
        # K3 on the frame's shadow queries (where its routines' factors launch it).
        args = L.chain_inputs(*cap["deferred_shade"])["pcf5"]
        err = float((S.sample_grid_pcf5(*args) - S.sample_grid_pcf5_plain(*args)).abs().max())
        log(f"{label} K3: max abs err {err:.3g} over {int(args[-1].sum())} valid queries")
        if not err <= 1e-6:
            raise AssertionError(f"{label} K3 differs from the plain version by {err}")
        checked.append("pcf5")
    for key in ("bilinear", "bilinear_cutout", "bilinear_sky"):
        if key in cap:
            _k4_check(f"{label} {key}", cap[key])
            checked.append(key)
    if "gather" in cap:
        k, p = S.sample_grid(*cap["gather"]), S.sample_grid_plain(*cap["gather"])
        if not torch.equal(k, p):
            raise AssertionError(f"{label} K5 differs from the plain version at {int((k != p).sum())} values")
        log(f"{label} K5: bit-exact over {int(cap['gather'][1].numel())} queries")
        checked.append("gather")
    return checked


def _example_frame(label, make_app, device, width=EXAMPLE_W, height=EXAMPLE_H, **start_kw):
    """The app's frames through framework.start with the launch counters
    zeroed just before and read just after; logs the host time and the
    launches. On the card the base graph captures each kernel's inputs (and
    fp.capture F1's at each call site), and each kernel launched is then
    held against its plain version. Returns (app, images, counts)."""
    import torch

    from rend3_tpu_torch import framework
    from rend3_tpu_torch.ops import fp

    cuda = torch.device(device).type == "cuda"
    smi = nvidia_smi_line() if cuda else "cpu"
    app = make_app()
    graphs = []
    if cuda:
        app_setup = app.setup

        def setup(context):
            context.base_graph.captured = {}
            graphs.append(context.base_graph)
            app_setup(context)

        app.setup = setup
    _reset_launch_counts()
    if cuda:
        torch.cuda.synchronize()
        fp.capture = {}
    t0 = time.perf_counter()
    try:
        imgs = framework.start(app, width, height, device=device, **start_kw)
    finally:
        sites, fp.capture = fp.capture, None
    ms = (time.perf_counter() - t0) * 1e3
    counts = _launch_counts()
    log(f"{label}: {len(imgs)} frame(s) at {width}x{height} in {ms:.3f} ms host (setup included); "
        f"launches {{{', '.join(f'{k}: {v}' for k, v in counts.items() if v)}}} [{smi}]")
    for img in imgs:
        if img.shape != (height, width, 4) or img.dtype.name != "uint8":
            raise AssertionError(f"{label}: image {img.shape} {img.dtype}")
    if cuda:
        checked = {k.split("_")[0] if k.startswith("bilinear") else k
                   for k in _check_frame_kernels(label, graphs[0].captured)}
        checked |= _check_f1_sites(f"{label} F1", sites)
        graphs[0].captured = None
        unchecked = {k for k, v in counts.items() if v} - checked
        if unchecked:
            raise AssertionError(f"{label}: launched {sorted(unchecked)} but captured no inputs to check")
    return app, imgs, counts


def _card_vs_cpu(label, make_app, card_imgs, width, height, **start_kw):
    """The same frames on the CPU, held to the card's within 1 u8."""
    import numpy as np

    _app, cpu_imgs, _counts = _example_frame(f"{label} on cpu", make_app, "cpu", width, height, **start_kw)
    d = max(int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max()) for a, b in zip(card_imgs, cpu_imgs))
    log(f"{label} at {width}x{height}, {len(card_imgs)} frame(s): card vs cpu largest u8 difference {d}")
    if d > 1:
        raise AssertionError(f"{label}: the card's and the CPU's frames differ by {d}")


def phase_framework(device="cuda", width=EXAMPLE_W, height=EXAMPLE_H):
    """The app layer through its entry points: the cube example against the
    JAX package's committed render, the overlay example with the overlay on
    the device and on the host, textured_quad on a checker built in memory,
    testing.make_test_gltf()'s animated scene (three poses through
    framework.start), each on the card against the CPU, and the profiling
    scopes. Returns the per-frame launches of each example."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_framework_") as tmp:
        return _phase_framework(device, width, height, tmp)


def _phase_framework(device, width, height, tmp):
    from types import SimpleNamespace

    import numpy as np
    import torch

    from rend3_tpu_torch import framework, testing
    from rend3_tpu_torch.examples import cube, overlay, textured_quad
    from rend3_tpu_torch.utils import profiling

    cuda = torch.device(device).type == "cuda"
    smi = nvidia_smi_line() if cuda else "cpu"
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cube.png")
    launches = {}

    # cube against the CPU and against the JAX render at the reference's threshold.
    _app, (img,), counts = _example_frame("cube", cube.CubeExample, device, width, height)
    launches["cube"] = counts
    if cuda:
        _check_launched(counts, ("raster_resolve", "raster_depth", "deferred_shade", *SHADOW_KERNELS))
    log(f"cube: K5 (gather) launches {counts['gather']}")
    _card_vs_cpu("cube", cube.CubeExample, [img], width, height)
    if (width, height) == (EXAMPLE_W, EXAMPLE_H):
        if not os.path.isfile(golden):
            raise AssertionError(f"the JAX package's cube render {golden!r} is missing")
        ref = testing.load_png(golden)
        diff = np.abs(img[..., :3].astype(np.int32) - ref.astype(np.int32))
        stats = testing.compare_to_golden(img, golden, testing.Threshold(mae=0.005, ssim=0.99), out_dir=tmp)
        off = (diff > 1).any(-1)
        log(f"cube vs {golden} (the JAX render): mae {stats['mae']:.6f}, ssim {stats['ssim']:.6f}, "
            f"largest u8 difference {int(diff.max())}, {int(off.sum())} pixels more than 1 u8 off "
            f"(share {float(off.mean()):.6f}) [{smi}]")

    # overlay: on the device, then on the host.
    imgs = {}
    apps = {}
    for on in (True, False):
        class App(overlay.OverlayExample):
            OVERLAY_ON_DEVICE = on

        apps[on] = App
        app, (imgs[on],), counts = _example_frame(f"overlay (OVERLAY_ON_DEVICE {on})", App, device, width, height)
        launches[f"overlay ({'device' if on else 'host'})"] = counts
    d = int(np.abs(imgs[True].astype(np.int32) - imgs[False].astype(np.int32)).max())
    log(f"overlay: device pass vs host compositor, largest u8 difference {d}")
    if d > 1:
        raise AssertionError(f"the overlay on the device and on the host differ by {d}")
    _card_vs_cpu("overlay (OVERLAY_ON_DEVICE True)", apps[True], [imgs[True]], width, height)
    if cuda:
        ov = app.overlay
        jobs = app.overlay_jobs(SimpleNamespace(overlay=ov))
        n_tris = sum(len(j.indices) for j in jobs)
        bake_ms = _median_ms(lambda: ov.bake(jobs, width, height), 5)
        fn = ov.device_pass(jobs, width, height)
        base = torch.from_numpy(imgs[False]).to(device)
        pass_ms = _median_ms(lambda: fn(base, None, None, 0), 5)
        host_ms = _median_ms(lambda: ov.render(imgs[False], jobs), 5)
        log(f"overlay timings ({len(jobs)} jobs, {n_tris} triangles, CUDA events, host work included, "
            f"median of 5 after a warm-up call): bake {bake_ms:.3f} ms, device pass {pass_ms:.4f} ms, "
            f"host compositor {host_ms:.3f} ms [{smi}]")

    # textured_quad on a checker built in memory.
    yy, xx = np.mgrid[0:256, 0:256]
    checker = np.zeros((256, 256, 4), np.uint8)
    checker[..., :3] = np.where(((xx // 32) + (yy // 32)) % 2 == 0, 230, 25)[..., None]
    checker[..., 3] = 255
    png = os.path.join(tmp, "checker.png")
    testing.save_png(png, checker)

    def quad():
        return textured_quad.TexturedQuadExample(png)

    _app, (img,), counts = _example_frame("textured_quad", quad, device, width, height)
    launches["textured_quad"] = counts
    if cuda and counts["deferred_shade"] == 0:
        raise AssertionError("textured_quad did not launch D1")
    _check_image(img, width, height)
    _card_vs_cpu("textured_quad", quad, [img], width, height)

    # The glTF scene, posed at t = 0, half the duration and the duration.
    dt = testing.TEST_GLTF_DURATION / 2

    class Timed(testing.GltfAnimationApp):
        def setup(self, context):
            self.renderer = context.renderer
            self.marks, self.frame_ms, self.peak_mib, self.pose_ms, self.states = [], [], [], [], []
            self.base_bytes = 0
            t0 = time.perf_counter()
            super().setup(context)
            self.load_ms = (time.perf_counter() - t0) * 1e3

        def mark(self):
            if cuda:
                torch.cuda.synchronize()
            now = time.perf_counter()
            if self.marks:
                self.frame_ms.append((now - self.marks[-1]) * 1e3)
                if cuda:
                    self.peak_mib.append((torch.cuda.max_memory_allocated() - self.base_bytes) / 2**20)
                r = self.renderer
                rigid = self.instance.objects_by_node[1][0]
                sk = self.instance.skeletons[2][0]
                self.states.append((r.object_manager.transforms[rigid.idx].copy(),
                                    r.skeleton_manager.data[sk.idx].joint_matrices.copy()))
            if cuda:
                torch.cuda.reset_peak_memory_stats()
                self.base_bytes = torch.cuda.memory_allocated()
            self.marks.append(now)

        def handle_redraw(self, context):
            self.mark()
            t0 = time.perf_counter()
            super().handle_redraw(context)
            self.pose_ms.append((time.perf_counter() - t0) * 1e3)

    app, big, counts = _example_frame("glTF scene", Timed, device, width, height, frames=3, frame_dt=dt)
    app.mark()
    launches["glTF scene (3 frames)"] = counts
    log(f"glTF scene at {width}x{height}: load {app.load_ms:.3f} ms, pose {[round(x, 3) for x in app.pose_ms]} ms, "
        f"frames {[round(x, 3) for x in app.frame_ms]} ms host (synchronized), peak above the frame's start "
        f"{[round(x, 1) for x in app.peak_mib]} MiB [{smi}]")
    for (t_a, j_a), (t_b, j_b) in zip(app.states, app.states[1:]):
        if np.array_equal(t_a, t_b) or np.array_equal(j_a, j_b):
            raise AssertionError("the rigid or the skinned node did not move between frames")
    for a, b in zip(big, big[1:]):
        if np.array_equal(a, b):
            raise AssertionError("two poses of the glTF scene rendered the same image")
    if cuda:
        _check_launched(counts, ("raster_resolve", "raster_depth", "deferred_shade", *SHADOW_KERNELS))
    _card_vs_cpu("glTF scene", Timed, big, width, height, frames=3, frame_dt=dt)

    # Profiling: both scopes in the chrome trace, and a device trace.
    profiling.enable()
    try:
        framework.render_single_frame(cube.CubeExample(), width, height, device=device)
    finally:
        profiling.disable()
    trace = os.path.join(tmp, "trace.json")
    profiling.dump_chrome_trace(trace)
    with open(trace) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    want = {"Renderer::evaluate_instructions", "BaseRenderGraph::build_frame_callable"}
    if not want <= names:
        raise AssertionError(f"the chrome trace lacks {want - names}")
    log("profiling: " + profiling.stats().summary().replace("\n", "; ") + f" [{smi}]")
    with profiling.device_trace(os.path.join(tmp, "device")):
        framework.render_single_frame(cube.CubeExample(), width, height, device=device)
    with open(os.path.join(tmp, "device", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    n_kernels = sum(1 for e in events if e.get("cat") == "kernel")
    log(f"device_trace: {len(events)} events, {n_kernels} device kernels")
    if not events or (cuda and not n_kernels):
        raise AssertionError("device_trace wrote no trace of the card")
    return launches


def _soup(n, seed):
    """test_raster_fast.py's random soup: n triangles of random depth over
    the whole viewport (and past it), w = 1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1.2, 1.2, (n, 3, 2)).astype(np.float32)
    z = rng.uniform(0.0, 1.0, (n, 1, 1)).astype(np.float32) * np.ones((n, 3, 1), np.float32)
    return np.concatenate([xy, z, np.ones((n, 3, 1), np.float32)], axis=2)


def _forward_city(device, width, height, n_buildings, samples, deferred=False):
    """The representative city (n_buildings) rendered once through the
    user's entry points under REND3_TPU_RASTER=reference (deferred: the
    default backend, with occlusion culling); returns (graph, image, host
    ms, peak MiB above the frame's start or nan on the CPU)."""
    import torch

    from rend3_tpu_torch import scenes
    from rend3_tpu_torch.routine.base import BaseRenderGraphSettings, FrameRenderTarget, StageTimer
    from rend3_tpu_torch.testing import TestRunner

    runner = TestRunner(device=device)
    keep = scenes.build_city_scene(runner, n_buildings=n_buildings, representative=True)
    scenes.set_bench_camera(runner, width, height)
    graph = runner.base_graph
    graph.captured = {}
    graph.timer = StageTimer(device)
    cuda = torch.device(device).type == "cuda"
    old = os.environ.get("REND3_TPU_RASTER")
    os.environ["REND3_TPU_RASTER"] = "pallas" if deferred else "reference"
    try:
        runner.renderer.swap_instruction_buffers()
        ev = runner.renderer.evaluate_instructions()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        settings = BaseRenderGraphSettings(ambient_color=(0.08, 0.08, 0.1, 1.0))
        img = graph.render_frame(ev, FrameRenderTarget(width, height, samples), settings)
        if cuda:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20 if cuda else float("nan")
    finally:
        if old is None:
            os.environ.pop("REND3_TPU_RASTER")
        else:
            os.environ["REND3_TPU_RASTER"] = old
    stages = graph.timer.ms()
    graph.timer = None
    del keep
    return graph, img, ms, peak, stages


def phase_reference(device="cuda", width=WIDTH, height=HEIGHT, n_buildings=REFERENCE_BUILDINGS, check=(320, 180)):
    """The reference forward backend (REND3_TPU_RASTER=reference): the
    representative city cut to n_buildings at width x height, at 1 and 4
    samples, and sample_shadow_map / sample_shadow_maps (K5) on the 1-sample
    frame's shadow maps at the deferred frame's light-space coordinates,
    launches counted over those frames and calls only. Firm checks: K5
    against its plain version bit for bit; raster.rasterize on a 64-triangle
    soup at width x height (1 sample), card against CPU, bit for bit; the forward frame
    at `check` on the card and on the CPU within 1 u8. Diagnostic: the
    pixels where the forward frame is more than 1 u8 off the deferred frame
    of the same scene. Returns the launch counts."""
    import numpy as np
    import torch

    from rend3_tpu_torch.ops import raster as R
    from rend3_tpu_torch.ops import shadow as SH

    log(f"reference: the representative city cut to {n_buildings} of its 600 buildings (the forward frame is "
        f"O(triangles x pixels) by design), at {width}x{height}")
    dgraph, dimg, dms, dpeak, _ = _forward_city(device, width, height, n_buildings, 1, deferred=True)
    log(f"reference: deferred frame of the same scene {dms:.1f} ms (host, synchronized), peak {dpeak:.1f} MiB")
    from rend3_tpu_torch.ops import lighting as L

    coords = L.chain_inputs(*dgraph.captured["deferred_shade"])["shadow_coords"]
    cuda = torch.device(device).type == "cuda"

    _reset_launch_counts()
    frames = {}
    for samples in (1, 4):
        graph, img, ms, peak, stages = _forward_city(device, width, height, n_buildings, samples)
        frames[samples] = (graph, img)
        _check_image(img, width, height)
        log(f"reference frame at {samples} sample(s): {ms:.1f} ms (host, synchronized), peak {peak:.1f} MiB above "
            f"its start, stats {graph.last_stats}")
        log("  stages (ms): " + json.dumps({k: round(v, 4) for k, v in stages.items()}))
        if graph.last_stats["samples"] != samples:
            raise AssertionError(f"the forward frame rendered {graph.last_stats['samples']} samples, not {samples}")
    vis, atlas, plan = frames[1][0].captured["forward"]
    maps = [atlas[oy : oy + size, ox : ox + size].contiguous() for _li, (ox, oy), size in plan]
    entries = [(k, sx, sy, hit) for k, sx, sy, _ref, hit, _ib in coords]
    occ0, need = SH.sample_shadow_map(maps[0], *entries[0][1:])
    occs, overflow = SH.sample_shadow_maps(maps, entries)
    counts = _launch_counts()
    log(f"launches during the reference path (two forward frames, sample_shadow_map and sample_shadow_maps): {counts}")
    if cuda:
        _check_launched(counts, ("gather",))

    # K5 through sample_shadow_map(s) against its plain version (the same
    # calls on the CPU), bit for bit.
    p0, _ = SH.sample_shadow_map(maps[0].cpu(), *(t.cpu() for t in entries[0][1:]))
    ps, _ = SH.sample_shadow_maps([m.cpu() for m in maps], [(k, *(t.cpu() for t in e)) for k, *e in entries])
    for label, k, p in [("sample_shadow_map", occ0, p0)] + [
        (f"sample_shadow_maps entry {i}", a, b) for i, (a, b) in enumerate(zip(occs, ps))
    ]:
        if not torch.equal(k.cpu(), p):
            raise AssertionError(f"K5 ({label}) differs from its plain version at {int((k.cpu() != p).sum())} values")
    n_hit = int(entries[0][3].sum())
    log(f"K5 through sample_shadow_map(s): bit-exact against the plain version over {len(entries)} entries "
        f"({n_hit} hit pixels each, maps {[tuple(m.shape) for m in maps]}), need {need}, overflow {overflow}, "
        f"{int((occ0 > 0).sum())} nonzero taps for light 0")

    # rasterize: card against CPU on a random soup at the full size.
    soup = torch.from_numpy(_soup(64, 0))
    valid = torch.ones(64, dtype=torch.bool)
    t0 = time.perf_counter()
    a = R.rasterize(soup.to(device), valid.to(device), width, height)
    b = R.rasterize(soup, valid, width, height)
    same_depth = torch.equal(a.depth.cpu().view(torch.int32), b.depth.view(torch.int32))
    if not (torch.equal(a.tri.cpu(), b.tri) and same_depth):
        raise AssertionError("rasterize on the card differs from the CPU")
    log(f"rasterize on a 64-triangle soup at {width}x{height}: card equals CPU bit for bit "
        f"({int((b.tri >= 0).sum())} covered pixels; {time.perf_counter() - t0:.2f} s with the CPU's)")

    # The forward frame at a small size, card against CPU.
    cw, ch = check
    _g, card_small, card_ms, _p, _s = _forward_city(device, cw, ch, n_buildings, 1)
    _g, cpu_small, cpu_ms, _p, _s = _forward_city("cpu", cw, ch, n_buildings, 1)
    d = int(np.abs(card_small.astype(np.int32) - cpu_small.astype(np.int32)).max())
    log(f"reference frame at {cw}x{ch}: card vs CPU max {d} u8 (card frame {card_ms:.0f} ms, CPU {cpu_ms:.0f} ms)")
    if d > 1:
        raise AssertionError(f"the forward frame on the card differs from the CPU by {d} u8")

    diff = np.abs(frames[1][1].astype(np.int32) - dimg.astype(np.int32)).max(-1)
    log(f"reference vs deferred frame at {width}x{height} (diagnostic): {int((diff > 1).sum())} pixels more than "
        f"1 u8 off (largest {int(diff.max())})")
    return counts


def phase_bench_host(device="cuda", n_objects=50_000):
    """tools.bench_host at n_objects on the card; logs its lines."""
    from rend3_tpu_torch.tools import bench_host

    res = bench_host.run(n_objects, device, out=lambda line: log("bench_host: " + line))
    return statistics.median(res["ms"])


# Row bands (phase 16): the band counts of the representative frame at 1
# sample, and the frames banded 4 ways (MSAA 4, the feature frame).
BAND_COUNTS = (2, 4, 8)
# The kernels the banded frames must launch: K1 at every band's first row
# past 0 ("raster_band") and band 0's K1 modes, K2 for the shadow maps
# (rebuilt in the first banded frame of each scene), C1, K4 (the feature
# frame's skybox), K5, D1 and V1-V4.
BAND_KERNELS = ("raster_band", "raster_resolve", "raster_count", "raster_bound", "raster_depth", "cutout_alpha",
                "bilinear", "gather", "deferred_shade", *F1_FRAME_KERNELS, *SHADOW_KERNELS, *VIEW_KERNELS)


def _peak_start(cuda):
    """Synchronizes and resets the peak; returns the bytes allocated now."""
    import torch

    if not cuda:
        return 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak_text(cuda, start):
    import torch

    if not cuda:
        return "peak not measured on the CPU"
    peak = torch.cuda.max_memory_allocated()
    return f"peak {(peak - start) / 2**20:.1f} MiB above the frame's start ({peak / 2**20:.1f} MiB in all)"


def _band_run(runner, target, settings, mesh, label, skybox_slot=None, frames=2):
    """`frames` frames of runner's scene through
    parallel.tiles.build_tiled_frame_callable on `mesh`, the first from no
    carried mask; logs each frame's host time (synchronized) and peak
    memory; returns the images."""
    import torch

    from rend3_tpu_torch.parallel.tiles import build_tiled_frame_callable

    graph = runner.base_graph
    cuda = mesh.device.type == "cuda"
    graph._prev_visible_mask = None
    imgs = []
    for k in range(frames):
        runner.renderer.swap_instruction_buffers()
        ev = runner.renderer.evaluate_instructions()
        start = _peak_start(cuda)
        t0 = time.perf_counter()
        program, args = build_tiled_frame_callable(graph, ev, target, settings, skybox_slot, mesh=mesh)
        img, _mask, aux = program(*args)
        img = img.cpu().numpy()
        ms = (time.perf_counter() - t0) * 1e3
        log(f"bands {label} frame {k + 1}: host {ms:.3f} ms (synchronized), {_peak_text(cuda, start)}, stats {aux}")
        imgs.append(img)
    return imgs


def _single_run(runner, target, settings, label, skybox_slot=None, frames=2):
    """The one-device frames that _band_run's are held to, timed alike."""
    import torch

    graph = runner.base_graph
    cuda = runner.renderer.device.type == "cuda"
    graph._prev_visible_mask = None
    imgs = []
    for k in range(frames):
        runner.renderer.swap_instruction_buffers()
        ev = runner.renderer.evaluate_instructions()
        start = _peak_start(cuda)
        t0 = time.perf_counter()
        imgs.append(graph.render_frame(ev, target, settings, skybox_slot))
        ms = (time.perf_counter() - t0) * 1e3
        log(f"bands {label} one-device frame {k + 1}: host {ms:.3f} ms (synchronized), {_peak_text(cuda, start)}")
    return imgs


def _same_images(label, got, want):
    import numpy as np

    for k, (a, b) in enumerate(zip(got, want)):
        if not np.array_equal(a, b):
            n = int((a != b).any(-1).sum())
            raise AssertionError(f"bands {label} frame {k + 1} differs from the one-device frame at {n} pixels")
    log(f"bands {label}: {len(got)} frames equal the one-device frames bit for bit")


def _distributed_one_rank(runner, target, settings, want, device):
    """One frame through a world-size-1 process group (NCCL on the card,
    gloo on the CPU) and parallel.tiles' distributed mesh, held to the
    one-device frame; the group is destroyed before returning."""
    import datetime
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from rend3_tpu_torch.parallel.tiles import build_tiled_frame_callable, device_mesh

    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    # One rank talks to no other host: NCCL's bootstrap binds to loopback.
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=120))
        try:
            mesh = device_mesh(device=device, distributed=True)
            runner.base_graph._prev_visible_mask = None
            runner.renderer.swap_instruction_buffers()
            program, args = build_tiled_frame_callable(
                runner.base_graph, runner.renderer.evaluate_instructions(), target, settings, mesh=mesh
            )
            img = program(*args)[0].cpu().numpy()
        finally:
            dist.destroy_process_group()
    if not np.array_equal(img, want):
        raise AssertionError(f"the {backend} world-size-1 frame differs from the one-device frame at "
                             f"{int((img != want).any(-1).sum())} pixels")
    log(f"bands: a world-size-1 {backend} group ({mesh}) through build_tiled_frame_callable equals the "
        f"one-device frame bit for bit ({(time.perf_counter() - t0):.2f} s with the group's set-up)")


def phase_bands(device="cuda", width=WIDTH, height=HEIGHT, n_buildings=600, sky_size=512, n_columns=64,
                timed=True):
    """Row bands (rend3_tpu_torch.parallel.tiles) on one device: the
    representative frame through the local mesh at each of BAND_COUNTS
    bands, at MSAA 4 with 4 bands, and the feature frame (skybox, skinned
    columns, routines, passes) with 4 bands, each two frames (all
    predicted, then the carried mask) held bit for bit to the one-device
    frames of the same scene; launches counted over the banded frames only
    (each scene's shadow maps dropped before its banded frames, so K2 runs
    on the path); then K1 against its plain version at every band's first
    row on that band's captured inputs, and one frame through a
    world-size-1 NCCL group. Returns (counts, [the raster_band kernel row])."""
    import torch

    from rend3_tpu_torch import scenes
    from rend3_tpu_torch.ops import deferred as D
    from rend3_tpu_torch.parallel.tiles import device_mesh
    from rend3_tpu_torch.routine.base import BaseRenderGraphSettings, FrameRenderTarget
    from rend3_tpu_torch.testing import TestRunner

    settings = BaseRenderGraphSettings(ambient_color=(0.08, 0.08, 0.1, 1.0))
    t0 = time.perf_counter()
    rep = TestRunner(device=device)
    rep_keep = scenes.build_city_scene(rep, n_buildings=n_buildings, representative=True)
    scenes.set_bench_camera(rep, width, height)
    feat = TestRunner(device=device)
    feat_keep, info = scenes.feature_city(feat, n_buildings=n_buildings, sky_size=sky_size, n_columns=n_columns)
    scenes.set_bench_camera(feat, width, height)
    log(f"bands: representative and feature cities built in {time.perf_counter() - t0:.2f} s")
    # (scene, runner, samples, skybox slot) and the band counts of each.
    scenes_ = {"representative": (rep, 1, None), "msaa4": (rep, 4, None), "features": (feat, 1, info["sky"].idx)}
    runs = [("representative", n) for n in BAND_COUNTS] + [("msaa4", 4), ("features", 4)]
    singles = {name: _single_run(r, FrameRenderTarget(width, height, s), settings, name, slot)
               for name, (r, s, slot) in scenes_.items()}

    _reset_launch_counts()
    banded, caps = {}, {}
    for name, n in runs:
        runner, samples, slot = scenes_[name]
        graph = runner.base_graph
        graph._shadow_cache = None
        graph.captured = {}
        label = f"{name} {n} bands"
        banded[label] = _band_run(runner, FrameRenderTarget(width, height, samples), settings,
                                  device_mesh(n, device=device), label, slot)
        caps[label] = graph.captured.get("raster_band", {})
        graph.captured = None
    counts = _launch_counts()
    log(f"launches during the banded frames: {counts}")
    if torch.device(device).type == "cuda":
        _check_launched(counts, BAND_KERNELS)
    for name, n in runs:
        label = f"{name} {n} bands"
        for img in banded[label]:
            _check_image(img, width, height)
        _same_images(label, banded[label], singles[name])

    # K1 at every band's first row, on the band's inputs of its last frame.
    err = 0.0
    for label, bands in caps.items():
        if sorted(bands) != [i * (height // len(bands)) for i in range(len(bands))]:
            raise AssertionError(f"bands {label}: captured first rows {sorted(bands)}")
        for row0, (tris, planes, binned, wp, hp, _r) in sorted(bands.items()):
            err = max(err, _k1_check(
                f"K1 {label} at row0 {row0} ({tris.count} triangles, {wp}x{hp})",
                D.raster_resolve(tris, planes, binned, wp, hp, y0=row0).data,
                D.raster_resolve_plain(tris, planes, binned, wp, hp, y0=row0),
            ))

    _distributed_one_rank(rep, FrameRenderTarget(width, height, 1), settings, singles["representative"][0], device)

    # The kernel row: K1 on the band of the representative frame at 8 bands
    # that lists the most triangles.
    bands = caps[f"representative {BAND_COUNTS[-1]} bands"]
    row0 = max(bands, key=lambda r: bands[r][0].count)
    tris, planes, binned, wp, hp, _r = bands[row0]
    bound_ms, bound_by = _k1_bound(tris, planes, binned, wp, hp, y0=row0)
    kfn = lambda: D.raster_resolve(tris, planes, binned, wp, hp, y0=row0)  # noqa: E731
    pfn = lambda: D.raster_resolve_plain(tris, planes, binned, wp, hp, y0=row0)  # noqa: E731
    ms = _graph_ms(kfn) if timed else None
    call_ms = _median_ms(kfn, 20) if timed else None
    plain_ms = _median_ms(pfn, 5) if timed else None
    log(f"raster_band (K1 at row0 {row0} of the representative frame's {BAND_COUNTS[-1]} bands, "
        f"{tris.count} triangles, {wp}x{hp}): kernel {ms} ms (device, graph of {DEVICE_CALLS} calls), call "
        f"{call_ms} ms (host included, median), plain {plain_ms} ms (median); bound {bound_ms:.6f} ms ({bound_by}); "
        f"{counts['raster_band']} launches on the banded frames")
    del rep_keep, feat_keep
    return counts, [{
        "name": "raster_band", "route": "cuda", "source": "rend3_tpu_torch/csrc/raster.cu",
        "replaces": "rend3_tpu/ops/deferred.py:505", "launches": counts["raster_band"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "ms_method": f"graph of {DEVICE_CALLS} calls", "call_ms": call_ms,
    }]


# bench.py's keys (bench.py:418-440), with --flat and --heavy.
BENCH_LINE_KEYS = ("metric", "value", "unit", "vs_baseline", "static_ms", "shadow_pass_ms", "dynamic_ms",
                   "steady_caps", "stats", "flat_scene_ms", "heavy_ms", "heavy_caps")
BENCH_TIMEOUT_S = 600


class _StagePeaks:
    """A stage hook for graph.timer that keeps each stage's peak device
    memory (MiB, the largest over the stage's runs): the peak is reset as
    a stage begins and read as it ends."""

    def __init__(self):
        self.peaks = {}

    def __call__(self, name):
        import contextlib

        import torch

        @contextlib.contextmanager
        def span():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            yield
            torch.cuda.synchronize()
            mib = torch.cuda.max_memory_allocated() / 2**20
            self.peaks[name] = max(self.peaks.get(name, 0.0), mib)

        return span()


def _bench_line():
    """`python -m rend3_tpu_torch.bench --flat --heavy` in a child process
    (its stderr logged): exit 0 and exactly one stdout line, a JSON object
    with bench.py's keys whose times are positive and whose dynamic_ms is
    static_ms + shadow_pass_ms. Returns the line."""
    import math

    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "rend3_tpu_torch.bench", "--flat", "--heavy"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True, timeout=BENCH_TIMEOUT_S,
    )
    for line in out.stderr.splitlines():
        log("  " + line)
    if out.returncode != 0:
        raise AssertionError(f"the bench exited {out.returncode}")
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    if len(lines) != 1:
        raise AssertionError(f"the bench printed {len(lines)} stdout lines, not one: {lines[:3]}")
    r = json.loads(lines[0])
    if tuple(r) != BENCH_LINE_KEYS:
        raise AssertionError(f"the bench line's keys {list(r)} are not bench.py's {list(BENCH_LINE_KEYS)}")
    times = [r[k] for k in ("value", "static_ms", "shadow_pass_ms", "dynamic_ms", "flat_scene_ms", "heavy_ms")]
    if not all(isinstance(t, float) and math.isfinite(t) and t > 0 for t in times):
        raise AssertionError(f"the bench line's times are not all positive: {times}")
    if r["dynamic_ms"] != round(r["static_ms"] + r["shadow_pass_ms"], 3) or r["steady_caps"] or r["heavy_caps"]:
        raise AssertionError("the bench line's dynamic_ms or caps are wrong")
    log(f"bench: exit 0 in {time.perf_counter() - t0:.2f} s; its line:")
    print(lines[0], flush=True)
    return lines[0]


def _check_peel_kernels(label, cap):
    """K1's count and bound modes against their plain versions on a frame's
    captured inputs (cutout peel 0, the first later peel)."""
    from rend3_tpu_torch.ops import deferred as D

    c_tris, c_planes, c_binned, c_wp, c_hp, floor, strict = cap["raster_count"]
    kg, kc = D.raster_resolve(c_tris, c_planes, c_binned, c_wp, c_hp, count_floor=floor, count_strict=strict)
    pg, pc = D.raster_resolve_plain(c_tris, c_planes, c_binned, c_wp, c_hp, count_floor=floor, count_strict=strict)
    _k1_check(f"{label} K1 count mode ({c_tris.count} triangles)", kg.data, pg, kc, pc)
    b_tris, b_planes, b_binned, b_wp, b_hp, bnd = cap["raster_bound"]
    _k1_check(f"{label} K1 bound mode ({b_tris.count} triangles)",
              D.raster_resolve(b_tris, b_planes, b_binned, b_wp, b_hp, bound=bnd).data,
              D.raster_resolve_plain(b_tris, b_planes, b_binned, b_wp, b_hp, bound=bnd))


def _log_frame_launches(name, program, args, shadow_call):
    """Kernel launches, copies, float64 kernels and device busy time per
    static frame (program) and per shadow pass, from torch.profiler over
    three calls of each (tools.frame_launches.profile_calls; uncounted: the
    launch counters are read before)."""
    from rend3_tpu_torch.tools.frame_launches import profile_calls

    fn, inputs = shadow_call
    for label, res in (("static frame", profile_calls(program, args)), ("shadow pass", profile_calls(fn, inputs))):
        log(f"bench {name}: per {label} (torch.profiler, 3 calls): {res['kernels']:g} kernel launches, "
            f"{res['copies']:g} copies, {res['float64_kernels']:g} float64 kernels; device busy "
            f"{res['busy_ms']:.3f} ms of {res['wall_ms']:.3f} ms (share {res['busy_share']:.3f})")
        log("  most launched: " + "; ".join(f"{t['launches']:g} x {t['name'][:70]}" for t in res["top"][:6]))


def phase_bench(device="cuda", width=WIDTH, height=HEIGHT, cities=None, line=True):
    """The bench line and the frame callable behind it. First (`line`) the
    bench line in a child process (_bench_line). Then, counted, for each
    of `cities` (name: (buildings, subdivision); default bench.py's
    representative city and its heavy one, about 2.04M triangles) at
    width x height: two warm-up frames through render_frame_tensor (the
    first from no carried mask), then build_frame_callable and its program
    called three times, each image bit for bit the second warm-up frame's;
    the third call under a stage hook that logs each stage's peak memory.
    The heavy city's kernels (K1 in its opaque, count and bound modes, K2,
    K3, K4 on the textures, C1 on the cutout alpha test, K5) are held against
    their plain versions on its captured inputs. Returns the launch counts
    over the cities' frames."""
    import torch

    from rend3_tpu_torch import bench

    if line:
        _bench_line()
    cities = cities or {"representative": (600, 3), "heavy": bench.HEAVY}
    cuda = torch.device(device).type == "cuda"
    total = {name: 0 for name in KERNEL_NAMES}
    cap = None
    for name, (n_buildings, subdiv) in cities.items():
        t0 = time.perf_counter()
        runner, keep, ev, target, settings = bench.scene(device, True, n_buildings, subdiv, width, height)
        graph = runner.base_graph
        log(f"bench {name}: {n_buildings} buildings at subdiv {subdiv} built in {time.perf_counter() - t0:.2f} s")
        heavy = name == "heavy"
        graph.captured = {} if heavy else None
        _reset_launch_counts()
        warm = []
        for k in range(2):
            start = _peak_start(cuda)
            t0 = time.perf_counter()
            warm.append(graph.render_frame_tensor(ev, target, settings).cpu().numpy())
            log(f"bench {name} warm-up frame {k + 1}: host {(time.perf_counter() - t0) * 1e3:.3f} ms (synchronized), "
                f"{_peak_text(cuda, start)}")
        t0 = time.perf_counter()
        program, args = graph.build_frame_callable(ev, target, settings)
        log(f"bench {name}: build_frame_callable {(time.perf_counter() - t0) * 1e3:.3f} ms, "
            f"{args[1].tri_vlocal.shape[0]} triangles in the opaque table")
        imgs = []
        for k in range(3):
            if k == 2 and cuda:
                graph.timer = _StagePeaks()
            start = _peak_start(cuda)
            t0 = time.perf_counter()
            img, mask, stats = program(*args)
            imgs.append(img.cpu().numpy())
            log(f"bench {name} program call {k + 1}: host {(time.perf_counter() - t0) * 1e3:.3f} ms "
                f"(synchronized), {_peak_text(cuda, start)}")
        peaks, graph.timer = getattr(graph.timer, "peaks", {}), None
        counts = _launch_counts()
        for key in total:
            total[key] += counts[key]
        log(f"bench {name}: stats {stats}; main_pairs {stats['main_pairs']}; launches {counts}")
        if peaks:
            log(f"bench {name}: peak MiB by stage " + json.dumps({k: round(v, 1) for k, v in peaks.items()}))
            log(f"bench {name}: clip stage peak {peaks['clip']:.1f} MiB, {peaks['clip'] - start / 2**20:.1f} MiB "
                f"above the frame's start")
        if cuda and name == "representative":
            _log_frame_launches(name, program, args, graph._last_shadow_call)
        _check_image(warm[1], width, height)
        for k, img in enumerate([warm[0]] + imgs):
            if not (img == warm[1]).all():
                raise AssertionError(f"bench {name}: image {k} differs from render_frame_tensor's at "
                                     f"{int((img != warm[1]).any(-1).sum())} pixels")
        log(f"bench {name}: three program calls equal render_frame_tensor's frame bit for bit; "
            f"{int(mask.sum())} of {mask.numel()} triangles predicted visible")
        if heavy:
            cap, graph.captured = graph.captured, None
            if cuda:
                _check_launched(counts, FRAME_KERNELS)
        del keep, runner, graph, program, args
    if cap is not None:
        checked = _check_frame_kernels("bench heavy", cap)
        _check_peel_kernels("bench heavy", cap)
        log(f"bench heavy: {checked} and K1's count and bound modes equal their plain versions")
    return total


def phase_entry(device="cuda", bands=(2, 4, 8), size=None):
    """The graft entry points (rend3_tpu_torch.graft_entry), counted:
    entry()'s program on the rich scene at 256x256 (an image that is not
    empty, two calls bit for bit equal), then dryrun_multichip(n) for each
    of `bands`, each bit for bit against the one-device program. Returns the
    launch counts."""
    import numpy as np

    from rend3_tpu_torch import graft_entry

    size = size or graft_entry.SIZE
    _reset_launch_counts()
    t0 = time.perf_counter()
    program, args = graft_entry.entry(device=device, size=size)
    a, _mask, stats = program(*args)
    b = program(*args)[0]
    a, b = a.cpu().numpy(), b.cpu().numpy()
    if a.shape != (size, size, 4) or not a[..., :3].max() > 0:
        raise AssertionError(f"entry(): an empty or misshapen image {a.shape}")
    if not np.array_equal(a, b):
        raise AssertionError("entry(): two calls of its program differ")
    log(f"entry: {a.shape} image in {(time.perf_counter() - t0) * 1e3:.1f} ms with the scene, stats {stats}")
    for n in bands:
        graft_entry.dryrun_multichip(n, device=device, size=size, log=log)
    counts = _launch_counts()
    log(f"entry: launches {counts}")
    return counts


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

        t_run = time.perf_counter()

        def timed(name, fn, *args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            log(f"phase {name}: {time.perf_counter() - t0:.2f} s wall (run so far {time.perf_counter() - t_run:.2f} s)")
            return out

        timed("environment", phase_environment)
        timed("build", phase_build)
        paths = {}
        for name, phase, kw in (("flat", phase_slice, {}), ("textured", phase_textured, {}),
                                ("representative", phase_representative, {}),
                                ("msaa", phase_representative, {"samples": 4})):
            graph, counts, _img = timed(name, phase, **kw)
            paths[name] = (graph, counts)
        rep_graph = paths["representative"][0]
        vis_counts, vis_rows = timed("visibility raster", phase_visibility, rep_graph)
        occ_counts, occ_rows = timed("map-free shadows", phase_mapfree, rep_graph)
        paths["visibility"] = (rep_graph, vis_counts)
        paths["map-free"] = (rep_graph, occ_counts)
        probe_counts, probe_runs = timed("probes", phase_probes)
        paths["probes"] = (None, probe_counts)
        for samples in (1, 4):
            graph, counts, _img = timed(f"features{samples}", phase_features, samples=samples)
            paths["features" if samples == 1 else "features-msaa"] = (graph, counts)
        kernels = timed("kernels", phase_kernels, paths, vis_rows + occ_rows + probe_rows(probe_runs))
        timed("parity", phase_parity)
        timed("framework", phase_framework)
        ref_counts = timed("reference", phase_reference)
        for row in kernels:
            row["launches"] += ref_counts[row["name"]]
        log("launches on the measured paths with the reference path: "
            + json.dumps({row["name"]: row["launches"] for row in kernels}))
        timed("bench_host", phase_bench_host)
        band_counts, band_rows = timed("bands", phase_bands)
        for row in kernels:
            row["launches"] += band_counts[row["name"]]
        kernels += band_rows
        log("launches on the measured paths with the reference and banded paths: "
            + json.dumps({row["name"]: row["launches"] for row in kernels}))
        for name, phase in (("bench", phase_bench), ("entry", phase_entry)):
            counts = timed(name, phase)
            for row in kernels:
                row["launches"] += counts[row["name"]]
        log("launches on the measured paths with the reference, banded, bench and entry paths: "
            + json.dumps({row["name"]: row["launches"] for row in kernels}))
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
