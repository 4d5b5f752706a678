"""The port's tracing (rend3_tpu_torch/utils/profiling.py) and the spans and
counters the frame records.

On the CPU: a span's parent, frame and self time; nothing recorded and the
one shared no-op scope while tracing is off; counters reset by enable();
every program span a CPU range in device_trace's trace.json, beside
spans.json; two identical static frames of a small city count the same
sync:: spans, every one from SYNC_SITES; the shadow cache hits on a
repeated frame and misses after an object moves (the object tables' cache
with it: no bytes copied, then some); a frame with no skeleton counts every
skinning counter 0 and opens no skinning span, a skinned one opens them
inside the frame, the palette's copy under skin::palette; a city frame
counts every extension-feature counter 0 and opens none of their spans, a
frame of scenes.feature_city counts its sky queries, archetypes and passes
and opens their spans (a routine shade call at least) inside the frame.

On the CPU a frame's front end is the plain version (no view_front.tables,
no kernel::V* span, none of the chain's reads). On the card (marked cuda; skips without one): one frame
of each traffic kind (static, camera moving, objects moving) with
PyTorch's sync debug mode on; every synchronizing call it warns of lies
inside a sync:: span; a city frame builds its four front-end tables with
V1-V4 (view_front.tables 4, the kernel::V1-V4 spans, two crossing reads
and four totals reads), a frame of the cube lattice two; the feature
counters read 0 on a city frame and count a feature frame's (a cutout
routine's verdict under routines::verdict), and the feature spans add no
sync:: site to either frame. Run it there with python3 -m pytest
tests/test_torch_profiling.py --noconftest -q.
"""

import json
import time
import traceback
import warnings

import numpy as np
import pytest
import torch

from rend3_tpu_torch import scenes
from rend3_tpu_torch.routine.base import BaseRenderGraphSettings, FrameRenderTarget
from rend3_tpu_torch.testing import TestRunner
from rend3_tpu_torch.types import Camera, Perspective
from rend3_tpu_torch.utils import math as m3
from rend3_tpu_torch.utils import profiling

# Every sync:: site of the deferred frame and its uploads.
SYNC_SITES = {
    "sync::upload.triangles", "sync::upload.objects", "sync::upload.blend", "sync::upload.visible",
    "sync::upload.uniforms", "sync::upload.materials", "sync::upload.meshes", "sync::upload.textures",
    "sync::upload.skin", "sync::upload.cube",
    "sync::clip.crossing", "sync::setup.survivors", "sync::bin.candidates", "sync::bin.pairs",
    "sync::bin.tile_counts", "sync::hiz.visible", "sync::cut.layers", "sync::cut.pixels", "sync::cut.searching",
    "sync::blend.layers", "sync::blend.pixels",
    "sync::const.setup_height", "sync::const.planes_viewport", "sync::const.planes_defaults",
    "sync::const.hiz_ln2", "sync::const.shade_defaults", "sync::const.texture_ln2", "sync::const.cube_faces",
    "sync::shadow_front.totals", "sync::view_front.crossing", "sync::view_front.totals",
}
# The view's front end on the card (ops/view_front.py): its kernels' spans.
VIEW_KERNEL_SPANS = {"kernel::V1", "kernel::V2", "kernel::V3", "kernel::V4"}
# Skinning's spans and counters (ops/skin.Skinner), the counters every frame.
SKIN_SPANS = {"skin::layout", "skin::palette", "skin::apply"}
SKIN_COUNTERS = {"skin.vertices", "skin.skeletons", "skin.layout_builds", "upload.skin_bytes"}
SETTINGS = BaseRenderGraphSettings(ambient_color=(0.08, 0.08, 0.1, 1.0))
# The extension features' spans (the verdict's on the card only) and
# counters, the counters every frame.
FEATURE_SPANS = {"sky::background", "routines::shadows", "routines::shade", "passes::hdr", "passes::srgb"}
FEATURE_COUNTERS = {"sky.queries", "routines.archetypes", "passes.run"}


@pytest.fixture(autouse=True)
def _tracing_off():
    profiling.disable()
    yield
    profiling.disable()


def _busy(ms):
    t = time.perf_counter()
    while time.perf_counter() - t < ms / 1e3:
        pass


def test_nested_spans_parent_frame_and_self_time(tmp_path):
    profiling.enable()
    with profiling.scope("Renderer::evaluate_instructions"):
        pass
    for _ in range(2):
        with profiling.scope(profiling.ROOT):
            _busy(2)
            with profiling.scope("graph::clip"):
                _busy(3)
                with profiling.scope("sync::clip.crossing"):
                    _busy(2)
            with profiling.scope("graph::setup"):
                _busy(1)
    profiling.disable()
    s = profiling.stats()
    assert s.frames == 2 and s.counts[profiling.ROOT] == 2 and s.counts["sync::clip.crossing"] == 2
    for name, children in ((profiling.ROOT, ("graph::clip", "graph::setup")), ("graph::clip", ("sync::clip.crossing",))):
        assert s.self_ms[name] == pytest.approx(s.totals_ms[name] - sum(s.totals_ms[c] for c in children), abs=1e-6)
    assert s.self_ms["sync::clip.crossing"] == s.totals_ms["sync::clip.crossing"] >= 4.0
    assert 2 * 2.0 <= s.self_ms[profiling.ROOT] < s.totals_ms[profiling.ROOT]
    assert "ms self" in s.summary()

    path = tmp_path / "trace.json"
    profiling.dump_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e["ph"] == "X"]
    by_name = {}
    for i, e in enumerate(events):
        by_name.setdefault(e["name"], []).append(i)
    assert events[0]["args"] == {"frame": None, "parent": -1}
    for frame, (root, clip, sync, setup) in enumerate(zip(*(by_name[n] for n in (
            profiling.ROOT, "graph::clip", "sync::clip.crossing", "graph::setup")))):
        assert events[root]["args"] == {"frame": frame, "parent": -1}
        assert events[clip]["args"] == {"frame": frame, "parent": root}
        assert events[sync]["args"] == {"frame": frame, "parent": clip}
        assert events[setup]["args"] == {"frame": frame, "parent": root}
        assert events[root]["ts"] <= events[clip]["ts"] <= events[sync]["ts"]
        assert events[sync]["ts"] + events[sync]["dur"] <= events[root]["ts"] + events[root]["dur"]
    # Wall-clock microseconds, as torch.profiler's chrome traces are.
    assert abs(events[0]["ts"] / 1e6 - time.time()) < 60


def test_off_records_nothing_and_makes_no_object():
    profiling.enable()
    profiling.disable()
    scopes = [profiling.scope(n) for n in ("graph::clip", "sync::bin.pairs", "kernel::F1", profiling.ROOT)]
    assert all(s is scopes[0] for s in scopes)
    assert not hasattr(scopes[0], "gen") and not hasattr(scopes[0], "__dict__")
    for _ in range(3):
        with profiling.scope(profiling.ROOT), profiling.scope("sync::bin.pairs"):
            assert profiling.current() is None
        profiling.count("shadow_cache.hit")
    s = profiling.stats()
    assert not s.totals_ms and not s.counters and s.frames == 0


def test_counters_reset_at_enable():
    profiling.enable()
    profiling.count("shadow_cache.hit")
    profiling.count("shadow_cache.hit", 2)
    profiling.disable()
    profiling.count("shadow_cache.hit")  # off: not counted
    assert profiling.stats().counters == {"shadow_cache.hit": 3}
    profiling.enable()
    assert profiling.stats().counters == {} and not profiling.stats().totals_ms
    profiling.count("shadow_cache.miss")
    profiling.disable()
    assert profiling.stats().counters == {"shadow_cache.miss": 1}


def _city(width=128, height=64):
    runner = TestRunner(device="cpu")
    keep = scenes.build_city_scene(runner, n_buildings=12, seed=7, subdiv=1, representative=True)
    scenes.set_bench_camera(runner, width, height)
    objects = [h for h in keep if getattr(h, "kind", None) == "object"]
    return runner, keep, objects, FrameRenderTarget(width, height, 1)


def _frame(runner, target):
    runner.renderer.swap_instruction_buffers()
    ev = runner.renderer.evaluate_instructions()
    return runner.base_graph.render_frame_tensor(ev, target, SETTINGS)


@pytest.fixture(scope="module")
def city():
    torch.set_num_threads(1)
    runner, keep, objects, target = _city()
    _frame(runner, target)  # uploads every table
    return runner, keep, objects, target


def test_device_trace_holds_every_program_span(city, tmp_path):
    runner, _keep, _objects, target = city
    profiling.enable()
    with profiling.device_trace(str(tmp_path)):
        _frame(runner, target)
    profiling.disable()
    names = set(profiling.stats().totals_ms)
    assert {profiling.ROOT, "graph::clip", "graph::lighting", "sync::hiz.visible"} <= names
    trace = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ranges = {e["name"] for e in trace if e.get("ph") == "X"}
    assert names <= ranges, names - ranges
    assert not any(n.startswith(("stage:", "host:")) for n in names)
    assert isinstance(json.loads((tmp_path / "spans.json").read_text()), dict)


def test_static_frames_count_the_same_sync_sites(city, tmp_path):
    runner, _keep, _objects, target = city
    profiling.enable()
    for _ in range(2):
        _frame(runner, target)
    profiling.disable()
    profiling.dump_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    per_frame = [{}, {}]
    for e in events:
        if e["ph"] == "X" and e["name"].startswith("sync::"):
            sites = per_frame[e["args"]["frame"]]
            sites[e["name"]] = sites.get(e["name"], 0) + 1
    assert per_frame[0] == per_frame[1]
    assert sum(per_frame[0].values()) > 0
    assert set(per_frame[0]) <= SYNC_SITES, set(per_frame[0]) - SYNC_SITES
    assert {"sync::hiz.visible", "sync::cut.layers", "sync::cut.pixels", "sync::blend.pixels",
            "sync::upload.uniforms"} <= set(per_frame[0])


def test_shadow_cache_hits_then_misses_after_a_move(city):
    runner, _keep, objects, target = city
    def counters():
        c = profiling.stats().counters
        return {k: v for k, v in c.items() if k.startswith("shadow_cache.")}, c

    profiling.enable()
    _frame(runner, target)
    _frame(runner, target)
    shadow, c = counters()
    assert shadow == {"shadow_cache.hit": 2}
    assert c["objects.transforms"] == 0 and c["upload.object_bytes"] == 0  # the object caches hold too
    runner.renderer.set_object_transform(objects[0], m3.translation([3.0, 2.0, 1.0]) @ m3.scale(2.0))
    _frame(runner, target)
    profiling.disable()
    shadow, c = counters()
    assert shadow == {"shadow_cache.hit": 2, "shadow_cache.miss": 1}
    assert c["objects.transforms"] == 1 and c["upload.object_bytes"] > 0


def test_a_move_keeps_the_cutout_mask(city):
    """The cutout mask over the triangle table reads the objects' materials,
    not their transforms: a moved object copies the object tables again but
    gathers no new mask."""
    runner, _keep, objects, target = city
    graph = runner.base_graph
    _frame(runner, target)
    mask = graph._cut_dev
    assert mask is not None and bool(mask.any())
    om = runner.renderer.object_manager
    runner.renderer.set_object_transform(objects[1], m3.translation([-3.0, 2.0, 1.0]) @ m3.scale(2.0))
    profiling.enable()
    _frame(runner, target)
    profiling.disable()
    assert graph._cut_dev is mask
    assert profiling.stats().counters["upload.object_bytes"] == om.transforms.nbytes + om.bases.nbytes + om.cap * 4


def test_frame_without_skeletons_counts_no_skinning(city):
    runner, _keep, _objects, target = city
    profiling.enable()
    _frame(runner, target)
    profiling.disable()
    s = profiling.stats()
    assert {k: s.counters[k] for k in SKIN_COUNTERS} == dict.fromkeys(SKIN_COUNTERS, 0)
    assert not SKIN_SPANS & set(s.counts)


def test_skinned_frame_spans_nest_in_the_frame(tmp_path):
    runner = TestRunner(device="cpu")
    keep, _skeletons = scenes.skinned_columns(runner)
    profiling.enable()
    _frame(runner, FrameRenderTarget(32, 32, 1))
    profiling.disable()
    s = profiling.stats()
    assert SKIN_SPANS <= set(s.counts) and s.counters["skin.layout_builds"] == 1
    assert s.counters["skin.skeletons"] == 3 and s.counters["skin.vertices"] == 3 * 150
    profiling.dump_chrome_trace(str(tmp_path / "trace.json"))
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"] if e["ph"] == "X"]
    by_name = {e["name"]: e for e in events}
    for name in SKIN_SPANS:
        assert by_name[name]["args"]["frame"] == 0, name
    upload = [e for e in events if e["name"] == "sync::upload.skin"]
    assert any(events[e["args"]["parent"]]["name"] == "skin::palette" for e in upload)
    del keep


def test_city_frame_counts_no_feature(city):
    runner, _keep, _objects, target = city
    profiling.enable()
    _frame(runner, target)
    profiling.disable()
    s = profiling.stats()
    assert {k: s.counters[k] for k in FEATURE_COUNTERS} == dict.fromkeys(FEATURE_COUNTERS, 0)
    assert not (FEATURE_SPANS | {"routines::verdict"}) & set(s.counts)


def _feature_city(device, width, height):
    runner = TestRunner(device=device)
    keep, extra = scenes.feature_city(runner, n_buildings=12 if device == "cpu" else 48, sky_size=16, n_columns=2)
    scenes.set_bench_camera(runner, width, height)
    return runner, keep, extra, FrameRenderTarget(width, height, 1)


def _feature_frame(runner, extra, target):
    runner.renderer.swap_instruction_buffers()
    ev = runner.renderer.evaluate_instructions()
    return runner.base_graph.render_frame_tensor(ev, target, SETTINGS, skybox_slot=extra["sky"].idx)


def _feature_counts(s, target) -> None:
    """A feature frame's counters and spans: K4's sky queries over the
    padded frame, three archetypes, a routine shade call at least, both
    passes once."""
    from rend3_tpu_torch.ops import deferred

    hp, wp = (-(-v // t) * t for v, t in ((target.height, deferred.DTILE_H), (target.width, deferred.DTILE_W)))
    assert s.counters["sky.queries"] == hp * wp
    assert s.counters["routines.archetypes"] == 3 and s.counts["routines::shade"] >= 1
    assert s.counters["passes.run"] == 2
    assert FEATURE_SPANS <= set(s.counts) and s.counts["passes::hdr"] == s.counts["passes::srgb"] == 1


def test_feature_frame_counts_and_spans(tmp_path):
    runner, keep, extra, target = _feature_city("cpu", 128, 64)
    profiling.enable()
    _feature_frame(runner, extra, target)
    profiling.disable()
    s = profiling.stats()
    _feature_counts(s, target)
    assert "routines::verdict" not in s.counts  # on the CPU the chain tests the routine's alpha itself
    profiling.dump_chrome_trace(str(tmp_path / "trace.json"))
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"] if e["ph"] == "X"]
    for e in events:
        if e["name"] in FEATURE_SPANS:
            assert e["args"]["frame"] == 0, e["name"]
    del keep


def test_cpu_frame_counts_no_card_table(city):
    """On the CPU the view's front end is the plain version: no
    view_front.tables, no kernel::V* span, and none of the chain's reads."""
    runner, _keep, _objects, target = city
    profiling.enable()
    _frame(runner, target)
    profiling.disable()
    s = profiling.stats()
    assert "view_front.tables" not in s.counters
    assert not VIEW_KERNEL_SPANS & set(s.counts)
    assert not {"sync::setup.survivors", "sync::clip.crossing", "sync::bin.candidates", "sync::bin.pairs",
                "sync::bin.tile_counts"} & set(s.counts)
    assert s.counts["graph::setup"] == 1 and s.counts["sync::hiz.visible"] >= 1


def _card_counts(runner, target):
    profiling.enable()
    _frame(runner, target)
    profiling.disable()
    torch.cuda.synchronize()
    return profiling.stats()


@pytest.mark.cuda
def test_card_view_front_spans_and_tables():
    """On the card, a city frame with occlusion on builds its four tables
    with V1-V4 (main, residual, cutout, blend: view_front.tables 4; the
    residual cull runs and counts on the first frame too, whose set is
    empty), with the kernel::V1-V4 spans, a crossing read per clipped set
    (main, blend) and a totals read per table, and none of the chain's
    reads; a frame of tools/bench_host's cube lattice (no cutout, no blend)
    builds two."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rend3_tpu_torch.tools import bench_host

    runner = TestRunner(device="cuda")
    keep = scenes.build_city_scene(runner, n_buildings=48, seed=7, representative=True)
    scenes.set_bench_camera(runner, 512, 256)
    target = FrameRenderTarget(512, 256, 1)
    for _ in range(2):
        s = _card_counts(runner, target)
        assert s.counters["view_front.tables"] == 4
        assert VIEW_KERNEL_SPANS <= set(s.counts)
        assert s.counts["sync::view_front.crossing"] == 2 and s.counts["sync::view_front.totals"] == 4
        assert not {"sync::setup.survivors", "sync::clip.crossing", "sync::bin.pairs", "sync::bin.candidates",
                    "sync::const.planes_defaults", "sync::const.setup_height"} & set(s.counts)
    del keep
    lattice = TestRunner(device="cuda")
    keep = bench_host.build_scene(lattice, 300)
    s = _card_counts(lattice, FrameRenderTarget(320, 180, 1))
    assert s.counters["view_front.tables"] == 2 and s.counts["sync::view_front.crossing"] == 1
    del keep


@pytest.mark.cuda
def test_every_card_sync_is_inside_a_sync_span():
    """Static, camera-moving and object-moving frames of the representative
    city on the card, PyTorch's sync debug mode on: each synchronizing call
    (a device read, a stream-synchronizing upload) warns, and the innermost
    span open at each warning must be a sync:: span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    runner = TestRunner(device="cuda")
    keep = scenes.build_city_scene(runner, n_buildings=48, seed=7, representative=True)
    objects = [h for h in keep if getattr(h, "kind", None) == "object"]
    scenes.set_bench_camera(runner, 512, 256)
    target = FrameRenderTarget(512, 256, 1)
    found = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" not in str(message):
            return  # the debug mode's own notice
        stack = [f"{fr.filename}:{fr.lineno} {fr.name}" for fr in traceback.extract_stack()[-6:-1]]
        found.append((profiling.current(), str(message)[:80], stack))

    moves = {
        "first": lambda: None,
        "static": lambda: None,
        "camera": lambda: runner.set_camera_data(Camera(
            projection=Perspective(vfov=60.0, near=0.1),
            view=m3.look_at_lh([35.0, 25.0, -55.0], [0.0, 4.0, 0.0], [0.0, 1.0, 0.0]))),
        "objects": lambda: [runner.renderer.set_object_transform(o, m3.translation([2.0 * k, 3.0, 1.0]))
                            for k, o in enumerate(objects[:8])],
    }
    outside = {}
    for kind, move in moves.items():
        move()
        found.clear()
        profiling.enable()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            old, warnings.showwarning = warnings.showwarning, show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                _frame(runner, target)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                warnings.showwarning = old
        profiling.disable()
        torch.cuda.synchronize()
        assert found, kind
        outside[kind] = [(span, msg, stack) for span, msg, stack in found
                         if span is None or not span.startswith("sync::")]
    del keep
    assert not any(outside.values()), {k: v[:3] for k, v in outside.items() if v}


def _sync_sites(runner, render) -> dict:
    """{sync:: site: calls} of one frame."""
    profiling.enable()
    render()
    profiling.disable()
    torch.cuda.synchronize()
    return {k: v for k, v in profiling.stats().counts.items() if k.startswith("sync::")}


@pytest.mark.cuda
def test_card_feature_counters_and_syncs(monkeypatch):
    """On the card the feature counters read 0 on a city frame and count
    the feature frame's sky, routines (the cutout routine's verdict under
    routines::verdict) and passes; the new spans hold no
    host read: a frame's sync:: sites are the same with the spans as with
    them replaced by no-ops, on the city and on the feature city."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rend3_tpu_torch.ops import lighting
    from rend3_tpu_torch.routine import base

    runner = TestRunner(device="cuda")
    keep = scenes.build_city_scene(runner, n_buildings=48, seed=7, representative=True)
    scenes.set_bench_camera(runner, 512, 256)
    target = FrameRenderTarget(512, 256, 1)
    s = _card_counts(runner, target)
    assert {k: s.counters[k] for k in FEATURE_COUNTERS} == dict.fromkeys(FEATURE_COUNTERS, 0)
    assert not (FEATURE_SPANS | {"routines::verdict"}) & set(s.counts)
    feat, fkeep, extra, ftarget = _feature_city("cuda", 512, 256)
    _feature_frame(feat, extra, ftarget)
    profiling.enable()
    _feature_frame(feat, extra, ftarget)
    profiling.disable()
    torch.cuda.synchronize()
    s = profiling.stats()
    _feature_counts(s, ftarget)
    assert s.counts["routines::verdict"] >= 1
    frames = {"city": lambda: _frame(runner, target), "features": lambda: _feature_frame(feat, extra, ftarget)}
    with_spans = {k: _sync_sites(None, f) for k, f in frames.items()}
    new = FEATURE_SPANS | {"routines::verdict"}
    for mod in (base, lighting):
        orig = mod.profiling_scope
        monkeypatch.setattr(mod, "profiling_scope",
                            lambda name, orig=orig: profiling._OFF if name in new else orig(name))
    without = {k: _sync_sites(None, f) for k, f in frames.items()}
    assert with_spans == without and all(with_spans.values())
    del keep, fkeep

