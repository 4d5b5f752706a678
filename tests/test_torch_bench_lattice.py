"""The benchmark's 50,000-object configuration (benchmark/generators/lattice.py,
host-50k-objects) and the object path's spans and counters, on the CPU.

- The generator at full size: 50,000 instances of the host micro-bench's
  cube (its arrays, rend3_tpu_torch/tools/bench_host.py), 600,000
  triangles, on the tool's 37^3 lattice order, moved to the origin; the
  same arrays for every seed. The cell's mix picks 2,500 movers that stay
  clear of their neighbours, and the light's box holds the whole lattice
  from every camera of the loop.
- The cell at a small size (512 objects, 160x90, a 256^2 map; the copied
  configuration cut, and the mix with it: heights that look at the small
  lattice, 26 movers, the cell's 5%, where the test root keeps 4, so that a
  dropped transform shows on every frame, 4-14% of the pixels, and not on
  some): correct against benchmark/reference.py, and refused when the port
  drops the movers' transforms.
- The counters at 300 objects: objects.transforms the transforms applied,
  objects.live the live objects, objects.visible the camera frustum mask's
  sum, upload.object_bytes the object tables' bytes on a moving frame and 0
  on a static one; one objects::evaluate span per run of object
  instructions.
- The readers object_evaluate_ms, object_upload_ms and object_upload_kb: a
  value from the spans and counters, None where a program records none.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import adapter, harness, reference, scene, traffic
from benchmark.generators import lattice
from benchmark.tests import tinyroot
from rend3_tpu_torch.routine.base import BaseRenderGraph
from rend3_tpu_torch.tools import bench_host
from rend3_tpu_torch.utils import profiling

CELL = "host-50k-objects.orbit-movers"
REPO = tinyroot.REPO


def _config():
    with open(os.path.join(REPO, "benchmark", "configs", "host-50k-objects.json")) as f:
        return json.load(f)


def _mix():
    with open(os.path.join(REPO, "benchmark", "mixes", "orbit-movers.json")) as f:
        return json.load(f)


@pytest.fixture(autouse=True)
def _tracing_off():
    profiling.disable()
    yield
    profiling.disable()


@pytest.fixture(scope="module")
def full():
    return lattice.build_scene(_config(), 2**33 + 5)


def test_full_size_lattice(full):
    np.testing.assert_array_equal(lattice.CUBE_POSITIONS, bench_host.CUBE_POSITIONS)
    np.testing.assert_array_equal(lattice.CUBE_INDICES.reshape(-1), bench_host.CUBE_INDICES)
    assert len(full.transforms) == len(full.buildings) == 50_000 and full.triangles() == 600_000
    assert full.half_width == 37.0 and len(full.lights) == 1 and len(full.materials) == 4
    pos = np.stack([t[:3, 3] for t in full.transforms])
    i = np.arange(50_000)
    np.testing.assert_array_equal(pos, np.stack([(i % 37) * 2.0 - 36.0, ((i // 37) % 37) * 2.0,
                                                 (i // 37**2) * 2.0 - 36.0], 1).astype(np.float32))
    np.testing.assert_array_equal(full.transforms[7][:3, :3], 0.4 * np.eye(3, dtype=np.float32))
    assert full.obj_material[:6] == [0, 1, 2, 3, 0, 1]
    np.testing.assert_allclose(full.materials[3].albedo, [0.5, 0.8, 0.5, 1.0], rtol=1e-6)
    assert full.buildings[40] == (40, tuple(float(v) for v in pos[40]), 0.4)
    assert full.meshes[0].uv0 is None
    np.testing.assert_array_equal(full.meshes[0].normals,
                                  scene.smooth_normals(lattice.CUBE_POSITIONS, lattice.CUBE_INDICES))
    other = lattice.build_scene(_config(), 3)
    assert all(np.array_equal(a, b) for a, b in zip(full.transforms, other.transforms))
    assert full.obj_material == other.obj_material and full.buildings == other.buildings


def test_mix_movers_and_light_box(full):
    mix, light = _mix(), full.lights[0]
    a, b = traffic.Traffic(mix, full, 2**33 + 9), traffic.Traffic(mix, full, 2**33 + 9)
    assert a.period == 240 and len(a.moved(0)) == 2_500
    assert [oi for oi, _m in a.moved(5)] == [oi for oi, _m in b.moved(5)]
    np.testing.assert_array_equal(a.transforms(17), b.transforms(17))
    # A mover's circle (0.5 m) keeps its cube (0.4 m) clear of the next one, 2 m on.
    assert mix["movers"]["radius"] + 0.4 < 2.0 - 0.4
    pos = np.stack([t[:3, 3] for t in full.transforms])
    lo, hi = pos.min(0) - 0.4, pos.max(0) + 0.4
    corners = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
    for f in range(0, a.period, 3):
        vp = reference.shadow_view_proj(light.direction, light.distance, light.resolution, a.view(f))
        ndc = (vp @ np.concatenate([corners, np.ones((8, 1))], 1).T).T
        assert np.all(np.abs(ndc[:, :2]) <= 1.0) and np.all((ndc[:, 2] >= 0) & (ndc[:, 2] <= 1)), f
        eye = a.camera(f)[0]
        assert np.linalg.norm(eye - np.clip(eye, lo, hi)) > 1.0  # the camera stays outside the lattice


def _small_root(tmp_path):
    root = tinyroot.make(tmp_path)
    path = os.path.join(root, "benchmark", "configs", "host-50k-objects.json")
    with open(path) as f:
        config = json.load(f)
    config["scene"]["n_objects"] = 512
    with open(path, "w") as f:
        json.dump(config, f)
    path = os.path.join(root, "benchmark", "mixes", "orbit-movers.json")
    with open(path) as f:
        mix = json.load(f)
    mix["camera"].update(height=[2.0, 16.0], target_height=[3.0, 11.0], target_radius=2.0)
    mix["movers"]["count"] = 26
    with open(path, "w") as f:
        json.dump(mix, f)
    return root


@pytest.mark.parametrize("fault", [False, True], ids=["sound", "transforms_dropped"])
def test_small_lattice_cell(tmp_path, monkeypatch, fault):
    torch.set_num_threads(2)
    root = _small_root(tmp_path)
    if fault:
        from rend3_tpu_torch.core.renderer import Renderer

        monkeypatch.setattr(Renderer, "set_object_transform", lambda self, handle, transform: None)
    # This suite's conftest loads JAX for the parity tests before any run:
    # the run is held to loading none of it itself.
    before = set(harness.forbidden_modules())
    orig = harness.forbidden_modules
    monkeypatch.setattr(harness, "forbidden_modules", lambda: sorted(set(orig()) - before))
    # The seed's checked frames are 1 and 3, inside the window unless the
    # machine is loaded; the window's last frame is checked in any case.
    result = harness.run_cell(root, CELL, 2**34 + 78, 1.0, False, device="cpu")
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["correct"] != fault, result["check"]


def _counting_port(k):
    config = _config()
    config.update(width=64, height=36)
    config["scene"]["n_objects"] = 300
    config["scene"]["lights"][0]["resolution"] = 64
    config["camera"].update(eye=[2.0, 5.0, -8.0], target=[2.0, 5.0, 0.0])
    sc = lattice.build_scene(config, 1)
    mix = {"camera": {"path": "fixed"}, "movers": {"count": k, "radius": 0.5, "frames_per_turn": 120},
           "warmup_frames": 1}
    return adapter.Port(sc, traffic.Traffic(mix, sc, 2**33 + 1), "cpu")


def test_object_counters(monkeypatch):
    torch.set_num_threads(2)
    k = 7
    port = _counting_port(k)
    frames = []
    orig = BaseRenderGraph._upload

    def upload(self, *a, **kw):
        frames.append(orig(self, *a, **kw))
        return frames[-1]

    monkeypatch.setattr(BaseRenderGraph, "_upload", upload)
    port.frame(0)
    om = port.renderer.object_manager

    def traced(frame):
        profiling.enable()
        port.frame(frame)
        profiling.disable()
        return profiling.stats()

    moving = traced(1)
    visible = int(frames[-1].visible.sum())
    assert moving.counters["objects.transforms"] == k and moving.counts["objects::evaluate"] == 1
    assert moving.counters["objects.live"] == 300
    assert moving.counters["objects.visible"] == visible and 0 < visible < 300
    table = om.transforms.nbytes + om.bases.nbytes + om.cap * 4  # transforms, bases, material slots
    assert moving.counters["upload.object_bytes"] == table
    assert moving.counts["upload::objects"] == 1

    port.traffic.movers = []  # nothing changes: every cache holds
    static = traced(2)
    assert static.counters["objects.transforms"] == 0 and "objects::evaluate" not in static.counts
    assert static.counters["upload.object_bytes"] == 0 and static.counts["upload::objects"] == 1
    assert static.counters["objects.visible"] == visible


def test_object_spans_follow_runs_of_object_instructions():
    """Object instructions between two others are one run: a span each,
    whatever else the frame carries, and a delete's reclaim one more."""
    port = _counting_port(0)
    r = port.renderer
    r.swap_instruction_buffers()
    r.evaluate_instructions()
    eye = np.eye(4, dtype=np.float32)
    r.set_object_transform(port.objects[0], eye)
    r.set_object_transform(port.objects[1], eye)
    port.set_camera(port.traffic.view(0))
    r.set_object_transform(port.objects[2], eye)
    port.objects[3] = None  # the handle's last reference: a delete instruction
    profiling.enable()
    r.swap_instruction_buffers()
    r.evaluate_instructions()
    r.swap_instruction_buffers()
    r.evaluate_instructions()  # reclaims the deleted slot
    profiling.disable()
    s = profiling.stats()
    assert s.counters["objects.transforms"] == 3 and s.counts["objects::evaluate"] == 3
    om = r.object_manager
    assert 3 not in om.data and not om.enabled[3] and om.enabled[4]
    np.testing.assert_array_equal(om.transforms[:3], np.stack([eye] * 3))


READERS = ("object_evaluate_ms", "object_upload_ms", "object_upload_kb")


def _ctx(stats, frames=2):
    return {"frames": frames, "frame_s": [0.1] * frames, "scene_s": [0.01] * frames, "plain_s": [],
            "stages_ms": {}, "scopes_ms": dict(stats.totals_ms), "profile": None}


def _record(with_objects: bool):
    """Two traced frames; with_objects: the object path's spans and counters
    (3 transforms, then none; 6,000 bytes, then none)."""
    profiling.enable()
    try:
        for frame in range(2):
            with profiling.scope(profiling.ROOT):
                with profiling.scope("BaseRenderGraph::build_frame_callable"):
                    if with_objects:
                        with profiling.scope("upload::objects"):
                            profiling.count("upload.object_bytes", 6000 if frame == 0 else 0)
            if with_objects:
                if frame == 0:
                    with profiling.scope("objects::evaluate"):
                        pass
                profiling.count("objects.transforms", 3 if frame == 0 else 0)
    finally:
        profiling.disable()
    return profiling.stats()


def test_object_readers_read_the_spans_and_counters():
    ctx = _ctx(_record(True))
    read = {name: harness.load_metric(REPO, name).read for name in READERS}
    assert read["object_evaluate_ms"](ctx) == pytest.approx(ctx["scopes_ms"]["objects::evaluate"] / 2)
    assert read["object_upload_ms"](ctx) == pytest.approx(ctx["scopes_ms"]["upload::objects"] / 2)
    assert 0.0 < read["object_upload_ms"](ctx) < ctx["scopes_ms"][profiling.ROOT] / 2
    assert read["object_upload_kb"](ctx) == pytest.approx(6000 / 2 / 1024)


def test_object_evaluate_reads_zero_without_object_instructions():
    profiling.enable()
    profiling.count("objects.transforms", 0)
    profiling.disable()
    ctx = _ctx(profiling.stats())
    assert harness.load_metric(REPO, "object_evaluate_ms").read(ctx) == 0.0


@pytest.mark.parametrize("name", READERS)
def test_object_readers_find_nothing_without_the_spans(name):
    """A program without the object path's spans and counters reads None, and
    so does a run with no traced frame."""
    ctx = _ctx(_record(False))
    reader = harness.load_metric(REPO, name)
    assert reader.read(ctx) is None
    assert reader.read({**_ctx(_record(True)), "frames": 0}) is None
