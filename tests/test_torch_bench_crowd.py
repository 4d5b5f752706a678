"""The benchmark's crowd configuration (benchmark/generators/crowd.py,
crowd-city-1080p) and skinning's readers, on the CPU.

- The generator at full size: the Bistro proxy city and 1,024 pedestrians
  on one 65-joint rig in Mixamo's topology, 2,560 vertices and 4,864
  triangles a pedestrian, each vertex weighted to 4 joints (its bone's,
  that joint's parent and grandparent, the bone's end) summing to 1; the
  spots clear of every building and 1.5 m apart; the same arrays for every
  run seed.
- The mix: the walk a function of the seed and the frame (480-frame
  period, 60-frame cycle), each pedestrian on its circle facing along it,
  every circle clear of the buildings by the body's reach; the vectorised
  joint globals against a loop over the joints; every posed vertex of the
  cycle inside the mesh's rest-pose bounding sphere, which the port's
  frustum test uses; the check's close-up views drawn from the seed, each
  a pedestrian's chest seen from its distance over a sight line no
  building crosses.
- The reference's skinning against the port's skinned arenas.
- The cell at a small size (8 pedestrians, 160x90, four flat buildings and
  a fixed camera; the copied configuration and mix cut): correct against
  the generator's Reference, and refused when the port drops the poses,
  also where the cell's camera sees no pedestrian (the close-ups refuse
  it).
- The readers skinning_ms and skin_upload_kb: values from the spans and
  counters, 0 where nothing was skinned, None where a program records none.
- The generator and its Reference load nothing of the port or of JAX.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark import scene as S
from benchmark.generators import crowd
from benchmark.tests import tinyroot
from rend3_tpu_torch.utils import profiling
from rend3_tpu_torch.utils.math import BoundingSphere

CELL = "crowd-city-1080p.crowd-walk"
REPO = tinyroot.REPO


def _config():
    with open(os.path.join(REPO, "benchmark", "configs", "crowd-city-1080p.json")) as f:
        return json.load(f)


def _mix():
    with open(os.path.join(REPO, "benchmark", "mixes", "crowd-walk.json")) as f:
        return json.load(f)


@pytest.fixture(autouse=True)
def _tracing_off():
    profiling.disable()
    yield
    profiling.disable()


@pytest.fixture(scope="module")
def full():
    return crowd.build_scene(_config(), 2**33 + 5)


def test_full_size_crowd(full):
    with open(os.path.join(REPO, "benchmark", "configs", "bistro-proxy-1080p.json")) as f:
        assert _config()["scene"] == json.load(f)["scene"]
    rg, mesh = full.rig, full.meshes[full.mesh]
    assert len(rg.names) == 65 and rg.names[:7] == ["Hips", "Spine", "Spine1", "Spine2", "Neck", "Head",
                                                    "HeadTop_End"]
    assert sum(n.startswith("LeftHand") for n in rg.names) == 21 and "RightToe_End" in rg.names
    assert rg.rest[:, 1].max() == pytest.approx(1.75)
    np.testing.assert_array_equal(rg.inverse_binds[:, :3, 3], -rg.rest)
    assert mesh.positions.shape == (2560, 3) and mesh.indices.shape == (4864, 3)
    np.testing.assert_array_equal(mesh.normals, S.smooth_normals(mesh.positions, mesh.indices))
    assert full.pedestrians == 1024 and full.triangles() == 121_426 + 1024 * 4864
    w, j = full.weights, full.joint_ids
    assert w.shape == j.shape == (2560, 4) and np.all(w >= 0) and np.all((w > 0).sum(1) <= 4)
    np.testing.assert_array_equal(w.sum(1), 1.0)
    assert (w > 0).sum(1).max() == 4 and (w[:, 0] >= 0.5).all()
    # Slot 0 is the bone's joint; then its parent, the bone's end (a child
    # of slot 0) and the grandparent, where the rig has them.
    for slot, up in ((1, 1), (3, 2)):
        used = w[:, slot] > 0
        anc = j[used, 0]
        for _ in range(up):
            anc = rg.parents[anc]
        np.testing.assert_array_equal(anc, j[used, slot])
    np.testing.assert_array_equal(rg.parents[j[:, 2]], j[:, 0])
    pos = np.stack([t[:3, 3] for t in full.transforms[full.first:]])
    np.testing.assert_array_equal(pos[:, [0, 2]], full.spots)
    assert np.all(np.hypot(full.spots[:, 0], full.spots[:, 1]) <= 60.0)
    gap = np.linalg.norm(full.spots[:, None] - full.spots[None], axis=-1) + 1e9 * np.eye(1024)
    assert gap.min() >= 1.5
    for _oi, (x, _h, z), (wx, _hy, _wz) in full.buildings:
        d = np.hypot(np.maximum(np.abs(full.spots[:, 0] - x) - wx, 0), np.maximum(np.abs(full.spots[:, 1] - z) - wx, 0))
        assert d.min() >= 1.1
        assert np.all(full.clear <= d + 1e-5)
    assert full.obj_material[full.first:full.first + 9] == [full.material + k for k in (0, 1, 2, 3, 4, 5, 6, 7, 0)]
    other = crowd.build_scene(_config(), 3)
    np.testing.assert_array_equal(other.spots, full.spots)
    np.testing.assert_array_equal(other.meshes[other.mesh].positions, mesh.positions)
    np.testing.assert_array_equal(other.joint_ids, j)


def _loop_globals(rg, phase: float, frame: int, cycle: int) -> np.ndarray:
    """(J, 4, 4) globals of one pedestrian, a joint at a time from POSE."""
    phi = phase + 2 * np.pi * (frame % cycle) / cycle
    out = []
    for j, (name, _parent, offset, _r) in enumerate(crowd.RIG):
        sx, key = 0.0, name
        for side, v in (("Left", 1.0), ("Right", -1.0)):
            if name.startswith(side):
                sx, key = v, "S" + name[len(side):]
        key = "SHandF" if key.startswith("SHand") and key != "SHand" else key
        rot = np.eye(4)
        for axis, base, amp, wave, off in crowd.POSE[key]:
            sign = sx if sx and axis in "yz" else 1.0
            x = phi + 2 * np.pi * (off + (0.5 if sx < 0 else 0.0))
            a = math.radians(base + amp * (math.sin(x) if wave == "sin" else 0.5 * (1 - math.cos(x)))) * sign
            c, s = math.cos(a), math.sin(a)
            rot = rot @ {"x": S.rotation_x(a), "y": S.rotation_y(a),
                         "z": np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])}[axis]
        local = S.translation(offset) @ rot
        p = rg.parents[j]
        out.append(local if p < 0 else out[p] @ local)
    return np.stack(out)


def test_mix_walks_by_seed_and_frame(full):
    mix = _mix()
    a, b = crowd.Traffic(mix, full, 2**33 + 9), crowd.Traffic(mix, full, 2**33 + 9)
    c = crowd.Traffic(mix, full, 4)
    assert a.period == 480 and a.moves_camera
    np.testing.assert_array_equal(a.walkers(17), b.walkers(17))
    np.testing.assert_array_equal(a.joint_globals(17), b.joint_globals(17))
    assert not np.array_equal(a.walkers(17), c.walkers(17)) and not np.array_equal(a.radius, c.radius)
    assert np.all((a.radius >= 0.6) & (a.radius <= 3.0)) and (a.radius > 1.5).any()
    # No walk comes nearer a building than the body's reach.
    assert np.all(a.radius <= full.clear - mix["walk"]["margin"] + 1e-6)
    ring = np.concatenate([a.walkers(f)[:, [0, 2], 3] for f in range(0, 480, 24)])
    assert crowd.clearance(full.buildings, ring).min() >= mix["walk"]["margin"] - 1e-4
    np.testing.assert_array_equal(a.walkers(5), a.walkers(5 + 480))
    np.testing.assert_array_equal(a.joint_globals(5), a.joint_globals(65))
    assert not np.array_equal(a.joint_globals(5), a.joint_globals(6))
    m0, m1 = a.walkers(40), a.walkers(41)
    np.testing.assert_allclose(np.hypot(*(m0[:, [0, 2], 3] - full.spots).T), a.radius, rtol=1e-5)
    step = m1[:, :3, 3] - m0[:, :3, 3]
    forward = m0[:, :3, 2]  # the pedestrian's +z
    assert np.all((step * forward).sum(1) > 0.99 * np.linalg.norm(step, axis=1))
    state = a.state(40)
    assert set(state) == {"view", "transforms", "joints", "closeups"} and state["joints"].shape == (1024, 65, 4, 4)
    assert state["closeups"] == []
    np.testing.assert_array_equal(state["transforms"][full.first:], m0)
    for p in (0, 511, 1023):
        np.testing.assert_allclose(a.joint_globals(23)[p], _loop_globals(full.rig, a.phase[p], 23, 60), atol=2e-6)
    # The close-ups: drawn from the seed; each eye `distance` from the
    # pedestrian's chest, `elevation` up, over a sight line clear of every
    # building.
    cu = mix["closeup"]
    views = a.closeup_views()
    assert len(views) == cu["views"] and [v[:2] for v in views] == [v[:2] for v in b.closeup_views()]
    assert [v[:2] for v in views] != [v[:2] for v in c.closeup_views()]
    for frame, p, view in views:
        chest = a.walkers(frame)[p, :3, 3] + [0.0, cu["height"], 0.0]
        eye = np.linalg.inv(view)[:3, 3]
        np.testing.assert_allclose(np.linalg.norm(eye - chest), cu["distance"], rtol=1e-5)
        np.testing.assert_allclose(np.degrees(np.arcsin((eye - chest)[1] / cu["distance"])), cu["elevation"], rtol=1e-4)
        np.testing.assert_allclose((view @ np.append(chest, 1.0))[:2], 0.0, atol=1e-5)
        line = chest[[0, 2]] + np.linspace(0, 1, 32)[:, None] * (eye - chest)[[0, 2]]
        assert crowd.clearance(full.buildings, line).min() >= 0.3


def _reference_skin(scene, tf32=False):
    ref = crowd.Reference.__new__(crowd.Reference)
    ref.dev, ref.tf32 = torch.device("cpu"), tf32
    m = scene.meshes[scene.mesh]
    ref.v_pos, ref.v_nrm, ref.v_idx = (torch.from_numpy(a) for a in (m.positions, m.normals, m.indices))
    ref.joint_ids, ref.weights = torch.from_numpy(scene.joint_ids), torch.from_numpy(scene.weights)
    ref.inverse_binds = torch.from_numpy(scene.rig.inverse_binds)
    return ref


def test_poses_stay_inside_the_rest_sphere(full):
    """The port culls a skinned object by its mesh's rest-pose sphere
    (core/managers/object.py): every posed vertex of the walk cycle lies
    inside it, so no pose is culled at the screen's edge."""
    mesh = full.meshes[full.mesh]
    sphere = BoundingSphere.from_points(mesh.positions)
    traffic = crowd.Traffic(_mix(), full, 2**33 + 9)
    ref = _reference_skin(full)
    worst = 0.0
    for frame in range(0, 60, 3):
        pos, _nrm = ref.skin(traffic.joint_globals(frame)[:64])
        worst = max(worst, float((pos.reshape(-1, 3) - torch.from_numpy(sphere.center)).norm(dim=1).max()))
    assert 0.5 * sphere.radius < worst < sphere.radius


def _small_root(tmp_path, target=(3.0, 1.0, 3.0)):
    root = tinyroot.make(tmp_path)
    path = os.path.join(root, "benchmark", "configs", "crowd-city-1080p.json")
    with open(path) as f:
        config = json.load(f)
    config["crowd"].update(pedestrians=8, area_radius=10.0)
    config["scene"].update(n_buildings=4, representative=False)
    config["camera"].update(eye=[14.0, 6.0, 14.0], target=list(target), vfov=40.0)
    with open(path, "w") as f:
        json.dump(config, f)
    path = os.path.join(root, "benchmark", "mixes", "crowd-walk.json")
    with open(path) as f:
        mix = json.load(f)
    mix["camera"] = {"path": "fixed"}
    with open(path, "w") as f:
        json.dump(mix, f)
    return root


def test_reference_skins_as_the_port_does(tmp_path):
    """The reference's plain skinning against the port's skinned arenas
    (its fma forms) at a pose of the walk: within a few ulps."""
    root = _small_root(tmp_path)
    _cell, config, mix, _e, _p = harness.find_cell(root, harness.load_manifest(root), CELL)
    build_scene, Traffic, Port, _ref = harness.parts(root, config, mix)
    scene = build_scene(config, 5)
    traffic = Traffic(mix, scene, 2**33 + 3)
    port = Port(scene, traffic, "cpu")
    port.apply(31)
    port.evaluate()
    r = port.renderer
    geo = port.graph._skinner(r.mesh_manager.evaluate(), r.skeleton_manager, r.mesh_manager, "cpu")
    want, want_n = _reference_skin(scene).skin(traffic.joint_globals(31))
    idx = torch.from_numpy(scene.meshes[scene.mesh].indices)
    for k, sk in enumerate(port.skeletons):
        rec = r.skeleton_manager.data[sk.idx]
        start, count = rec.override_ranges["position"]
        np.testing.assert_allclose(geo.position[start:start + count][idx], want[k], rtol=0, atol=2e-6)
        start, count = rec.override_ranges["normal"]
        np.testing.assert_allclose(geo.normal[start:start + count][idx], want_n[k], rtol=0, atol=2e-6)
    port.close()


@pytest.mark.parametrize("fault,seen", [(False, True), (True, True), (True, False)],
                         ids=["sound", "poses_dropped", "poses_dropped_unseen"])
def test_small_crowd_cell(tmp_path, monkeypatch, capfd, fault, seen):
    """Unseen: the cell's camera looks away from the crowd, so only the
    close-ups can see the poses."""
    torch.set_num_threads(2)
    root = _small_root(tmp_path, (3.0, 1.0, 3.0) if seen else (40.0, 12.0, 40.0))
    if fault:
        from rend3_tpu_torch.core.renderer import Renderer

        monkeypatch.setattr(Renderer, "set_skeleton_joint_transforms", lambda self, handle, globals_, ib: None)
    before = set(harness.forbidden_modules())
    orig = harness.forbidden_modules
    monkeypatch.setattr(harness, "forbidden_modules", lambda: sorted(set(orig()) - before))
    # The seed's checked frames are 1 and 3, and the window's last.
    result = harness.run_cell(root, CELL, 2**34 + 78, 1.0, False, device="cpu")
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["correct"] != fault, result["check"]
    assert ("close-ups: refused" in capfd.readouterr().err) == fault


READERS = ("skinning_ms", "skin_upload_kb")


def _ctx(stats, frames=2):
    return {"frames": frames, "frame_s": [0.1] * frames, "scene_s": [0.01] * frames, "plain_s": [],
            "stages_ms": {}, "scopes_ms": dict(stats.totals_ms), "profile": None}


def _record(skinned: bool, counted: bool = True):
    """Two traced frames; skinned: the first builds a layout and both upload
    a palette (4096 bytes) and skin 100 vertices; counted: the counters at
    all (0 where nothing is skinned)."""
    profiling.enable()
    try:
        for frame in range(2):
            with profiling.scope(profiling.ROOT):
                if skinned and frame == 0:
                    with profiling.scope("skin::layout"):
                        pass
                if skinned:
                    for name in ("skin::palette", "skin::apply"):
                        with profiling.scope(name):
                            pass
                if counted:
                    profiling.count("skin.vertices", 100 if skinned else 0)
                    profiling.count("upload.skin_bytes", (4096 + (2048 if frame == 0 else 0)) if skinned else 0)
    finally:
        profiling.disable()
    return profiling.stats()


def test_skinning_readers_read_the_spans_and_counters():
    ctx = _ctx(_record(True))
    read = {name: harness.load_metric(REPO, name).read for name in READERS}
    spans = sum(ctx["scopes_ms"][s] for s in ("skin::layout", "skin::palette", "skin::apply"))
    assert read["skinning_ms"](ctx) == pytest.approx(spans / 2) and read["skinning_ms"](ctx) > 0
    assert read["skin_upload_kb"](ctx) == pytest.approx((2 * 4096 + 2048) / 2 / 1024)
    ctx = _ctx(_record(False))
    assert read["skinning_ms"](ctx) == 0.0 and read["skin_upload_kb"](ctx) == 0.0


@pytest.mark.parametrize("name", READERS)
def test_skinning_readers_find_nothing_without_the_spans(name):
    reader = harness.load_metric(REPO, name)
    assert reader.read(_ctx(_record(False, counted=False))) is None
    assert reader.read({**_ctx(_record(True)), "frames": 0}) is None


def test_generator_and_reference_load_nothing_of_the_port(tmp_path):
    root = _small_root(tmp_path)
    code = ("import sys, json; sys.path.insert(0, {repo!r}); from benchmark import harness; "
            "cell, config, mix, e, p = harness.find_cell({root!r}, harness.load_manifest({root!r}), {cell!r}); "
            "config['width'], config['height'] = 32, 18; "
            "b, T, P, R = harness.parts({root!r}, config, mix); s = b(config, 3); t = T(mix, s, 3); "
            "img = R(s, 'cpu').render(**t.state(2))['image']; "
            "print(sorted({{m.split('.')[0] for m in sys.modules}} & {{'rend3_tpu_torch', 'rend3_tpu', 'jax'}}), "
            "tuple(img.shape))")
    out = subprocess.run([sys.executable, "-c", code.format(repo=REPO, root=root, cell=CELL)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] (18, 32, 4)"
