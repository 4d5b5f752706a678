"""The benchmark's feature configuration (benchmark/generators/features.py,
feature-city-1080p) and the extension features' readers, on the CPU.

- The generator at full size: the Bistro proxy city, 300 / 150 / 150 / 16
  signs of the four archetypes, each on a wall of its building, 3-5 m up,
  1.5-3 m wide and half as tall, 64 skinned columns of 486 vertices and
  768 triangles, each clear of every footprint, a cube of 6 x 2048² f16
  faces with a sun above 1.0; the same geometry for every run seed.
- The mix: the flythrough mix's camera at every frame, the columns' poses a
  function of the frame (a 60-frame cycle), the close-up views drawn from
  the seed, each a column or a sign seen over a sight line no building
  crosses, and a lit sign facing the key light in its light and in a
  building's shadow, each filling the view.
- The reference's sky, routines, passes and skinning against the port's
  plain versions and the generator's routines and passes on small inputs.
- The cell at a small size (160x90, nine flat buildings, a 16² cube, four
  columns, eight lit signs and two of each other archetype, a fixed
  camera): correct, and refused under each planted fault: the skybox slot
  dropped, the lit, cutout or glass routine unregistered, the cutout
  routine's verdict dropped, the routines' shadow factors dropped, the
  hidden archetype given a routine, the hdr pass dropped, the columns'
  poses dropped.
- The readers skybox_ms, routines_ms and passes_ms: values from the spans,
  0 where the counters were counted and no span opened, None where a
  program records neither.
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
from benchmark import traffic as T
from benchmark.generators import crowd, features
from benchmark.tests import tinyroot
from rend3_tpu_torch.utils import profiling

CELL = "feature-city-1080p.animated"
REPO = tinyroot.REPO


def _load(*parts):
    with open(os.path.join(REPO, "benchmark", *parts)) as f:
        return json.load(f)


@pytest.fixture(autouse=True)
def _tracing_off():
    profiling.disable()
    yield
    profiling.disable()


@pytest.fixture(scope="module")
def full():
    return features.build_scene(_load("configs", "feature-city-1080p.json"), 2**33 + 5)


def _archetype(scene, oi):
    return scene.routine[scene.obj_material[oi]]


def test_full_size_features(full):
    config = _load("configs", "feature-city-1080p.json")
    city = _load("configs", "bistro-proxy-1080p.json")
    for key in ("scene", "camera", "ambient", "width", "height", "samples", "occlusion_culling"):
        assert config[key] == city[key], key
    signs = range(full.first_sign, full.first_column)
    kinds = [_archetype(full, oi) for oi in signs]
    assert {a: kinds.count(a) for a in features.ARCHETYPES} == {
        "SignMaterial": 300, "CutoutSignMaterial": 150, "GlassSignMaterial": 150, "HiddenSignMaterial": 16}
    col = full.meshes[full.column_mesh]
    assert col.positions.shape == (486, 3) and col.indices.shape == (768, 3) and full.columns == 64
    assert full.triangles() == 121_426 + 616 * 4 + 64 * 768
    np.testing.assert_array_equal(full.weights.sum(1), 1.0)
    assert full.joint_ids.max() == 3 and full.inverse_binds.shape == (4, 4, 4)
    assert full.sky.shape == (6, 2048, 2048, 4) and full.sky.dtype == np.float16
    assert full.sky[..., :3].max() > 4.0 and np.all(full.sky[..., 3] == 1.0)
    assert full.hud.shape == (1080, 1920, 4) and set(np.unique(full.hud[..., 3])) == {0, 153, 217, 255}
    # Every sign lies 0.05 m off a wall of a building, inside the wall's
    # width and below its roof, facing out, 3-5 m up, 1.5-3 m wide and half
    # as tall; a building holds at most two, on two walls.
    walls = {}
    box = np.array([[x, z, h, w] for _oi, (x, h, z), (w, _hy, _wz) in full.buildings])
    for k, oi in enumerate(signs):
        centre, normal, width = full.sign_boxes[k]
        m = full.transforms[oi]
        np.testing.assert_allclose(m[:3, 3], centre)
        np.testing.assert_allclose(m[:3, 2], -normal, atol=1e-6)  # the quad's front faces local -z
        np.testing.assert_allclose(2 * np.linalg.norm(m[:3, 0]), width, rtol=1e-6)
        np.testing.assert_allclose(2 * np.linalg.norm(m[:3, 1]), width / 2, rtol=1e-6)
        assert 1.5 <= width <= 3.0 and 3.0 <= centre[1] <= 5.0
        rel = centre[[0, 2]] - box[:, :2]
        on = np.nonzero((np.abs(rel @ normal[[0, 2]] - (box[:, 3] + 0.05)) < 1e-4)
                        & (np.abs(rel[:, 1] * normal[0] - rel[:, 0] * normal[2]) <= box[:, 3] - width / 2 + 1e-4)
                        & (centre[1] + width / 4 < 2 * box[:, 2]))[0]
        assert len(on) == 1, k
        walls.setdefault(on[0], []).append(tuple(normal))
    assert len(walls) == 600 and all(len(set(v)) == len(v) <= 2 for v in walls.values())
    spots = np.stack([full.transforms[oi][[0, 2], 3] for oi in range(full.first_column, len(full.transforms))])
    assert crowd.clearance(full.buildings, spots).min() >= 1.0
    gap = np.linalg.norm(spots[:, None] - spots[None], axis=-1) + 1e9 * np.eye(64)
    assert gap.min() >= 1.5
    heights = [2 * full.transforms[oi][1, 1] for oi in range(full.first_column, len(full.transforms))]
    np.testing.assert_allclose(heights, full.heights)
    assert full.heights.min() >= 3.0 and full.heights.max() <= 6.0
    small_sky = _load("configs", "feature-city-1080p.json")
    small_sky["features"]["sky_size"] = 16  # the layout does not depend on it
    other = features.build_scene(small_sky, 3)
    for a, b in zip(other.transforms, full.transforms):
        np.testing.assert_array_equal(a, b)
    assert other.obj_material == full.obj_material and other.routine == full.routine
    np.testing.assert_array_equal(other.hud, full.hud)
    assert not np.array_equal(features.build_scene(small_sky, 4).sky, other.sky)
    first = full.obj_material[next(oi for oi in signs if _archetype(full, oi) == "SignMaterial")]
    assert not np.array_equal(other.materials[first].albedo, full.materials[first].albedo)


def test_mix_follows_the_flythrough_and_poses_by_frame(full):
    mix = _load("mixes", "animated.json")
    fly = _load("mixes", "flythrough.json")
    assert mix["camera"] == fly["camera"] and mix["warmup_frames"] == fly["warmup_frames"] == 24
    a, b = features.Traffic(mix, full, 2**33 + 9), features.Traffic(mix, full, 2**33 + 9)
    c = features.Traffic(mix, full, 4)
    control = T.Traffic(fly, full, 2**33 + 9)
    assert a.period == control.period == 240
    for frame in range(240):
        np.testing.assert_array_equal(a.view(frame), control.view(frame))
    g = a.joint_globals(17)
    assert g.shape == (64, 4, 4, 4)
    np.testing.assert_array_equal(g, b.joint_globals(17))
    np.testing.assert_array_equal(g, c.joint_globals(17))  # the sway is the same for every seed
    np.testing.assert_array_equal(a.joint_globals(5), a.joint_globals(65))
    assert not np.array_equal(a.joint_globals(5), a.joint_globals(6))
    for k in (0, 37, 63):
        phase = 2 * math.pi * 17 / 60
        bend, twist = 0.5 * math.sin(phase + 0.7 * k), 0.8 * math.cos(phase + 0.3 * k)
        for j in range(4):
            f = j / 3
            rz = np.array([[math.cos(bend * f), -math.sin(bend * f), 0, 0], [math.sin(bend * f), math.cos(bend * f), 0, 0],
                           [0, 0, 1, 0], [0, 0, 0, 1]])
            want = S.translation([0.0, -1.0 + 2.0 * f, 0.0]) @ rz @ S.rotation_y(twist * f)
            np.testing.assert_allclose(g[k, j], want, atol=1e-6)
    # The bottom joint stays put; the top one turns by the whole bend.
    np.testing.assert_allclose(g[:, 0], np.tile(S.translation([0.0, -1.0, 0.0]), (64, 1, 1)), atol=1e-6)
    state = a.state(17)
    assert set(state) == {"view", "transforms", "joints", "closeups"} and state["closeups"] == []
    # The close-ups: drawn from the seed; a column's top from `eye_height`
    # up and `distance` times its height away, the ground line on through
    # the column `beyond` metres clear, and a sign of each listed archetype
    # from in front, each over a sight line clear of every building; then a
    # lit sign facing the key light for each of `lit`, in the scene's light,
    # the view inside the sign.
    cu = mix["closeup"]
    views = a.closeup_views()
    assert [v[:2] for v in views] == [v[:2] for v in b.closeup_views()]
    assert [v[:2] for v in views] != [v[:2] for v in c.closeup_views()]
    assert len(views) == 1 + len(cu["signs"]) + len(cu["lit"]) == 7 and "column" in views[0][1]
    for (frame, label, view, lit), arch in zip(views[1:], cu["signs"] + [f"in {m}" for m in cu["lit"]]):
        assert arch in label and lit == ("in " in label)
    to_key = -full.lights[0].direction / np.linalg.norm(full.lights[0].direction)
    for frame, label, view, lit in views:
        assert 0 <= frame < a.period
        eye = np.linalg.inv(view)[:3, 3]
        k = int(label.split()[label.split().index("column" if "column" in label else "sign") + 1])
        if "column" in label:
            target = full.transforms[full.first_column + k][:3, 3] * [1.0, 2.0, 1.0]  # the top
            np.testing.assert_allclose(np.linalg.norm((eye - target)[[0, 2]]), full.heights[k] * cu["distance"],
                                       rtol=1e-5)
            np.testing.assert_allclose(eye[1], cu["eye_height"], rtol=1e-5)
            run = (eye - target)[[0, 2]] / np.linalg.norm((eye - target)[[0, 2]])
            line = target[[0, 2]] + np.linspace(-cu["beyond"], 0, 32)[:, None] * run
            assert crowd.clearance(full.buildings, line).min() >= 0.29
        elif lit:
            target, normal, width = full.sign_boxes[k]
            assert _archetype(full, full.first_sign + k) == "SignMaterial" and normal @ to_key >= 0.3
            np.testing.assert_allclose(eye, target + 0.35 * width * normal, atol=1e-5)
            # The view's corner rays meet the sign's plane inside the sign.
            half = math.tan(math.radians(full.vfov) / 2)
            for sx in (-1, 1):
                for sy in (-1, 1):
                    d = np.linalg.inv(view)[:3, :3] @ [sx * half * full.width / full.height, sy * half, 1.0]
                    hit = eye + d * (0.35 * width / -(d @ normal)) - target
                    assert abs(hit[1]) < width / 4 and abs(hit @ np.cross(normal, [0, 1, 0])) < width / 2
        else:
            target, normal, width = full.sign_boxes[k]
            assert 1.0 - 1e-5 <= np.dot(eye - target, normal) <= 2 * width + 1e-5
        np.testing.assert_allclose((view @ np.append(target, 1.0))[:2], 0.0, atol=1e-4)
        line = target[[0, 2]] + np.linspace(0.5, 1, 32)[:, None] * (eye - target)[[0, 2]]
        assert crowd.clearance(full.buildings, line).min() >= 0.29


def _small_root(tmp_path, eye=(14.0, 6.0, 14.0), target=(0.0, 3.0, 0.0)):
    root = tinyroot.make(tmp_path)
    path = os.path.join(root, "benchmark", "configs", "feature-city-1080p.json")
    with open(path) as f:
        config = json.load(f)
    config["scene"].update(n_buildings=9, representative=False)
    config["camera"].update(eye=list(eye), target=list(target))
    ft = config["features"]
    ft.update(sky_size=16, columns=4)
    ft["signs"] = {**dict.fromkeys(features.ARCHETYPES, 2), "SignMaterial": 8}  # one in light, one in shadow
    ft["hud"].update(bar_height=8, minimap=20, margin=2, lines=3)
    with open(path, "w") as f:
        json.dump(config, f)
    path = os.path.join(root, "benchmark", "mixes", "animated.json")
    with open(path) as f:
        mix = json.load(f)
    mix["camera"] = {"path": "fixed"}
    with open(path, "w") as f:
        json.dump(mix, f)
    return root


def _small(tmp_path, seed=5):
    root = _small_root(tmp_path)
    _cell, config, mix, _e, _p = harness.find_cell(root, harness.load_manifest(root), CELL)
    build_scene, Traffic, Port, Reference = harness.parts(root, config, mix)
    scene = build_scene(config, seed)
    return scene, Traffic(mix, scene, seed), Port, Reference


def test_reference_sky_matches_the_ports_sampler(tmp_path):
    """The reference's sky against the port's sky directions and its plain
    scalar cube sampler (texture.sample_cube, the f32 faces) at a 48x32
    target: within float32 rounding."""
    from rend3_tpu_torch.ops import texture as tex_ops
    from rend3_tpu_torch.routine.base import sky_directions

    scene, traffic, _port, Reference = _small(tmp_path)
    scene.width, scene.height = 48, 32
    ref = Reference(scene, "cpu")
    view = S.look_at_lh([3.0, 2.0, -4.0], [0.0, 4.0, 1.0])
    origin = view.copy()
    origin[:3, 3] = 0.0
    from benchmark.reference import projection

    inv = np.linalg.inv(projection(scene.vfov, 48 / 32, scene.near) @ origin).astype(np.float32)
    dirs = sky_directions(torch.from_numpy(inv), 48, 32, 32, 48, (0.5, 0.5))
    faces = scene.sky.astype(np.float32)
    cube = tex_ops.cube_arrays(np.stack([np.zeros_like(faces), faces]), np.array([0, 16], np.int32))
    want = tex_ops.sample_cube(cube, 1, dirs)[:, :3]
    got = ref.sky_rgb(view)
    assert float((got - want).abs().max()) < 2e-4
    assert float(got.max()) > float(got.min()) + 0.1


def test_reference_routines_and_passes_match_the_ports(tmp_path):
    """The reference's lit, cutout and glass shading, checker alpha, tonemap
    and HUD against the generator's routines and passes as the port calls
    them (view-space normals and lights, GBufferPixels) on random inputs."""
    from rend3_tpu_torch.ops.shade import DirLightArrays, FrameUniformsArrays
    from rend3_tpu_torch.routine.registry import GBufferPixels

    scene, _traffic, _port, Reference = _small(tmp_path)
    ref = Reference(scene, "cpu")
    g = torch.Generator().manual_seed(3)
    n = 64
    nrm = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1)
    uv = torch.rand(n, 2, generator=g) * 3 - 1
    shadow = torch.rand(len(ref.plan), n, generator=g)
    view = S.look_at_lh([3.0, 2.0, -4.0], [0.0, 1.0, 1.0])
    v3 = torch.from_numpy(view[:3, :3])
    L = len(scene.lights)
    dl = DirLightArrays(
        view_proj=torch.zeros(L, 4, 4), direction=torch.from_numpy(np.stack([lt.direction for lt in scene.lights])),
        color=torch.from_numpy(np.stack([lt.color * np.float32(lt.intensity) for lt in scene.lights])),
        inv_resolution=torch.zeros(L, 2), atlas_offset=torch.zeros(L, 2), atlas_size=torch.zeros(L, 2),
        mask=torch.ones(L, dtype=torch.bool))
    eye4 = torch.eye(4)
    uni = FrameUniformsArrays(view=torch.from_numpy(view), view_proj=eye4, origin_view_proj=eye4, inv_view=eye4,
                              inv_origin_view_proj=eye4, ambient=torch.tensor(scene.ambient, dtype=torch.float32))
    pixels = GBufferPixels(view_pos=torch.zeros(n, 3), nrm=nrm @ v3.T * 1.7, tan=torch.zeros(n, 3), uv0=uv,
                           uv1=torch.zeros(n, 2), vcol=torch.ones(n, 4), hit=torch.ones(n, dtype=torch.bool))
    # The plan's order is the lights' here (2048², then 1024²).
    assert [li for li, _o, _s in ref.plan] == list(range(L))
    for arch, fn in (("SignMaterial", features.lit_shade), ("CutoutSignMaterial", features.unlit_shade),
                     ("GlassSignMaterial", features.unlit_shade)):
        mi = scene.routine.index(arch)
        mat = torch.full((n,), mi, dtype=torch.long)
        want = ref._shade(torch.zeros(n, 3), nrm, uv, torch.zeros(n, 4), mat, shadow, np.ones(3, np.float32))
        mdata = ref.m_albedo[mat]
        got = fn(pixels, mdata, torch.zeros(n, dtype=torch.int32), dl, None, shadow, uni)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    mi = scene.routine.index("CutoutSignMaterial")
    alpha = ref._alpha(torch.full((n,), mi, dtype=torch.long), uv, torch.zeros(n, 4))
    torch.testing.assert_close(features.checker_alpha(pixels, None, None), alpha)
    assert 0 < float(alpha.mean()) < 1
    img = torch.rand(scene.height, scene.width, 4, generator=g) * 6.0
    torch.testing.assert_close(features.aces_pass(scene.exposure)(img, None, None), ref.tonemap(img))
    u8 = (torch.rand(scene.height, scene.width, 4, generator=g) * 255).to(torch.uint8)
    hud = features.hud_pass(torch.from_numpy(scene.hud))(u8, None, None)
    assert torch.equal(hud, ref.overlay(u8)) and not torch.equal(hud, u8)


def test_reference_skins_as_the_port_does(tmp_path):
    """The reference's column skinning against the port's skinned arenas at
    a pose of the sway: within a few ulps."""
    scene, traffic, Port, Reference = _small(tmp_path)
    port = Port(scene, traffic, "cpu")
    port.apply(31)
    port.evaluate()
    r = port.renderer
    geo = port.graph._skinner(r.mesh_manager.evaluate(), r.skeleton_manager, r.mesh_manager, "cpu")
    want, want_n = Reference(scene, "cpu").skin(traffic.joint_globals(31))
    idx = torch.from_numpy(scene.meshes[scene.column_mesh].indices)
    for k, sk in enumerate(port.skeletons):
        rec = r.skeleton_manager.data[sk.idx]
        start, count = rec.override_ranges["position"]
        np.testing.assert_allclose(geo.position[start:start + count][idx], want[k], rtol=0, atol=2e-6)
        start, count = rec.override_ranges["normal"]
        np.testing.assert_allclose(geo.normal[start:start + count][idx], want_n[k], rtol=0, atol=2e-6)


def _hidden_routine(monkeypatch):
    """The hidden archetype gets an unlit routine."""
    from rend3_tpu_torch.routine.base import BaseRenderGraph
    from rend3_tpu_torch.routine.registry import MaterialRoutine

    orig = BaseRenderGraph.register_routine

    def register(self, routine):
        orig(self, routine)
        orig(self, MaterialRoutine(type("HiddenSignMaterial", (), {}), features.unlit_shade))

    monkeypatch.setattr(BaseRenderGraph, "register_routine", register)


def _no_routine(archetype):
    """The routine of `archetype` left unregistered, so its signs do not draw."""

    def plant(monkeypatch):
        from rend3_tpu_torch.routine.base import BaseRenderGraph

        orig = BaseRenderGraph.register_routine
        monkeypatch.setattr(BaseRenderGraph, "register_routine",
                            lambda self, rt: None if rt.archetype == archetype else orig(self, rt))

    return plant


def _no_verdict(monkeypatch):
    """Each cutout peel's alpha test without the registered routines: on the
    card C1 gets no verdict, on the CPU the chain no routine."""
    from rend3_tpu_torch.ops import lighting

    orig = lighting.cutout_peel_step
    monkeypatch.setattr(lighting, "cutout_peel_step", lambda *args, extras=(), **kw: orig(*args, **kw))


def _no_routine_shadows(monkeypatch):
    """The registered routines shade with no shadow factors."""
    from rend3_tpu_torch.ops import lighting

    orig = lighting.apply_material_routines
    monkeypatch.setattr(lighting, "apply_material_routines",
                        lambda img, gbuf, extras, dl, pl, shadow_values, uniforms:
                        orig(img, gbuf, extras, dl, pl, None, uniforms))


def _no_hdr_pass(monkeypatch):
    from rend3_tpu_torch.routine.base import BaseRenderGraph

    orig = BaseRenderGraph.register_pass
    monkeypatch.setattr(BaseRenderGraph, "register_pass",
                        lambda self, fn, stage="srgb": None if stage == "hdr" else orig(self, fn, stage))


def _no_sky(monkeypatch):
    from rend3_tpu_torch.routine.base import BaseRenderGraph

    orig = BaseRenderGraph.render_frame_tensor
    monkeypatch.setattr(BaseRenderGraph, "render_frame_tensor",
                        lambda self, ev, target, settings, skybox_slot=None: orig(self, ev, target, settings))


def _no_poses(monkeypatch):
    from rend3_tpu_torch.core.renderer import Renderer

    monkeypatch.setattr(Renderer, "set_skeleton_joint_transforms", lambda self, handle, globals_, ib: None)


FAULTS = {"sound": None, "skybox_dropped": _no_sky, "lit_routine_unregistered": _no_routine("SignMaterial"),
          "hidden_archetype_drawn": _hidden_routine, "hdr_pass_dropped": _no_hdr_pass, "poses_dropped": _no_poses,
          "cutout_routine_unregistered": _no_routine("CutoutSignMaterial"), "cutout_verdict_dropped": _no_verdict,
          "glass_routine_unregistered": _no_routine("GlassSignMaterial"),
          "routine_shadows_dropped": _no_routine_shadows}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_small_feature_cell(tmp_path, monkeypatch, fault):
    torch.set_num_threads(2)
    root = _small_root(tmp_path)
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    before = set(harness.forbidden_modules())
    orig = harness.forbidden_modules
    monkeypatch.setattr(harness, "forbidden_modules", lambda: sorted(set(orig()) - before))
    result = harness.run_cell(root, CELL, 2**34 + 78, 1.0, False, device="cpu")
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["correct"] == (fault == "sound"), result["check"]


READERS = {"skybox_ms": (("sky::background",), "sky.queries"),
           "routines_ms": (("routines::shadows", "routines::shade", "routines::verdict"), "routines.archetypes"),
           "passes_ms": (("passes::hdr", "passes::srgb"), "passes.run")}


def _ctx(stats, frames=2):
    return {"frames": frames, "frame_s": [0.1] * frames, "scene_s": [0.01] * frames, "plain_s": [],
            "stages_ms": {}, "scopes_ms": dict(stats.totals_ms), "profile": None}


def _record(spans, counter, ran: bool, counted: bool = True):
    """Two traced frames; ran: each opens `spans` and counts 3; counted:
    the counter at all (0 where the feature did not run)."""
    profiling.enable()
    try:
        for _frame in range(2):
            with profiling.scope(profiling.ROOT):
                for name in spans if ran else ():
                    with profiling.scope(name):
                        pass
                if counted:
                    profiling.count(counter, 3 if ran else 0)
    finally:
        profiling.disable()
    return profiling.stats()


@pytest.mark.parametrize("name", list(READERS))
def test_feature_readers(name):
    spans, counter = READERS[name]
    reader = harness.load_metric(REPO, name)
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == ("extension features", "ms", "program_span",
                                                                        "frame_ms")
    ctx = _ctx(_record(spans, counter, True))
    assert reader.read(ctx) == pytest.approx(sum(ctx["scopes_ms"][s] for s in spans) / 2) and reader.read(ctx) > 0
    assert reader.read(_ctx(_record(spans, counter, False))) == 0.0
    assert reader.read(_ctx(_record(spans, counter, False, counted=False))) is None
    assert reader.read({**ctx, "frames": 0}) is None


def test_generator_and_reference_load_nothing_of_the_port(tmp_path):
    root = _small_root(tmp_path)
    code = ("import sys, json; sys.path.insert(0, {repo!r}); from benchmark import harness; "
            "cell, config, mix, e, p = harness.find_cell({root!r}, harness.load_manifest({root!r}), {cell!r}); "
            "config['width'], config['height'] = 32, 18; config['features']['hud']['margin'] = 1; "
            "b, T, P, R = harness.parts({root!r}, config, mix); s = b(config, 3); t = T(mix, s, 3); "
            "img = R(s, 'cpu').render(**t.state(2))['image']; "
            "print(sorted({{m.split('.')[0] for m in sys.modules}} & {{'rend3_tpu_torch', 'rend3_tpu', 'jax'}}), "
            "tuple(img.shape))")
    out = subprocess.run([sys.executable, "-c", code.format(repo=REPO, root=root, cell=CELL)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] (18, 32, 4)"
