"""GPU skinning of the PyTorch port on the CPU against the JAX package.

- `apply_skinning` on a three-skeleton fixture (scenes.skinned_columns:
  three bent columns of one skinned mesh): positions, normals and tangents
  of every override range within 1e-6 (a few ulps of values of order 1:
  the port takes the fma forms XLA:CPU gave the JAX function where they
  were found, ops/skin.py, and matched it bit for bit there, but which
  products XLA contracts may change with the CPU), the source ranges
  untouched, and the same from JAX's own work list carried over
  (interop.skin_inputs), bit for bit.
- The skinned scene at 64x64 with one shadowed light against JAX's frame,
  within 1 u8 level; then a new pose set through
  set_skeleton_joint_transforms: the port must re-raster its shadow map,
  and the new frame must again match JAX's.
- The layout is rebuilt only when the skeletons change: a pose change
  uploads the palette alone (J x 64 bytes, skin.layout_builds unchanged) and
  gives arenas equal bit for bit to a fresh build of layout and palette;
  adding or removing a skeleton, or another joint count, rebuilds the
  layout.
"""

import numpy as np
import pytest
import torch

import rend3_tpu.testing as jax_testing
from rend3_tpu import types as jax_types
from rend3_tpu.ops import skin as JS
from rend3_tpu.routine.base import FrameRenderTarget as JaxTarget
from rend3_tpu.routine.pbr import material as jax_material
from rend3_tpu.utils import math as jax_m3
from rend3_tpu_torch import interop, scenes
from rend3_tpu_torch.ops import skin as PS
from rend3_tpu_torch.routine.base import FrameRenderTarget
from rend3_tpu_torch.testing import TestRunner
from rend3_tpu_torch.types import Skeleton
from rend3_tpu_torch.utils import profiling

SIZE = 64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_scene():
    jr = jax_testing.TestRunner()
    keep, sks = scenes.skinned_columns(jr, mat=jax_material, types=jax_types, m3=jax_m3)
    return jr, keep, sks


def _port_scene():
    pr = TestRunner(device="cpu")
    keep, sks = scenes.skinned_columns(pr)
    return pr, keep, sks


def _evaluate(runner):
    runner.renderer.swap_instruction_buffers()
    return runner.renderer.evaluate_instructions()


def test_apply_skinning_matches_jax():
    jr, jkeep, _ = _jax_scene()
    pr, keep, _ = _port_scene()
    _evaluate(jr)
    _evaluate(pr)
    jsi = JS.build_skin_inputs(jr.renderer.skeleton_manager, jr.renderer.mesh_manager)
    want = JS.apply_skinning(jr.renderer.mesh_manager.evaluate(), jsi)
    pm = pr.renderer.mesh_manager
    geo = pm.evaluate()
    before = {f: getattr(geo, f).clone() for f in ("position", "normal", "tangent")}
    got = PS.apply_skinning(geo, *PS.build_skin_inputs(pr.renderer.skeleton_manager, pm))
    skm = pr.renderer.skeleton_manager
    assert len(skm.data) == 3
    n_checked = 0
    for rec in skm.data.values():
        for name in ("position", "normal", "tangent"):
            start, count = rec.override_ranges[name]
            src = rec.source_ranges[name][0]
            g = getattr(got, name)[start : start + count].numpy()
            np.testing.assert_allclose(g, np.asarray(getattr(want, name))[start : start + count], rtol=0, atol=1e-6)
            # The source ranges keep the rest pose; the pose moved the vertices.
            np.testing.assert_array_equal(getattr(got, name)[src : src + count], before[name][src : src + count])
            assert not np.array_equal(g, before[name][start : start + count].numpy())
            n_checked += count
    assert n_checked == 3 * 3 * 150
    # The other attributes are the arenas themselves.
    assert got.uv0 is geo.uv0 and got.color0 is geo.color0
    # JAX's own work list, carried over, gives the same arenas.
    again = PS.apply_skinning(geo, *interop.skin_inputs(jsi))
    for name in ("position", "normal", "tangent"):
        assert torch.equal(getattr(again, name), getattr(got, name))
    del keep, jkeep


def test_skinned_frames_match_jax_and_rebuild_shadows():
    pr, keep, sks = _port_scene()
    jr, jkeep, jsks = _jax_scene()
    graph = pr.base_graph
    images = []
    for step in range(2):
        if step:
            scenes.pose_columns(pr, sks, 1.3)
            scenes.pose_columns(jr, jsks, 1.3, m3=jax_m3)
        got = graph.render_frame(_evaluate(pr), FrameRenderTarget(SIZE, SIZE, 1))
        want = jr.base_graph.render_frame(_evaluate(jr), JaxTarget(SIZE, SIZE, 1))
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1, f"frame {step}: max diff {diff.max()} at {(diff > 0).any(-1).sum()} pixels"
        images.append(got)
        if step == 0:
            state0, maps0 = graph._shadow_cache
            layout0, palette0 = graph._skinner.layout, graph._skinner.palette
    # The new pose re-rasters the shadow map and uploads a new palette over
    # the same layout.
    assert graph._shadow_cache[0] != state0 and graph._shadow_cache[1] is not maps0
    assert graph._skinner.layout is layout0 and graph._skinner.palette is not palette0
    assert not np.array_equal(images[0], images[1])
    del keep, jkeep


def test_static_pose_reuses_skinning_and_shadows():
    pr, keep, _ = _port_scene()
    graph = pr.base_graph
    target = FrameRenderTarget(SIZE, SIZE, 1)
    a = graph.render_frame(_evaluate(pr), target)
    skin, skinned, shadow = graph._skinner.palette, graph._skinner.skinned[1], graph._shadow_cache[1]
    b = graph.render_frame(_evaluate(pr), target)
    assert graph._skinner.palette is skin and graph._skinner.skinned[1] is skinned
    assert graph._shadow_cache[1] is shadow
    np.testing.assert_array_equal(a, b)
    del keep


def _traced_skinning(pr, skinner, geo):
    """One evaluate and one Skinner call, traced: (skinned arenas, counters)."""
    profiling.enable()
    try:
        _evaluate(pr)
        r = pr.renderer
        out = skinner(geo, r.skeleton_manager, r.mesh_manager, "cpu")
    finally:
        profiling.disable()
    return out, profiling.stats()


def _assert_arenas_equal(got, want):
    for name in ("position", "normal", "tangent"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_pose_change_uploads_the_palette_alone():
    pr, keep, sks = _port_scene()
    r = pr.renderer
    skinner = PS.Skinner()
    geo = (_evaluate(pr), r.mesh_manager.evaluate())[1]
    first, s0 = _traced_skinning(pr, skinner, geo)
    skm = r.skeleton_manager
    joints = sum(len(rec.joint_matrices) for rec in skm.data.values())
    layout = skinner.layout
    assert s0.counters["skin.layout_builds"] == 1 and s0.counters["skin.skeletons"] == 3
    assert s0.counters["skin.vertices"] == 3 * 150
    assert s0.counters["upload.skin_bytes"] == layout.nbytes + joints * 64
    assert {"skin::layout", "skin::palette", "skin::apply"} <= set(s0.counts)
    # A new pose: no layout, the palette's J x 64 bytes, arenas as a fresh build.
    scenes.pose_columns(pr, sks, 0.7)
    posed, s1 = _traced_skinning(pr, skinner, geo)
    assert skinner.layout is layout and "skin::layout" not in s1.counts
    assert s1.counters["skin.layout_builds"] == 0 and s1.counters["upload.skin_bytes"] == joints * 64
    assert s1.counters["skin.vertices"] == 3 * 150
    _assert_arenas_equal(posed, PS.apply_skinning(geo, *PS.build_skin_inputs(skm, r.mesh_manager)))
    assert not torch.equal(posed.position, first.position)
    # Nothing changed: nothing skinned or copied, the same arenas.
    again, s2 = _traced_skinning(pr, skinner, geo)
    assert again is posed and s2.counters["skin.vertices"] == 0 and s2.counters["upload.skin_bytes"] == 0
    assert not {"skin::layout", "skin::palette", "skin::apply"} & set(s2.counts)
    del keep


def test_adding_or_removing_a_skeleton_rebuilds_the_layout():
    pr, keep, sks = _port_scene()
    r = pr.renderer
    skinner = PS.Skinner()
    _evaluate(pr)
    skinner(r.mesh_manager.evaluate(), r.skeleton_manager, r.mesh_manager, "cpu")
    layout = skinner.layout
    skm = r.skeleton_manager
    version = skm.layout_version
    rec = skm.data[sks[0].idx]
    extra = r.add_skeleton(Skeleton(mesh=rec.skeleton.mesh, joint_matrices=rec.joint_matrices))
    geo = (_evaluate(pr), r.mesh_manager.evaluate())[1]
    grown, s = _traced_skinning(pr, skinner, geo)
    assert skm.layout_version == version + 1 and skinner.layout is not layout
    assert s.counters["skin.layout_builds"] == 1 and s.counters["skin.skeletons"] == 4
    assert skinner.layout.src_ids.shape[0] == 4 * 150
    _assert_arenas_equal(grown, PS.apply_skinning(geo, *PS.build_skin_inputs(skm, r.mesh_manager)))
    layout = skinner.layout
    del extra  # the handle's last reference: a delete instruction
    geo = (_evaluate(pr), r.mesh_manager.evaluate())[1]
    shrunk, s = _traced_skinning(pr, skinner, geo)
    assert skm.layout_version == version + 2 and skinner.layout is not layout
    assert s.counters["skin.layout_builds"] == 1 and skinner.layout.src_ids.shape[0] == 3 * 150
    _assert_arenas_equal(shrunk, PS.apply_skinning(geo, *PS.build_skin_inputs(skm, r.mesh_manager)))
    # Another joint count for the first skeleton moves the later ones' joint
    # bases: the layout is rebuilt with the palette.
    rec = skm.data[sks[0].idx]
    r.set_skeleton_joint_matrices(sks[0], np.concatenate([rec.joint_matrices, rec.joint_matrices[:1]]))
    counted, s = _traced_skinning(pr, skinner, geo)
    assert skm.layout_version == version + 3 and s.counters["skin.layout_builds"] == 1
    assert skm.global_joint_count == sum(len(q.joint_matrices) for q in skm.data.values())
    _assert_arenas_equal(counted, PS.apply_skinning(geo, *PS.build_skin_inputs(skm, r.mesh_manager)))
    del keep
