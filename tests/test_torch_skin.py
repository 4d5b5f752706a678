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
- The work list is rebuilt only when the skeletons change.
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
    psi = PS.build_skin_inputs(pr.renderer.skeleton_manager, pm)
    got = PS.apply_skinning(geo, psi)
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
    again = PS.apply_skinning(geo, interop.skin_inputs(jsi))
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
            skin0 = graph._skin
    # The new pose re-rasters the shadow map and rebuilds the work list.
    assert graph._shadow_cache[0] != state0 and graph._shadow_cache[1] is not maps0
    assert graph._skin is not skin0
    assert not np.array_equal(images[0], images[1])
    del keep, jkeep


def test_static_pose_reuses_skinning_and_shadows():
    pr, keep, _ = _port_scene()
    graph = pr.base_graph
    target = FrameRenderTarget(SIZE, SIZE, 1)
    a = graph.render_frame(_evaluate(pr), target)
    skin, skinned, shadow = graph._skin, graph._skinned[1], graph._shadow_cache[1]
    b = graph.render_frame(_evaluate(pr), target)
    assert graph._skin is skin and graph._skinned[1] is skinned and graph._shadow_cache[1] is shadow
    np.testing.assert_array_equal(a, b)
    del keep
