"""Whole frames of the PyTorch port on the CPU against the JAX package and
the wgpu goldens.

- The tests/test_shadow.py scene (plane, then plane + cube, one shadowed
  light, 256x256) through the port: the same golden thresholds as
  test_shadow.py (FLIP P50 <= 0.04, mae 0.02, ssim 0.95; a missing golden
  is created from the render, as every golden test does), and the u8 image
  against the JAX render: max abs difference <= 1 (lighting math may round
  differently in the last ulp before quantization).
- The 24-building flat city scene of bench.py at 256x128, the port with its
  default two-phase occlusion culling against JAX with
  occlusion_culling=False (culling is image-neutral): max abs
  difference <= 1.
- Shadow maps cached across static frames (as test_caps.py:96 tests).
(MSAA 4 renders: tests/test_torch_msaa.py; the skybox:
tests/test_torch_skybox.py.)
"""

import os

import numpy as np
import pytest
import torch

import bench
import rend3_tpu.testing as jax_testing
from rend3_tpu.routine.base import BaseRenderGraphSettings as JaxSettings
from rend3_tpu.routine.base import FrameRenderTarget as JaxTarget
from rend3_tpu.types import Camera as JaxCamera
from rend3_tpu.types import Orthographic as JaxOrtho
from rend3_tpu.types import Perspective as JaxPerspective
from rend3_tpu.utils import math as jm3
from rend3_tpu_torch import scenes
from rend3_tpu_torch.routine.base import BaseRenderGraphSettings, FrameRenderTarget
from rend3_tpu_torch.testing import FrameRenderSettings, TestRunner, Threshold, compare_to_golden, load_png
from rend3_tpu_torch.types import Camera, Orthographic
from rend3_tpu_torch.utils import math as m3

SHADOW_THRESHOLD = Threshold(mae=0.02, ssim=0.95, flip_percentiles=((50.0, 0.04),))
CITY_W, CITY_H = 256, 128


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _max_diff(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def _shadow_frames(runner, settings_cls, cam_cls, ortho_cls, mm3):
    """Plane, then plane + cube (tests/test_shadow.py); returns both images."""
    keep = [runner.add_directional_light(np.array([-1.0, -1.0, 1.0], np.float32))]
    mat1 = runner.add_lit_material([0.25, 0.5, 0.75, 1.0])
    keep += [mat1, runner.plane(mat1, mm3.rotation_x(-np.pi / 2))]
    runner.set_camera_data(
        cam_cls(
            projection=ortho_cls(size=np.array([2.5, 2.5, 5.0], np.float32)),
            view=mm3.look_at_lh([0.0, 1.0, -1.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
        )
    )
    plane = runner.render_frame(settings_cls(size=256))
    mat2 = runner.add_lit_material([0.75, 0.5, 0.25, 1.0])
    keep += [mat2, runner.cube(mat2, mm3.translation([0.25, 0.25, -0.25]) @ mm3.scale(0.25))]
    cube = runner.render_frame(settings_cls(size=256))
    return plane, cube


@pytest.fixture(scope="module")
def shadow_images():
    port = _shadow_frames(TestRunner(device="cpu"), FrameRenderSettings, Camera, Orthographic, m3)
    ref = _shadow_frames(
        jax_testing.TestRunner(), jax_testing.FrameRenderSettings, JaxCamera, JaxOrtho, jm3
    )
    return port, ref


@pytest.mark.parametrize("i,golden", [(0, "shadow/plane.png"), (1, "shadow/cube.png")])
def test_shadow_scene_golden(shadow_images, i, golden):
    path = os.path.join(jax_testing.REFERENCE_RESULTS, golden)
    compare_to_golden(shadow_images[0][i], path, SHADOW_THRESHOLD)


@pytest.mark.parametrize("i,golden", [(0, "shadow/plane.png"), (1, "shadow/cube.png")])
def test_shadow_scene_golden_created_when_missing(shadow_images, i, golden, tmp_path, monkeypatch):
    """With no golden on disk, test_shadow_scene_golden passes and writes
    it from the render (it must not depend on another test having written
    it first)."""
    monkeypatch.setattr(jax_testing, "REFERENCE_RESULTS", str(tmp_path))
    test_shadow_scene_golden(shadow_images, i, golden)
    path = tmp_path / golden
    assert path.exists()
    np.testing.assert_array_equal(load_png(str(path)), shadow_images[0][i][..., :3])
    test_shadow_scene_golden(shadow_images, i, golden)  # and now compares against it


@pytest.mark.parametrize("i", [0, 1])
def test_shadow_scene_matches_jax(shadow_images, i):
    assert _max_diff(shadow_images[0][i], shadow_images[1][i]) <= 1


@pytest.fixture(scope="module")
def city_images():
    pr = TestRunner(device="cpu")
    keep = scenes.build_city_scene(pr, n_buildings=24, seed=7, representative=False)
    scenes.set_bench_camera(pr, CITY_W, CITY_H)
    pr.renderer.swap_instruction_buffers()
    port = pr.base_graph.render_frame(
        pr.renderer.evaluate_instructions(), FrameRenderTarget(CITY_W, CITY_H, 1),
        BaseRenderGraphSettings(ambient_color=(0.08, 0.08, 0.1, 1.0)),
    )
    jr = jax_testing.TestRunner()
    # JAX's caps as its controller converges them for this frame, set up
    # front so that it compiles the converged frame program at once.
    jr.base_graph._caps.update({
        "shadow": 4096, "tile_shadow_mult": 2, "fl_shadow": 8192, "main": 4096, "resid": 4096, "cut": 4096,
        "tile_main_mult": 1, "tex_pair": 16, "shadow_pair": 128, "fl_main": 4096, "q_pcf": 1024, "blend_peels": 1,
    })
    jkeep = bench.build_city_scene(jr, n_buildings=24, seed=7, representative=False)
    jr.set_camera_data(
        JaxCamera(
            projection=JaxPerspective(vfov=60.0, near=0.1),
            view=jm3.look_at_lh([40.0, 30.0, -60.0], [0.0, 5.0, 0.0], [0.0, 1.0, 0.0]),
        )
    )
    jr.renderer.set_aspect_ratio(CITY_W / CITY_H)
    jr.renderer.swap_instruction_buffers()
    jr.base_graph.occlusion_culling = False
    ref = jr.base_graph.render_frame(
        jr.renderer.evaluate_instructions(), JaxTarget(CITY_W, CITY_H, 1),
        JaxSettings(ambient_color=(0.08, 0.08, 0.1, 1.0)),
    )
    del keep, jkeep
    return port, ref


def test_city_frame_matches_jax(city_images):
    port, ref = city_images
    assert port.shape == (CITY_H, CITY_W, 4)
    assert (port[..., :3] != 0).any(-1).mean() > 0.5
    assert _max_diff(port, ref) <= 1


def _camera(runner):
    runner.set_camera_data(
        Camera(
            projection=Orthographic(size=np.array([2.5, 2.5, 5.0], np.float32)),
            view=m3.look_at_lh([0.0, 1.0, -1.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
        )
    )


def test_shadow_maps_cached_across_static_frames():
    runner = TestRunner(device="cpu")
    keep = [runner.add_directional_light(np.array([-1.0, -1.0, 1.0], np.float32))]
    mat = runner.add_lit_material([0.5, 0.6, 0.7, 1.0])
    keep += [mat, runner.plane(mat, m3.rotation_x(-np.pi / 2))]
    keep.append(runner.cube(mat, m3.translation([0.0, 0.3, 0.0]) @ m3.scale(0.3)))
    _camera(runner)
    settings = FrameRenderSettings(size=64)
    graph = runner.base_graph
    runner.render_frame(settings)
    state0, maps0 = graph._shadow_cache
    runner.render_frame(settings)
    assert graph._shadow_cache[0] == state0
    assert graph._shadow_cache[1] is maps0  # the same tensors, nothing re-rastered
    keep.append(runner.cube(mat, m3.translation([0.5, 0.3, 0.0]) @ m3.scale(0.2)))
    runner.render_frame(settings)
    assert graph._shadow_cache[0] != state0
    del keep
