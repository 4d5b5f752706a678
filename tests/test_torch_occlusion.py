"""Two-phase Hi-Z occlusion culling in the PyTorch port against the JAX
package on the CPU.

- build_pyramid bit-exact, on even and odd depth sizes.
- K5's plain version (sample_grid_plain) bit-exact against the JAX Pallas
  sample_grid (interpret mode) with the 4 Hi-Z taps and the 12 PCF taps, on
  the inputs of tests/test_mxu_gather.py.
- occlusion_test's mask equal to the JAX mask on a scene small enough that
  the JAX sampler's 64-pair cap is not hit (the port has no cap).
- The tests/test_occlusion.py scene through the port: the frame-2
  survivors drop, frames 1 and 2 equal the occlusion-off image bit for bit
  and equal the JAX render within 1 u8 level.
- The textured city (scenes.textured_city: 24 buildings, both shadowed
  lights, occlusion on) at 256x128, two frames: each within 1 u8 level of
  the JAX render, the second with fewer survivors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import rend3_tpu.testing as jax_testing
from rend3_tpu.routine.base import BaseRenderGraphSettings as JaxSettings
from rend3_tpu.routine.base import FrameRenderTarget as JaxTarget
from rend3_tpu.ops import hi_z as jhiz
from rend3_tpu.ops import mxu_gather as mg
from rend3_tpu.types import Camera as JaxCamera
from rend3_tpu.types import Orthographic as JaxOrtho
from rend3_tpu.types import Perspective as JaxPerspective
from rend3_tpu.utils import math as jm3
from rend3_tpu_torch import scenes
from rend3_tpu_torch.ops import hi_z
from rend3_tpu_torch.ops import samplers as S
from rend3_tpu_torch.routine.base import BaseRenderGraphSettings, FrameRenderTarget
from rend3_tpu_torch.testing import FrameRenderSettings, TestRunner
from rend3_tpu_torch.types import Camera, Orthographic
from rend3_tpu_torch.utils import math as m3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _depth(h, w, seed):
    """Reverse-Z depth with flat occluders over a noisy background."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 0.2, (h, w)).astype(np.float32)
    for _ in range(6):
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        d[y0 : y0 + rng.integers(h // 4, h), x0 : x0 + rng.integers(w // 4, w)] = rng.uniform(0.4, 0.9)
    d[:6, -6:] = 0.0  # a corner never drawn
    return d


@pytest.mark.parametrize("shape", [(96, 160), (75, 131)])
def test_build_pyramid_bit_exact(shape):
    d = _depth(*shape, seed=1)
    want = jhiz.build_pyramid(jnp.asarray(d))
    got = hi_z.build_pyramid(torch.from_numpy(d))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("offsets", [hi_z.HIZ_TAPS, S.PCF5_OFFSETS], ids=["hiz", "pcf"])
def test_sample_grid_plain_matches_jax_kernel(offsets):
    rng = np.random.default_rng(3)
    H, W = 32, 128
    Hs, Ws = 200, 150
    img = rng.standard_normal((Hs, Ws)).astype(np.float32)
    bx = rng.integers(-10, Ws + 10, size=(H, W)).astype(np.int32)
    by = rng.integers(-10, Hs + 10, size=(H, W)).astype(np.int32)
    valid = rng.random((H, W)) > 0.2
    want, overflow, _q = mg.sample_grid(
        jnp.asarray(img), jnp.asarray(bx), jnp.asarray(by), jnp.asarray(valid), offsets, interpret=True,
    )
    assert int(overflow) <= 32
    got = S.sample_grid(*(torch.from_numpy(a) for a in (img, bx, by, valid)), offsets)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_occlusion_test_matches_jax():
    h, w = 96, 160
    d = _depth(h, w, seed=2)
    rng = np.random.default_rng(4)
    V = 1500
    xmin = rng.uniform(-5.0, w, V).astype(np.float32)
    ymin = rng.uniform(-5.0, h, V).astype(np.float32)
    xmax = (xmin + rng.exponential(6.0, V)).astype(np.float32)
    ymax = (ymin + rng.exponential(6.0, V)).astype(np.float32)
    zmax = rng.uniform(0.0, 0.6, V).astype(np.float32)
    live = rng.random(V) > 0.1
    want = jhiz.occlusion_test(
        jhiz.build_pyramid(jnp.asarray(d)), None, *(jnp.asarray(a) for a in (xmin, ymin, xmax, ymax, zmax)),
        w, h, live=jnp.asarray(live), interpret=True,
    )
    got = hi_z.occlusion_test(
        hi_z.build_pyramid(torch.from_numpy(d)), *(torch.from_numpy(a) for a in (xmin, ymin, xmax, ymax, zmax)),
        live=torch.from_numpy(live),
    )
    assert 0.1 < float(got.float().mean()) < 0.9  # both verdicts occur
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _wall_and_cubes(runner, cam, ortho, mm3):
    """The scene of tests/test_occlusion.py: a wall hiding 16 cubes."""
    keep = [runner.add_directional_light(np.array([-1.0, -1.0, 1.0], np.float32))]
    wall = runner.add_lit_material([0.6, 0.6, 0.6, 1.0])
    keep += [wall, runner.plane(wall, mm3.translation([0.0, 0.0, 0.5]) @ mm3.rotation_y(np.pi) @ mm3.scale(2.0))]
    hidden = runner.add_lit_material([0.8, 0.2, 0.2, 1.0])
    keep.append(hidden)
    for i in range(4):
        for j in range(4):
            keep.append(runner.cube(hidden, mm3.translation([(i - 1.5) * 0.5, (j - 1.5) * 0.5, 2.0]) @ mm3.scale(0.2)))
    runner.set_camera_data(cam(
        projection=ortho(size=np.array([4.0, 4.0, 8.0], np.float32)),
        view=mm3.look_at_lh([0.0, 0.0, -2.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
    ))
    return keep


def test_occlusion_scene_culls_and_keeps_image():
    runner = TestRunner(device="cpu")
    keep = _wall_and_cubes(runner, Camera, Orthographic, m3)
    settings = FrameRenderSettings(size=128)
    graph = runner.base_graph
    graph.occlusion_culling = False
    img_off = runner.render_frame(settings)
    s_off = graph.last_stats["main_survivors"]
    graph.occlusion_culling = True
    img_on1 = runner.render_frame(settings)  # frame 1: everything predicted
    s_on1 = graph.last_stats["main_survivors"] + graph.last_stats["resid_survivors"]
    img_on2 = runner.render_frame(settings)  # frame 2: the carried mask
    s_on2 = graph.last_stats["main_survivors"] + graph.last_stats["resid_survivors"]
    del keep
    assert s_on1 == s_off > 0
    assert s_on2 < s_off, (s_on2, s_off)
    np.testing.assert_array_equal(img_on1, img_off)
    np.testing.assert_array_equal(img_on2, img_off)

    jr = jax_testing.TestRunner()
    jkeep = _wall_and_cubes(jr, JaxCamera, JaxOrtho, jm3)
    ref = jr.render_frame(jax_testing.FrameRenderSettings(size=128))
    del jkeep
    assert int(np.abs(img_on2.astype(np.int32) - ref.astype(np.int32)).max()) <= 1


def test_predicted_mask_resets_when_the_triangle_table_changes():
    runner = TestRunner(device="cpu")
    keep = _wall_and_cubes(runner, Camera, Orthographic, m3)
    settings = FrameRenderSettings(size=64)
    graph = runner.base_graph
    runner.render_frame(settings)
    mask = graph._prev_visible_mask
    assert mask is not None and not bool(mask.all())  # the hidden cubes drop out
    keep.append(runner.cube(keep[1], m3.translation([0.0, 0.0, -0.5]) @ m3.scale(0.1)))
    img = runner.render_frame(settings)
    # The new table is larger: every row was predicted (nothing residual).
    assert graph.last_stats["resid_survivors"] == 0
    assert graph._prev_visible_mask.shape[0] > mask.shape[0]
    graph.occlusion_culling = False
    np.testing.assert_array_equal(img, runner.render_frame(settings))
    del keep


def test_textured_city_matches_jax():
    W, H = 256, 128
    pr = TestRunner(device="cpu")
    keep = scenes.textured_city(pr, n_buildings=24)
    scenes.set_bench_camera(pr, W, H)
    port, survivors = [], []
    for _ in range(2):
        pr.renderer.swap_instruction_buffers()
        port.append(pr.base_graph.render_frame(
            pr.renderer.evaluate_instructions(), FrameRenderTarget(W, H, 1),
            BaseRenderGraphSettings(ambient_color=(0.08, 0.08, 0.1, 1.0)),
        ))
        st = pr.base_graph.last_stats
        survivors.append(st["main_survivors"] + st["resid_survivors"])
    assert len(pr.base_graph._shadow_cache[1][0]) == 2  # both shadow maps
    jr = jax_testing.TestRunner()
    # JAX's caps as its controller converges them on frame 1 of this scene,
    # set up front so that it compiles the converged frame program at once.
    jr.base_graph._caps.update({
        "shadow": 4096, "tile_shadow_mult": 4, "fl_shadow": 8192, "main": 4096, "resid": 4096, "cut": 4096,
        "tile_main_mult": 1, "tex_pair": 16, "shadow_pair": 128, "fl_main": 4096, "q_tex": 1024, "q_pcf": 1024,
        "blend_peels": 1,
    })
    jkeep = scenes.textured_city(jr, n_buildings=24, build=bench.build_city_scene)
    jr.set_camera_data(JaxCamera(
        projection=JaxPerspective(vfov=60.0, near=0.1),
        view=jm3.look_at_lh([40.0, 30.0, -60.0], [0.0, 5.0, 0.0], [0.0, 1.0, 0.0]),
    ))
    jr.renderer.set_aspect_ratio(W / H)
    ref = []
    for _ in range(2):
        jr.renderer.swap_instruction_buffers()
        ref.append(jr.base_graph.render_frame(
            jr.renderer.evaluate_instructions(), JaxTarget(W, H, 1), JaxSettings(ambient_color=(0.08, 0.08, 0.1, 1.0)),
        ))
    del keep, jkeep
    assert survivors[1] < survivors[0]
    for a, b in zip(port, ref):
        assert (a[..., :3] != 0).any(-1).mean() > 0.5
        assert int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max()) <= 1
