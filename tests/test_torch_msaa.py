"""MSAA 4 in the PyTorch port on the CPU.

- tests/test_msaa.py's three goldens (a 4-sample triangle, and the 64x64
  grid of shrinking planes at 1 and 4 samples) rendered by the port, at the
  reference's thresholds (msaa.rs).
- A small scene of the whole slice at 64x64 and 4 samples: a lit ground,
  a double-sided cutout quad whose alpha comes from its vertex colours
  (cutoff 0.5, so the alpha test cuts a diagonal through it), a glass pane
  in front of it, one shadowed directional light, occlusion culling on.
  The port's image is held within 1 u8 level of the JAX package's (the
  resolve is a mean over samples in both; summation order may cost an ulp
  before quantisation). JAX renders it once, with its peel caps set to what
  its controller converges to for the scene so that it compiles one frame
  program, and with occlusion culling off (culling is image-neutral, and
  the test below holds the port to that).
- The port's occlusion-on frames (the first predicts every triangle, the
  second renders the carried mask) equal its occlusion-off frame bit for
  bit.
"""

import numpy as np
import pytest
import torch

import rend3_tpu.testing as jax_testing
from rend3_tpu import types as jax_types
from rend3_tpu.routine.pbr import material as jax_material
from rend3_tpu.utils import math as jax_m3
import rend3_tpu_torch.testing as port_testing
from rend3_tpu_torch import types
from rend3_tpu_torch.routine.pbr import material
from rend3_tpu_torch.testing import FrameRenderSettings, TestRunner, Threshold
from rend3_tpu_torch.types import Camera, Handedness, MeshBuilder, Object, RawProjection, StaticMeshKind
from rend3_tpu_torch.utils import math as m3

SIZE, SAMPLES = 64, 4
# JAX's converged caps for msaa_slice at 64x64 and 4 samples: one peel of
# each kind, every list and queue at its floor.
JAX_CAPS = {
    "shadow": 4096, "tile_shadow_mult": 1, "fl_shadow": 2048, "main": 4096, "resid": 4096, "cut": 4096,
    "blend_peels": 1, "tile_main_mult": 1, "tex_pair": 16, "shadow_pair": 32, "cut_peels": 1,
    "blend_px": 65536, "fl_main": 2048, "fl_cut": 2048, "fl_blend": 2048, "q_tex": 1024, "q_cut": 1024,
    "q_blend": 1024, "q_pcf": 1024,
}


@pytest.fixture(autouse=True)
def _goldens_and_threads(monkeypatch):
    monkeypatch.setattr(port_testing, "REFERENCE_RESULTS", jax_testing.REFERENCE_RESULTS)
    torch.set_num_threads(1)


def test_msaa_triangle():
    runner = TestRunner(device="cpu")
    mesh = MeshBuilder(
        np.array([[0.5, -0.5, 0.0], [-0.5, -0.5, 0.0], [0.0, 0.5, 0.0]], np.float32), Handedness.LEFT
    ).build()
    mesh_hdl = runner.add_mesh(mesh)
    mat = runner.add_unlit_material([0.25, 0.5, 0.75, 1.0])
    obj = runner.add_object(Object(mesh_kind=StaticMeshKind(mesh_hdl), material=mat))
    runner.set_camera_data(Camera(projection=RawProjection(np.eye(4)), view=np.eye(4)))
    runner.render_and_compare(FrameRenderSettings(samples=4), "msaa/four.png", Threshold(mae=0.004, ssim=0.98))
    assert runner.base_graph.last_stats["samples"] == 4
    del obj


@pytest.mark.parametrize("samples", [1, 4])
def test_sample_coverage(samples):
    runner = TestRunner(device="cpu")
    mat = runner.add_unlit_material([1.0, 1.0, 1.0, 1.0])
    base = m3.translation([0.5, 0.5, 0.0]) @ m3.scale([0.5, 0.5, 1.0])
    objs = []
    for x in range(64):
        for y in range(64):
            t = m3.translation([x, y, 0.0]) @ m3.scale([1.0 - x / 63.0, 1.0 - y / 63.0, 1.0]) @ base
            objs.append(runner.plane(mat, t))
    runner.set_camera_data(
        Camera(projection=RawProjection(m3.orthographic_lh(0.0, 64.0, 64.0, 0.0, 0.0, 1.0)), view=np.eye(4))
    )
    runner.render_and_compare(
        FrameRenderSettings(samples=samples), f"msaa/sample-coverage-{samples}.png", Threshold(mae=0.01, ssim=0.93)
    )


def msaa_slice(runner, mat, mod, mm3):
    """The whole slice in a few triangles; `mat`, `mod`, `mm3` are the
    material, types and math modules of the package that renders it."""
    r = runner.renderer
    keep = [runner.add_directional_light(np.array([-0.7, -1.0, 0.4], np.float32))]
    ground = runner.add_lit_material([0.35, 0.35, 0.33, 1.0])
    keep += [ground, runner.plane(ground, mm3.rotation_x(-np.pi / 2) @ mm3.scale(3.0))]
    v = np.array([[-1, 1, 0], [1, 1, 0], [1, -1, 0], [-1, -1, 0]], np.float32)
    alpha = np.array([0.0, 1.0, 0.2, 0.9], np.float32)
    col = np.concatenate([np.tile([[0.3, 0.8, 0.2]], (4, 1)), alpha[:, None]], axis=1).astype(np.float32)
    quad = r.add_mesh(
        mod.MeshBuilder(v, mod.Handedness.LEFT).with_vertex_colors(col)
        .with_indices(np.array([0, 1, 2, 2, 3, 0, 0, 2, 1, 2, 0, 3], np.uint32)).build()
    )
    leaf = r.add_material(mat.PbrMaterial(
        albedo=mat.AlbedoComponent(value=np.ones(4, np.float32), vertex=True),
        transparency=mat.Transparency.cutout_at(0.5),
    ))
    glass = r.add_material(mat.PbrMaterial(
        albedo=mat.AlbedoComponent.new_value(np.array([0.4, 0.7, 0.9, 0.35], np.float32)),
        transparency=mat.Transparency.blend(),
    ))
    keep += [quad, leaf, glass]
    for m, pos, sc in ((leaf, [0.0, 0.8, 0.2], 0.8), (glass, [0.35, 0.75, -0.9], 0.55)):
        keep.append(r.add_object(mod.Object(
            mesh_kind=mod.StaticMeshKind(quad), material=m, transform=mm3.translation(pos) @ mm3.scale(sc),
        )))
    runner.set_camera_data(mod.Camera(
        projection=mod.Perspective(vfov=60.0, near=0.1),
        view=mm3.look_at_lh([0.4, 1.6, -3.2], [0.0, 0.6, 0.0], [0.0, 1.0, 0.0]),
    ))
    return keep


@pytest.fixture(scope="module")
def slice_frames():
    runner = TestRunner(device="cpu")
    keep = msaa_slice(runner, material, types, m3)
    settings = FrameRenderSettings(size=SIZE, samples=SAMPLES)
    on = [runner.render_frame(settings) for _ in range(2)]
    stats = dict(runner.base_graph.last_stats)
    runner.base_graph.occlusion_culling = False
    off = runner.render_frame(settings)
    del keep
    return on, off, stats


def test_slice_scene_matches_jax(slice_frames):
    on, _off, stats = slice_frames
    assert stats["samples"] == SAMPLES
    assert stats["cut_survivors"] > 0 and stats["cut_peels"] == JAX_CAPS["cut_peels"], stats
    assert stats["blend_peels"] == JAX_CAPS["blend_peels"] and stats["blend_px"] > 0, stats
    assert (on[0][..., :3] != 0).any(-1).mean() > 0.3
    jr = jax_testing.TestRunner()
    jr.base_graph._caps.update(JAX_CAPS)
    jr.base_graph.occlusion_culling = False
    keep = msaa_slice(jr, jax_material, jax_types, jax_m3)
    ref = jr.render_frame(jax_testing.FrameRenderSettings(size=SIZE, samples=SAMPLES))
    assert jr.base_graph._caps == {**jr.base_graph._caps, **JAX_CAPS}, "JAX regrew a cap (a second compile)"
    del keep
    assert on[0].shape == ref.shape == (SIZE, SIZE, 4)
    assert int(np.abs(on[0].astype(np.int32) - ref.astype(np.int32)).max()) <= 1


def test_slice_scene_occlusion_is_image_neutral(slice_frames):
    on, off, _stats = slice_frames
    for img in on:
        np.testing.assert_array_equal(img, off)
