"""Alpha-blended depth peels, and the whole slice, in the PyTorch port
against the JAX package on the CPU.

- tests/test_blend.py's scene (three unlit glass layers over a half
  backstop) through the port: within 1 u8 of JAX's deferred render and of
  its forward "reference" render (the ordered full-image scan).
- tests/test_caps.py:184-245's scene: one lit glass pane needs exactly one
  peel; five stacked panes exactly five, within 1 u8 of JAX.
- Eighteen stacked glass layers: past JAX's clamp of 16 blend peels, so the
  port is held to JAX's forward "reference" render (every layer
  composited), within 1 u8.
- A small scene of the whole slice (scenes.peel_slice): an opaque ground,
  two crossing double-sided textured leaf quads (alpha cutout), two
  overlapping glass panes (one textured) and two shadowed lights, with
  occlusion culling on, within 1 u8 of JAX.
"""

import numpy as np
import pytest
import torch

import rend3_tpu.testing as jax_testing
from rend3_tpu import types as jax_types
from rend3_tpu.routine.pbr import material as jax_material
from rend3_tpu.utils import math as jax_m3
from rend3_tpu_torch import scenes, types
from rend3_tpu_torch.routine.pbr import material
from rend3_tpu_torch.testing import FrameRenderSettings, TestRunner
from rend3_tpu_torch.utils import math as m3

PORT = (TestRunner, FrameRenderSettings, material, types, m3)
JAX = (jax_testing.TestRunner, jax_testing.FrameRenderSettings, jax_material, jax_types, jax_m3)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _max_diff(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def _render(pkg, build, size, monkeypatch=None, backend=None, blend_peels=None, caps=None):
    """Renders build(runner, pkg) on the CPU; `backend` sets the JAX
    package's raster backend for this render. `blend_peels` starts the JAX
    blend peel cap at the value its controller converges to for the scene
    (tests/test_caps.py shows it does), and `caps` all of JAX's caps, so JAX
    compiles the converged frame program once instead of once per regrow.
    Returns (image, stats)."""
    runner_cls, settings_cls = pkg[:2]
    if backend is not None:
        monkeypatch.setenv("REND3_TPU_RASTER", backend)
    runner = runner_cls(device="cpu") if pkg is PORT else runner_cls()
    if pkg is JAX:
        runner.base_graph._caps.update(caps or {})
    if blend_peels is not None and pkg is JAX:
        runner.base_graph._caps["blend_peels"] = blend_peels
    keep = build(runner, pkg)
    img = runner.render_frame(settings_cls(size=size))
    stats = dict(runner.base_graph.last_stats)
    if backend is not None:
        monkeypatch.delenv("REND3_TPU_RASTER")
    del keep
    return img, stats


def _glass_stack(layers):
    def build(runner, pkg):
        return scenes.glass_stack(runner, layers, *pkg[2:])

    return build


def test_blend_scene_matches_jax_deferred_and_reference(monkeypatch):
    build = _glass_stack(scenes.GLASS_LAYERS)
    port, stats = _render(PORT, build, 64)
    deferred, _ = _render(JAX, build, 64, blend_peels=3)
    forward, _ = _render(JAX, build, 64, monkeypatch, "reference")
    assert (port[:, :, 0] > 10).any() and (port[:, :, 2] > 10).any()
    assert stats["blend_peels"] == 3 and stats["blend_px"] > 0, stats
    assert _max_diff(port, deferred) <= 1
    assert _max_diff(port, forward) <= 1


def test_eighteen_glass_layers_match_jax_reference(monkeypatch):
    """More layers than JAX's deferred build peels (16): every layer is
    composited, as the forward scan does."""
    rng = np.random.default_rng(4)
    layers = [
        (0.05 + 0.045 * i, 0.9 - 0.02 * i, (*rng.uniform(0.1, 1.0, 3), 0.15))
        for i in range(18)
    ]
    build = _glass_stack(layers)
    port, stats = _render(PORT, build, 64)
    forward, _ = _render(JAX, build, 64, monkeypatch, "reference")
    assert stats["blend_peels"] == 18, stats
    assert _max_diff(port, forward) <= 1


def _caps_panes(n):
    """test_caps.py:184-245's scene with n stacked lit glass panes."""

    def build(runner, pkg):
        _r, _s, mat, mod, mm3 = pkg
        r = runner.renderer
        keep = [runner.add_directional_light(np.array([-1.0, -1.0, 1.0], np.float32))]
        mat_bg = runner.add_lit_material([0.3, 0.3, 0.3, 1.0])
        keep += [mat_bg, runner.plane(mat_bg, mm3.rotation_x(-np.pi / 2))]
        glass = r.add_material(mat.PbrMaterial(
            albedo=mat.AlbedoComponent.new_value(np.array([0.4, 0.7, 0.9, 0.4], np.float32)),
            transparency=mat.Transparency.blend(),
        ))
        quad_v = np.array([[-1, 1, 0], [1, 1, 0], [1, -1, 0], [-1, -1, 0]], np.float32)
        quad = r.add_mesh(
            mod.MeshBuilder(quad_v, mod.Handedness.LEFT).with_indices(np.array([0, 1, 2, 2, 3, 0], np.uint32)).build()
        )
        keep += [glass, quad]
        for i in range(n):
            keep.append(r.add_object(mod.Object(
                mesh_kind=mod.StaticMeshKind(quad), material=glass,
                transform=mm3.translation([0.0, 0.3, -0.5 - 0.12 * i]) @ mm3.scale(0.4),
            )))
        runner.set_camera_data(mod.Camera(
            projection=mod.Orthographic(size=np.array([2.5, 2.5, 5.0], np.float32)),
            view=mm3.look_at_lh([0.0, 1.0, -1.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
        ))
        return keep

    return build


def test_caps_blend_scene_peel_counts():
    one, stats1 = _render(PORT, _caps_panes(1), 64)
    assert one[..., :3].max() > 0
    assert stats1["blend_peels"] == 1, stats1
    five, stats5 = _render(PORT, _caps_panes(5), 64)
    ref, _ = _render(JAX, _caps_panes(5), 64, blend_peels=5)
    assert stats5["blend_peels"] == 5, stats5
    assert _max_diff(five, ref) <= 1


# JAX's caps for scenes.peel_slice at 128x128 as its controller converges
# them, so that it compiles the converged frame program at once.
PEEL_SLICE_CAPS = {
    "shadow": 4096, "tile_shadow_mult": 1, "fl_shadow": 2048, "main": 4096, "resid": 4096, "cut": 4096,
    "blend_peels": 2, "tile_main_mult": 1, "tex_pair": 16, "shadow_pair": 32, "cut_peels": 2, "blend_px": 65536,
    "fl_main": 2048, "fl_cut": 2048, "fl_blend": 2048, "q_tex": 1024, "q_cut": 1024, "q_blend": 1024, "q_pcf": 1024,
}


def test_slice_scene_matches_jax():
    port, stats = _render(PORT, lambda runner, pkg: scenes.peel_slice(runner, *pkg[2:]), 128)
    ref, _ = _render(JAX, lambda runner, pkg: scenes.peel_slice(runner, *pkg[2:]), 128, caps=PEEL_SLICE_CAPS)
    assert stats["cut_survivors"] > 0 and stats["cut_peels"] >= 1, stats
    assert stats["blend_peels"] >= 2 and stats["blend_px"] > 0, stats
    assert (port[..., :3] != 0).any(-1).mean() > 0.3
    assert _max_diff(port, ref) <= 1
