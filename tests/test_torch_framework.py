"""The framework layer of the PyTorch port on the CPU: the eight cases of
tests/test_framework.py (AssetLoader, first-person controls, the overlay
hook), run against the port; a 64x64 App with an overlay through both
packages' render_single_frame, within 1 u8; OVERLAY_ON_DEVICE True
against False, within 1 u8; the profiling scopes in the chrome trace."""

import json
import math
import os

import numpy as np
import pytest
import torch

from rend3_tpu import framework as JF
from rend3_tpu import overlay as JO
from rend3_tpu_torch import framework
from rend3_tpu_torch.framework.assets import AssetFileError, AssetLoader, AssetNetworkError, AssetPath
from rend3_tpu_torch.framework.camera import FirstPersonControls
from rend3_tpu_torch.utils import math as m3
from rend3_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# -- AssetLoader (rend3-framework/src/assets.rs:23-64) -------------------------


def test_asset_loader_path_resolution(tmp_path):
    loader = AssetLoader(str(tmp_path))
    assert loader.get_asset_path("a/b.bin") == os.path.join(str(tmp_path), "a/b.bin")
    assert loader.get_asset_path(AssetPath.external_("/abs/c.bin")) == "/abs/c.bin"
    url = AssetLoader("http://localhost:8000/resources/")
    assert url.get_asset_path("skybox.ktx2") == "http://localhost:8000/resources/skybox.ktx2"


def test_asset_loader_file_fetch(tmp_path):
    p = tmp_path / "scene.bin"
    p.write_bytes(b"\x01\x02\x03")
    loader = AssetLoader(str(tmp_path))
    assert loader.get_asset("scene.bin") == b"\x01\x02\x03"
    with pytest.raises(AssetFileError):
        loader.get_asset("missing.bin")


def test_asset_loader_data_uri_and_network_gate():
    loader = AssetLoader("")
    assert loader.get_asset(AssetPath.external_("data:application/octet-stream;base64,AQID")) == b"\x01\x02\x03"
    with pytest.raises(AssetNetworkError):
        loader.get_asset(AssetPath.external_("https://example.com/a.bin"))


# -- FirstPersonControls (examples/src/scene_viewer/mod.rs:545-643) ------------


def test_controls_view_matches_euler_composition():
    c = FirstPersonControls(location=np.array([1.0, 2.0, 3.0], np.float32), pitch=0.3, yaw=-0.7)
    expect = m3.rotation_x(-0.3) @ m3.rotation_y(0.7) @ m3.translation(np.array([-1.0, -2.0, -3.0], np.float32))
    np.testing.assert_allclose(c.view_matrix(), expect, atol=1e-6)


def test_controls_forward_motion_and_run():
    c = FirstPersonControls(location=np.zeros(3, np.float32), walk_speed=10.0, run_speed=50.0)
    c.key("w")
    c.update(0.1)
    np.testing.assert_allclose(c.location, [0.0, 0.0, -1.0], atol=1e-6)
    c.key("shift")
    c.update(0.1)
    np.testing.assert_allclose(c.location, [0.0, 0.0, -6.0], atol=1e-5)


def test_controls_mouse_look_clamps_and_wraps():
    c = FirstPersonControls()
    c.mouse(0.0, -10000.0)
    assert c.pitch == pytest.approx(math.pi / 2 - 1e-4)
    c.mouse(-1000.0 * math.tau + 500.0, 0.0)
    assert 0.0 <= c.yaw < math.tau


def test_walk_script_steps_and_commands():
    c = FirstPersonControls(location=np.zeros(3, np.float32), walk_speed=6.0)
    steps = list(c.run_script("w,w,yaw:90,dt:0.5,w"))
    assert len(steps) == 3
    assert c.location[2] == pytest.approx(-2 * 6.0 / 60.0, abs=1e-5)
    assert c.location[0] == pytest.approx(-3.0, abs=1e-4)


# -- overlay hook in the frame loop -------------------------------------------


def _overlay_app(fw, ov, on_device=False):
    """A 64x64 App: one unlit quad, and over it an opaque white UI square, a
    translucent textured panel and a fractional-vertex triangle."""

    class App(fw.App):
        OVERLAY_ON_DEVICE = on_device

        def clear_color(self):
            return (0.0, 0.0, 0.0, 1.0)

        def setup(self, context):
            r = context.renderer
            self.keep = _lit_quad(r, fw)
            tex = np.zeros((4, 4, 4), np.uint8)
            tex[..., 0] = np.arange(4)[None, :] * 60
            tex[..., 1] = 200
            tex[..., 3] = np.arange(4)[:, None] * 60 + 40
            self.tex = context.overlay.add_texture(tex)

        def overlay_jobs(self, ctx):
            quad = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
            return [
                ov.PaintJob(vertices=np.array([[2, 2], [30, 2], [30, 30], [2, 30]], np.float32),
                            colors=np.full((4, 4), 255, np.uint8), indices=quad),
                ov.PaintJob(vertices=np.array([[20.25, 24.5], [60.75, 24.5], [60.75, 58.0], [20.25, 58.0]],
                                              np.float32),
                            colors=np.tile(np.array([120, 90, 255, 170], np.uint8), (4, 1)), indices=quad,
                            uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32), texture=self.tex),
                ov.PaintJob(vertices=np.array([[5.3, 40.1], [33.7, 61.9], [3.2, 62.6]], np.float32),
                            colors=np.array([[255, 0, 0, 200], [0, 255, 0, 120], [0, 0, 255, 255]], np.uint8),
                            indices=np.array([[0, 1, 2]], np.uint32), clip_rect=(4.0, 44.0, 30.0, 64.0)),
            ]

    return App()


def _lit_quad(r, fw):
    """An unlit green quad in front of the default camera (handles kept)."""
    import importlib

    pkg = fw.__name__.rsplit(".", 1)[0]
    types = importlib.import_module(pkg + ".types")
    mat = importlib.import_module(pkg + ".routine.pbr.material")
    mesh = (
        types.MeshBuilder(np.array([[-1, -1, 0], [-1, 1, 0], [1, 1, 0], [1, -1, 0]], np.float32),
                          types.Handedness.LEFT)
        .with_indices(np.array([0, 2, 1, 0, 3, 2], np.uint32)).build()
    )
    m = r.add_mesh(mesh)
    material = r.add_material(mat.PbrMaterial(albedo=mat.AlbedoComponent.new_value([0.2, 0.7, 0.3, 1.0]),
                                              unlit=True))
    view = np.eye(4, dtype=np.float32)
    view[2, 3] = 3.0
    r.set_camera_data(types.Camera(projection=types.Perspective(vfov=60.0, near=0.1), view=view))
    return m, material, r.add_object(types.Object(mesh_kind=types.StaticMeshKind(m), material=material,
                                                  transform=np.eye(4, dtype=np.float32)))


def test_framework_overlay_composites():
    from rend3_tpu_torch import overlay

    class App(framework.App):
        def clear_color(self):
            return (0.0, 0.0, 0.0, 1.0)

        def overlay_jobs(self, ctx):
            v = np.array([[2, 2], [30, 2], [30, 30], [2, 30]], np.float32)
            c = np.full((4, 4), 255, np.uint8)
            return [overlay.PaintJob(vertices=v, colors=c, indices=np.array([[0, 1, 2], [0, 2, 3]], np.uint32))]

    img = framework.render_single_frame(App(), 64, 64, device="cpu")
    assert img.shape == (64, 64, 4) and img.dtype == np.uint8
    assert img[10, 10, :3].min() == 255
    assert img[50, 50, :3].max() == 0


@pytest.fixture(scope="module")
def port_frames():
    """The overlay App's frame through the port with the host compositor and
    with the device pass."""
    from rend3_tpu_torch import overlay

    return {on: framework.render_single_frame(_overlay_app(framework, overlay, on), 64, 64, device="cpu")
            for on in (False, True)}


def test_overlay_app_matches_jax(port_frames):
    want = JF.render_single_frame(_overlay_app(JF, JO), 64, 64)
    got = port_frames[False]
    assert got.shape == want.shape == (64, 64, 4)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (got[..., :3] != 0).any(-1).mean() > 0.5  # quad and UI drawn


def test_overlay_on_device_matches_host(port_frames):
    host, dev = port_frames[False], port_frames[True]
    np.testing.assert_array_equal(dev[..., 3], host[..., 3])
    assert np.abs(dev.astype(int) - host.astype(int)).max() <= 1
    assert dev[10, 10, :3].min() == 255


def test_overlay_pass_registered_once_for_static_ui(monkeypatch):
    """Three frames of unchanged UI register the pass once: it is rebaked
    only when _overlay_key changes."""
    from rend3_tpu_torch import overlay

    registered = []
    real = framework.BaseRenderGraph.register_pass

    def spy(self, fn, stage="srgb"):
        registered.append(fn)
        real(self, fn, stage)

    monkeypatch.setattr(framework.BaseRenderGraph, "register_pass", spy)
    imgs = framework.start(_overlay_app(framework, overlay, True), 64, 64, frames=3, device="cpu")
    assert len(registered) == 1
    assert all(np.array_equal(imgs[0], im) for im in imgs[1:])


def test_profiling_trace_holds_both_scopes(tmp_path):
    from rend3_tpu_torch import overlay

    profiling.enable()
    try:
        framework.render_single_frame(_overlay_app(framework, overlay), 64, 64, device="cpu")
    finally:
        profiling.disable()
    path = tmp_path / "trace.json"
    profiling.dump_chrome_trace(str(path))
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]}
    assert {"Renderer::evaluate_instructions", "BaseRenderGraph::build_frame_callable"} <= names
    s = profiling.stats()
    assert s.counts["Renderer::evaluate_instructions"] == 1 and "ms avg" in s.summary()

    with profiling.device_trace(str(tmp_path / "dev")):
        framework.render_single_frame(_overlay_app(framework, overlay), 64, 64, device="cpu")
    events = json.loads((tmp_path / "dev" / "trace.json").read_text())["traceEvents"]
    assert events
