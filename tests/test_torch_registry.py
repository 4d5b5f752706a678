"""Registered material routines and injected passes of the PyTorch port on
the CPU: the six scenes of tests/test_routine_registry.py through the port.

- The opaque scene (a FlatMaterial cube over a PBR plane, the unlit
  routine) and one combined scene of a cutout routine's pane and a blend
  routine's pane are held against JAX's images within 1 u8 level.
- The rest use the JAX tests' own mask checks: an unregistered archetype
  does not draw (and, hidden from the shadow maps too, leaves the image it
  would give without the object), a blend routine composites, a cutout
  routine discards through its alpha callback, and register_pass /
  unregister_pass run at the "srgb" and "hdr" stages.
- apply_material_routines against JAX's on a random G-buffer, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import rend3_tpu.testing as jax_testing
from rend3_tpu import types as jax_types
from rend3_tpu.ops import deferred as JD
from rend3_tpu.ops import lighting as JL
from rend3_tpu.routine import registry as JR
from rend3_tpu.routine.pbr import material as jax_material
from rend3_tpu.utils import math as jax_m3
from rend3_tpu_torch import scenes, types
from rend3_tpu_torch.ops import blit
from rend3_tpu_torch.ops import deferred as PD
from rend3_tpu_torch.ops import lighting as PL
from rend3_tpu_torch.routine import registry as PREG
from rend3_tpu_torch.routine.registry import GBufferPixels, MaterialRoutine, unlit_routine
from rend3_tpu_torch.testing import FrameRenderSettings, TestRunner
from rend3_tpu_torch.utils import math as m3

SIZE = 128
FLAT = scenes.flat_material_class("FlatMaterial")
FLAT_BLEND = scenes.flat_material_class("FlatBlendMaterial", blend=True)
J_FLAT = scenes.flat_material_class("FlatMaterial", types=jax_types)
J_FLAT_BLEND = scenes.flat_material_class("FlatBlendMaterial", blend=True, types=jax_types)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _masks(img):
    f = img.astype(np.float32) / 255.0
    red = (f[..., 0] > 0.6) & (f[..., 1] < 0.3) & (f[..., 2] < 0.3)
    green = (f[..., 1] > 0.15) & (f[..., 0] < f[..., 1]) & (f[..., 2] < f[..., 1])
    return red, green


def _max_diff(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def _render(runner, samples=1):
    return runner.render_frame(FrameRenderSettings(size=SIZE, samples=samples))


def test_registered_archetype_draws_alongside_pbr_and_matches_jax():
    runner = TestRunner(device="cpu")
    keep = scenes.registry_scene(runner, FLAT)
    runner.base_graph.register_routine(unlit_routine(FLAT))
    img = _render(runner)
    red, green = _masks(img)
    assert red.sum() > 50, f"FlatMaterial cube missing ({red.sum()} red px)"
    assert green.sum() > 500, f"PBR plane missing ({green.sum()} green px)"
    jr = jax_testing.TestRunner()
    jkeep = scenes.registry_scene(jr, J_FLAT, mat=jax_material, types=jax_types, m3=jax_m3)
    jr.base_graph.register_routine(JR.unlit_routine(J_FLAT))
    assert _max_diff(img, jr.render_frame(jax_testing.FrameRenderSettings(size=SIZE))) <= 1
    del keep, jkeep


def test_unregistered_archetype_does_not_draw_or_cast():
    runner = TestRunner(device="cpu")
    keep = scenes.registry_scene(runner, FLAT)  # no register_routine
    img = _render(runner)
    red, _green = _masks(img)
    assert red.sum() == 0, f"unregistered archetype drew {red.sum()} px"
    # Hidden from the shadow maps too: the image is the scene's without the cube.
    bare = TestRunner(device="cpu")
    bkeep = scenes.registry_scene(bare, FLAT)
    del bkeep[-1]  # the cube object
    np.testing.assert_array_equal(img, _render(bare))
    del keep


def _pane(r, T, mm3, material, z, x=0.0, s=0.8):
    """A quad at depth z facing the -z ortho camera (test_blend winding)."""
    v = np.array([[-s, s, z], [s, s, z], [s, -s, z], [-s, -s, z]], np.float32)
    mesh = r.add_mesh(T.MeshBuilder(v, T.Handedness.LEFT).with_indices(np.array([0, 1, 2, 2, 3, 0], np.uint32)).build())
    return [mesh, r.add_object(T.Object(
        mesh_kind=T.StaticMeshKind(mesh), material=material, transform=mm3.translation([x, 0.5, 0.0]),
    ))]


def _pane_scene(runner, T, mm3, panes):
    """A lit green plane, then (material, z, x) panes, ortho from -z."""
    keep = [runner.add_directional_light(np.array([-1.0, -1.0, 1.0], np.float32))]
    pbr = runner.add_lit_material([0.1, 0.6, 0.1, 1.0])
    keep += [pbr, runner.plane(pbr, mm3.rotation_x(-np.pi / 2) @ mm3.scale(3.0))]
    for material, z, x in panes:
        keep += [material] + _pane(runner.renderer, T, mm3, material, z, x)
    runner.set_camera_data(T.Camera(
        projection=T.Orthographic(size=np.array([4.0, 4.0, 8.0], np.float32)),
        view=mm3.look_at_lh([0.0, 0.5, -2.0], [0.0, 0.5, 0.0], [0.0, 1.0, 0.0]),
    ))
    return keep


def _half_alpha(pixels, mdata, mflags):
    """Discard where view-space x is on the left half."""
    return (pixels.view_pos[:, 0] > 0.0).float()


def test_registered_blend_routine_composites():
    runner = TestRunner(device="cpu")
    glass = runner.renderer.add_material(FLAT_BLEND([0.9, 0.02, 0.02, 0.5]))
    keep = _pane_scene(runner, types, m3, [(glass, 0.5, 0.0)])
    runner.base_graph.register_routine(
        MaterialRoutine(FLAT_BLEND, shade=unlit_routine(FLAT).shade, transparency="blend")
    )
    f = _render(runner).astype(np.float32) / 255.0
    reddish = (f[..., 0] > 0.25) & (f[..., 0] < 0.95) & (f[..., 1] < f[..., 0])
    assert reddish.sum() > 200, f"blend routine pane missing ({reddish.sum()} px)"
    assert runner.base_graph.last_stats["blend_px"] > 200
    del keep


def test_registered_cutout_routine_discards():
    runner = TestRunner(device="cpu")
    cut = runner.renderer.add_material(FLAT([0.9, 0.02, 0.02, 1.0]))
    keep = _pane_scene(runner, types, m3, [(cut, 0.5, 0.0)])
    runner.base_graph.register_routine(
        MaterialRoutine(FLAT, shade=unlit_routine(FLAT).shade, transparency="cutout", alpha=_half_alpha,
                        alpha_cutoff=0.5)
    )
    red, _green = _masks(_render(runner))
    left, right = red[:, : SIZE // 2].sum(), red[:, SIZE // 2 :].sum()
    assert red.sum() > 100, f"cutout routine pane missing ({red.sum()} px)"
    assert min(left, right) == 0 and max(left, right) > 100, (left, right)
    assert runner.base_graph.last_stats["cut_survivors"] > 0
    del keep


def test_cutout_and_blend_routines_match_jax():
    """A cutout routine's pane behind a blend routine's pane that covers
    part of it, against JAX."""
    def jax_alpha(pixels, mdata, mflags):
        return (pixels.view_pos[:, 0] > 0.0).astype(jnp.float32)

    imgs = []
    for T, reg, mm3, flat, flat_blend, alpha, runner, settings in (
        (types, PREG, m3, FLAT, FLAT_BLEND, _half_alpha, TestRunner(device="cpu"), FrameRenderSettings),
        (jax_types, JR, jax_m3, J_FLAT, J_FLAT_BLEND, jax_alpha, jax_testing.TestRunner(),
         jax_testing.FrameRenderSettings),
    ):
        r = runner.renderer
        cut = r.add_material(flat([0.9, 0.02, 0.02, 1.0]))
        glass = r.add_material(flat_blend([0.1, 0.2, 0.9, 0.5]))
        keep = _pane_scene(runner, T, mm3, [(cut, 0.5, 0.0), (glass, 0.2, 1.2)])
        runner.base_graph.register_routine(reg.MaterialRoutine(
            flat, shade=reg.unlit_routine(flat).shade, transparency="cutout", alpha=alpha, alpha_cutoff=0.5,
        ))
        runner.base_graph.register_routine(reg.MaterialRoutine(
            flat_blend, shade=reg.unlit_routine(flat).shade, transparency="blend",
        ))
        imgs.append(runner.render_frame(settings(size=SIZE)))
        del keep
    red, _green = _masks(imgs[0])
    f = imgs[0].astype(np.float32) / 255.0
    blended = (f[..., 2] > f[..., 1] + 0.1) & (f[..., 0] > 0.25)  # the blue glass over the red pane
    assert red.sum() > 100 and blended.sum() > 100, (red.sum(), blended.sum())
    assert red[:, : SIZE // 2].sum() == 0
    assert _max_diff(imgs[0], imgs[1]) <= 1


def test_injected_srgb_pass_runs_inside_frame_and_unregisters():
    runner = TestRunner(device="cpu")
    keep = scenes.registry_scene(runner, FLAT)
    runner.base_graph.register_routine(unlit_routine(FLAT))

    def corner_tint(img, gbuf, uniforms):
        out = img.clone()
        out[:16, :16] = 255
        return out

    runner.base_graph.register_pass(corner_tint)
    img = _render(runner)
    assert (img[:16, :16] == 255).all(), "injected pass did not run"
    assert not (img[32:, 32:] == 255).all()
    runner.base_graph.unregister_pass(corner_tint)
    assert not (_render(runner)[:16, :16] == 255).all()
    runner.base_graph.unregister_pass(corner_tint)  # absent: a no-op
    with pytest.raises(ValueError, match="stage"):
        runner.base_graph.register_pass(corner_tint, stage="ldr")
    del keep


def test_injected_hdr_pass_runs_pre_tonemap():
    runner = TestRunner(device="cpu")
    keep = scenes.registry_scene(runner, FLAT)
    runner.base_graph.register_routine(unlit_routine(FLAT))

    def hdr_patch(img, gbuf, uniforms):
        out = img.clone()
        out[:16, :16] = 0.5
        return out

    runner.base_graph.register_pass(hdr_patch, stage="hdr")
    img = _render(runner)
    want = blit.hdr_to_srgb_u8(torch.full((1, 1, 4), 0.5))[0, 0].numpy()
    np.testing.assert_array_equal(img[:16, :16], np.broadcast_to(want, (16, 16, 4)))
    assert not (img[32:, 32:, :3] == want[:3]).all()
    del keep


def test_passes_get_sample_zero_gbuffer_and_row0():
    """Under MSAA a pass sees the resolved image and sample 0's padded
    G-buffer; a four-parameter pass also gets row0 = 0."""
    runner = TestRunner(device="cpu")
    keep = scenes.registry_scene(runner, FLAT)
    runner.base_graph.register_routine(unlit_routine(FLAT))
    seen = {}

    def hdr_probe(img, gbuf, uniforms, row0):
        seen["hdr"] = (tuple(img.shape), img.dtype, tuple(gbuf.data.shape), row0)
        seen["hits"] = int((gbuf.data[PD.G_HIT] > 0).sum())
        return img

    def srgb_probe(img, gbuf, uniforms):
        seen["srgb"] = (tuple(img.shape), img.dtype)
        return img

    runner.base_graph.register_pass(hdr_probe, stage="hdr")
    runner.base_graph.register_pass(srgb_probe)
    _render(runner, samples=4)
    assert seen["hdr"] == ((SIZE, SIZE, 4), torch.float32, (PD.GB_CH, SIZE, SIZE), 0)
    assert seen["srgb"] == ((SIZE, SIZE, 4), torch.uint8)
    assert 1000 < seen["hits"] < SIZE * SIZE
    del keep


def test_apply_material_routines_matches_jax():
    rng = np.random.default_rng(11)
    hh, ww = 8, 128
    N = hh * ww
    g = np.zeros((PD.GB_CH, N), np.float32)
    den = rng.uniform(0.5, 2.0, N).astype(np.float32)
    g[PD.G_DEN] = den
    for off, n in ((PD.G_VP, 3), (PD.G_NRM, 3), (PD.G_TAN, 3), (PD.G_UV0, 2), (PD.G_UV1, 2), (PD.G_COL, 4)):
        g[off : off + n] = rng.uniform(-1.0, 1.0, (n, N)) * den
    g[PD.G_MAT] = rng.integers(0, 80, N)
    g[PD.G_HIT] = rng.random(N) < 0.9
    g = g.reshape(PD.GB_CH, hh, ww)
    img = rng.random((hh, ww, 4)).astype(np.float32)
    data = [rng.random((8, 4)).astype(np.float32), rng.random((8, 4)).astype(np.float32)]
    flags = [np.zeros(8, np.int32), np.zeros(8, np.int32)]

    def tinted(pixels, mdata, mflags, dl, pl, sv, u):
        return mdata[:, :4] * pixels.vcol + pixels.uv1[:, :1] * pixels.nrm[:, :1]

    want = JL.apply_material_routines(
        jnp.asarray(img), JD.GBuffer(data=jnp.asarray(g)),
        [(64, 8, JR.unlit_routine(J_FLAT), jnp.asarray(data[0]), jnp.asarray(flags[0])),
         (72, 8, JR.MaterialRoutine(J_FLAT_BLEND, shade=tinted), jnp.asarray(data[1]), jnp.asarray(flags[1]))],
        None, None, None, None,
    )
    got = PL.apply_material_routines(
        torch.from_numpy(img), PD.GBuffer(torch.from_numpy(g)),
        [(64, 8, unlit_routine(FLAT), torch.from_numpy(data[0]), torch.from_numpy(flags[0])),
         (72, 8, MaterialRoutine(FLAT_BLEND, shade=tinted), torch.from_numpy(data[1]), torch.from_numpy(flags[1]))],
        None, None, None, None,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != img).any(-1).mean() > 0.1


def test_routine_validation():
    with pytest.raises(ValueError, match="alpha"):
        MaterialRoutine(FLAT, shade=unlit_routine(FLAT).shade, transparency="cutout")
    with pytest.raises(ValueError, match="transparency"):
        MaterialRoutine(FLAT, shade=unlit_routine(FLAT).shade, transparency="glass")
    assert isinstance(GBufferPixels._fields, tuple) and unlit_routine(FLAT).archetype == "FlatMaterial"
