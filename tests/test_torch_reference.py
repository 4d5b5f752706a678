"""The reference forward backend (REND3_TPU_RASTER=reference) of the
PyTorch port against the JAX package on the CPU.

- raster.rasterize on tests/test_raster_fast.py's random soups (64
  triangles, 128x128): seeds 0-2 x cull BACK / FRONT / NONE, MSAA 4, a
  perspective soup, a fragment mask, an initial buffer and a tile window:
  ids equal and depth bit for bit against JAX's rasterize. The JAX scan
  body is compiled by XLA; the port computes its contracted forms.
- chunk invariance: chunk 7 and chunk 256 give the same bits.
- shade.shadow_sample_pcf5 bit for bit, and shade.shade_deferred on a
  textured, shadowed scene (scenes.textured_planes, uv gradients, every
  texture slot) within 2e-3 of JAX's linear RGBA: the port's texels are
  bf16 (the atlas it keeps), JAX's scalar sampler reads f32 texels.
- shadow.sample_shadow_map and sample_shadow_maps (K5's plain version on
  the CPU) bit for bit against JAX's, whose mxu_gather.sample_grid runs in
  interpret mode as its own tests run it.
- 64x64 frames under REND3_TPU_RASTER=reference, each within 1 u8 of the
  JAX package's forward frame: the glass stack, the peel slice (textures,
  two shadowed lights, cutout drawn as opaque, glass), the skybox (at most
  0.1% of the pixels more than 1 u8 off, as the deferred skybox test
  allows: the sky directions' normalisation differs by an ulp or two) and
  the peel slice at MSAA 4.
- test_blend.py::test_blend_peeling_matches_scan_oracle on the port: its
  deferred peels within 1 u8 of its own forward frame.
- raster_scene(backend="reference") is rasterize; default_raster_backend
  reads REND3_TPU_RASTER.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rend3_tpu.testing as jax_testing
from rend3_tpu import types as jax_types
from rend3_tpu.ops import mxu_gather as JMG
from rend3_tpu.ops import raster as JR
from rend3_tpu.ops import shade as JS
from rend3_tpu.ops import shadow as JSh
from rend3_tpu.ops import transform as JT
from rend3_tpu.routine.base import FrameRenderTarget as JaxTarget
from rend3_tpu.routine.pbr import material as jax_material
from rend3_tpu.utils import math as jax_m3
from rend3_tpu_torch import interop, scenes, types
from rend3_tpu_torch.ops import raster as PR
from rend3_tpu_torch.ops import shade as PS
from rend3_tpu_torch.ops import shadow as PSh
from rend3_tpu_torch.ops import transform as PT
from rend3_tpu_torch.routine import base as PB
from rend3_tpu_torch.routine.base import FrameRenderTarget
from rend3_tpu_torch.routine.pbr import material
from rend3_tpu_torch.testing import FrameRenderSettings, TestRunner
from rend3_tpu_torch.utils import math as m3

PORT = (TestRunner, FrameRenderSettings, material, types, m3)
JAX = (jax_testing.TestRunner, jax_testing.FrameRenderSettings, jax_material, jax_types, jax_m3)
N = 64
SIZE = 128


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _soup(n, seed, persp=False):
    """test_raster_fast.py's soup; `persp` gives every corner its own w and z."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1.2, 1.2, (n, 3, 2)).astype(np.float32)
    z = rng.uniform(0.0, 1.0, (n, 1, 1)).astype(np.float32) * np.ones((n, 3, 1), np.float32)
    w = np.ones((n, 3, 1), np.float32)
    if persp:
        w = rng.uniform(0.5, 2.0, (n, 3, 1)).astype(np.float32)
        xy = xy * w
        z = rng.uniform(0.0, 1.0, (n, 3, 1)).astype(np.float32) * w
    return np.concatenate([xy, z, w], axis=2)


def _both(clip, valid=None, **kw):
    """(JAX VisBuffer as numpy, port VisBuffer) of one rasterize call."""
    valid = np.ones(clip.shape[0], bool) if valid is None else valid
    jkw = {k: (v if k != "init" or v is None else JR.VisBuffer(jnp.asarray(v[0]), jnp.asarray(v[1])))
           for k, v in kw.items() if k != "frag_mask_fn"}
    pkw = {k: (v if k != "init" or v is None else PR.VisBuffer(torch.from_numpy(v[0]), torch.from_numpy(v[1])))
           for k, v in kw.items() if k != "frag_mask_fn"}
    if "frag_mask_fn" in kw:
        jkw["frag_mask_fn"], pkw["frag_mask_fn"] = kw["frag_mask_fn"]
    j = JR.rasterize(jnp.asarray(clip), jnp.asarray(valid), SIZE, SIZE, front_is_cw=True, **jkw)
    p = PR.rasterize(torch.from_numpy(clip), torch.from_numpy(valid), SIZE, SIZE, front_is_cw=True, **pkw)
    return (np.asarray(j.depth), np.asarray(j.tri)), p


def _assert_bits(jvis, pvis):
    """ids equal, depth bit for bit (tolerance: none)."""
    np.testing.assert_array_equal(pvis.tri.numpy(), jvis[1])
    np.testing.assert_array_equal(pvis.depth.numpy().view(np.int32), jvis[0].view(np.int32))
    assert (jvis[1] >= 0).mean() > 0.2


@pytest.mark.parametrize("cull", [PR.CullMode.BACK, PR.CullMode.FRONT, PR.CullMode.NONE], ids=["back", "front", "none"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rasterize_matches_jax(seed, cull):
    _assert_bits(*_both(_soup(N, seed), cull_mode=cull))


@pytest.mark.parametrize("persp", [False, True], ids=["flat", "perspective"])
def test_rasterize_msaa4_matches_jax(persp):
    _assert_bits(*_both(_soup(N, 7 if not persp else 4, persp), sample_offsets=PR.MSAA4_OFFSETS))


def test_rasterize_perspective_matches_jax():
    _assert_bits(*_both(_soup(N, 3, True), cull_mode=PR.CullMode.NONE))


def test_rasterize_frag_mask_matches_jax():
    """A cutout-style mask: every third triangle keeps only fragments whose
    perspective barycentric 0 exceeds 0.3."""
    def jmask(ids, bar, pb):
        return (ids % 3 != 0)[:, None, None] | (pb[:, 0] > 0.3)

    def pmask(ids, bar, pb):
        return (ids % 3 != 0)[:, None, None] | (pb[:, 0] > 0.3)

    _assert_bits(*_both(_soup(N, 5, True), cull_mode=PR.CullMode.NONE, frag_mask_fn=(jmask, pmask)))


def test_rasterize_init_matches_jax():
    """Drawn over another soup's visibility buffer: equal depth replaces it."""
    first, _ = _both(_soup(N, 6), cull_mode=PR.CullMode.NONE)
    init = (first[0].copy(), first[1].copy())
    init[0][:, :8] = 0.5  # a band where only nearer triangles win
    _assert_bits(*_both(_soup(N, 8), cull_mode=PR.CullMode.BACK, init=init))


def test_rasterize_tile_matches_jax():
    """A 64x48 window of the 128x128 viewport at (32, 16)."""
    jvis, pvis = _both(_soup(N, 9, True), cull_mode=PR.CullMode.NONE, origin=(32, 16), tile=(64, 48),
                       sample_offsets=PR.MSAA4_OFFSETS)
    assert pvis.tri.shape == (4, 48, 64)
    _assert_bits(jvis, pvis)


def test_rasterize_chunk_invariance():
    clip = torch.from_numpy(_soup(100, 11, True))
    valid = torch.ones(100, dtype=torch.bool)
    a = PR.rasterize(clip, valid, SIZE, SIZE, cull_mode=PR.CullMode.NONE, chunk=7, sample_offsets=PR.MSAA4_OFFSETS)
    b = PR.rasterize(clip, valid, SIZE, SIZE, cull_mode=PR.CullMode.NONE, chunk=256, sample_offsets=PR.MSAA4_OFFSETS)
    assert torch.equal(a.tri, b.tri)
    assert torch.equal(a.depth.view(torch.int32), b.depth.view(torch.int32))


def test_shadow_sample_pcf5_matches_jax():
    """Bit for bit (tolerance: none), taps past the atlas edge included."""
    rng = np.random.default_rng(12)
    atlas = rng.uniform(0.0, 1.0, (96, 80)).astype(np.float32)
    atlas[rng.random(atlas.shape) < 0.3] = 0.0
    uv = rng.uniform(-0.05, 1.05, (40, 50, 2)).astype(np.float32)
    ref = rng.uniform(0.0, 1.0, (40, 50)).astype(np.float32)
    want = np.asarray(JS.shadow_sample_pcf5(jnp.asarray(atlas), jnp.asarray(uv), jnp.asarray(ref)))
    got = PS.shadow_sample_pcf5(torch.from_numpy(atlas), torch.from_numpy(uv), torch.from_numpy(ref)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.05 < (got == 1.0).mean() < 0.95 and (got == 0.0).any()


def _uniforms(cam):
    """The frame uniforms of a camera, as numpy arrays."""
    inv_ovp = np.linalg.inv(cam.origin_view_proj()).astype(np.float32)
    return dict(view=cam.view, view_proj=cam.view_proj(), origin_view_proj=cam.origin_view_proj(),
                inv_view=cam.inv_view, inv_origin_view_proj=inv_ovp, ambient=np.zeros(4, np.float32))


def test_shade_deferred_matches_jax():
    """scenes.textured_planes at 64x64 through both packages' rasterize
    and shade_deferred (textures with uv gradients, the shadow atlas of
    the light's map); linear RGBA within 2e-3 (bf16 texels in the port)."""
    jr = jax_testing.TestRunner()
    keep = scenes.textured_planes(jr, 3, *JAX[2:])
    r = jr.renderer
    r.swap_instruction_buffers()
    ev = r.evaluate_instructions()
    om = r.object_manager
    opaque, _ = om.build_tri_tables(r.mesh_manager)
    geo = r.mesh_manager.evaluate()
    tv, to = jnp.asarray(opaque[:, :3]), jnp.asarray(opaque[:, 3])
    cam = r.camera
    vis_mask = om.enabled & cam.world_frustum.contains_spheres(om.world_spheres)
    mv, mvp = JT.object_uniforms(jnp.asarray(om.transforms), jnp.asarray(cam.view), jnp.asarray(cam.proj))
    cl = JT.clip_triangles(JT.gather_tri_clip(geo.position, tv, to, jnp.asarray(om.bases)[:, 0], mvp),
                           jnp.asarray(vis_mask)[to])
    jvis = JR.rasterize(cl.clip, cl.valid, 64, 64, cull_mode=JR.CullMode.BACK, front_is_cw=True)
    # The light's map placed in the atlas, as the forward frame does.
    (li, (ox, oy), size), = ev.shadow_plan
    svp = ev.dir_light_arrays["view_proj"][0]
    _, smvp = JT.object_uniforms(jnp.asarray(om.transforms), jnp.asarray(svp), jnp.eye(4))
    sc = ev.shadow_cameras[li]
    svis_mask = om.enabled & sc.world_frustum.contains_spheres(om.world_spheres)
    scl = JT.clip_triangles(JT.gather_tri_clip(geo.position, tv, to, jnp.asarray(om.bases)[:, 0], smvp),
                            jnp.asarray(svis_mask)[to])
    smap = JR.rasterize(scl.clip, scl.valid, size, size, cull_mode=JR.CullMode.FRONT, front_is_cw=True).depth[0]
    aw, ah = ev.shadow_atlas_extent
    atlas = jnp.zeros((ah, aw), jnp.float32).at[oy:oy + size, ox:ox + size].set(smap)
    mdata, mflags, mtex = r.material_manager.evaluate("PbrMaterial")
    tex = r.d2_texture_manager.evaluate()
    uni = _uniforms(cam)
    want = np.asarray(JS.shade_deferred(
        jvis, cl, tv, to, geo, jnp.asarray(om.bases), mv, jnp.asarray(om.material_slots),
        JS.PbrMaterialTable(mdata, mflags, mtex), JS.DirLightArrays(**{k: jnp.asarray(v) for k, v in
                                                                      ev.dir_light_arrays.items()}),
        JS.PointLightArrays(**{k: jnp.asarray(v) for k, v in ev.point_light_arrays.items()}), atlas,
        JS.FrameUniformsArrays(**{k: jnp.asarray(v) for k, v in uni.items()}), 64, 64, JR.CENTER_OFFSET,
        textures=tex,
    ))

    t = interop.tensor
    pcl = PT.ClippedTris(clip=t(cl.clip), orig=t(cl.orig, dtype=torch.int64), bary=t(cl.bary), valid=t(cl.valid))
    pvis = PR.rasterize(pcl.clip, pcl.valid, 64, 64, cull_mode=PR.CullMode.BACK, front_is_cw=True)
    np.testing.assert_array_equal(pvis.tri.numpy(), np.asarray(jvis.tri))
    got = PS.shade_deferred(
        pvis, pcl, t(tv), t(to), interop.geometry_arrays(geo), t(om.bases), t(mv), t(om.material_slots),
        PS.PbrMaterialTable(t(mdata), t(mflags), t(mtex)), interop.dir_lights(ev.dir_light_arrays),
        interop.point_lights(ev.point_light_arrays), t(atlas), PS.FrameUniformsArrays(**{k: t(v) for k, v in
                                                                                         uni.items()}),
        64, 64, PR.CENTER_OFFSET, textures=interop.texture_arrays(tex.atlas, tex.rects, tex.mip_counts),
    ).numpy()
    hit = np.asarray(jvis.tri)[0] >= 0
    assert hit.mean() > 0.3 and (np.asarray(smap) > 0).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    del keep


def test_sample_shadow_maps_match_jax():
    """K5's plain version through sample_shadow_map and sample_shadow_maps
    bit for bit against JAX's (interpret mode); the port's overflow / need
    is 0 (K5 has no pair cap)."""
    rng = np.random.default_rng(13)
    maps = [rng.uniform(0.0, 1.0, (s, s)).astype(np.float32) for s in (64, 32)]
    for m in maps:
        m[rng.random(m.shape) < 0.4] = 0.0
    H, W = 32, 128
    entries = []
    for k, mi in enumerate((0, 1, 0)):
        s = maps[mi].shape[0]
        sx = rng.uniform(-3.0, s + 3.0, (H, W)).astype(np.float32)
        sy = rng.uniform(-3.0, s + 3.0, (H, W)).astype(np.float32)
        entries.append((mi, sx, sy, rng.random((H, W)) > 0.2))
    want1, _need = JSh.sample_shadow_map(jnp.asarray(maps[0]), *(jnp.asarray(a) for a in entries[0][1:]),
                                         interpret=True)
    got1, need = PSh.sample_shadow_map(torch.from_numpy(maps[0]), *(torch.from_numpy(a) for a in entries[0][1:]))
    np.testing.assert_array_equal(got1.numpy(), np.asarray(want1))
    assert need == 0
    want, _ovf = JSh.sample_shadow_maps([jnp.asarray(m) for m in maps],
                                        [(mi, *(jnp.asarray(a) for a in e)) for mi, *e in entries], interpret=True)
    got, ovf = PSh.sample_shadow_maps([torch.from_numpy(m) for m in maps],
                                      [(mi, *(torch.from_numpy(a) for a in e)) for mi, *e in entries])
    assert ovf == 0 and len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == (12, H, W)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[1] > 0).float().mean() > 0.1
    assert JMG.LT == PSh.GAP  # the same zero gap between stacked maps


def _render(pkg, build, size, monkeypatch, samples=1, backend="reference"):
    """build(runner, pkg) rendered by `pkg` on the CPU under the raster
    backend `backend` (None: the default, the deferred frame)."""
    if backend is not None:
        monkeypatch.setenv("REND3_TPU_RASTER", backend)
    runner = pkg[0](device="cpu") if pkg is PORT else pkg[0]()
    keep = build(runner, pkg)
    img = runner.render_frame(pkg[1](size=size, samples=samples))
    stats = dict(runner.base_graph.last_stats)
    monkeypatch.delenv("REND3_TPU_RASTER", raising=False)
    del keep
    return img, stats


def _max_diff(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def _glass(runner, pkg):
    return scenes.glass_stack(runner, scenes.GLASS_LAYERS, *pkg[2:])


def _slice(runner, pkg):
    return scenes.peel_slice(runner, *pkg[2:])


def test_forward_glass_stack_matches_jax(monkeypatch):
    port, stats = _render(PORT, _glass, 64, monkeypatch)
    ref, _ = _render(JAX, _glass, 64, monkeypatch)
    assert stats["blend_px"] > 0 and (port[:, :, 0] > 10).any() and (port[:, :, 2] > 10).any()
    assert _max_diff(port, ref) <= 1


@pytest.mark.parametrize("samples", [1, 4])
def test_forward_peel_slice_matches_jax(monkeypatch, samples):
    """Textures, two shadowed lights, cutout (drawn as opaque in both) and
    glass."""
    port, stats = _render(PORT, _slice, 64, monkeypatch, samples)
    ref, _ = _render(JAX, _slice, 64, monkeypatch, samples)
    assert stats["samples"] == samples and stats["blend_px"] > 0
    assert (port[..., :3] != 0).any(-1).mean() > 0.3
    assert _max_diff(port, ref) <= 1


def test_forward_skybox_matches_jax(monkeypatch):
    monkeypatch.setenv("REND3_TPU_RASTER", "reference")
    imgs = []
    for pkg, target in ((PORT, FrameRenderTarget), (JAX, JaxTarget)):
        runner = pkg[0](device="cpu") if pkg is PORT else pkg[0]()
        keep = scenes.skybox_cube(runner, types=pkg[3], m3=pkg[4])
        runner.renderer.swap_instruction_buffers()
        ev = runner.renderer.evaluate_instructions()
        imgs.append(runner.base_graph.render_frame(ev, target(64, 64, 1), skybox_slot=keep[-1].idx))
        del keep
    diff = np.abs(imgs[0].astype(np.int32) - imgs[1].astype(np.int32)).max(-1)
    assert (diff > 1).mean() <= 0.001, f"{(diff > 1).sum()} pixels differ by more than 1 (max {diff.max()})"
    assert (imgs[0][..., 3] == 255).all()


def test_deferred_peels_match_forward_frame(monkeypatch):
    """test_blend.py::test_blend_peeling_matches_scan_oracle on the port."""
    got, stats = _render(PORT, _glass, 64, monkeypatch, backend=None)
    want, _ = _render(PORT, _glass, 64, monkeypatch)
    assert stats["blend_peels"] == 3
    assert _max_diff(got, want) <= 1
    assert (got[:, :, 0] > 10).any() and (got[:, :, 2] > 10).any()


def test_raster_scene_reference_backend():
    clip = torch.from_numpy(_soup(N, 0))
    valid = torch.ones(N, dtype=torch.bool)
    kw = dict(cull_mode=PR.CullMode.BACK, front_is_cw=True, sample_offsets=PR.MSAA4_OFFSETS)
    a = PB.raster_scene(clip, valid, SIZE, SIZE, backend="reference", **kw)
    b = PR.rasterize(clip, valid, SIZE, SIZE, **kw)
    assert torch.equal(a.tri, b.tri) and torch.equal(a.depth, b.depth)


def test_default_raster_backend(monkeypatch):
    monkeypatch.delenv("REND3_TPU_RASTER", raising=False)
    assert PB.default_raster_backend() == "pallas"
    for name in ("pallas", "binned_xla", "reference"):
        monkeypatch.setenv("REND3_TPU_RASTER", name)
        assert PB.default_raster_backend() == name
    monkeypatch.setenv("REND3_TPU_RASTER", "wgpu")
    with pytest.raises(ValueError, match="REND3_TPU_RASTER"):
        PB.default_raster_backend()
