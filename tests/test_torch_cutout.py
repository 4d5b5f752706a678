"""Cutout (alpha-tested) depth peels in the PyTorch port against the JAX
package on the CPU.

- K1's peel modes: the plain version against JAX raster_resolve_packed in
  Pallas interpret mode on the test_torch_raster.py fixture (ties, pixels on
  edges), with a bound, a count floor, a strict count floor, and both.
  Depth, hit, material and counts bit-exact; the other channels within
  1 ulp (as test_torch_raster.py states why).
- cutout_alpha_pass against JAX's, bit for bit, on a G-buffer of random
  textured and untextured cutout pixels.
- cutout_peel_step (on the CPU its plain version) against the peel loop's
  body as the frame wrote it inline before C1, bit for bit in gbuf, done,
  bound and the searching count, over three chained peels of
  testing.cutout_peel_case (NEAREST, ALBEDO_BLEND, no cutoff, untextured
  materials, misses, fragments behind the opaque depth, pixels already
  done), also with done reset after the first peel (passed pixels tested
  again) and with a registered cutout routine; the inputs it refuses; its
  counter; routine_verdict against cutout_alpha_pass's routine override.
- The three scenes of tests/test_cutout.py through the port: each equal to
  the JAX render within 1 u8 (JAX converges its peel caps first), and to
  the analytic np.where composite those tests hold JAX to.
- tests/test_caps.py:248-318's scene (two alpha-failing layers in front of
  a passing one): the port runs exactly 3 peels and shows the red layer,
  within 1 u8 of JAX.
- Ten alpha-failing layers in front of a passing one: past JAX's clamp of 8
  peels, so the port is held to the wgpu discard semantics
  (depth.wgsl:105-124) through the analytic np.where image.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rend3_tpu.testing as jax_testing
from rend3_tpu import types as jax_types
from rend3_tpu.ops import deferred as JD
from rend3_tpu.ops import geometry as JG
from rend3_tpu.ops import lighting as JL
from rend3_tpu.ops import raster as JRaster
from rend3_tpu.ops import shade as JS
from rend3_tpu.ops import texture as JT
from rend3_tpu.routine.pbr import material as jax_material
from rend3_tpu.utils import math as jax_m3
from rend3_tpu_torch import interop, scenes, testing, types
from rend3_tpu_torch.ops import deferred as PD
from rend3_tpu_torch.ops import lighting as PL
from rend3_tpu_torch.ops import shade as PS
from rend3_tpu_torch.routine.pbr import material
from rend3_tpu_torch.testing import FrameRenderSettings, TestRunner
from rend3_tpu_torch.utils import math as m3
from test_torch_raster import H, W, _fixture

PORT = (TestRunner, FrameRenderSettings, material, types, m3)
JAX = (jax_testing.TestRunner, jax_testing.FrameRenderSettings, jax_material, jax_types, jax_m3)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _max_diff(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


# ---------------------------------------------------------------------------
# K1 peel modes
# ---------------------------------------------------------------------------

MODES = {
    "bound": dict(bound=True),
    "count_floor": dict(floor=True),
    "count_floor_strict": dict(floor=True, strict=True),
    "bound_and_count_floor_strict": dict(bound=True, floor=True, strict=True),
}


@pytest.fixture(scope="module")
def peel_case():
    """The raster fixture's tables, and per-pixel bound and floor images
    taken from its own opaque depth (so fragments tie the bound and the
    floor exactly), with a third of the pixels set to random depths."""
    clip, planes = _fixture()
    t = JG.cull_and_setup(
        jnp.asarray(clip), jnp.ones(clip.shape[0], bool), W, H,
        cull_mode=JRaster.CullMode.NONE, front_is_cw=True, subpixel=True,
    )
    binned = JG.bin_triangles(t, W, H, tile_cap=int(t.count), tile_h=JD.DTILE_H, tile_w=JD.DTILE_W)
    pk = JD.pack_raster(t, jnp.asarray(planes), binned, W, H, flat_cap=1 << 14)
    g0, _ovf = JD.raster_resolve_packed(pk, W, H, interpret=True)
    d0 = np.asarray(g0.data[JD.G_DEPTH])
    hit0 = np.asarray(g0.data[JD.G_HIT]) > 0
    rng = np.random.default_rng(1)
    noise = rng.random((H, W)) < 0.33
    rand = rng.uniform(0.0, 0.7, (H, W)).astype(np.float32)
    bound = np.where(noise, rand, np.where(hit0, d0, 0.0)).astype(np.float32)
    floor = np.where(noise, rand, np.where(hit0, d0, -1.0)).astype(np.float32)
    return dict(
        t=t, pk=pk, binned=binned, planes=planes, bound=bound, floor=floor,
        pt=interop.tri_setup(t.setup, t.bbox, t.count, t.src, t.flip),
        pb=interop.binned(binned.ids), pp=interop.planes(planes, t.count),
    )


@pytest.fixture(scope="module")
def peel_results(peel_case):
    c = peel_case
    out = {}
    for name, m in MODES.items():
        bound = c["bound"] if m.get("bound") else None
        floor = c["floor"] if m.get("floor") else None
        strict = bool(m.get("strict"))
        res = JD.raster_resolve_packed(
            c["pk"], W, H, interpret=True,
            bound=None if bound is None else jnp.asarray(bound),
            count_floor=None if floor is None else jnp.asarray(floor), count_strict=strict,
        )
        port = PD.raster_resolve(
            c["pt"], c["pp"], c["pb"], W, H,
            bound=None if bound is None else torch.from_numpy(bound),
            count_floor=None if floor is None else torch.from_numpy(floor), count_strict=strict,
        )
        jg = np.asarray(res[0].data)
        jc = np.asarray(res[2]) if floor is not None else None
        pg, pc = (port[0].data.numpy(), port[1].numpy()) if floor is not None else (port.data.numpy(), None)
        out[name] = (jg, jc, pg, pc)
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_k1_peel_mode_matches_jax(peel_results, mode):
    jg, jc, pg, pc = peel_results[mode]
    for ch in (PD.G_DEPTH, PD.G_HIT, PD.G_MAT):
        np.testing.assert_array_equal(pg[ch], jg[ch])
    np.testing.assert_array_max_ulp(pg, jg, maxulp=1)
    if jc is not None:
        np.testing.assert_array_equal(pc, jc)
        assert pc.max() >= 2  # pixels with several fragments above the floor


def test_k1_peel_modes_are_not_vacuous(peel_results):
    """The bound removes winners, strictness changes counts, and the count
    includes fragments that lose the depth test or fail the bound."""
    plain = peel_results["bound"][2]
    both = peel_results["bound_and_count_floor_strict"]
    hits_bound = (plain[PD.G_HIT] > 0).sum()
    assert 0 < hits_bound < (peel_results["count_floor"][2][PD.G_HIT] > 0).sum()
    loose, strict = peel_results["count_floor"][3], peel_results["count_floor_strict"][3]
    assert (loose > strict).any() and (loose >= strict).all()
    np.testing.assert_array_equal(both[3], strict)  # the bound does not change the count


# ---------------------------------------------------------------------------
# cutout_alpha_pass
# ---------------------------------------------------------------------------


def test_cutout_alpha_pass_matches_jax():
    """Random hit pixels over four materials: textured with an alpha ramp
    (linear and nearest), textured with vertex-color blend, and a factor-only
    material without a cutoff, each against JAX's pass bit for bit."""
    rng = np.random.default_rng(3)

    class Tex:
        def __init__(self, mips):
            self.mips = mips

    def ramp(w, h):
        m0 = np.zeros((h, w, 4), np.float32)
        m0[..., 0] = 0.5
        m0[..., 3] = np.linspace(0.0, 1.0, w)[None, :]
        mips, cur = [m0], m0
        while min(cur.shape[:2]) > 1:
            nh, nw = max(1, cur.shape[0] // 2), max(1, cur.shape[1] // 2)
            cur = cur[: nh * 2, : nw * 2].reshape(nh, 2, nw, 2, 4).mean(axis=(1, 3))
            mips.append(cur.astype(np.float32))
        return mips

    jt = JT.build_texture_atlas({0: Tex(ramp(32, 32)), 1: Tex(ramp(16, 64))})
    M = 4
    data = np.zeros((M, JS.PBR_DATA_SIZE), np.float32)
    data[:, JS.PBR_UVT0 : JS.PBR_UVT0 + 9] = np.eye(3, dtype=np.float32).reshape(9)
    data[:, JS.PBR_UVT0 + 2] = rng.uniform(-0.3, 0.3, M)
    data[:, JS.PBR_ALBEDO : JS.PBR_ALBEDO + 4] = rng.uniform(0.5, 1.0, (M, 4))
    data[:, JS.PBR_ALPHA_CUTOUT] = [0.5, 0.3, 0.6, 0.0]
    flags = np.array([
        JS.MF.ALBEDO_ACTIVE,
        JS.MF.ALBEDO_ACTIVE | JS.MF.NEAREST,
        JS.MF.ALBEDO_ACTIVE | JS.MF.ALBEDO_BLEND,
        JS.MF.ALBEDO_ACTIVE,
    ], np.int32)
    mtex = np.zeros((M, JT.NSLOT), np.int32)
    mtex[:3, JS.TEX_ALBEDO] = [1, 2, 1]
    hh, ww = 32, 128
    N = hh * ww
    g = np.zeros((JD.GB_CH, N), np.float32)
    den = rng.uniform(0.5, 2.0, N).astype(np.float32)
    g[JD.G_DEPTH] = rng.uniform(0.1, 0.9, N)
    g[JD.G_DEN] = den
    g[JD.G_UV0 : JD.G_UV0 + 2] = rng.uniform(-1.0, 2.0, (2, N)) * den
    g[JD.G_COL : JD.G_COL + 4] = rng.uniform(0.0, 1.0, (4, N)) * den
    g[JD.G_MAT] = rng.integers(0, M, N)
    g[JD.G_HIT] = rng.random(N) < 0.9
    g[JD.G_DUV : JD.G_DUV + 4] = rng.uniform(-1, 1, (4, N)) * 0.03
    g = g.reshape(JD.GB_CH, hh, ww)

    jmats = JS.PbrMaterialTable(data=jnp.asarray(data), flags=jnp.asarray(flags), textures=jnp.asarray(mtex))
    want, _ovf, _q = JL.cutout_alpha_pass(
        JD.GBuffer(data=jnp.asarray(g)), jmats, jt, (JS.TEX_ALBEDO,), (hh, ww), tex_pair_cap=64, interpret=True,
    )
    pmats = PS.PbrMaterialTable(
        data=torch.from_numpy(data), flags=torch.from_numpy(flags), textures=torch.from_numpy(mtex)
    )
    tex = interop.texture_arrays(jt.atlas, jt.rects, jt.mip_counts)
    got = PL.cutout_alpha_pass(PD.GBuffer(torch.from_numpy(g)), pmats, tex, (PS.TEX_ALBEDO,))
    want = np.asarray(want)
    assert got.shape == (hh, ww) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.2 < want.mean() < 0.9  # both outcomes occur


def test_cutout_alpha_pass_registered_routines_match_jax():
    """Pixels of two registered cutout routines' global slot ranges take
    each routine's own alpha against its cutoff; the PBR pixels keep the
    PBR test. Against JAX's pass bit for bit."""
    from rend3_tpu.routine import registry as JR
    from rend3_tpu_torch.routine import registry as PREG

    rng = np.random.default_rng(5)
    M, hh, ww = 4, 8, 128
    N = hh * ww
    data = np.zeros((M, JS.PBR_DATA_SIZE), np.float32)
    data[:, JS.PBR_ALBEDO : JS.PBR_ALBEDO + 4] = rng.uniform(0.2, 1.0, (M, 4))
    data[:, JS.PBR_ALPHA_CUTOUT] = [0.5, 0.0, 0.7, 0.4]
    flags = np.zeros(M, np.int32)
    mtex = np.zeros((M, JT.NSLOT), np.int32)
    g = np.zeros((JD.GB_CH, N), np.float32)
    den = rng.uniform(0.5, 2.0, N).astype(np.float32)
    g[JD.G_DEN] = den
    for off, n in ((JD.G_VP, 3), (JD.G_NRM, 3), (JD.G_TAN, 3), (JD.G_UV0, 2), (JD.G_UV1, 2), (JD.G_COL, 4)):
        g[off : off + n] = rng.uniform(-1.0, 1.0, (n, N)) * den
    g[JD.G_MAT] = rng.integers(0, M + 8, N)  # PBR slots 0-3, then two routines' 4 slots each
    g[JD.G_HIT] = 1.0
    g = g.reshape(JD.GB_CH, hh, ww)
    ext = [(rng.random((4, 4)).astype(np.float32), np.zeros(4, np.int32)) for _ in range(2)]

    def routines(reg, to_float):
        return [
            reg.MaterialRoutine(object, shade=None, transparency="cutout", alpha_cutoff=0.5,
                                alpha=lambda px, md, mf: to_float(px.view_pos[:, 0] > 0.0)),
            reg.MaterialRoutine(object, shade=None, transparency="cutout", alpha_cutoff=0.3,
                                alpha=lambda px, md, mf: md[:, 0] * px.uv0[:, 1]),
        ]

    jr = routines(JR, lambda b: b.astype(jnp.float32))
    want, _ovf, _q = JL.cutout_alpha_pass(
        JD.GBuffer(data=jnp.asarray(g)),
        JS.PbrMaterialTable(data=jnp.asarray(data), flags=jnp.asarray(flags), textures=jnp.asarray(mtex)),
        None, (), (hh, ww),
        extras=[(M + 4 * i, 4, jr[i], jnp.asarray(d), jnp.asarray(f)) for i, (d, f) in enumerate(ext)],
    )
    pr = routines(PREG, lambda b: b.float())
    got = PL.cutout_alpha_pass(
        PD.GBuffer(torch.from_numpy(g)),
        PS.PbrMaterialTable(data=torch.from_numpy(data), flags=torch.from_numpy(flags), textures=torch.from_numpy(mtex)),
        None, (),
        extras=[(M + 4 * i, 4, pr[i], torch.from_numpy(d), torch.from_numpy(f)) for i, (d, f) in enumerate(ext)],
    )
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.2 < want.mean() < 0.9  # both outcomes occur


# ---------------------------------------------------------------------------
# cutout_peel_step
# ---------------------------------------------------------------------------


def _inline_peel(gc, gbuf, ohit, odepth, done, materials, textures, active, extras=()):
    """The peel loop's alpha test as routine/base.py wrote it inline."""
    hp, wp = gc.shape[1:]
    chit = gc[PD.G_HIT] > 0.0
    cdepth = gc[PD.G_DEPTH]
    nearer = ~ohit | (cdepth > odepth)
    pix = torch.nonzero((~done & chit & nearer).flatten()).flatten()
    passed = torch.zeros(hp * wp, dtype=torch.bool, device=gc.device)
    searching = 0
    if pix.numel():
        ok = PL.cutout_alpha_pass(
            PD.GBuffer(gc.reshape(PD.GB_CH, -1)[:, pix][:, None]), materials, textures, active, extras=extras,
        ).flatten()
        passed[pix] = ok
        searching = pix.numel() - int(ok.sum())
    passed = passed.reshape(hp, wp)
    gbuf = torch.where(passed[None], gc, gbuf)
    done = done | ~chit | passed | (chit & ~nearer)
    bound = torch.where(done, torch.zeros_like(cdepth), cdepth)
    return gbuf, done, bound, searching


@pytest.mark.parametrize("kind", testing.CUTOUT_PEEL_KINDS)
@pytest.mark.parametrize("retest", [False, True], ids=["chained", "retest"])
def test_cutout_peel_step_matches_the_inline_loop(kind, retest):
    """The step on the case's floor against the inline body on its opaque
    hit and depth, from which the floor is made."""
    case = testing.cutout_peel_case(kind, "cpu", seed=3)
    got = testing.run_cutout_peels(PL.cutout_peel_step, case, retest)
    want = testing.run_cutout_peels(
        lambda gc, gbuf, _floor, done, *a, extras: _inline_peel(gc, gbuf, case["ohit"], case["odepth"], done, *a,
                                                                extras=extras),
        case, retest,
    )
    for k, ((gb, dn, bd, n), (wgb, wdn, wbd, wn)) in enumerate(zip(got, want)):
        assert torch.equal(gb.view(torch.int32), wgb.view(torch.int32)), k
        assert torch.equal(dn, wdn) and torch.equal(bd.view(torch.int32), wbd.view(torch.int32)) and n == wn, k
    searching = [n for *_t, n in want]
    assert all(n > 0 for n in searching)  # every peel fails some candidates
    assert not torch.equal(want[0][0], case["gbuf"])  # and passes some
    if retest:
        assert searching[1] > searching[0] // 2  # done reset: the passed pixels are candidates again


@pytest.mark.parametrize("fault", ["done_uint8", "gc_strided", "gbuf_shape", "floor_f64", "floor_device"])
def test_cutout_peel_step_refuses(fault):
    """Inputs C1 does not take raise ValueError on every device."""
    case = testing.cutout_peel_case("textured", "cpu", seed=0, height=8, width=16, peels=1)
    args = dict(gc=case["gcs"][0], gbuf=case["gbuf"], floor=case["floor"], done=case["done"])
    if fault == "done_uint8":
        args["done"] = args["done"].to(torch.uint8)
    elif fault == "gc_strided":
        args["gc"] = torch.cat([args["gc"], args["gc"]], dim=2)[:, :, ::2]
    elif fault == "gbuf_shape":
        args["gbuf"] = args["gbuf"][:, :4]
    elif fault == "floor_f64":
        args["floor"] = args["floor"].double()
    else:
        args["floor"] = args["floor"].to("meta")
    with pytest.raises(ValueError):
        PL.cutout_peel_step(*args.values(), case["materials"], case["textures"], case["active"])


def test_cutout_peel_step_counts_chain_peels():
    """On the CPU every peel takes the chain: cut.chain_peels, no cut.c1_peels."""
    from rend3_tpu_torch.utils import profiling

    case = testing.cutout_peel_case("textured", "cpu", seed=1, height=8, width=16)
    profiling.enable()
    try:
        testing.run_cutout_peels(PL.cutout_peel_step, case)
        counters = dict(profiling.stats().counters)
    finally:
        profiling.disable()
    assert counters.get("cut.chain_peels") == 3 and "cut.c1_peels" not in counters


def test_routine_verdict_is_the_alpha_pass_override():
    """routine_verdict over a peel, where nonzero, takes the place of the
    albedo alpha test as cutout_alpha_pass's routine override does: both
    verdicts occur, exactly on the pixels of the routine's slots."""
    case = testing.cutout_peel_case("routines", "cpu", seed=2)
    gc = case["gcs"][0]
    args = (PD.GBuffer(gc), case["materials"], case["textures"], case["active"])
    verdict = PL.routine_verdict(gc, case["extras"])
    got = torch.where(verdict > 0, verdict == 2, PL.cutout_alpha_pass(*args))
    assert torch.equal(got, PL.cutout_alpha_pass(*args, extras=case["extras"]))
    in_range = (torch.round(gc[PD.G_MAT]) >= 12) & (torch.round(gc[PD.G_MAT]) < 14)
    assert torch.equal(verdict > 0, in_range) and (verdict == 1).any() and (verdict == 2).any()


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

SIZE = 64
RED, GREEN, BLUE = (255, 40, 40), (40, 255, 40), (40, 40, 255)


def _quad(r, mod, z):
    v = np.array([[-1, 1, z], [1, 1, z], [1, -1, z], [-1, -1, z]], np.float32)
    mesh = (
        mod.MeshBuilder(v, mod.Handedness.LEFT)
        .with_vertex_uv0(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32))
        .with_indices(np.array([0, 1, 2, 2, 3, 0], np.uint32))
        .build()
    )
    return r.add_mesh(mesh)


def _converged_jax_runner(peels):
    """A JAX TestRunner whose cutout peel cap starts at the value its
    controller converges to for this scene (tests/test_caps.py shows it
    does), so the first frame is the converged one and JAX compiles one
    frame program instead of one per regrow."""
    runner = jax_testing.TestRunner()
    runner.base_graph._caps["cut_peels"] = peels
    return runner


def _render_layers(pkg, layers):
    """tests/test_cutout.py's scene: unlit nearest-sampled quads at the given
    depths; mask None = opaque, else a cutout at 0.5 with alpha 255 where
    the mask holds. Returns (image, runner stats)."""
    runner_cls, settings_cls, mat, mod, mm3 = pkg
    n_cut = sum(mask is not None for _z, mask, _rgb in layers)
    runner = runner_cls(device="cpu") if pkg is PORT else _converged_jax_runner(max(n_cut, 1))
    r = runner.renderer
    keep = []
    for z, mask, rgb in layers:
        img = np.zeros((SIZE, SIZE, 4), np.uint8)
        img[..., 0], img[..., 1], img[..., 2] = rgb
        img[..., 3] = 255 if mask is None else np.where(mask, 255, 0)
        tex = r.add_texture_2d(mod.Texture(
            label="t", data=img, format=mod.TextureFormat.RGBA8_UNORM_SRGB, mip_count=mod.MipmapCount.ONE,
        ))
        kw = {} if mask is None else dict(transparency=mat.Transparency.cutout_at(0.5))
        m = r.add_material(mat.PbrMaterial(
            albedo=mat.AlbedoComponent.new_texture(tex), unlit=True, sample_type=mat.SampleType.NEAREST, **kw,
        ))
        mesh = _quad(r, mod, z)
        keep += [tex, m, mesh, r.add_object(mod.Object(
            mesh_kind=mod.StaticMeshKind(mesh), material=m, transform=np.eye(4, dtype=np.float32),
        ))]
    runner.set_camera_data(mod.Camera(
        projection=mod.Orthographic(size=np.array([2.0, 2.0, 8.0], np.float32)),
        view=mm3.look_at_lh([0.0, 0.0, -2.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
    ))
    img = runner.render_frame(settings_cls(size=SIZE))
    stats = dict(runner.base_graph.last_stats)
    del keep
    return img, stats


def _checker(phase=0, block=8):
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    return ((xx // block + yy // block + phase) % 2) == 0


@pytest.fixture(scope="module")
def plain_layers():
    """Opaque renders the analytic composites are built from."""
    return {
        "bg": _render_layers(PORT, [(1.0, None, GREEN)])[0],
        "red": _render_layers(PORT, [(0.4, None, RED), (1.0, None, GREEN)])[0],
        "red5": _render_layers(PORT, [(0.5, None, RED), (1.0, None, GREEN)])[0],
        "blue": _render_layers(PORT, [(0.7, None, BLUE), (1.0, None, GREEN)])[0],
    }


CUT_SCENES = {
    "full_discard": ([(0.5, np.zeros((SIZE, SIZE), bool), RED), (1.0, None, GREEN)], lambda p: p["bg"]),
    "full_keep": ([(0.5, np.ones((SIZE, SIZE), bool), RED), (1.0, None, GREEN)], lambda p: p["red5"]),
    "checker": (
        [(0.5, _checker(), RED), (1.0, None, GREEN)],
        lambda p: np.where(_checker()[..., None], p["red5"], p["bg"]),
    ),
    "two_stacked": (
        [(0.4, _checker(0), RED), (0.7, _checker(1), BLUE), (1.0, None, GREEN)],
        lambda p: np.where(_checker(0)[..., None], p["red"], np.where(_checker(1)[..., None], p["blue"], p["bg"])),
    ),
}


@pytest.mark.parametrize("scene", list(CUT_SCENES))
def test_cutout_scene_matches_jax_and_composite(plain_layers, scene):
    layers, want = CUT_SCENES[scene]
    port, stats = _render_layers(PORT, layers)
    ref, _ = _render_layers(JAX, layers)
    assert _max_diff(port, ref) <= 1
    np.testing.assert_array_equal(port, want(plain_layers))
    assert stats["cut_survivors"] > 0 and stats["cut_peels"] >= 1


def _caps_scene(pkg):
    """scenes.stacked_cutout (test_caps.py:248-318) rendered at 64x64."""
    runner_cls, settings_cls = pkg[:2]
    runner = runner_cls(device="cpu") if pkg is PORT else _converged_jax_runner(3)
    keep = scenes.stacked_cutout(runner, *pkg[2:])
    img = runner.render_frame(settings_cls(size=SIZE))
    stats = dict(runner.base_graph.last_stats)
    del keep
    return img, stats


def test_caps_cutout_scene_three_peels():
    port, stats = _caps_scene(PORT)
    ref, _ = _caps_scene(JAX)
    assert stats["cut_peels"] == 3 and stats["cut_layers"] == 3, stats
    c = port[32, 32].astype(np.int32)
    assert c[0] > c[2] + 30, port[32, 32]  # the red passing layer, not the blue backdrop
    assert _max_diff(port, ref) <= 1


def test_eleven_cutout_layers_show_the_passing_one(plain_layers):
    """Ten fully alpha-failing layers in front of a checker-cut red one: the
    port peels 11 deep (JAX clamps at 8 and would show the backdrop), and
    the image is the analytic composite of the red layer over the backdrop
    (failing fragments are discarded at any depth, depth.wgsl:105-124)."""
    fail = np.zeros((SIZE, SIZE), bool)
    layers = [(0.05 + 0.04 * i, fail, BLUE) for i in range(10)]
    port, stats = _render_layers(PORT, layers + [(0.5, _checker(), RED), (1.0, None, GREEN)])
    assert stats["cut_layers"] == 11 and stats["cut_peels"] == 11, stats
    want = np.where(_checker()[..., None], plain_layers["red5"], plain_layers["bg"])
    np.testing.assert_array_equal(port, want)
