"""Deferred lighting and the blit of the PyTorch port against the JAX
package, on a synthetic G-buffer from a numpy seed (32x128 pixels, five
material flag combinations, two directional lights and one masked slot with
precomputed shadow factors, two point lights). Inputs cross through
rend3_tpu_torch.interop.

Tolerance: lit HDR values rtol 1e-4 / atol 1e-6 (pow, sqrt and division
round differently in the last ulp between XLA and PyTorch, and the GGX /
Smith specular terms amplify that to about 2e-5 relative on a few pixels);
f16 round trip exact; u8 sRGB output within 1 level.

Then light_gbuffer on CPU tensors (D1's plain version, the shading chain)
against the frame's chain before D1, bit for bit, on
testing.deferred_shade_case's G-buffers; chain_inputs' K3 / K4 arguments;
the wrapper's input checks; and csrc/deferred_shade.cu's layout constants
against the package's."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rend3_tpu.ops import blit as JB
from rend3_tpu.ops import deferred as JD
from rend3_tpu.ops import lighting as JL
from rend3_tpu.ops import shade as JS
from rend3_tpu_torch import interop, testing
from rend3_tpu_torch.ops import blit as PB
from rend3_tpu_torch.ops import deferred as PD
from rend3_tpu_torch.ops import lighting as PL
from rend3_tpu_torch.ops import shade as PS
from rend3_tpu_torch.ops import texture as PT
from rend3_tpu_torch.utils import math as m3

H, W = 32, 128
MF = PS.MF
FLAGS = [
    MF.ALBEDO_ACTIVE,
    MF.ALBEDO_ACTIVE | MF.ALBEDO_BLEND,
    MF.ALBEDO_ACTIVE | MF.ALBEDO_BLEND | MF.ALBEDO_VERTEX_SRGB,
    MF.ALBEDO_ACTIVE | MF.UNLIT,
    0,
]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    M = len(FLAGS)
    data = np.zeros((M, PS.PBR_DATA_SIZE), np.float32)
    data[:, PS.PBR_ALBEDO : PS.PBR_ALBEDO + 4] = rng.uniform(0.1, 1.0, (M, 4))
    data[:, PS.PBR_EMISSIVE : PS.PBR_EMISSIVE + 3] = rng.uniform(0.0, 0.05, (M, 3))
    data[:, PS.PBR_ROUGHNESS] = rng.uniform(0.3, 1.0, M)
    data[:, PS.PBR_METALLIC] = rng.uniform(0.0, 1.0, M)
    data[:, PS.PBR_REFLECTANCE] = rng.uniform(0.2, 0.8, M)
    data[:, PS.PBR_CLEAR_COAT] = np.where(rng.random(M) < 0.5, rng.uniform(0.1, 1.0, M), 0.0)
    data[:, PS.PBR_CLEAR_COAT_ROUGHNESS] = rng.uniform(0.1, 0.9, M)
    data[:, PS.PBR_AMBIENT_OCCLUSION] = rng.uniform(0.5, 1.0, M)
    flags = np.array(FLAGS, np.int32)
    tex = np.zeros((M, 10), np.int32)

    g = np.zeros((PD.GB_CH, H, W), np.float32)
    den = rng.uniform(0.05, 1.0, (H, W)).astype(np.float32)
    vp = np.stack([rng.uniform(-5, 5, (H, W)), rng.uniform(-5, 5, (H, W)), rng.uniform(1, 20, (H, W))])
    nrm = rng.standard_normal((3, H, W))
    nrm[2] = -np.abs(nrm[2])  # mostly facing the camera
    g[PD.G_DEN] = den
    g[PD.G_VP : PD.G_VP + 3] = vp * den
    g[PD.G_NRM : PD.G_NRM + 3] = nrm * den
    g[PD.G_COL : PD.G_COL + 4] = rng.uniform(0, 1, (4, H, W)) * den
    g[PD.G_MAT] = rng.integers(0, M, (H, W))
    g[PD.G_HIT] = rng.random((H, W)) < 0.85
    g[PD.G_DEPTH] = rng.uniform(0, 1, (H, W))

    L = 3
    dirs = rng.standard_normal((L, 3)).astype(np.float32)
    dl = dict(
        view_proj=np.tile(np.eye(4, dtype=np.float32), (L, 1, 1)),
        color=rng.uniform(0.5, 3.0, (L, 3)).astype(np.float32),
        direction=dirs,
        inv_resolution=np.full((L, 2), 1 / 256, np.float32),
        atlas_offset=np.zeros((L, 2), np.float32),
        atlas_size=np.ones((L, 2), np.float32),
        mask=np.array([True, True, False]),
    )
    pl = dict(
        position=rng.uniform(-5, 5, (2, 3)).astype(np.float32),
        color=rng.uniform(1, 5, (2, 3)).astype(np.float32),
        radius=np.array([10.0, 25.0], np.float32),
        mask=np.array([True, True]),
    )
    view = m3.look_at_lh([3.0, 4.0, -10.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]).astype(np.float32)
    uni = dict(
        view=view, view_proj=view, origin_view_proj=view,
        inv_view=np.linalg.inv(view).astype(np.float32), inv_origin_view_proj=view,
        ambient=np.array([0.05, 0.04, 0.06, 1.0], np.float32),
    )
    sv = rng.uniform(0, 1, (L, H, W)).astype(np.float32)
    bg = np.broadcast_to(np.array([0.1, 0.2, 0.3, 1.0], np.float32), (H, W, 4)).copy()
    return (data, flags, tex), g, dl, pl, uni, sv, bg


@pytest.fixture(scope="module", params=[0, 1])
def lit(request):
    (data, flags, tex), g, dl, pl, uni, sv, bg = _inputs(request.param)
    j = JL.light_gbuffer(
        JD.GBuffer(jnp.asarray(g)),
        JS.PbrMaterialTable(jnp.asarray(data), jnp.asarray(flags), jnp.asarray(tex)),
        JS.DirLightArrays(**{k: jnp.asarray(v) for k, v in dl.items()}),
        JS.PointLightArrays(**{k: jnp.asarray(v) for k, v in pl.items()}),
        jnp.zeros((1, 1), jnp.float32),
        JS.FrameUniformsArrays(**{k: jnp.asarray(v) for k, v in uni.items()}),
        jnp.asarray(bg), textures=None, shadow_values=jnp.asarray(sv),
    )
    p = PL.light_gbuffer(
        PD.GBuffer(interop.tensor(g)),
        PS.PbrMaterialTable(interop.tensor(data), interop.tensor(flags), interop.tensor(tex)),
        interop.dir_lights(dl),
        interop.point_lights(pl),
        PS.FrameUniformsArrays(**{k: interop.tensor(v) for k, v in uni.items()}),
        interop.tensor(bg), interop.tensor(sv),
    )
    return np.asarray(j), p.numpy()


def test_light_gbuffer_matches(lit):
    j, p = lit
    assert p.shape == (H, W, 4)
    assert np.isfinite(p).all()
    np.testing.assert_allclose(p, j, rtol=1e-4, atol=1e-6)


def test_blit_matches(lit):
    j, _p = lit
    jf = np.asarray(JB.f16_roundtrip(jnp.asarray(j[None])))
    pf = PB.f16_roundtrip(torch.from_numpy(j[None].copy())).numpy()
    np.testing.assert_array_equal(pf, jf)
    ju = np.asarray(JB.hdr_to_srgb_u8(JB.resolve_samples(jnp.asarray(jf))))
    pu = PB.hdr_to_srgb_u8(PB.resolve_samples(torch.from_numpy(pf))).numpy()
    assert pu.dtype == np.uint8
    assert int(np.abs(pu.astype(np.int32) - ju.astype(np.int32)).max()) <= 1


# -- light_gbuffer on CPU tensors: D1's plain version ---------------------------
#
# testing.deferred_shade_case's G-buffers (72x128, or 1,500 compacted blend
# pixels): light_gbuffer on the CPU runs the shading chain, and must give the
# image the frame gave before D1 (testing.deferred_shade_chain: every
# G-buffer's shadow coordinates, one K3 launch for all, then the lighting with
# those factors) bit for bit.


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("kind", testing.DEFERRED_SHADE_KINDS)
def test_light_gbuffer_cpu_equals_chain(kind):
    args = testing.deferred_shade_case(kind, seed=3)
    got = PL.light_gbuffer(*args)
    want = testing.deferred_shade_chain([args])[0]
    assert got.shape == args[5].shape
    assert torch.equal(_bits(got), _bits(want))
    hit = args[0].data[PD.G_HIT] > 0
    assert torch.equal(_bits(got[~hit]), _bits(args[5][~hit]))  # the background where nothing hit


def test_light_gbuffer_frame_pair_equals_chain():
    """The opaque G-buffer and its hit pixels compacted as blend pixels,
    shaded one call each, against the chain's one K3 launch for both."""
    opaque = testing.deferred_shade_case("opaque", seed=4)
    g = opaque[0].data.reshape(PD.GB_CH, -1)
    pix = torch.nonzero(g[PD.G_HIT] > 0).flatten()
    blend = (PD.GBuffer(g[:, pix][:, None].contiguous()), *opaque[1:5], torch.zeros(1, pix.numel(), 4),
             *opaque[6:])
    want = testing.deferred_shade_chain([opaque, blend])
    for args, w in zip((opaque, blend), want):
        assert torch.equal(_bits(PL.light_gbuffer(*args)), _bits(w))


def test_chain_inputs_reproduce_the_chain():
    """chain_inputs' K3 and K4 arguments (what tools read where the frame
    shades with D1) give the chain's shadow factors and texture samples."""
    from rend3_tpu_torch.ops import samplers as PSa

    args = testing.deferred_shade_case("opaque", seed=5)
    gbuf, materials, dl, _pl, uni, _bg, shadows, tex, active = args
    ins = PL.chain_inputs(*args)
    coords = ins["shadow_coords"]
    assert [c[0] for c in coords] == [0, 1]
    ok = ins["pcf5"][-1]
    pcf = torch.where(ok, PSa.sample_grid_pcf5_plain(*ins["pcf5"]), torch.ones_like(ok, dtype=torch.float32))
    for k, (c, p) in enumerate(zip(coords, pcf.split(ok.numel() // len(coords)))):
        want = PL.shadow_factors(gbuf, dl, uni, shadows)[k]
        assert torch.equal(torch.where(c[-1], p.reshape(c[1].shape), torch.ones_like(c[1])), want)
    g, inv_den, _h, _w = PL._flat(gbuf)
    midx = torch.round(g[PD.G_MAT]).long().clamp(0, materials.data.shape[0] - 1)
    samples = PT.sample_textures_grid(
        tex, materials.textures[midx].T, PL._uv_coords(materials.data[midx].T, g[PD.G_UV0 : PD.G_UV0 + 2] * inv_den),
        g[PD.G_DUV : PD.G_DUV + 4], materials.flags[midx], active, hit=g[PD.G_HIT] > 0,
    )
    out = PSa.sample_grid_bilinear_plain(*ins["bilinear"])
    for i, q in enumerate(active):
        res = out[:, 2 * i] + out[:, 2 * i + 1]
        assert torch.equal(torch.where(materials.textures[midx].T[q][None] > 0, res, torch.ones_like(res)), samples[q])


def _bad(case):
    gbuf, materials, dl, pl, uni, bg, shadows, tex, active = testing.deferred_shade_case("opaque", seed=6)
    g = gbuf.data
    if case == "gbuf dtype":
        gbuf = PD.GBuffer(g.double())
    elif case == "gbuf channels":
        gbuf = PD.GBuffer(g[:-1])
    elif case == "gbuf strided rows":
        gbuf = PD.GBuffer(g.transpose(1, 2).contiguous().transpose(1, 2))
    elif case == "background shape":
        bg = bg[:, :-1]
    elif case == "background strided pixels":
        bg = bg.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    elif case == "material flags dtype":
        materials = materials._replace(flags=materials.flags.long())
    elif case == "material slots":
        materials = materials._replace(textures=materials.textures[:, :5].contiguous())
    elif case == "shadow factors shape":
        shadows = torch.ones(2, *g.shape[1:])
    elif case == "more maps than lights":
        shadows = shadows._replace(plan=shadows.plan * 2, maps=shadows.maps * 2, bases=shadows.bases * 2)
    elif case == "atlas dtype":
        tex = tex._replace(atlas=tex.atlas.float())
    elif case == "light mask dtype":
        dl = dl._replace(mask=dl.mask.int())
    return gbuf, materials, dl, pl, uni, bg, shadows, tex, active


@pytest.mark.parametrize("case", ["gbuf dtype", "gbuf channels", "gbuf strided rows", "background shape",
                                  "background strided pixels", "material flags dtype", "material slots",
                                  "shadow factors shape", "more maps than lights", "atlas dtype", "light mask dtype"])
def test_light_gbuffer_checks_raise(case):
    with pytest.raises(ValueError):
        PL.light_gbuffer(*_bad(case))


def test_d1_constants_match_the_package():
    """The layout constants csrc/deferred_shade.cu reads the G-buffer, the
    material table and the flags with are the package's."""
    src = open(os.path.join(os.path.dirname(PL.__file__), "..", "csrc", "deferred_shade.cu")).read()
    consts = {k: int(eval(v)) for k, v in re.findall(r"\b([A-Z][A-Z0-9_]+) = ([0-9][0-9 <]*)[,;]", src)}
    for name in ("G_DEN", "G_VP", "G_NRM", "G_TAN", "G_UV0", "G_COL", "G_MAT", "G_HIT", "G_DUV"):
        assert consts[name] == getattr(PD, name), name
    for name in ("PBR_UVT0", "PBR_ALBEDO", "PBR_EMISSIVE", "PBR_ROUGHNESS", "PBR_METALLIC", "PBR_REFLECTANCE",
                 "PBR_CLEAR_COAT", "PBR_CLEAR_COAT_ROUGHNESS", "PBR_AMBIENT_OCCLUSION", "PBR_DATA_SIZE",
                 "TEX_ALBEDO", "TEX_NORMAL", "TEX_ROUGHNESS", "TEX_METALLIC", "TEX_REFLECTANCE", "TEX_CLEAR_COAT",
                 "TEX_CLEAR_COAT_ROUGHNESS", "TEX_EMISSIVE", "TEX_AO"):
        assert consts[name] == getattr(PS, name), name
    flags = [k for k in consts if k.startswith("MF_")]
    assert len(flags) == 13
    for name in flags:
        assert consts[name] == getattr(PS.MF, name[3:]), name
    assert (consts["NSLOT"], consts["MAX_MIPS"]) == (PT.NSLOT, PT.MAX_MIPS)
    assert int(re.search(r"kMaxMaps = (\d+);", src).group(1)) == PL.MAX_MAPS
    assert re.search(r"kPi = \(float\)([0-9.]+);", src).group(1) == repr(PS.PI)
