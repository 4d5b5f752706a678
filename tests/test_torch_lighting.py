"""Deferred lighting and the blit of the PyTorch port against the JAX
package, on a synthetic G-buffer from a numpy seed (32x128 pixels, five
material flag combinations, two directional lights and one masked slot with
precomputed shadow factors, two point lights). Inputs cross through
rend3_tpu_torch.interop.

Tolerance: lit HDR values rtol 1e-4 / atol 1e-6 (pow, sqrt and division
round differently in the last ulp between XLA and PyTorch, and the GGX /
Smith specular terms amplify that to about 2e-5 relative on a few pixels);
f16 round trip exact; u8 sRGB output within 1 level."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rend3_tpu.ops import blit as JB
from rend3_tpu.ops import deferred as JD
from rend3_tpu.ops import lighting as JL
from rend3_tpu.ops import shade as JS
from rend3_tpu_torch import interop
from rend3_tpu_torch.ops import blit as PB
from rend3_tpu_torch.ops import deferred as PD
from rend3_tpu_torch.ops import lighting as PL
from rend3_tpu_torch.ops import shade as PS
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
