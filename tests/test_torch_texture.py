"""Textures in the PyTorch port against the JAX package on the CPU.

- The texture atlas, its rect table and mip counts, through both packages'
  TextureManager: a full pack, incremental adds after a first evaluate, a
  removal, and a repack when the atlas is full. Rects and mip counts
  bit-exact; the port's bf16 texels bit-exact against the JAX f32 atlas
  rounded to bf16 (the JAX sampler's own cast).
- K4's plain version against the JAX Pallas sample_grid_bilinear (interpret
  mode, default bf16 dot) on the inputs of tests/test_mxu_gather.py, with
  4 channels: bit-exact.
- sample_textures_grid against the JAX sample_textures_grid (bf16), rtol
  1e-6 (bit-exact here once the texel coordinate takes XLA:CPU's fma), and against the port's scalar sampler within the JAX test's bf16
  tolerance.
- A frame of textured lit quads (normal maps, AO/metallic/roughness in two
  packings, emissive, reflectance) within 1 u8 level of the JAX render.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rend3_tpu.testing as jax_testing
from rend3_tpu import types as jax_types
from rend3_tpu.core.managers.texture import TextureManager as JaxTextureManager
from rend3_tpu.ops import mxu_gather as mg
from rend3_tpu.ops import texture as jtex
from rend3_tpu.ops.shade import MF as JMF
from rend3_tpu.routine.pbr import material as jax_material
from rend3_tpu.utils import math as jax_m3
from rend3_tpu_torch import interop, scenes, types
from rend3_tpu_torch.core.managers.texture import TextureManager
from rend3_tpu_torch.ops import samplers as S
from rend3_tpu_torch.ops import texture as T
from rend3_tpu_torch.testing import FrameRenderSettings, TestRunner


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Atlas
# ---------------------------------------------------------------------------


def _manager_steps():
    """Both managers through: pack 3 textures; add 2 (incremental); remove
    one; add one too large for the resident atlas (repack). Returns the
    (port, jax) arrays after each step."""
    rng = np.random.default_rng(1)
    # (h, w, mip count): square textures carry full chains.
    sizes = [(32, 32, None), (64, 16, 3), (8, 8, None), (16, 16, None), (24, 40, 1), (256, 256, None)]
    data = [rng.integers(0, 256, (h, w, 4), dtype=np.uint8) for h, w, _m in sizes]
    port, ref = TextureManager("d2"), JaxTextureManager("d2")

    def add(i):
        for mgr, mod in ((port, types), (ref, jax_types)):
            fmt = mod.TextureFormat.RGBA8_UNORM_SRGB if i % 2 else mod.TextureFormat.RGBA8_UNORM
            mips = sizes[i][2] or mod.MipmapCount.MAXIMUM
            mgr.add(i, mod.Texture(label=str(i), data=data[i], format=fmt, mip_count=mips))

    def remove(i):
        port.remove(i)
        ref.remove(i)

    steps = []
    for change in ((add, (0, 1, 2)), (add, (3, 4)), (remove, (1,)), (add, (5,))):
        for i in change[1]:
            change[0](i)
        # The port updates its resident atlas in place, and the JAX manager's
        # tables may alias its host arrays on the CPU: keep a copy per step.
        steps.append((
            T.TextureArrays(*(t.clone() for t in port.evaluate())),
            [np.array(a) for a in ref.evaluate()[:3]],
        ))
    return steps


@pytest.fixture(scope="module")
def manager_steps():
    return _manager_steps()


@pytest.mark.parametrize("step", [0, 1, 2, 3], ids=["full_pack", "incremental", "remove", "repack"])
def test_atlas_matches_jax(manager_steps, step):
    port, (atlas, rects, mip_counts) = manager_steps[step]
    assert port.atlas.dtype == torch.bfloat16 and port.atlas.shape == atlas.shape
    assert torch.equal(port.atlas, _bf16(atlas))
    np.testing.assert_array_equal(port.rects.numpy(), rects)
    np.testing.assert_array_equal(port.mip_counts.numpy(), mip_counts)


def test_atlas_incremental_then_repack(manager_steps):
    """The incremental step kept the resident atlas; the repack grew it."""
    (p0, _), (p1, _), (_p2, _), (p3, _) = manager_steps
    assert p1.atlas.shape == p0.atlas.shape
    assert p3.atlas.shape[0] > p0.atlas.shape[0]
    assert int(p3.mip_counts[2]) == 0  # removed before the repack


# ---------------------------------------------------------------------------
# K4 plain version
# ---------------------------------------------------------------------------


def test_bilinear_plain_matches_jax_kernel():
    rng = np.random.default_rng(6)
    H, W = 32, 128
    C, Hs, Ws = 4, 100, 150
    planes = rng.standard_normal((C, Hs, Ws)).astype(np.float32)
    bx = rng.integers(-5, Ws + 5, size=(H, W)).astype(np.int32)
    by = rng.integers(-5, Hs + 5, size=(H, W)).astype(np.int32)
    fx = rng.random((H, W)).astype(np.float32)
    fy = rng.random((H, W)).astype(np.float32)
    wt = rng.random((H, W)).astype(np.float32)
    valid = rng.random((H, W)) > 0.2

    want, overflow, _q = mg.sample_grid_bilinear(
        *(jnp.asarray(a) for a in (planes, bx, by, fx, fy, wt, valid)),
        pair_cap=64, interpret=True, dot_dtype=jnp.bfloat16,
    )
    assert int(overflow) <= 64
    atlas = _bf16(np.moveaxis(planes, 0, -1)).contiguous()
    got = S.sample_grid_bilinear(atlas, *(torch.from_numpy(a) for a in (bx, by, fx, fy, wt, valid)))
    assert got.shape == (C, H, W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# sample_textures_grid
# ---------------------------------------------------------------------------


def test_sample_textures_grid_matches_jax():
    rng = np.random.default_rng(7)

    class Tex:
        def __init__(self, mips):
            self.mips = mips

    def mips_for(w, h):
        m0 = rng.uniform(0, 1, (h, w, 4)).astype(np.float32)
        mips, cur = [m0], m0
        while min(cur.shape[:2]) > 1:
            nh, nw = max(1, cur.shape[0] // 2), max(1, cur.shape[1] // 2)
            cur = cur[: nh * 2, : nw * 2].reshape(nh, 2, nw, 2, 4).mean(axis=(1, 3))
            mips.append(cur.astype(np.float32))
        return mips

    jt = jtex.build_texture_atlas({0: Tex(mips_for(64, 64)), 1: Tex(mips_for(128, 32)), 2: Tex(mips_for(48, 48))})
    H, W = 32, 128
    N = H * W
    mtex = np.zeros((N, jtex.NSLOT), np.int32)
    mtex[:, 0] = rng.integers(0, 4, N)
    mtex[:, 1] = rng.integers(0, 4, N)
    coords = rng.uniform(-1.5, 2.5, (N, 2)).astype(np.float32)
    duv = (rng.uniform(-1, 1, (N, 2, 2)) * 0.02).astype(np.float32)
    mflags = np.where(rng.uniform(size=N) < 0.2, JMF.NEAREST, 0).astype(np.int32)

    f = jax.jit(functools.partial(
        jtex.sample_textures_grid, hw=(H, W), active_slots=(0, 1), pair_cap=64, interpret=True,
        dot_dtype=jnp.bfloat16,
    ))
    want, ovf, _q = f(jt, jnp.asarray(mtex), jnp.asarray(coords), jnp.asarray(duv), jnp.asarray(mflags))
    assert int(ovf) <= 64

    tex = interop.texture_arrays(jt.atlas, jt.rects, jt.mip_counts)
    mt = torch.from_numpy(mtex.T.copy())
    uv = torch.from_numpy(coords.T.copy())
    duv_p = torch.from_numpy(duv.reshape(N, 4).T.copy())
    fl = torch.from_numpy(mflags)
    got = T.sample_textures_grid(tex, mt, uv, duv_p, fl, (0, 1))
    assert got[2] is None  # inactive slot
    for q in (0, 1):
        np.testing.assert_allclose(got[q].numpy(), np.asarray(want[q]).T, rtol=1e-6, atol=0)
        oracle = T.sample_textures(tex, mt[q], uv.T, torch.from_numpy(duv), fl)
        np.testing.assert_allclose(got[q].T.numpy(), oracle.numpy(), rtol=6e-3, atol=6e-3)


# ---------------------------------------------------------------------------
# A textured frame
# ---------------------------------------------------------------------------


def test_textured_planes_match_jax():
    pr = TestRunner(device="cpu")
    keep = scenes.textured_planes(pr)
    port = pr.render_frame(FrameRenderSettings(size=128))
    jr = jax_testing.TestRunner()
    jkeep = scenes.textured_planes(jr, mat=jax_material, types=jax_types, m3=jax_m3)
    ref = jr.render_frame(jax_testing.FrameRenderSettings(size=128))
    del keep, jkeep
    assert port.shape == ref.shape == (128, 128, 4)
    assert (port[..., :3] != 0).any(-1).mean() > 0.3
    assert int(np.abs(port.astype(np.int32) - ref.astype(np.int32)).max()) <= 1
