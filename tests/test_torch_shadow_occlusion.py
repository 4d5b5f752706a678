"""The map-free shadow resolve of the PyTorch port (K7, K8 and
pcf5_from_occlusion) against the JAX package on the CPU.

Fixture (numpy seed 0): 48 random caster triangles in light clip space,
set up with cull_and_setup for a 256x256 light (FRONT culling, as the
shadow pass culls; about 20 survive), and a 128x64 screen (two 32x128
tiles) whose light-space coordinates sx, sy follow a tilted plane with
sub-texel noise and jump by 60 texels in one quadrant (a depth
discontinuity, so the rect lists and the light-cell lists differ), with
80% of the pixels hit.

- The port's plain versions of K7 and K8 against JAX's shadow_occlusion and
  shadow_occlusion_lt(size=256) in Pallas interpret mode: bit for bit at
  hit pixels, the only pixels where the values are defined (the lists
  decide the others). This holds the two kernels' expression orders and
  K7's depth-plane contraction quirk (ops/shadow.py _occlusion_plain).
- pcf5_from_occlusion against JAX's on the same occluder depths, within
  1e-6 (XLA:CPU may contract the bilinear blend).
- Both of the port's list builders hold, for every tile, every caster that
  covers a tap of one of the tile's hit pixels in a brute-force evaluation
  over all casters, so the kernels' results do not depend on the lists.

The same holds on rend3_tpu_torch.testing.shadow_stress_case (numpy seed
0, 5,300 casters, a 256x64 screen: a tile across a depth discontinuity
whose rect list spans several of the CUDA kernel's segments, casters of
depth 0 at every tap they cover, a tile with no hit pixel, a tile whose
hit pixels list no caster, and a tile hit in part), which the card-only tests and chip_smoke.py hold the CUDA
kernels to: the plain versions against JAX in interpret mode, bit for bit
at hit pixels, with JAX's list capacity past the longest list so that it
drops no caster.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rend3_tpu.ops import geometry as JG
from rend3_tpu.ops import raster as JR
from rend3_tpu.ops import shadow as JS
from rend3_tpu_torch import interop, testing
from rend3_tpu_torch.ops import shadow as PS

W, H, SIZE = 128, 64, 256


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    n = 48
    ctr = rng.uniform(-0.9, 0.9, (n, 1, 2))
    xy = ctr + rng.uniform(-0.35, 0.35, (n, 3, 2))
    z = rng.uniform(0.1, 0.9, (n, 3, 1))
    clip = np.concatenate([xy, z, np.ones((n, 3, 1))], axis=2).astype(np.float32)
    t = JG.cull_and_setup(jnp.asarray(clip), jnp.ones(n, bool), SIZE, SIZE, cull_mode=JR.CullMode.FRONT,
                          front_is_cw=True, subpixel=True)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    sx = 30.0 + 1.3 * xx + 0.4 * yy + rng.uniform(-0.5, 0.5, (H, W))
    sy = (40.0 + 0.2 * xx + 2.1 * yy + rng.uniform(-0.5, 0.5, (H, W))).astype(np.float32)
    sx = np.where((yy >= 32) & (xx >= 64), sx + 60.0, sx).astype(np.float32)
    hit = rng.uniform(size=(H, W)) < 0.8
    ref = rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)
    jargs = (jnp.asarray(sx), jnp.asarray(sy), jnp.asarray(hit))
    j7 = np.asarray(JS.shadow_occlusion(t, *jargs, W, H, interpret=True))
    j8, ovf = JS.shadow_occlusion_lt(t, *jargs, W, H, SIZE, interpret=True)
    assert int(ovf) == 0
    j8 = np.asarray(j8)
    jpcf = np.asarray(JS.pcf5_from_occlusion(jnp.asarray(j8), jargs[0], jargs[1], jnp.asarray(ref)))
    pt = interop.tri_setup(t.setup, t.bbox, t.count, t.src, t.flip)
    return dict(
        pt=pt, sx=torch.from_numpy(sx), sy=torch.from_numpy(sy), hit=torch.from_numpy(hit),
        ref=torch.from_numpy(ref), j7=j7, j8=j8, jpcf=jpcf, h=np.broadcast_to(hit, j7.shape),
    )


def test_fixture_has_casters_and_shadowed_taps(case):
    assert case["pt"].count >= 16
    assert (case["j8"][case["h"]] > 0).mean() > 0.05


@pytest.mark.parametrize("kernel", ["k7", "k8"])
def test_occlusion_matches_jax_at_hit_pixels(case, kernel):
    c = case
    args = (c["pt"], c["sx"], c["sy"], c["hit"])
    if kernel == "k7":
        port, plain, jax_occ = PS.shadow_occlusion(*args, W, H), PS.shadow_occlusion_plain(*args), c["j7"]
    else:
        port, overflow = PS.shadow_occlusion_lt(*args, W, H, SIZE)
        assert int(overflow) == 0
        plain, jax_occ = PS.shadow_occlusion_lt_plain(*args), c["j8"]
    assert port.shape == (PS.N_OFF, H, W)
    np.testing.assert_array_equal(port.numpy()[c["h"]], jax_occ[c["h"]])
    np.testing.assert_array_equal(plain.numpy()[c["h"]], jax_occ[c["h"]])


def test_k7_and_k8_differ_only_in_rounding(case):
    c = case
    d = np.abs(c["j7"] - c["j8"])[c["h"]]
    assert (d > 0).any()  # the two expression orders round differently somewhere
    assert d.max() < 1e-5


def test_pcf5_matches_jax(case):
    c = case
    pcf = PS.pcf5_from_occlusion(interop.tensor(c["j8"]), c["sx"], c["sy"], c["ref"])
    np.testing.assert_allclose(pcf.numpy(), c["jpcf"], atol=1e-6, rtol=0)
    assert 0.0 < float(pcf.mean()) < 1.0


def test_lists_hold_every_caster_a_hit_pixel_needs(case):
    c = case
    pt, sx, sy, hit = c["pt"], c["sx"], c["sy"], c["hit"]
    bx = torch.floor(sx - 0.5) + 0.5
    by = torch.floor(sy - 0.5) + 0.5
    s = pt.setup
    tile = (torch.arange(H)[:, None] // PS.STILE_H) * (W // PS.STILE_W) + torch.arange(W)[None, :] // PS.STILE_W
    needed = set()
    for v in range(pt.count):
        cov_any = torch.zeros(H, W, dtype=torch.bool)
        for dx, dy in PS.PCF_OFFSETS:
            px, py = bx + dx, by + dy
            e = [s[v, k] * px + s[v, 3 + k] * py + s[v, 6 + k] for k in range(3)]
            z = s[v, 9] * px + s[v, 10] * py + s[v, 11]
            cov_any |= (e[0] > 0) & (e[1] > 0) & (e[2] > 0) & (z >= 0)
        needed |= {(int(t), v) for t in torch.unique(tile[cov_any & hit])}
    assert len(needed) > 10
    for lists in (PS.rect_lists(pt, sx, sy, hit, W, H), PS.cell_lists(pt, sx, sy, hit, W, H, SIZE)):
        o = lists.offsets.tolist()
        have = {(t, int(v)) for t in range(len(o) - 1) for v in lists.ids[o[t]:o[t + 1]]}
        assert needed <= have
    cells = PS.cell_lists(pt, sx, sy, hit, W, H, SIZE)
    rects = PS.rect_lists(pt, sx, sy, hit, W, H)
    assert cells.ids.numel() != rects.ids.numel()  # the discontinuity tile's lists differ


@pytest.fixture(scope="module")
def stress():
    c = testing.shadow_stress_case("cpu")
    tr = c["tris"]
    jt = JG.TriSetup(setup=jnp.asarray(tr.setup.numpy()), bbox=jnp.asarray(tr.bbox.numpy()), count=jnp.int32(tr.count),
                     src=jnp.asarray(tr.src.numpy().astype(np.int32)), flip=jnp.asarray(tr.flip.numpy()))
    jargs = tuple(jnp.asarray(c[k].numpy()) for k in ("sx", "sy", "hit"))
    h = np.broadcast_to(c["hit"].numpy(), (PS.N_OFF, c["height"], c["width"]))
    return dict(c, jt=jt, jargs=jargs, h=h)


def _lens(lists):
    return (lists.offsets[1:] - lists.offsets[:-1]).numpy()


def test_shadow_stress_input_presses_the_kernels(stress):
    c = stress
    rects, cells = _lens(c["rects"]), _lens(c["cells"])
    assert rects.max() > 2 * PS.OCC_SEG  # a list over several segments
    hit = c["hit"].numpy().reshape(2, PS.STILE_H, 2, PS.STILE_W)
    tile_hits = hit.any(axis=(1, 3)).reshape(-1)
    assert not tile_hits.all() and rects[~tile_hits].sum() == 0  # a tile with no hit pixel lists nothing
    assert (tile_hits & (rects == 0)).any()  # hit pixels over an empty list
    # A tile hit in part: 8x32 pixel blocks (a CTA's) with and without a hit
    # pixel, and 4x8 warp blocks hit in part.
    blocks = hit.reshape(2, 32, 2, 16, 8).any(axis=(1, 4))
    assert (blocks.any(axis=2) & ~blocks.all(axis=2)).any()
    warps = hit.reshape(2, 4, 8, 2, 32, 4).transpose(0, 1, 3, 4, 2, 5).reshape(-1, 32)
    assert (warps.any(axis=1) & ~warps.all(axis=1)).any()
    s = c["tris"].setup.numpy()
    assert (s[:, 9:12] == 0).all(axis=1).sum() >= 10  # depth exactly 0 at every tap


@pytest.mark.parametrize("kernel", ["k7", "k8"])
def test_occlusion_stress_matches_jax_at_hit_pixels(stress, kernel):
    c = stress
    W, H, V = c["width"], c["height"], c["tris"].count
    args = (c["tris"], c["sx"], c["sy"], c["hit"])
    if kernel == "k7":
        jax_occ = np.asarray(JS.shadow_occlusion(c["jt"], *c["jargs"], W, H, tile_cap=V, interpret=True))
        plain = PS.shadow_occlusion_plain(*args)
    else:
        # A capacity of whole groups of 8, past every list.
        j, overflow = JS.shadow_occlusion_lt(c["jt"], *c["jargs"], W, H, c["size"], tile_cap=V // 8 * 8,
                                             interpret=True)
        assert int(overflow) == 0
        jax_occ, plain = np.asarray(j), PS.shadow_occlusion_lt_plain(*args)
    h = c["h"]
    np.testing.assert_array_equal(plain.numpy()[h], jax_occ[h])
    assert (jax_occ[h] > 0).mean() > 0.1
