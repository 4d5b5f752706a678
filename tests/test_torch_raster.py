"""K1 and K2 plain versions of the PyTorch port against the JAX kernels.

The JAX side runs raster_resolve_packed and raster_depth_packed (through
deferred.raster_resolve / raster_depth) in Pallas interpret mode on the CPU,
as its own suite does. Both sides get the same setup, plane and tile tables
(interop), 256x128 target. Tolerance: depth, hit and material channels
bit-exact, K2 bit-exact; the other K1 channels within 1 ulp (the plain
version evaluates fma(a, px, b*py) + c with an exactly rounded fma; XLA
chooses where to contract the finalize, so 1 ulp is allowed there).

Fixture (about 200 triangles, numpy seed 0): a 10x5 grid of quads whose
corners, edges and diagonals pass through pixel centres (edge-exact pixels
exercise the top-left rule and the watertight anchor), 40 coplanar
duplicates of grid triangles with other materials (equal depth: the later
list entry must win), and random perspective triangles of varied depth.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rend3_tpu.ops import deferred as JD
from rend3_tpu.ops import geometry as JG
from rend3_tpu.ops import raster as JRaster
from rend3_tpu_torch import interop
from rend3_tpu_torch.ops import deferred as PD
from rend3_tpu_torch.ops import geometry as PG

W, H = 256, 128


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _to_clip(xs, ys, z, w):
    """Screen (pixel) coordinates -> clip space, exact for w == 1."""
    cx = (xs / W - 0.5) * 2.0 * w
    cy = (0.5 - ys / H) * 2.0 * w
    return np.stack([cx, cy, z * w, w], axis=-1).astype(np.float32)


def _fixture():
    rng = np.random.default_rng(0)
    tris = []
    # 10x5 grid of 20x20 quads with corners on pixel centres.
    for j in range(5):
        for i in range(10):
            x0, y0 = 20.5 + 20 * i, 10.5 + 20 * j
            a, b, c, d = (x0, y0), (x0 + 20, y0), (x0 + 20, y0 + 20), (x0, y0 + 20)
            tris += [(a, b, c), (a, c, d)]
    grid = np.array(tris, np.float64)                       # (100, 3, 2)
    zg = (0.25 + 0.001 * grid[..., 0]).astype(np.float32)   # one tilted plane
    clip_grid = _to_clip(grid[..., 0], grid[..., 1], zg, np.ones_like(zg))
    dup = clip_grid[rng.choice(100, 40, replace=False)]     # coplanar duplicates
    n_rand = 60
    xs = rng.uniform(-20, W + 20, (n_rand, 3))
    ys = rng.uniform(-10, H + 10, (n_rand, 3))
    w = rng.uniform(0.5, 2.0, (n_rand, 3))
    z = rng.uniform(0.05, 0.6, (n_rand, 3))
    clip_rand = _to_clip(xs, ys, z, w)
    clip = np.concatenate([clip_grid, dup, clip_rand]).astype(np.float32)
    planes = rng.standard_normal((clip.shape[0], PD.PLANES_W)).astype(np.float32)
    planes[:, PD.P_MAT] = rng.integers(0, 9, clip.shape[0]).astype(np.float32)
    return clip, planes


@pytest.fixture(scope="module")
def raster_case():
    clip, planes = _fixture()
    t = JG.cull_and_setup(
        jnp.asarray(clip), jnp.ones(clip.shape[0], bool), W, H,
        cull_mode=JRaster.CullMode.NONE, front_is_cw=True, subpixel=True,
    )
    n = int(t.count)
    # Each duplicate (clip rows 100..139) gets its own material 100 + row,
    # so the material channel shows where a duplicate won.
    src = np.asarray(t.src)[:n]
    dups = (src >= 100) & (src < 140)
    planes[:n][dups, PD.P_MAT] = 100.0 + src[dups]
    binned = JG.bin_triangles(t, W, H, tile_cap=n, tile_h=JD.DTILE_H, tile_w=JD.DTILE_W)
    assert int(binned.overflow) == 0
    gbuf, ovf = JD.raster_resolve(t, jnp.asarray(planes), binned, W, H, interpret=True, flat_cap=1 << 14)
    depth, dovf = JD.raster_depth(t, binned, W, H, interpret=True, flat_cap=1 << 14)
    assert int(ovf) == 0 and int(dovf) == 0
    pt = interop.tri_setup(t.setup, t.bbox, t.count, t.src, t.flip)
    pb = interop.binned(binned.ids)
    pp = interop.planes(planes, t.count)
    return dict(
        clip=clip, n=n, t=t, binned=binned, pt=pt, pb=pb, pp=pp,
        jgbuf=np.asarray(gbuf.data), jdepth=np.asarray(depth),
        pgbuf=PD.raster_resolve(pt, pp, pb, W, H).data.numpy(),
        pdepth=PD.raster_depth(pt, pb, W, H).numpy(),
    )


def test_fixture_has_ties_and_edge_exact_pixels(raster_case):
    c = raster_case
    assert c["n"] >= 180
    # Some pixel centre lies exactly on an edge of a surviving triangle.
    s = c["pt"].setup.numpy()
    py, px = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    on_edge = 0
    for row in s[:140]:
        for k in range(3):
            e = row[PG.S_EA + k] * px + row[PG.S_EB + k] * py + row[PG.S_EC + k]
            on_edge += int((e == 0).sum())
    assert on_edge > 0


@pytest.mark.parametrize("channel", ["depth", "hit", "material"])
def test_k1_key_channels_exact(raster_case, channel):
    ch = {"depth": PD.G_DEPTH, "hit": PD.G_HIT, "material": PD.G_MAT}[channel]
    np.testing.assert_array_equal(raster_case["pgbuf"][ch], raster_case["jgbuf"][ch])


def test_k1_other_channels_within_one_ulp(raster_case):
    np.testing.assert_array_max_ulp(raster_case["pgbuf"], raster_case["jgbuf"], maxulp=1)


def test_k1_ties_go_to_the_later_entry(raster_case):
    """Where a grid triangle and its later coplanar duplicate both cover a
    pixel, the duplicate's material (the later setup row) shows."""
    c = raster_case
    mat = c["pgbuf"][PD.G_MAT]
    assert (c["pgbuf"][PD.G_HIT] > 0).mean() > 0.3
    shown = set(np.unique(mat[mat >= 100]).astype(int))
    # A duplicate covers exactly the pixels of its grid original at exactly
    # its depth, so it shows only if equal depth goes to the later entry;
    # the others are hidden behind nearer random triangles.
    assert len(shown) >= 10, shown


def test_k2_exact(raster_case):
    np.testing.assert_array_equal(raster_case["pdepth"], raster_case["jdepth"])
    np.testing.assert_array_equal(raster_case["pdepth"], raster_case["jgbuf"][PD.G_DEPTH])


def test_port_binning_matches(raster_case):
    c = raster_case
    own = PG.bin_triangles(c["pt"], W, H, tile_h=PD.DTILE_H, tile_w=PD.DTILE_W)
    assert torch.equal(own.offsets, c["pb"].offsets)
    assert torch.equal(own.ids, c["pb"].ids)
