"""Geometry front end: per-triangle culling, setup, and tile binning.

Port of rend3_tpu/ops/geometry.py (the redesign of the reference's
GpuCuller + cull.wgsl). The culling tests, the setup-row layout and the
watertight edge anchor follow the JAX code operand for operand. What changed
is the compaction: survivors are compacted with `nonzero` to the frame's real
count (no survivor cap), and binning is a stable sort of (tile, triangle)
pairs into CSR lists instead of the (tiles x V) masks and rank-select of the
TPU build. Each tile's list is in ascending triangle id, the order the raster
kernels' tie-break depends on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.profiling import scope as profiling_scope
from .fp import ab_minus_cd, dot3, fma32
from .hi_z import occlusion_test

__all__ = [
    "TriSetup",
    "BinnedTris",
    "CullMode",
    "cull_and_setup",
    "visibility_mask",
    "bin_triangles",
    "SETUP_W",
    "TILE_H",
    "TILE_W",
]

# The visibility raster's (K6's) tile, as geometry.py:25-26; the G-buffer
# raster K1 bins at deferred.DTILE_H x DTILE_W.
TILE_H = 8
TILE_W = 128

# Setup row layout (SETUP_W floats per surviving triangle), as geometry.py:28-35.
SETUP_W = 16
S_EA, S_EB, S_EC = 0, 3, 6        # edge eq: e_i = a_i*px + b_i*py + c_i (inside > 0)
S_ZA, S_ZB, S_ZC = 9, 10, 11      # depth plane: z = za*px + zb*py + zc
S_TL = 12                          # top-left flag, edge 0 (0.0/1.0)
S_ID = 13                          # source (clipped-table) id as float
S_TL1, S_TL2 = 14, 15             # top-left flags, edges 1 and 2


class CullMode:
    NONE = 0
    BACK = 1
    FRONT = 2


class TriSetup(NamedTuple):
    setup: torch.Tensor  # (V, SETUP_W) f32, V = number of survivors
    bbox: torch.Tensor   # (V, 4) f32: xmin, ymin, xmax, ymax (pixels)
    src: torch.Tensor    # (V,) int64 source (clipped-table) row per survivor
    flip: torch.Tensor   # (V,) bool: corners 1/2 swapped for orientation

    @property
    def count(self) -> int:
        return self.setup.shape[0]


class BinnedTris(NamedTuple):
    """CSR per-tile triangle lists: tile t's setup rows are
    ids[offsets[t]:offsets[t+1]], ascending."""

    offsets: torch.Tensor  # (n_tiles + 1,) int32
    ids: torch.Tensor      # (P,) int32 indices into the setup table


def _top_left(ax, ay, bx, by):
    """wgpu top-left fill rule for a CCW(-in-screen-space) edge a->b."""
    dy = by - ay
    dx = bx - ax
    return ((dy == 0.0) & (dx > 0.0)) | (dy < 0.0)


def _ab_minus_cd_eager(a, b, c, d):
    return a * b - c * d


def _swap12(a: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Corners 1 <-> 2 where flip (orientation fix)."""
    swapped = torch.stack([a[:, 0], a[:, 2], a[:, 1]], dim=1)
    return torch.where(flip.reshape((-1,) + (1,) * (a.dim() - 1)), swapped, a)


def _opp(a: torch.Tensor) -> torch.Tensor:
    """Column rotation [1, 2, 0]: the edge opposite each corner."""
    return torch.stack([a[:, 1], a[:, 2], a[:, 0]], dim=1)


def _screen_tests(
    clip, valid, width, height, *, cull_mode, front_is_cw, subpixel, hiz=None, capture=None, contract=False,
    y_range=None,
):
    """Degenerate / winding / viewport / sub-pixel culls (cull.wgsl), and
    the Hi-Z occlusion test against `hiz` (a hi_z.build_pyramid list) when
    given; `capture` as in hi_z.occlusion_test; `contract` and `y_range` as
    in cull_and_setup. Returns (keep, x, y, z, area2)."""
    d2 = ab_minus_cd if contract else _ab_minus_cd_eager
    w = clip[..., 3]
    inv_w = 1.0 / torch.where(w == 0.0, torch.ones_like(w), w)
    x = (clip[..., 0] * inv_w * 0.5 + 0.5) * width
    y = (0.5 - clip[..., 1] * inv_w * 0.5) * height
    z = clip[..., 2] * inv_w

    area2 = d2(x[:, 1] - x[:, 0], y[:, 2] - y[:, 0], x[:, 2] - x[:, 0], y[:, 1] - y[:, 0])
    is_front = (area2 > 0.0) if front_is_cw else (area2 < 0.0)
    keep = valid & (area2 != 0.0) & (w > 0.0).all(dim=-1)
    if cull_mode == CullMode.BACK:
        keep = keep & is_front
    elif cull_mode == CullMode.FRONT:
        keep = keep & ~is_front

    xmin, xmax = x.amin(dim=1), x.amax(dim=1)
    ymin, ymax = y.amin(dim=1), y.amax(dim=1)
    y_lo, y_hi = (0.0, float(height)) if y_range is None else (float(y_range[0]), float(y_range[1]))
    keep = keep & (xmax > 0.0) & (xmin < width) & (ymax > y_lo) & (ymin < y_hi)
    if subpixel:
        # Sub-pixel cull: the bbox holds no pixel center (cull.wgsl:221-236).
        cx = torch.floor(xmin - 0.5) + 1.5
        cy = torch.floor(ymin - 0.5) + 1.5
        keep = keep & (cx <= xmax) & (cy <= ymax)
    if hiz is not None:
        # Only triangles that passed every other test are queried.
        keep = keep & ~occlusion_test(
            hiz, xmin, ymin, xmax, ymax, z.amax(dim=1), live=keep, capture=capture
        )
    return keep, x, y, z, area2


def visibility_mask(clip, valid, width, height, *, cull_mode, front_is_cw, subpixel, hiz, capture=None):
    """Per-row potentially-visible mask: the tests of cull_and_setup,
    including the Hi-Z query, without building a setup table, in the
    frame's contracted form. Drives the two-phase predicted-visible set
    (cull.wgsl phase-2 result stores): the next frame predicts exactly the
    rows that pass against this frame's occluder depth."""
    keep, *_ = _screen_tests(
        clip, valid, width, height, cull_mode=cull_mode, front_is_cw=front_is_cw,
        subpixel=subpixel, hiz=hiz, capture=capture, contract=True,
    )
    return keep


def cull_and_setup(
    clip: torch.Tensor,      # (T, 3, 4) clipped triangles
    valid: torch.Tensor,     # (T,) bool
    width: int,
    height: int,
    *,
    cull_mode: int,
    front_is_cw: bool,
    subpixel: bool = False,
    hiz=None,
    capture=None,
    contract: bool = False,
    y_range=None,
) -> TriSetup:
    """Cull, compute edge/depth planes, compact to the survivors. With
    `hiz` (a hi_z.build_pyramid list) the survivors also pass the Hi-Z
    occlusion test, as the JAX frame's cutout geometry pass does against the
    opaque phase-1 depth (base.py:1487-1489 into geom_pass, :1334-1339);
    `capture` as in hi_z.occlusion_test.

    contract: the form XLA:CPU gives the JAX function inside a jitted
    program (the frame's form, read off its fusions): each a*b - c*d of
    the area and the edge constants as fma(a, b, -(c*d)), each depth-plane
    sum as fma(z2, e2, fma(z1, e1, z0*e0)), and the stored a coefficients
    -(yn - yo) as fma(yp, height, -yn), yo's product fused in. The default
    is the eager JAX form.

    y_range: optional (y0, y1) target rows, a row band's
    (parallel/tiles.py): only the viewport reject is restricted to
    [y0, y1), as geometry.py:108-135 does; the viewport transform and so
    every setup row stay in whole-target coordinates.

    Host read: `nonzero` sizes the survivor table (one device sync)."""
    keep, x, y, z, area2 = _screen_tests(
        clip, valid, width, height, cull_mode=cull_mode, front_is_cw=front_is_cw,
        subpixel=subpixel, hiz=hiz, capture=capture, contract=contract, y_range=y_range,
    )
    d2 = ab_minus_cd if contract else _ab_minus_cd_eager
    with profiling_scope("sync::setup.survivors"):
        g = torch.nonzero(keep).flatten()
    x, y, z, area2 = x[g], y[g], z[g], area2[g]
    flip = area2 < 0.0
    xmin, xmax = x.amin(dim=1), x.amax(dim=1)
    ymin, ymax = y.amin(dim=1), y.amax(dim=1)

    xo, yo, zo = _swap12(x, flip), _swap12(y, flip), _swap12(z, flip)
    # Edge i: from corner i to corner i+1. e = a*px + b*py + c.
    xn = torch.roll(xo, -1, dims=1)
    yn = torch.roll(yo, -1, dims=1)
    ea = -(yn - yo)
    ea_row = ea
    if contract:
        # The stored row holds -(yn - yo) as yo - yn with yo's product fused
        # in; the depth plane below reads the plain difference.
        c = clip[g]
        w = c[..., 3]
        y_pre = _swap12(0.5 - c[..., 1] * (1.0 / torch.where(w == 0.0, torch.ones_like(w), w)) * 0.5, flip)
        with profiling_scope("sync::const.setup_height"):
            height_t = torch.tensor(float(height), device=y_pre.device)
        ea_row = fma32(y_pre, height_t, -yn)
    eb = xn - xo
    ec = d2(yn - yo, xo, xn - xo, yo)
    tl = _top_left(xo, yo, xn, yn).float()

    # Watertight shared edges (geometry.py:226-239): anchor c at the
    # lexicographically smaller endpoint so two triangles sharing an edge
    # compute bitwise-opposite edge functions.
    swap = (xn < xo) | ((xn == xo) & (yn < yo))
    sgn = torch.where(swap, -1.0, 1.0).to(x.dtype)
    lx = torch.where(swap, xn, xo)
    hx = torch.where(swap, xo, xn)
    ly = torch.where(swap, yn, yo)
    hy = torch.where(swap, yo, yn)
    ec_canon = sgn * d2(hy - ly, lx, hx - lx, ly)

    # Depth plane: z(p) = sum_i z_i * e_opp_i(p) / area.
    area_o = d2(xo[:, 1] - xo[:, 0], yo[:, 2] - yo[:, 0], xo[:, 2] - xo[:, 0], yo[:, 1] - yo[:, 0])
    inv_area = 1.0 / torch.where(area_o == 0.0, torch.ones_like(area_o), area_o)

    # The three planes at once: (V, plane, corner) opposite-edge values.
    opp = torch.stack([_opp(ea), _opp(eb), _opp(ec)], dim=1)
    zc3 = zo[:, None, :]
    if contract:
        zp = dot3(zc3[..., 0], opp[..., 0], zc3[..., 1], opp[..., 1], zc3[..., 2], opp[..., 2])
    else:
        t = zc3 * opp
        zp = t[..., 0] + t[..., 1] + t[..., 2]
    za, zb, zc = (zp * inv_area[:, None]).unbind(1)
    setup = torch.stack(
        [
            ea_row[:, 0], ea_row[:, 1], ea_row[:, 2],
            eb[:, 0], eb[:, 1], eb[:, 2],
            ec_canon[:, 0], ec_canon[:, 1], ec_canon[:, 2],
            za, zb, zc,
            tl[:, 0],
            g.to(x.dtype),  # S_ID, exact below 2^24
            tl[:, 1], tl[:, 2],
        ],
        dim=1,
    )
    bbox = torch.stack([xmin, ymin, xmax, ymax], dim=1)
    return TriSetup(setup=setup.contiguous(), bbox=bbox.contiguous(), src=g, flip=flip)


def bin_triangles(
    tris: TriSetup, width: int, height: int, *, tile_h: int, tile_w: int, y0: int = 0
) -> BinnedTris:
    """Per-tile triangle lists (CSR) by bbox overlap with the tile, the
    test of geometry.py bin_triangles: xmax > tx0, xmin < tx0 + tile_w,
    ymax > ty0, ymin < ty0 + tile_h. width/height are padded to tiles.
    y0: the target row of the first tile row (a row band's first row,
    geometry.py:306, :433): tile row r covers rows [y0 + r*tile_h, ...).

    Each triangle's candidate tiles come from its bbox (one tile of slack
    on each side), the exact float test above decides, and a stable sort of
    the (tile, triangle) keys gives each tile its list in ascending id.
    Host reads: the candidate total (two repeat_interleave), the pair total
    (two boolean selections) and bincount's range: five blocking calls, each
    a sync:: span."""
    dev = tris.setup.device
    n_rows, n_cols = height // tile_h, width // tile_w
    n_tiles = n_rows * n_cols
    V = tris.count
    if V == 0:
        return BinnedTris(
            offsets=torch.zeros(n_tiles + 1, dtype=torch.int32, device=dev),
            ids=torch.zeros(0, dtype=torch.int32, device=dev),
        )
    xmin, ymin, xmax, ymax = tris.bbox.unbind(dim=1)

    def span(lo, hi, size, n):
        a = torch.floor(lo / size).clamp(-1, n).long() - 1
        b = torch.floor(hi / size).clamp(-1, n).long() + 1
        return a.clamp(0, n - 1), b.clamp(0, n - 1)

    c0, c1 = span(xmin, xmax, tile_w, n_cols)
    r0, r1 = span(ymin - y0, ymax - y0, tile_h, n_rows)
    nc = (c1 - c0 + 1).clamp_min(0)
    nr = (r1 - r0 + 1).clamp_min(0)
    cnt = nc * nr
    with profiling_scope("sync::bin.candidates"):
        tri = torch.repeat_interleave(torch.arange(V, device=dev), cnt)
    with profiling_scope("sync::bin.candidates"):
        first = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
    local = torch.arange(tri.shape[0], device=dev) - first
    row = r0[tri] + local // nc[tri]
    col = c0[tri] + local % nc[tri]
    tx0 = (col * tile_w).to(torch.float32)
    ty0 = (row * tile_h).to(torch.float32) + float(y0)
    hit = (
        (xmax[tri] > tx0)
        & (xmin[tri] < tx0 + tile_w)
        & (ymax[tri] > ty0)
        & (ymin[tri] < ty0 + tile_h)
    )
    with profiling_scope("sync::bin.pairs"):
        tile = (row * n_cols + col)[hit]
    with profiling_scope("sync::bin.pairs"):
        tri = tri[hit]
    key = tile * V + tri
    key, _ = torch.sort(key, stable=True)
    with profiling_scope("sync::bin.tile_counts"):
        counts = torch.bincount(key // V, minlength=n_tiles)
    offsets = torch.zeros(n_tiles + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    return BinnedTris(offsets=offsets.to(torch.int32), ids=(key % V).to(torch.int32))
