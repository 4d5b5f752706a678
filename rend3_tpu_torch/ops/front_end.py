"""The triangle front end's arithmetic in PyTorch, on any device: the plain
versions of the view's front end (ops/view_front.py, V1-V4) and of the
shadow pass's (ops/shadow_front.py, S1 / S2) are compositions of these
pieces, as their kernels share csrc/front_end.cuh. Each piece computes
what the chain (transform.gather_tri_clip and clip_triangles,
geometry.cull_and_setup, geometry.bin_triangles) computes, in the frame's
contracted forms, so every value equals the chain's bit for bit; where a
row or a list entry goes is its caller's choice.
"""

from __future__ import annotations

from typing import List

import torch

from .deferred import DTILE_H, DTILE_W
from .fp import ab_minus_cd, dot3, fma32
from .geometry import BinnedTris, CullMode, TriSetup
from .transform import W_EPS

__all__ = ["clip_corners", "clip_plane", "fans", "cull_setup", "tile_lists"]


def clip_corners(m: torch.Tensor, p: torch.Tensor, valid: torch.Tensor):
    """(c, whole, crossing) of T triangles with corners p (T, 3, 3) under
    their objects' MVPs m (T, 4, 4): the clip-space corners c (T, 3, 4),
    fma(m2, p2, fma(m1, p1, m0 * p0)) + m3, and of the valid triangles
    those wholly inside the near planes (w > W_EPS, w - z >= 0 at every
    corner) and those crossing them."""
    c = dot3(*(t for k in range(3) for t in (m[:, None, :, k], p[:, :, None, k]))) + m[:, None, :, 3]
    w = c[..., 3]
    inside = ((w - c[..., 2]) >= 0.0) & (w > W_EPS)
    all_in = inside.all(dim=-1)
    return c, valid & all_in, valid & inside.any(dim=-1) & ~all_in


def clip_plane(v: torch.Tensor, n: torch.Tensor, d: torch.Tensor):
    """One Sutherland-Hodgman step (front_end.cuh clip_plane) for polygons
    of n <= 4 corners in 5 slots: keep corners with d >= 0, add the crossing
    points fma(vj - vi, t, vi), every column alike."""
    N = v.shape[0]
    rows = torch.arange(N, device=v.device)
    out = torch.zeros_like(v)
    on = torch.zeros_like(n)
    for i in range(4):
        live = i < n
        j = torch.where(i + 1 >= n, torch.zeros_like(n), torch.full_like(n, i + 1))
        vi, vj = v[:, i], v[rows, j]
        di, dj = d[:, i], d[rows, j]
        ini, inj = di >= 0.0, dj >= 0.0
        emit = live & ini
        out[rows[emit], on[emit]] = vi[emit]
        on = on + emit.long()
        cross = live & (ini != inj)
        den = di - dj
        t = di / torch.where(den.abs() < 1e-30, torch.full_like(den, 1e-30), den)
        out[rows[cross], on[cross]] = fma32(vj - vi, t[:, None], vi)[cross]
        on = on + cross.long()
    return out, on


def fans(c: torch.Tensor):
    """(fan, live) of crossing triangles c (n, 3, 4) clipped against w -
    W_EPS >= 0, then w - z >= 0: fan (3, n, 3, 7), fan k of each polygon
    (its corners 0, k + 1, k + 2, each the clip corner and the source
    triangle's barycentrics), and live (3, n), whether fan k exists."""
    n = c.shape[0]
    poly = torch.zeros(n, 5, 7, dtype=torch.float32, device=c.device)
    poly[:, :3, :4], poly[:, :3, 4:] = c, torch.eye(3, dtype=torch.float32, device=c.device)
    cnt = torch.full((n,), 3, dtype=torch.long, device=c.device)
    poly, cnt = clip_plane(poly, cnt, poly[..., 3] - W_EPS)
    poly, cnt = clip_plane(poly, cnt, poly[..., 3] - poly[..., 2])
    fan = torch.stack([torch.stack([poly[:, 0], poly[:, k + 1], poly[:, k + 2]], dim=1) for k in range(3)])
    return fan, torch.stack([cnt >= k + 3 for k in range(3)])


def _occluded(pyramid: List[torch.Tensor], xmin, ymin, xmax, ymax, zmax) -> torch.Tensor:
    """hi_z.occlusion_test's answer read straight from the mips: the level
    by ceil(log(max(extent, 1)) / log(2)), the min of its 2x2 footprint
    from the base texel with the last row and column repeated."""
    extent = torch.maximum(xmax - xmin, ymax - ymin)
    ln2 = torch.log(torch.full((), 2.0, dtype=torch.float32, device=xmin.device))
    level = torch.ceil(torch.log(torch.clamp_min(extent, 1.0)) / ln2).to(torch.int32).clamp(0, len(pyramid) - 1)
    m = torch.zeros_like(xmin)
    for lv, mip in enumerate(pyramid):
        mh, mw = mip.shape
        scale = float(1 << lv)
        x0 = (xmin / scale).to(torch.int32).clamp(0, mw - 1).long()
        y0 = (ymin / scale).to(torch.int32).clamp(0, mh - 1).long()
        x1, y1 = (x0 + 1).clamp_max(mw - 1), (y0 + 1).clamp_max(mh - 1)
        v = torch.minimum(torch.minimum(mip[y0, x0], mip[y0, x1]), torch.minimum(mip[y1, x0], mip[y1, x1]))
        m = torch.where(level == lv, v, m)
    return zmax < m


def cull_setup(c, valid, width, height, *, cull_mode, front_is_cw, subpixel, hiz=None, y_range=None) -> TriSetup:
    """cull_and_setup(contract=True) of the rows c (N, 3, 4) where valid:
    each row's screen transform and tests (winding by cull_mode, every w >
    0, the viewport's columns and the rows of y_range (y0, y1), default the
    target's, the sub-pixel test, the Hi-Z pyramid's), then the survivors
    in ascending row, each with its setup row (S_ID and src its row in c)
    and bbox."""
    w = c[..., 3]
    inv_w = 1.0 / torch.where(w == 0.0, torch.ones_like(w), w)
    x = (c[..., 0] * inv_w * 0.5 + 0.5) * width
    yp = 0.5 - c[..., 1] * inv_w * 0.5
    y = yp * height
    z = c[..., 2] * inv_w
    area2 = ab_minus_cd(x[:, 1] - x[:, 0], y[:, 2] - y[:, 0], x[:, 2] - x[:, 0], y[:, 1] - y[:, 0])
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
        keep = keep & (torch.floor(xmin - 0.5) + 1.5 <= xmax) & (torch.floor(ymin - 0.5) + 1.5 <= ymax)
    if hiz:
        keep = keep & ~_occluded(hiz, xmin, ymin, xmax, ymax, z.amax(dim=1))
    g = torch.nonzero(keep).flatten()
    x, y, z, yp, area2 = x[g], y[g], z[g], yp[g], area2[g]
    flip = area2 < 0.0
    # Corners 1 and 2 swapped where flip (orientation fix).
    xo, yo, zo, ypo = (torch.where(flip[:, None], torch.stack([a[:, 0], a[:, 2], a[:, 1]], dim=1), a)
                       for a in (x, y, z, yp))
    xn, yn = xo.roll(-1, dims=1), yo.roll(-1, dims=1)
    dy, dx = yn - yo, xn - xo
    ea = -dy
    ea_row = fma32(ypo, torch.full_like(ypo, float(height)), -yn)
    ec = ab_minus_cd(dy, xo, dx, yo)
    tl = (((dy == 0.0) & (dx > 0.0)) | (dy < 0.0)).float()
    swap = (xn < xo) | ((xn == xo) & (yn < yo))
    lx, hx = torch.where(swap, xn, xo), torch.where(swap, xo, xn)
    ly, hy = torch.where(swap, yn, yo), torch.where(swap, yo, yn)
    cc = ab_minus_cd(hy - ly, lx, hx - lx, ly)
    ec_canon = torch.where(swap, -cc, cc)
    area_o = ab_minus_cd(xo[:, 1] - xo[:, 0], yo[:, 2] - yo[:, 0], xo[:, 2] - xo[:, 0], yo[:, 1] - yo[:, 0])
    inv_area = 1.0 / torch.where(area_o == 0.0, torch.ones_like(area_o), area_o)
    # Each depth-plane coefficient fma(z2, e0, fma(z1, e2, z0 * e1)) / area.
    za, zb, zc = (dot3(zo[:, 0], e[:, 1], zo[:, 1], e[:, 2], zo[:, 2], e[:, 0]) * inv_area for e in (ea, dx, ec))
    setup = torch.stack([*ea_row.unbind(1), *dx.unbind(1), *ec_canon.unbind(1), za, zb, zc,
                         tl[:, 0], g.to(torch.float32), tl[:, 1], tl[:, 2]], dim=1)
    bbox = torch.stack([xmin[g], ymin[g], xmax[g], ymax[g]], dim=1)
    return TriSetup(setup=setup.contiguous(), bbox=bbox.contiguous(), src=g, flip=flip)


def _axis_hits(bmin, bmax, tile: int, n: int, org: int) -> torch.Tensor:
    """(V, n): tile i of an axis holds the bbox [bmin, bmax]: bin_triangles'
    candidates (the span of [bmin, bmax] - org, a tile of slack each side)
    that pass its float test bmax > t0, bmin < t0 + tile, t0 = i * tile +
    org."""
    def edge(v, d):
        return (torch.floor((v - org) / tile).clamp(-1, n).long() + d).clamp(0, n - 1)

    a, b = edge(bmin, -1)[:, None], edge(bmax, 1)[:, None]
    i = torch.arange(n, device=bmin.device)
    t0 = (i * tile).to(torch.float32) + float(org)
    return (i >= a) & (i <= b) & (bmax[:, None] > t0) & (bmin[:, None] < t0 + tile)


def tile_lists(bbox: torch.Tensor, n_cols: int, n_rows: int, y0: int) -> BinnedTris:
    """The CSR lists of the DTILE_H x DTILE_W tiles of an n_cols x n_rows
    grid whose first row is target row y0: each tile's list holds the rows
    whose bbox (V, 4) meets it, ascending, at the tile's offset (a prefix
    sum of the tile counts)."""
    xmin, ymin, xmax, ymax = bbox.unbind(dim=1)
    cols = _axis_hits(xmin, xmax, DTILE_W, n_cols, 0)
    rows = _axis_hits(ymin, ymax, DTILE_H, n_rows, y0)
    hit = (rows[:, :, None] & cols[:, None, :]).reshape(bbox.shape[0], n_rows * n_cols)
    _tile, tri = torch.nonzero(hit.T, as_tuple=True)
    offsets = torch.zeros(n_rows * n_cols + 1, dtype=torch.int64, device=bbox.device)
    offsets[1:] = torch.cumsum(hit.sum(dim=0), 0)
    return BinnedTris(offsets=offsets.to(torch.int32), ids=tri.to(torch.int32))
