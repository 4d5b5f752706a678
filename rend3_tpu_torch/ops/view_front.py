"""The view's triangle front end on the card: V1-V4 (csrc/view_front.cu).

Every triangle set the frame rasters with K1 (the main set, the residual
set, the cutout set and the blend set) needs the same tables: the clipped
table of transform.gather_tri_clip and clip_triangles, the survivors' setup
rows of geometry.cull_and_setup, their planes of
deferred.attribute_planes and their tile lists of geometry.bin_triangles,
all in the frame's contracted forms. On CUDA tensors these functions build
them with hand-written kernels: `clip` (V1: a count, one host read of the
crossing triangles, a fill), `cull` (V2: the tests, a scan, one host read
of the survivor and pair totals, the setup rows), `planes` (V3) and
`tiles` (V4). Every row and list entry is placed by a scan, so the tables
equal the chain's bit for bit and in its order: the clipped rows (sources,
then every crossing triangle's fan 0, fan 1, fan 2), the survivors in
ascending clipped row, each tile's list ascending (K1 breaks depth ties by
list order).

`clip_plain`, `cull_plain`, `planes_plain` and `tiles_plain` are the same
algorithm in PyTorch on any device, the reference the card is held to. The
CPU's frame keeps the chain (routine/base.py).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from ..utils.profiling import scope as profiling_scope
from .deferred import DTILE_H, DTILE_W, PLANES_W, attribute_planes
from .fp import ab_minus_cd, dot3, fma32
from .geometry import SETUP_W, BinnedTris, CullMode, TriSetup
from .shadow_front import _clip_plane
from .transform import W_EPS, ClippedTris

__all__ = ["Culled", "on_card", "clip", "cull", "planes", "tiles", "clip_plain", "cull_plain", "planes_plain",
           "tiles_plain", "launch_clip_count", "launch_clip_fill", "launch_cull", "launch_setup", "launches", "BLOCK",
           "MAX_LEVELS", "MAX_TILES"]

# Rows of a CTA's block (csrc/view_front.cu kBlock): the clip count, the
# cull and the tile lists work in blocks of this many rows.
BLOCK = 1024
# Hi-Z mips the cull takes (hi_z.build_pyramid's max_levels).
MAX_LEVELS = 12
# Tiles of a target the cull and the tile lists hold in shared memory (48 KiB).
MAX_TILES = 12288
# Attribute bases of an object (position, normal, tangent, uv0, uv1, color0).
N_ATTRS = 6
# Launch counts (plain-version runs do not count); each name is a row of
# chip_smoke.py's kernels line: V1 (its count and fill), V2 (cull, scan
# and setup), V3, V4.
launches = {"view_clip": 0, "view_setup": 0, "view_planes": 0, "view_tiles": 0}


def on_card(t: torch.Tensor) -> bool:
    """Whether the front end of a frame on t's device runs V1-V4."""
    return t.is_cuda


class Culled(NamedTuple):
    """A cull's survivors and what its tile lists need: the keep flags, and
    the (block, tile) table, block bases and totals V2 left in `ints`, the
    CSR offsets, the pair total. `launch` is V2's launch arguments (for
    launch_cull / launch_setup)."""

    tris: TriSetup
    keep: torch.Tensor
    ints: torch.Tensor
    offsets: torch.Tensor
    pairs: int
    n_cols: int
    n_rows: int
    y0: int
    launch: tuple


def _need(name: str, t: torch.Tensor, dtype, tail=None, rows=None) -> None:
    if t.dtype != dtype or not t.is_contiguous() or (tail is not None and tuple(t.shape[1:]) != tuple(tail)) or (
            rows is not None and t.shape[0] != rows):
        raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} (contiguous {t.is_contiguous()}): want "
                         f"{'(N' if rows is None else f'({rows}'}{''.join(f', {d}' for d in tail or ())}) {dtype}")


def _grid(wp: int, hp: int):
    n_cols, n_rows = wp // DTILE_W, hp // DTILE_H
    if n_cols < 1 or n_rows < 1 or n_cols * n_rows > MAX_TILES:
        raise ValueError(f"the tile lists take 1..{MAX_TILES} tiles of {DTILE_H}x{DTILE_W}; got {n_rows}x{n_cols}")
    return n_cols, n_rows


# -- V1: the clipped table -----------------------------------------------------


def _check_clip(positions, tri_vlocal, tri_obj, bases, mvp, visible):
    T = tri_obj.shape[0]
    _need("positions", positions, torch.float32, (3,))
    _need("tri_vlocal", tri_vlocal, torch.int32, (3,), T)
    _need("tri_obj", tri_obj, torch.int32, (), T)
    _need("bases", bases, torch.int32, (N_ATTRS,))
    _need("mvp", mvp, torch.float32, (4, 4))
    _need("visible", visible, torch.bool, ())
    if positions.shape[0] < 1 or mvp.shape[0] < 1 or bases.shape[0] < mvp.shape[0] or visible.shape[0] < 1:
        raise ValueError("clip needs a position, an object and a visibility flag")


def _clip_sizes(inputs):
    positions, _v, tri_obj, _b, mvp, visible = inputs
    return (tri_obj.shape[0], positions.shape[0], mvp.shape[0], visible.shape[0])


def launch_clip_count(inputs, blk: torch.Tensor) -> None:
    """V1's count over clip's `inputs` (T > 0) into blk (T // BLOCK + 2
    int32): each block's first fan row, the crossing total at
    blk[ceil(T / BLOCK)]. No host read."""
    from . import cuda_kernels

    cuda_kernels.call("v1_clip_count", *inputs, blk, ints=_clip_sizes(inputs))
    launches["view_clip"] += 1


def launch_clip_fill(inputs, blk: torch.Tensor, n_cross: int, out: ClippedTris) -> None:
    """V1's fill of `out` (T + 3 n_cross rows) after the count. No host
    read."""
    from . import cuda_kernels

    cuda_kernels.call("v1_clip_fill", *inputs, blk, out.clip, out.bary, out.orig, out.valid,
                      ints=_clip_sizes(inputs) + (n_cross,))
    launches["view_clip"] += 1


def clip(positions, tri_vlocal, tri_obj, bases, mvp, visible) -> ClippedTris:
    """The clipped table of a triangle set (gather_tri_clip and
    clip_triangles, contract=True; tri_valid = visible[tri_obj]) on CUDA
    tensors: V1's count, one host read of the crossing triangles, V1's
    fill. positions (Np, 3) f32, tri_vlocal (T, 3) / tri_obj (T,) int32,
    bases (O, 6) int32 (column 0 the position base), mvp (O, 4, 4) f32,
    visible (Ov,) bool."""
    inputs = (positions, tri_vlocal, tri_obj, bases, mvp, visible)
    _check_clip(*inputs)
    dev = positions.device
    T = tri_obj.shape[0]
    n_cross = 0
    blk = torch.empty(T // BLOCK + 2, dtype=torch.int32, device=dev)
    if T:
        with profiling_scope("kernel::V1"):
            launch_clip_count(inputs, blk)
        with profiling_scope("sync::view_front.crossing"):
            n_cross = int(blk[-(-T // BLOCK)])
    n = T + 3 * n_cross
    out = ClippedTris(
        clip=torch.empty(n, 3, 4, dtype=torch.float32, device=dev),
        orig=torch.empty(n, dtype=torch.int64, device=dev),
        bary=torch.empty(n, 3, 3, dtype=torch.float32, device=dev),
        valid=torch.empty(n, dtype=torch.bool, device=dev),
    )
    if T:
        with profiling_scope("kernel::V1"):
            launch_clip_fill(inputs, blk, n_cross, out)
    return out


# -- V2: cull and setup ----------------------------------------------------------


def _hiz_args(hiz: Optional[Sequence[torch.Tensor]], dev):
    """The mips one after another and (levels, then each mip's height,
    width and first element, 36 ints)."""
    if not hiz:
        return None, [0] * (1 + 3 * MAX_LEVELS)
    if len(hiz) > MAX_LEVELS:
        raise ValueError(f"the cull takes at most {MAX_LEVELS} Hi-Z mips, got {len(hiz)}")
    dims, base = [], 0
    for m in hiz:
        if m.dim() != 2 or m.dtype != torch.float32 or m.device != dev:
            raise ValueError(f"Hi-Z mip {tuple(m.shape)} {m.dtype} on {m.device}: want 2-D float32 on {dev}")
        dims += [m.shape[0], m.shape[1], base]
        base += m.numel()
    mips = torch.cat([m.reshape(-1) for m in hiz])
    return mips, [len(hiz)] + dims + [0] * (3 * (MAX_LEVELS - len(hiz)))


def cull(clip_rows, valid, width, height, *, cull_mode, front_is_cw, subpixel, hiz=None, y_range=None, wp, hp,
         y0=0) -> Culled:
    """geometry.cull_and_setup(contract=True) of the clipped rows on CUDA
    tensors, with the counts bin_triangles(wp, hp, DTILE_H, DTILE_W, y0)
    needs: V2's cull and scan, one host read of the survivor and pair
    totals, V2's setup. clip_rows (Tc, 3, 4) f32, valid (Tc,) bool; hiz a
    hi_z.build_pyramid list or None; y_range a row band's (y0, y1) or
    None."""
    Tc = clip_rows.shape[0]
    _need("clip", clip_rows, torch.float32, (3, 4))
    _need("valid", valid, torch.bool, (), Tc)
    dev = clip_rows.device
    n_cols, n_rows = _grid(wp, hp)
    n_tiles = n_cols * n_rows
    nb = -(-Tc // BLOCK)
    mips, dims = _hiz_args(hiz, dev)
    y_lo, y_hi = (0.0, float(height)) if y_range is None else (float(y_range[0]), float(y_range[1]))
    launch = (clip_rows, valid, mips, (Tc, n_cols, n_rows, y0, int(cull_mode), int(bool(front_is_cw)),
                                       int(bool(subpixel)), *dims), (float(width), float(height), y_lo, y_hi))
    culled = Culled(None, torch.empty(Tc, dtype=torch.bool, device=dev),
                    torch.empty(nb + 1 + n_tiles * nb + n_tiles + 2, dtype=torch.int32, device=dev),
                    torch.empty(n_tiles + 1, dtype=torch.int32, device=dev), 0, n_cols, n_rows, y0, launch)
    with profiling_scope("kernel::V2"):
        launch_cull(culled)
    with profiling_scope("sync::view_front.totals"):
        V, P = culled.ints[-2:].tolist()
    tris = TriSetup(
        setup=torch.empty(V, SETUP_W, dtype=torch.float32, device=dev),
        bbox=torch.empty(V, 4, dtype=torch.float32, device=dev),
        src=torch.empty(V, dtype=torch.int64, device=dev),
        flip=torch.empty(V, dtype=torch.bool, device=dev),
    )
    culled = culled._replace(tris=tris, pairs=P)
    if V:
        with profiling_scope("kernel::V2"):
            launch_setup(culled)
    return culled


def launch_cull(culled: Culled) -> None:
    """V2's cull and scan into culled.keep, .ints and .offsets. No host
    read."""
    from . import cuda_kernels

    clip_rows, valid, mips, ints, floats = culled.launch
    cuda_kernels.call("v2_cull", clip_rows, valid, culled.keep, culled.ints, culled.offsets, mips, ints=ints,
                      floats=floats)
    launches["view_setup"] += 2


def launch_setup(culled: Culled) -> None:
    """V2's setup rows into culled.tris, after the cull and the read that
    sized them. No host read."""
    from . import cuda_kernels

    clip_rows, _valid, _mips, ints, floats = culled.launch
    cuda_kernels.call("v2_setup", clip_rows, culled.keep, culled.ints, *culled.tris,
                      ints=(ints[0], culled.n_cols * culled.n_rows), floats=floats[:2])
    launches["view_setup"] += 1


# -- V3 and V4 -------------------------------------------------------------------


def planes(culled: Culled, table: ClippedTris, tri_vlocal, tri_obj, bases, geo, model_view, obj_material, width,
           height) -> torch.Tensor:
    """The (V, PLANES_W) plane table of a cull's survivors
    (deferred.attribute_planes(contract=True)) on CUDA tensors: V3."""
    from . import cuda_kernels

    tris = culled.tris
    V = tris.count
    arenas = (geo.position, geo.normal, geo.tangent, geo.uv0, geo.uv1, geo.color0)
    for name, a, c in zip(("position", "normal", "tangent", "uv0", "uv1", "color0"), arenas, (3, 3, 3, 2, 2, 4)):
        _need(name, a, torch.float32, (c,))
    _need("tri_vlocal", tri_vlocal, torch.int32, (3,))
    _need("tri_obj", tri_obj, torch.int32, (), tri_vlocal.shape[0])
    _need("bases", bases, torch.int32, (N_ATTRS,))
    _need("model_view", model_view, torch.float32, (4, 4))
    _need("obj_material", obj_material, torch.int32, ())
    for name, t in zip(("clip", "bary", "orig"), (table.clip, table.bary, table.orig)):
        if not t.is_contiguous():
            raise ValueError(f"the clipped table's {name} must be contiguous")
    out = torch.empty(V, PLANES_W, dtype=torch.float32, device=tris.setup.device)
    if V:
        with profiling_scope("kernel::V3"):
            cuda_kernels.call(
                "v3_planes", tris.src, tris.flip, table.clip, table.bary, table.orig, tri_vlocal, tri_obj, bases,
                *arenas, model_view, obj_material, out,
                ints=(V, *(a.shape[0] for a in arenas)), floats=(float(width), float(height)),
            )
            launches["view_planes"] += 1
    return out


def tiles(culled: Culled) -> BinnedTris:
    """The CSR tile lists of a cull's survivors (bin_triangles at DTILE_H x
    DTILE_W from row y0) on CUDA tensors: V4."""
    from . import cuda_kernels

    ids = torch.empty(culled.pairs, dtype=torch.int32, device=culled.offsets.device)
    if culled.pairs:
        with profiling_scope("kernel::V4"):
            cuda_kernels.call("v4_tiles", culled.tris.bbox, culled.ints, culled.offsets, ids,
                              ints=(culled.launch[0].shape[0], culled.n_cols, culled.n_rows, culled.y0))
            launches["view_tiles"] += 1
    return BinnedTris(offsets=culled.offsets, ids=ids)


# -- the plain version -------------------------------------------------------------


def clip_plain(positions, tri_vlocal, tri_obj, bases, mvp, visible) -> ClippedTris:
    """Plain version of clip (V1's algorithm in PyTorch, any device): each
    triangle's corners and classes, the crossing triangles' ranks by a
    prefix sum, then the T source rows and fan k of the crossing triangle
    of rank r at row T + k * n_cross + r."""
    _check_clip(positions, tri_vlocal, tri_obj, bases, mvp, visible)
    T = tri_obj.shape[0]
    dev = positions.device
    obj = tri_obj.long()
    oc = obj.clamp_min(0)
    tri_valid = visible[obj]
    ids = (tri_vlocal.long() + bases[oc, 0].long()[:, None]).clamp(0, positions.shape[0] - 1)
    p, m = positions[ids], mvp[oc]
    c = dot3(*(t for k in range(3) for t in (m[:, None, :, k], p[:, :, None, k]))) + m[:, None, :, 3]
    w = c[..., 3]
    inside = ((w - c[..., 2]) >= 0.0) & (w > W_EPS)
    all_in = inside.all(dim=-1)
    crossing = tri_valid & inside.any(dim=-1) & ~all_in
    rank = torch.cumsum(crossing.long(), 0) - 1
    n_cross = int(crossing.sum())
    eye = torch.eye(3, dtype=torch.float32, device=dev).expand(T, 3, 3)
    n = T + 3 * n_cross
    out = ClippedTris(clip=torch.zeros(n, 3, 4, device=dev), orig=torch.zeros(n, dtype=torch.int64, device=dev),
                      bary=torch.zeros(n, 3, 3, device=dev), valid=torch.zeros(n, dtype=torch.bool, device=dev))
    out.clip[:T], out.bary[:T] = c, eye
    out.orig[:T] = torch.arange(T, device=dev)
    out.valid[:T] = tri_valid & all_in
    if n_cross:
        g = torch.nonzero(crossing).flatten()
        poly = torch.zeros(n_cross, 5, 7, dtype=torch.float32, device=dev)
        poly[:, :3, :4], poly[:, :3, 4:] = c[g], eye[g]
        cnt = torch.full((n_cross,), 3, dtype=torch.long, device=dev)
        poly, cnt = _clip_plane(poly, cnt, poly[..., 3] - W_EPS)
        poly, cnt = _clip_plane(poly, cnt, poly[..., 3] - poly[..., 2])
        for k in range(3):
            rows = T + k * n_cross + rank[g]
            fan = torch.stack([poly[:, 0], poly[:, k + 1], poly[:, k + 2]], dim=1)
            out.clip[rows], out.bary[rows] = fan[..., :4], fan[..., 4:]
            out.orig[rows] = g
            out.valid[rows] = cnt >= k + 3
    return out


def _screen(c: torch.Tensor, width, height):
    w = c[..., 3]
    inv_w = 1.0 / torch.where(w == 0.0, torch.ones_like(w), w)
    x = (c[..., 0] * inv_w * 0.5 + 0.5) * width
    yp = 0.5 - c[..., 1] * inv_w * 0.5
    y = yp * height
    z = c[..., 2] * inv_w
    area2 = ab_minus_cd(x[:, 1] - x[:, 0], y[:, 2] - y[:, 0], x[:, 2] - x[:, 0], y[:, 1] - y[:, 0])
    return x, y, z, yp, area2


def _occluded_plain(pyramid: List[torch.Tensor], xmin, ymin, xmax, ymax, zmax) -> torch.Tensor:
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


def cull_plain(clip_rows, valid, width, height, *, cull_mode, front_is_cw, subpixel, hiz=None,
               y_range=None) -> TriSetup:
    """Plain version of cull (V2's algorithm in PyTorch, any device): each
    row's tests, then the survivors at their prefix sum over the keep flags
    (ascending clipped row) and their setup rows."""
    x, y, z, yp, area2 = _screen(clip_rows, width, height)
    w = clip_rows[..., 3]
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
        keep = keep & ~_occluded_plain(hiz, xmin, ymin, xmax, ymax, z.amax(dim=1))
    pos = torch.cumsum(keep.long(), 0) - 1
    V = int(keep.sum())
    g = torch.zeros(V, dtype=torch.int64, device=keep.device)
    g[pos[keep]] = torch.nonzero(keep).flatten()
    x, y, z, yp, area2 = x[g], y[g], z[g], yp[g], area2[g]
    flip = area2 < 0.0

    def swap12(a):
        return torch.where(flip[:, None], torch.stack([a[:, 0], a[:, 2], a[:, 1]], dim=1), a)

    xo, yo, zo, ypo = swap12(x), swap12(y), swap12(z), swap12(yp)
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


def planes_plain(tris: TriSetup, table: ClippedTris, tri_vlocal, tri_obj, bases, geo, model_view, obj_material,
                 width, height) -> torch.Tensor:
    """Plain version of planes: V3 evaluates attribute_planes(contract=True)
    row by row, so that function is its plain version."""
    return attribute_planes(tris, table.clip, table.bary, table.orig, tri_vlocal, tri_obj, bases, geo, model_view,
                            obj_material, width, height, contract=True)


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


def tiles_plain(tris: TriSetup, wp: int, hp: int, y0: int = 0) -> BinnedTris:
    """Plain version of tiles (V4's algorithm in PyTorch, any device): each
    survivor's rectangle of tiles, then each tile's survivors ascending,
    at the tile's offset (a prefix sum of the tile counts)."""
    n_cols, n_rows = _grid(wp, hp)
    xmin, ymin, xmax, ymax = tris.bbox.unbind(dim=1)
    cols = _axis_hits(xmin, xmax, DTILE_W, n_cols, 0)
    rows = _axis_hits(ymin, ymax, DTILE_H, n_rows, y0)
    hit = (rows[:, :, None] & cols[:, None, :]).reshape(tris.count, n_rows * n_cols)
    _tile, tri = torch.nonzero(hit.T, as_tuple=True)
    offsets = torch.zeros(n_rows * n_cols + 1, dtype=torch.int64, device=tris.bbox.device)
    offsets[1:] = torch.cumsum(hit.sum(dim=0), 0)
    return BinnedTris(offsets=offsets.to(torch.int32), ids=tri.to(torch.int32))
