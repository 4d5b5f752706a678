"""The shadow pass's front end on the card: S1 and S2 (csrc/shadow_front.cu).

Every shadow map of a frame needs the caster table of its light (the
clip transform, the near clip, the FRONT cull and the setup rows of
transform.gather_tri_clip, clip_triangles and geometry.cull_and_setup in
their contracted forms) and its DTILE_H x DTILE_W tile lists
(geometry.bin_triangles), which K2 (deferred.raster_depth) rasters. On
CUDA tensors `shadow_front` builds them for all maps with S1 (one thread a
(map, triangle): transform, clip, cull, setup, append, tile counts) and S2
(the scan, then one read of every map's totals on the host, then the
fill), in place of the chain's ~630 PyTorch ops and 8 blocking reads a
map. The rows equal the chain's bit for bit; their order and the order
within a tile's list come from atomics, which K2's per-texel max cannot
see. The view's front end (ops/view_front.py) places its rows by scans
instead: its K1 breaks depth ties by list order.

`shadow_front_plain` is S1 and S2's algorithm in PyTorch on any device,
with rows in the fixed slot order (row 4 t + s before compaction: slot 0
the triangle when it lies wholly inside the near planes, slot 1 + k the
k-th fan of its clipped polygon) and each tile's list ascending, so it is
deterministic; the card's tables equal it as row multisets.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from ..utils.profiling import scope as profiling_scope
from .deferred import DTILE_H, DTILE_W
from .fp import ab_minus_cd, dot3, fma32
from .geometry import SETUP_W, BinnedTris, TriSetup
from .transform import W_EPS, object_uniforms

__all__ = ["ShadowFrontBuffers", "MapFront", "light_mvp", "shadow_front", "shadow_front_plain", "launches",
           "MAX_MAPS", "SLOTS"]

# Maps a launch of S1 / S2 (csrc/shadow_front.cu kMaxMaps); more maps take
# one launch a group.
MAX_MAPS = 4
# Candidate rows a source triangle: the triangle itself, or its three fans.
SLOTS = 4
# Launch counts (plain-version runs do not count); each name is a row of
# chip_smoke.py's kernels line: S1, and S2 (its scan and its fill count
# one launch each).
launches = {"shadow_setup": 0, "shadow_tiles": 0}


class MapFront(NamedTuple):
    """One map's caster table and tile lists, as K2 takes them."""

    tris: TriSetup
    binned: BinnedTris
    width: int   # the map padded to DTILE_W
    height: int  # the map padded to DTILE_H


def _padded(size: int) -> Tuple[int, int]:
    return -(-size // DTILE_W) * DTILE_W, -(-size // DTILE_H) * DTILE_H


def _n_tiles(size: int) -> int:
    wp, hp = _padded(size)
    return (wp // DTILE_W) * (hp // DTILE_H)


def _check(sizes, mvp, vis, tri_pos, tri_obj) -> torch.device:
    dev = tri_pos.device
    T = tri_pos.shape[0]
    L = len(sizes)
    if tri_pos.dtype != torch.float32 or tri_pos.shape[1:] != (3, 3):
        raise ValueError(f"tri_pos {tuple(tri_pos.shape)} {tri_pos.dtype}, want (T, 3, 3) float32")
    if tri_obj.dtype != torch.int32 or tri_obj.shape != (T,):
        raise ValueError(f"tri_obj {tuple(tri_obj.shape)} {tri_obj.dtype}, want ({T},) int32")
    if mvp.dtype != torch.float32 or mvp.dim() != 4 or mvp.shape[0] < L or mvp.shape[2:] != (4, 4):
        raise ValueError(f"mvp {tuple(mvp.shape)} {mvp.dtype}, want ({L}, O, 4, 4) float32")
    if vis.dtype != torch.bool or vis.dim() != 2 or vis.shape[0] < L:
        raise ValueError(f"vis {tuple(vis.shape)} {vis.dtype}, want ({L}, O) bool")
    if any(int(s) < 1 for s in sizes):
        raise ValueError(f"map sizes {list(sizes)}")
    for t in (mvp, vis, tri_pos, tri_obj):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("shadow front inputs must be contiguous and on one device")
    return dev


class ShadowFrontBuffers:
    """S1 and S2's device buffers, kept by their owner (a render graph)
    across frames: the caster tables at 3 rows a source triangle (the most
    a triangle yields), the tile counts, offsets and cursors of every map,
    the totals and the lists. They are reallocated only when the triangle
    count, the maps or the pair total grow; each shadow_front call
    overwrites them, and the tables it returns are views of them."""

    def __init__(self):
        self.key = None
        self.ids = None

    def fit(self, n_tris: int, sizes: Sequence[int], device: torch.device) -> None:
        L = len(sizes)
        n_tiles = [_n_tiles(s) for s in sizes]
        cap = 3 * n_tris
        total = sum(n_tiles)
        self.tile_base = self._bases(n_tiles)
        if self.key is not None:
            o_cap, o_L, o_total, o_dev = self.key
            if o_dev == device and o_cap >= cap and o_L == L and o_total >= total:
                return
        self.key = (cap, L, total, device)
        f32 = dict(dtype=torch.float32, device=device)
        self.cap = cap
        self.setup = torch.empty(L, cap, SETUP_W, **f32)
        self.bbox = torch.empty(L, cap, 4, **f32)
        self.src = torch.empty(L, cap, dtype=torch.int64, device=device)
        self.flip = torch.empty(L, cap, dtype=torch.bool, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        self.counts = torch.empty(L + total, **i32)   # survivors a map, then tile counts
        self.offsets = torch.empty(total + L, **i32)  # map m's n_tiles + 1 from tile_base[m] + m
        self.cursor = torch.empty(total, **i32)
        self.totals = torch.empty(2 * L, **i32)       # survivors a map, then pairs a map
        if self.ids is not None and self.ids.device != device:
            self.ids = None

    def fit_ids(self, n: int, device: torch.device) -> None:
        if self.ids is None or self.ids.numel() < n:
            self.ids = torch.empty(max(n + n // 4, 1), dtype=torch.int32, device=device)

    @staticmethod
    def _bases(n_tiles):
        out, b = [], 0
        for n in n_tiles:
            out.append(b)
            b += n
        return out


def light_mvp(transforms: torch.Tensor, light_vp: torch.Tensor, n_maps: int) -> torch.Tensor:
    """(n_maps, O, 4, 4) light-space MVP of every object for each map, the
    matrices the chain forms a map at a time (transform.object_uniforms
    with the light's view-projection and an identity projection), in one
    broadcast product."""
    eye = torch.eye(4, dtype=torch.float32, device=transforms.device)
    return object_uniforms(transforms, light_vp[:n_maps, None], eye)[1].contiguous()


def _groups(sizes):
    for first in range(0, len(sizes), MAX_MAPS):
        yield first, list(sizes[first:first + MAX_MAPS])


def _pad(vals):
    return list(vals) + [0] * (MAX_MAPS - len(vals))


def launch_setup(bufs: ShadowFrontBuffers, sizes, front_is_cw, mvp, vis, tri_pos, tri_obj) -> None:
    """Zero the counters, then S1 over every map (one launch a group of
    MAX_MAPS): the tables, the survivor counts and the tile counts. No host
    read."""
    from . import cuda_kernels

    L = len(sizes)
    bufs.counts.zero_()
    surv, tiles = bufs.counts[:L], bufs.counts[L:]
    for first, group in _groups(sizes):
        cuda_kernels.call(
            "s1_shadow_setup", tri_pos, tri_obj, mvp, vis, bufs.setup, bufs.bbox, bufs.src, bufs.flip, surv, tiles,
            ints=(tri_pos.shape[0], mvp.shape[1], vis.shape[1], bufs.cap, int(bool(front_is_cw)), len(group), first,
                  *_pad(group), *_pad(bufs.tile_base[first:first + MAX_MAPS])),
        )
        launches["shadow_setup"] += 1


def launch_scan(bufs: ShadowFrontBuffers, sizes) -> None:
    """S2's scan: every map's offsets, the fill cursors and the totals. No
    host read."""
    from . import cuda_kernels

    L = len(sizes)
    for first, group in _groups(sizes):
        cuda_kernels.call(
            "s2_tile_scan", bufs.counts[:L], bufs.counts[L:], bufs.offsets, bufs.cursor, bufs.totals,
            ints=(L, len(group), first, *_pad(group), *_pad(bufs.tile_base[first:first + MAX_MAPS])),
        )
        launches["shadow_tiles"] += 1


def launch_fill(bufs: ShadowFrontBuffers, sizes, surv, pair_base) -> None:
    """S2's fill: each survivor's row id into its tiles' lists, map m's
    from pair_base[m] of bufs.ids. Needs the scan just before it. No host
    read."""
    from . import cuda_kernels

    L = len(sizes)
    for first, group in _groups(sizes):
        rows = max(surv[first:first + MAX_MAPS])
        cuda_kernels.call(
            "s2_tile_fill", bufs.bbox, bufs.counts[:L], bufs.cursor, bufs.ids,
            ints=(bufs.cap, rows, len(group), first, *_pad(group), *_pad(bufs.tile_base[first:first + MAX_MAPS]),
                  *_pad(pair_base[first:first + MAX_MAPS])),
        )
        launches["shadow_tiles"] += 1


def shadow_front(
    bufs: ShadowFrontBuffers,
    sizes: Sequence[int],
    front_is_cw: bool,
    mvp: torch.Tensor,      # (L, O, 4, 4) f32: map m's light-space MVP per object
    vis: torch.Tensor,      # (L, O) bool: object visible to map m's light
    tri_pos: torch.Tensor,  # (T, 3, 3) f32 corners
    tri_obj: torch.Tensor,  # (T,) int32 object per triangle
) -> List[MapFront]:
    """Every map's caster table and tile lists (maps of sizes[m] texels a
    side, culled FRONT, sub-texel casters dropped) on CUDA tensors: S1, S2's
    scan, one blocking read of the totals, S2's fill. Raises on CPU
    tensors (their path is the chain, or shadow_front_plain)."""
    dev = _check(sizes, mvp, vis, tri_pos, tri_obj)
    if dev.type != "cuda":
        raise ValueError(f"shadow_front launches CUDA kernels; got tensors on {dev}")
    L = len(sizes)
    bufs.fit(tri_pos.shape[0], sizes, dev)
    with profiling_scope("kernel::S1"):
        launch_setup(bufs, sizes, front_is_cw, mvp, vis, tri_pos, tri_obj)
    with profiling_scope("kernel::S2"):
        launch_scan(bufs, sizes)
    with profiling_scope("sync::shadow_front.totals"):
        totals = bufs.totals.tolist()
    surv, pairs = totals[:L], totals[L:]
    if max(surv, default=0) > bufs.cap:
        raise RuntimeError(f"shadow front: {surv} survivors outran the table's {bufs.cap} rows")
    pair_base = [sum(pairs[:m]) for m in range(L)]
    bufs.fit_ids(sum(pairs), dev)
    with profiling_scope("kernel::S2"):
        launch_fill(bufs, sizes, surv, pair_base)
    out = []
    for m, size in enumerate(sizes):
        V, b = surv[m], bufs.tile_base[m] + m
        tris = TriSetup(setup=bufs.setup[m, :V], bbox=bufs.bbox[m, :V], src=bufs.src[m, :V], flip=bufs.flip[m, :V])
        binned = BinnedTris(offsets=bufs.offsets[b:b + _n_tiles(size) + 1],
                            ids=bufs.ids[pair_base[m]:pair_base[m] + pairs[m]])
        out.append(MapFront(tris, binned, *_padded(size)))
    return out


# -- the plain version ---------------------------------------------------------


def _clip_plane(v: torch.Tensor, n: torch.Tensor, d: torch.Tensor):
    """One Sutherland-Hodgman step (S1's clip_plane) for polygons of n <= 4
    corners in 5 slots: keep corners with d >= 0, add the crossing points
    fma(vj - vi, t, vi)."""
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


def _candidates(mvp_m, vis_m, tri_pos, tri_obj):
    """(T * SLOTS, 3, 4) candidate triangles in clip space and which exist,
    in slot order."""
    T = tri_pos.shape[0]
    O, Ov = mvp_m.shape[0], vis_m.shape[0]
    obj = tri_obj.long()
    valid = (obj >= 0) & (obj < Ov) & (obj < O) & vis_m[obj.clamp(0, Ov - 1)]
    m = mvp_m[obj.clamp(0, O - 1)]                      # (T, 4, 4)
    p = tri_pos
    c = dot3(*(t for k in range(3) for t in (m[:, None, :, k], p[:, :, None, k]))) + m[:, None, :, 3]
    w = c[..., 3]
    inside = ((w - c[..., 2]) >= 0.0) & (w > W_EPS)
    all_in = inside.all(dim=-1)
    crossing = valid & inside.any(dim=-1) & ~all_in
    tri = torch.zeros(T, SLOTS, 3, 4, dtype=torch.float32, device=c.device)
    cand = torch.zeros(T, SLOTS, dtype=torch.bool, device=c.device)
    tri[:, 0] = c
    cand[:, 0] = valid & all_in
    g = torch.nonzero(crossing).flatten()
    if g.numel():
        v = torch.cat([c[g], torch.zeros(g.numel(), 2, 4, dtype=c.dtype, device=c.device)], dim=1)
        n = torch.full((g.numel(),), 3, dtype=torch.long, device=c.device)
        v, n = _clip_plane(v, n, v[..., 3] - W_EPS)
        v, n = _clip_plane(v, n, v[..., 3] - v[..., 2])
        for k in range(3):
            tri[g, 1 + k] = torch.stack([v[:, 0], v[:, k + 1], v[:, k + 2]], dim=1)
            cand[g, 1 + k] = n >= k + 3
    return tri.reshape(T * SLOTS, 3, 4), cand.reshape(T * SLOTS)


def _setup_plain(tri, ids, size: int, front_is_cw: bool) -> TriSetup:
    """S1's cull and setup rows (cull_and_setup's FRONT, sub-pixel,
    contracted arithmetic) for the candidate rows `ids` of `tri`; the
    survivors in ascending id."""
    c = tri[ids]
    w = c[..., 3]
    inv_w = 1.0 / torch.where(w == 0.0, torch.ones_like(w), w)
    x = (c[..., 0] * inv_w * 0.5 + 0.5) * size
    yp = 0.5 - c[..., 1] * inv_w * 0.5
    y = yp * size
    z = c[..., 2] * inv_w
    area2 = ab_minus_cd(x[:, 1] - x[:, 0], y[:, 2] - y[:, 0], x[:, 2] - x[:, 0], y[:, 1] - y[:, 0])
    is_front = (area2 > 0.0) if front_is_cw else (area2 < 0.0)
    xmin, xmax = x.amin(dim=1), x.amax(dim=1)
    ymin, ymax = y.amin(dim=1), y.amax(dim=1)
    keep = (area2 != 0.0) & (w > 0.0).all(dim=-1) & ~is_front
    keep = keep & (xmax > 0.0) & (xmin < size) & (ymax > 0.0) & (ymin < size)
    keep = keep & (torch.floor(xmin - 0.5) + 1.5 <= xmax) & (torch.floor(ymin - 0.5) + 1.5 <= ymax)
    k = torch.nonzero(keep).flatten()
    x, yp, y, z, area2, ids = x[k], yp[k], y[k], z[k], area2[k], ids[k]
    flip = area2 < 0.0
    # Corners 1 and 2 swapped where flip (orientation fix).
    xo, yo, zo, ypo = (torch.where(flip[:, None], torch.stack([a[:, 0], a[:, 2], a[:, 1]], dim=1), a)
                       for a in (x, y, z, yp))
    xn, yn = xo.roll(-1, dims=1), yo.roll(-1, dims=1)
    dy, dx = yn - yo, xn - xo
    ea = -dy
    ea_row = fma32(ypo, torch.full_like(ypo, float(size)), -yn)
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
    setup = torch.stack(
        [*ea_row.unbind(1), *dx.unbind(1), *ec_canon.unbind(1), za, zb, zc,
         tl[:, 0], ids.to(torch.float32), tl[:, 1], tl[:, 2]],
        dim=1,
    )
    bbox = torch.stack([xmin[k], ymin[k], xmax[k], ymax[k]], dim=1)
    return TriSetup(setup=setup.contiguous(), bbox=bbox.contiguous(), src=ids, flip=flip)


def _tile_lists_plain(bbox: torch.Tensor, size: int) -> BinnedTris:
    """S2's lists: every survivor in each DTILE_H x DTILE_W tile of the
    padded map its bbox meets (bin_triangles' float test), ascending."""
    wp, hp = _padded(size)
    nc, nr = wp // DTILE_W, hp // DTILE_H
    dev = bbox.device
    tx0 = (torch.arange(nc, device=dev) * DTILE_W).to(torch.float32)
    ty0 = (torch.arange(nr, device=dev) * DTILE_H).to(torch.float32)
    xmin, ymin, xmax, ymax = (a[:, None] for a in bbox.unbind(dim=1))
    cols = (xmax > tx0) & (xmin < tx0 + DTILE_W)   # (V, nc)
    rows = (ymax > ty0) & (ymin < ty0 + DTILE_H)   # (V, nr)
    hit = (rows[:, :, None] & cols[:, None, :]).reshape(bbox.shape[0], nr * nc)
    _tile, tri = torch.nonzero(hit.T, as_tuple=True)
    offsets = torch.zeros(nr * nc + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(hit.sum(dim=0), 0)
    return BinnedTris(offsets=offsets.to(torch.int32), ids=tri.to(torch.int32))


def shadow_front_plain(sizes, front_is_cw, mvp, vis, tri_pos, tri_obj) -> List[MapFront]:
    """Plain version of shadow_front (S1 and S2's algorithm in PyTorch, any
    device): each map's survivors in ascending slot id 4 t + s (S_ID and
    src), each tile's list ascending."""
    _check(sizes, mvp, vis, tri_pos, tri_obj)
    out = []
    for m, size in enumerate(sizes):
        tri, cand = _candidates(mvp[m], vis[m], tri_pos, tri_obj)
        tris = _setup_plain(tri, torch.nonzero(cand).flatten(), int(size), bool(front_is_cw))
        out.append(MapFront(tris, _tile_lists_plain(tris.bbox, int(size)), *_padded(int(size))))
    return out
