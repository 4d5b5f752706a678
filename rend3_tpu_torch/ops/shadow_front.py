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

`shadow_front_plain` is S1 and S2's algorithm in PyTorch on any device
(built from ops/front_end.py's pieces), with rows in the fixed slot order
(row 4 t + s before compaction: slot 0 the triangle when it lies wholly
inside the near planes, slot 1 + k the k-th fan of its clipped polygon)
and each tile's list ascending, so it is deterministic; the card's tables
equal it as row multisets. On CPU tensors `shadow_front` returns it.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from ..utils import profiling
from ..utils.profiling import scope as profiling_scope
from . import front_end
from .deferred import DTILE_H, DTILE_W
from .geometry import SETUP_W, BinnedTris, CullMode, TriSetup
from .transform import object_uniforms

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
    side, culled FRONT, sub-texel casters dropped): on CUDA tensors S1,
    S2's scan, one blocking read of the totals, S2's fill (counter
    shadow_front.maps); on CPU tensors shadow_front_plain."""
    dev = _check(sizes, mvp, vis, tri_pos, tri_obj)
    if dev.type == "cpu":
        return shadow_front_plain(sizes, front_is_cw, mvp, vis, tri_pos, tri_obj)
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
    profiling.count("shadow_front.maps", L)
    return out


# -- the plain version ---------------------------------------------------------


def _candidates(mvp_m, vis_m, tri_pos, tri_obj):
    """(T * SLOTS, 3, 4) candidate triangles in clip space and which exist,
    in slot order."""
    T = tri_pos.shape[0]
    O, Ov = mvp_m.shape[0], vis_m.shape[0]
    obj = tri_obj.long()
    valid = (obj >= 0) & (obj < Ov) & (obj < O) & vis_m[obj.clamp(0, Ov - 1)]
    c, whole, crossing = front_end.clip_corners(mvp_m[obj.clamp(0, O - 1)], tri_pos, valid)
    tri = torch.zeros(T, SLOTS, 3, 4, dtype=torch.float32, device=c.device)
    cand = torch.zeros(T, SLOTS, dtype=torch.bool, device=c.device)
    tri[:, 0], cand[:, 0] = c, whole
    g = torch.nonzero(crossing).flatten()
    if g.numel():
        fan, live = front_end.fans(c[g])
        tri[g, 1:], cand[g, 1:] = fan[..., :4].transpose(0, 1), live.T
    return tri.reshape(T * SLOTS, 3, 4), cand.reshape(T * SLOTS)


def shadow_front_plain(sizes, front_is_cw, mvp, vis, tri_pos, tri_obj) -> List[MapFront]:
    """Plain version of shadow_front (S1 and S2's algorithm in PyTorch, any
    device): each map's candidates, FRONT-culled with sub-texel casters
    dropped, the survivors in ascending slot id 4 t + s (S_ID and src),
    each tile's list ascending."""
    _check(sizes, mvp, vis, tri_pos, tri_obj)
    out = []
    for m, size in enumerate(sizes):
        tri, cand = _candidates(mvp[m], vis[m], tri_pos, tri_obj)
        wp, hp = _padded(int(size))
        tris = front_end.cull_setup(tri, cand, int(size), int(size), cull_mode=CullMode.FRONT,
                                    front_is_cw=bool(front_is_cw), subpixel=True)
        out.append(MapFront(tris, front_end.tile_lists(tris.bbox, wp // DTILE_W, hp // DTILE_H, 0), wp, hp))
    return out
