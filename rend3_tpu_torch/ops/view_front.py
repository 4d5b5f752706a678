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
algorithm in PyTorch on any device (built from ops/front_end.py's pieces),
the reference the card is held to; on CPU tensors `clip`, `cull`, `planes`
and `tiles` return their results.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..utils import profiling
from ..utils.profiling import scope as profiling_scope
from . import front_end
from .deferred import DTILE_H, DTILE_W, PLANES_W, attribute_planes
from .geometry import SETUP_W, BinnedTris, TriSetup
from .transform import ClippedTris

__all__ = ["Culled", "clip", "cull", "planes", "tiles", "clip_plain", "cull_plain", "planes_plain",
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


class Culled(NamedTuple):
    """A cull's survivors and what its tile lists need: the grid and its
    first row; on the card also the keep flags, the (block, tile) table,
    block bases and totals V2 left in `ints`, the CSR offsets, the pair
    total and `launch`, V2's launch arguments (for launch_cull /
    launch_setup), which are None on the CPU."""

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
    clip_triangles, contract=True; tri_valid = visible[tri_obj]): on CUDA
    tensors V1's count, one host read of the crossing triangles, V1's
    fill; on CPU tensors clip_plain. positions (Np, 3) f32, tri_vlocal (T,
    3) / tri_obj (T,) int32, bases (O, 6) int32 (column 0 the position
    base), mvp (O, 4, 4) f32, visible (Ov,) bool."""
    inputs = (positions, tri_vlocal, tri_obj, bases, mvp, visible)
    _check_clip(*inputs)
    dev = positions.device
    if dev.type == "cpu":
        return clip_plain(*inputs)
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
    """geometry.cull_and_setup(contract=True) of the clipped rows, with the
    counts bin_triangles(wp, hp, DTILE_H, DTILE_W, y0) needs: on CUDA
    tensors V2's cull and scan, one host read of the survivor and pair
    totals, V2's setup (counter view_front.tables); on CPU tensors
    cull_plain. clip_rows (Tc, 3, 4) f32, valid (Tc,) bool; hiz a
    hi_z.build_pyramid list or None; y_range a row band's (y0, y1) or
    None."""
    Tc = clip_rows.shape[0]
    _need("clip", clip_rows, torch.float32, (3, 4))
    _need("valid", valid, torch.bool, (), Tc)
    dev = clip_rows.device
    n_cols, n_rows = _grid(wp, hp)
    if dev.type == "cpu":
        tris = cull_plain(clip_rows, valid, width, height, cull_mode=cull_mode, front_is_cw=front_is_cw,
                          subpixel=subpixel, hiz=hiz, y_range=y_range)
        return Culled(tris, None, None, None, 0, n_cols, n_rows, y0, None)
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
    profiling.count("view_front.tables")
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
    (deferred.attribute_planes(contract=True)): V3 on CUDA tensors,
    planes_plain on CPU tensors."""
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
    if tris.setup.device.type == "cpu":
        return planes_plain(tris, table, tri_vlocal, tri_obj, bases, geo, model_view, obj_material, width, height)
    from . import cuda_kernels

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
    DTILE_W from row y0): V4 on CUDA tensors, tiles_plain on CPU tensors."""
    if culled.tris.bbox.device.type == "cpu":
        return tiles_plain(culled.tris, culled.n_cols * DTILE_W, culled.n_rows * DTILE_H, culled.y0)
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
    triangle's corners and classes, then the T source rows and fan k of the
    crossing triangle of rank r (its place among the crossing triangles, a
    prefix sum) at row T + k * n_cross + r."""
    _check_clip(positions, tri_vlocal, tri_obj, bases, mvp, visible)
    T = tri_obj.shape[0]
    dev = positions.device
    obj = tri_obj.long()
    oc = obj.clamp_min(0)
    ids = (tri_vlocal.long() + bases[oc, 0].long()[:, None]).clamp(0, positions.shape[0] - 1)
    c, whole, crossing = front_end.clip_corners(mvp[oc], positions[ids], visible[obj])
    g = torch.nonzero(crossing).flatten()
    n = T + 3 * g.numel()
    out = ClippedTris(clip=torch.zeros(n, 3, 4, device=dev), orig=torch.zeros(n, dtype=torch.int64, device=dev),
                      bary=torch.zeros(n, 3, 3, device=dev), valid=torch.zeros(n, dtype=torch.bool, device=dev))
    out.clip[:T], out.bary[:T] = c, torch.eye(3, dtype=torch.float32, device=dev)
    out.orig[:T] = torch.arange(T, device=dev)
    out.valid[:T] = whole
    if g.numel():
        fan, live = front_end.fans(c[g])
        out.clip[T:], out.bary[T:] = fan[..., :4].reshape(-1, 3, 4), fan[..., 4:].reshape(-1, 3, 3)
        out.orig[T:] = g.repeat(3)
        out.valid[T:] = live.reshape(-1)
    return out


# Plain version of cull (V2's algorithm in PyTorch, any device): each row's
# tests, then the survivors in ascending clipped row (V2 places them by a
# prefix sum over the keep flags) and their setup rows.
cull_plain = front_end.cull_setup


def planes_plain(tris: TriSetup, table: ClippedTris, tri_vlocal, tri_obj, bases, geo, model_view, obj_material,
                 width, height) -> torch.Tensor:
    """Plain version of planes: V3 evaluates attribute_planes(contract=True)
    row by row, so that function is its plain version."""
    return attribute_planes(tris, table.clip, table.bary, table.orig, tri_vlocal, tri_obj, bases, geo, model_view,
                            obj_material, width, height, contract=True)


def tiles_plain(tris: TriSetup, wp: int, hp: int, y0: int = 0) -> BinnedTris:
    """Plain version of tiles (V4's algorithm in PyTorch, any device): each
    survivor's rectangle of tiles, then each tile's survivors ascending."""
    return front_end.tile_lists(tris.bbox, *_grid(wp, hp), y0)
