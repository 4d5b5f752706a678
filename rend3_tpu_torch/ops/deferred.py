"""Per-triangle attribute planes, and the raster kernels K1 and K2.

Port of rend3_tpu/ops/deferred.py. Every surviving triangle gets
screen-space interpolation planes for each vertex attribute (attr/w and 1/w
are linear in screen space); the fused raster + resolve kernel (K1) walks
each 32x128 tile's triangle list, keeps the nearest triangle per pixel and
evaluates the winner's planes into the 25-channel G-buffer. K2 is the same
walk keeping only the depth (shadow maps). K1's peel modes serve the cutout
and blend depth peels: `bound` keeps only fragments strictly in front of a
per-pixel bound, and `count_floor` also counts, per pixel, the covered
fragments above a floor (the exact layer count of a peel loop).

The TPU kernels' chunk packing, band masks, 1D step queue and phase-B
one-hot matmul are gone: the CUDA kernels (csrc/raster.cu) read the CSR tile
lists directly and gather the winner's plane row. Each wrapper runs the
kernel for CUDA tensors and the plain PyTorch version, in this module, for
CPU tensors.

Arithmetic contract shared by the kernels and their plain versions: an edge,
depth or attribute plane a*px + b*py + c is evaluated as fma(a, px, b*py) + c.
That is what the JAX kernels compute under XLA:CPU (the reference the parity
tests run), where LLVM contracts the first product into an fma. The form is
symmetric under negation, so the watertight shared-edge scheme
(geometry.py:226-239) still holds. The plain versions take the fma from
`fma32` (ops/fp.py, re-exported here): the correctly rounded fma, the F1
kernel on CUDA tensors and its float64 emulation on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .fp import ab_minus_cd, dot3, fma32, sqrt32
from .geometry import S_EA, S_EB, S_EC, S_TL, S_TL1, S_TL2, S_ZA, S_ZB, S_ZC, BinnedTris, TriSetup

__all__ = [
    "DTILE_H",
    "DTILE_W",
    "PLANES_W",
    "GB_CH",
    "GBuffer",
    "attribute_planes",
    "raster_resolve",
    "raster_depth",
    "fma32",
    "sqrt32",
]

DTILE_H = 32
DTILE_W = 128

# Plane-table lanes (PLANES_W per surviving triangle), as deferred.py:52-62.
PLANES_W = 64
P_DEN = 0    # 3: 1/w plane
P_VP = 3     # 9: view-space position (3 ch x 3 coefs)
P_NRM = 12   # 9
P_TAN = 21   # 9
P_UV0 = 30   # 6
P_UV1 = 36   # 6
P_COL = 42   # 12
P_MAT = 54   # 1: material slot as float value

# G-buffer channels, as deferred.py:64-84.
GB_CH = 25
G_DEPTH = 0
G_DEN = 1
G_VP = 2     # 3
G_NRM = 5    # 3
G_TAN = 8    # 3
G_UV0 = 11   # 2
G_UV1 = 13   # 2
G_COL = 15   # 4
G_MAT = 19
G_HIT = 20
G_DUV = 21   # 4: du/dx, dv/dx, du/dy, dv/dy (analytic, post-divide)

# Launch counts of the CUDA kernels (plain-version runs do not count). K1
# counts its modes apart: plain (opaque and residual G-buffers) at the pixel
# centre, plain at another sample offset (MSAA), with a count floor (peel 0
# of a peel loop), with a bound only (later peels); a launch for a row band
# that does not start at the target's row 0 counts as "raster_band", in any
# mode.
launches = {
    "raster_resolve": 0, "raster_msaa": 0, "raster_count": 0, "raster_bound": 0, "raster_band": 0, "raster_depth": 0,
}


class GBuffer(NamedTuple):
    """Raw (numerator-space) G-buffer: (CH, H, W) float32."""

    data: torch.Tensor


def plane_eval(a, b, c, px, py):
    """fma(a, px, b*py) + c in float32 (the kernels' plane evaluation)."""
    return fma32(a, px, b * py) + c


def attribute_planes(
    tris: TriSetup,
    ctri_clip: torch.Tensor,    # (Tc, 3, 4)
    ctri_bary: torch.Tensor,    # (Tc, 3, 3)
    ctri_orig: torch.Tensor,    # (Tc,)
    tri_vlocal: torch.Tensor,
    tri_obj: torch.Tensor,
    bases: torch.Tensor,
    geo,
    model_view: torch.Tensor,   # (O, 4, 4)
    obj_material: torch.Tensor,
    width: int,
    height: int,
    *,
    contract: bool = False,
) -> torch.Tensor:
    """The (V, PLANES_W) plane table for the surviving triangles (the
    vertex-stage math of opaque.wgsl vs_main), as deferred.py:101-220.
    Sums over the three corners are written out left to right.

    contract: the form XLA:CPU gives the JAX function inside a jitted
    program (the frame's form, read off its fusions): each three-term sum
    of products as fp.dot3; the edge constant c as fma(a, b, -(c*d)); in
    the a and b coefficients and the area, the product x = xp*width (or y)
    of a corner used once fused into the difference that reads it. The
    default is the eager JAX form."""
    from .geometry import _opp, _swap12

    V = tris.count
    src = tris.src
    c = _swap12(ctri_clip[src], tris.flip)       # (V, 3, 4)
    b = _swap12(ctri_bary[src], tris.flip)       # (V, 3, 3)
    o = ctri_orig[src]

    w = c[..., 3]
    inv_w = 1.0 / torch.where(w == 0.0, torch.ones_like(w), w)   # (V, 3)
    xp = c[..., 0] * inv_w * 0.5 + 0.5
    yp = 0.5 - c[..., 1] * inv_w * 0.5
    x = xp * width
    y = yp * height

    xn = torch.roll(x, -1, dims=1)
    yn = torch.roll(y, -1, dims=1)
    if contract:
        wt = torch.tensor(float(width), device=c.device)
        ht = torch.tensor(float(height), device=c.device)
        ea = fma32(yp, ht, -yn)
        eb = fma32(-xp, wt, xn)
        ec = ab_minus_cd(yn - y, x, xn - x, y)
        area = ab_minus_cd(
            fma32(xp[:, 1], wt, -x[:, 0]), fma32(yp[:, 2], ht, -y[:, 0]),
            fma32(xp[:, 2], wt, -x[:, 0]), fma32(yp[:, 1], ht, -y[:, 0]),
        )
    else:
        ea = -(yn - y)
        eb = xn - x
        ec = (yn - y) * x - (xn - x) * y
        area = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0])
    inv_area = 1.0 / torch.where(area == 0.0, torch.ones_like(area), area)
    oa = _opp(ea) * inv_area[:, None]
    ob = _opp(eb) * inv_area[:, None]
    oc = _opp(ec) * inv_area[:, None]

    obj = tri_obj[o].clamp_min(0).long()
    vloc = tri_vlocal[o].long()                  # (V, 3)
    bs = bases[obj].long()                       # (V, n_attrs)

    def sum3(t, dim):
        return t.select(dim, 0) + t.select(dim, 1) + t.select(dim, 2)

    def dot(a, b, dim):
        """sum over dim of a * b (broadcast), in the chosen form."""
        a, b = torch.broadcast_tensors(a, b)
        if contract:
            return dot3(a.select(dim, 0), b.select(dim, 0), a.select(dim, 1), b.select(dim, 1),
                        a.select(dim, 2), b.select(dim, 2))
        return sum3(a * b, dim)

    def corner_vals(arena, ai, default):
        """(V, 3src, C) source-corner values of one attribute arena."""
        base = bs[:, ai]
        ids = (vloc + base[:, None]).clamp(0, arena.shape[0] - 1)
        vals = arena[ids]
        dflt = torch.tensor(default, dtype=torch.float32, device=vals.device)
        return torch.where((base >= 0)[:, None, None], vals, dflt)

    # Every attribute at once, side by side along the channel axis: each
    # sum below is per channel, so batching them changes no value.
    vals = torch.cat([
        corner_vals(geo.position, 0, [0.0, 0.0, 0.0]), corner_vals(geo.normal, 1, [0.0, 0.0, 0.0]),
        corner_vals(geo.tangent, 2, [0.0, 0.0, 0.0]), corner_vals(geo.uv0, 3, [0.0, 0.0]),
        corner_vals(geo.uv1, 4, [0.0, 0.0]), corner_vals(geo.color0, 5, [1.0, 1.0, 1.0, 1.0]),
    ], dim=2)
    # per-CLIPPED-corner values: sum_k b[v,j,k] * vals[v,k,c]
    pos_c, nrm_m, tan_m, uv0_c, uv1_c, col_c = dot(b[:, :, :, None], vals[:, None, :, :], 2).split(
        [3, 3, 3, 2, 2, 4], dim=2
    )

    mv = model_view[obj]
    mv3 = mv[:, :3, :3]
    inv_scale_sq = 1.0 / torch.clamp_min(dot(mv3, mv3, 1), 1e-30)[:, None, :]   # (V, 1, 3)
    # sum_b mv3[v,a,b] * t[v,j,b] of position, normal and tangent -> (V, 9, a)
    vecs = torch.cat([pos_c, nrm_m * inv_scale_sq, tan_m * inv_scale_sq], dim=1)
    vecs = dot(mv3[:, None, :, :], vecs[:, :, None, :], 3)
    vp_c = vecs[:, 0:3] + mv[:, None, :3, 3]
    dirs = vecs[:, 3:9]
    n = sqrt32(dot(dirs, dirs, 2))[..., None]
    dirs = dirs / torch.where(n == 0.0, torch.ones_like(n), n)

    # Plane coefficients (a, b, c) of sum_j (A_j / w_j) lam_j for 1/w and
    # every attribute channel: (V, 18, 3).
    allv = torch.cat([torch.ones_like(inv_w)[..., None], vp_c, dirs[:, 0:3], dirs[:, 3:6], uv0_c, uv1_c, col_c], 2)
    aw = allv * inv_w[:, :, None]
    opp = torch.stack([oa, ob, oc], dim=-1)   # (V, 3, 3)
    pl = dot(aw[:, :, :, None], opp[:, :, None, :], 1)
    planes = torch.zeros(V, PLANES_W, dtype=torch.float32, device=c.device)
    planes[:, P_DEN : P_DEN + 3] = pl[:, 0]
    planes[:, P_VP : P_COL + 12] = pl[:, 1:].reshape(V, P_COL + 12 - P_VP)
    planes[:, P_MAT] = obj_material[obj].float()
    return planes


# ---------------------------------------------------------------------------
# Plain versions of K1 and K2
# ---------------------------------------------------------------------------

# Fragments evaluated per batch by the plain versions (bounds their memory).
_PLAIN_BATCH = 1 << 22


def _fragments(
    tris: TriSetup, binned: BinnedTris, width: int, sofs, tile_h: int = DTILE_H, tile_w: int = DTILE_W, row0: int = 0,
):
    """Yield (tri ids, pixel index, px, py) for every pixel the kernels
    test a binned triangle against and that could be covered: the pixels
    of the triangle's tiles (tile_h x tile_w) inside its bbox grown by one
    pixel (rounding can put a covered sample a hair outside the float bbox,
    never a whole pixel). row0: the target row of the output's row 0 (a row
    band's first row); rows are row0 + local as integers before the float
    conversion, pixel indices local."""
    dev = tris.setup.device
    n_cols = width // tile_w
    offs = binned.offsets.long()
    counts = offs[1:] - offs[:-1]
    tile = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev), counts)
    tri = binned.ids.long()
    if tri.numel() == 0:
        return
    bb = tris.bbox[tri]
    tx0 = (tile % n_cols) * tile_w
    ty0 = (tile // n_cols) * tile_h + row0
    x0 = torch.maximum(torch.floor(bb[:, 0]).clamp(-2, 1 << 20).long() - 1, tx0)
    x1 = torch.minimum(torch.ceil(bb[:, 2]).clamp(-2, 1 << 20).long() + 1, tx0 + tile_w)
    y0 = torch.maximum(torch.floor(bb[:, 1]).clamp(-2, 1 << 20).long() - 1, ty0)
    y1 = torch.minimum(torch.ceil(bb[:, 3]).clamp(-2, 1 << 20).long() + 1, ty0 + tile_h)
    nx = (x1 - x0).clamp_min(0)
    ny = (y1 - y0).clamp_min(0)
    npx = nx * ny
    # Batches of whole pairs, each about _PLAIN_BATCH fragments (a pair
    # holds at most one tile's fragments).
    csum = torch.cumsum(npx, 0)
    total = int(csum[-1])  # host read: fragment count
    marks = torch.tensor(list(range(_PLAIN_BATCH, total, _PLAIN_BATCH)), dtype=csum.dtype, device=dev)
    cuts = [0] + sorted(set(torch.searchsorted(csum, marks).tolist())) + [tri.shape[0]]
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        if hi <= lo:
            continue
        n = npx[lo:hi]
        rep = lambda t: torch.repeat_interleave(t, n)
        local = torch.arange(int(n.sum()), device=dev) - rep(torch.cumsum(n, 0) - n)
        nxr = rep(nx[lo:hi])
        xs = rep(x0[lo:hi]) + local % nxr
        ys = rep(y0[lo:hi]) + local // nxr
        px = xs.float() + float(sofs[0])
        py = ys.float() + float(sofs[1])
        yield rep(tri[lo:hi]), (ys - row0) * width + xs, px, py


def _coverage(s: torch.Tensor, px, py):
    """Top-left edge tests and the depth plane (deferred.py:601-610);
    returns (covered, z)."""
    cov = None
    for k, tlk in ((0, S_TL), (1, S_TL1), (2, S_TL2)):
        e = plane_eval(s[:, S_EA + k], s[:, S_EB + k], s[:, S_EC + k], px, py)
        ck = (e > 0.0) | ((e == 0.0) & (s[:, tlk] > 0.0))
        cov = ck if cov is None else cov & ck
    z = plane_eval(s[:, S_ZA], s[:, S_ZB], s[:, S_ZC], px, py)
    return cov & (z >= 0.0) & (z <= 1.0), z


def raster_depth_plain(tris: TriSetup, binned: BinnedTris, width: int, height: int, sofs=(0.5, 0.5), y0: int = 0):
    """Plain version of K2: per pixel the greatest reverse-Z depth over the
    covering triangles of its tile list, 0 where none covers; y0 as in
    raster_depth."""
    depth = torch.zeros(height * width, dtype=torch.float32, device=tris.setup.device)
    for tri, pix, px, py in _fragments(tris, binned, width, sofs, row0=y0):
        cov, z = _coverage(tris.setup[tri], px, py)
        depth.scatter_reduce_(0, pix[cov], z[cov], reduce="amax")
    return depth.reshape(height, width)


def _winners_plain(
    tris: TriSetup, binned: BinnedTris, width: int, height: int, sofs,
    bound=None, count_floor=None, count_strict=False, tile_h: int = DTILE_H, tile_w: int = DTILE_W, y0: int = 0,
):
    """Per pixel the winning setup row (-1 = none): greatest depth, and on
    equal depth the later list entry, i.e. the higher row id. Packs
    (depth bits, row) into one int64 key and takes the max. With `bound`
    (H, W) a fragment also needs z < bound (deferred.py:617-618). With
    `count_floor` (H, W), counts per pixel every covered fragment at
    z >= floor (z > floor when count_strict), before the bound and whatever
    the depth test decides (deferred.py:611-616). y0: _fragments' row0.
    Returns (win, depth, counts or None)."""
    dev = tris.setup.device
    key = torch.full((height * width,), -1, dtype=torch.int64, device=dev)
    bnd = None if bound is None else bound.reshape(-1)
    flr = None if count_floor is None else count_floor.reshape(-1)
    counts = None if flr is None else torch.zeros(height * width, dtype=torch.int64, device=dev)
    for tri, pix, px, py in _fragments(tris, binned, width, sofs, tile_h, tile_w, y0):
        cov, z = _coverage(tris.setup[tri], px, py)
        if flr is not None:
            above = (z > flr[pix]) if count_strict else (z >= flr[pix])
            hits = pix[cov & above]
            counts.index_add_(0, hits, torch.ones_like(hits))
        if bnd is not None:
            cov = cov & (z < bnd[pix])
        zbits = (z[cov] + 0.0).view(torch.int32).long()   # z >= 0: bits are monotone
        key.scatter_reduce_(0, pix[cov], (zbits << 32) | tri[cov], reduce="amax")
    win = torch.where(key >= 0, key & 0xFFFFFFFF, torch.full_like(key, -1))
    zb = torch.where(key >= 0, key >> 32, torch.zeros_like(key)).to(torch.int32)
    if counts is not None:
        counts = counts.float().reshape(height, width)
    return win, zb.view(torch.float32), counts


def resolve_channels(planes_w: torch.Tensor, depth, px, py) -> torch.Tensor:
    """The finalize of deferred.py:676-711: the winners' plane rows
    (N, PLANES_W) evaluated at (px, py) into (GB_CH, N) channels."""

    def plane(off):
        return plane_eval(planes_w[:, off], planes_w[:, off + 1], planes_w[:, off + 2], px, py)

    chans = [depth, plane(P_DEN)]
    chans += [plane(P_VP + 3 * k) for k in range(3)]
    chans += [plane(P_NRM + 3 * k) for k in range(3)]
    chans += [plane(P_TAN + 3 * k) for k in range(3)]
    chans += [plane(P_UV0 + 3 * k) for k in range(2)]
    chans += [plane(P_UV1 + 3 * k) for k in range(2)]
    chans += [plane(P_COL + 3 * k) for k in range(4)]
    chans.append(planes_w[:, P_MAT])
    chans.append(torch.ones_like(depth))
    # Analytic uv screen derivatives (quotient rule): du/dx = (a_u - u a_d)/Dn.
    dn = plane(P_DEN)
    invd = torch.where(dn.abs() < 1e-30, torch.ones_like(dn), 1.0 / dn)
    for coef in (P_DEN, P_DEN + 1):   # d/dx uses the a coefficients, d/dy the b
        for k in range(2):
            off = P_UV0 + 3 * k
            uvv = plane(off) * invd
            a = planes_w[:, off + (coef - P_DEN)]
            chans.append(fma32(-uvv, planes_w[:, coef], a) * invd)
    return torch.stack(chans)


def raster_resolve_plain(
    tris, planes, binned, width, height, sofs=(0.5, 0.5), bound=None, count_floor=None, count_strict=False, y0=0,
):
    """Plain version of K1: the (GB_CH, H, W) G-buffer, and with
    `count_floor` also the (H, W) f32 counts: (gbuf, counts); y0 as in
    raster_resolve."""
    win, depth, counts = _winners_plain(
        tris, binned, width, height, sofs, bound, count_floor, count_strict, y0=y0
    )
    out = torch.zeros(GB_CH, height * width, dtype=torch.float32, device=planes.device)
    pix = torch.nonzero(win >= 0).flatten()
    px = (pix % width).float() + float(sofs[0])
    py = (pix // width + y0).float() + float(sofs[1])
    out[:, pix] = resolve_channels(planes[win[pix]], depth[pix], px, py)
    out = out.reshape(GB_CH, height, width)
    return out if counts is None else (out, counts)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(tris: TriSetup, binned: BinnedTris, width: int, height: int, planes=None,
           tile_h: int = DTILE_H, tile_w: int = DTILE_W):
    dev = tris.setup.device
    if width % tile_w or height % tile_h:
        raise ValueError(f"target {width}x{height} is not a multiple of the {tile_w}x{tile_h} tile")
    n_tiles = (width // tile_w) * (height // tile_h)
    if binned.offsets.shape != (n_tiles + 1,):
        raise ValueError(f"offsets {tuple(binned.offsets.shape)} != ({n_tiles + 1},)")
    tensors = [tris.setup, tris.bbox, binned.offsets, binned.ids]
    if planes is not None:
        tensors.append(planes)
        if planes.shape != (tris.count, PLANES_W) or planes.dtype != torch.float32:
            raise ValueError(f"planes {tuple(planes.shape)} {planes.dtype}")
    if tris.setup.dtype != torch.float32 or tris.setup.shape[1:] != (16,):
        raise ValueError(f"setup {tuple(tris.setup.shape)} {tris.setup.dtype}")
    if binned.offsets.dtype != torch.int32 or binned.ids.dtype != torch.int32:
        raise ValueError("tile lists must be int32")
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("raster inputs must be contiguous and on one device")
    if tris.bbox.shape[1:] != (4,) or tris.bbox.dtype != torch.float32 or tris.bbox.data_ptr() % 16:
        raise ValueError("bbox must be (V, 4) f32 rows aligned to 16 bytes")
    if tris.setup.data_ptr() % 16:
        raise ValueError("setup rows must be aligned to 16 bytes (the kernels copy them 16 bytes at a time)")
    return dev


def raster_resolve(
    tris: TriSetup,
    planes: torch.Tensor,
    binned: BinnedTris,
    width: int,
    height: int,
    *,
    sofs: Tuple[float, float] = (0.5, 0.5),
    bound: Optional[torch.Tensor] = None,
    count_floor: Optional[torch.Tensor] = None,
    count_strict: bool = False,
    y0: int = 0,
):
    """K1, the fused raster + G-buffer resolve over CSR tile lists (the
    counterpart of deferred.raster_resolve_packed): the (GB_CH, H, W)
    numerator-space G-buffer.

    bound: optional (H, W) f32 exclusive reverse-Z upper bound (depth
    peels: a fragment needs z < bound). count_floor: optional (H, W) f32
    floor; the kernel then also counts, per pixel, every covered fragment at
    z >= floor (z > floor with count_strict), before the bound, and the
    call returns (GBuffer, counts (H, W) f32). JAX returns (GBuffer,
    overflow, counts); the port has no overflow, so counts come second.
    y0: the target row of the output's row 0, a row band's first row
    (parallel/tiles.py): tile rows start there, and pixel rows are y0 +
    local, added as integers before the float conversion
    (deferred.py:573), so a band equals the same rows of the whole frame
    bit for bit; the setup table and its bboxes are in target coordinates,
    `bound`, `count_floor` and the outputs are the band's (H, W).
    CUDA tensors launch the kernel in csrc/raster.cu; CPU tensors run
    raster_resolve_plain."""
    dev = _check(tris, binned, width, height, planes)
    for name, img in (("bound", bound), ("count_floor", count_floor)):
        if img is not None and (
            img.shape != (height, width) or img.dtype != torch.float32 or img.device != dev
            or not img.is_contiguous()
        ):
            raise ValueError(f"{name} must be a contiguous ({height}, {width}) f32 image on {dev}")
    if dev.type == "cpu":
        out = raster_resolve_plain(tris, planes, binned, width, height, sofs, bound, count_floor, count_strict, y0)
        return (GBuffer(out[0]), out[1]) if count_floor is not None else GBuffer(out)
    from . import cuda_kernels

    out = torch.empty(GB_CH, height, width, dtype=torch.float32, device=dev)
    counts = None if count_floor is None else torch.empty(height, width, dtype=torch.float32, device=dev)
    cuda_kernels.call(
        "k1_raster_resolve",
        tris.setup, tris.bbox, planes, binned.offsets, binned.ids, out, bound, count_floor, counts,
        ints=(width, height, int(count_strict), y0), floats=sofs,
    )
    if y0 != 0:
        launches["raster_band"] += 1
    elif counts is not None:
        launches["raster_count"] += 1
    elif bound is not None:
        launches["raster_bound"] += 1
    else:
        launches["raster_resolve" if tuple(sofs) == (0.5, 0.5) else "raster_msaa"] += 1
    return (GBuffer(out), counts) if counts is not None else GBuffer(out)


def raster_depth(
    tris: TriSetup,
    binned: BinnedTris,
    width: int,
    height: int,
    *,
    sofs: Tuple[float, float] = (0.5, 0.5),
    y0: int = 0,
) -> torch.Tensor:
    """K2, the depth-only raster (the counterpart of deferred._depth_launch):
    (H, W) f32, 0 where no triangle covers; y0 as in raster_resolve (the
    shadow maps take 0). CUDA tensors launch the kernel in csrc/raster.cu;
    CPU tensors run raster_depth_plain."""
    dev = _check(tris, binned, width, height)
    if dev.type == "cpu":
        return raster_depth_plain(tris, binned, width, height, sofs, y0)
    from . import cuda_kernels

    out = torch.empty(height, width, dtype=torch.float32, device=dev)
    # The kernel's segment plan: a count, then (tile, first entry) for each
    # of at most n_tiles + P / 128 segments of 128 list entries.
    n_entries = binned.ids.numel()
    plan = torch.empty(1 + 2 * (binned.offsets.numel() - 1 + n_entries // 128), dtype=torch.int32, device=dev)
    cuda_kernels.call(
        "k2_raster_depth",
        tris.setup, tris.bbox, binned.offsets, binned.ids, out, plan,
        ints=(width, height, n_entries, y0), floats=sofs,
    )
    launches["raster_depth"] += 1
    return out
