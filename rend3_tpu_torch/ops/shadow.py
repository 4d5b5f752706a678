"""Shadow-map stacking, the per-frame PCF5 resolve, and the map-free
shadow occlusion (K7, K8).

Port of rend3_tpu/ops/shadow.py. stack_shadow_maps and resolve_shadow_pcf5
(shadow.py:669-766): the frame's shadow maps are stacked row-wise with zero
gap rows (so a tap past a map's edge reads 0.0, as in the JAX build) and
every (G-buffer, light) entry resolves through one K3 launch
(samplers.sample_grid_pcf5). shadow_occlusion (K7), shadow_occlusion_lt (K8)
and pcf5_from_occlusion (shadow.py:51-577, 769-792) compute the same
occluder depths straight from the caster triangles, with no map; the frame
does not use them (rend3_tpu_torch.probe_shadow drives them).
sample_shadow_map and sample_shadow_maps (shadow.py:581-666) read the
occluder depth at the 12 PCF texels of every pixel from rasterized maps
through K5 (samplers.sample_grid).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..utils.profiling import scope as profiling_scope
from .deferred import fma32, plane_eval
from .geometry import S_EA, S_EB, S_EC, S_ZA, S_ZB, S_ZC, BinnedTris, TriSetup
from .samplers import sample_grid, sample_grid_pcf5

__all__ = [
    "stack_shadow_maps", "resolve_shadow_pcf5", "PCF_OFFSETS", "N_OFF", "STILE_H", "STILE_W",
    "rect_lists", "cell_lists", "occlusion_from_lists", "shadow_occlusion", "shadow_occlusion_plain",
    "shadow_occlusion_lt", "shadow_occlusion_lt_plain", "occlusion_pairs", "pcf5_from_occlusion",
    "sample_shadow_map", "sample_shadow_maps",
]

# Gap unit: maps are padded to a multiple of GAP rows plus one more GAP of
# zeros, well past the PCF5 halo (two texels), as mxu_gather.LT.
GAP = 64


def _stacked_rows(h: int) -> int:
    return -(-h // GAP) * GAP + GAP


def stack_shadow_maps(smaps: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, List[int]]:
    """Row-stack maps with zero gaps: (stacked (R, maxw) f32, row base per
    map)."""
    maxw = max(int(m.shape[1]) for m in smaps)
    rows = sum(_stacked_rows(int(m.shape[0])) for m in smaps)
    stacked = torch.zeros(rows, maxw, dtype=torch.float32, device=smaps[0].device)
    bases = []
    r = 0
    for m in smaps:
        bases.append(r)
        stacked[r : r + m.shape[0], : m.shape[1]] = m
        r += _stacked_rows(int(m.shape[0]))
    return stacked, bases


def resolve_shadow_pcf5(smaps, entries, stacked=None, capture=None):
    """All PCF5 shadow resolves of a frame in one K3 launch.

    smaps: list of (size, size) maps; entries: list of (map index, sx, sy,
    ref, hit) per (G-buffer, light), each of one shape per entry (a padded
    frame, or compacted pixels). stacked: optional (stacked, bases) from
    stack_shadow_maps, built once with cached maps. capture: optional dict
    that receives the K3 launch's inputs. The entries' queries are
    flattened into one vector, so entries of any shapes share the launch.
    Returns a list of factors shaped like each entry, 1.0 where the pixel
    is invalid."""
    if not entries:
        return []
    stacked, bases = stacked if stacked is not None else stack_shadow_maps(smaps)
    bxs, bys, fxs, fys, refs, oks = [], [], [], [], [], []
    for mi, sx, sy, ref, hit in entries:
        h_m, w_m = smaps[mi].shape
        sx, sy = sx.flatten(), sy.flatten()
        xb = torch.floor(sx - 0.5)
        yb = torch.floor(sy - 0.5)
        bx = xb.to(torch.int32)
        by = yb.to(torch.int32)
        bxs.append(bx)
        bys.append(by + bases[mi])
        fxs.append((sx - 0.5) - xb)
        fys.append((sy - 0.5) - yb)
        refs.append(ref.flatten())
        oks.append(hit.flatten() & (bx >= 0) & (bx < w_m) & (by >= 0) & (by < h_m))

    args = (stacked, *(torch.cat(xs).contiguous() for xs in (bxs, bys, fxs, fys, refs, oks)))
    if capture is not None:
        capture["pcf5"] = args
    ok_all = args[-1]
    pcf_all = sample_grid_pcf5(*args)
    # Invalid pixels read 0 from the sampler; they are lit (1.0).
    pcf_all = torch.where(ok_all, pcf_all, torch.ones_like(pcf_all))
    return [p.reshape(e[1].shape) for p, e in zip(torch.split(pcf_all, [e[1].numel() for e in entries]), entries)]


def _base_texel(s):
    return torch.floor(s - 0.5).to(torch.int32)


def sample_shadow_map(smap, sx, sy, hit):
    """Occluder depth at the 12 PCF texel centres (PCF_OFFSETS) of every
    pixel from a rasterized (size, size) max-depth map, through one K5
    launch: ((12, H, W), need). sx, sy (H, W) are each pixel's light-space
    texel coordinates, hit (H, W) bool; texels no caster touched, taps
    outside the map and pixels not hit read 0.0. JAX's second value is the
    pair count its capped gather needed; K5 has no pair cap, so it is 0."""
    out = sample_grid(
        smap.contiguous(), _base_texel(sx).contiguous(), _base_texel(sy).contiguous(), hit.contiguous(), PCF_OFFSETS,
    )
    return out, 0


def sample_shadow_maps(smaps, entries):
    """All PCF tap gathers of a frame in one K5 launch (shadow.py:608-666):
    the maps stacked row-wise with zero gap rows (stack_shadow_maps), every
    entry's pixels stacked too. entries: (map index, sx, sy, hit) per
    (G-buffer, light), each (H_e, W) with one W. Returns (list of (12, H_e,
    W) occluder depths, overflow); K5 has no pair cap, so overflow is 0."""
    if not entries:
        return [], 0
    stacked, bases = stack_shadow_maps(smaps)
    bxs, bys, oks = [], [], []
    for mi, sx, sy, hit in entries:
        h_m, w_m = smaps[mi].shape
        bx, by = _base_texel(sx), _base_texel(sy)
        # A base texel outside its own map reads nothing; taps past a map's
        # edge read the zero gap.
        oks.append(hit & (bx >= 0) & (bx < w_m) & (by >= 0) & (by < h_m))
        bxs.append(bx)
        bys.append(by + bases[mi])
    occ = sample_grid(stacked, *(torch.cat(t, dim=0).contiguous() for t in (bxs, bys, oks)), PCF_OFFSETS)
    return list(torch.split(occ, [int(e[1].shape[0]) for e in entries], dim=1)), 0


# ---------------------------------------------------------------------------
# Map-free shadow occlusion: K7 (rect lists) and K8 (light-cell lists)
# ---------------------------------------------------------------------------
#
# Port of shadow.py:51-577. For every screen pixel the occluder depth at the
# 12 texel centres that PCF5 with bilinear corners reads, taken straight
# from the caster triangles (set up in light pixel space, as the shadow
# pass rasterizes them) instead of from a map: the max over casters of z
# where all three edge values are strictly positive and z >= 0, else 0.
# pcf5_from_occlusion turns the 12 depths into the PCF5 factor.
#
# Values are defined at hit pixels only. Neither TPU kernel reads `hit`;
# the lists are built from the hit pixels' light-space footprint, so a
# non-hit pixel's value depends on which casters happen to be listed. At a
# hit pixel, any list that holds every caster whose bbox can reach one of
# its taps gives the same max: the taps lie in (sx - 2, sx + 2], and both
# builders pad the footprint by (-2, +3). So the port's uncapped CSR lists
# may differ from JAX's padded, capped ones in membership and order and
# still give JAX's values; everything here is compared at hit pixels.

STILE_H = 32
STILE_W = 128

# The 12 distinct texel centres touched by 5-tap PCF with bilinear corners:
# taps {(0,0),(0,1),(0,-1),(1,0),(-1,0)} x corners {0,1}^2 (shadow.py:57-62).
PCF_OFFSETS = (
    (-1, 0), (-1, 1),
    (0, -1), (0, 0), (0, 1), (0, 2),
    (1, -1), (1, 0), (1, 1), (1, 2),
    (2, 0), (2, 1),
)  # (dx, dy)
N_OFF = len(PCF_OFFSETS)

# Launch counts of the CUDA kernels (plain-version runs do not count).
launches = {"shadow_occ": 0, "shadow_occ_lt": 0}
# List entries a segment of the CUDA kernel's work (csrc/shadow_occ.cu SEG;
# the kernel refuses a plan buffer sized for a larger one).
OCC_SEG = 2048

_BIG = 1e9
# Mask entries per step of the list builders and pairs per batch of the
# plain versions (bound their memory).
_MASK_BATCH = 1 << 24
_PAIR_BATCH = 1 << 22


def _check_screen(tris: TriSetup, sx, sy, hit, width: int, height: int):
    dev = tris.setup.device
    if width % STILE_W or height % STILE_H:
        raise ValueError(f"screen {width}x{height} is not a multiple of the {STILE_W}x{STILE_H} tile")
    for name, t, dt in (("sx", sx, torch.float32), ("sy", sy, torch.float32), ("hit", hit, torch.bool)):
        if t.shape != (height, width) or t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({height}, {width}) {dt} image on {dev}")
    if tris.setup.dtype != torch.float32 or tris.setup.shape[1:] != (16,) or not tris.setup.is_contiguous():
        raise ValueError(f"setup {tuple(tris.setup.shape)} {tris.setup.dtype}")
    if tris.bbox.shape[1:] != (4,) or tris.bbox.dtype != torch.float32 or tris.bbox.data_ptr() % 16:
        raise ValueError("bbox must be (V, 4) f32 rows aligned to 16 bytes")
    return dev


def _tile_rects(sx, sy, hit, height: int, width: int) -> torch.Tensor:
    """Per-32x128-tile light-space bounds of the hit pixels' PCF footprint,
    padded by (-2, +3) (shadow.py:157-172): (n_tiles, 4) xmin, ymin, xmax,
    ymax; a tile with no hit pixel gets an empty rect."""
    n_rows, n_cols = height // STILE_H, width // STILE_W

    def red(img, fill, fn):
        v = torch.where(hit, img, torch.full_like(img, fill)).reshape(n_rows, STILE_H, n_cols, STILE_W)
        return fn(fn(v, dim=3), dim=1).reshape(-1)

    return torch.stack([
        red(sx, _BIG, torch.amin) - 2.0, red(sy, _BIG, torch.amin) - 2.0,
        red(sx, -_BIG, torch.amax) + 3.0, red(sy, -_BIG, torch.amax) + 3.0,
    ], dim=1)


def _csr_from_rows(mask_rows, n_rows: int, V: int, dev) -> BinnedTris:
    """CSR lists from a (n_rows, V) bool mask built `mask_rows(r0, r1)` a
    block of rows at a time; each list in ascending caster id."""
    step = max(1, _MASK_BATCH // max(V, 1))
    counts, ids = [], []
    for r0 in range(0, n_rows, step):
        m = mask_rows(r0, min(n_rows, r0 + step))
        counts.append(m.sum(dim=1))
        with profiling_scope("sync::shadow.caster_lists"):
            ids.append(torch.nonzero(m)[:, 1])
    offsets = torch.zeros(n_rows + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(torch.cat(counts), 0)
    return BinnedTris(offsets=offsets.to(torch.int32), ids=torch.cat(ids).to(torch.int32))


def rect_lists(tris: TriSetup, sx, sy, hit, width: int, height: int) -> BinnedTris:
    """K7's caster lists: per 32x128 screen tile, every caster whose bbox
    overlaps the tile's padded footprint rect (bin_rects, shadow.py:66-82;
    one level, as bin_rects_2level only shrinks the TPU scatter and gives
    the same lists), as CSR with no cap."""
    dev = tris.setup.device
    rects = _tile_rects(sx, sy, hit, height, width)
    bb = tris.bbox

    def rows(r0, r1):
        r = rects[r0:r1, None]
        return (bb[None, :, 2] > r[..., 0]) & (bb[None, :, 0] < r[..., 2]) & (bb[None, :, 3] > r[..., 1]) & (
            bb[None, :, 1] < r[..., 3]
        )

    return _csr_from_rows(rows, rects.shape[0], tris.count, dev)


def cell_lists(tris: TriSetup, sx, sy, hit, width: int, height: int, size: int, lt: int = 32) -> BinnedTris:
    """K8's caster lists: per 32x128 screen tile, every caster whose bbox,
    padded by (-2, +3), overlaps one of the lt x lt light cells that the
    tile's hit pixels occupy (the exact light-cell union of
    shadow.py:290-442, per caster instead of per Morton-sorted group of 8),
    as CSR with no cap. A pixel's cell is clip(floor(s / lt), 0, G - 1)
    with G = ceil(size / lt); the occupancy goes through 2D prefix sums, so
    each (tile, caster) test is one rectangle sum."""
    dev = tris.setup.device
    n_rows, n_cols = height // STILE_H, width // STILE_W
    n_tiles = n_rows * n_cols
    G = -(-size // lt)
    with profiling_scope("sync::shadow.hit_pixels"):
        ys, xs = torch.nonzero(hit, as_tuple=True)
    tile = (ys // STILE_H) * n_cols + xs // STILE_W
    cx = torch.floor(sx[ys, xs] / lt).clamp(0, G - 1).long()
    cy = torch.floor(sy[ys, xs] / lt).clamp(0, G - 1).long()
    occ = torch.zeros(n_tiles, G, G, dtype=torch.int32, device=dev)
    occ[tile, cy, cx] = 1
    psum = torch.zeros(n_tiles, G + 1, G + 1, dtype=torch.int32, device=dev)
    psum[:, 1:, 1:] = occ.cumsum(1).cumsum(2)
    psum = psum.reshape(n_tiles, -1)
    x0, y0, x1, y1 = tris.bbox.unbind(dim=1)
    # Cell j is relevant iff j*lt - 2 < x1 and j*lt + lt + 3 > x0.
    c0x = torch.floor((x0 - lt - 3.0) / lt).long() + 1
    c1x = torch.ceil((x1 + 2.0) / lt).long() - 1
    c0y = torch.floor((y0 - lt - 3.0) / lt).long() + 1
    c1y = torch.ceil((y1 + 2.0) / lt).long() - 1
    live = (c0x <= c1x) & (c1x >= 0) & (c0x <= G - 1) & (c0y <= c1y) & (c1y >= 0) & (c0y <= G - 1)
    c0x, c1x = c0x.clamp(0, G - 1), c1x.clamp(0, G - 1)
    c0y, c1y = c0y.clamp(0, G - 1), c1y.clamp(0, G - 1)
    W1 = G + 1
    corners = ((c1y + 1) * W1 + c1x + 1, c0y * W1 + c1x + 1, (c1y + 1) * W1 + c0x, c0y * W1 + c0x)

    def rows(r0, r1):
        p = psum[r0:r1]
        s = p[:, corners[0]] - p[:, corners[1]] - p[:, corners[2]] + p[:, corners[3]]
        return (s > 0) & live[None]

    return _csr_from_rows(rows, n_tiles, tris.count, dev)


def _texel_pairs(tris: TriSetup, tx, ty, cell: int = 16):
    """The plain versions' candidates. For the distinct base texels (tx,
    ty) (int64, base texel centre (tx + 0.5, ty + 0.5)), yield batches of
    (caster, texel index) pairs: every caster whose bbox comes within half
    a texel of the texel's taps (x in [tx - 0.5, tx + 2.5], the same in y),
    found by joining casters and texels on `cell`-texel light cells."""
    dev = tx.device
    n = tx.shape[0]
    if n == 0 or tris.count == 0:
        return
    kx, ky = torch.div(tx, cell, rounding_mode="floor"), torch.div(ty, cell, rounding_mode="floor")
    lo_x, lo_y = int(kx.min()), int(ky.min())
    span = int(kx.max()) - lo_x + 1
    ckey = (ky - lo_y) * span + (kx - lo_x)
    order = torch.argsort(ckey)
    ukeys, ucounts = torch.unique_consecutive(ckey[order], return_counts=True)
    ustart = torch.cumsum(ucounts, 0) - ucounts
    x0, y0, x1, y1 = tris.bbox.unbind(dim=1)
    # Relevant base texels: x1 > tx - 1 and x0 < tx + 3 (likewise y).
    bx0 = torch.floor((x0 - 3.0) / cell).long()
    bx1 = torch.floor((x1 + 1.0) / cell).long()
    by0 = torch.floor((y0 - 3.0) / cell).long()
    by1 = torch.floor((y1 + 1.0) / cell).long()
    hi_x, hi_y = int(kx.max()), int(ky.max())
    bx0, bx1 = bx0.clamp_min(lo_x), bx1.clamp_max(hi_x)
    by0, by1 = by0.clamp_min(lo_y), by1.clamp_max(hi_y)
    nx, ny = (bx1 - bx0 + 1).clamp_min(0), (by1 - by0 + 1).clamp_min(0)
    ncell = nx * ny
    v = torch.repeat_interleave(torch.arange(tris.count, device=dev), ncell)
    local = torch.arange(v.shape[0], device=dev) - torch.repeat_interleave(torch.cumsum(ncell, 0) - ncell, ncell)
    key = (by0[v] + local // nx[v] - lo_y) * span + (bx0[v] + local % nx[v] - lo_x)
    pos = torch.searchsorted(ukeys, key).clamp_max(ukeys.shape[0] - 1)
    found = ukeys[pos] == key
    v, pos = v[found], pos[found]
    cnt = ucounts[pos]
    csum = torch.cumsum(cnt, 0)
    total = int(csum[-1]) if csum.numel() else 0  # host read: candidate count
    marks = torch.tensor(list(range(_PAIR_BATCH, total, _PAIR_BATCH)), dtype=csum.dtype, device=dev)
    cuts = [0] + sorted(set(torch.searchsorted(csum, marks).tolist())) + [v.shape[0]]
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        if hi <= lo:
            continue
        c = cnt[lo:hi]
        vv = torch.repeat_interleave(v[lo:hi], c)
        off = torch.arange(int(c.sum()), device=dev) - torch.repeat_interleave(torch.cumsum(c, 0) - c, c)
        u = order[torch.repeat_interleave(ustart[pos[lo:hi]], c) + off]
        keep = (x1[vv] > (tx[u] - 1).float()) & (x0[vv] < (tx[u] + 3).float())
        keep &= (y1[vv] > (ty[u] - 1).float()) & (y0[vv] < (ty[u] + 3).float())
        yield vv[keep], u[keep]


def _base_texels(sx, sy, hit):
    """The hit pixels' flat ids, and the distinct base texels (tx, ty) with
    each hit pixel's index into them."""
    pix = torch.nonzero(hit.flatten()).flatten()
    lim = float(1 << 24)
    tx = torch.floor(sx.flatten()[pix] - 0.5).clamp(-lim, lim).long()
    ty = torch.floor(sy.flatten()[pix] - 0.5).clamp(-lim, lim).long()
    key = (ty + (1 << 25)) * (1 << 26) + (tx + (1 << 25))
    ukey, inv = torch.unique(key, return_inverse=True)
    return pix, ukey % (1 << 26) - (1 << 25), ukey // (1 << 26) - (1 << 25), inv


def _occlusion_plain(tris: TriSetup, sx, sy, hit, lt_form: bool) -> torch.Tensor:
    """Plain version of K7 (lt_form False) and K8 (True): (12, H, W), the
    values at hit pixels, 0 elsewhere. A pixel's 12 values depend only on
    its base texel, so they are computed once per distinct base texel, over
    every caster near it (_texel_pairs), in the kernels' arithmetic: the
    three edges and the depth plane at the base texel centre as
    fma(a, bx, b*by) + c, then at offset (dx, dy) K7's (e + a*dx) + b*dy
    (shadow.py:255-258) or K8's e + (a*dx + b*dy) (shadow.py:521-541); the
    products by dx, dy are exact. These are the forms XLA:CPU gives the
    Pallas kernels in interpret mode, found by bit-matching, with one quirk:
    in K7 at the offsets with dx == 1 and dy != 1 (where XLA drops the
    product by 1 and so changes what LLVM contracts) the depth plane's base
    is fma(zb, by, za*bx) + zc."""
    H, W = sx.shape
    pix, tx, ty, inv = _base_texels(sx, sy, hit)
    occ_u = torch.zeros(tx.shape[0], N_OFF, dtype=torch.float32, device=sx.device)
    s = tris.setup
    for v, u in _texel_pairs(tris, tx, ty):
        bx = tx[u].float() + 0.5
        by = ty[u].float() + 0.5
        r = s[v]
        e = [plane_eval(r[:, S_EA + k], r[:, S_EB + k], r[:, S_EC + k], bx, by) for k in range(3)]
        a = [r[:, S_EA + k] for k in range(3)] + [r[:, S_ZA]]
        b = [r[:, S_EB + k] for k in range(3)] + [r[:, S_ZB]]
        e.append(plane_eval(r[:, S_ZA], r[:, S_ZB], r[:, S_ZC], bx, by))
        # K7's depth plane where dx == 1 and dy != 1: fma(zb, by, za*bx) + zc.
        z_swapped = fma32(r[:, S_ZB], by, r[:, S_ZA] * bx) + r[:, S_ZC]
        vals = []
        for dx, dy in PCF_OFFSETS:
            if lt_form:
                p = [e[k] + (a[k] * float(dx) + b[k] * float(dy)) for k in range(4)]
            else:
                ez = z_swapped if (dx == 1 and dy != 1) else e[3]
                p = [(ek + a[k] * float(dx)) + b[k] * float(dy) for k, ek in enumerate(e[:3] + [ez])]
            cov = (p[0] > 0.0) & (p[1] > 0.0) & (p[2] > 0.0) & (p[3] >= 0.0)
            vals.append(torch.where(cov, p[3], torch.zeros_like(p[3])))
        occ_u.scatter_reduce_(0, u[:, None].expand(-1, N_OFF), torch.stack(vals, dim=1), reduce="amax")
    out = torch.zeros(N_OFF, H * W, dtype=torch.float32, device=sx.device)
    out[:, pix] = occ_u[inv].T
    return out.reshape(N_OFF, H, W)


def occlusion_pairs(tris: TriSetup, sx, sy, hit) -> int:
    """(distinct base texel, caster) pairs whose caster bbox comes near the
    texel's taps: the evaluations the occlusion needs at these inputs."""
    _pix, tx, ty, _inv = _base_texels(sx, sy, hit)
    return sum(int(v.numel()) for v, _u in _texel_pairs(tris, tx, ty))


def shadow_occlusion_plain(tris: TriSetup, sx, sy, hit) -> torch.Tensor:
    """Plain version of K7 at hit pixels (see _occlusion_plain)."""
    return _occlusion_plain(tris, sx, sy, hit, lt_form=False)


def shadow_occlusion_lt_plain(tris: TriSetup, sx, sy, hit) -> torch.Tensor:
    """Plain version of K8 at hit pixels (see _occlusion_plain)."""
    return _occlusion_plain(tris, sx, sy, hit, lt_form=True)


def occlusion_from_lists(tris: TriSetup, binned: BinnedTris, sx, sy, hit, width: int, height: int, *, lt_form: bool):
    """The occlusion kernel over per-screen-tile caster lists (CSR, one
    list per 32x128 tile): K7's arithmetic with lt_form False, K8's with
    True. CUDA tensors launch csrc/shadow_occ.cu; CPU tensors run the plain
    version (which needs no lists). Returns (12, height, width) f32."""
    dev = _check_screen(tris, sx, sy, hit, width, height)
    n_tiles = (width // STILE_W) * (height // STILE_H)
    if binned.offsets.shape != (n_tiles + 1,) or any(
        t.dtype != torch.int32 or t.device != dev or not t.is_contiguous() for t in (binned.offsets, binned.ids)
    ):
        raise ValueError(f"caster lists must be contiguous int32 CSR over {n_tiles} tiles on {dev}")
    if dev.type == "cpu":
        return _occlusion_plain(tris, sx, sy, hit, lt_form)
    if tris.setup.data_ptr() % 16:
        raise ValueError("setup rows must be aligned to 16 bytes (the kernel copies them 16 bytes at a time)")
    from . import cuda_kernels

    with profiling_scope("kernel::K8" if lt_form else "kernel::K7"):
        out = torch.empty(N_OFF, height, width, dtype=torch.float32, device=dev)
        # The kernel's segment plan: a count, then (tile, first entry) for each
        # of at most n_tiles + P / OCC_SEG segments.
        n_entries = binned.ids.numel()
        plan = torch.empty(1 + 2 * (n_tiles + n_entries // OCC_SEG), dtype=torch.int32, device=dev)
        cuda_kernels.call(
            "k7_shadow_occ", tris.setup, tris.bbox, binned.offsets, binned.ids, sx, sy, hit, out, plan,
            ints=(width, height, int(lt_form), n_entries, plan.numel()),
        )
        launches["shadow_occ_lt" if lt_form else "shadow_occ"] += 1
    return out


def shadow_occlusion(tris: TriSetup, sx, sy, hit, width: int, height: int) -> torch.Tensor:
    """K7 (shadow.py:175-287): max occluder depth at the 12 PCF texel
    centres, (12, height, width), over rect caster lists. sx, sy: (H, W)
    light-space pixel coordinates of each screen pixel; hit: (H, W) bool;
    width / height padded to the 32x128 tile."""
    _check_screen(tris, sx, sy, hit, width, height)
    binned = rect_lists(tris, sx, sy, hit, width, height)
    return occlusion_from_lists(tris, binned, sx, sy, hit, width, height, lt_form=False)


def shadow_occlusion_lt(tris: TriSetup, sx, sy, hit, width: int, height: int, size: int, lt: int = 32):
    """K8 (shadow.py:445-577): K7 over the light-cell-union caster lists
    of a `size`-texel light viewport with lt-texel cells. Returns (occ,
    overflow); the lists have no cap, so overflow is a 0 int32 scalar.
    JAX's bf16 one-hot einsums, Morton-sorted groups of 8 and row bits are
    TPU workarounds and are not ported; the kernel's per-warp bbox skip
    takes the row bits' place."""
    dev = _check_screen(tris, sx, sy, hit, width, height)
    binned = cell_lists(tris, sx, sy, hit, width, height, size, lt)
    occ = occlusion_from_lists(tris, binned, sx, sy, hit, width, height, lt_form=True)
    return occ, torch.zeros((), dtype=torch.int32, device=dev)


def pcf5_from_occlusion(occ: torch.Tensor, sx, sy, ref) -> torch.Tensor:
    """Exact PCF5-with-bilinear-GE from the 12 occluder depths (elementwise,
    shadow.py:769-792). occ: (12, H, W); sx / sy: unsnapped light pixel
    coordinates; ref: the reference depth. Returns the shadow factor."""
    fx = (sx - 0.5) - torch.floor(sx - 0.5)
    fy = (sy - 0.5) - torch.floor(sy - 0.5)
    idx = {off: i for i, off in enumerate(PCF_OFFSETS)}

    def cmp(dx, dy):
        return (ref >= occ[idx[(dx, dy)]]).float()

    def tap(ox, oy):
        top = cmp(ox, oy) * (1.0 - fx) + cmp(ox + 1, oy) * fx
        bot = cmp(ox, oy + 1) * (1.0 - fx) + cmp(ox + 1, oy + 1) * fx
        return top * (1.0 - fy) + bot * fy

    total = tap(0, 0) + tap(0, 1) + tap(0, -1) + tap(1, 0) + tap(-1, 0)
    return total * 0.2
