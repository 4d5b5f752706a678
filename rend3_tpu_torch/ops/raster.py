"""Visibility-buffer types, the sample offsets, and the reference rasterizer.

Port of rend3_tpu/ops/raster.py: the per-sample visibility buffer that the
binned visibility raster (ops/raster_binned.py, K6) writes, the
pixel-relative sample positions of one sample and of wgpu's standard 4x
MSAA pattern, which the frame's K1 launches and K6 share, and `rasterize`,
the O(T x P) reference rasterizer that the forward frame
(REND3_TPU_RASTER=reference) draws with.

Matched wgpu semantics: front face = CW in NDC for Handedness::Left, cull
back (forward) / front (shadows), reverse-Z GreaterEqual depth test onto a
0-cleared buffer, the top-left fill rule, pixel centres at (x+0.5, y+0.5).

`rasterize` computes what the JAX function's chunked `lax.scan` computes:
per pixel and sample, the covering triangle of greatest depth, the later
one on equal depth (JAX: the last argmax within a chunk, a write on >=
across chunks, so the result does not depend on the chunk). Here that is
the greatest (depth, triangle id) key, which does not depend on the order
the triangles are visited in either, so the steps visit them in an order
that keeps each step's pixel window small. The scan body
is compiled by XLA even when the JAX function is called eagerly, so its
sums take the forms XLA:CPU gives them (read off the compiled body): each
edge function fma((hx-lx), (py-ly), -((hy-ly)*(px-lx))) and the depth
fma(b2, z2, fma(b1, z1, b0*z0)). Each step here takes a chunk of
triangles over the window of pixels their bounding boxes can reach (grown
by one pixel, as the K1 plain version's fragments), sized from a memory
budget, and keeps per pixel the (depth, triangle) key that is greatest.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.profiling import scope as profiling_scope
from .fp import fma32
from .geometry import CullMode

__all__ = [
    "VisBuffer", "CullMode", "NEG_DEPTH", "CENTER_OFFSET", "MSAA4_OFFSETS", "sample_offsets",
    "screen_coords", "prepare_tris", "pixel_windows", "rasterize",
]

NEG_DEPTH = -1.0  # sentinel "no coverage" depth; real depths are >= 0

# wgpu / Vulkan standard sample positions (pixel-relative).
CENTER_OFFSET = ((0.5, 0.5),)
MSAA4_OFFSETS = ((0.375, 0.125), (0.875, 0.375), (0.125, 0.625), (0.625, 0.875))

# Elements of one (C, 3, h, w) edge tensor a step of `rasterize` may hold
# (its float64 temporaries are a few times that in bytes).
RASTER_BUDGET = 1 << 23


class VisBuffer(NamedTuple):
    """Per-sample visibility: depth (S, H, W) f32 and triangle id (S, H, W)
    int32 into the clipped-triangle table, -1 = no hit."""

    depth: torch.Tensor
    tri: torch.Tensor


def sample_offsets(samples: int) -> Tuple[Tuple[float, float], ...]:
    """The sample positions of a target with `samples` samples (1 or 4)."""
    if samples == 1:
        return CENTER_OFFSET
    if samples == 4:
        return MSAA4_OFFSETS
    raise ValueError(f"samples={samples}: the renderer takes 1 or 4 samples")


def screen_coords(clip: torch.Tensor, width: int, height: int):
    """clip (..., 4) -> pixel-space x, y (y down) and ndc z, after the w
    divide (raster.py:55-62)."""
    inv_w = 1.0 / clip[..., 3]
    x = (clip[..., 0] * inv_w * 0.5 + 0.5) * width
    y = (0.5 - clip[..., 1] * inv_w * 0.5) * height
    z = clip[..., 2] * inv_w
    return x, y, z


def _edge(ax, ay, bx, by, px, py):
    """Signed area*2 of (a, b, p), positive when p is left of a->b in y-down
    screen space: (bx-ax)*(py-ay) - (by-ay)*(px-ax), contracted as the
    compiled scan body computes it."""
    return fma32(bx - ax, py - ay, -((by - ay) * (px - ax)))


def _edge_canonical(ax, ay, bx, by, px, py):
    """Watertight edge function: evaluated from the lexicographically
    smaller endpoint and sign-corrected, so the two triangles sharing an
    edge get bitwise-opposite values."""
    swap = (bx < ax) | ((bx == ax) & (by < ay))
    lx = torch.where(swap, bx, ax)
    hx = torch.where(swap, ax, bx)
    ly = torch.where(swap, by, ay)
    hy = torch.where(swap, ay, by)
    sgn = torch.where(swap, -1.0, 1.0).to(ax.dtype)
    return sgn * _edge(lx, ly, hx, hy, px, py)


def _top_left(ax, ay, bx, by):
    """wgpu top-left fill rule for a CCW(-in-screen-space) triangle edge a->b."""
    dy = by - ay
    dx = bx - ax
    return ((dy == 0.0) & (dx > 0.0)) | (dy < 0.0)


def prepare_tris(clip, valid, width: int, height: int, cull_mode: int, front_is_cw: bool):
    """Per-triangle setup (raster.py:95-127): screen coords, winding cull,
    orientation fix. Returns (xs, ys, zs, ws, keep, flip), the corners
    reordered (1 <-> 2 where flip) so every kept triangle's screen-space
    area is positive."""
    x, y, z = screen_coords(clip, width, height)
    w = clip[..., 3]
    area2 = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) - (y[:, 1] - y[:, 0]) * (x[:, 2] - x[:, 0])
    is_front = (area2 > 0.0) if front_is_cw else (area2 < 0.0)
    keep = valid & (area2 != 0.0) & (w > 0.0).all(dim=-1)
    if cull_mode == CullMode.BACK:
        keep = keep & is_front
    elif cull_mode == CullMode.FRONT:
        keep = keep & ~is_front
    flip = area2 < 0.0

    def sw(a):
        return torch.where(flip[:, None], a[:, [0, 2, 1]], a)

    return sw(x), sw(y), sw(z), sw(w), keep, flip


def pixel_windows(xs, ys, width: int, height: int, origin=(0, 0)) -> torch.Tensor:
    """(n, 4) int64 [x0, y0, x1) x [y0, y1) pixel window of each triangle's
    screen corners xs, ys (n, 3): its bounding box grown by one pixel (a
    covered sample may round a hair outside the float box, never a whole
    pixel), in the coordinates of a width x height tile at `origin`,
    clipped to it."""
    ox, oy = float(origin[0]), float(origin[1])
    x0 = torch.floor(xs.amin(1) - ox).clamp(-2, width + 1).long() - 1
    x1 = torch.ceil(xs.amax(1) - ox).clamp(-2, width + 1).long() + 1
    y0 = torch.floor(ys.amin(1) - oy).clamp(-2, height + 1).long() - 1
    y1 = torch.ceil(ys.amax(1) - oy).clamp(-2, height + 1).long() + 1
    return torch.stack([x0.clamp(0, width), y0.clamp(0, height), x1.clamp(0, width), y1.clamp(0, height)], 1)


def _ordered(z: torch.Tensor) -> torch.Tensor:
    """int64 keys that order float32 values as floats (-0.0 as +0.0)."""
    i = (z + 0.0).view(torch.int32)
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i).long()


def rasterize(
    clip: torch.Tensor,          # (T, 3, 4) clipped triangles
    valid: torch.Tensor,         # (T,) bool
    width: int,
    height: int,
    *,
    cull_mode: int = CullMode.BACK,
    front_is_cw: bool = True,
    sample_offsets=CENTER_OFFSET,
    chunk: int = 256,
    frag_mask_fn=None,
    init: Optional[VisBuffer] = None,
    origin=(0, 0),
    tile=None,
) -> VisBuffer:
    """Rasterize triangles into a per-sample visibility buffer
    (raster.py:130-240).

    Triangle order is draw order: on depth ties the later triangle wins.
    ``frag_mask_fn(tri_ids (C,), bary (C,3,h,w), persp_bary (C,3,h,w)) ->
    (C,h,w) bool`` optionally discards fragments (alpha cutout); it is
    called per step on the step's pixel window, so it must act per
    fragment. ``init`` is a VisBuffer the triangles are drawn over (a
    triangle writes where its depth >= the buffer's). ``tile`` restricts
    the raster to a (tile_w, tile_h) window whose top-left pixel is
    ``origin``; ``width`` / ``height`` stay the viewport of the NDC ->
    pixel mapping, and the output is tile-sized. ``chunk`` caps the
    triangles of one step; the result does not depend on it."""
    dev = clip.device
    tile_w, tile_h = tile if tile is not None else (width, height)
    ox0, oy0 = float(origin[0]), float(origin[1])
    xs, ys, zs, ws, keep, _ = prepare_tris(clip, valid, width, height, cull_mode, front_is_cw)
    S = len(sample_offsets)
    if init is None:
        depth = torch.zeros((S, tile_h, tile_w), dtype=torch.float32, device=dev)
        tri = torch.full((S, tile_h, tile_w), -1, dtype=torch.int32, device=dev)
    else:
        depth, tri = init.depth.clone(), init.tri.clone()
    # The best (depth, triangle + 1) key per pixel; the initial buffer's
    # entries carry 0, so a triangle of equal depth replaces them.
    best = _ordered(depth) << 32
    with profiling_scope("sync::raster.kept"):
        kept = torch.nonzero(keep).flatten()
    if kept.numel() == 0:
        return VisBuffer(depth=depth, tri=tri)
    win = pixel_windows(xs[kept], ys[kept], tile_w, tile_h, (ox0, oy0))
    # The merge keeps the greatest key, whatever the order the triangles
    # are visited in: visit them sorted by window size class, then by the
    # 64-pixel cell of the window's corner, so a step's window is tight.
    area = (win[:, 2] - win[:, 0]).clamp_min(0) * (win[:, 3] - win[:, 1]).clamp_min(0)
    size_class = torch.floor(torch.log2(area.double() + 1.0)).long()
    cells_x = tile_w // 64 + 1
    order = torch.argsort(size_class * (1 << 40) + (win[:, 1] // 64) * cells_x + win[:, 0] // 64, stable=True)
    with profiling_scope("sync::raster.windows"):
        kept, win = kept[order], win[order].cpu()  # host read: the windows size each step
    chunk = max(1, int(chunk))
    for i, j, window in _steps(win.tolist(), chunk, S):
        best, depth, tri = _raster_step(
            kept[i:j], xs, ys, zs, ws, sample_offsets, window, (ox0, oy0), frag_mask_fn, best, depth, tri,
        )
    return VisBuffer(depth=depth, tri=tri)


def _steps(win, chunk: int, samples: int):
    """Yield (i, j, window): runs of at most `chunk` consecutive windows
    whose union window holds at most RASTER_BUDGET edge values and wastes
    little: the run's triangles times the union's area stay within 8 times
    the sum of their own areas (plus a 64x64 allowance)."""
    n = len(win)
    i = 0
    while i < n:
        x0, y0, x1, y1 = win[i]
        own = max(0, x1 - x0) * max(0, y1 - y0)
        j = i + 1
        while j < n and j - i < chunk:
            a0, b0, a1, b1 = win[j]
            u = (min(x0, a0), min(y0, b0), max(x1, a1), max(y1, b1))
            ua = max(0, u[2] - u[0]) * max(0, u[3] - u[1])
            c = j - i + 1
            if c * 3 * samples * ua > RASTER_BUDGET or c * ua > 8 * (own + max(0, a1 - a0) * max(0, b1 - b0)) + 4096:
                break
            x0, y0, x1, y1 = u
            own += max(0, a1 - a0) * max(0, b1 - b0)
            j += 1
        if x1 > x0 and y1 > y0:
            yield i, j, (x0, y0, x1, y1)
        i = j


def _raster_step(ids, xs, ys, zs, ws, sample_offsets, window, origin, frag_mask_fn, best, depth, tri):
    """The scan body of raster.py:181-238 for the triangles `ids` over one
    pixel window of the tile; merges the step's winners into (best, depth,
    tri)."""
    dev = xs.device
    x0, y0, x1, y1 = window
    cx, cy, cz, cw = xs[ids], ys[ids], zs[ids], ws[ids]
    ax, bx = cx, torch.roll(cx, -1, 1)
    ay, by = cy, torch.roll(cy, -1, 1)
    tl = _top_left(ax, ay, bx, by)
    cols = torch.arange(x0, x1, dtype=torch.float32, device=dev) + origin[0]
    rows = torch.arange(y0, y1, dtype=torch.float32, device=dev) + origin[1]
    key_id = (ids.long() + 1)[:, None, None]
    C = ids.shape[0]

    def e4(t):
        return t[:, :, None, None]

    for s, (sx, sy) in enumerate(sample_offsets):
        py, px = torch.meshgrid(rows + sy, cols + sx, indexing="ij")
        e = _edge_canonical(e4(ax), e4(ay), e4(bx), e4(by), px[None, None], py[None, None])
        inside = (e > 0.0) | ((e == 0.0) & e4(tl))
        cov = inside.all(dim=1)
        bar = torch.stack([e[:, 1], e[:, 2], e[:, 0]], dim=1)
        bsum = (bar[:, 0] + bar[:, 1]) + bar[:, 2]
        bar = bar / torch.where(bsum == 0.0, torch.ones_like(bsum), bsum)[:, None]
        zfrag = fma32(bar[:, 2], e4(cz)[:, 2], fma32(bar[:, 1], e4(cz)[:, 1], bar[:, 0] * e4(cz)[:, 0]))
        cov = cov & (zfrag >= 0.0) & (zfrag <= 1.0)
        if frag_mask_fn is not None:
            pb = bar / e4(cw)
            psum = (pb[:, 0] + pb[:, 1]) + pb[:, 2]
            pb = pb / psum[:, None]
            cov = cov & frag_mask_fn(ids, bar, pb)
        none = torch.full_like(key_id, -(1 << 63)).expand(C, *cov.shape[1:])
        key = torch.where(cov, (_ordered(zfrag) << 32) | key_id, none)
        kmax, arg = key.max(dim=0)
        zwin = torch.gather(zfrag, 0, arg[None])[0]
        cur = best[s, y0:y1, x0:x1]
        take = kmax > cur
        best[s, y0:y1, x0:x1] = torch.where(take, kmax, cur)
        depth[s, y0:y1, x0:x1] = torch.where(take, zwin, depth[s, y0:y1, x0:x1])
        tri[s, y0:y1, x0:x1] = torch.where(take, (kmax & 0xFFFFFFFF).to(torch.int32) - 1, tri[s, y0:y1, x0:x1])
    return best, depth, tri
