"""Hi-Z depth pyramid and occlusion test.

Port of rend3_tpu/ops/hi_z.py. Reference: rend3-routine/src/hi_z.rs and the
shaders hi_z.wgsl / resolve_depth_min.wgsl: a min-reduction mip pyramid over
reverse-Z depth (min = farthest), and cull.wgsl's occlusion test
(:243-262): pick the mip where the triangle's screen bbox spans <= 2x2
texels, take the min of those 4 texels, and cull when the triangle's nearest
depth is still farther than everything drawn there.

The four texel reads go through kernel K5 (samplers.sample_grid) over the
edge-padded mips packed side by side, one query per triangle. The TPU build
lays the queries out as a fake (Vp/128, 128) image for its tile sampler and
drops the queries of a pair past the sampler's 64-pair cap (they read 0,
"not occluded"); here the queries are a flat vector and none is dropped.
"""

from __future__ import annotations

from typing import List

import torch

from ..utils.profiling import scope as profiling_scope
from .samplers import sample_grid

__all__ = ["build_pyramid", "occlusion_test", "HIZ_TAPS"]

HIZ_TAPS = ((0, 0), (1, 0), (0, 1), (1, 1))


def build_pyramid(depth: torch.Tensor, max_levels: int = 12) -> List[torch.Tensor]:
    """depth (H, W) reverse-Z -> list of min-reduced mips [full, half, ...].

    Odd edges fold into the last texel (min with the trailing row / column),
    which keeps the test conservative."""
    mips = [depth]
    cur = depth
    while min(cur.shape) > 1 and len(mips) < max_levels:
        h, w = cur.shape
        nh, nw = max(1, h // 2), max(1, w // 2)
        m = cur[: nh * 2, : nw * 2].reshape(nh, 2, nw, 2).amin(dim=(1, 3))
        if h > nh * 2:
            m = torch.minimum(m, cur[nh * 2, : nw * 2].reshape(nw, 2).amin(dim=1)[None, :])
        if w > nw * 2:
            m = torch.minimum(m, cur[: nh * 2, nw * 2].reshape(nh, 2).amin(dim=1)[:, None])
        mips.append(m)
        cur = m
    return mips


def mip_atlas(pyramid: List[torch.Tensor]):
    """The mips, each padded by one replicated row and column, side by side
    in one zero-filled (max height, total width) image; returns (atlas,
    column offset per mip)."""
    padded = []
    for m in pyramid:
        p = torch.cat([m, m[-1:]], dim=0)
        padded.append(torch.cat([p, p[:, -1:]], dim=1))
    ah = max(p.shape[0] for p in padded)
    offs = []
    off = 0
    for p in padded:
        offs.append(off)
        off += p.shape[1]
    atlas = torch.zeros(ah, off, dtype=torch.float32, device=pyramid[0].device)
    for p, ox in zip(padded, offs):
        atlas[: p.shape[0], ox : ox + p.shape[1]] = p
    return atlas, offs


def occlusion_test(pyramid, xmin, ymin, xmax, ymax, zmax, *, live=None, capture=None) -> torch.Tensor:
    """Vectorized over triangles: True where definitely occluded.

    The mip is chosen by the bbox's longest screen edge (cull.wgsl:243-250)
    and the test takes the min over its 2x2 footprint. Queries that are not
    `live` read 0 and so are never occluded. `capture`: optional dict that
    receives the K5 launch's inputs under "gather"."""
    n_levels = len(pyramid)
    extent = torch.maximum(xmax - xmin, ymax - ymin)
    with profiling_scope("sync::const.hiz_ln2"):
        two = torch.tensor(2.0, dtype=torch.float32, device=extent.device)
    ln2 = torch.log(two)
    # log(x) / log(2): the form jnp.log2 takes.
    level = torch.ceil(torch.log(torch.clamp_min(extent, 1.0)) / ln2).to(torch.int32).clamp(0, n_levels - 1)

    atlas, offs = mip_atlas(pyramid)
    bx = torch.zeros(xmin.shape, dtype=torch.int32, device=xmin.device)
    by = torch.zeros_like(bx)
    for lv, mip in enumerate(pyramid):
        mh, mw = mip.shape
        scale = float(1 << lv)
        x0 = (xmin / scale).to(torch.int32).clamp(0, mw - 1) + offs[lv]
        y0 = (ymin / scale).to(torch.int32).clamp(0, mh - 1)
        sel = level == lv
        bx = torch.where(sel, x0, bx)
        by = torch.where(sel, y0, by)

    valid = torch.ones(xmin.shape, dtype=torch.bool, device=xmin.device) if live is None else live
    args = (atlas, bx, by, valid.contiguous(), HIZ_TAPS)
    if capture is not None:
        capture["gather"] = args
    vals = sample_grid(*args)
    m = torch.minimum(torch.minimum(vals[0], vals[1]), torch.minimum(vals[2], vals[3]))
    return zmax < m
