"""Deferred lighting over the G-buffer.

Port of rend3_tpu/ops/lighting.py light_gbuffer (lighting.py:50-142) with
textures=None: perspective divide of the numerator G-buffer, material table
lookup, then the opaque.wgsl lighting math (shade._shade_pixels). The TPU
build looks materials up with a one-hot matmul on the MXU
(lighting.py:23-47); here it is an index gather.
"""

from __future__ import annotations

import torch

from . import deferred as D
from .shade import DirLightArrays, FrameUniformsArrays, PbrMaterialTable, PointLightArrays, _shade_pixels

__all__ = ["light_gbuffer"]


def light_gbuffer(
    gbuf: D.GBuffer,
    materials: PbrMaterialTable,
    dir_lights: DirLightArrays,
    point_lights: PointLightArrays,
    uniforms: FrameUniformsArrays,
    background: torch.Tensor,       # (H, W, 4)
    shadow_values: torch.Tensor,    # (L, H, W) precomputed factors
) -> torch.Tensor:
    """Returns the (H, W, 4) linear HDR image: shaded where the G-buffer
    hit, the background elsewhere."""
    CH, H, W = gbuf.data.shape
    N = H * W
    g = gbuf.data.reshape(CH, N)
    hit = g[D.G_HIT] > 0.0
    den = g[D.G_DEN]
    inv_den = torch.where(den.abs() < 1e-30, torch.ones_like(den), 1.0 / den)

    def ch(off, n):
        return g[off : off + n] * inv_den[None]

    midx = torch.round(g[D.G_MAT]).long().clamp(0, materials.data.shape[0] - 1)
    mdata = materials.data[midx].T           # (D, N)
    mflags = materials.flags[midx]
    out_rgb, out_a = _shade_pixels(
        mdata, mflags, ch(D.G_COL, 4), ch(D.G_NRM, 3), ch(D.G_VP, 3),
        dir_lights, point_lights, uniforms, shadow_values.reshape(shadow_values.shape[0], N),
    )
    rgba = torch.cat([out_rgb, out_a], dim=0)  # (4, N)
    rgba = torch.where(hit[None, :], rgba, background.reshape(N, 4).T)
    return rgba.reshape(4, H, W).permute(1, 2, 0)
