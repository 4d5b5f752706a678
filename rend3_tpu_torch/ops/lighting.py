"""Deferred lighting over the G-buffer.

Port of rend3_tpu/ops/lighting.py light_gbuffer (lighting.py:50-142):
perspective divide of the numerator G-buffer, material table lookup, texture
sampling of the active slots at the hit pixels (texture.sample_textures_grid
on kernel K4, with the analytic uv gradients of the G_DUV channels), then the
opaque.wgsl lighting math (shade._shade_pixels); and cutout_alpha_pass
(lighting.py:203-289), the alpha test of the cutout depth peels on the same
sampler. The TPU build looks materials up with one-hot matmuls on the MXU
(lighting.py:23-47); here they are index gathers. Both passes are per pixel,
so they take any (CH, H, W) G-buffer: the frame hands them compacted pixels
as (CH, 1, N).
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

from . import deferred as D
from .shade import (
    PBR_ALPHA_CUTOUT,
    PBR_UVT0,
    TEX_ALBEDO,
    DirLightArrays,
    FrameUniformsArrays,
    PbrMaterialTable,
    PointLightArrays,
    _shade_pixels,
    albedo_alpha,
)

__all__ = ["light_gbuffer", "cutout_alpha_pass"]


def _uv_coords(mdata: torch.Tensor, uv0: torch.Tensor) -> torch.Tensor:
    """The material's uv transform applied to uv0, (2, N), written out as
    the JAX passes write it (no einsum)."""
    u, vv = uv0[0:1], uv0[1:2]
    t = mdata[PBR_UVT0 : PBR_UVT0 + 6]
    return torch.cat([t[0:1] * u + t[1:2] * vv + t[2:3], t[3:4] * u + t[4:5] * vv + t[5:6]])


def light_gbuffer(
    gbuf: D.GBuffer,
    materials: PbrMaterialTable,
    dir_lights: DirLightArrays,
    point_lights: PointLightArrays,
    uniforms: FrameUniformsArrays,
    background: torch.Tensor,       # (H, W, 4)
    shadow_values: torch.Tensor,    # (L, H, W) precomputed factors
    textures=None,                  # texture.TextureArrays, or None
    active_tex_slots=(),            # slots any material samples this frame
    stage=None,                     # optional stage timer (routine.base.StageTimer)
    capture=None,                   # optional dict for the K4 launch's inputs
) -> torch.Tensor:
    """Returns the (H, W, 4) linear HDR image: shaded where the G-buffer
    hit, the background elsewhere. With a `stage` timer, texture sampling
    is timed as "textures" and the rest as "lighting"."""
    timed = stage if stage is not None else (lambda _name: nullcontext())
    with timed("lighting"):
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
    mtex = None
    tex_samples = None
    if textures is not None and active_tex_slots:
        from . import texture as tex_ops

        with timed("textures"):
            mtex = materials.textures[midx].T    # (NSLOT, N)
            # Analytic uv screen derivatives, already divided (deferred.G_DUV).
            duv = g[D.G_DUV : D.G_DUV + 4]
            tex_samples = tex_ops.sample_textures_grid(
                textures, mtex, _uv_coords(mdata, ch(D.G_UV0, 2)), duv, mflags, tuple(active_tex_slots),
                hit=hit, capture=capture,
            )
    with timed("lighting"):
        out_rgb, out_a = _shade_pixels(
            mdata, mflags, mtex, ch(D.G_COL, 4), ch(D.G_NRM, 3), ch(D.G_TAN, 3), ch(D.G_VP, 3),
            dir_lights, point_lights, uniforms, shadow_values.reshape(shadow_values.shape[0], N),
            tex_samples=tex_samples,
        )
        rgba = torch.cat([out_rgb, out_a], dim=0)  # (4, N)
        rgba = torch.where(hit[None, :], rgba, background.reshape(N, 4).T)
        return rgba.reshape(4, H, W).permute(1, 2, 0)


def cutout_alpha_pass(
    gbuf: D.GBuffer,
    materials: PbrMaterialTable,
    textures,                       # texture.TextureArrays, or None
    active_tex_slots,
    *,
    extras=(),
    capture=None,                   # optional dict for the K4 launch's inputs
) -> torch.Tensor:
    """Per-pixel cutout alpha test over a (CH, H, W) G-buffer: (H, W) bool,
    True where the pixel's fragment survives (alpha >= cutoff, or its
    material has no cutoff). The deferred counterpart of the reference's
    per-fragment discard (depth.wgsl:105-124), used by the cutout depth-peel
    loop. Only the albedo slot is sampled, through K4, at the hit pixels.
    `extras` (registered cutout-mode material routines, lighting.py:271-288)
    are not ported."""
    if extras:
        raise NotImplementedError(
            "registered material routines are not ported yet (ROADMAP queue 1: Off the main path, in the frame)"
        )
    CH, H, W = gbuf.data.shape
    N = H * W
    g = gbuf.data.reshape(CH, N)
    den = g[D.G_DEN]
    inv_den = torch.where(den.abs() < 1e-30, torch.ones_like(den), 1.0 / den)
    vcol = g[D.G_COL : D.G_COL + 4] * inv_den[None]
    midx = torch.round(g[D.G_MAT]).long().clamp(0, materials.data.shape[0] - 1)
    mdata = materials.data[midx].T               # (D, N)
    mflags = materials.flags[midx]
    tex_a = None
    if textures is not None and TEX_ALBEDO in tuple(active_tex_slots):
        from . import texture as tex_ops

        uv0 = g[D.G_UV0 : D.G_UV0 + 2] * inv_den[None]
        samples = tex_ops.sample_textures_grid(
            textures, materials.textures[midx].T, _uv_coords(mdata, uv0), g[D.G_DUV : D.G_DUV + 4], mflags,
            (TEX_ALBEDO,), hit=g[D.G_HIT] > 0.0, capture=capture,
        )
        tex_a = samples[TEX_ALBEDO][3]
    cutoff = mdata[PBR_ALPHA_CUTOUT]
    alpha = albedo_alpha(mdata, mflags, vcol, tex_a)
    return ((cutoff <= 0.0) | (alpha >= cutoff)).reshape(H, W)
