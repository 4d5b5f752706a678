"""Deferred lighting over the G-buffer.

Port of rend3_tpu/ops/lighting.py light_gbuffer (lighting.py:50-142):
perspective divide of the numerator G-buffer, material table lookup, texture
sampling of the active slots at the hit pixels (texture.sample_textures_grid
on kernel K4, with the analytic uv gradients of the G_DUV channels), then the
opaque.wgsl lighting math (shade._shade_pixels); and cutout_alpha_pass
(lighting.py:203-289), the alpha test of the cutout depth peels on the same
sampler; and apply_material_routines (lighting.py:143-200), which lets
registered non-PBR archetypes (routine/registry.py) shade their pixels over
the PBR image. The TPU build looks materials up with one-hot matmuls on the MXU
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

__all__ = ["light_gbuffer", "cutout_alpha_pass", "apply_material_routines"]


def _uv_coords(mdata: torch.Tensor, uv0: torch.Tensor) -> torch.Tensor:
    """The material's uv transform applied to uv0, (2, N), written out as
    the JAX passes write it (no einsum)."""
    u, vv = uv0[0:1], uv0[1:2]
    t = mdata[PBR_UVT0 : PBR_UVT0 + 6]
    return torch.cat([t[0:1] * u + t[1:2] * vv + t[2:3], t[3:4] * u + t[4:5] * vv + t[5:6]])


def _flat(gbuf: D.GBuffer):
    """(flat (CH, N) G-buffer, (N,) 1 / den guarded against 0, H, W)."""
    CH, H, W = gbuf.data.shape
    g = gbuf.data.reshape(CH, H * W)
    den = g[D.G_DEN]
    return g, torch.where(den.abs() < 1e-30, torch.ones_like(den), 1.0 / den), H, W


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
        g, inv_den, H, W = _flat(gbuf)
        N = H * W
        hit = g[D.G_HIT] > 0.0

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


def _pixels(g: torch.Tensor, inv_den: torch.Tensor):
    """GBufferPixels of a flat (CH, N) G-buffer (N-major, the routine API)."""
    from ..routine.registry import GBufferPixels

    def ch(off, n):
        return (g[off : off + n] * inv_den[None]).T

    return GBufferPixels(
        view_pos=ch(D.G_VP, 3), nrm=ch(D.G_NRM, 3), tan=ch(D.G_TAN, 3), uv0=ch(D.G_UV0, 2),
        uv1=ch(D.G_UV1, 2), vcol=ch(D.G_COL, 4), hit=g[D.G_HIT] > 0.0,
    )


def _extra_rows(midx: torch.Tensor, base: int, count: int, data: torch.Tensor, flags: torch.Tensor):
    """(in range, (N, D) data rows, (N,) flags) of an archetype's table."""
    ml = (midx - base).clamp(0, count - 1)
    return (midx >= base) & (midx < base + count), data[ml], flags[ml]


def apply_material_routines(
    img: torch.Tensor,              # (H, W, 4) lit image (the built-in PBR pass)
    gbuf: D.GBuffer,
    extras,                         # [(base, count, routine, data, flags)]
    dir_lights: DirLightArrays,
    point_lights: PointLightArrays,
    shadow_values,                  # (L, H, W) or None
    uniforms: FrameUniformsArrays,
) -> torch.Tensor:
    """Registered non-PBR archetypes shade their G-buffer pixels: each
    routine takes the hit pixels whose global material slot lies in its
    table's range, and its rgba replaces the PBR image there."""
    if not extras:
        return img
    g, inv_den, H, W = _flat(gbuf)
    N = H * W
    pixels = _pixels(g, inv_den)
    sv = None if shadow_values is None else shadow_values.reshape(shadow_values.shape[0], N)
    midx = torch.round(g[D.G_MAT]).long()
    out = img.reshape(N, 4)
    for base, count, routine, data, flags in extras:
        sel, mdata, mflags = _extra_rows(midx, base, count, data, flags)
        rgba = routine.shade(pixels, mdata, mflags, dir_lights, point_lights, sv, uniforms)
        out = torch.where((pixels.hit & sel)[:, None], rgba, out)
    return out.reshape(H, W, 4)


def cutout_alpha_pass(
    gbuf: D.GBuffer,
    materials: PbrMaterialTable,
    textures,                       # texture.TextureArrays, or None
    active_tex_slots,
    *,
    extras=(),                      # [(base, count, routine, data, flags)] cutout routines
    capture=None,                   # optional dict for the K4 launch's inputs
) -> torch.Tensor:
    """Per-pixel cutout alpha test over a (CH, H, W) G-buffer: (H, W) bool,
    True where the pixel's fragment survives (alpha >= cutoff, or its
    material has no cutoff). The deferred counterpart of the reference's
    per-fragment discard (depth.wgsl:105-124), used by the cutout depth-peel
    loop. Only the albedo slot is sampled, through K4, at the hit pixels.
    Pixels of a registered cutout routine's archetype (`extras`) are tested
    with the routine's own alpha against its alpha_cutoff instead."""
    g, inv_den, H, W = _flat(gbuf)
    vcol = g[D.G_COL : D.G_COL + 4] * inv_den[None]
    midx_raw = torch.round(g[D.G_MAT]).long()
    midx = midx_raw.clamp(0, materials.data.shape[0] - 1)
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
    ok = (cutoff <= 0.0) | (alpha >= cutoff)
    if extras:
        pixels = _pixels(g, inv_den)
        for base, count, routine, data, flags in extras:
            sel, e_data, e_flags = _extra_rows(midx_raw, base, count, data, flags)
            ok = torch.where(sel, routine.alpha(pixels, e_data, e_flags) >= routine.alpha_cutoff, ok)
    return ok.reshape(H, W)
