"""PBR shading math (opaque.wgsl), planar over pixels, and the forward
frame's shading pass.

Port of rend3_tpu/ops/shade.py: the material flags and data layout, the
frame's light and uniform tables, `_shade_pixels` (shade.py:443-707), the
shadow-atlas PCF of the forward frame (`_sample_compare_bilinear`,
`shadow_sample_pcf5`, shade.py:229-271) and `shade_deferred`, which shades
a visibility buffer (shade.py:284-441).

Matched math: material decode with every texture branch (albedo, the normal
map in its three encodings with tangent and bitangent, the three AO /
metallic / roughness packings, reflectance, clear coat, emissive), Lambert
diffuse + GGX/Smith/Schlick specular (math/brdf.wgsl), directional lights
with precomputed shadow factors, point lights with the smooth-radius
falloff, final max(ambient * albedo, shaded). Textures arrive as per-slot
samples taken by lighting.light_gbuffer (texture.sample_textures_grid),
or, in the forward frame, through texture.sample_textures; directional
shadows arrive as factors, or, in the forward frame, are resolved from the
shadow atlas.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.profiling import scope as profiling_scope
from .fp import sqrt32

__all__ = [
    "MF",
    "shadow_sample_pcf5",
    "shade_deferred",
    "PbrMaterialTable",
    "PBR_DATA_SIZE",
    "DirLightArrays",
    "PointLightArrays",
    "FrameUniformsArrays",
    "srgb_scene_to_display",
    "srgb_display_to_scene",
    "albedo_alpha",
    "light_vectors",
]

PI = 3.14159265358979


class MF:
    """MaterialFlags bit values (reference: rend3-routine/src/pbr/material.rs:11-31)."""

    ALBEDO_ACTIVE = 1 << 0
    ALBEDO_BLEND = 1 << 1
    ALBEDO_VERTEX_SRGB = 1 << 2
    BICOMPONENT_NORMAL = 1 << 3
    SWIZZLED_NORMAL = 1 << 4
    YDOWN_NORMAL = 1 << 5
    AOMR_COMBINED = 1 << 6
    AOMR_SWIZZLED_SPLIT = 1 << 7
    AOMR_SPLIT = 1 << 8
    AOMR_BW_SPLIT = 1 << 9
    CC_GLTF_COMBINED = 1 << 10
    CC_GLTF_SPLIT = 1 << 11
    CC_BW_SPLIT = 1 << 12
    UNLIT = 1 << 13
    NEAREST = 1 << 14


# ShaderMaterial float-data layout (reference struct: pbr/material.rs:526-583).
PBR_UVT0 = 0          # 9 floats, row-major 3x3
PBR_UVT1 = 9
PBR_ALBEDO = 18       # 4
PBR_EMISSIVE = 22     # 3
PBR_ROUGHNESS = 25
PBR_METALLIC = 26
PBR_REFLECTANCE = 27
PBR_CLEAR_COAT = 28
PBR_CLEAR_COAT_ROUGHNESS = 29
PBR_ANISOTROPY = 30
PBR_AMBIENT_OCCLUSION = 31
PBR_ALPHA_CUTOUT = 32
PBR_DATA_SIZE = 33

# Texture slot order (reference: PbrMaterial::to_textures, pbr/material.rs:497-510).
TEX_ALBEDO, TEX_NORMAL, TEX_ROUGHNESS, TEX_METALLIC, TEX_REFLECTANCE = 0, 1, 2, 3, 4
TEX_CLEAR_COAT, TEX_CLEAR_COAT_ROUGHNESS, TEX_EMISSIVE, TEX_ANISOTROPY, TEX_AO = 5, 6, 7, 8, 9


class PbrMaterialTable(NamedTuple):
    data: torch.Tensor      # (M, PBR_DATA_SIZE) f32
    flags: torch.Tensor     # (M,) i32
    textures: torch.Tensor  # (M, 10) i32, 0 = none else 1-based texture index


class DirLightArrays(NamedTuple):
    """ShaderDirectionalLight SoA (reference: rend3/src/managers/directional.rs:38-54)."""

    view_proj: torch.Tensor       # (L, 4, 4)
    color: torch.Tensor           # (L, 3) color * intensity
    direction: torch.Tensor       # (L, 3)
    inv_resolution: torch.Tensor  # (L, 2) 1/atlas extent
    atlas_offset: torch.Tensor    # (L, 2) uv
    atlas_size: torch.Tensor      # (L, 2) uv
    mask: torch.Tensor            # (L,) bool


class PointLightArrays(NamedTuple):
    """ShaderPointLight SoA (reference: rend3/src/managers/point.rs)."""

    position: torch.Tensor  # (P, 3)
    color: torch.Tensor     # (P, 3) color * intensity
    radius: torch.Tensor    # (P,)
    mask: torch.Tensor      # (P,) bool


class FrameUniformsArrays(NamedTuple):
    """FrameUniforms (reference: rend3-routine/src/uniforms.rs:16-125)."""

    view: torch.Tensor                 # (4, 4)
    view_proj: torch.Tensor            # (4, 4)
    origin_view_proj: torch.Tensor     # (4, 4)
    inv_view: torch.Tensor             # (4, 4)
    inv_origin_view_proj: torch.Tensor  # (4, 4)
    ambient: torch.Tensor              # (4,)


def srgb_display_to_scene(e):
    """sRGB EOTF (reference: math/color.wgsl srgb_display_to_scene)."""
    return torch.where(e > 0.04045, ((e + 0.055) / 1.055) ** 2.4, e / 12.92)


def srgb_scene_to_display(o):
    """sRGB OETF with the exact 1/2.4 exponent (hardware Rgba8UnormSrgb)."""
    return torch.where(o > 0.0031308, 1.055 * o ** (1.0 / 2.4) - 0.055, o * 12.92)


def _sum_rows(t):
    """Sum over the leading (channel) axis, left to right, keepdim."""
    acc = t[0:1]
    for i in range(1, t.shape[0]):
        acc = acc + t[i : i + 1]
    return acc


def _dot_p(a, b):
    return _sum_rows(a * b)  # (1, N)


def _normalize_p(v):
    n = sqrt32(_sum_rows(v * v))
    return v / torch.where(n == 0.0, torch.ones_like(n), n)


def _cross_p(a, b):
    return torch.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]
    )


def _saturate(v):
    return torch.clamp(v, 0.0, 1.0)


def brdf_d_ggx(noh, a):
    a2 = a * a
    f = (noh * a2 - noh) * noh + 1.0
    return a2 / (PI * f * f)


def brdf_f_schlick(u, f0, f90):
    return f0 + (f90 - f0) * (1.0 - u) ** 5


def brdf_v_smith_ggx_correlated(nov, nol, a):
    a2 = a * a
    ggxl = nov * sqrt32((-nol * a2 + nol) * nol + a2)
    ggxv = nol * sqrt32((-nov * a2 + nov) * nov + a2)
    return 0.5 / (ggxl + ggxv)


def surface_shading(light_dir, intensity, normal, f0, roughness, diffuse_color, view_dir, occlusion):
    """reference: opaque.wgsl surface_shading; vectors (3, N), scalars (1, N)."""
    n = normal
    h = _normalize_p(view_dir + light_dir)
    nov = torch.abs(_dot_p(n, view_dir)) + 0.00001
    nol = _saturate(_dot_p(n, light_dir))
    noh = _saturate(_dot_p(n, h))
    loh = _saturate(_dot_p(light_dir, h))
    f90 = _saturate(_sum_rows(f0 * (50.0 * 0.33)))
    d = brdf_d_ggx(noh, roughness)
    f = brdf_f_schlick(loh, f0, f90)
    v = brdf_v_smith_ggx_correlated(nov, nol, roughness)
    fr = (d * v) * f
    fd = diffuse_color * (1.0 / PI)
    color = fd + fr
    return (color * intensity) * (nol * occlusion)


def _finite_or_zero(t):
    return torch.where(torch.isfinite(t), t, torch.zeros_like(t))


def _sample_compare_bilinear(atlas, u_px, v_px, ref):
    """textureSampleCompareLevel with a linear GreaterEqual comparison
    sampler (shade.py:229-258): compare each of the 4 bilinear texels with
    ref, then blend the 0/1 results. atlas (Ha, Wa) stored reverse-Z depth;
    u_px, v_px texel-space coordinates; lit (1.0) where ref >= stored."""
    ha, wa = atlas.shape
    xf = u_px - 0.5
    yf = v_px - 0.5
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    fx = xf - x0
    fy = yf - y0
    x0 = x0.to(torch.int32)
    y0 = y0.to(torch.int32)

    def cmp(xi, yi):
        xi = xi.clamp(0, wa - 1).long()
        yi = yi.clamp(0, ha - 1).long()
        return (ref >= atlas[yi, xi]).to(torch.float32)

    c00 = cmp(x0, y0)
    c10 = cmp(x0 + 1, y0)
    c01 = cmp(x0, y0 + 1)
    c11 = cmp(x0 + 1, y0 + 1)
    top = c00 * (1.0 - fx) + c10 * fx
    bot = c01 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def shadow_sample_pcf5(atlas, coords_uv, ref):
    """5-tap PCF cross (shadow/pcf.wgsl:1-9, shade.py:261-271): coords_uv
    (..., 2) atlas uv; ref (...,) depth."""
    ha, wa = atlas.shape
    u_px = coords_uv[..., 0] * wa
    v_px = coords_uv[..., 1] * ha
    total = _sample_compare_bilinear(atlas, u_px, v_px, ref)
    for ox, oy in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        total = total + _sample_compare_bilinear(atlas, u_px + ox, v_px + oy, ref)
    return total * 0.2


def _interp(corner_vals, bary):
    """corner_vals (N, 3, C), bary (N, 3) -> (N, C)."""
    t = corner_vals * bary[:, :, None]
    return (t[:, 0] + t[:, 1]) + t[:, 2]


def _normalize(v):
    """v / |v| over the last axis (0 length left as is)."""
    n = sqrt32((v * v).sum(-1, keepdim=True))
    return v / torch.where(n == 0.0, torch.ones_like(n), n)


def shade_deferred(
    vis, ctris, tri_vlocal, tri_obj, geo, obj_bases, model_view, obj_material,
    materials: PbrMaterialTable, dir_lights: DirLightArrays, point_lights: PointLightArrays,
    shadow_atlas, uniforms: FrameUniformsArrays, width: int, height: int, sample_offsets,
    textures=None, background=None, origin=(0, 0),
):
    """Shade every sample of a visibility buffer (shade.py:284-416): per
    pixel, the barycentrics of its clipped triangle at the sample position,
    the vertex attributes interpolated from the source triangle's corners,
    the material decode and lighting of `_shade_pixels` with shadows from
    `shadow_atlas` and textures through texture.sample_textures with the
    analytic uv gradients. Returns (S, Ht, Wt, 4) linear HDR RGBA, the
    background (transparent black when None) where no triangle hit.
    `width` / `height` are the viewport; the shaded region is the tile
    covered by `vis`, whose top-left pixel is `origin`."""
    S, tile_h, tile_w = vis.tri.shape
    N = S * tile_h * tile_w
    dev = vis.tri.device
    t = vis.tri.reshape(N).long()
    hit = t >= 0
    ts = t.clamp_min(0)

    cpos = ctris.clip[ts]
    bmat = ctris.bary[ts]
    orig = ctris.orig[ts].long()
    inv_w = 1.0 / cpos[..., 3]
    sx = (cpos[..., 0] * inv_w * 0.5 + 0.5) * width
    sy = (0.5 - cpos[..., 1] * inv_w * 0.5) * height

    cols = torch.arange(tile_w, dtype=torch.float32, device=dev) + origin[0]
    rows = torch.arange(tile_h, dtype=torch.float32, device=dev) + origin[1]
    pxs, pys = [], []
    for ox, oy in sample_offsets:
        py, px = torch.meshgrid(rows + oy, cols + ox, indexing="ij")
        pxs.append(px)
        pys.append(py)
    px = torch.stack(pxs).reshape(N)
    py = torch.stack(pys).reshape(N)

    def edge(i, j):
        return (sx[:, j] - sx[:, i]) * (py - sy[:, i]) - (sy[:, j] - sy[:, i]) * (px - sx[:, i])

    bar = torch.stack([edge(1, 2), edge(2, 0), edge(0, 1)], dim=-1)
    bsum = (bar[:, 0:1] + bar[:, 1:2]) + bar[:, 2:3]
    bar = bar / torch.where(bsum == 0.0, torch.ones_like(bsum), bsum)
    pb = bar * inv_w
    psum = (pb[:, 0:1] + pb[:, 1:2]) + pb[:, 2:3]
    pb = pb / torch.where(psum == 0.0, torch.ones_like(psum), psum)
    beta = _interp(bmat, pb)  # barycentrics of the source triangle

    vloc = tri_vlocal[orig].long()
    obj = tri_obj[orig].clamp_min(0).long()
    bases = obj_bases[obj].long()

    def gather_attr(arena, ai, default):
        base = bases[:, ai]
        ids = (vloc + base[:, None]).clamp(0, arena.shape[0] - 1)
        vals = arena[ids]
        dflt = torch.tensor(default, dtype=torch.float32, device=dev)
        return torch.where((base >= 0)[:, None, None], vals, dflt)

    mv = model_view[obj]
    mv3 = mv[:, :3, :3]

    def mat3(m, v):  # sum_b m[n, a, b] * v[n, ..., b], summed in order
        t = m[:, None, :, :] * v[:, :, None, :] if v.dim() == 3 else m * v[:, None, :]
        return (t[..., 0] + t[..., 1]) + t[..., 2]

    model_pos = _interp(gather_attr(geo.position, 0, [0.0, 0.0, 0.0]), beta)
    view_pos = mat3(mv3, model_pos) + mv[:, :3, 3]
    sq = mv3 * mv3
    inv_scale_sq = 1.0 / torch.clamp_min((sq[:, 0] + sq[:, 1]) + sq[:, 2], 1e-30)
    nrm_v = mat3(mv3, gather_attr(geo.normal, 1, [0.0, 0.0, 0.0]) * inv_scale_sq[:, None, :])
    tan_v = mat3(mv3, gather_attr(geo.tangent, 2, [0.0, 0.0, 0.0]) * inv_scale_sq[:, None, :])
    nrm = _interp(_normalize(nrm_v), beta)
    tan = _interp(_normalize(tan_v), beta)
    uv0_c = gather_attr(geo.uv0, 3, [0.0, 0.0])
    uv0 = _interp(uv0_c, beta)
    vcol = _interp(gather_attr(geo.color0, 5, [1.0, 1.0, 1.0, 1.0]), beta)
    duv = _uv_gradients(sx, sy, inv_w, bmat, bar, pb, uv0_c) if textures is not None else None

    midx = obj_material[obj].long()
    mdata = materials.data[midx]
    mflags = materials.flags[midx]
    mtex = materials.textures[midx] if textures is not None else None
    out_rgb, out_a = _shade_pixels(
        mdata.T, mflags, None if mtex is None else mtex.T, vcol.T, nrm.T, tan.T, view_pos.T,
        dir_lights, point_lights, uniforms, None,
        textures=textures, uv0=uv0.T, duv=None if duv is None else duv.reshape(N, 4).T, shadow_atlas=shadow_atlas,
    )
    rgba = torch.cat([out_rgb, out_a], dim=0).T
    bg = torch.zeros(N, 4, device=dev) if background is None else background.reshape(N, 4)
    rgba = torch.where(hit[:, None], rgba, bg)
    return rgba.reshape(S, tile_h, tile_w, 4)


def _uv_gradients(sx, sy, inv_w, bmat, bar, pb, uv_corners):
    """d(uv)/dx and d(uv)/dy (shade.py:419-441): the screen barycentrics'
    constant gradients, perspective-corrected to first order at the pixel,
    weighting the corners' uv. Returns (N, 2, 2). `bmat` is unused, as in
    JAX's function (same signature)."""
    x0, x1, x2 = sx[:, 0], sx[:, 1], sx[:, 2]
    y0, y1, y2 = sy[:, 0], sy[:, 1], sy[:, 2]
    area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    area2 = torch.where(area2 == 0.0, torch.ones_like(area2), area2)
    dl_dx = torch.stack([(y1 - y2), (y2 - y0), (y0 - y1)], dim=-1) / area2[:, None]
    dl_dy = torch.stack([(x2 - x1), (x0 - x2), (x1 - x0)], dim=-1) / area2[:, None]

    def sum3(t):
        return (t[:, 0:1] + t[:, 1:2]) + t[:, 2:3]

    wsum = sum3(bar * inv_w)
    wsum = torch.where(wsum == 0.0, torch.ones_like(wsum), wsum)
    db_dx = (dl_dx * inv_w - pb * sum3(dl_dx * inv_w)) / wsum
    db_dy = (dl_dy * inv_w - pb * sum3(dl_dy * inv_w)) / wsum
    return torch.stack([_interp(uv_corners, db_dx), _interp(uv_corners, db_dy)], dim=1)


def _shade_pixels(
    mdata, mflags, mtex, vcol, nrm, tan, view_pos,
    dir_lights: DirLightArrays, point_lights: PointLightArrays,
    uniforms: FrameUniformsArrays, shadow_values, tex_samples=None,
    *, textures=None, uv0=None, duv=None, shadow_atlas=None,
):
    """get_pixel_data + the lighting loop, planar over N pixels: mdata
    (D, N), mflags (N,), mtex (NSLOT, N) 1-based texture ids or None,
    vcol (4, N), nrm/tan/view_pos (3, N), shadow_values (L, N), tex_samples
    None or a list of NSLOT (4, N) samples / None (a slot no material
    samples this frame reads as a white texture). Returns ((3, N) rgb,
    (1, N) alpha).

    The forward frame's inputs, as in JAX (shade.py:474-484, 615-655):
    with shadow_values None, each directional light's factor is PCF5 of
    `shadow_atlas` at the pixel's light-space position, with the
    reference's atlas-space bounds expressions (the any() quirk); with
    tex_samples None and `textures` given, every slot is sampled through
    texture.sample_textures at the material's transform of `uv0` (2, N)
    with gradients `duv` (4, N) rows [du/dx, dv/dx, du/dy, dv/dy] or None."""
    dev = mdata.device
    N = mdata.shape[1]

    def fl(bit):
        return ((mflags & bit) != 0)[None, :]

    coords = None
    if tex_samples is None and textures is not None and mtex is not None:
        u, vv = uv0[0:1], uv0[1:2]
        coords = torch.cat([
            mdata[PBR_UVT0 + 0 : PBR_UVT0 + 1] * u + mdata[PBR_UVT0 + 1 : PBR_UVT0 + 2] * vv
            + mdata[PBR_UVT0 + 2 : PBR_UVT0 + 3],
            mdata[PBR_UVT0 + 3 : PBR_UVT0 + 4] * u + mdata[PBR_UVT0 + 4 : PBR_UVT0 + 5] * vv
            + mdata[PBR_UVT0 + 5 : PBR_UVT0 + 6],
        ])

    def sample(slot):
        if coords is not None:
            from .texture import sample_textures

            duv_nm = None if duv is None else duv.T.reshape(N, 2, 2)
            return sample_textures(textures, mtex[slot], coords.T, duv_nm, mflags).T
        if tex_samples is None:
            return None
        s = tex_samples[slot]
        return s if s is not None else torch.ones(4, N, dtype=torch.float32, device=dev)

    def has(slot):
        return (mtex[slot] != 0)[None, :]

    def vec3(a, b, c):
        with profiling_scope("sync::const.shade_defaults"):
            return torch.tensor([a, b, c], dtype=torch.float32, device=dev)[:, None]

    # --- albedo (opaque.wgsl get_pixel_data_inner) ---
    albedo = torch.ones(4, N, dtype=torch.float32, device=dev)
    tex_albedo = sample(TEX_ALBEDO)
    if tex_albedo is not None:
        albedo = torch.where(has(TEX_ALBEDO), tex_albedo, albedo)
    blend_col = torch.where(
        fl(MF.ALBEDO_VERTEX_SRGB),
        torch.cat([srgb_display_to_scene(vcol[:3]), vcol[3:]], dim=0),
        vcol,
    )
    albedo = torch.where(fl(MF.ALBEDO_BLEND), albedo * blend_col, albedo)
    with profiling_scope("sync::const.shade_defaults"):
        no_albedo = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)[:, None]
    albedo = torch.where(fl(MF.ALBEDO_ACTIVE), albedo, no_albedo)
    albedo = albedo * mdata[PBR_ALBEDO : PBR_ALBEDO + 4]

    # --- normals ---
    normal = _normalize_p(nrm)
    tex_normal = sample(TEX_NORMAL)
    if tex_normal is not None:
        bicomp2 = torch.where(
            fl(MF.SWIZZLED_NORMAL), torch.cat([tex_normal[3:4], tex_normal[1:2]], dim=0), tex_normal[:2]
        ) * 2.0 - 1.0
        bz = sqrt32(torch.clamp_min(1.0 - _sum_rows(bicomp2 ** 2), 0.0))
        n_bi = torch.cat([bicomp2, bz], dim=0)
        n_tri = _normalize_p(tex_normal[:3] * 2.0 - 1.0)
        n_tex = torch.where(fl(MF.BICOMPONENT_NORMAL), n_bi, n_tri)
        n_tex = n_tex * torch.where(fl(MF.YDOWN_NORMAL), vec3(1.0, -1.0, 1.0), vec3(1.0, 1.0, 1.0))
        t_norm = _normalize_p(tan)
        bitangent = _cross_p(normal, t_norm)
        mapped = t_norm * n_tex[0:1] + bitangent * n_tex[1:2] + normal * n_tex[2:3]
        normal = torch.where(has(TEX_NORMAL), _normalize_p(mapped), normal)

    # --- AO / metallic / roughness (three packing modes) ---
    base_ao = mdata[PBR_AMBIENT_OCCLUSION : PBR_AMBIENT_OCCLUSION + 1]
    base_rough = mdata[PBR_ROUGHNESS : PBR_ROUGHNESS + 1]
    base_metal = mdata[PBR_METALLIC : PBR_METALLIC + 1]
    ao, rough, metal = base_ao, base_rough, base_metal
    tex_rough = sample(TEX_ROUGHNESS)
    tex_metal = sample(TEX_METALLIC)
    tex_ao = sample(TEX_AO)
    if tex_rough is not None:
        has_r, has_m, has_a = has(TEX_ROUGHNESS), has(TEX_METALLIC), has(TEX_AO)
        combined = fl(MF.AOMR_COMBINED)
        bw_split = fl(MF.AOMR_BW_SPLIT)
        swz = fl(MF.AOMR_SWIZZLED_SPLIT)
        # combined: one texture; ao = r, rough = g, metal = b
        ao_c = torch.where(has_r, base_ao * tex_rough[0:1], base_ao)
        ro_c = torch.where(has_r, base_rough * tex_rough[1:2], base_rough)
        me_c = torch.where(has_r, base_metal * tex_rough[2:3], base_metal)
        # bw split: each from its own texture's r
        ro_b = torch.where(has_r, base_rough * tex_rough[0:1], base_rough)
        me_b = torch.where(has_m, base_metal * tex_metal[0:1], base_metal)
        ao_b = torch.where(has_a, base_ao * tex_ao[0:1], base_ao)
        # split / swizzled split: rm from the rough texture's rg or gb; ao from r
        rm_r = torch.where(swz, tex_rough[1:2], tex_rough[0:1])
        rm_m = torch.where(swz, tex_rough[2:3], tex_rough[1:2])
        ro_s = torch.where(has_r, base_rough * rm_r, base_rough)
        me_s = torch.where(has_r, base_metal * rm_m, base_metal)
        ao_s = torch.where(has_a, base_ao * tex_ao[0:1], base_ao)
        ao = torch.where(combined, ao_c, torch.where(bw_split, ao_b, ao_s))
        rough = torch.where(combined, ro_c, torch.where(bw_split, ro_b, ro_s))
        metal = torch.where(combined, me_c, torch.where(bw_split, me_b, me_s))

    # --- reflectance / clear coat / emissive ---
    reflectance = mdata[PBR_REFLECTANCE : PBR_REFLECTANCE + 1]
    tex_refl = sample(TEX_REFLECTANCE)
    if tex_refl is not None:
        reflectance = torch.where(has(TEX_REFLECTANCE), reflectance * tex_refl[0:1], reflectance)

    clear_coat = mdata[PBR_CLEAR_COAT : PBR_CLEAR_COAT + 1]
    cc_rough = mdata[PBR_CLEAR_COAT_ROUGHNESS : PBR_CLEAR_COAT_ROUGHNESS + 1]
    tex_cc = sample(TEX_CLEAR_COAT)
    tex_ccr = sample(TEX_CLEAR_COAT_ROUGHNESS)
    if tex_cc is not None:
        has_cc, has_ccr = has(TEX_CLEAR_COAT), has(TEX_CLEAR_COAT_ROUGHNESS)
        ccr_comb = torch.where(has_cc, cc_rough * tex_cc[1:2], cc_rough)
        ccr_src = torch.where(fl(MF.CC_GLTF_SPLIT), tex_ccr[1:2], tex_ccr[0:1])
        ccr_sep = torch.where(has_ccr, cc_rough * ccr_src, cc_rough)
        # Every packing reads the clear-coat factor from the clear-coat
        # texture's r (the JAX branches cc_comb and cc_sep are one expression).
        clear_coat = torch.where(has_cc, clear_coat * tex_cc[0:1], clear_coat)
        cc_rough = torch.where(fl(MF.CC_GLTF_COMBINED), ccr_comb, ccr_sep)

    emissive = mdata[PBR_EMISSIVE : PBR_EMISSIVE + 3]
    tex_emis = sample(TEX_EMISSIVE)
    if tex_emis is not None:
        emissive = torch.where(has(TEX_EMISSIVE), emissive * tex_emis[:3], emissive)

    diffuse_color = albedo[:3] * (1.0 - metal)
    dielectric_f0 = 0.16 * reflectance * reflectance
    f0 = albedo[:3] * metal + dielectric_f0 * (1.0 - metal)
    base_pr = torch.maximum(rough, cc_rough)
    rough = torch.where(clear_coat != 0.0, rough + (base_pr - rough) * clear_coat, rough)
    roughness = rough * rough

    v = -_normalize_p(view_pos)
    dir_vectors, point_positions = light_vectors(dir_lights, point_lights, uniforms)

    color = emissive
    if shadow_values is None:
        iv = uniforms.inv_view
        world = [((iv[a, 0] * view_pos[0] + iv[a, 1] * view_pos[1]) + iv[a, 2] * view_pos[2]) + iv[a, 3]
                 for a in range(3)]
    for i, l in enumerate(dir_vectors):
        if shadow_values is None:
            shadow_value = _atlas_shadow(dir_lights, i, world, shadow_atlas)[None, :]
        else:
            shadow_value = shadow_values[i][None, :]
        contrib = surface_shading(
            l[:, None].expand(3, N), dir_lights.color[i][:, None],
            normal, f0, roughness, diffuse_color, v, shadow_value * ao,
        )
        # GPU max() semantics drop the NaN of the Smith term at nol == 0
        # with roughness 0.
        contrib = _finite_or_zero(contrib)
        color = color + torch.where(dir_lights.mask[i], contrib, torch.zeros_like(contrib))

    for i, lp in enumerate(point_positions):
        delta = lp[:, None] - view_pos
        d = sqrt32(_sum_rows(delta * delta))
        s = _saturate(d / point_lights.radius[i])
        s2 = s * s
        inv_s2 = 1.0 - s2
        att = inv_s2 * inv_s2 / (1.0 + s2)
        intensity = point_lights.color[i][:, None] * att
        l = delta / torch.where(d == 0.0, torch.ones_like(d), d)
        contrib = surface_shading(l, intensity, normal, f0, roughness, diffuse_color, v, ao)
        contrib = torch.clamp_min(_finite_or_zero(contrib), 0.0)
        color = color + torch.where(point_lights.mask[i], contrib, torch.zeros_like(contrib))

    ambient = uniforms.ambient[:, None] * albedo
    lit_rgb = torch.maximum(ambient[:3], color)
    lit_a = torch.maximum(ambient[3:4], albedo[3:4])
    unlit = fl(MF.UNLIT)
    out_rgb = torch.where(unlit, albedo[:3], lit_rgb)
    out_a = torch.where(unlit, albedo[3:4], lit_a)
    return out_rgb, out_a


def light_vectors(dir_lights: DirLightArrays, point_lights: PointLightArrays, uniforms: FrameUniformsArrays):
    """(each directional light's unit vector towards the light, each point
    light's position), (3,) each, in view space: the per-light constants of
    the lighting loop, by its own expressions."""
    view3 = uniforms.view[:3, :3]
    dirs = []
    for i in range(dir_lights.mask.shape[0]):
        dvec = view3 @ (-dir_lights.direction[i])
        dn = sqrt32((dvec * dvec).sum())
        dirs.append(dvec / torch.where(dn == 0.0, torch.ones_like(dn), dn))
    points = []
    for i in range(point_lights.mask.shape[0]):
        lp4 = torch.cat([point_lights.position[i], torch.ones(1, device=uniforms.view.device)])
        points.append((uniforms.view @ lp4)[:3])
    return dirs, points


def _atlas_shadow(dir_lights: DirLightArrays, i: int, world, atlas):
    """Light i's shadow factor at world positions (three (N,) rows) from
    the shadow atlas (shade.py:617-650): PCF5 inside the reference's
    atlas-space bounds, including its any() quirk, 1.0 outside."""
    vp = dir_lights.view_proj[i]
    ndc = [((vp[a, 0] * world[0] + vp[a, 1] * world[1]) + vp[a, 2] * world[2]) + vp[a, 3] for a in range(3)]
    flipped_x = ndc[0] * 0.5 + 0.5
    flipped_y = ndc[1] * 0.5 + 0.5
    top_left = dir_lights.atlas_offset[i]
    size = dir_lights.atlas_size[i]
    sc_u = top_left[0] + size[0] * flipped_x
    sc_v = top_left[1] + size[1] * (1.0 - flipped_y)
    border = dir_lights.inv_resolution[i] * 1.5
    tl_b = top_left + border
    tr_b = top_left + size - border
    in_bounds = (
        ((flipped_x >= tl_b[0]) | (flipped_y >= tl_b[1]))
        & ((flipped_x <= tr_b[0]) | (flipped_y <= tr_b[1]))
        & (ndc[2] >= 0.0)
        & (ndc[2] <= 1.0)
    )
    pcf = shadow_sample_pcf5(atlas, torch.stack([sc_u, sc_v], dim=-1), ndc[2])
    return torch.where(in_bounds, pcf, torch.ones_like(pcf))


def albedo_alpha(mdata, mflags, vcol, tex_a):
    """Alpha of get_pixel_data's albedo for the cutout discard (shade.py:708-717;
    depth.wgsl:105-124, opaque.wgsl:231): texture alpha x vertex-color alpha
    (when blended) x factor alpha. Planar: mdata (D, N), vcol (4, N), tex_a
    the sampled albedo texture's alpha (N,) or None; returns (N,)."""
    a = torch.ones_like(vcol[3]) if tex_a is None else tex_a
    a = torch.where((mflags & MF.ALBEDO_BLEND) != 0, a * vcol[3], a)
    a = torch.where((mflags & MF.ALBEDO_ACTIVE) != 0, a, torch.ones_like(a))
    return a * mdata[PBR_ALBEDO + 3]
