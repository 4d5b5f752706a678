"""PBR shading math (opaque.wgsl), planar over pixels.

Port of rend3_tpu/ops/shade.py: the material flags and data layout, the
frame's light and uniform tables, and `_shade_pixels` (shade.py:443-707).

Matched math: material decode with every texture branch (albedo, the normal
map in its three encodings with tangent and bitangent, the three AO /
metallic / roughness packings, reflectance, clear coat, emissive), Lambert
diffuse + GGX/Smith/Schlick specular (math/brdf.wgsl), directional lights
with precomputed shadow factors, point lights with the smooth-radius
falloff, final max(ambient * albedo, shaded). Textures arrive as per-slot
samples taken by lighting.light_gbuffer (texture.sample_textures_grid).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .deferred import sqrt32

__all__ = [
    "MF",
    "PbrMaterialTable",
    "PBR_DATA_SIZE",
    "DirLightArrays",
    "PointLightArrays",
    "FrameUniformsArrays",
    "srgb_scene_to_display",
    "srgb_display_to_scene",
    "albedo_alpha",
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


def _shade_pixels(
    mdata, mflags, mtex, vcol, nrm, tan, view_pos,
    dir_lights: DirLightArrays, point_lights: PointLightArrays,
    uniforms: FrameUniformsArrays, shadow_values, tex_samples=None,
):
    """get_pixel_data + the lighting loop, planar over N pixels: mdata
    (D, N), mflags (N,), mtex (NSLOT, N) 1-based texture ids or None,
    vcol (4, N), nrm/tan/view_pos (3, N), shadow_values (L, N), tex_samples
    None or a list of NSLOT (4, N) samples / None (a slot no material
    samples this frame reads as a white texture). Returns ((3, N) rgb,
    (1, N) alpha)."""
    dev = mdata.device
    N = mdata.shape[1]

    def fl(bit):
        return ((mflags & bit) != 0)[None, :]

    def sample(slot):
        if tex_samples is None:
            return None
        s = tex_samples[slot]
        return s if s is not None else torch.ones(4, N, dtype=torch.float32, device=dev)

    def has(slot):
        return (mtex[slot] != 0)[None, :]

    def vec3(a, b, c):
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
    albedo = torch.where(
        fl(MF.ALBEDO_ACTIVE), albedo, torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)[:, None]
    )
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
    view3 = uniforms.view[:3, :3]

    color = emissive
    for i in range(dir_lights.mask.shape[0]):
        shadow_value = shadow_values[i][None, :]
        dvec = view3 @ (-dir_lights.direction[i])
        dn = sqrt32((dvec * dvec).sum())
        l = dvec / torch.where(dn == 0.0, torch.ones_like(dn), dn)
        contrib = surface_shading(
            l[:, None].expand(3, N), dir_lights.color[i][:, None],
            normal, f0, roughness, diffuse_color, v, shadow_value * ao,
        )
        # GPU max() semantics drop the NaN of the Smith term at nol == 0
        # with roughness 0.
        contrib = _finite_or_zero(contrib)
        color = color + torch.where(dir_lights.mask[i], contrib, torch.zeros_like(contrib))

    for i in range(point_lights.mask.shape[0]):
        lp4 = torch.cat([point_lights.position[i], torch.ones(1, device=dev)])
        delta = (uniforms.view @ lp4)[:3][:, None] - view_pos
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


def albedo_alpha(mdata, mflags, vcol, tex_a):
    """Alpha of get_pixel_data's albedo for the cutout discard (shade.py:708-717;
    depth.wgsl:105-124, opaque.wgsl:231): texture alpha x vertex-color alpha
    (when blended) x factor alpha. Planar: mdata (D, N), vcol (4, N), tex_a
    the sampled albedo texture's alpha (N,) or None; returns (N,)."""
    a = torch.ones_like(vcol[3]) if tex_a is None else tex_a
    a = torch.where((mflags & MF.ALBEDO_BLEND) != 0, a * vcol[3], a)
    a = torch.where((mflags & MF.ALBEDO_ACTIVE) != 0, a, torch.ones_like(a))
    return a * mdata[PBR_ALBEDO + 3]
