"""Deferred lighting over the G-buffer.

Port of rend3_tpu/ops/lighting.py light_gbuffer (lighting.py:50-142):
perspective divide of the numerator G-buffer, material table lookup, each
directional light's shadow factor (the light-space coordinates of the
frame's shadow pass, base.py:1642-1680, and PCF5 against the stacked shadow
maps), texture sampling of the active slots at the hit pixels (with the
analytic uv gradients of the G_DUV channels), then the opaque.wgsl lighting
math (shade._shade_pixels); and cutout_alpha_pass (lighting.py:203-289), the
alpha test of the cutout depth peels on K4; and apply_material_routines
(lighting.py:143-200), which lets registered non-PBR archetypes
(routine/registry.py) shade their pixels over the PBR image. The TPU build
looks materials up with one-hot matmuls on the MXU (lighting.py:23-47);
here they are index gathers. Both passes are per pixel, so they take any
(CH, H, W) G-buffer: the frame hands them compacted pixels as (CH, 1, N).

light_gbuffer shades a G-buffer with the hand-written kernel D1
(csrc/deferred_shade.cu, one launch) on CUDA tensors, and with its plain
version, light_gbuffer_plain, on CPU tensors: shadow_coords and
shadow.resolve_shadow_pcf5 (K3), texture.sample_textures_grid (K4) and
shade._shade_pixels, the chain D1 computes in one pass. cutout_peel_step,
one cutout peel's alpha test with its replace, done and bound updates,
runs the hand-written kernel C1 (the same file, on D1's albedo path) on
CUDA tensors, with a registered cutout routine's verdict computed before
it (routine_verdict), and its plain version, cutout_peel_step_plain (the
chain around cutout_alpha_pass), on CPU tensors.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import List, NamedTuple

import torch

from ..utils import profiling
from ..utils.profiling import scope as profiling_scope
from . import deferred as D
from . import fp as fp_ops
from . import shadow as shadow_ops
from . import texture as tex_ops
from .shade import (
    PBR_ALPHA_CUTOUT,
    PBR_DATA_SIZE,
    PBR_UVT0,
    TEX_ALBEDO,
    DirLightArrays,
    FrameUniformsArrays,
    PbrMaterialTable,
    PointLightArrays,
    _shade_pixels,
    albedo_alpha,
    light_vectors,
)

__all__ = ["light_gbuffer", "light_gbuffer_plain", "ShadowMaps", "shadow_coords", "shadow_factors",
           "chain_inputs", "light_tensors", "launch_args", "cutout_alpha_pass", "cutout_peel_step",
           "cutout_peel_step_plain", "routine_verdict", "peel_launch_args", "apply_material_routines", "launches",
           "MAX_MAPS"]

# D1's and C1's launches (their plain versions' runs do not count).
launches = {"deferred_shade": 0, "cutout_alpha": 0}
# Shadow maps one D1 launch takes (csrc/deferred_shade.cu kMaxMaps).
MAX_MAPS = 16


class ShadowMaps(NamedTuple):
    """A frame's shadow maps as the shade reads them: map k shades
    directional light k (lights past the plan are unshadowed)."""

    plan: tuple            # ((light, (ox, oy), size), ...), one entry a map
    maps: List[torch.Tensor]  # (size, size) f32 reverse-Z depth each
    stacked: torch.Tensor  # shadow.stack_shadow_maps(maps)'s stack
    bases: List[int]       # each map's first row in `stacked`


def _untimed(_name):
    return nullcontext()


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


def shadow_coords(g: torch.Tensor, inv_view: torch.Tensor, dir_lights: DirLightArrays, plan):
    """Per plan entry (map index, sx, sy, ref, hit, in_bounds) at the
    fragments of a (CH, H, W) G-buffer (a padded frame, or compacted pixels
    as (CH, 1, N)): world reconstruct -> light NDC, with the reference's
    atlas-space bounds expressions including the any() quirk
    (opaque.wgsl:509-514, base.py:1642-1680). Both matrix products take the
    form XLA:CPU gives the JAX frame's: fma(m2, v2, fma(m0, v0, m1*v1)),
    then the translation added."""

    def mat_img(m, rows, img):  # (rows, 3) of m x three image channels, all rows at once
        col = [m[:rows, k].reshape(rows, *([1] * (img.dim() - 1))) for k in range(3)]
        return fp_ops.fma32(col[2], img[2:3], fp_ops.fma32(col[0], img[0:1], col[1] * img[1:2]))

    den = g[D.G_DEN]
    invden = torch.where(den.abs() < 1e-30, torch.ones_like(den), 1.0 / den)
    vp_img = g[D.G_VP : D.G_VP + 3] * invden[None]
    hitp = g[D.G_HIT] > 0.0
    world = mat_img(inv_view[:3, :3], 3, vp_img) + inv_view[:3, 3][:, None, None]
    dl = dir_lights
    out = []
    for k, (_li, _off, size) in enumerate(plan):
        vp = dl.view_proj[k]
        ndc = mat_img(vp, 4, world) + vp[:, 3][:, None, None]
        ndcw = torch.where(ndc[3] == 0.0, torch.ones_like(ndc[3]), ndc[3])
        ndc_xyz = ndc[:3] / ndcw[None]
        sx = (ndc_xyz[0] * 0.5 + 0.5) * size
        sy = (0.5 - ndc_xyz[1] * 0.5) * size
        ref = ndc_xyz[2]
        flipped_x = ndc_xyz[0] * 0.5 + 0.5
        flipped_y = ndc_xyz[1] * 0.5 + 0.5
        border = dl.inv_resolution[k] * 1.5
        tl_b = dl.atlas_offset[k] + border
        tr_b = dl.atlas_offset[k] + dl.atlas_size[k] - border
        in_bounds = (
            ((flipped_x >= tl_b[0]) | (flipped_y >= tl_b[1]))
            & ((flipped_x <= tr_b[0]) | (flipped_y <= tr_b[1]))
            & (ref >= 0.0)
            & (ref <= 1.0)
        )
        out.append((k, sx, sy, ref, hitp, in_bounds))
    return out


def shadow_factors(gbuf: D.GBuffer, dir_lights: DirLightArrays, uniforms: FrameUniformsArrays,
                   shadows: ShadowMaps, stage=None) -> torch.Tensor:
    """(L, H, W) shadow factors of a G-buffer's pixels, one a directional
    light: PCF5 of its map (shadow_coords, then one K3 launch for every
    map), 1.0 outside the map's bounds and for lights past the plan. With a
    `stage` timer, timed as "shadow_coords" and "pcf"."""
    timed = stage if stage is not None else _untimed
    L = dir_lights.mask.shape[0]
    with timed("shadow_coords"):
        coords = shadow_coords(gbuf.data, uniforms.inv_view, dir_lights, shadows.plan)
    with timed("pcf"):
        entries = [(k, sx, sy, ref, hitp) for k, sx, sy, ref, hitp, _ib in coords]
        pcfs = shadow_ops.resolve_shadow_pcf5(shadows.maps, entries, stacked=(shadows.stacked, shadows.bases))
        svals = [torch.where(c[-1], p, torch.ones_like(p)) for c, p in zip(coords, pcfs)]
        while len(svals) < L:
            svals.append(torch.ones_like(svals[0]))
        return torch.stack(svals)


def _need(name: str, t, dtype, shape) -> None:
    """Raises unless t is a `dtype` tensor of `shape` (None: any size)."""
    if (not isinstance(t, torch.Tensor) or t.dtype != dtype or t.dim() != len(shape)
            or any(want is not None and got != want for got, want in zip(t.shape, shape))):
        got = f"{tuple(t.shape)} {t.dtype}" if isinstance(t, torch.Tensor) else type(t).__name__
        raise ValueError(f"{name}: want a {dtype} tensor of shape {shape}, got {got}")


def _check(gbuf, materials, dir_lights, point_lights, uniforms, background, shadows, textures):
    """light_gbuffer's inputs: the shapes, dtypes and strides D1 reads, on
    one device. Raises ValueError."""
    g = gbuf.data
    _need("gbuf", g, torch.float32, (D.GB_CH, None, None))
    _CH, H, W = g.shape
    if W > 1 and g.stride(2) != 1:
        raise ValueError(f"gbuf: rows must be contiguous, got strides {g.stride()}")
    _need("background", background, torch.float32, (H, W, 4))
    if background.stride(2) != 1:
        raise ValueError(f"background: each pixel's 4 channels must be contiguous, got strides {background.stride()}")
    tables = [background, *_material_tables(materials, textures)]
    L = dir_lights.mask.shape[0]
    for name, want in (("view_proj", (L, 4, 4)), ("color", (L, 3)), ("direction", (L, 3)),
                       ("inv_resolution", (L, 2)), ("atlas_offset", (L, 2)), ("atlas_size", (L, 2))):
        _need(f"dir_lights.{name}", getattr(dir_lights, name), torch.float32, want)
    _need("dir_lights.mask", dir_lights.mask, torch.bool, (L,))
    P = point_lights.mask.shape[0]
    for name, want in (("position", (P, 3)), ("color", (P, 3)), ("radius", (P,))):
        _need(f"point_lights.{name}", getattr(point_lights, name), torch.float32, want)
    _need("point_lights.mask", point_lights.mask, torch.bool, (P,))
    _need("uniforms.view", uniforms.view, torch.float32, (4, 4))
    _need("uniforms.inv_view", uniforms.inv_view, torch.float32, (4, 4))
    _need("uniforms.ambient", uniforms.ambient, torch.float32, (4,))
    tables += [*dir_lights, *point_lights, uniforms.view, uniforms.inv_view, uniforms.ambient]
    if isinstance(shadows, ShadowMaps):
        if not (len(shadows.plan) == len(shadows.maps) == len(shadows.bases)):
            raise ValueError("shadows: one map and one stack row a plan entry")
        if len(shadows.plan) > L:
            raise ValueError(f"shadows: {len(shadows.plan)} maps for {L} directional lights")
        _need("shadows.stacked", shadows.stacked, torch.float32, (None, None))
        for k, m in enumerate(shadows.maps):
            _need(f"shadows.maps[{k}]", m, torch.float32, (None, None))
        tables += [shadows.stacked, *shadows.maps]
    elif shadows is not None:
        _need("shadow factors", shadows, torch.float32, (L, H, W))
        if W > 1 and shadows.stride(2) != 1:
            raise ValueError(f"shadow factors: rows must be contiguous, got strides {shadows.stride()}")
        tables.append(shadows)
    _same_device("light_gbuffer", g, tables)


def _material_tables(materials, textures) -> list:
    """Checks the material table and the texture arrays (or None) D1 and C1
    read; returns their tensors. Raises ValueError."""
    M = materials.data.shape[0]
    _need("materials.data", materials.data, torch.float32, (None, PBR_DATA_SIZE))
    _need("materials.flags", materials.flags, torch.int32, (M,))
    _need("materials.textures", materials.textures, torch.int32, (M, tex_ops.NSLOT))
    if M < 1:
        raise ValueError("materials: the table needs a row")
    tables = list(materials)
    if textures is not None:
        S = textures.rects.shape[0]
        _need("textures.atlas", textures.atlas, torch.bfloat16, (None, None, 4))
        _need("textures.rects", textures.rects, torch.float32, (S, tex_ops.MAX_MIPS, 4))
        _need("textures.mip_counts", textures.mip_counts, torch.int32, (S,))
        tables += list(textures)
    return tables


def _same_device(name: str, g: torch.Tensor, tables) -> None:
    for t in tables:
        if t.device != g.device:
            raise ValueError(f"{name}: inputs on {t.device} and {g.device}")


def light_gbuffer_plain(
    gbuf: D.GBuffer,
    materials: PbrMaterialTable,
    dir_lights: DirLightArrays,
    point_lights: PointLightArrays,
    uniforms: FrameUniformsArrays,
    background: torch.Tensor,
    shadows=None,
    textures=None,
    active_tex_slots=(),
    stage=None,
) -> torch.Tensor:
    """Plain version of D1 (light_gbuffer's arguments): the shading chain in
    PyTorch ops on any device. With a `stage` timer, the shadow lookups are
    timed as "shadow_coords" and "pcf", texture sampling as "textures" and
    the rest as "lighting"."""
    timed = stage if stage is not None else _untimed
    L = dir_lights.mask.shape[0]
    _CH, H, W = gbuf.data.shape
    if isinstance(shadows, ShadowMaps):
        shadow_values = shadow_factors(gbuf, dir_lights, uniforms, shadows, stage)
    elif shadows is None:
        shadow_values = torch.ones(L, H, W, dtype=torch.float32, device=gbuf.data.device)
    else:
        shadow_values = shadows
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
        with timed("textures"):
            mtex = materials.textures[midx].T    # (NSLOT, N)
            # Analytic uv screen derivatives, already divided (deferred.G_DUV).
            duv = g[D.G_DUV : D.G_DUV + 4]
            tex_samples = tex_ops.sample_textures_grid(
                textures, mtex, _uv_coords(mdata, ch(D.G_UV0, 2)), duv, mflags, tuple(active_tex_slots), hit=hit,
            )
    with timed("lighting"):
        out_rgb, out_a = _shade_pixels(
            mdata, mflags, mtex, ch(D.G_COL, 4), ch(D.G_NRM, 3), ch(D.G_TAN, 3), ch(D.G_VP, 3),
            dir_lights, point_lights, uniforms, shadow_values.reshape(L, N),
            tex_samples=tex_samples,
        )
        rgba = torch.cat([out_rgb, out_a], dim=0)  # (4, N)
        rgba = torch.where(hit[None, :], rgba, background.reshape(N, 4).T)
        return rgba.reshape(4, H, W).permute(1, 2, 0)


def light_gbuffer(
    gbuf: D.GBuffer,
    materials: PbrMaterialTable,
    dir_lights: DirLightArrays,
    point_lights: PointLightArrays,
    uniforms: FrameUniformsArrays,
    background: torch.Tensor,       # (H, W, 4)
    shadows=None,                   # ShadowMaps, (L, H, W) precomputed factors, or None (unshadowed)
    textures=None,                  # texture.TextureArrays, or None
    active_tex_slots=(),            # slots any material samples this frame
    stage=None,                     # optional stage timer (routine.base.StageTimer)
) -> torch.Tensor:
    """Returns the (H, W, 4) linear HDR image: shaded where the G-buffer
    hit, the background elsewhere. Each directional light k is shadowed by
    map k of `shadows` (a ShadowMaps), by row k of precomputed factors, or
    not at all (None). On CUDA tensors one launch of D1 (csrc/
    deferred_shade.cu), timed with a `stage` timer as "lighting"; on CPU
    tensors light_gbuffer_plain. Raises ValueError on inputs D1 does not
    take (light_gbuffer_plain's chain takes the same)."""
    _check(gbuf, materials, dir_lights, point_lights, uniforms, background, shadows, textures)
    if gbuf.data.device.type == "cpu":
        return light_gbuffer_plain(gbuf, materials, dir_lights, point_lights, uniforms, background, shadows,
                                   textures, active_tex_slots, stage)
    timed = stage if stage is not None else _untimed
    with timed("lighting"):
        return _launch(gbuf, materials, dir_lights, point_lights, uniforms, background, shadows, textures,
                       active_tex_slots)


def light_tensors(dir_lights: DirLightArrays, point_lights: PointLightArrays, uniforms: FrameUniformsArrays):
    """D1's per-light constants: ((L, 3) directional light vectors, (P, 3)
    point light positions), in view space, by the chain's expressions
    (shade.light_vectors)."""
    dirs, points = light_vectors(dir_lights, point_lights, uniforms)
    empty = uniforms.view.new_empty((0, 3))
    return torch.stack(dirs) if dirs else empty, torch.stack(points) if points else empty


def launch_args(gbuf, materials, dir_lights, point_lights, uniforms, background, shadows, textures,
                active_tex_slots, lights):
    """D1's C arguments (tensors, ints) for light_gbuffer's checked
    arguments on the card and light_tensors' `lights`; the third tensor is
    the new (H, W, 4) output."""
    g = gbuf.data
    _CH, H, W = g.shape
    maps = shadows if isinstance(shadows, ShadowMaps) else None
    sv = shadows if isinstance(shadows, torch.Tensor) else None
    n_maps = len(maps.plan) if maps is not None else 0
    if n_maps > MAX_MAPS:
        raise ValueError(f"D1 takes at most {MAX_MAPS} shadow maps, got {n_maps}")
    # Per map: its plan size, first stacked row, height and width (a host array).
    map_ints = [0] * (4 * MAX_MAPS)
    for k in range(n_maps):
        for j, v in enumerate((maps.plan[k][2], maps.bases[k], *maps.maps[k].shape)):
            map_ints[j * MAX_MAPS + k] = int(v)
    slots = 0
    if textures is not None:
        for q in active_tex_slots:
            slots |= 1 << int(q)
    tex = textures if slots else (None, None, None)
    stacked = maps.stacked.contiguous() if maps is not None else None
    dl, pl = dir_lights, point_lights
    ints = (H, W, g.stride(0), g.stride(1), background.stride(0), background.stride(1), materials.data.shape[0],
            *(tex[0].shape[:2] if slots else (0, 0)), tex[1].shape[0] if slots else 0, slots,
            *(sv.stride()[:2] if sv is not None else (0, 0)), *(stacked.shape if stacked is not None else (0, 0)),
            dl.mask.shape[0], pl.mask.shape[0], n_maps)
    if max(abs(i) for i in ints) >= 2**31 or H * W >= 2**31:
        raise ValueError(f"D1: a size or stride of the {H}x{W} G-buffer passes 2^31")

    def c(t):
        return None if t is None else t.contiguous()

    tensors = (g, background, torch.empty((H, W, 4), dtype=torch.float32, device=g.device), c(materials.data),
               c(materials.flags), c(materials.textures), c(tex[0]), c(tex[1]), c(tex[2]), sv, stacked,
               c(dl.view_proj), c(dl.inv_resolution), c(dl.atlas_offset), c(dl.atlas_size), c(uniforms.inv_view),
               lights[0], c(dl.color), c(dl.mask), lights[1], c(pl.color), c(pl.radius), c(pl.mask),
               c(uniforms.ambient), torch.tensor(map_ints, dtype=torch.int32))
    return tensors, ints


def _launch(*args):
    """D1 over light_gbuffer's checked arguments: one new (H, W, 4) float32
    image."""
    from . import cuda_kernels

    lights = light_tensors(*args[2:5])
    with profiling_scope("kernel::D1"):
        tensors, ints = launch_args(*args, lights)
        cuda_kernels.call("d1_deferred_shade", *tensors, ints=ints)
        launches["deferred_shade"] += 1
    profiling.count("shade.gbuffers")
    return tensors[2]


def chain_inputs(gbuf, materials, dir_lights, point_lights, uniforms, background, shadows=None, textures=None,
                 active_tex_slots=()) -> dict:
    """What the plain chain computes on the way at one light_gbuffer call's
    arguments (the frame keeps them, as `captured["deferred_shade"]`, where
    D1 shades): "shadow_coords" (shadow_coords' entries) and "pcf5" (K3's
    arguments) with shadow maps, "bilinear" (K4's arguments) with a sampled
    slot. For tools and tests that hold K3, K4 or the map-free shadow
    resolve to the frame's own queries."""
    out = {}
    if isinstance(shadows, ShadowMaps):
        coords = shadow_coords(gbuf.data, uniforms.inv_view, dir_lights, shadows.plan)
        out["shadow_coords"] = coords
        out["pcf5"] = shadow_ops.pcf5_queries(shadows.maps, [c[:5] for c in coords], (shadows.stacked, shadows.bases))
    if textures is not None and active_tex_slots:
        g, inv_den, _H, _W = _flat(gbuf)
        midx = torch.round(g[D.G_MAT]).long().clamp(0, materials.data.shape[0] - 1)
        uv0 = g[D.G_UV0 : D.G_UV0 + 2] * inv_den[None]
        out["bilinear"] = tex_ops.texture_queries(
            textures, materials.textures[midx].T, _uv_coords(materials.data[midx].T, uv0), g[D.G_DUV : D.G_DUV + 4],
            materials.flags[midx], tuple(active_tex_slots), g[D.G_HIT] > 0.0,
        )
    return out


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


def _check_peel(gc, gbuf, floor, done, materials, textures) -> None:
    """cutout_peel_step's inputs: the shapes, dtypes and layouts C1 reads,
    on one device. Raises ValueError."""
    _need("gc", gc, torch.float32, (D.GB_CH, None, None))
    _CH, H, W = gc.shape
    _need("gbuf", gbuf, torch.float32, (D.GB_CH, H, W))
    _need("floor", floor, torch.float32, (H, W))
    _need("done", done, torch.bool, (H, W))
    for name, t in (("gc", gc), ("gbuf", gbuf), ("floor", floor), ("done", done)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous, got strides {t.stride()}")
    if D.GB_CH * H * W >= 2**31:
        raise ValueError(f"cutout_peel_step: the {H}x{W} G-buffer passes 2^31 values")
    _same_device("cutout_peel_step", gc, [gbuf, floor, done, *_material_tables(materials, textures)])


def cutout_peel_step_plain(gc, gbuf, floor, done, materials, textures, active_tex_slots, extras=(), capture=None):
    """Plain version of C1 (cutout_peel_step's arguments): the chain in
    PyTorch ops on any device. Reads the candidates' pixels with a
    `nonzero`, tests them with cutout_alpha_pass and, where any failed,
    reads their count; returns new gbuf, done and bound tensors and the
    count."""
    CH, H, W = gc.shape
    chit = gc[D.G_HIT] > 0.0
    cdepth = gc[D.G_DEPTH]
    nearer = cdepth > floor
    # The alpha test decides only where a pixel still searches and the
    # fragment is nearer than the opaque one.
    with profiling_scope("sync::cut.pixels"):
        pix = torch.nonzero((~done & chit & nearer).flatten()).flatten()
    passed = torch.zeros(H * W, dtype=torch.bool, device=gc.device)
    searching = 0
    if pix.numel():
        ok = cutout_alpha_pass(
            D.GBuffer(gc.reshape(CH, -1)[:, pix][:, None]), materials, textures, active_tex_slots, extras=extras,
            capture=capture,
        ).flatten()
        passed[pix] = ok
        with profiling_scope("sync::cut.searching"):
            searching = pix.numel() - int(ok.sum())
    passed = passed.reshape(H, W)
    # replace = ~done & chit & pass & nearer, which is `passed`.
    gbuf = torch.where(passed[None], gc, gbuf)
    done = done | ~chit | passed | (chit & ~nearer)
    bound = torch.where(done, torch.zeros_like(cdepth), cdepth)
    return gbuf, done, bound, searching


def routine_verdict(gc: torch.Tensor, extras) -> torch.Tensor:
    """The registered cutout routines' alpha test over a (GB_CH, H, W)
    G-buffer, as cutout_alpha_pass applies it: (H, W) uint8, 0 where no
    routine's material range holds the pixel (the albedo alpha decides), 1
    where a routine fails it, 2 where it passes (the later routine where
    ranges overlap). PyTorch ops, no host read."""
    g, inv_den, H, W = _flat(D.GBuffer(gc))
    pixels = _pixels(g, inv_den)
    midx = torch.round(g[D.G_MAT]).long()
    verdict = torch.zeros(H * W, dtype=torch.uint8, device=gc.device)
    for base, count, routine, data, flags in extras:
        sel, e_data, e_flags = _extra_rows(midx, base, count, data, flags)
        ok = routine.alpha(pixels, e_data, e_flags) >= routine.alpha_cutoff
        verdict = torch.where(sel, 1 + ok.to(torch.uint8), verdict)
    return verdict.reshape(H, W)


def cutout_peel_step(
    gc: torch.Tensor,               # (GB_CH, H, W) the peel's G-buffer (K1's)
    gbuf: torch.Tensor,             # (GB_CH, H, W) the sample's G-buffer so far
    floor: torch.Tensor,            # (H, W) the loop's opaque depth where it hit, else -1
    done: torch.Tensor,             # (H, W) bool: pixels no longer searching
    materials: PbrMaterialTable,
    textures,                       # texture.TextureArrays, or None
    active_tex_slots,
    *,
    extras=(),                      # [(base, count, routine, data, flags)] cutout routines
    capture=None,                   # optional dict: the chain's K4 inputs
):
    """One cutout depth peel's alpha test (base.py:1480-1557): the
    candidates (~done & hit & depth > floor; a hit's reverse-Z depth is at
    least 0, so -1 takes any) are alpha-tested (cutout_alpha_pass); a
    passing fragment replaces the pixel of `gbuf`; done becomes done | ~hit
    | passed | (hit & ~nearer); bound is the depth where a pixel still
    searches, else 0. Returns (gbuf, done, bound, searching), searching the
    count of candidates that failed (one host read).

    On CUDA tensors one launch of C1 (csrc/deferred_shade.cu), which writes
    gbuf in place and returns it with a new done and bound: `floor` must
    not be a view of gbuf. A registered cutout routine's alpha (`extras`, a
    Python callable) is computed over the peel by routine_verdict first,
    and C1 takes its verdict where the routine's range holds the material.
    On CPU tensors cutout_peel_step_plain, which returns new tensors.
    Counters: cut.c1_peels, cut.chain_peels; span routines::verdict around
    a verdict. Raises ValueError on inputs C1 does not take (the chain
    takes the same)."""
    _check_peel(gc, gbuf, floor, done, materials, textures)
    if gc.device.type == "cpu":
        profiling.count("cut.chain_peels")
        return cutout_peel_step_plain(gc, gbuf, floor, done, materials, textures, active_tex_slots, extras, capture)
    from . import cuda_kernels

    verdict = None
    if extras:
        with profiling_scope("routines::verdict"):
            verdict = routine_verdict(gc, extras)
    with profiling_scope("kernel::C1"):
        tensors, ints = peel_launch_args(gc, gbuf, floor, done, materials, textures, active_tex_slots, verdict)
        cuda_kernels.call("c1_cutout_peel", *tensors, ints=ints)
        launches["cutout_alpha"] += 1
    profiling.count("cut.c1_peels")
    with profiling_scope("sync::cut.searching"):
        searching = int(tensors[6])
    return gbuf, tensors[4], tensors[5], searching


def peel_launch_args(gc, gbuf, floor, done, materials, textures, active_tex_slots, verdict=None):
    """C1's C arguments (tensors, ints) for cutout_peel_step's checked
    arguments on the card, with routine_verdict's (H, W) uint8 or None; the
    fifth to seventh tensors are the new done, bound and zeroed counter."""
    n = gc.shape[1] * gc.shape[2]
    slots = int(textures is not None and TEX_ALBEDO in tuple(active_tex_slots))
    tex = textures if slots else (None, None, None)

    def c(t):
        return None if t is None else t.contiguous()

    tensors = (gc, gbuf, floor, done, torch.empty_like(done), torch.empty_like(floor),
               torch.zeros(1, dtype=torch.int32, device=gc.device), c(verdict), c(materials.data),
               c(materials.flags), c(materials.textures), c(tex[0]), c(tex[1]), c(tex[2]))
    ints = (n, materials.data.shape[0], *(tex[0].shape[:2] if slots else (0, 0)), tex[1].shape[0] if slots else 0,
            slots)
    return tensors, ints
