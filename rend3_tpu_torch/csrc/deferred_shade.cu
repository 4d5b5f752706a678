// D1: the deferred shade of a G-buffer in one launch: each hit pixel's
// shadow coordinates and PCF5 factor per shadow map, its texture samples and
// the PBR lighting of opaque.wgsl; the background where no fragment hit.
// C1 (at the end of this file): the alpha test of one cutout depth peel in
// one launch, on D1's albedo path.
//
// Replaces no Pallas kernel. The JAX frame shades with XLA ops around its K3
// and K4 sampling (rend3_tpu/ops/lighting.py:50-142 light_gbuffer, the
// frame's shadow coordinates at rend3_tpu/routine/base.py:1642-1680); the
// port ran the same chain as some 700 PyTorch ops a G-buffer (about 1,400 a
// city frame: the opaque pixels and the blend peels' pixels), with blocking
// uploads of constants. The plain version is that chain
// (ops/lighting.py light_gbuffer_plain: lighting.shadow_coords,
// shadow.resolve_shadow_pcf5, texture.sample_textures_grid,
// shade._shade_pixels), which the CPU runs.
//
// What it computes, per pixel of a (GB_CH, h, w) G-buffer (a padded frame's
// crop, or compacted pixels as (GB_CH, 1, n)), in the chain's expressions:
//   1. the perspective divide (1 / den, guarded), the material row;
//   2. each sampled texture slot: the mip level from the analytic G_DUV
//      gradients, two mip queries (fma(uu, rw, -0.5), bilinear or nearest)
//      through K4's taps (samplers.cuh bilinear_query), summed;
//   3. each shadow map k (directional light k): the light-space position
//      fma(m2, v2, fma(m0, v0, m1 * v1)) + m3 of the world position (the
//      same form from the view position), the atlas bounds with the
//      reference's any() quirk, K3's five taps on the row-stacked maps
//      (samplers.cuh pcf5_query); or precomputed factors; or 1.0;
//   4. _shade_pixels: albedo, normal map, AO / metallic / roughness,
//      reflectance, clear coat, emissive, each directional and point light
//      through surface_shading (non-finite terms dropped), ambient, UNLIT;
//   5. RGBA as one 16-byte store.
// The light vectors in view space (a 3x3 product a light) come from the
// wrapper, computed by the chain's own PyTorch expressions.
//
// Numerics: every operation is the one PyTorch's CUDA kernel computes for
// the chain's op, in its order: _rn intrinsics under --fmad=false, `_rn`
// fmas where the chain calls F1, IEEE division and sqrt, a division by a
// Python number as a multiply by its float reciprocal (PyTorch's
// div_true_kernel with a scalar divisor), `x ** 2` as x * x and other
// powers as powf, log as logf, NaN propagation as torch.maximum / minimum /
// clamp have it (a NaN operand is the result; fmaxf alone would drop it),
// selects where the chain selects. So D1 equals the chain on the card bit
// for bit, except where the device library's powf or logf under
// --fmad=false rounds otherwise than PyTorch's build of them.
//
// What bounds it on the H100: memory. A hit pixel reads the 20 G-buffer
// channels it uses (80 bytes), its texels (a bilinear tap is one 8-byte
// load of four interleaved bf16 channels) and 12 map texels a shadow map,
// and writes 16 bytes; a 1920x1088 frame is about 0.2 GB, 0.06 ms at
// 3.35 TB/s. What holds it above that is arithmetic: the chain's exact
// rounding asks for IEEE divisions and square roots in every normalize and
// BRDF term, a few hundred a lit pixel. Design: one thread a pixel in 32x8
// blocks (a row of 32 pixels reads each plane coalesced, and a block's texel
// and map taps fall on neighbouring texels, so they hit L1 / L2), capped at
// 64 registers so that four CTAs share a SM (the first design's 80 and
// three CTAs were 10-13% slower; a 16x16 tile and five CTAs no faster);
// every table (materials, rects, lights) is read through the read-only
// cache, where the pixels of one material share its row; a pixel not hit
// reads only its hit flag and the background.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kernel_info.cuh"
#include "samplers.cuh"

namespace {

// G-buffer channels (ops/deferred.py).
constexpr int GB_CH = 25, G_DEPTH = 0, G_DEN = 1, G_VP = 2, G_NRM = 5, G_TAN = 8, G_UV0 = 11, G_COL = 15, G_MAT = 19, G_HIT = 20,
              G_DUV = 21;
// Material data layout (ops/shade.py PBR_*).
constexpr int PBR_UVT0 = 0, PBR_ALBEDO = 18, PBR_EMISSIVE = 22, PBR_ROUGHNESS = 25, PBR_METALLIC = 26,
              PBR_REFLECTANCE = 27, PBR_CLEAR_COAT = 28, PBR_CLEAR_COAT_ROUGHNESS = 29,
              PBR_AMBIENT_OCCLUSION = 31, PBR_ALPHA_CUTOUT = 32, PBR_DATA_SIZE = 33;
// Texture slots (ops/shade.py TEX_*) and the atlas's mips (ops/texture.py).
constexpr int NSLOT = 10, MAX_MIPS = 14;
constexpr int TEX_ALBEDO = 0, TEX_NORMAL = 1, TEX_ROUGHNESS = 2, TEX_METALLIC = 3, TEX_REFLECTANCE = 4,
              TEX_CLEAR_COAT = 5, TEX_CLEAR_COAT_ROUGHNESS = 6, TEX_EMISSIVE = 7, TEX_AO = 9;
// Material flags (ops/shade.py MF).
constexpr int MF_ALBEDO_ACTIVE = 1 << 0, MF_ALBEDO_BLEND = 1 << 1, MF_ALBEDO_VERTEX_SRGB = 1 << 2,
              MF_BICOMPONENT_NORMAL = 1 << 3, MF_SWIZZLED_NORMAL = 1 << 4, MF_YDOWN_NORMAL = 1 << 5,
              MF_AOMR_COMBINED = 1 << 6, MF_AOMR_SWIZZLED_SPLIT = 1 << 7, MF_AOMR_BW_SPLIT = 1 << 9,
              MF_CC_GLTF_COMBINED = 1 << 10, MF_CC_GLTF_SPLIT = 1 << 11, MF_UNLIT = 1 << 13,
              MF_NEAREST = 1 << 14;
// Shadow maps a launch takes (ops/lighting.py MAX_MAPS).
constexpr int kMaxMaps = 16;
// ops/shade.py PI, as the chain's float32 ops see it.
constexpr float kPi = (float)3.14159265358979;
constexpr float kInvPi = (float)(1.0 / 3.14159265358979);

struct ShadeParams {
    const float* g;        // G-buffer: channel stride gc, row stride gr, column stride 1
    const float* bg;       // background (h, w, 4): row stride bgr, column stride bgc, channel stride 1
    float4* out;           // (h, w, 4)
    const float* mdata;    // (m, PBR_DATA_SIZE)
    const int* mflags;     // (m,)
    const int* mtex;       // (m, NSLOT), 1-based texture ids
    const uint2* atlas;    // (ah, aw, 4) bf16
    const float* rects;    // (s, MAX_MIPS, 4)
    const int* mipc;       // (s,)
    const float* sv;       // precomputed factors (nl, h, w): light stride svl, row stride svr; or null
    const float* stacked;  // row-stacked maps (hs, ws); or null
    const float* lvp;      // (nl, 4, 4) directional lights' view_proj
    const float* inv_res;  // (nl, 2)
    const float* aoff;     // (nl, 2)
    const float* asize;    // (nl, 2)
    const float* inv_view;  // (4, 4)
    const float* ldir;     // (nl, 3) light vectors in view space
    const float* lcolor;   // (nl, 3)
    const uint8_t* lmask;  // (nl,)
    const float* ppos;     // (np, 3) point lights in view space
    const float* pcolor;   // (np, 3)
    const float* pradius;  // (np,)
    const uint8_t* pmask;  // (np,)
    const float* ambient;  // (4,)
    int h, w, gc, gr, bgr, bgc, m, ah, aw, s, slots, svl, svr, hs, ws, nl, np, n_maps;
    int map_size[kMaxMaps], map_base[kMaxMaps], map_h[kMaxMaps], map_w[kMaxMaps];
};

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// torch.maximum / torch.minimum: a NaN operand is the result.
__device__ __forceinline__ float tmax(float a, float b) { return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b)); }
__device__ __forceinline__ float tmin(float a, float b) { return isnan(a) ? a : (isnan(b) ? b : fminf(a, b)); }
// torch.clamp_min(v, lo) and torch.clamp(v, 0, 1): NaN stays NaN.
__device__ __forceinline__ float clamp_lo(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }
__device__ __forceinline__ float saturate(float v) { return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f); }
__device__ __forceinline__ float finite_or_zero(float v) { return isfinite(v) ? v : 0.0f; }

// ((a0 * b0 + a1 * b1) + a2 * b2), shade._dot_p's order.
__device__ __forceinline__ float dot3(const float a[3], const float b[3])
{
    return fadd(fadd(fmul(a[0], b[0]), fmul(a[1], b[1])), fmul(a[2], b[2]));
}

// shade._normalize_p: v / |v|, a zero length left as is.
__device__ __forceinline__ void normalize3(const float v[3], float o[3])
{
    const float n = __fsqrt_rn(dot3(v, v));
    const float d = n == 0.0f ? 1.0f : n;
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c] = fdiv(v[c], d);
}

// shade.srgb_display_to_scene; `/ 1.055` and `/ 12.92` multiply by the
// float reciprocal, as PyTorch divides by a Python number on the card.
__device__ __forceinline__ float srgb_to_scene(float e)
{
    return e > 0.04045f ? powf(fmul(fadd(e, 0.055f), 1.0f / 1.055f), 2.4f) : fmul(e, 1.0f / 12.92f);
}

// One mip query of sample_textures_grid through K4's taps.
__device__ __forceinline__ void tex_query(const ShadeParams& p, int s, long long li, float uu, float vv,
                                          bool nearest, float wt, bool valid, float v[4])
{
    const float* r = p.rects + ((size_t)s * MAX_MIPS + li) * 4;
    const float rx = __ldg(r), ry = __ldg(r + 1), rw = __ldg(r + 2), rh = __ldg(r + 3);
    const float xf = __fmaf_rn(uu, rw, -0.5f), yf = __fmaf_rn(vv, rh, -0.5f);
    const float x0 = floorf(xf), y0 = floorf(yf);
    const float xn = tmin(floorf(fmul(uu, rw)), fsub(rw, 1.0f));
    const float yn = tmin(floorf(fmul(vv, rh)), fsub(rh, 1.0f));
    const int bx = (int)fadd(nearest ? xn : x0, rx);
    const int by = (int)fadd(nearest ? yn : y0, ry);
    const float fx = nearest ? 0.0f : fsub(xf, x0);
    const float fy = nearest ? 0.0f : fsub(yf, y0);
    bilinear_query(p.atlas, p.ah, p.aw, bx, by, fx, fy, wt, valid, v);
}

// Texture slot q at a hit pixel, as the chain's per-slot sample: a slot no
// material samples this frame, or one that holds no texture (id <= 0),
// reads 1.0; else its two mip queries summed (sample_textures_grid).
__device__ void tex_sample(const ShadeParams& p, int q, int slv, float u, float v, const float duv[4], bool nearest,
                           float out[4])
{
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = 1.0f;
    if (!((p.slots >> q) & 1) || !(slv > 0)) return;
    const int s = min(max(slv, 0), p.s - 1);
    const float nmips = clamp_lo((float)__ldg(p.mipc + s), 1.0f);
    const float tw = __ldg(p.rects + (size_t)s * MAX_MIPS * 4 + 2), th = __ldg(p.rects + (size_t)s * MAX_MIPS * 4 + 3);
    const float dxu = fmul(duv[0], tw), dxv = fmul(duv[1], th), dyu = fmul(duv[2], tw), dyv = fmul(duv[3], th);
    const float rho = tmax(__fsqrt_rn(fadd(fmul(dxu, dxu), fmul(dxv, dxv))),
                           __fsqrt_rn(fadd(fmul(dyu, dyu), fmul(dyv, dyv))));
    // texture._log2: log(x) / log(2), as PyTorch's log on the card.
    const float lg = fdiv(logf(clamp_lo(rho, 1e-12f)), logf(2.0f));
    const float lam = tmin(clamp_lo(lg, 0.0f), fsub(nmips, 1.0f));
    const float l0 = floorf(lam), lf = fsub(lam, l0);
    // A NaN lambda reads mip 0, as the chain's conversion gives it.
    const long long l0i = min(max((long long)l0, 0LL), (long long)(MAX_MIPS - 1));
    const long long l1i = min(l0i + 1, (long long)fsub(nmips, 1.0f));
    const float uu = fsub(u, floorf(u)), vv = fsub(v, floorf(v));
    float a[4], b[4];
    tex_query(p, s, l0i, uu, vv, nearest, nearest ? 1.0f : fsub(1.0f, lf), true, a);
    tex_query(p, s, l1i, uu, vv, nearest, nearest ? 0.0f : lf, !nearest && lf > 0.0f, b);
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = fadd(a[c], b[c]);
}

// Shadow map k's factor at a hit pixel's world position: lighting.shadow_coords,
// then shadow.resolve_shadow_pcf5's query and K3, 1.0 outside the bounds.
__device__ float map_factor(const ShadeParams& p, int k, const float world[3])
{
    const float* m = p.lvp + (size_t)k * 16;
    float ndc[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        ndc[r] = fadd(__fmaf_rn(__ldg(m + r * 4 + 2), world[2],
                                __fmaf_rn(__ldg(m + r * 4), world[0], fmul(__ldg(m + r * 4 + 1), world[1]))),
                      __ldg(m + r * 4 + 3));
    }
    const float ndcw = ndc[3] == 0.0f ? 1.0f : ndc[3];
    const float nx = fdiv(ndc[0], ndcw), ny = fdiv(ndc[1], ndcw), ref = fdiv(ndc[2], ndcw);
    const float size = (float)p.map_size[k];
    const float flx = fadd(fmul(nx, 0.5f), 0.5f), fly = fadd(fmul(ny, 0.5f), 0.5f);
    const float sx = fmul(flx, size), sy = fmul(fsub(0.5f, fmul(ny, 0.5f)), size);
    const float bdx = fmul(__ldg(p.inv_res + 2 * k), 1.5f), bdy = fmul(__ldg(p.inv_res + 2 * k + 1), 1.5f);
    const float ox = __ldg(p.aoff + 2 * k), oy = __ldg(p.aoff + 2 * k + 1);
    const float tl0 = fadd(ox, bdx), tl1 = fadd(oy, bdy);
    const float tr0 = fsub(fadd(ox, __ldg(p.asize + 2 * k)), bdx);
    const float tr1 = fsub(fadd(oy, __ldg(p.asize + 2 * k + 1)), bdy);
    const bool in_bounds = (flx >= tl0 || fly >= tl1) && (flx <= tr0 || fly <= tr1) && ref >= 0.0f && ref <= 1.0f;
    const float sxm = fsub(sx, 0.5f), sym = fsub(sy, 0.5f);
    const float xb = floorf(sxm), yb = floorf(sym);
    const int bx = (int)xb, by = (int)yb;
    const bool ok = bx >= 0 && bx < p.map_w[k] && by >= 0 && by < p.map_h[k];
    const float pcf = ok ? pcf5_query(p.stacked, p.hs, p.ws, bx, by + p.map_base[k], fsub(sxm, xb), fsub(sym, yb),
                                      ref, true)
                         : 1.0f;
    return in_bounds ? pcf : 1.0f;
}

// shade.surface_shading for one light: (3,) vectors, scalars.
__device__ void surface_shading(const float l[3], const float intensity[3], const float n[3], const float f0[3],
                                float roughness, const float diffuse[3], const float v[3], float occlusion,
                                float out[3])
{
    float hv[3], h[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) hv[c] = fadd(v[c], l[c]);
    normalize3(hv, h);
    const float nov = fadd(fabsf(dot3(n, v)), 0.00001f);
    const float nol = saturate(dot3(n, l));
    const float noh = saturate(dot3(n, h));
    const float loh = saturate(dot3(l, h));
    const float f90 = saturate(fadd(fadd(fmul(f0[0], 16.5f), fmul(f0[1], 16.5f)), fmul(f0[2], 16.5f)));
    // brdf_d_ggx
    const float a2 = fmul(roughness, roughness);
    const float fd = fadd(fmul(fsub(fmul(noh, a2), noh), noh), 1.0f);
    const float d = fdiv(a2, fmul(fmul(fd, kPi), fd));
    // brdf_f_schlick's (1 - u) ** 5
    const float p5 = powf(fsub(1.0f, loh), 5.0f);
    // brdf_v_smith_ggx_correlated; 0.5 / x is reciprocal(x) * 0.5
    const float ggxl = fmul(nov, __fsqrt_rn(fadd(fmul(fadd(fmul(-nol, a2), nol), nol), a2)));
    const float ggxv = fmul(nol, __fsqrt_rn(fadd(fmul(fadd(fmul(-nov, a2), nov), nov), a2)));
    const float vis = fmul(fdiv(1.0f, fadd(ggxl, ggxv)), 0.5f);
    const float dv = fmul(d, vis);
    const float occ = fmul(nol, occlusion);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const float f = fadd(f0[c], fmul(fsub(f90, f0[c]), p5));
        const float color = fadd(fmul(diffuse[c], kInvPi), fmul(dv, f));
        out[c] = fmul(fmul(color, intensity[c]), occ);
    }
}

// A hit pixel's RGBA: light_gbuffer_plain's chain.
__device__ float4 shade(const ShadeParams& p, const float* __restrict__ gp, int x, int y)
{
    auto G = [&](int ch) { return __ldg(gp + (size_t)ch * p.gc); };
    const float den = G(G_DEN);
    const float inv = fabsf(den) < 1e-30f ? 1.0f : fmul(fdiv(1.0f, den), 1.0f);
    float vp[3], nrm[3], tan[3], vcol[4];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        vp[c] = fmul(G(G_VP + c), inv);
        nrm[c] = fmul(G(G_NRM + c), inv);
        tan[c] = fmul(G(G_TAN + c), inv);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) vcol[c] = fmul(G(G_COL + c), inv);
    const long long mraw = (long long)nearbyintf(G(G_MAT));
    const int mi = (int)min(max(mraw, 0LL), (long long)(p.m - 1));
    const float* md = p.mdata + (size_t)mi * PBR_DATA_SIZE;
    auto M = [&](int k) { return __ldg(md + k); };
    const int flags = __ldg(p.mflags + mi);
    const int* mt = p.mtex + (size_t)mi * NSLOT;
    const bool any_tex = p.slots != 0;
    auto has = [&](int q) { return any_tex && __ldg(mt + q) != 0; };

    float u = 0.0f, v = 0.0f, duv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (any_tex) {
        const float u0 = fmul(G(G_UV0), inv), v0 = fmul(G(G_UV0 + 1), inv);
        u = fadd(fadd(fmul(M(PBR_UVT0), u0), fmul(M(PBR_UVT0 + 1), v0)), M(PBR_UVT0 + 2));
        v = fadd(fadd(fmul(M(PBR_UVT0 + 3), u0), fmul(M(PBR_UVT0 + 4), v0)), M(PBR_UVT0 + 5));
#pragma unroll
        for (int c = 0; c < 4; ++c) duv[c] = G(G_DUV + c);
    }
    const bool nearest = (flags & MF_NEAREST) != 0;
    auto sample = [&](int q, float t[4]) { tex_sample(p, q, __ldg(mt + q), u, v, duv, nearest, t); };

    // albedo
    float albedo[4] = {1.0f, 1.0f, 1.0f, 1.0f};
    if (has(TEX_ALBEDO)) sample(TEX_ALBEDO, albedo);
    if (flags & MF_ALBEDO_BLEND) {
        const bool s = (flags & MF_ALBEDO_VERTEX_SRGB) != 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) albedo[c] = fmul(albedo[c], (s && c < 3) ? srgb_to_scene(vcol[c]) : vcol[c]);
    }
    if (!(flags & MF_ALBEDO_ACTIVE)) {
        albedo[0] = albedo[1] = albedo[2] = 0.0f;
        albedo[3] = 1.0f;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) albedo[c] = fmul(albedo[c], M(PBR_ALBEDO + c));

    // normal
    float normal[3];
    normalize3(nrm, normal);
    if (has(TEX_NORMAL)) {
        float tn[4];
        sample(TEX_NORMAL, tn);
        float nt[3];
        if (flags & MF_BICOMPONENT_NORMAL) {
            const float b0 = fsub(fmul((flags & MF_SWIZZLED_NORMAL) ? tn[3] : tn[0], 2.0f), 1.0f);
            const float b1 = fsub(fmul(tn[1], 2.0f), 1.0f);
            nt[0] = b0;
            nt[1] = b1;
            nt[2] = __fsqrt_rn(clamp_lo(fsub(1.0f, fadd(fmul(b0, b0), fmul(b1, b1))), 0.0f));
        } else {
            float raw[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) raw[c] = fsub(fmul(tn[c], 2.0f), 1.0f);
            normalize3(raw, nt);
        }
        nt[1] = fmul(nt[1], (flags & MF_YDOWN_NORMAL) ? -1.0f : 1.0f);
        float t[3], mapped[3];
        normalize3(tan, t);
        const float bit[3] = {fsub(fmul(normal[1], t[2]), fmul(normal[2], t[1])),
                              fsub(fmul(normal[2], t[0]), fmul(normal[0], t[2])),
                              fsub(fmul(normal[0], t[1]), fmul(normal[1], t[0]))};
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            mapped[c] = fadd(fadd(fmul(t[c], nt[0]), fmul(bit[c], nt[1])), fmul(normal[c], nt[2]));
        }
        normalize3(mapped, normal);
    }

    // AO / metallic / roughness, in the packing the flags name
    const float base_ao = M(PBR_AMBIENT_OCCLUSION), base_rough = M(PBR_ROUGHNESS), base_metal = M(PBR_METALLIC);
    float ao = base_ao, rough = base_rough, metal = base_metal;
    {
        // Only the textures the packing reads are sampled.
        const bool has_r = has(TEX_ROUGHNESS), has_a = has(TEX_AO);
        float t[4];
        if (flags & MF_AOMR_COMBINED) {
            if (has_r) {
                sample(TEX_ROUGHNESS, t);
                ao = fmul(base_ao, t[0]);
                rough = fmul(base_rough, t[1]);
                metal = fmul(base_metal, t[2]);
            }
        } else {
            const bool bw = (flags & MF_AOMR_BW_SPLIT) != 0, swz = (flags & MF_AOMR_SWIZZLED_SPLIT) != 0;
            if (has_r) {
                sample(TEX_ROUGHNESS, t);
                rough = fmul(base_rough, (!bw && swz) ? t[1] : t[0]);
                if (!bw) metal = fmul(base_metal, swz ? t[2] : t[1]);
            }
            if (bw && has(TEX_METALLIC)) {
                sample(TEX_METALLIC, t);
                metal = fmul(base_metal, t[0]);
            }
            if (has_a) {
                sample(TEX_AO, t);
                ao = fmul(base_ao, t[0]);
            }
        }
    }

    // reflectance, clear coat, emissive
    float reflectance = M(PBR_REFLECTANCE);
    if (has(TEX_REFLECTANCE)) {
        float t[4];
        sample(TEX_REFLECTANCE, t);
        reflectance = fmul(reflectance, t[0]);
    }
    float clear_coat = M(PBR_CLEAR_COAT), cc_rough = M(PBR_CLEAR_COAT_ROUGHNESS);
    {
        const bool has_cc = has(TEX_CLEAR_COAT);
        float tc[4] = {1.0f, 1.0f, 1.0f, 1.0f}, t[4];
        if (has_cc) sample(TEX_CLEAR_COAT, tc);
        if (flags & MF_CC_GLTF_COMBINED) {
            if (has_cc) cc_rough = fmul(cc_rough, tc[1]);
        } else if (has(TEX_CLEAR_COAT_ROUGHNESS)) {
            sample(TEX_CLEAR_COAT_ROUGHNESS, t);
            cc_rough = fmul(cc_rough, (flags & MF_CC_GLTF_SPLIT) ? t[1] : t[0]);
        }
        if (has_cc) clear_coat = fmul(clear_coat, tc[0]);
    }
    float color[3] = {M(PBR_EMISSIVE), M(PBR_EMISSIVE + 1), M(PBR_EMISSIVE + 2)};
    if (has(TEX_EMISSIVE)) {
        float t[4];
        sample(TEX_EMISSIVE, t);
#pragma unroll
        for (int c = 0; c < 3; ++c) color[c] = fmul(color[c], t[c]);
    }

    const float one_m = fsub(1.0f, metal);
    const float dielectric = fmul(fmul(reflectance, 0.16f), reflectance);
    float diffuse[3], f0[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        diffuse[c] = fmul(albedo[c], one_m);
        f0[c] = fadd(fmul(albedo[c], metal), fmul(dielectric, one_m));
    }
    const float base_pr = tmax(rough, cc_rough);
    if (clear_coat != 0.0f) rough = fadd(rough, fmul(fsub(base_pr, rough), clear_coat));
    const float roughness = fmul(rough, rough);
    float vdir[3];
    normalize3(vp, vdir);
#pragma unroll
    for (int c = 0; c < 3; ++c) vdir[c] = -vdir[c];

    // directional lights, each with its shadow factor
    float world[3];
    if (p.n_maps > 0) {
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            const float* iv = p.inv_view + r * 4;
            world[r] = fadd(__fmaf_rn(__ldg(iv + 2), vp[2], __fmaf_rn(__ldg(iv), vp[0], fmul(__ldg(iv + 1), vp[1]))),
                            __ldg(iv + 3));
        }
    }
    for (int i = 0; i < p.nl; ++i) {
        float shadow = 1.0f;
        if (p.sv) shadow = __ldg(p.sv + (size_t)i * p.svl + (size_t)y * p.svr + x);
        else if (i < p.n_maps) shadow = map_factor(p, i, world);
        const float l[3] = {__ldg(p.ldir + 3 * i), __ldg(p.ldir + 3 * i + 1), __ldg(p.ldir + 3 * i + 2)};
        const float li[3] = {__ldg(p.lcolor + 3 * i), __ldg(p.lcolor + 3 * i + 1), __ldg(p.lcolor + 3 * i + 2)};
        float contrib[3];
        surface_shading(l, li, normal, f0, roughness, diffuse, vdir, fmul(shadow, ao), contrib);
        const bool on = __ldg(p.lmask + i) != 0;
#pragma unroll
        for (int c = 0; c < 3; ++c) color[c] = fadd(color[c], on ? finite_or_zero(contrib[c]) : 0.0f);
    }
    // point lights
    for (int i = 0; i < p.np; ++i) {
        float delta[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) delta[c] = fsub(__ldg(p.ppos + 3 * i + c), vp[c]);
        const float d = __fsqrt_rn(dot3(delta, delta));
        const float s = saturate(fdiv(d, __ldg(p.pradius + i)));
        const float s2 = fmul(s, s);
        const float inv_s2 = fsub(1.0f, s2);
        const float att = fdiv(fmul(inv_s2, inv_s2), fadd(s2, 1.0f));
        const float dd = d == 0.0f ? 1.0f : d;
        float l[3], li[3], contrib[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            li[c] = fmul(__ldg(p.pcolor + 3 * i + c), att);
            l[c] = fdiv(delta[c], dd);
        }
        surface_shading(l, li, normal, f0, roughness, diffuse, vdir, ao, contrib);
        const bool on = __ldg(p.pmask + i) != 0;
#pragma unroll
        for (int c = 0; c < 3; ++c) color[c] = fadd(color[c], on ? clamp_lo(finite_or_zero(contrib[c]), 0.0f) : 0.0f);
    }

    if (flags & MF_UNLIT) return make_float4(albedo[0], albedo[1], albedo[2], albedo[3]);
    float amb[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) amb[c] = fmul(__ldg(p.ambient + c), albedo[c]);
    return make_float4(tmax(amb[0], color[0]), tmax(amb[1], color[1]), tmax(amb[2], color[2]), tmax(amb[3], albedo[3]));
}

__global__ void __launch_bounds__(256, 4) d1_kernel(const ShadeParams p)
{
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= p.w || y >= p.h) return;
    const float* gp = p.g + (size_t)y * p.gr + x;
    float4 o;
    if (__ldg(gp + (size_t)G_HIT * p.gc) > 0.0f) {
        o = shade(p, gp, x, y);
    } else {
        const float* b = p.bg + (size_t)y * p.bgr + (size_t)x * p.bgc;
        o = make_float4(__ldg(b), __ldg(b + 1), __ldg(b + 2), __ldg(b + 3));
    }
    p.out[(size_t)y * p.w + x] = o;
}

// 32x8 pixels a CTA; compacted pixels (fewer than 8 rows) 256 a CTA row.
dim3 d1_block(int h) { return h >= 8 ? dim3(32, 8) : dim3(256, 1); }


// C1: one cutout depth peel's alpha test (routine/base.py _cutout_sample,
// ops/lighting.py cutout_peel_step) in one launch.
//
// Replaces no Pallas kernel. The JAX frame tests each peel's candidate
// pixels with XLA ops around K4 (rend3_tpu/ops/lighting.py:203-289
// cutout_alpha_pass, the peel loop at rend3_tpu/routine/base.py:1480-1557);
// the port ran about 200 PyTorch ops a peel and two blocking reads: the
// candidates' `nonzero`, a gather of their G-buffer columns, the material
// gathers and texture queries around one K4 launch, a scatter, the count of
// the failed, and three full-frame selects (one over all 25 channels). The
// plain version is that chain (ops/lighting.py cutout_peel_step_plain),
// which the CPU runs.
//
// Per pixel of the peel's (GB_CH, n) G-buffer gc, in the chain's
// expressions:
//   1. candidate = !done & hit & depth > floor, the floor the opaque depth
//      of the loop's start where it hit, else -1 (below every hit's
//      reverse-Z depth), never read from the sample's G-buffer, which an
//      earlier peel may have written;
//   2. a candidate's verdict: a registered cutout routine's where the
//      optional verdict array holds one (1 fails, 2 passes; its Python
//      alpha ran before the launch, ops/lighting.py routine_verdict), else
//      the alpha, albedo_alpha's product: D1's albedo texture alpha
//      (tex_sample: the mip select, fma(uu, rw, -0.5), K4's taps), x the
//      vertex alpha where ALBEDO_BLEND, 1 unless ALBEDO_ACTIVE, x the
//      factor's alpha; it passes where cutoff <= 0 or alpha >= cutoff;
//   3. a passing fragment's 25 channels copied into the sample's G-buffer
//      in place (no other pixel of it is written);
//   4. done = !(candidate & failed); bound = depth where the pixel still
//      searches, else +0;
//   5. the still searching pixels counted: a warp's count, then one atomic
//      add a warp (an integer sum, so the order cannot change it).
// The numerics are D1's (the same functions), so the alpha equals the
// chain's bit for bit; the sRGB powf, where D1 parts from the chain, reads
// only RGB.
//
// What bounds it on the H100: memory. Every pixel reads its depth, hit,
// floor and done flag and writes done and bound (18 bytes);
// a candidate reads 9 more channels (36 bytes) and its texels, a passing one
// reads and writes 25 channels (200 bytes). A 1920x1088 peel with the
// Bistro proxy's foliage is about 40 MB, 0.012 ms at 3.35 TB/s, near the
// launch floor. Design: one thread a pixel, 256 a CTA, every access a 32-bit
// (or byte) lane of a coalesced row, 32 registers, eight CTAs a SM. Four
// pixels a thread, the full-frame reads and writes as float4 and uchar4
// vectors (48 registers, five CTAs a SM), was a third slower: 0.0251 against
// 0.0188 ms on the Bistro proxy's first 1080p peel (H100 80GB HBM3, 700 W,
// timed in turns).

struct CutParams {
    ShadeParams t;         // the material table and, with t.slots bit TEX_ALBEDO, the albedo textures
    const float* gc;       // the peel's G-buffer (GB_CH, n), channel stride n
    float* gbuf;           // the sample's G-buffer (GB_CH, n), written where a fragment passes
    const float* depth_floor;  // (n,) the loop's opaque depth where it hit, else -1
    const uint8_t* done;   // (n,) the pixels no longer searching
    const uint8_t* verdict;  // (n,) or null: a routine's verdict (0 none, 1 fails, 2 passes)
    uint8_t* done_out;     // (n,) written
    float* bound;          // (n,) written
    unsigned* searching;   // one counter, added to
    int n;
};

// cutout_alpha_pass at a candidate pixel i: does its fragment pass?
__device__ __forceinline__ bool alpha_passes(const CutParams& c, int i)
{
    const ShadeParams& p = c.t;
    auto G = [&](int ch) { return __ldg(c.gc + (size_t)ch * c.n + i); };
    const float den = G(G_DEN);
    const float inv = fabsf(den) < 1e-30f ? 1.0f : fmul(fdiv(1.0f, den), 1.0f);
    const long long mraw = (long long)nearbyintf(G(G_MAT));
    const int mi = (int)min(max(mraw, 0LL), (long long)(p.m - 1));
    const float* md = p.mdata + (size_t)mi * PBR_DATA_SIZE;
    auto M = [&](int k) { return __ldg(md + k); };
    const int flags = __ldg(p.mflags + mi);
    float a = 1.0f;
    const int slv = p.slots ? __ldg(p.mtex + (size_t)mi * NSLOT + TEX_ALBEDO) : 0;
    if (slv > 0) {
        const float u0 = fmul(G(G_UV0), inv), v0 = fmul(G(G_UV0 + 1), inv);
        const float u = fadd(fadd(fmul(M(PBR_UVT0), u0), fmul(M(PBR_UVT0 + 1), v0)), M(PBR_UVT0 + 2));
        const float v = fadd(fadd(fmul(M(PBR_UVT0 + 3), u0), fmul(M(PBR_UVT0 + 4), v0)), M(PBR_UVT0 + 5));
        const float duv[4] = {G(G_DUV), G(G_DUV + 1), G(G_DUV + 2), G(G_DUV + 3)};
        float t[4];
        tex_sample(p, TEX_ALBEDO, slv, u, v, duv, (flags & MF_NEAREST) != 0, t);
        a = t[3];
    }
    if (flags & MF_ALBEDO_BLEND) a = fmul(a, fmul(G(G_COL + 3), inv));
    if (!(flags & MF_ALBEDO_ACTIVE)) a = 1.0f;
    a = fmul(a, M(PBR_ALBEDO + 3));
    const float cutoff = M(PBR_ALPHA_CUTOUT);
    return cutoff <= 0.0f || a >= cutoff;
}

// Steps 1-3 at pixel i given its depth and hit: true where it still searches.
__device__ __forceinline__ bool peel_pixel(const CutParams& c, int i, float depth, bool hit, float depth_floor,
                                           bool done)
{
    if (done || !hit || !(depth > depth_floor)) return false;
    const uint8_t v = c.verdict ? __ldg(c.verdict + i) : 0;
    if (v ? v == 1 : !alpha_passes(c, i)) return true;
#pragma unroll 5
    for (int ch = 0; ch < GB_CH; ++ch) c.gbuf[(size_t)ch * c.n + i] = __ldg(c.gc + (size_t)ch * c.n + i);
    return false;
}

// Step 5: lane 0 of each warp adds the warp's count.
__device__ __forceinline__ void count_searching(const CutParams& c, unsigned k)
{
    k = __reduce_add_sync(0xffffffffu, k);
    if ((threadIdx.x & 31) == 0 && k) atomicAdd(c.searching, k);
}

__global__ void __launch_bounds__(256) c1_kernel(const CutParams c)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    bool fail = false;
    if (i < c.n) {
        const float depth = __ldg(c.gc + (size_t)G_DEPTH * c.n + i);
        fail = peel_pixel(c, i, depth, __ldg(c.gc + (size_t)G_HIT * c.n + i) > 0.0f, __ldg(c.depth_floor + i),
                          __ldg(c.done + i) != 0);
        c.done_out[i] = !fail;
        c.bound[i] = fail ? depth : 0.0f;
    }
    count_searching(c, fail);
}

}  // namespace

extern "C" {

// D1 over an (h, w) G-buffer. Device tensors: g, bg, out, mdata, mflags,
// mtex, atlas, rects, mipc, sv, stacked, lvp, inv_res, aoff, asize,
// inv_view, ldir, lcolor, lmask, ppos, pcolor, pradius, pmask, ambient (see
// ShadeParams; atlas, rects, mipc null without a sampled slot, sv null
// unless factors are given, stacked null without maps); then map_ints, a
// host int32 array: per map (kMaxMaps of each) its plan size, first stacked
// row, height and width. Ints: h, w, gc, gr, bgr, bgc, m, ah, aw, s, slots
// (bit q: slot q sampled), svl, svr, hs, ws, nl, np, n_maps. Returns
// cudaGetLastError() after the launch.
int d1_deferred_shade(const void* g, const void* bg, void* out, const void* mdata, const void* mflags,
                      const void* mtex, const void* atlas, const void* rects, const void* mipc, const void* sv,
                      const void* stacked, const void* lvp, const void* inv_res, const void* aoff, const void* asize,
                      const void* inv_view, const void* ldir, const void* lcolor, const void* lmask, const void* ppos,
                      const void* pcolor, const void* pradius, const void* pmask, const void* ambient,
                      const void* map_ints, int h, int w, int gc, int gr, int bgr, int bgc, int m, int ah, int aw,
                      int s, int slots, int svl, int svr, int hs, int ws, int nl, int np, int n_maps, void* stream)
{
    if (h < 0 || w < 0 || m < 1 || nl < 0 || np < 0 || n_maps < 0 || n_maps > kMaxMaps || !map_ints ||
        (slots && (!atlas || s < 1)) || (n_maps && !stacked))
        return (int)cudaErrorInvalidValue;
    if (h == 0 || w == 0) return (int)cudaGetLastError();
    ShadeParams p = {};
    p.g = (const float*)g;
    p.bg = (const float*)bg;
    p.out = (float4*)out;
    p.mdata = (const float*)mdata;
    p.mflags = (const int*)mflags;
    p.mtex = (const int*)mtex;
    p.atlas = (const uint2*)atlas;
    p.rects = (const float*)rects;
    p.mipc = (const int*)mipc;
    p.sv = (const float*)sv;
    p.stacked = (const float*)stacked;
    p.lvp = (const float*)lvp;
    p.inv_res = (const float*)inv_res;
    p.aoff = (const float*)aoff;
    p.asize = (const float*)asize;
    p.inv_view = (const float*)inv_view;
    p.ldir = (const float*)ldir;
    p.lcolor = (const float*)lcolor;
    p.lmask = (const uint8_t*)lmask;
    p.ppos = (const float*)ppos;
    p.pcolor = (const float*)pcolor;
    p.pradius = (const float*)pradius;
    p.pmask = (const uint8_t*)pmask;
    p.ambient = (const float*)ambient;
    p.h = h;
    p.w = w;
    p.gc = gc;
    p.gr = gr;
    p.bgr = bgr;
    p.bgc = bgc;
    p.m = m;
    p.ah = ah;
    p.aw = aw;
    p.s = s;
    p.slots = slots;
    p.svl = svl;
    p.svr = svr;
    p.hs = hs;
    p.ws = ws;
    p.nl = nl;
    p.np = np;
    p.n_maps = n_maps;
    const int* mi = (const int*)map_ints;
    for (int k = 0; k < kMaxMaps; ++k) {
        p.map_size[k] = mi[k];
        p.map_base[k] = mi[kMaxMaps + k];
        p.map_h[k] = mi[2 * kMaxMaps + k];
        p.map_w[k] = mi[3 * kMaxMaps + k];
    }
    const dim3 block = d1_block(h);
    const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
    d1_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

// Registers, spills, shared memory and resident CTAs per SM of d1_kernel.
int d1_kernel_info(int which, void* info)
{
    if (which != 0) return (int)cudaErrorInvalidValue;
    return kernel_info(d1_kernel, 256, 0, (int*)info);
}

// C1 over one peel: n pixels. Device tensors: gc (GB_CH, n) f32, gbuf
// (GB_CH, n) f32, depth_floor (n,) f32, done (n,) u8, done_out (n,) u8, bound
// (n,) f32, searching (1,) u32 (added to), verdict (n,) u8 or null, mdata,
// mflags, mtex (see ShadeParams), then atlas, rects, mipc (null unless the
// albedo slot is sampled). Ints: n, m, ah, aw, s, slots (1: the albedo slot
// sampled, else 0). Returns cudaGetLastError() after the launch.
int c1_cutout_peel(const void* gc, void* gbuf, const void* depth_floor, const void* done, void* done_out,
                   void* bound, void* searching, const void* verdict, const void* mdata, const void* mflags,
                   const void* mtex, const void* atlas, const void* rects, const void* mipc, int n, int m, int ah,
                   int aw, int s, int slots, void* stream)
{
    if (n < 0 || m < 1 || (slots != 0 && slots != 1) || (slots && (!atlas || s < 1)) || !searching)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    CutParams c = {};
    c.t.mdata = (const float*)mdata;
    c.t.mflags = (const int*)mflags;
    c.t.mtex = (const int*)mtex;
    c.t.atlas = (const uint2*)atlas;
    c.t.rects = (const float*)rects;
    c.t.mipc = (const int*)mipc;
    c.t.m = m;
    c.t.ah = ah;
    c.t.aw = aw;
    c.t.s = s;
    c.t.slots = slots << TEX_ALBEDO;
    c.gc = (const float*)gc;
    c.gbuf = (float*)gbuf;
    c.depth_floor = (const float*)depth_floor;
    c.done = (const uint8_t*)done;
    c.verdict = (const uint8_t*)verdict;
    c.done_out = (uint8_t*)done_out;
    c.bound = (float*)bound;
    c.searching = (unsigned*)searching;
    c.n = n;
    c1_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(c);
    return (int)cudaGetLastError();
}

// Registers, spills, shared memory and resident CTAs per SM of c1_kernel.
int c1_kernel_info(int which, void* info)
{
    if (which != 0) return (int)cudaErrorInvalidValue;
    return kernel_info(c1_kernel, 256, 0, (int*)info);
}

}  // extern "C"
