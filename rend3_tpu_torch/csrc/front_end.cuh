// The triangle front end's arithmetic on the card, shared by shadow_front.cu
// (S1 / S2, the shadow maps) and view_front.cu (V1-V4, the view): the near
// clip, the screen transform and setup row of geometry.cull_and_setup and
// the tile rectangles of geometry.bin_triangles, in the frame's contracted
// forms. Every product, sum and fma is an _rn intrinsic (the library is
// built with --fmad=false), so each value equals the PyTorch chain's bit
// for bit; 1/x is the IEEE quotient (__frcp_rn), as PyTorch's reciprocal.
// Everything here has internal linkage: each source instantiates its own.

#pragma once

#include <cuda_runtime.h>

namespace {
namespace front_end {

constexpr int SETUP_W = 16;
constexpr int S_ID = 13;
constexpr int TILE_H = 32;   // deferred.DTILE_H
constexpr int TILE_W = 128;  // deferred.DTILE_W
constexpr float W_EPS = 1e-6f;
constexpr unsigned FULL = 0xffffffffu;

// torch.amin / amax / minimum / maximum: a NaN wins.
__device__ __forceinline__ float nmin(float a, float b) { return (a != a || a < b) ? a : b; }
__device__ __forceinline__ float nmax(float a, float b) { return (a != a || a > b) ? a : b; }

// fma(a, b, -(c*d)): ops/fp.py ab_minus_cd.
__device__ __forceinline__ float ab_minus_cd(float a, float b, float c, float d)
{
    return __fmaf_rn(a, b, -__fmul_rn(c, d));
}

// fma(a2, b2, fma(a1, b1, a0*b0)): ops/fp.py dot3.
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2, float b2)
{
    return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmul_rn(a0, b0)));
}

// One Sutherland-Hodgman step of transform._clip_one_plane: polygon v (n
// <= 4 corners in 5 slots, C columns: the clip corner first, then any
// values carried along) against d >= 0, d = w - W_EPS (PLANE 0) or w - z
// (PLANE 1); every column of a crossing point is fma(vj - vi, t, vi).
template <int PLANE, int C>
__device__ void clip_plane(const float (&v)[5][C], int n, float (&o)[5][C], int& on)
{
    float d[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) d[i] = PLANE == 0 ? __fsub_rn(v[i][3], W_EPS) : __fsub_rn(v[i][3], v[i][2]);
#pragma unroll
    for (int i = 0; i < 5; ++i)
#pragma unroll
        for (int a = 0; a < C; ++a) o[i][a] = 0.0f;
    on = 0;
    for (int i = 0; i < 4; ++i) {
        if (i >= n) break;
        const int j = i + 1 >= n ? 0 : i + 1;
        const float di = d[i], dj = d[j];
        const bool ini = di >= 0.0f, inj = dj >= 0.0f;
        if (ini) {
#pragma unroll
            for (int a = 0; a < C; ++a) o[on][a] = v[i][a];
            ++on;
        }
        if (ini != inj) {
            const float den = __fsub_rn(di, dj);
            const float t = __fdiv_rn(di, fabsf(den) < 1e-30f ? 1e-30f : den);
#pragma unroll
            for (int a = 0; a < C; ++a) o[on][a] = __fmaf_rn(__fsub_rn(v[j][a], v[i][a]), t, v[i][a]);
            ++on;
        }
    }
}

// A clipped triangle in screen space (geometry._screen_tests): pixel x, y,
// depth z and the pre-scale yp of each corner, the doubled signed area and
// the bbox (xmin, ymin, xmax, ymax); wpos: every w > 0.
struct Screen {
    float x[3], y[3], z[3], yp[3];
    float area2;
    float4 bb;
    bool wpos;
};

__device__ __forceinline__ void to_screen(const float (&c)[3][4], float fw, float fh, Screen& s)
{
    s.wpos = true;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const float w = c[i][3];
        s.wpos = s.wpos && w > 0.0f;
        const float inv_w = __frcp_rn(w == 0.0f ? 1.0f : w);
        s.x[i] = __fmul_rn(__fadd_rn(__fmul_rn(__fmul_rn(c[i][0], inv_w), 0.5f), 0.5f), fw);
        s.yp[i] = __fsub_rn(0.5f, __fmul_rn(__fmul_rn(c[i][1], inv_w), 0.5f));
        s.y[i] = __fmul_rn(s.yp[i], fh);
        s.z[i] = __fmul_rn(c[i][2], inv_w);
    }
    s.area2 = ab_minus_cd(__fsub_rn(s.x[1], s.x[0]), __fsub_rn(s.y[2], s.y[0]), __fsub_rn(s.x[2], s.x[0]),
                          __fsub_rn(s.y[1], s.y[0]));
    s.bb.x = nmin(nmin(s.x[0], s.x[1]), s.x[2]);
    s.bb.y = nmin(nmin(s.y[0], s.y[1]), s.y[2]);
    s.bb.z = nmax(nmax(s.x[0], s.x[1]), s.x[2]);
    s.bb.w = nmax(nmax(s.y[0], s.y[1]), s.y[2]);
}

// Sub-pixel cull (cull.wgsl:221-236): whether the bbox holds a pixel centre.
__device__ __forceinline__ bool holds_centre(float4 bb)
{
    return __fadd_rn(floorf(__fsub_rn(bb.x, 0.5f)), 1.5f) <= bb.z &&
           __fadd_rn(floorf(__fsub_rn(bb.y, 0.5f)), 1.5f) <= bb.w;
}

// The setup row of a survivor (cull_and_setup(contract=True)) and its
// orientation flip; S_ID is left to the caller.
__device__ void setup_row(const Screen& s, float fh, float* row, bool& flip)
{
    flip = s.area2 < 0.0f;
    // Corners 1 and 2 swapped where flip (orientation fix).
    const float xo[3] = {s.x[0], flip ? s.x[2] : s.x[1], flip ? s.x[1] : s.x[2]};
    const float yo[3] = {s.y[0], flip ? s.y[2] : s.y[1], flip ? s.y[1] : s.y[2]};
    const float zo[3] = {s.z[0], flip ? s.z[2] : s.z[1], flip ? s.z[1] : s.z[2]};
    const float ypo[3] = {s.yp[0], flip ? s.yp[2] : s.yp[1], flip ? s.yp[1] : s.yp[2]};
    float ea[3], eb[3], ec[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const int n = (i + 1) % 3;
        const float xn = xo[n], yn = yo[n];
        const float dy = __fsub_rn(yn, yo[i]);
        ea[i] = -dy;
        eb[i] = __fsub_rn(xn, xo[i]);
        ec[i] = ab_minus_cd(dy, xo[i], eb[i], yo[i]);
        row[i] = __fmaf_rn(ypo[i], fh, -yn);  // the stored a: yo's product fused in
        row[3 + i] = eb[i];
        // Watertight shared edges: c anchored at the lexicographically
        // smaller endpoint (geometry.py:226-239).
        const bool swap = xn < xo[i] || (xn == xo[i] && yn < yo[i]);
        const float lx = swap ? xn : xo[i], hx = swap ? xo[i] : xn;
        const float ly = swap ? yn : yo[i], hy = swap ? yo[i] : yn;
        const float cc = ab_minus_cd(__fsub_rn(hy, ly), lx, __fsub_rn(hx, lx), ly);
        row[6 + i] = swap ? -cc : cc;
        // Top-left flags: edge 0 at 12, edges 1 and 2 at 14 and 15.
        row[i == 0 ? 12 : 13 + i] = ((dy == 0.0f && eb[i] > 0.0f) || dy < 0.0f) ? 1.0f : 0.0f;
    }
    // Depth plane: z(p) = sum_i z_i * e_opp_i(p) / area, each sum
    // fma(z2, e0, fma(z1, e2, z0 * e1)).
    const float area_o = ab_minus_cd(__fsub_rn(xo[1], xo[0]), __fsub_rn(yo[2], yo[0]), __fsub_rn(xo[2], xo[0]),
                                     __fsub_rn(yo[1], yo[0]));
    const float inv_area = __frcp_rn(area_o == 0.0f ? 1.0f : area_o);
    row[9] = __fmul_rn(dot3(zo[0], ea[1], zo[1], ea[2], zo[2], ea[0]), inv_area);
    row[10] = __fmul_rn(dot3(zo[0], eb[1], zo[1], eb[2], zo[2], eb[0]), inv_area);
    row[11] = __fmul_rn(dot3(zo[0], ec[1], zo[1], ec[2], zo[2], ec[0]), inv_area);
}

// bin_triangles' candidate span of one axis, [lo_t, hi_t] clamped to the
// n tiles; the exact test decides within it.
__device__ __forceinline__ void span(float lo, float hi, float tile, int n, int& a, int& b)
{
    const float fa = fminf(fmaxf(floorf(__fdiv_rn(lo, tile)), -1.0f), (float)n);
    const float fb = fminf(fmaxf(floorf(__fdiv_rn(hi, tile)), -1.0f), (float)n);
    a = min(max((int)fa - 1, 0), n - 1);
    b = min(max((int)fb + 1, 0), n - 1);
}

// The tiles [lo, hi] along one axis (n tiles of `tile` pixels from `org`)
// that the bbox's [bmin, bmax] meets by bin_triangles' float test, bmax >
// t0 and bmin < t0 + tile, t0 = i * tile + org (hi < lo if none); the
// candidates come from [bmin, bmax] - org. The test is monotone in i, so
// the tiles a bbox meets form a rectangle.
__device__ __forceinline__ void axis_hits(float bmin, float bmax, int tile, int n, float org, int& lo, int& hi)
{
    int a, b;
    span(__fsub_rn(bmin, org), __fsub_rn(bmax, org), (float)tile, n, a, b);
    lo = b + 1;
    hi = a - 1;
    for (int i = a; i <= b; ++i) {
        const float t0 = __fadd_rn((float)(i * tile), org);
        if (bmax > t0 && bmin < __fadd_rn(t0, (float)tile)) {
            lo = min(lo, i);
            hi = max(hi, i);
        }
    }
}

// The rectangle of DTILE_H x DTILE_W tiles (c0, r0, c1, r1) a bbox meets on
// a grid of n_cols x n_rows tiles whose first row is target row y0; empty
// (c1 < c0 or r1 < r0) when none.
__device__ __forceinline__ int4 tile_rect(float4 bb, int n_cols, int n_rows, int y0)
{
    int4 r;
    axis_hits(bb.x, bb.z, TILE_W, n_cols, 0.0f, r.x, r.z);
    axis_hits(bb.y, bb.w, TILE_H, n_rows, (float)y0, r.y, r.w);
    return r;
}

__device__ __forceinline__ int rect_size(int4 r)
{
    return r.z >= r.x && r.w >= r.y ? (r.z - r.x + 1) * (r.w - r.y + 1) : 0;
}

}  // namespace front_end
}  // namespace
