// S1 (shadow setup) and S2 (shadow tile lists): the shadow pass's front end
// on the card, every shadow map of a frame in a few launches.
//
// Replace no Pallas kernel. The JAX shadow program runs its front end as
// XLA ops (rend3_tpu/routine/base.py:554-580: transform.gather_tri_clip,
// clip_triangles, geometry.cull_and_setup and bin_triangles per map); the
// port ran the same chain as some 630 PyTorch ops and 8 blocking reads a
// map. These kernels compute its result for every map at once; the plain
// version, which the CPU runs, is ops/shadow_front.py shadow_front_plain
// (the chain is testing.py shadow_front_chain).
//
// S1, one thread per (map, source triangle) (a CTA row of the grid a map):
//   - the clip-space corners through the object's light-space MVP in the
//     frame's contracted form, fma(m2, p2, fma(m1, p1, m0*p0)) + m3;
//   - the classes of clip_triangles: all in (w > W_EPS and w - z >= 0 at
//     every corner), crossing, or out; a crossing triangle is clipped by
//     Sutherland-Hodgman against w - W_EPS >= 0, then w - z >= 0, in
//     _clip_one_plane's slot order with fma(vj - vi, t, vi) intersections,
//     and fanned as _clip_triangles_full fans;
//   - each candidate (slot 0 the triangle when all in, slots 1-3 the fans)
//     through cull_and_setup's tests (cull FRONT, sub-pixel) and, if it
//     survives, its setup row and bbox in cull_and_setup(contract=True)'s
//     arithmetic; S_ID and src are the slot id 4 t + s (S_ID exact as a
//     float below 2^22 source triangles; K2 does not read it);
//   - the survivors of a CTA are appended to the map's table through one
//     atomicAdd on the map's counter a slot (each warp's count by ballot,
//     their prefix in shared memory), and each survivor adds 1 to the count
//     of every DTILE_H x DTILE_W tile of the padded map that its bbox
//     meets, by bin_triangles' float test;
//   - slot 0 needs registers only; the clipped polygon (local memory) and
//     slots 1-3 run only in CTAs that hold a crossing triangle, which in a
//     shadow map's orthographic light are few.
// S2, the tile lists: one CTA a map scans its tile counts into CSR
// offsets (exclusive, int32, from 0), copies them to the fill cursors and
// writes the map's survivor and pair totals for the host's one read; after
// that read, one thread per (map, survivor) puts its row id into each of
// its tiles' lists at an atomicAdd of the tile's cursor. The tile counts
// and the fill take one atomic a tile for the lanes of a warp on that tile
// (__match_any_sync): neighbouring rows are neighbouring triangles of one
// mesh and meet the same tiles, where atomics would queue on one address.
//
// Numerics: front_end.cuh's (the near clip, the screen transform, the setup
// row and the tile rectangles, shared with the view's V1-V4), so each setup
// row equals the chain's bit for bit. Only the order of the rows, and of
// the ids within a tile's list, differs (atomics). K2 cannot see either:
// its result is a per-texel max (raster.cu), so the maps equal the chain's
// bit for bit. The view's K1 can see the order (its later-entry
// tie-break), so V1-V4 (view_front.cu) place the view's rows by scans.
//
// What bounds them on the H100: neither bytes nor operations. S1 reads 40
// bytes a (map, triangle) and writes 89 a survivor (setup row, bbox, src,
// flip), a few hundred f32 operations; 2M triangles and two maps are
// about 0.2 GB, 0.06 ms at 3.35 TB/s. What the design removes is the
// host's cost: the chain's ~1,260 launches and 16 stream drains a pass
// become S1, the scan, one read and the fill (plus K2), and no
// intermediate table (clip corners, masks, compacted copies) is written.

#include <cuda_runtime.h>
#include <stdint.h>

#include "front_end.cuh"
#include "kernel_info.cuh"

namespace {

using namespace front_end;

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kMaxMaps = 4;  // maps a launch; the wrapper launches once a group

struct Maps {
    int n;                    // maps of this launch
    int first;                // global index of the first
    int size[kMaxMaps];       // the map's side in texels
    int tile_base[kMaxMaps];  // its first tile in the tile arrays (all maps')
    int pair_base[kMaxMaps];  // its first entry in the ids buffer (fill only)

    // Entry i of an array above with constant indices only: a kernel
    // parameter indexed at run time would be copied to local memory.
    __device__ static int pick(const int (&a)[kMaxMaps], int i)
    {
        return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
    }
};

struct S1Params {
    const float* tri_pos;      // (T, 3, 3)
    const int* tri_obj;        // (T,)
    const float* mvp;          // (L, O, 4, 4) light-space MVP per object
    const uint8_t* vis;        // (Lv, Ov) bool: object visible to the map's light
    float* setup;              // (L, cap, 16)
    float4* bbox;              // (L, cap) xmin, ymin, xmax, ymax
    long long* src;            // (L, cap)
    uint8_t* flip;             // (L, cap) bool
    int* surv;                 // (L,) survivors (may pass cap: the host checks)
    int* tiles;                // tile counts, all maps
    int T, O, Ov, cap, front_is_cw;
    Maps maps;
};

__device__ __forceinline__ int n_cols(int size) { return (size + TILE_W - 1) / TILE_W; }
__device__ __forceinline__ int n_rows(int size) { return (size + TILE_H - 1) / TILE_H; }

// Every DTILE_H x DTILE_W tile of the padded size x size map that each
// lane's bbox meets (none where live is false), a round a tile: f(tile,
// group) on every lane of the warp each round, tile -1 for a lane with no
// tile left, group the lanes on the same tile this round (__match_any_sync),
// so that one atomic serves them. All 32 lanes call it.
template <typename F>
__device__ __forceinline__ void warp_tiles(bool live, float4 bb, int size, F&& f)
{
    const int nc = n_cols(size);
    const int4 rc = live ? tile_rect(bb, nc, n_rows(size), 0) : make_int4(0, 0, -1, -1);
    const int w = rc.z - rc.x + 1;
    const int mine = rect_size(rc);
    int most = mine;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) most = max(most, __shfl_xor_sync(FULL, most, d));
    for (int k = 0; k < most; ++k) {
        const int tile = k < mine ? (rc.y + k / w) * nc + rc.x + k % w : -1;
        f(tile, __match_any_sync(FULL, tile));
    }
}

// cull_and_setup(cull_mode=FRONT, subpixel=True, contract=True) on one
// clipped triangle c of a size x size map: whether it survives, and if so
// its setup row (S_ID left to the caller) and bbox.
__device__ bool caster_row(const float (&c)[3][4], float fsize, bool front_is_cw, float* row, float4& bb,
                           bool& flip)
{
    Screen s;
    to_screen(c, fsize, fsize, s);
    bb = s.bb;
    const bool is_front = front_is_cw ? s.area2 > 0.0f : s.area2 < 0.0f;
    const bool keep = s.area2 != 0.0f && s.wpos && !is_front && bb.z > 0.0f && bb.x < fsize && bb.w > 0.0f &&
                      bb.y < fsize && holds_centre(bb);
    if (keep) setup_row(s, fsize, row, flip);
    return keep;
}

// The survivors of one slot of the CTA take one atomicAdd on the map's
// counter: each warp's count by ballot, thread 0's prefix and add. Every
// thread of the CTA calls it; returns this thread's row (if keep).
__device__ __forceinline__ int append(bool keep, int* counter, int* warp_base)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned mask = __ballot_sync(FULL, keep);
    if (lane == 0) warp_base[warp] = __popc(mask);
    __syncthreads();
    if (threadIdx.x == 0) {
        int total = 0;
#pragma unroll
        for (int w = 0; w < kThreads / 32; ++w) {
            const int k = warp_base[w];
            warp_base[w] = total;
            total += k;
        }
        const int base = total > 0 ? atomicAdd(counter, total) : 0;
#pragma unroll
        for (int w = 0; w < kThreads / 32; ++w) warp_base[w] += base;
    }
    __syncthreads();
    const int v = warp_base[warp] + __popc(mask & ((1u << lane) - 1));
    __syncthreads();  // warp_base is rewritten by the next slot
    return v;
}

// Row v of map m's table: the setup row (S_ID = id), bbox, src and flip.
__device__ __forceinline__ void put_row(const S1Params& p, int m, int v, long long id, float (&row)[SETUP_W],
                                        float4 bb, bool flip)
{
    row[S_ID] = (float)id;
    float4* dst = reinterpret_cast<float4*>(p.setup + ((size_t)m * p.cap + v) * SETUP_W);
#pragma unroll
    for (int q = 0; q < SETUP_W / 4; ++q) {
        dst[q] = make_float4(row[4 * q], row[4 * q + 1], row[4 * q + 2], row[4 * q + 3]);
    }
    const size_t at = (size_t)m * p.cap + v;
    p.bbox[at] = bb;
    p.src[at] = id;
    p.flip[at] = flip;
}

// Each survivor of the warp (live) adds 1 to the count of every tile its
// bbox meets, one atomicAdd a tile and round for the lanes on it.
__device__ __forceinline__ void count_tiles(bool live, float4 bb, int size, int* tiles)
{
    const int lane = threadIdx.x & 31;
    warp_tiles(live, bb, size, [&](int tile, unsigned group) {
        if (tile >= 0 && lane == __ffs(group) - 1) atomicAdd(tiles + tile, __popc(group));
    });
}

__global__ void __launch_bounds__(kThreads) s1_kernel(S1Params p)
{
    __shared__ int warp_base[kThreads / 32];
    const int mi = blockIdx.y;
    const int m = p.maps.first + mi;
    const int size = Maps::pick(p.maps.size, mi);
    const float fsize = (float)size;
    int* tiles = p.tiles + Maps::pick(p.maps.tile_base, mi);
    const bool cw = p.front_is_cw != 0;
    const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;

    float c[3][4] = {};
    bool all_in = false, crossing = false;
    if (t < p.T) {
        const int obj = __ldg(p.tri_obj + t);
        // As the JAX shadow program: a triangle of no object casts nothing.
        const bool valid = obj >= 0 && obj < p.Ov && obj < p.O && __ldg(p.vis + (size_t)m * p.Ov + obj) != 0;
        if (valid) {
            const float* M = p.mvp + ((size_t)m * p.O + obj) * 16;
            float mm[16];
#pragma unroll
            for (int k = 0; k < 16; ++k) mm[k] = __ldg(M + k);
            const float* P = p.tri_pos + (size_t)t * 9;
            bool any_in = false;
            all_in = true;
#pragma unroll
            for (int i = 0; i < 3; ++i) {
                const float p0 = __ldg(P + 3 * i), p1 = __ldg(P + 3 * i + 1), p2 = __ldg(P + 3 * i + 2);
#pragma unroll
                for (int a = 0; a < 4; ++a) {
                    const float* r = mm + 4 * a;
                    c[i][a] = __fadd_rn(dot3(r[0], p0, r[1], p1, r[2], p2), r[3]);
                }
                const bool in = __fsub_rn(c[i][3], c[i][2]) >= 0.0f && c[i][3] > W_EPS;
                any_in = any_in || in;
                all_in = all_in && in;
            }
            crossing = any_in && !all_in;
        }
    }

    {  // Slot 0: the triangle itself, when all in.
        float row[SETUP_W];
        float4 bb;
        bool flip = false;
        const bool keep = all_in && caster_row(c, fsize, cw, row, bb, flip);
        const int v = append(keep, p.surv + m, warp_base);
        if (keep && v < p.cap) put_row(p, m, v, 4 * t, row, bb, flip);
        count_tiles(keep && v < p.cap, bb, size, tiles);
    }
    // Slots 1-3, fan k of the clipped polygon (poly[0], poly[k + 1],
    // poly[k + 2]): only in CTAs that hold a crossing triangle.
    if (!__syncthreads_or(crossing)) return;
    float poly[5][4];
    int n = 0;
    if (crossing) {
        float v[5][4] = {};
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int a = 0; a < 4; ++a) v[i][a] = c[i][a];
        int n1;
        clip_plane<0>(v, 3, poly, n1);
        clip_plane<1>(poly, n1, v, n);
#pragma unroll
        for (int i = 0; i < 5; ++i)
#pragma unroll
            for (int a = 0; a < 4; ++a) poly[i][a] = v[i][a];
    }
#pragma unroll 1
    for (int s = 1; s < 4; ++s) {
        const bool cand = crossing && n >= s + 2;
        float tri[3][4];
        if (cand) {
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                tri[0][a] = poly[0][a];
                tri[1][a] = poly[s][a];
                tri[2][a] = poly[s + 1][a];
            }
        }
        float row[SETUP_W];
        float4 bb;
        bool flip = false;
        const bool keep = cand && caster_row(tri, fsize, cw, row, bb, flip);
        const int v = append(keep, p.surv + m, warp_base);
        if (keep && v < p.cap) put_row(p, m, v, 4 * t + s, row, bb, flip);
        count_tiles(keep && v < p.cap, bb, size, tiles);
    }
}

struct ScanParams {
    const int* surv;   // (L,)
    const int* tiles;  // tile counts, all maps
    int* offsets;      // per map n_tiles + 1, at tile_base + map index
    int* cursor;       // fill cursors, as tiles
    int* totals;       // (2 L): survivors, then pairs, a map
    int L;
    Maps maps;
};

// One CTA a map: its exclusive scan, 1,024 tiles a round.
__global__ void __launch_bounds__(kScanThreads) scan_kernel(ScanParams p)
{
    __shared__ int warp_sum[kScanThreads / 32];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    {
        const int mi = blockIdx.x;
        const int m = p.maps.first + mi;
        const int size = Maps::pick(p.maps.size, mi);
        const int nt = n_cols(size) * n_rows(size);
        const int tb = Maps::pick(p.maps.tile_base, mi);
        int* offs = p.offsets + tb + m;
        int carry = 0;
        for (int base = 0; base < nt; base += kScanThreads) {
            const int i = base + tid;
            const int v = i < nt ? p.tiles[tb + i] : 0;
            int x = v;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int y = __shfl_up_sync(FULL, x, d);
                if (lane >= d) x += y;
            }
            if (lane == 31) warp_sum[warp] = x;
            __syncthreads();
            if (warp == 0) {
                int s = warp_sum[lane];
#pragma unroll
                for (int d = 1; d < 32; d <<= 1) {
                    const int y = __shfl_up_sync(FULL, s, d);
                    if (lane >= d) s += y;
                }
                warp_sum[lane] = s;
            }
            __syncthreads();
            const int excl = carry + x - v + (warp > 0 ? warp_sum[warp - 1] : 0);
            if (i < nt) {
                offs[i] = excl;
                p.cursor[tb + i] = excl;
            }
            carry += warp_sum[kScanThreads / 32 - 1];
            __syncthreads();
        }
        if (tid == 0) {
            offs[nt] = carry;
            p.totals[m] = p.surv[m];
            p.totals[p.L + m] = carry;
        }
    }
}

struct FillParams {
    const float4* bbox;  // (L, cap)
    const int* surv;     // (L,)
    int* cursor;         // as scan_kernel's
    int* ids;            // every map's lists, map m's from pair_base
    int cap;
    Maps maps;
};

__global__ void __launch_bounds__(kThreads) fill_kernel(FillParams p)
{
    const int mi = blockIdx.y;
    const int m = p.maps.first + mi;
    const int v = blockIdx.x * kThreads + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const int n = min(p.surv[m], p.cap);
    if (v - lane >= n) return;  // the whole warp past the table
    const bool live = v < n;
    const float4 bb = live ? p.bbox[(size_t)m * p.cap + v] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int* cursor = p.cursor + Maps::pick(p.maps.tile_base, mi);
    int* ids = p.ids + Maps::pick(p.maps.pair_base, mi);
    // The lanes on one tile take consecutive places from one atomicAdd.
    warp_tiles(live, bb, Maps::pick(p.maps.size, mi), [&](int tile, unsigned group) {
        const int leader = __ffs(group) - 1;
        int base = 0;
        if (tile >= 0 && lane == leader) base = atomicAdd(cursor + tile, __popc(group));
        base = __shfl_sync(FULL, base, leader);
        if (tile >= 0) ids[base + __popc(group & ((1u << lane) - 1))] = v;
    });
}

Maps make_maps(int n, int first, const int* size, const int* tile_base, const int* pair_base)
{
    Maps m = {};
    m.n = n;
    m.first = first;
    for (int i = 0; i < kMaxMaps; ++i) {
        m.size[i] = size[i];
        m.tile_base[i] = tile_base[i];
        m.pair_base[i] = pair_base ? pair_base[i] : 0;
    }
    return m;
}

bool bad_maps(int n, const int* size)
{
    if (n < 1 || n > kMaxMaps) return true;
    for (int i = 0; i < n; ++i)
        if (size[i] < 1) return true;
    return false;
}

}  // namespace

extern "C" {

// S1 for maps first .. first + n - 1 (n <= 4): tri_pos (T, 3, 3) f32,
// tri_obj (T,) int32, mvp (L, O, 4, 4) f32, vis (Lv, Ov) bool; out: setup
// (L, cap, 16) f32, bbox (L, cap, 4) f32 (16-byte aligned), src (L, cap)
// int64, flip (L, cap) bool, surv (L,) int32 and tiles (the tile counts,
// map i's DTILE_H x DTILE_W tiles of its padded s_i x s_i map from
// tile base b_i, row-major), both zeroed by the caller and added to here.
int s1_shadow_setup(const void* tri_pos, const void* tri_obj, const void* mvp, const void* vis, void* setup,
                    void* bbox, void* src, void* flip, void* surv, void* tiles, int T, int O, int Ov, int cap,
                    int front_is_cw, int n, int first, int s0, int s1, int s2, int s3, int b0, int b1, int b2,
                    int b3, void* stream)
{
    const int size[kMaxMaps] = {s0, s1, s2, s3}, tile_base[kMaxMaps] = {b0, b1, b2, b3};
    if (bad_maps(n, size) || T < 0 || O < 1 || cap < 0) return (int)cudaErrorInvalidValue;
    if (T == 0) return (int)cudaGetLastError();
    S1Params p;
    p.tri_pos = (const float*)tri_pos;
    p.tri_obj = (const int*)tri_obj;
    p.mvp = (const float*)mvp;
    p.vis = (const uint8_t*)vis;
    p.setup = (float*)setup;
    p.bbox = (float4*)bbox;
    p.src = (long long*)src;
    p.flip = (uint8_t*)flip;
    p.surv = (int*)surv;
    p.tiles = (int*)tiles;
    p.T = T;
    p.O = O;
    p.Ov = Ov;
    p.cap = cap;
    p.front_is_cw = front_is_cw;
    p.maps = make_maps(n, first, size, tile_base, nullptr);
    const dim3 grid((unsigned)((T + kThreads - 1) / kThreads), (unsigned)n);
    s1_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

// S2's scan for maps first .. first + n - 1: offsets (map i's n_tiles + 1
// int32 from tile base b_i + first + i), cursor (as the tile counts), and
// totals (2 L int32: each map's survivors at its index, its pairs at L +
// its index).
int s2_tile_scan(const void* surv, const void* tiles, void* offsets, void* cursor, void* totals, int L, int n,
                 int first, int s0, int s1, int s2, int s3, int b0, int b1, int b2, int b3, void* stream)
{
    const int size[kMaxMaps] = {s0, s1, s2, s3}, tile_base[kMaxMaps] = {b0, b1, b2, b3};
    if (bad_maps(n, size) || first + n > L) return (int)cudaErrorInvalidValue;
    ScanParams p;
    p.surv = (const int*)surv;
    p.tiles = (const int*)tiles;
    p.offsets = (int*)offsets;
    p.cursor = (int*)cursor;
    p.totals = (int*)totals;
    p.L = L;
    p.maps = make_maps(n, first, size, tile_base, nullptr);
    scan_kernel<<<n, kScanThreads, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

// S2's fill for maps first .. first + n - 1: each survivor's row id into
// its tiles' lists, map i's at ids + p_i; rows: the most survivors of
// these maps (the grid), cap as S1's.
int s2_tile_fill(const void* bbox, const void* surv, void* cursor, void* ids, int cap, int rows, int n, int first,
                 int s0, int s1, int s2, int s3, int b0, int b1, int b2, int b3, int p0, int p1, int p2, int p3,
                 void* stream)
{
    const int size[kMaxMaps] = {s0, s1, s2, s3}, tile_base[kMaxMaps] = {b0, b1, b2, b3};
    const int pair_base[kMaxMaps] = {p0, p1, p2, p3};
    if (bad_maps(n, size) || rows < 0) return (int)cudaErrorInvalidValue;
    if (rows == 0) return (int)cudaGetLastError();
    FillParams p;
    p.bbox = (const float4*)bbox;
    p.surv = (const int*)surv;
    p.cursor = (int*)cursor;
    p.ids = (int*)ids;
    p.cap = cap;
    p.maps = make_maps(n, first, size, tile_base, pair_base);
    const dim3 grid((unsigned)((rows + kThreads - 1) / kThreads), (unsigned)n);
    fill_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

// Registers, spills, shared memory and resident CTAs per SM of instance
// `which`: 0 S1 s1_kernel, 1 S2 scan_kernel, 2 S2 fill_kernel.
int shadow_front_kernel_info(int which, void* info)
{
    int* i = (int*)info;
    switch (which) {
        case 0: return kernel_info(s1_kernel, kThreads, 0, i);
        case 1: return kernel_info(scan_kernel, kScanThreads, 0, i);
        case 2: return kernel_info(fill_kernel, kThreads, 0, i);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
