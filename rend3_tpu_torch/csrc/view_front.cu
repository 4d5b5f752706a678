// V1-V4, the view's triangle front end on the card: the clipped table, the
// cull and setup rows, the attribute planes and the tile lists of a
// triangle set in a few launches and one or two host reads.
//
// Replace no Pallas kernel. The JAX frame runs its front end as XLA ops
// (rend3_tpu/ops/transform.py gather_tri_clip and clip_triangles,
// geometry.py cull_and_setup and bin_triangles, deferred.py
// attribute_planes); the port ran the same chain as some 150 PyTorch ops
// and up to 16 blocking calls a call site (main, residual, cutout, blend:
// 7 reads, 9 tensors made from Python values).
// These kernels compute its result bit for bit and in its order: K1 breaks
// depth ties by the order of a tile's list, so every row and list entry is
// placed by a scan, never by an atomic. The plain version is
// ops/view_front.py (clip_plain, cull_plain, planes_plain, tiles_plain),
// which the CPU runs.
//
// V1, the clipped table (clip_triangles' rows): the T source rows, then
// fan 0 of every near-plane-crossing triangle, then fan 1, then fan 2.
//   - count: one thread a triangle (four in turns, a CTA's block of 1,024
//     rows): the clip transform fma(m2, p2, fma(m1, p1, m0*p0)) + m3 of
//     gather_tri_clip(contract=True), clip_triangles' classes; each block's
//     crossing count, and the last block to finish scans them into bases and
//     the total, which the host reads to size the table;
//   - fill: the same threads write their source rows and, at the block's
//     base plus their rank in the block, their fans: Sutherland-Hodgman
//     against w - W_EPS >= 0, then w - z >= 0, corners and barycentrics
//     through fma(vj - vi, t, vi), fanned as _clip_triangles_full fans.
// V2, the cull and setup rows (cull_and_setup(contract=True)):
//   - cull: one thread a clipped row (four in turns, blocks of 1,024): the
//     degenerate, winding (BACK / FRONT), viewport (a band's rows), sub-pixel
//     and Hi-Z tests; a keep flag a row, the survivors of each block, and
//     each block's count of survivors in each DTILE_H x DTILE_W tile
//     (bin_triangles' candidate span and float test), its row of a
//     (block, tile) table;
//   - scan: a CTA a tile scans its column (the block's first place in the
//     tile's list), one more the blocks' survivor counts (each block's
//     first row), and the last to finish the tiles' totals into the CSR
//     offsets, the survivor and pair totals: the host's one read;
//   - setup: each survivor's row at its block's first row plus its rank in
//     the block, in ascending clipped-row order (nonzero's), as
//     cull_and_setup computes it; S_ID and src the clipped row.
// V3, the attribute planes: one thread a survivor, the arithmetic of
//   attribute_planes(contract=True) (fma forms, dot3's order, IEEE sqrt
//   and division).
// V4, the tile lists: a warp a block of V2 (its row of the table staged in
//   shared memory) walks its survivors in order, the 32 of a round over
//   their distinct tiles in increasing id: each survivor's id goes into
//   each of its tiles' lists at the tile's offset + the block's first place
//   in it + the survivors of the block before it in that tile. Each tile's
//   list ascends, as the chain's stable sort gives it.
//
// Numerics: front_end.cuh's, shared with S1 / S2, so every row equals the
// chain's bit for bit; the Hi-Z level takes logf, as PyTorch's log on the
// card does.
//
// What bounds them on the H100: neither bytes nor operations. V1 reads 52
// bytes a triangle and writes 97 a row; V2 reads 49 a row and writes 89 a
// survivor; V3 reads about 300 a survivor and writes 256; 2M triangles are
// about 0.5 GB, 0.15 ms at 3.35 TB/s. What the design removes is the host's
// cost: the chain's ~150 launches and up to 16 stream drains a call site
// become seven launches and one or two reads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "front_end.cuh"
#include "kernel_info.cuh"

namespace {

using namespace front_end;

constexpr int kThreads = 256;
constexpr int kTurns = 4;                      // rows a thread, in turns
constexpr int kBlock = kThreads * kTurns;      // rows a CTA
constexpr int kScanThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int PLANES_W = 64;
constexpr int P_MAT = 54;
constexpr int kMaxLevels = 12;                 // hi_z.build_pyramid's max_levels
constexpr int kAttrs = 6;                      // the object table's attribute bases

// The last CTA of V1's count (0) and of V2's scan (1) finds itself by its
// counter here and puts it back to zero (zero when the library loads).
__device__ int g_tickets[2];

// Exclusive prefix of `flag` over the CTA's threads in thread order, and
// the CTA's count; every thread calls it.
__device__ __forceinline__ int cta_prefix(bool flag, int* sh, int& total)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned m = __ballot_sync(FULL, flag);
    if (lane == 0) sh[warp] = __popc(m);
    __syncthreads();
    int before = 0;
    total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        const int c = sh[w];
        before += w < warp ? c : 0;
        total += c;
    }
    __syncthreads();
    return before + __popc(m & ((1u << lane) - 1));
}

// Exclusive scan of n ints, in[k * stride], by one CTA of NT threads into
// out[k * stride] (in may alias out); returns the total on every thread.
// `sh` holds NT / 32 ints. Reads through L2 (ld.cg): the values may come
// from other CTAs of this launch.
template <int NT>
__device__ int cta_scan(const int* in, int* out, int n, int* sh, int stride = 1)
{
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    int carry = 0;
    for (int base = 0; base < n; base += NT) {
        const int i = base + tid;
        const int v = i < n ? __ldcg(in + (size_t)i * stride) : 0;
        int x = v;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(FULL, x, d);
            if (lane >= d) x += y;
        }
        if (lane == 31) sh[warp] = x;
        __syncthreads();
        if (warp == 0) {
            int s = lane < NT / 32 ? sh[lane] : 0;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int y = __shfl_up_sync(FULL, s, d);
                if (lane >= d) s += y;
            }
            if (lane < NT / 32) sh[lane] = s;
        }
        __syncthreads();
        const int excl = carry + x - v + (warp > 0 ? sh[warp - 1] : 0);
        if (i < n) out[(size_t)i * stride] = excl;
        carry += sh[NT / 32 - 1];
        __syncthreads();
    }
    return carry;
}

// Whether this CTA is the last of its grid to get here: each CTA's writes
// before it are then visible to the last one. Every thread calls it.
__device__ __forceinline__ bool last_cta(int* ticket)
{
    __shared__ bool last;
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        last = atomicAdd(ticket, 1) == (int)(gridDim.x * gridDim.y) - 1;
    }
    __syncthreads();
    if (last) __threadfence();
    return last;
}

// -- V1: the clipped table ---------------------------------------------------

struct ClipParams {
    const float* positions;  // (Np, 3) the position arena
    const int* vlocal;       // (T, 3) mesh-local vertex ids
    const int* tri_obj;      // (T,) object ids
    const int* bases;        // (O, kAttrs) attribute bases; column 0 the position's
    const float* mvp;        // (O, 4, 4)
    const uint8_t* visible;  // (Ov,) bool
    int* blk;                // (nb + 1,) crossing triangles a block -> their first fan row, the total last
    float* clip;             // (T + 3 Nc, 3, 4)
    float* bary;             // (T + 3 Nc, 3, 3)
    long long* orig;         // (T + 3 Nc,)
    uint8_t* valid;          // (T + 3 Nc,) bool
    int T, Np, O, Ov, nb, n_cross;
};

// Triangle t's clip-space corners (gather_tri_clip(contract=True)), whether
// its object is visible (tri_valid) and its classes (clip_triangles).
__device__ void clip_corners(const ClipParams& p, int t, float (&c)[3][4], bool& tri_valid, bool& all_in,
                             bool& crossing)
{
    const int obj = __ldg(p.tri_obj + t);
    const int oc = max(obj, 0);
    int ov = obj < 0 ? obj + p.Ov : obj;  // visible[obj]: a negative index counts from the end
    ov = min(max(ov, 0), p.Ov - 1);
    tri_valid = __ldg(p.visible + ov) != 0;
    const float* M = p.mvp + (size_t)oc * 16;
    float mm[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) mm[k] = __ldg(M + k);
    const long long base = __ldg(p.bases + (size_t)oc * kAttrs);
    bool any_in = false;
    all_in = true;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        long long id = (long long)__ldg(p.vlocal + (size_t)t * 3 + i) + base;
        id = id < 0 ? 0 : (id > p.Np - 1 ? p.Np - 1 : id);
        const float* P = p.positions + id * 3;
        const float p0 = __ldg(P), p1 = __ldg(P + 1), p2 = __ldg(P + 2);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            const float* r = mm + 4 * a;
            c[i][a] = __fadd_rn(dot3(r[0], p0, r[1], p1, r[2], p2), r[3]);
        }
        const bool in = __fsub_rn(c[i][3], c[i][2]) >= 0.0f && c[i][3] > W_EPS;
        any_in = any_in || in;
        all_in = all_in && in;
    }
    crossing = tri_valid && any_in && !all_in;
}

__global__ void __launch_bounds__(kThreads) clip_count_kernel(ClipParams p)
{
    __shared__ int sh[kWarps];
    int n = 0;
    for (int r = 0; r < kTurns; ++r) {
        const int t = blockIdx.x * kBlock + r * kThreads + threadIdx.x;
        bool crossing = false;
        if (t < p.T) {
            float c[3][4];
            bool tri_valid, all_in;
            clip_corners(p, t, c, tri_valid, all_in, crossing);
        }
        n += __syncthreads_count(crossing);
    }
    if (threadIdx.x == 0) p.blk[blockIdx.x] = n;
    if (!last_cta(g_tickets)) return;
    const int total = cta_scan<kThreads>(p.blk, p.blk, p.nb, sh);
    if (threadIdx.x == 0) {
        p.blk[p.nb] = total;
        g_tickets[0] = 0;
    }
}

// Fan k of a clipped (corner, 7) polygon of n corners, (v[0], v[k + 1],
// v[k + 2]), as row `row` of the clipped table.
__device__ __forceinline__ void put_fan(const ClipParams& p, long long row, const float (&v)[5][7], int k, int n,
                                        long long orig)
{
    float* C = p.clip + row * 12;
    float* B = p.bary + row * 9;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const int s = i == 0 ? 0 : k + i;
#pragma unroll
        for (int a = 0; a < 4; ++a) C[4 * i + a] = v[s][a];
#pragma unroll
        for (int a = 0; a < 3; ++a) B[3 * i + a] = v[s][4 + a];
    }
    p.orig[row] = orig;
    p.valid[row] = n >= k + 3;
}

__global__ void __launch_bounds__(kThreads) clip_fill_kernel(ClipParams p)
{
    __shared__ int sh[kWarps];
    int run = p.blk[blockIdx.x];
    for (int r = 0; r < kTurns; ++r) {
        const int t = blockIdx.x * kBlock + r * kThreads + threadIdx.x;
        float v[5][7] = {};
        bool tri_valid = false, all_in = false, crossing = false;
        if (t < p.T) {
            float c[3][4];
            clip_corners(p, t, c, tri_valid, all_in, crossing);
            float* C = p.clip + (size_t)t * 12;
            float* B = p.bary + (size_t)t * 9;
#pragma unroll
            for (int i = 0; i < 3; ++i) {
#pragma unroll
                for (int a = 0; a < 4; ++a) C[4 * i + a] = v[i][a] = c[i][a];
#pragma unroll
                for (int a = 0; a < 3; ++a) B[3 * i + a] = v[i][4 + a] = i == a ? 1.0f : 0.0f;
            }
            p.orig[t] = t;
            p.valid[t] = tri_valid && all_in;
        }
        int total;
        const int rank = run + cta_prefix(crossing, sh, total);
        run += total;
        if (crossing) {
            float o[5][7];
            int n1, n;
            clip_plane<0>(v, 3, o, n1);
            clip_plane<1>(o, n1, v, n);
#pragma unroll 1
            for (int k = 0; k < 3; ++k) {
                put_fan(p, (long long)p.T + (long long)k * p.n_cross + rank, v, k, n, t);
            }
        }
    }
}

// -- V2: cull and setup ------------------------------------------------------

struct Hiz {
    const float* mips;      // every mip, row-major, one after the other
    int n;                  // mips (0: no Hi-Z test)
    int h[kMaxLevels], w[kMaxLevels], base[kMaxLevels];
};

struct CullParams {
    const float* clip;      // (Tc, 3, 4)
    const uint8_t* valid;   // (Tc,) bool
    uint8_t* keep;          // (Tc,) bool
    int* blk;               // (nb + 1,) survivors a block -> its first row, V last
    int* hist;              // (nb, n_tiles): survivors a (block, tile) -> the block's first place in the tile
    int* tile_count;        // (n_tiles,) pairs a tile
    int* offsets;           // (n_tiles + 1,) CSR offsets
    int* totals;            // (2,): survivors, pairs
    float* setup;           // (V, 16)
    float4* bbox;           // (V,)
    long long* src;         // (V,)
    uint8_t* flip;          // (V,) bool
    int Tc, nb, n_cols, n_rows, y0;
    int cull_mode;          // 0 none, 1 back, 2 front (geometry.CullMode)
    int front_is_cw, subpixel;
    float fw, fh, y_lo, y_hi;
    Hiz hiz;
};

// Clipped row `row` in screen space.
__device__ __forceinline__ void load_screen(const CullParams& p, int row, Screen& s)
{
    float c[3][4];
    const float* C = p.clip + (size_t)row * 12;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int a = 0; a < 4; ++a) c[i][a] = __ldg(C + 4 * i + a);
    to_screen(c, p.fw, p.fh, s);
}

// hi_z.occlusion_test for one live row: the mip where the bbox's longest
// edge spans <= 2 texels (ceil(log(max(extent, 1)) / log(2))), the min of
// its 2x2 footprint from the base texel (the last row and column repeated
// past the mip, as mip_atlas pads it), occluded when zmax is farther.
__device__ bool occluded(const Hiz& hz, float4 bb, float zmax)
{
    const float extent = nmax(__fsub_rn(bb.z, bb.x), __fsub_rn(bb.w, bb.y));
    const float e1 = extent != extent ? extent : fmaxf(extent, 1.0f);
    const float lf = ceilf(__fdiv_rn(logf(e1), logf(2.0f)));
    const int level = min(max(__float2int_rz(lf), 0), hz.n - 1);
    float m = 0.0f;
#pragma unroll
    for (int lv = 0; lv < kMaxLevels; ++lv) {
        if (lv == level) {  // constant indices into the parameter arrays
            const int mh = hz.h[lv], mw = hz.w[lv];
            const float scale = (float)(1 << lv);
            const int x0 = min(max(__float2int_rz(__fdiv_rn(bb.x, scale)), 0), mw - 1);
            const int y0 = min(max(__float2int_rz(__fdiv_rn(bb.y, scale)), 0), mh - 1);
            const int x1 = min(x0 + 1, mw - 1), y1 = min(y0 + 1, mh - 1);
            const float* mip = hz.mips + hz.base[lv];
            m = nmin(nmin(__ldg(mip + (size_t)y0 * mw + x0), __ldg(mip + (size_t)y0 * mw + x1)),
                     nmin(__ldg(mip + (size_t)y1 * mw + x0), __ldg(mip + (size_t)y1 * mw + x1)));
        }
    }
    return zmax < m;
}

// cull_and_setup's tests on clipped row `row`.
__device__ bool survives(const CullParams& p, int row, Screen& s)
{
    if (!p.valid[row]) return false;
    load_screen(p, row, s);
    const bool is_front = p.front_is_cw ? s.area2 > 0.0f : s.area2 < 0.0f;
    bool keep = s.area2 != 0.0f && s.wpos;
    if (p.cull_mode == 1) keep = keep && is_front;
    if (p.cull_mode == 2) keep = keep && !is_front;
    keep = keep && s.bb.z > 0.0f && s.bb.x < p.fw && s.bb.w > p.y_lo && s.bb.y < p.y_hi;
    if (p.subpixel) keep = keep && holds_centre(s.bb);
    if (keep && p.hiz.n > 0) keep = !occluded(p.hiz, s.bb, nmax(nmax(s.z[0], s.z[1]), s.z[2]));
    return keep;
}

__global__ void __launch_bounds__(kThreads) cull_kernel(CullParams p)
{
    extern __shared__ int tiles[];  // this block's survivors a tile
    const int n_tiles = p.n_cols * p.n_rows;
    for (int i = threadIdx.x; i < n_tiles; i += kThreads) tiles[i] = 0;
    __syncthreads();
    int n = 0;
    for (int r = 0; r < kTurns; ++r) {
        const int row = blockIdx.x * kBlock + r * kThreads + threadIdx.x;
        bool keep = false;
        if (row < p.Tc) {
            Screen s;
            keep = survives(p, row, s);
            p.keep[row] = keep;
            if (keep) {
                const int4 rc = tile_rect(s.bb, p.n_cols, p.n_rows, p.y0);
                for (int ty = rc.y; ty <= rc.w; ++ty)
                    for (int tx = rc.x; tx <= rc.z; ++tx) atomicAdd(tiles + ty * p.n_cols + tx, 1);
            }
        }
        n += __syncthreads_count(keep);
    }
    for (int i = threadIdx.x; i < n_tiles; i += kThreads) p.hist[(size_t)blockIdx.x * n_tiles + i] = tiles[i];
    if (threadIdx.x == 0) p.blk[blockIdx.x] = n;
}

// CTAs 0 .. n_tiles - 1 scan their tile's column, CTA n_tiles the blocks'
// survivor counts; the last CTA to finish scans the tiles' pair counts.
__global__ void __launch_bounds__(kScanThreads) cull_scan_kernel(CullParams p)
{
    __shared__ int sh[kScanThreads / 32];
    const int n_tiles = p.n_cols * p.n_rows;
    if ((int)blockIdx.x < n_tiles) {
        int* col = p.hist + blockIdx.x;
        const int total = cta_scan<kScanThreads>(col, col, p.nb, sh, n_tiles);
        if (threadIdx.x == 0) p.tile_count[blockIdx.x] = total;
    } else {
        const int total = cta_scan<kScanThreads>(p.blk, p.blk, p.nb, sh);
        if (threadIdx.x == 0) p.blk[p.nb] = total;
    }
    if (!last_cta(g_tickets + 1)) return;
    const int pairs = cta_scan<kScanThreads>(p.tile_count, p.offsets, n_tiles, sh);
    if (threadIdx.x == 0) {
        p.offsets[n_tiles] = pairs;
        p.totals[0] = __ldcg(p.blk + p.nb);
        p.totals[1] = pairs;
        g_tickets[1] = 0;
    }
}

__global__ void __launch_bounds__(kThreads) setup_kernel(CullParams p)
{
    __shared__ int sh[kWarps];
    int run = p.blk[blockIdx.x];
    if (p.blk[blockIdx.x + 1] == run) return;  // no survivor in the block
    for (int r = 0; r < kTurns; ++r) {
        const int row = blockIdx.x * kBlock + r * kThreads + threadIdx.x;
        const bool keep = row < p.Tc && p.keep[row];
        int total;
        const int v = run + cta_prefix(keep, sh, total);
        run += total;
        if (!keep) continue;
        Screen s;
        load_screen(p, row, s);
        float out[SETUP_W];
        bool flip;
        setup_row(s, p.fh, out, flip);
        out[S_ID] = (float)row;
        float4* dst = reinterpret_cast<float4*>(p.setup + (size_t)v * SETUP_W);
#pragma unroll
        for (int q = 0; q < SETUP_W / 4; ++q) {
            dst[q] = make_float4(out[4 * q], out[4 * q + 1], out[4 * q + 2], out[4 * q + 3]);
        }
        p.bbox[v] = s.bb;
        p.src[v] = row;
        p.flip[v] = flip;
    }
}

// -- V4: the tile lists ------------------------------------------------------

struct TileParams {
    const float4* bbox;     // (V,)
    const int* blk;         // V2's: each block's first survivor, V last
    const int* hist;        // V2's scanned (block, tile) table
    const int* offsets;     // (n_tiles + 1,)
    int* ids;               // (P,)
    int nb, n_cols, n_rows, y0;
};

// One warp a block of V2: its survivors in order, 32 at a time. The
// block's next place in each tile's list (the tile's offset + the block's
// first place in it) is staged in shared memory first. Each lane walks the
// tiles of its rectangle in increasing tile id; the warp takes the smallest
// tile any lane is on (X), the lanes on X put their ids at X's next place
// + the lanes before them on X, the place moves on by their count, and
// they step on. So a round costs a warp minimum, a ballot and shared
// memory, and the rounds are the distinct tiles of the 32 survivors.
__global__ void __launch_bounds__(32) tiles_kernel(TileParams p)
{
    extern __shared__ int at[];  // this block's next place in each tile's list
    const int s0 = p.blk[blockIdx.x], count = p.blk[blockIdx.x + 1] - s0;
    if (count == 0) return;
    const int n_tiles = p.n_cols * p.n_rows;
    const int lane = threadIdx.x;
    constexpr int kNone = 0x7fffffff;
    const int* first = p.hist + (size_t)blockIdx.x * n_tiles;
    for (int t = lane; t < n_tiles; t += 32) at[t] = p.offsets[t] + first[t];
    __syncwarp();
    for (int base = 0; base < count; base += 32) {
        const int i = base + lane;
        int4 rc = make_int4(0, 0, -1, -1);
        if (i < count) rc = tile_rect(p.bbox[s0 + i], p.n_cols, p.n_rows, p.y0);
        const int w = rc.z - rc.x + 1, mine = rect_size(rc);
        int k = 0;
        int cur = mine > 0 ? rc.y * p.n_cols + rc.x : kNone;
        for (;;) {
            const int X = __reduce_min_sync(FULL, cur);
            if (X == kNone) break;
            const unsigned on = __ballot_sync(FULL, cur == X);
            if (cur == X) {
                p.ids[at[X] + __popc(on & ((1u << lane) - 1))] = s0 + i;
                ++k;
                cur = k < mine ? (rc.y + k / w) * p.n_cols + rc.x + k % w : kNone;
            }
            __syncwarp();
            if (lane == __ffs(on) - 1) at[X] += __popc(on);
            __syncwarp();
        }
    }
}

// -- V3: the attribute planes ------------------------------------------------

struct PlaneParams {
    const long long* src;    // (V,) clipped row of each survivor
    const uint8_t* flip;     // (V,) bool
    const float* clip;       // (Tc, 3, 4)
    const float* bary;       // (Tc, 3, 3)
    const long long* orig;   // (Tc,)
    const int* vlocal;       // (T, 3)
    const int* tri_obj;      // (T,)
    const int* bases;        // (O, kAttrs)
    const float* arena[6];   // position, normal, tangent, uv0, uv1, color0
    const float* model_view; // (O, 4, 4)
    const int* material;     // (O,)
    float* planes;           // (V, 64)
    int V;
    int rows[6];             // each arena's rows
    float fw, fh;
};

// Each source corner's values of one attribute arena (C channels), as
// attribute_planes' corner_vals: the default where the object has no such
// attribute.
template <int C>
__device__ __forceinline__ void corner_vals(const float* arena, int rows, const int (&vloc)[3], int base,
                                           const float (&dflt)[C], float (&out)[3][C])
{
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        long long id = (long long)vloc[k] + base;
        id = id < 0 ? 0 : (id > rows - 1 ? rows - 1 : id);
#pragma unroll
        for (int ch = 0; ch < C; ++ch) out[k][ch] = base >= 0 ? __ldg(arena + id * C + ch) : dflt[ch];
    }
}

// Per clipped corner j, sum_k b[j][k] * vals[k] in dot3's order.
template <int C>
__device__ __forceinline__ void at_corners(const float (&b)[3][3], const float (&vals)[3][C], float (&out)[3][C])
{
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
            out[j][ch] = dot3(b[j][0], vals[0][ch], b[j][1], vals[1][ch], b[j][2], vals[2][ch]);
        }
}

__global__ void __launch_bounds__(kThreads) planes_kernel(PlaneParams p)
{
    const int v = blockIdx.x * kThreads + threadIdx.x;
    if (v >= p.V) return;
    const long long src = p.src[v];
    const bool flip = p.flip[v] != 0;
    const int sw[3] = {0, flip ? 2 : 1, flip ? 1 : 2};
    float c[3][4], b[3][3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
        for (int a = 0; a < 4; ++a) c[j][a] = __ldg(p.clip + src * 12 + sw[j] * 4 + a);
#pragma unroll
        for (int a = 0; a < 3; ++a) b[j][a] = __ldg(p.bary + src * 9 + sw[j] * 3 + a);
    }
    const long long o = p.orig[src];

    float inv_w[3], xp[3], yp[3], x[3], y[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        inv_w[j] = __frcp_rn(c[j][3] == 0.0f ? 1.0f : c[j][3]);
        xp[j] = __fadd_rn(__fmul_rn(__fmul_rn(c[j][0], inv_w[j]), 0.5f), 0.5f);
        yp[j] = __fsub_rn(0.5f, __fmul_rn(__fmul_rn(c[j][1], inv_w[j]), 0.5f));
        x[j] = __fmul_rn(xp[j], p.fw);
        y[j] = __fmul_rn(yp[j], p.fh);
    }
    float ea[3], eb[3], ec[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        const int n = (j + 1) % 3;
        ea[j] = __fmaf_rn(yp[j], p.fh, -y[n]);
        eb[j] = __fmaf_rn(-xp[j], p.fw, x[n]);
        ec[j] = ab_minus_cd(__fsub_rn(y[n], y[j]), x[j], __fsub_rn(x[n], x[j]), y[j]);
    }
    const float area = ab_minus_cd(__fmaf_rn(xp[1], p.fw, -x[0]), __fmaf_rn(yp[2], p.fh, -y[0]),
                                   __fmaf_rn(xp[2], p.fw, -x[0]), __fmaf_rn(yp[1], p.fh, -y[0]));
    const float inv_area = __frcp_rn(area == 0.0f ? 1.0f : area);
    float opp[3][3];  // corner j: the opposite edge's a, b, c over the area
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        const int n = (j + 1) % 3;
        opp[j][0] = __fmul_rn(ea[n], inv_area);
        opp[j][1] = __fmul_rn(eb[n], inv_area);
        opp[j][2] = __fmul_rn(ec[n], inv_area);
    }

    const int obj = max(__ldg(p.tri_obj + o), 0);
    int vloc[3], bs[kAttrs];
#pragma unroll
    for (int k = 0; k < 3; ++k) vloc[k] = __ldg(p.vlocal + o * 3 + k);
#pragma unroll
    for (int a = 0; a < kAttrs; ++a) bs[a] = __ldg(p.bases + (size_t)obj * kAttrs + a);
    float mv[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) mv[k] = __ldg(p.model_view + (size_t)obj * 16 + k);
    float* out = p.planes + (size_t)v * PLANES_W;

    // Plane (a, b, c) of sum_j (A_j / w_j) lam_j of per-corner values A.
    auto put = [&](int lane0, const float (&A)[3]) {
        float aw[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) aw[j] = __fmul_rn(A[j], inv_w[j]);
#pragma unroll
        for (int q = 0; q < 3; ++q) out[lane0 + q] = dot3(aw[0], opp[0][q], aw[1], opp[1][q], aw[2], opp[2][q]);
    };
    {
        const float one[3] = {1.0f, 1.0f, 1.0f};
        put(0, one);  // 1/w
    }
    const float z3[3] = {0.0f, 0.0f, 0.0f};
    {   // View-space position: mv3 . p + t.
        float vals[3][3], pc[3][3];
        corner_vals<3>(p.arena[0], p.rows[0], vloc, bs[0], z3, vals);
        at_corners<3>(b, vals, pc);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            float A[3];
#pragma unroll
            for (int j = 0; j < 3; ++j)
                A[j] = __fadd_rn(dot3(mv[4 * a], pc[j][0], mv[4 * a + 1], pc[j][1], mv[4 * a + 2], pc[j][2]),
                                 mv[4 * a + 3]);
            put(3 + 3 * a, A);
        }
    }
    // 1 / |column b of mv3|^2, clamped below at 1e-30.
    float inv_scale_sq[3];
#pragma unroll
    for (int bb = 0; bb < 3; ++bb) {
        const float s = dot3(mv[bb], mv[bb], mv[4 + bb], mv[4 + bb], mv[8 + bb], mv[8 + bb]);
        inv_scale_sq[bb] = __frcp_rn(s != s ? s : fmaxf(s, 1e-30f));
    }
#pragma unroll
    for (int which = 0; which < 2; ++which) {  // normal, then tangent: mv3 . (t * inv_scale_sq), normalized
        float vals[3][3], tc[3][3];
        corner_vals<3>(p.arena[1 + which], p.rows[1 + which], vloc, bs[1 + which], z3, vals);
        at_corners<3>(b, vals, tc);
        float d[3][3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            float t[3];
#pragma unroll
            for (int k = 0; k < 3; ++k) t[k] = __fmul_rn(tc[j][k], inv_scale_sq[k]);
#pragma unroll
            for (int a = 0; a < 3; ++a) d[j][a] = dot3(mv[4 * a], t[0], mv[4 * a + 1], t[1], mv[4 * a + 2], t[2]);
            const float nn = __fsqrt_rn(dot3(d[j][0], d[j][0], d[j][1], d[j][1], d[j][2], d[j][2]));
            const float den = nn == 0.0f ? 1.0f : nn;
#pragma unroll
            for (int a = 0; a < 3; ++a) d[j][a] = __fdiv_rn(d[j][a], den);
        }
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const float A[3] = {d[0][a], d[1][a], d[2][a]};
            put(12 + 9 * which + 3 * a, A);
        }
    }
    {   // uv0, uv1
        const float z2[2] = {0.0f, 0.0f};
#pragma unroll
        for (int which = 0; which < 2; ++which) {
            float vals[3][2], uc[3][2];
            corner_vals<2>(p.arena[3 + which], p.rows[3 + which], vloc, bs[3 + which], z2, vals);
            at_corners<2>(b, vals, uc);
#pragma unroll
            for (int a = 0; a < 2; ++a) {
                const float A[3] = {uc[0][a], uc[1][a], uc[2][a]};
                put(30 + 6 * which + 3 * a, A);
            }
        }
    }
    {   // color0
        const float one4[4] = {1.0f, 1.0f, 1.0f, 1.0f};
        float vals[3][4], cc[3][4];
        corner_vals<4>(p.arena[5], p.rows[5], vloc, bs[5], one4, vals);
        at_corners<4>(b, vals, cc);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            const float A[3] = {cc[0][a], cc[1][a], cc[2][a]};
            put(42 + 3 * a, A);
        }
    }
    out[P_MAT] = (float)__ldg(p.material + obj);
#pragma unroll
    for (int q = P_MAT + 1; q < PLANES_W; ++q) out[q] = 0.0f;
}

}  // namespace

extern "C" {

// V1's count: tri_pos gathered from positions (Np, 3) f32 through vlocal
// (T, 3) int32 and the position column of bases (O, 6) int32, mvp (O, 4,
// 4) f32 and visible (Ov,) bool by tri_obj (T,) int32; blk (nb + 1) int32,
// nb = ceil(T / 1024), gets each block's first fan row and the total last.
int v1_clip_count(const void* positions, const void* vlocal, const void* tri_obj, const void* bases,
                  const void* mvp, const void* visible, void* blk, int T, int Np, int O, int Ov,
                  void* stream)
{
    if (T < 0 || Np < 1 || O < 1 || Ov < 1) return (int)cudaErrorInvalidValue;
    if (T == 0) return (int)cudaGetLastError();
    ClipParams p = {};
    p.positions = (const float*)positions;
    p.vlocal = (const int*)vlocal;
    p.tri_obj = (const int*)tri_obj;
    p.bases = (const int*)bases;
    p.mvp = (const float*)mvp;
    p.visible = (const uint8_t*)visible;
    p.blk = (int*)blk;
    p.T = T;
    p.Np = Np;
    p.O = O;
    p.Ov = Ov;
    p.nb = (T + kBlock - 1) / kBlock;
    clip_count_kernel<<<p.nb, kThreads, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

// V1's fill, after the count (same inputs; n_cross the total): the clipped
// table clip (T + 3 n_cross, 3, 4) f32, bary (.., 3, 3) f32, orig (..)
// int64, valid (..) bool.
int v1_clip_fill(const void* positions, const void* vlocal, const void* tri_obj, const void* bases,
                 const void* mvp, const void* visible, const void* blk, void* clip, void* bary, void* orig,
                 void* valid, int T, int Np, int O, int Ov, int n_cross, void* stream)
{
    if (T < 0 || Np < 1 || O < 1 || Ov < 1 || n_cross < 0) return (int)cudaErrorInvalidValue;
    if (T == 0) return (int)cudaGetLastError();
    ClipParams p = {};
    p.positions = (const float*)positions;
    p.vlocal = (const int*)vlocal;
    p.tri_obj = (const int*)tri_obj;
    p.bases = (const int*)bases;
    p.mvp = (const float*)mvp;
    p.visible = (const uint8_t*)visible;
    p.blk = (int*)blk;
    p.clip = (float*)clip;
    p.bary = (float*)bary;
    p.orig = (long long*)orig;
    p.valid = (uint8_t*)valid;
    p.T = T;
    p.Np = Np;
    p.O = O;
    p.Ov = Ov;
    p.nb = (T + kBlock - 1) / kBlock;
    p.n_cross = n_cross;
    clip_fill_kernel<<<p.nb, kThreads, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

static int cull_params(CullParams& p, const void* clip, const void* valid, void* keep, void* ints, void* offsets,
                       const void* mips, int Tc, int n_cols, int n_rows, int y0, int cull_mode,
                       int front_is_cw, int subpixel, int n_levels, const int* dims, float fw, float fh,
                       float y_lo, float y_hi)
{
    if (Tc < 0 || n_cols < 1 || n_rows < 1 || n_levels < 0 || n_levels > kMaxLevels || cull_mode < 0 ||
        cull_mode > 2 || (n_levels > 0 && !mips))
        return (int)cudaErrorInvalidValue;
    p = CullParams{};
    const int n_tiles = n_cols * n_rows;
    p.nb = (Tc + kBlock - 1) / kBlock;
    p.clip = (const float*)clip;
    p.valid = (const uint8_t*)valid;
    p.keep = (uint8_t*)keep;
    // ints: blk (nb + 1), hist (n_tiles nb), tile counts (n_tiles), totals (2)
    p.blk = (int*)ints;
    p.hist = p.blk + p.nb + 1;
    p.tile_count = p.hist + (size_t)n_tiles * p.nb;
    p.totals = p.tile_count + n_tiles;
    p.offsets = (int*)offsets;
    p.Tc = Tc;
    p.n_cols = n_cols;
    p.n_rows = n_rows;
    p.y0 = y0;
    p.cull_mode = cull_mode;
    p.front_is_cw = front_is_cw;
    p.subpixel = subpixel;
    p.fw = fw;
    p.fh = fh;
    p.y_lo = y_lo;
    p.y_hi = y_hi;
    p.hiz.mips = (const float*)mips;
    p.hiz.n = n_levels;
    for (int i = 0; i < n_levels; ++i) {
        p.hiz.h[i] = dims[3 * i];
        p.hiz.w[i] = dims[3 * i + 1];
        p.hiz.base[i] = dims[3 * i + 2];
        if (p.hiz.h[i] < 1 || p.hiz.w[i] < 1) return (int)cudaErrorInvalidValue;
    }
    return 0;
}

// V2's cull and scan: clip (Tc, 3, 4) f32 and valid (Tc,) bool; keep (Tc,)
// bool; ints (nb + 1 + n_tiles nb + n_tiles + 2) int32, nb = ceil(Tc /
// 1024): the blocks' first rows, the (block, tile) table, the tiles' pair
// counts, then the totals (survivors, pairs) the host reads; offsets
// (n_tiles + 1) int32; the Hi-Z mips one after another (n_levels, then each
// mip's height, width and first element in d0..d35); the viewport fw x fh
// with the rows [y_lo, y_hi); the tile grid n_cols x n_rows from target row
// y0.
int v2_cull(const void* clip, const void* valid, void* keep, void* ints, void* offsets,
            const void* mips, int Tc, int n_cols, int n_rows, int y0, int cull_mode, int front_is_cw, int subpixel,
            int n_levels, int d0, int d1, int d2, int d3, int d4, int d5, int d6, int d7, int d8, int d9, int d10,
            int d11, int d12, int d13, int d14, int d15, int d16, int d17, int d18, int d19, int d20, int d21,
            int d22, int d23, int d24, int d25, int d26, int d27, int d28, int d29, int d30, int d31, int d32,
            int d33, int d34, int d35, float fw, float fh, float y_lo, float y_hi, void* stream)
{
    const int dims[3 * kMaxLevels] = {d0,  d1,  d2,  d3,  d4,  d5,  d6,  d7,  d8,  d9,  d10, d11,
                                      d12, d13, d14, d15, d16, d17, d18, d19, d20, d21, d22, d23,
                                      d24, d25, d26, d27, d28, d29, d30, d31, d32, d33, d34, d35};
    CullParams p;
    const int rc = cull_params(p, clip, valid, keep, ints, offsets, mips, Tc, n_cols, n_rows, y0, cull_mode,
                               front_is_cw, subpixel, n_levels, dims, fw, fh, y_lo, y_hi);
    if (rc) return rc;
    const int n_tiles = n_cols * n_rows;
    const size_t smem = (size_t)n_tiles * sizeof(int);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    if (p.nb > 0) cull_kernel<<<p.nb, kThreads, smem, (cudaStream_t)stream>>>(p);
    cull_scan_kernel<<<n_tiles + 1, kScanThreads, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

// V2's setup, after the host read (same clip, keep and ints): the survivors'
// setup (V, 16) f32, bbox (V, 4) f32, src (V,) int64 and flip (V,) bool.
int v2_setup(const void* clip, const void* keep, const void* ints, void* setup, void* bbox, void* src, void* flip,
             int Tc, int n_tiles, float fw, float fh, void* stream)
{
    if (Tc < 0 || n_tiles < 1) return (int)cudaErrorInvalidValue;
    CullParams p = {};
    p.nb = (Tc + kBlock - 1) / kBlock;
    p.clip = (const float*)clip;
    p.keep = (uint8_t*)keep;
    p.blk = (int*)ints;
    p.setup = (float*)setup;
    p.bbox = (float4*)bbox;
    p.src = (long long*)src;
    p.flip = (uint8_t*)flip;
    p.Tc = Tc;
    p.fw = fw;
    p.fh = fh;
    if (p.nb > 0) setup_kernel<<<p.nb, kThreads, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

// V3: the plane table planes (V, 64) f32 of the survivors src (V,) int64 /
// flip (V,) bool of the clipped table clip / bary / orig; vlocal (T, 3) and
// tri_obj (T,) int32 of the set, bases (O, 6) int32, the six attribute
// arenas (rows r_i, 3, 3, 3, 2, 2, 4 channels) f32, model_view (O, 4, 4)
// f32, material (O,) int32.
int v3_planes(const void* src, const void* flip, const void* clip, const void* bary, const void* orig,
              const void* vlocal, const void* tri_obj, const void* bases, const void* position, const void* normal,
              const void* tangent, const void* uv0, const void* uv1, const void* color0, const void* model_view,
              const void* material, void* planes, int V, int r0, int r1, int r2, int r3, int r4, int r5, float fw,
              float fh, void* stream)
{
    const int rows[6] = {r0, r1, r2, r3, r4, r5};
    if (V < 0) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < 6; ++i)
        if (rows[i] < 1) return (int)cudaErrorInvalidValue;
    if (V == 0) return (int)cudaGetLastError();
    PlaneParams p = {};
    p.src = (const long long*)src;
    p.flip = (const uint8_t*)flip;
    p.clip = (const float*)clip;
    p.bary = (const float*)bary;
    p.orig = (const long long*)orig;
    p.vlocal = (const int*)vlocal;
    p.tri_obj = (const int*)tri_obj;
    p.bases = (const int*)bases;
    const void* arenas[6] = {position, normal, tangent, uv0, uv1, color0};
    for (int i = 0; i < 6; ++i) {
        p.arena[i] = (const float*)arenas[i];
        p.rows[i] = rows[i];
    }
    p.model_view = (const float*)model_view;
    p.material = (const int*)material;
    p.planes = (float*)planes;
    p.V = V;
    p.fw = fw;
    p.fh = fh;
    planes_kernel<<<(V + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

// V4: the tile lists ids (P,) int32 of V2's survivors (bbox (V, 4) f32),
// from V2's ints and offsets.
int v4_tiles(const void* bbox, const void* ints, const void* offsets, void* ids, int Tc, int n_cols, int n_rows,
             int y0, void* stream)
{
    if (Tc < 0 || n_cols < 1 || n_rows < 1) return (int)cudaErrorInvalidValue;
    TileParams p = {};
    p.nb = (Tc + kBlock - 1) / kBlock;
    p.bbox = (const float4*)bbox;
    p.blk = (const int*)ints;
    p.hist = p.blk + p.nb + 1;
    p.offsets = (const int*)offsets;
    p.ids = (int*)ids;
    p.n_cols = n_cols;
    p.n_rows = n_rows;
    p.y0 = y0;
    const size_t smem = (size_t)n_cols * n_rows * sizeof(int);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    if (p.nb > 0) tiles_kernel<<<p.nb, 32, smem, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

// Registers, spills, shared memory and resident CTAs per SM of instance
// `which`: 0 V1 clip_count_kernel, 1 V1 clip_fill_kernel, 2 V2 cull_kernel,
// 3 V2 cull_scan_kernel, 4 V2 setup_kernel, 5 V3 planes_kernel, 6 V4
// tiles_kernel (the dynamic shared memory of a 1080p target's 510 tiles).
int view_front_kernel_info(int which, void* info)
{
    int* i = (int*)info;
    switch (which) {
        case 0: return kernel_info(clip_count_kernel, kThreads, 0, i);
        case 1: return kernel_info(clip_fill_kernel, kThreads, 0, i);
        case 2: return kernel_info(cull_kernel, kThreads, 510 * sizeof(int), i);
        case 3: return kernel_info(cull_scan_kernel, kScanThreads, 0, i);
        case 4: return kernel_info(setup_kernel, kThreads, 0, i);
        case 5: return kernel_info(planes_kernel, kThreads, 0, i);
        case 6: return kernel_info(tiles_kernel, 32, 510 * sizeof(int), i);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
