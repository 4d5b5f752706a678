// CSR tile lists on the card, shared by raster.cu (K1, K2, K6) and
// shadow_occ.cu (K7, K8): the segment plan that spreads a long list over
// many CTAs, and the double-buffered cp.async staging of list entries.
//
// A list entry is a setup row id; its staged row is the 16-float setup row
// (edges, depth plane, top-left flags, S_ID; ops/geometry.py) and the f32
// bbox (xmin, ymin, xmax, ymax), 80 bytes, a stride that keeps the lanes of
// a warp reading 32 rows at once on distinct banks. Everything here has
// internal linkage: each source instantiates its own kernels.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {
namespace tile_lists {

constexpr int SETUP_W = 16;
constexpr int ROW4 = SETUP_W / 4 + 1;  // float4s a staged row: the setup row, then the bbox
constexpr int CHUNK = 128;             // entries a staged buffer holds
constexpr int NT = 256;                // threads of a CTA that stages or plans (two an entry)
constexpr int WARPS = NT / 32;

struct Chunk {
    float4 row[CHUNK][ROW4];
    int id[CHUNK];
};

// Stage entry e of a chunk (setup row `id`, -1 past the list's end) into
// `c`: thread half h copies setup floats 8h..8h+7, half 0 also the bbox.
__device__ __forceinline__ void stage(Chunk& c, int e, int h, int id, const float* setup, const float4* bbox) {
    if (id < 0) return;
    const float4* src = reinterpret_cast<const float4*>(setup + (size_t)id * SETUP_W) + 2 * h;
    __pipeline_memcpy_async(&c.row[e][2 * h], src, 16);
    __pipeline_memcpy_async(&c.row[e][2 * h + 1], src + 1, 16);
    if (h == 0) {
        __pipeline_memcpy_async(&c.row[e][ROW4 - 1], bbox + id, 16);
        c.id[e] = id;
    }
}

// Stage list entries [beg, end) of `ids` CHUNK at a time into the two
// buffers of `sm`, so that chunk k + 1 loads while chunk k is visited; the
// id of each thread's entry is loaded a chunk ahead. visit(chunk, n) runs
// on every thread of the CTA (NT threads) once the chunk's n entries have
// arrived. Every thread of the CTA calls it with the same range.
template <typename Visit>
__device__ __forceinline__ void walk_staged(const int* __restrict__ ids, const float* __restrict__ setup,
                                            const float4* __restrict__ bbox, int beg, int end, Chunk* sm,
                                            Visit&& visit) {
    const int n_chunks = (end - beg + CHUNK - 1) / CHUNK;
    if (n_chunks <= 0) return;
    const int e = threadIdx.x >> 1, h = threadIdx.x & 1;
    stage(sm[0], e, h, beg + e < end ? __ldg(ids + beg + e) : -1, setup, bbox);
    __pipeline_commit();
    int id_next = beg + CHUNK + e < end ? __ldg(ids + beg + CHUNK + e) : -1;
    for (int k = 0; k < n_chunks; ++k) {
        const int base = beg + k * CHUNK;
        if (k + 1 < n_chunks) {
            stage(sm[(k + 1) & 1], e, h, id_next, setup, bbox);
            __pipeline_commit();
            id_next = base + 2 * CHUNK + e < end ? __ldg(ids + base + 2 * CHUNK + e) : -1;
            __pipeline_wait_prior(1);
        } else {
            __pipeline_wait_prior(0);
        }
        __syncthreads();
        visit(sm[k & 1], min(CHUNK, end - base));
        __syncthreads();  // buffer k & 1 is staged again for chunk k + 2
    }
}

// Exclusive prefix sum of one int a thread over an NT-thread CTA; `total`
// gets the sum.
__device__ __forceinline__ int cta_exclusive_scan(int v, int& total, int* warp_sums) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += t;
    }
    if (lane == 31) warp_sums[warp] = inc;
    __syncthreads();
    int base = 0;
    total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        const int s = warp_sums[w];
        base += (w < warp) ? s : 0;
        total += s;
    }
    __syncthreads();
    return base + inc - v;
}

// Ints of a plan of the segments of SEG entries over n_tiles lists of
// n_entries entries in all: at most one partial segment a tile.
template <int SEG>
inline size_t plan_ints(size_t n_tiles, size_t n_entries) {
    return 1 + 2 * (n_tiles + n_entries / SEG);
}

// The segments, one CTA of NT threads: tile t's list of len entries splits
// into ceil(len / SEG) segments of SEG entries (none for an empty list), in
// tile order. plan[0] gets their number; segment s's tile and first list
// entry go to plan[1 + 2s] and plan[2 + 2s]. Thread i owns a contiguous run
// of tiles.
template <int SEG>
__global__ void __launch_bounds__(NT) plan_kernel(const int* __restrict__ offs, int n_tiles, int* __restrict__ plan) {
    __shared__ int warp_sums[WARPS];
    const int per = (n_tiles + NT - 1) / NT;
    const int lo = min(n_tiles, (int)threadIdx.x * per), hi = min(n_tiles, lo + per);
    int n = 0;
    for (int t = lo; t < hi; ++t) n += (offs[t + 1] - offs[t] + SEG - 1) / SEG;
    int total;
    int s = cta_exclusive_scan(n, total, warp_sums);
    for (int t = lo; t < hi; ++t) {
        for (int b = offs[t]; b < offs[t + 1]; b += SEG, ++s) {
            plan[1 + 2 * s] = t;
            plan[2 + 2 * s] = b;
        }
    }
    if (threadIdx.x == 0) plan[0] = total;
}

}  // namespace tile_lists
}  // namespace
