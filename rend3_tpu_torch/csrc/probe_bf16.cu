// P1-P3: the bf16 "select-and-lerp" probes of K4's TPU design, for Hopper.
//
// Replaces: tools/probe_bf16_dot.py run (:22, pallas_call at :26; kernels
// k_f32, k_bf16, k_bf16_T, k_bf16_pad128 at :37-67), tools/probe_bf16_kernel.py
// v1-v7 (:44-223) and tools/probe_bf16_real.py build (:22, pallas_call at
// :115). On the TPU they were Mosaic lowering probes: each does a bilinear
// gather as a bf16 one-hot matmul on the MXU. On the H100 there is no Mosaic
// to probe; what is kept is what each probe computes, bit for bit with the
// JAX kernels as XLA:CPU runs them in interpret mode (the tests' reference)
// and with the plain versions (ops/probe_bf16.py).
//
// Three kernels:
//   - probe_dot (P1, and the dense dot of P2 v1 / v2): out = a^T b, the
//     contraction over dim 0 of both operands, operands kept in f32 or
//     rounded to bf16 (round to nearest even), the sum taken in f32 as a
//     sequential fma over r in ascending order (the order XLA:CPU uses,
//     found by bit-matching all 524,288 values of the f32 variant). The
//     function fixes the order, so tensor cores are out: mma / wgmma add
//     their products without rounding after each one, as a sequential f32
//     fma must, so they cannot give these bits. It is a CUDA-core GEMM
//     (below).
//   - probe_reduce (P2 v1 / v2): per channel c < 4 and pixel p, the
//     x-weighted sum over the 128 lanes j of r2[128c + j, p], written or
//     added to out. The 128-lane sum is XLA:CPU's order for a (128, n) axis-0
//     reduce, found by bit-matching: four sequential sums of 32 consecutive
//     lanes (each product rounded, then added), then the four partial sums in
//     order.
//   - probe_lerp (P2 v3-v7, P3): a step list (tile, cell, flags) walked in
//     order per tile, as the TPU grid runs; a CTA per (tile, 32 pixels), so
//     no atomics and no order across CTAs. Per step: bit 4 of the flags zeroes the pixel's 8 output rows (when the
//     init branch is on); bits 0-3 select the bands (npb pixels each); each
//     selected pixel gets the two-hot y-weights (w_lo at row ry, w_hi at
//     ry + 1), the dot over the 72 rows reduces to
//     fma(t[ry+1], w_hi, t[ry] * w_lo) (the sequential fma with its zero
//     rows dropped, exact), then either the 128-lane sum of those columns
//     (the order above) or the x-lerp (1-fx) * rc[rx] + fx * rc[rx+1] (the
//     only two nonzero terms of the one-hot reduce), added to the output.
//     Texels and weights are rounded to bf16 in the bf16 variants.
//
// What bounds them on the H100. P1 at the probes' shapes (K = 72 or 128, M =
// 512, N = 1024) does 75.5 MFLOP, about 1.1 us at the f32 peak, and moves
// 2.5 MB, about 0.75 us; the others are smaller. An empty kernel in a CUDA
// graph takes 1.4-1.7 us (gather.cu's launch_floor). P1's design: a CTA
// stages its whole contraction slice of both operands at once (K <= 128
// rows, 27.6 KB at K = 72; a larger K loops over 128-row chunks) with
// 16-byte cp.async copies issued from one site (the (M, K) layout of the
// transposed variant through 16-byte loads, transposed into shared memory on
// the way), bf16 rounded in place; 32 x 64 outputs a CTA, 128 threads of
// 4 x 4, so the probes' 512 x 1024 outputs are 256 CTAs, about two on each
// of the 132 SMs; a k step reads one float4 of each operand a thread; each
// output row goes out as 16-byte streaming stores. What bounds it then is
// the k loop: with 4 x 4 outputs a thread it issues two shared-memory loads
// and 16 fmas a step, and the 524,288 outputs leave no room for larger
// tiles at 8 warps an SM, nor may the contraction be split (the order). On
// the card it costs more than cuBLAS per contraction row and less to
// start, so at K = 72 the two are within a few per cent (PERF.md §6 lists
// the designs measured). Any shape still launches: the operands are read
// element by element where they do not allow 16 bytes.
// P2 and P3 load texels directly in place of one-hot matmuls (the rule that
// turned K4 into a gather). P2 moves 2.6 MB (0.8 us at 3.35 TB/s) and P3's
// probe input about 3.8 MB, so each is bound by its launch and by load
// latency, not by bytes: their designs (at reduce_kernel and lerp_kernel)
// spread independent chains over enough warps to fill the SMs and issue
// their loads before the adds that wait on them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_info.cuh"

namespace {

constexpr int kLanes = 128;   // lanes of one channel (STILE_W)
constexpr int kChannels = 4;
constexpr int kOutRows = 8;   // rows of an output block (channels padded to 8)

// Mode bits of probe_lerp (ops/probe_bf16.py LERP_* constants).
constexpr int kBf16 = 1;      // round texels and y-weights to bf16
constexpr int kYCell = 2;     // ry, rx from int coords against the step's cell (P3); else rint(f2 * (R - 8))
constexpr int kWArea = 4;     // y-weights w * (1 - fy), w * fy; else 1 - fy, fy
constexpr int kXLerp = 8;     // x-lerp at rx, rx + 1; else the 128-lane sum
constexpr int kInit = 16;     // bit 4 of a step's flags zeroes its tile
constexpr int kGate = 32;     // a step runs only if f[tile, 0, 0] < 1

__device__ __forceinline__ float round_bf16(float v)
{
    uint32_t u = __float_as_uint(v);
    u += 0x7FFFu + ((u >> 16) & 1u);
    return __uint_as_float(u & 0xFFFF0000u);
}

// P1's tiling: a thread computes 4 x 4 outputs (4 of a's columns M by 4 of
// b's columns N); a warp's lanes lie DOT_LM along M by DOT_LN along N; a CTA
// is DOT_WM x DOT_WN warps. A CTA stages DOT_KC contraction rows of both
// operands at once (a larger K loops over chunks).
constexpr int DOT_LM = 4, DOT_WM = 2, DOT_WN = 2;
constexpr int DOT_LN = 32 / DOT_LM;
constexpr int DOT_TM = 4 * DOT_LM * DOT_WM;   // 32
constexpr int DOT_TN = 4 * DOT_LN * DOT_WN;   // 64
constexpr int DOT_THREADS = 32 * DOT_WM * DOT_WN;
constexpr int DOT_KC = 128;

// How dot_kernel reads its operands: element by element through (a_sr, a_si)
// (any shape), or 16 bytes at a time from a (K, M) a (M % 4 == 0) or from an
// (M, K) a transposed into shared memory on the way (K % 4 == 0); both
// vector modes need N % 4 == 0 and 16-byte aligned pointers, and store 16
// bytes at a time.
enum DotMode { kDotScalar, kDotVec, kDotVecT };

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ float4 round_bf16(float4 v)
{
    return make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z), round_bf16(v.w));
}

// kc rows of the chunk at k0 into as[r][i] (i < DOT_TM) and bs[r][j] (j <
// DOT_TN) for the CTA's tile at (i0, j0), zero past M and N, rounded to
// bf16 when BF16. Ends with the CTA's barrier.
template <bool BF16, int MODE>
__device__ __forceinline__ void stage(const float* __restrict__ a, const float* __restrict__ b, float* as, float* bs,
                                      int k0, int kc, int K, int M, int N, int a_sr, int a_si, int i0, int j0)
{
    const int t = threadIdx.x;
    if (MODE == kDotScalar) {
        constexpr int W = DOT_TM + DOT_TN;
        for (int e = t; e < kc * W; e += DOT_THREADS) {
            const int r = e / W, c = e % W, k = k0 + r;
            float v = 0.0f;
            if (c < DOT_TM) {
                if (i0 + c < M) v = a[(size_t)k * a_sr + (size_t)(i0 + c) * a_si];
                as[r * DOT_TM + c] = BF16 ? round_bf16(v) : v;
            } else {
                if (j0 + c - DOT_TM < N) v = b[(size_t)k * N + j0 + c - DOT_TM];
                bs[r * DOT_TN + c - DOT_TM] = BF16 ? round_bf16(v) : v;
            }
        }
        __syncthreads();
        return;
    }
    // b, and a in the (K, M) layout: 16-byte cp.async copies, zero-filled
    // past the edge. (One copy site: two, one a branch, made the kernel 25%
    // slower on the card.)
    constexpr int AQ = MODE == kDotVec ? DOT_TM / 4 : 0;  // 16-byte pieces of a row of a
    constexpr int Q = AQ + DOT_TN / 4;
#pragma unroll 4
    for (int e = t; e < kc * Q; e += DOT_THREADS) {
        const int r = e / Q, c = e % Q, k = k0 + r;
        float* dst;
        const float* src;
        bool in;
        if (c < AQ) {
            in = i0 + 4 * c < M;
            dst = as + r * DOT_TM + 4 * c;
            src = a + (size_t)k * M + i0 + 4 * c;
        } else {
            const int j = j0 + 4 * (c - AQ);
            in = j < N;
            dst = bs + r * DOT_TN + 4 * (c - AQ);
            src = b + (size_t)k * N + j;
        }
        cp_async16(dst, in ? src : b, in);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (MODE == kDotVecT) {
        // a (M, K): thread e reads 4 consecutive k of row i = e % DOT_TM, so a
        // warp's four stores into as each hit consecutive words.
        for (int e = t; e < DOT_TM * (kc / 4); e += DOT_THREADS) {
            const int i = e % DOT_TM, r = 4 * (e / DOT_TM);
            float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (i0 + i < M) v = __ldg(reinterpret_cast<const float4*>(a + (size_t)(i0 + i) * K + k0 + r));
            if (BF16) v = round_bf16(v);
            as[r * DOT_TM + i] = v.x;
            as[(r + 1) * DOT_TM + i] = v.y;
            as[(r + 2) * DOT_TM + i] = v.z;
            as[(r + 3) * DOT_TM + i] = v.w;
        }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (BF16) {
        // Each thread rounds in place the pieces it copied itself.
#pragma unroll 4
        for (int e = t; e < kc * Q; e += DOT_THREADS) {
            const int r = e / Q, c = e % Q;
            float4* p = reinterpret_cast<float4*>(c < AQ ? as + r * DOT_TM + 4 * c : bs + r * DOT_TN + 4 * (c - AQ));
            *p = round_bf16(*p);
        }
    }
    __syncthreads();
}

template <bool BF16, int MODE>
__global__ void __launch_bounds__(DOT_THREADS) dot_kernel(
    const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
    int K, int M, int N, int a_sr, int a_si)
{
    extern __shared__ float4 smem4[];
    float* as = reinterpret_cast<float*>(smem4);
    float* bs = as + min(K, DOT_KC) * DOT_TM;
    const int i0 = blockIdx.y * DOT_TM, j0 = blockIdx.x * DOT_TN;
    // The thread's rows m0..m0+3 and columns n0..n0+3 of the CTA's tile: a
    // k step reads one float4 of each operand (a warp: 4 distinct float4 of
    // as, 8 of bs).
    const int w = threadIdx.x / 32, l = threadIdx.x % 32;
    const int m0 = (w / DOT_WN) * 4 * DOT_LM + (l / DOT_LN) * 4;
    const int n0 = (w % DOT_WN) * 4 * DOT_LN + (l % DOT_LN) * 4;
    float acc[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += DOT_KC) {
        const int kc = min(DOT_KC, K - k0);
        if (k0 > 0) __syncthreads();
        stage<BF16, MODE>(a, b, as, bs, k0, kc, K, M, N, a_sr, a_si, i0, j0);
#pragma unroll 8
        for (int kk = 0; kk < kc; ++kk) {
            const float4 av = *reinterpret_cast<const float4*>(as + kk * DOT_TM + m0);
            const float4 bv = *reinterpret_cast<const float4*>(bs + kk * DOT_TN + n0);
            const float ax[4] = {av.x, av.y, av.z, av.w}, by[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int x = 0; x < 4; ++x)
#pragma unroll
                for (int y = 0; y < 4; ++y) acc[x][y] = __fmaf_rn(ax[x], by[y], acc[x][y]);
        }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
        const int i = i0 + m0 + x, j = j0 + n0;
        if (i >= M) continue;
        float* o = out + (size_t)i * N + j;
        if (MODE != kDotScalar) {
            if (j < N) __stcs(reinterpret_cast<float4*>(o), make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]));
        } else {
#pragma unroll
            for (int y = 0; y < 4; ++y)
                if (j + y < N) o[y] = acc[x][y];
        }
    }
}

// P2's reduce (P2 v1 / v2). XLA:CPU's 128-lane sum is four sequential
// 32-lane sums, then those four in order from 0: per column and channel,
// four independent chains of 32, not one of 128. A CTA takes 32 columns (a
// lane each) of one channel (blockIdx.y), a warp per 32-lane block, so every
// load is a coalesced 128-byte piece of a row; a thread's chain loads its 64
// operands before its 32 adds, and the four block sums of a column meet in
// shared memory, where warp 0 adds them in order. The probes' n = 1,024
// columns make 128 CTAs. (Two or four channels a CTA, x loaded once for
// them, were slower on the card: PERF.md §6.)
constexpr int RED_BLOCKS = kLanes / 32;
constexpr int RED_THREADS = 32 * RED_BLOCKS;

__global__ void __launch_bounds__(RED_THREADS) reduce_kernel(
    const float* __restrict__ r2, const float* __restrict__ x, float* __restrict__ out, int n, int accumulate)
{
    __shared__ float part[RED_BLOCKS][32];
    const int lane = threadIdx.x % 32, blk = threadIdx.x / 32, c = blockIdx.y;
    const int p = blockIdx.x * 32 + lane;
    if (p < n) {
        const float* xp = x + (size_t)blk * 32 * n + p;
        const float* rp = r2 + ((size_t)c * kLanes + blk * 32) * n + p;
        float xv[32], rv[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            xv[j] = __ldg(xp + (size_t)j * n);
            rv[j] = __ldg(rp + (size_t)j * n);
        }
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < 32; ++j) s = __fadd_rn(s, __fmul_rn(xv[j], rv[j]));
        part[blk][lane] = s;
    }
    __syncthreads();
    if (blk == 0 && p < n) {
        float total = 0.0f;
#pragma unroll
        for (int b = 0; b < RED_BLOCKS; ++b) total = __fadd_rn(total, part[b][lane]);
        float* o = out + (size_t)c * n + p;
        *o = accumulate ? __fadd_rn(*o, total) : total;
    }
}

// P2 v3-v7's and P3's lerp. The steps of a tile run in list order and a
// pixel's output is a chain of adds in that order: the steps are the serial
// dimension, pixels and channels the parallel ones. A CTA takes LERP_PX = 32
// pixels of one tile, a thread per (pixel, channel) (a warp: 32 pixels of
// one channel).
//   - The walk: the CTA compacts the tile's steps once, in order, into
//     shared memory (cell, its origin, flags), a step a thread a round by
//     ballot, keeping only the steps that select a band of its pixels. A
//     step before the tile's last init step adds nothing that outlives that
//     init, so the walk starts at the last init step, from 0 (a first pass
//     over the flags finds it).
//   - A thread keeps its output value in a register from one read (or the
//     init's 0) to one store, through the plain version's adds in its
//     order, so NaN and zero outputs keep their bits; rows 4-7 are written
//     (with 0) only where an init step hit the tile.
//   - x-lerp: a thread issues the texel loads of LERP_BATCH steps before
//     their arithmetic (loads at clamped indices, without a branch).
//   - 128-lane sum: a warp computes its pixels' terms a 32-lane block at a
//     time, a lane a column (coalesced rows), every pixel's loads issued
//     together, the terms transposed through shared memory; then each lane
//     adds its own pixel's 32 terms in order.
// What bounds it on the card: on P3's probe input the launch and three
// dependent rounds of global loads (the init scan, the compaction, the
// walk's two or so steps); on long walks over owned pixels the texel
// gathers (each lane reads its own rows, so an x-lerp load touches 32
// lines) and, for the 128-lane sum, the 4 KB of cell rows each
// (pixel, step) reads through L1 and L2. Neither is bytes or operations
// once; the bound (bytes once) lies under the launch floor.
constexpr int LERP_PX = 32;
constexpr int LERP_THREADS = LERP_PX * kChannels;
constexpr int LERP_WARPS = LERP_THREADS / 32;
constexpr int LERP_BATCH = 2;   // x-lerp steps whose loads a thread issues together
constexpr unsigned kAll = 0xffffffffu;

// A step's rows ry, ry + 1, lanes rx, rx + 1 and y-weights at one pixel.
struct Tap {
    int ry, rx;
    float wlo, whi;
};

// The pixel's tap: in the cell mode its y-weights where a step owns it
// (rows and lanes come with the step); else all of it, the same every step.
__device__ __forceinline__ Tap pixel_tap(float f0, float f1, float f2, int R, int mode)
{
    Tap k;
    k.ry = (int)rintf(__fmul_rn(f2, (float)(R - 8)));
    k.rx = (int)rintf(__fmul_rn(f0, (float)(kLanes - 8)));
    const float one_m = __fsub_rn(1.0f, f1);
    k.wlo = (mode & kWArea) ? __fmul_rn(f2, one_m) : one_m;
    k.whi = (mode & kWArea) ? __fmul_rn(f2, f1) : f1;
    if (mode & kBf16) {
        k.wlo = round_bf16(k.wlo);
        k.whi = round_bf16(k.whi);
    }
    return k;
}

// The tap of a step whose cell starts at (ox, oy) in the cell mode: rows and
// lanes relative to the cell where it owns the pixel (base texel inside the
// cell and the source: in_src), else none (the step then adds +0).
__device__ __forceinline__ Tap cell_tap(Tap k, int bx, int by, int ox, int oy, int lt, bool in_src)
{
    const int rel_x = bx - ox, rel_y = by - oy;
    const bool own = in_src && rel_y >= 0 && rel_y < lt && rel_x >= 0 && rel_x < lt;
    k.ry = own ? rel_y : -2;
    k.rx = own ? rel_x : -2;
    return k;
}

__device__ __forceinline__ float texel(float v, bool bf16)
{
    return bf16 ? round_bf16(v) : v;
}

// One column of the two-hot dot: the sequential fma over the rows, whose
// zero-weight rows add exactly nothing.
__device__ __forceinline__ float two_hot(float lo, float hi, bool lo_ok, bool hi_ok, float wlo, float whi)
{
    const float acc = lo_ok ? __fmul_rn(lo, wlo) : 0.0f;
    return hi_ok ? __fmaf_rn(hi, whi, acc) : acc;
}

// The texels an x-lerp reads at tap k of channel c0 / 128 of a cell's rows
// tc: rows ry, ry + 1 at lanes rx, rx + 1, read at indices clamped into the
// cell whether used or not (loads without a branch).
struct Quad {
    float la, lb, ha, hb;
};

__device__ __forceinline__ Quad load_quad(const float* __restrict__ tc, Tap k, int R, int c0)
{
    constexpr int cw = kChannels * kLanes;
    const float* lo = tc + (ptrdiff_t)min(max(k.ry, 0), R - 1) * cw + c0;
    const float* hi = tc + (ptrdiff_t)min(max(k.ry + 1, 0), R - 1) * cw + c0;
    const int ca = min(max(k.rx, 0), kLanes - 1), cb = min(max(k.rx + 1, 0), kLanes - 1);
    return {__ldg(lo + ca), __ldg(lo + cb), __ldg(hi + ca), __ldg(hi + cb)};
}

// The x-lerp of those texels: the only two nonzero terms of the one-hot
// reduce.
__device__ __forceinline__ float xlerp(Quad q, Tap k, float f0, int R, bool bf16)
{
    const bool lo_ok = k.ry >= 0 && k.ry < R, hi_ok = k.ry + 1 >= 0 && k.ry + 1 < R;
    const bool a_ok = k.rx >= 0 && k.rx < kLanes, b_ok = k.rx + 1 >= 0 && k.rx + 1 < kLanes;
    const float la = texel(q.la, bf16), lb = texel(q.lb, bf16), ha = texel(q.ha, bf16), hb = texel(q.hb, bf16);
    const float a = a_ok ? __fmul_rn(__fsub_rn(1.0f, f0), two_hot(la, ha, lo_ok, hi_ok, k.wlo, k.whi)) : 0.0f;
    const float b = b_ok ? __fmul_rn(f0, two_hot(lb, hb, lo_ok, hi_ok, k.wlo, k.whi)) : 0.0f;
    return __fadd_rn(__fadd_rn(0.0f, a), b);
}

// The 128-lane sum of channel c0 / 128 at each of a warp's 32 pixels (taps
// k, selected where sel) over a cell's rows tc; the warp's shared buffers
// s_ry / s_w (2 x 32) / terms (32 x 33). A selected pixel whose rows lie
// outside the cell gets the sum of 128 zeros, +0.
__device__ __forceinline__ float lane_sum(const float* __restrict__ tc, Tap k, bool sel, int R, int c0, bool bf16,
                                          int* __restrict__ s_ry, float* __restrict__ s_w,
                                          float* __restrict__ terms)
{
    constexpr int cw = kChannels * kLanes;
    const int lane = threadIdx.x % 32;
    const bool needs = sel && ((k.ry >= 0 && k.ry < R) || (k.ry + 1 >= 0 && k.ry + 1 < R));
    const unsigned need = __ballot_sync(kAll, needs);
    float total = 0.0f;
    if (!need) return total;
    s_ry[lane] = needs ? k.ry : -2;
    s_w[lane] = k.wlo;
    s_w[32 + lane] = k.whi;
    __syncwarp();
    const float* col = tc + c0 + lane;
    for (int blk = 0; blk < kLanes; blk += 32) {
        // Every pixel's two rows (clamped into the cell): all 64 loads
        // issued, without a branch, before the terms that use them.
        float lo[32], hi[32];
#pragma unroll
        for (int q = 0; q < 32; ++q) {
            const int ry = s_ry[q];
            lo[q] = __ldg(col + (ptrdiff_t)min(max(ry, 0), R - 1) * cw + blk);
            hi[q] = __ldg(col + (ptrdiff_t)min(max(ry + 1, 0), R - 1) * cw + blk);
        }
#pragma unroll
        for (int q = 0; q < 32; ++q) {
            const int ry = s_ry[q];
            const bool lo_ok = ry >= 0 && ry < R, hi_ok = ry + 1 >= 0 && ry + 1 < R;
            terms[q * 33 + lane] = two_hot(texel(lo[q], bf16), texel(hi[q], bf16), lo_ok, hi_ok, s_w[q], s_w[32 + q]);
        }
        __syncwarp();
        if (needs) {
            float sum = 0.0f;
#pragma unroll
            for (int j = 0; j < 32; ++j) sum = __fadd_rn(sum, terms[lane * 33 + j]);
            total = __fadd_rn(total, sum);
        }
        __syncwarp();
    }
    return total;
}

template <bool XLERP>
__global__ void __launch_bounds__(LERP_THREADS) lerp_kernel(
    const float* __restrict__ t, const float* __restrict__ f, const int* __restrict__ coords,
    const int* __restrict__ st, const int* __restrict__ sc, const int* __restrict__ sf, float* __restrict__ out,
    int R, int npx, int npb, int S, int gx, int lt, int hs, int ws, int mode)
{
    constexpr int NT = LERP_THREADS, NW = LERP_WARPS;
    __shared__ int s_cell[NT], s_ox[NT], s_oy[NT], s_fl[NT], s_count[NW], s_last;
    // 128-lane sum: per warp, its pixels' rows and weights and a 32 x 32
    // block of terms (a row per pixel, padded against bank conflicts).
    constexpr int TW = XLERP ? 1 : NW, TQ = XLERP ? 1 : 32;
    __shared__ int s_ry[TW][TQ];
    __shared__ float s_w[TW][2 * TQ], s_terms[TW][TQ * 33];
    const int T = blockIdx.y, tid = threadIdx.x, lane = tid % 32, warp = tid / 32, c = warp;
    const int p0 = blockIdx.x * LERP_PX, p = p0 + lane;
    const bool live = p < npx, bf16 = mode & kBf16, cell_mode = mode & kYCell;
    const float* fT = f + (size_t)T * 3 * npx;

    // The pixel's inputs and output, loaded before the scan below.
    float* o = out + (size_t)T * kOutRows * npx + p;
    float acc = 0.0f, f0 = 0.0f, f1 = 0.0f, f2 = 0.0f;
    int bx = 0, by = 0;
    if (live) {
        acc = o[(size_t)c * npx];
        f0 = fT[p];
        f1 = fT[npx + p];
        f2 = fT[2 * npx + p];
        if (cell_mode) {
            bx = coords[(size_t)T * 2 * npx + p];
            by = coords[((size_t)T * 2 + 1) * npx + p];
        }
    }

    // The tile's last init step, or -1.
    if (tid == 0) s_last = -1;
    __syncthreads();
    if (mode & kInit) {
        int last = -1;
#pragma unroll 4
        for (int s = tid; s < S; s += NT) {
            const int tile = st[s], fl = sf[s];
            if (tile == T && ((fl >> 4) & 1)) last = s;
        }
        last = __reduce_max_sync(kAll, last);
        if (lane == 0 && last >= 0) atomicMax(&s_last, last);
    }
    __syncthreads();
    const int first = s_last;
    if (first >= 0) acc = 0.0f;

    const Tap base = pixel_tap(f0, f1, f2, R, mode);
    const bool in_src = bx >= 0 && bx + 1 < ws && by >= 0 && by + 1 < hs;
    const int band = p / npb;
    const int bands = (2 << ((min(p0 + LERP_PX, npx) - 1) / npb)) - (1 << (p0 / npb));  // the CTA's band bits
    const bool gate_ok = !(mode & kGate) || fT[0] < 1.0f;

    // Step k's tap and cell rows at this thread's pixel.
    auto step_tap = [&](int k) {
        return cell_mode ? cell_tap(base, bx, by, s_ox[k], s_oy[k], lt, in_src) : base;
    };
    auto rows = [&](int k) { return t + (size_t)s_cell[k] * R * kChannels * kLanes; };
    auto selected = [&](int k) { return live && ((s_fl[k] >> band) & 1); };

    for (int round = max(first, 0); gate_ok && round < S; round += NT) {
        // Compact this round's steps of the tile, in order.
        const int s = round + tid, sl = min(s, S - 1);
        const int tile = st[sl], fl = sf[sl], cell = sc[sl];
        const bool take = s < S && tile == T && (fl & bands);
        const unsigned m = __ballot_sync(kAll, take);
        if (lane == 0) s_count[warp] = __popc(m);
        __syncthreads();
        int at = __popc(m & ((1u << lane) - 1)), n = 0;
        for (int w = 0; w < NW; ++w) {
            at += w < warp ? s_count[w] : 0;
            n += s_count[w];
        }
        if (take) {
            const int cy = cell / gx;
            s_cell[at] = cell;
            s_ox[at] = (cell - cy * gx) * lt;
            s_oy[at] = cy * lt;
            s_fl[at] = fl;
        }
        __syncthreads();

        if constexpr (XLERP) {
            for (int k0 = 0; k0 < n; k0 += LERP_BATCH) {
                // The batch's loads (past the end: the last step again, not
                // added), all issued before the arithmetic.
                Tap taps[LERP_BATCH];
                Quad quads[LERP_BATCH];
#pragma unroll
                for (int i = 0; i < LERP_BATCH; ++i) {
                    const int k = min(k0 + i, n - 1);
                    taps[i] = step_tap(k);
                    quads[i] = load_quad(rows(k), taps[i], R, c * kLanes);
                }
#pragma unroll
                for (int i = 0; i < LERP_BATCH; ++i)
                    if (k0 + i < n && selected(k0 + i)) acc = __fadd_rn(acc, xlerp(quads[i], taps[i], f0, R, bf16));
            }
        } else {
            for (int k = 0; k < n; ++k) {
                const float v = lane_sum(rows(k), step_tap(k), selected(k), R, c * kLanes, bf16, s_ry[warp],
                                         s_w[warp], s_terms[warp]);
                if (selected(k)) acc = __fadd_rn(acc, v);
            }
        }
        __syncthreads();
    }
    if (live) {
        o[(size_t)c * npx] = acc;
        if (first >= 0) o[(size_t)(kChannels + c) * npx] = 0.0f;
    }
}

// P1's instance for (bf16, mode), through f(instance).
template <typename F>
int dot_instance(bool bf16, int mode, F f)
{
    switch (mode) {
        case kDotScalar: return bf16 ? f(dot_kernel<true, kDotScalar>) : f(dot_kernel<false, kDotScalar>);
        case kDotVec: return bf16 ? f(dot_kernel<true, kDotVec>) : f(dot_kernel<false, kDotVec>);
        case kDotVecT: return bf16 ? f(dot_kernel<true, kDotVecT>) : f(dot_kernel<false, kDotVecT>);
        default: return (int)cudaErrorInvalidValue;
    }
}

size_t dot_smem(int K)
{
    return (size_t)(K < DOT_KC ? K : DOT_KC) * (DOT_TM + DOT_TN) * sizeof(float);
}

}  // namespace

extern "C" {

// P1: out (M, N) f32 = a^T b over K rows; a (K, M) f32, or (M, K) when
// transposed != 0; b (K, N) f32; all contiguous. bf16 != 0 rounds both
// operands to bf16.
int p1_probe_dot(const void* a, const void* b, void* out, int K, int M, int N, int transposed, int bf16,
                 void* stream)
{
    if (M <= 0 || N <= 0) return (int)cudaGetLastError();
    const bool aligned = (((uintptr_t)a | (uintptr_t)b | (uintptr_t)out) & 15) == 0 && N % 4 == 0;
    const int mode = !aligned ? kDotScalar : !transposed ? (M % 4 == 0 ? kDotVec : kDotScalar)
                                                         : (K % 4 == 0 ? kDotVecT : kDotScalar);
    const int a_sr = transposed ? 1 : M, a_si = transposed ? K : 1;
    const dim3 grid((N + DOT_TN - 1) / DOT_TN, (M + DOT_TM - 1) / DOT_TM);
    return dot_instance(bf16 != 0, mode, [&](auto kernel) {
        kernel<<<grid, DOT_THREADS, dot_smem(K), (cudaStream_t)stream>>>(
            (const float*)a, (const float*)b, (float*)out, K, M, N, a_sr, a_si);
        return (int)cudaGetLastError();
    });
}

// Registers, spills, shared memory and resident CTAs per SM (at K's dynamic
// shared memory) of P1's instance `which` = 2 * mode + bf16, mode 0 scalar,
// 1 vector, 2 vector transposed (kernel_info.cuh). info: 5 ints.
int p1_kernel_info(int which, int K, void* info)
{
    return dot_instance(which & 1, which >> 1, [&](auto kernel) {
        return kernel_info(kernel, DOT_THREADS, dot_smem(K), (int*)info);
    });
}

// P2 v1 / v2: out rows 0-3 of (8, n) f32 get (or, with accumulate, add) the
// x-weighted 128-lane sums of r2 (512, n) f32; x (128, n) f32.
int p2_probe_reduce(const void* r2, const void* x, void* out, int n, int accumulate, void* stream)
{
    if (n > 0) {
        const dim3 grid((n + 31) / 32, kChannels);
        reduce_kernel<<<grid, RED_THREADS, 0, (cudaStream_t)stream>>>(
            (const float*)r2, (const float*)x, (float*)out, n, accumulate);
    }
    return (int)cudaGetLastError();
}

// P2 v3-v7, P3: out (nT, 8, npx) f32 updated in place by the S steps (st tile,
// sc cell, sf flags; int32) over t (cells, R, 512) f32, f (nT, 3, npx) f32
// and, in the cell mode, coords (nT, 2, npx) int32 (else null).
int p3_probe_lerp(const void* t, const void* f, const void* coords, const void* st, const void* sc, const void* sf,
                  void* out, int n_tiles, int R, int npx, int npb, int S, int gx, int lt, int hs, int ws, int mode,
                  void* stream)
{
    if (n_tiles > 0 && npx > 0) {
        const dim3 grid((npx + LERP_PX - 1) / LERP_PX, n_tiles);
        const bool x = mode & kXLerp;
        auto kernel = x ? lerp_kernel<true> : lerp_kernel<false>;
        kernel<<<grid, LERP_THREADS, 0, (cudaStream_t)stream>>>(
            (const float*)t, (const float*)f, (const int*)coords, (const int*)st, (const int*)sc, (const int*)sf,
            (float*)out, R, npx, npb, S, gx, lt, hs, ws, mode);
    }
    return (int)cudaGetLastError();
}

// Registers, spills, shared memory and resident CTAs per SM (kernel_info.cuh)
// of P2's reduce_kernel (which = 0) and of P3's lerp_kernel, x-lerp (1) or
// 128-lane sum (2). info: 5 ints.
int p23_kernel_info(int which, void* info)
{
    switch (which) {
        case 0: return kernel_info(reduce_kernel, RED_THREADS, 0, (int*)info);
        case 1: return kernel_info(lerp_kernel<true>, LERP_THREADS, 0, (int*)info);
        case 2: return kernel_info(lerp_kernel<false>, LERP_THREADS, 0, (int*)info);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
