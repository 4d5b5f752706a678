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
//     order per tile, as the TPU grid runs; one thread per pixel of a tile, a
//     CTA per (tile, 128 pixels), so no atomics and no order across CTAs.
//     Per step: bit 4 of the flags zeroes the pixel's 8 output rows (when the
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
// P2 and P3 are the simple, right design: direct loads in place of one-hot
// matmuls (the rule that turned K4 into a gather).

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

// XLA:CPU's 128-lane sum: four sequential 32-lane sums, then those in order.
template <typename Term>
__device__ __forceinline__ float lane_sum(Term term)
{
    float total = 0.0f;
#pragma unroll
    for (int blk = 0; blk < kLanes; blk += 32) {
        float s = 0.0f;
        for (int j = blk; j < blk + 32; ++j) s = __fadd_rn(s, term(j));
        total = __fadd_rn(total, s);
    }
    return total;
}

__global__ void __launch_bounds__(256) reduce_kernel(
    const float* __restrict__ r2, const float* __restrict__ x, float* __restrict__ out, int n, int accumulate)
{
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    for (int c = 0; c < kChannels; ++c) {
        const float* rc = r2 + (size_t)c * kLanes * n + p;
        const float v = lane_sum([&](int j) { return __fmul_rn(x[(size_t)j * n + p], rc[(size_t)j * n]); });
        float* o = out + (size_t)c * n + p;
        *o = accumulate ? __fadd_rn(*o, v) : v;
    }
}

__global__ void __launch_bounds__(128) lerp_kernel(
    const float* __restrict__ t, const float* __restrict__ f, const int* __restrict__ coords,
    const int* __restrict__ st, const int* __restrict__ sc, const int* __restrict__ sf, float* __restrict__ out,
    int R, int npx, int npb, int S, int gx, int lt, int hs, int ws, int mode)
{
    const int T = blockIdx.y;
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= npx) return;
    const bool bf16 = mode & kBf16;
    const float* fT = f + (size_t)T * 3 * npx;
    float* o = out + (size_t)T * kOutRows * npx + p;
    const int band = p / npb;
    const bool gate_ok = !(mode & kGate) || fT[0] < 1.0f;
    const int cw = kChannels * kLanes;
    for (int s = 0; s < S; ++s) {
        if (st[s] != T) continue;
        const int fl = sf[s];
        if ((mode & kInit) && ((fl >> 4) & 1)) {
            for (int r = 0; r < kOutRows; ++r) o[(size_t)r * npx] = 0.0f;
        }
        if (!gate_ok || !((fl >> band) & 1)) continue;
        const int cell = sc[s];
        const float f0 = fT[p], f1 = fT[npx + p], f2 = fT[2 * npx + p];
        int ry, rx;
        float w;
        if (mode & kYCell) {
            const int cy = cell / gx, cx = cell - cy * gx;
            const int bx = coords[(size_t)T * 2 * npx + p], by = coords[((size_t)T * 2 + 1) * npx + p];
            const int rel_x = bx - cx * lt, rel_y = by - cy * lt;
            const bool own = rel_y >= 0 && rel_y < lt && rel_x >= 0 && rel_x < lt && bx >= 0 && bx + 1 < ws &&
                             by >= 0 && by + 1 < hs;
            ry = own ? rel_y : -2;
            rx = own ? rel_x : -2;
            w = own ? f2 : 0.0f;
        } else {
            ry = (int)rintf(__fmul_rn(f2, (float)(R - 8)));
            rx = (int)rintf(__fmul_rn(f0, (float)(kLanes - 8)));
            w = f2;
        }
        const float one_m = __fsub_rn(1.0f, f1);
        float wlo = (mode & kWArea) ? __fmul_rn(w, one_m) : one_m;
        float whi = (mode & kWArea) ? __fmul_rn(w, f1) : f1;
        if (bf16) {
            wlo = round_bf16(wlo);
            whi = round_bf16(whi);
        }
        const float* tc = t + (size_t)cell * R * cw;
        const bool lo_ok = ry >= 0 && ry < R, hi_ok = ry + 1 >= 0 && ry + 1 < R;
        auto texel = [&](int r, int col) {
            const float v = tc[(size_t)r * cw + col];
            return bf16 ? round_bf16(v) : v;
        };
        // One column of the two-hot dot: the sequential fma over the rows,
        // whose zero-weight rows add exactly nothing.
        auto rcol = [&](int col) {
            float acc = lo_ok ? __fmul_rn(texel(ry, col), wlo) : 0.0f;
            return hi_ok ? __fmaf_rn(texel(ry + 1, col), whi, acc) : acc;
        };
        for (int c = 0; c < kChannels; ++c) {
            const int c0 = c * kLanes;
            float v;
            if (mode & kXLerp) {
                const float a = (rx >= 0 && rx < kLanes) ? __fmul_rn(__fsub_rn(1.0f, f0), rcol(c0 + rx)) : 0.0f;
                const float b = (rx + 1 >= 0 && rx + 1 < kLanes) ? __fmul_rn(f0, rcol(c0 + rx + 1)) : 0.0f;
                v = __fadd_rn(__fadd_rn(0.0f, a), b);
            } else {
                v = lane_sum([&](int j) { return rcol(c0 + j); });
            }
            o[(size_t)c * npx] = __fadd_rn(o[(size_t)c * npx], v);
        }
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
        reduce_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
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
        const dim3 grid((npx + 127) / 128, n_tiles);
        lerp_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
            (const float*)t, (const float*)f, (const int*)coords, (const int*)st, (const int*)sc, (const int*)sf,
            (float*)out, R, npx, npb, S, gx, lt, hs, ws, mode);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
