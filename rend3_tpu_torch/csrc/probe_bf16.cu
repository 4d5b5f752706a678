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
//     found by bit-matching all 524,288 values of the f32 variant). A tiled
//     shared-memory GEMM: 64 x 64 outputs per CTA, 4 x 4 per thread, 16 rows
//     of each operand staged per step. The operand a is read through two
//     strides, so the transposed variant really reads a transposed layout.
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
// What bounds them on the H100: nothing the card feels. P1 moves 2.5 MB and
// does 75.5 MFLOP (about 1.1 us at the f32 peak); the others less. A launch
// (3-5 us) dominates. The design is the simple, right one: direct loads in
// place of one-hot matmuls (the rule that turned K4 into a gather), a
// hand-written GEMM for the one dense product.

#include <cuda_runtime.h>
#include <stdint.h>

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

template <bool BF16>
__global__ void __launch_bounds__(256) dot_kernel(
    const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
    int K, int M, int N, int a_sr, int a_si)
{
    __shared__ float as[16][64];
    __shared__ float bs[16][64];
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int i0 = blockIdx.y * 64, j0 = blockIdx.x * 64;
    float acc[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += 16) {
        for (int e = threadIdx.x; e < 16 * 64; e += 256) {
            const int kk = e / 64, c = e % 64, r = k0 + kk;
            float va = 0.0f, vb = 0.0f;
            if (r < K && i0 + c < M) va = a[(size_t)r * a_sr + (size_t)(i0 + c) * a_si];
            if (r < K && j0 + c < N) vb = b[(size_t)r * N + j0 + c];
            as[kk][c] = BF16 ? round_bf16(va) : va;
            bs[kk][c] = BF16 ? round_bf16(vb) : vb;
        }
        __syncthreads();
        const int kn = min(16, K - k0);
        for (int kk = 0; kk < kn; ++kk) {
            float av[4], bv[4];
#pragma unroll
            for (int x = 0; x < 4; ++x) av[x] = as[kk][ty * 4 + x];
#pragma unroll
            for (int y = 0; y < 4; ++y) bv[y] = bs[kk][tx * 4 + y];
#pragma unroll
            for (int x = 0; x < 4; ++x)
#pragma unroll
                for (int y = 0; y < 4; ++y) acc[x][y] = __fmaf_rn(av[x], bv[y], acc[x][y]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
        const int i = i0 + ty * 4 + x;
        if (i >= M) continue;
#pragma unroll
        for (int y = 0; y < 4; ++y) {
            const int j = j0 + tx * 4 + y;
            if (j < N) out[(size_t)i * N + j] = acc[x][y];
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

}  // namespace

extern "C" {

// P1: out (M, N) f32 = a^T b over K rows; a element (r, i) at a[r * a_sr +
// i * a_si], b (K, N) f32 contiguous; bf16 != 0 rounds both operands to bf16.
int p1_probe_dot(const void* a, const void* b, void* out, int K, int M, int N, int a_sr, int a_si, int bf16,
                 void* stream)
{
    if (M > 0 && N > 0) {
        const dim3 grid((N + 63) / 64, (M + 63) / 64);
        if (bf16)
            dot_kernel<true><<<grid, 256, 0, (cudaStream_t)stream>>>(
                (const float*)a, (const float*)b, (float*)out, K, M, N, a_sr, a_si);
        else
            dot_kernel<false><<<grid, 256, 0, (cudaStream_t)stream>>>(
                (const float*)a, (const float*)b, (float*)out, K, M, N, a_sr, a_si);
    }
    return (int)cudaGetLastError();
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
