// K4: weighted bilinear texture gather for Hopper.
//
// Replaces: rend3_tpu/ops/mxu_gather.py sample_grid_bilinear
// (mxu_gather.py:645, pallas_call at :807), as the texture sampler calls it
// with the default bf16 dot (ops/texture.py sample_textures_grid).
//
// What it computes. Per query i: wt * bilerp(atlas, by + fy, bx + fx) for
// the 4 interleaved channels of a bf16 (AH, AW, 4) atlas, written planar to
// out (4, q). A query that is invalid, or whose 2x2 footprint leaves the
// atlas (bx < 0, bx + 1 >= AW, by < 0, by + 1 >= AH: the `own` mask of
// mxu_gather.py:762-763), gets 0.
//
// Numerics, matched bit for bit with the JAX kernel as XLA:CPU runs it
// (the reference the tests use) and with the plain version
// (ops/samplers.py sample_grid_bilinear_plain):
//   - texels are bf16;
//   - the y-weights wt*(1-fy) and wt*fy are computed in f32 and rounded to
//     bf16 (they ride in the kernel's bf16 one-hot matrix, :768 and :785);
//   - each column's two y-products are exact in f32 and summed once;
//   - the x-lerp is (1-fx)*left + fx*right: two f32 products, one add
//     (XLA:CPU does not contract this reduce into an fma).
// Separate __fmul_rn / __fadd_rn under --fmad=false keep that order. The
// per-query arithmetic is samplers.cuh's bilinear_query, which D1
// (deferred_shade.cu) shares.
//
// What bounds it on the H100: memory latency. A query reads 21 bytes of
// inputs, four 8-byte texels (one load each, thanks to the interleaved
// layout; neighbouring pixels hit the same L1/L2 lines) and writes 16 bytes.
// The TPU kernel selects rows with a one-hot matmul on the MXU per (screen
// tile, atlas cell) pair because a per-lane gather is slow there; here the
// design is one thread per query with direct loads, no pair lists and no
// pre-tiled copy of the atlas.

#include <cuda_runtime.h>
#include <stdint.h>

#include "samplers.cuh"

namespace {

__global__ void __launch_bounds__(256) bilinear_kernel(
    const uint2* __restrict__ atlas, const int* __restrict__ bx, const int* __restrict__ by,
    const float* __restrict__ fx, const float* __restrict__ fy, const float* __restrict__ wt,
    const bool* __restrict__ valid, float* __restrict__ out, int ah, int aw, int q)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= q) return;
    float v[4];
    bilinear_query(atlas, ah, aw, bx[i], by[i], fx[i], fy[i], wt[i], valid[i], v);
#pragma unroll
    for (int c = 0; c < 4; ++c) out[(size_t)c * q + i] = v[c];
}

}  // namespace

extern "C" {

// K4: out (4, q) f32 over q queries; atlas (ah, aw, 4) bf16; bx, by int32;
// fx, fy, wt f32; valid bool (1 byte). Returns cudaGetLastError() after the
// launch.
int k4_bilinear(const void* atlas, const void* bx, const void* by, const void* fx, const void* fy,
                const void* wt, const void* valid, void* out, int ah, int aw, int q, void* stream)
{
    if (q > 0) {
        bilinear_kernel<<<(q + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
            (const uint2*)atlas, (const int*)bx, (const int*)by, (const float*)fx, (const float*)fy,
            (const float*)wt, (const bool*)valid, (float*)out, ah, aw, q);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
