// K3: fused PCF5 shadow resolve for Hopper.
//
// Replaces: rend3_tpu/ops/mxu_gather.py sample_grid_pcf5 (mxu_gather.py:424,
// pallas_call at :591).
//
// What it computes. Per pixel: the 12 texels around the base texel
// (bx, by) = floor(s - 0.5) of the row-stacked shadow maps, each compared
// GreaterEqual against `ref`; the five bilinear taps of PCF5 (centre and the
// four neighbours, mxu_gather.py:570-577) blended with (fx, fy) and scaled
// by 0.2. A texel outside the stacked image reads 0.0, as the JAX zero
// padding and gap rows give (shadow.py:669-684). A pixel that is invalid or
// whose base texel lies outside the image gets 0; the caller substitutes 1.0
// (shadow.py:757-759).
//
// Numerics: separate IEEE multiplies and adds in the order of the plain
// version (ops/samplers.py), built with --fmad=false, so the two agree bit
// for bit. The JAX kernel contracts some of these under XLA:CPU and skips
// fully lit cells; both differ from this by rounding only (the tests hold
// K3 to 1e-6). The per-query arithmetic is samplers.cuh's pcf5_query, which
// D1 (deferred_shade.cu) shares.
//
// What bounds it on the H100: memory. Per pixel it reads 6 inputs (25 bytes)
// and writes 4 bytes; the 12 texel loads hit L1/L2, since neighbouring
// pixels sample neighbouring texels of a 16 MB map. The TPU kernel gathers by
// one-hot matmuls on the MXU over (screen tile, map cell) pair lists,
// because a per-pixel gather is slow there; on Hopper a gather is a load, so
// the design is one thread per pixel with direct loads and no pair lists.

#include <cuda_runtime.h>
#include <stdint.h>

#include "samplers.cuh"

namespace {

__global__ void __launch_bounds__(256) pcf5_kernel(
    const float* __restrict__ img, const int* __restrict__ bx, const int* __restrict__ by,
    const float* __restrict__ fx, const float* __restrict__ fy, const float* __restrict__ ref,
    const bool* __restrict__ valid, float* __restrict__ out, int hs, int ws, int n)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    out[i] = pcf5_query(img, hs, ws, bx[i], by[i], fx[i], fy[i], ref[i], valid[i]);
}

}  // namespace

extern "C" {

// K3: out (n) f32 over n pixels; img (hs, ws) f32; bx, by int32; fx, fy,
// ref f32; valid bool (1 byte). Returns cudaGetLastError() after the launch.
int k3_pcf5(const void* img, const void* bx, const void* by, const void* fx, const void* fy,
            const void* ref, const void* valid, void* out, int hs, int ws, int n, void* stream)
{
    if (n > 0) {
        pcf5_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
            (const float*)img, (const int*)bx, (const int*)by, (const float*)fx, (const float*)fy,
            (const float*)ref, (const bool*)valid, (float*)out, hs, ws, n);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
