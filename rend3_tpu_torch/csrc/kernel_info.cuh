// What the CUDA runtime reports of a compiled kernel, for chip_smoke.py's
// kernel lines: the *_kernel_info functions of raster.cu, gather.cu and
// probe_bf16.cu call it on one instance each.

#pragma once

#include <cuda_runtime.h>

// info[0..4]: registers a thread, local (spill) bytes a thread, static
// shared bytes a CTA, resident CTAs per SM at `threads` threads and
// `dyn_smem` bytes of dynamic shared memory a CTA
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and the SM count.
template <typename K>
inline int kernel_info(K kernel, int threads, size_t dyn_smem, int* info)
{
    cudaFuncAttributes attr;
    int per_sm = 0, dev = 0, n_sm = 0;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, dyn_smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    info[0] = attr.numRegs;
    info[1] = (int)attr.localSizeBytes;
    info[2] = (int)attr.sharedSizeBytes;
    info[3] = per_sm;
    info[4] = n_sm;
    return (int)e;
}
