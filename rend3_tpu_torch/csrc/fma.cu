// F1: the float32 fused multiply-add forms of the frame, elementwise.
//
// Replaces no Pallas kernel: XLA:CPU contracts the JAX frame's sums into
// fmas (a product whose value has one use in a fusion is fused into the
// add that reads it), and the port's ops/fp.py computes those forms. On the
// card this kernel computes them; on the CPU the plain versions in fp.py
// emulate the same correctly rounded fma in float64 (fma32_plain).
//
// What it computes, one output element from the broadcast inputs:
//   FMA          fma(a, b, c)
//   DOT3         fma(a2, b2, fma(a1, b1, a0*b0))        (x = a0 b0 a1 b1 a2 b2)
//   AB_MINUS_CD  fma(a, b, -(c*d))
// Every fma is __fmaf_rn and every product __fmul_rn, so nothing is fused
// that the JAX form does not fuse (the build also passes --fmad=false). The
// build uses no --use_fast_math, so subnormals are kept (no flush to zero),
// and __fmaf_rn is the IEEE correctly rounded fma: every finite result,
// signed zero and infinity equals the emulation's bit for bit; a NaN is a
// NaN in both (its payload may differ).
//
// Layout. The wrapper broadcasts the inputs (torch.broadcast_tensors) and
// passes the expanded sizes and each input's strides in elements, with
// contiguous dimensions merged and size-1 dimensions dropped (at most 6
// left); a stride of 0 is a broadcast, read again and never copied. The
// output is contiguous, so its row-major index is the loop index.
//
// What bounds it on the H100: bytes. It does 1-3 f32 operations per 12-28
// bytes moved (a broadcast input is read once per distinct element), far
// below the 20 operations a byte at which the f32 units would bind. So the
// design only keeps the memory system busy: a grid-stride loop over 256-
// thread CTAs, 8 CTAs per SM (the SM's 2,048 threads), 64-bit indices
// where the output or an input's reach passes 2^31 elements and 32-bit
// arithmetic otherwise. Two instances by layout:
//   rows4    the innermost size a multiple of 4 (a contiguous input, and
//            the frame's broadcasts: _shadow_coords' (rows, 1, 1) x
//            (1, H, W), the clip transform's (T, 1, 4) x (T, 3, 1)): four
//            outputs a thread and one 16-byte store, the index split into
//            coordinates once per four (a division per dimension), and per
//            input one load where its innermost stride is 0, one 16-byte
//            load where it is 1 and its rows are aligned, four loads at the
//            stride otherwise;
//   strided  anything else: one element a thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_info.cuh"

namespace {

constexpr int kMaxDims = 6;
constexpr int kMaxIn = 6;
constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;

enum Form { FMA = 0, DOT3 = 1, AB_MINUS_CD = 2 };

template <int FORM>
struct Arity;
template <>
struct Arity<FMA> { static constexpr int n = 3; };
template <>
struct Arity<DOT3> { static constexpr int n = 6; };
template <>
struct Arity<AB_MINUS_CD> { static constexpr int n = 4; };

struct Params {
    const float* x[kMaxIn];
    float* out;
    long long n;
    int ndim;
    int size[kMaxDims];
    int stride[kMaxIn][kMaxDims];
    int inner[kMaxIn];  // rows4: per input, 0 broadcast, 1 a 16-byte load, 2 four loads at its stride
};

template <int FORM>
__device__ __forceinline__ float apply(const float* v)
{
    if constexpr (FORM == FMA) {
        return __fmaf_rn(v[0], v[1], v[2]);
    } else if constexpr (FORM == DOT3) {
        return __fmaf_rn(v[4], v[5], __fmaf_rn(v[2], v[3], __fmul_rn(v[0], v[1])));
    } else {
        return __fmaf_rn(v[0], v[1], -__fmul_rn(v[2], v[3]));
    }
}

template <int FORM>
__device__ __forceinline__ float4 apply4(const float4* v4)
{
    constexpr int N = Arity<FORM>::n;
    float v[N];
    float4 o;
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = v4[k].x;
    o.x = apply<FORM>(v);
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = v4[k].y;
    o.y = apply<FORM>(v);
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = v4[k].z;
    o.z = apply<FORM>(v);
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = v4[k].w;
    o.w = apply<FORM>(v);
    return o;
}

// Each input's offset at the output's row-major index i: one division per
// dimension.
template <int N, typename Index>
__device__ __forceinline__ void offsets(const Params& p, Index i, Index* off)
{
#pragma unroll
    for (int k = 0; k < N; ++k) off[k] = 0;
    for (int d = p.ndim - 1; d >= 0; --d) {
        const Index s = (Index)p.size[d];
        const Index q = i / s;
        const Index r = i - q * s;
        i = q;
#pragma unroll
        for (int k = 0; k < N; ++k) off[k] += r * (Index)p.stride[k][d];
    }
}

// Any layout: one element a thread. Index is uint32_t when the output and
// every input's largest offset stay below 2^31, else int64_t.
template <int FORM, typename Index>
__global__ void __launch_bounds__(kThreads) strided_kernel(Params p)
{
    constexpr int N = Arity<FORM>::n;
    const Index n = (Index)p.n;
    for (Index i = (Index)blockIdx.x * kThreads + threadIdx.x; i < n; i += (Index)gridDim.x * kThreads) {
        Index off[N];
        offsets<N>(p, i, off);
        float v[N];
#pragma unroll
        for (int k = 0; k < N; ++k) v[k] = __ldg(p.x[k] + off[k]);
        p.out[i] = apply<FORM>(v);
    }
}

// The innermost size a multiple of 4: four outputs of one row a thread.
template <int FORM, typename Index>
__global__ void __launch_bounds__(kThreads) rows4_kernel(Params p)
{
    constexpr int N = Arity<FORM>::n;
    const Index n4 = (Index)(p.n >> 2);
    const int last = p.ndim - 1;
    for (Index i = (Index)blockIdx.x * kThreads + threadIdx.x; i < n4; i += (Index)gridDim.x * kThreads) {
        Index off[N];
        offsets<N>(p, i << 2, off);
        float4 v4[N];
#pragma unroll
        for (int k = 0; k < N; ++k) {
            const float* x = p.x[k] + off[k];
            if (p.inner[k] == 1) {
                v4[k] = __ldg(reinterpret_cast<const float4*>(x));
            } else if (p.inner[k] == 0) {
                const float a = __ldg(x);
                v4[k] = make_float4(a, a, a, a);
            } else {
                const Index s = (Index)p.stride[k][last];
                v4[k] = make_float4(__ldg(x), __ldg(x + s), __ldg(x + 2 * s), __ldg(x + 3 * s));
            }
        }
        reinterpret_cast<float4*>(p.out)[i] = apply4<FORM>(v4);
    }
}

// The paths, by instance index within a form.
enum Path { STRIDED32 = 0, STRIDED64 = 1, ROWS4_32 = 2, ROWS4_64 = 3, N_PATHS = 4 };

template <int FORM, typename F>
int by_path(int path, F f)
{
    switch (path) {
        case STRIDED32: return f(strided_kernel<FORM, uint32_t>, 1);
        case STRIDED64: return f(strided_kernel<FORM, int64_t>, 1);
        case ROWS4_32: return f(rows4_kernel<FORM, uint32_t>, 4);
        case ROWS4_64: return f(rows4_kernel<FORM, int64_t>, 4);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The instance for (form, path) through f(kernel, elements per thread).
template <typename F>
int by_instance(int form, int path, F f)
{
    switch (form) {
        case FMA: return by_path<FMA>(path, f);
        case DOT3: return by_path<DOT3>(path, f);
        case AB_MINUS_CD: return by_path<AB_MINUS_CD>(path, f);
        default: return (int)cudaErrorInvalidValue;
    }
}

int arity(int form) { return form == FMA ? 3 : form == DOT3 ? 6 : 4; }

}  // namespace

extern "C" {

// F1: out = the form's value at every element of the broadcast shape.
// x0..x5: the form's inputs in order (FMA a, b, c; DOT3 a0, b0, a1, b1,
// a2, b2; AB_MINUS_CD a, b, c, d), float32, the unused ones null; out
// float32, contiguous. form: 0 FMA, 1 DOT3, 2 AB_MINUS_CD; ndim <= 6 and
// s0..s5 the (merged) sizes; t[6 k + d] input k's stride in elements along
// dimension d, each >= 0. Launches nothing for an empty output. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a form,
// ndim, size or stride out of range).
int f1_fma(const void* x0, const void* x1, const void* x2, const void* x3, const void* x4, const void* x5,
           void* out, int form, int ndim, int s0, int s1, int s2, int s3, int s4, int s5,
           int t0, int t1, int t2, int t3, int t4, int t5, int t6, int t7, int t8, int t9, int t10, int t11,
           int t12, int t13, int t14, int t15, int t16, int t17, int t18, int t19, int t20, int t21, int t22,
           int t23, int t24, int t25, int t26, int t27, int t28, int t29, int t30, int t31, int t32, int t33,
           int t34, int t35, void* stream)
{
    const void* xs[kMaxIn] = {x0, x1, x2, x3, x4, x5};
    const int sizes[kMaxDims] = {s0, s1, s2, s3, s4, s5};
    const int strides[kMaxIn * kMaxDims] = {t0, t1, t2, t3, t4, t5, t6, t7, t8, t9, t10, t11,
                                            t12, t13, t14, t15, t16, t17, t18, t19, t20, t21, t22, t23,
                                            t24, t25, t26, t27, t28, t29, t30, t31, t32, t33, t34, t35};
    if (form < FMA || form > AB_MINUS_CD || ndim < 0 || ndim > kMaxDims) return (int)cudaErrorInvalidValue;
    const int n_in = arity(form);
    Params p = {};
    p.out = (float*)out;
    p.ndim = ndim;
    p.n = 1;
    for (int d = 0; d < ndim; ++d) {
        if (sizes[d] < 0) return (int)cudaErrorInvalidValue;
        p.size[d] = sizes[d];
        p.n *= sizes[d];
    }
    // The largest offset any input reaches, for the index width; which
    // path the layout takes.
    long long reach = p.n;
    const bool rows = ndim >= 1 && sizes[ndim - 1] % 4 == 0 && ((uintptr_t)out % 16) == 0;
    for (int k = 0; k < n_in; ++k) {
        if (xs[k] == nullptr) return (int)cudaErrorInvalidValue;
        p.x[k] = (const float*)xs[k];
        long long last = 0;
        bool outer4 = true;  // every row of the input starts on a 16-byte boundary
        for (int d = 0; d < ndim; ++d) {
            const int s = strides[k * kMaxDims + d];
            if (s < 0) return (int)cudaErrorInvalidValue;
            p.stride[k][d] = s;
            last += (long long)(sizes[d] - 1) * s;
            outer4 = outer4 && (d == ndim - 1 || s % 4 == 0);
        }
        reach = last + 1 > reach ? last + 1 : reach;
        const int inner = ndim >= 1 ? p.stride[k][ndim - 1] : 0;
        const bool aligned = ((uintptr_t)xs[k] % 16) == 0 && outer4;
        p.inner[k] = inner == 0 ? 0 : (inner == 1 && aligned) ? 1 : 2;
    }
    if (p.n == 0) return (int)cudaGetLastError();
    const bool narrow = reach < (1LL << 31);
    const int path = rows ? (narrow ? ROWS4_32 : ROWS4_64) : (narrow ? STRIDED32 : STRIDED64);
    int dev = 0, n_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    return by_instance(form, path, [&](auto kernel, int per_thread) {
        const long long work = (p.n + per_thread - 1) / per_thread;
        const long long want = (work + kThreads - 1) / kThreads;
        const long long cap = (long long)n_sm * kCtasPerSm;
        const int blocks = (int)(want < cap ? want : cap);
        kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
        return (int)cudaGetLastError();
    });
}

// Registers, spills, shared memory and resident CTAs per SM of F1's
// instance `which` = 4 * form + path (Path: strided with 32-bit indices,
// strided with 64-bit, rows4 with 32-bit, rows4 with 64-bit), as
// kernel_info.cuh reports them.
int f1_kernel_info(int which, void* info)
{
    return by_instance(which / N_PATHS, which % N_PATHS,
                       [&](auto kernel, int) { return kernel_info(kernel, kThreads, 0, (int*)info); });
}

}  // extern "C"
