"""Build, load and call the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled with nvcc, one process per source started
together, and linked into one shared library with a plain C interface,
loaded with ctypes (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -lineinfo -Xcompiler -fPIC -c -o _build/<hash>/<name>.o csrc/<name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o _build/librend3_kernels_<hash>.so _build/<hash>/*.o

The library is built at first use into rend3_tpu_torch/_build/ (listed in
.gitignore); its name carries a hash of the sources, their header and the
flags, so editing a source rebuilds it. --fmad=false keeps nvcc from
contracting a*b + c into an fma anywhere the kernels do not ask for one
explicitly; division and sqrt stay IEEE (no --use_fast_math).

Each C function takes a `c_void_p` per tensor (None passes a null pointer,
for an optional input or output), then ints, then floats, then the CUDA
stream, launches on that stream and returns cudaGetLastError(); `call`
raises on a nonzero code. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

import torch

__all__ = ["build", "library", "call", "kernel_info", "SOURCES", "HEADERS", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("raster.cu", "pcf5.cu", "bilinear.cu", "gather.cu", "shadow_occ.cu", "probe_bf16.cu", "fma.cu",
           "shadow_front.cu", "view_front.cu", "deferred_shade.cu")
HEADERS = ("kernel_info.cuh", "tile_lists.cuh", "front_end.cuh", "samplers.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "--fmad=false", "-lineinfo", "-Xcompiler", "-fPIC")

# name -> (tensor args, int args, float args); every function ends with the stream.
_SIGNATURES = {
    "k1_raster_resolve": (9, 4, 2),
    "k2_raster_depth": (6, 4, 2),
    "k3_pcf5": (8, 3, 0),
    "k4_bilinear": (8, 3, 0),
    "k5_gather": (5, 4 + 2 * 12, 0),
    "k6_raster_vis": (6, 3, 8),
    "k7_shadow_occ": (9, 5, 0),
    "p1_probe_dot": (3, 5, 0),
    "p2_probe_reduce": (3, 2, 0),
    "p3_probe_lerp": (7, 10, 0),
    "launch_floor": (0, 2, 0),
    "f1_fma": (7, 2 + 6 + 6 * 6, 0),
    "s1_shadow_setup": (10, 7 + 2 * 4, 0),
    "s2_tile_scan": (5, 3 + 2 * 4, 0),
    "s2_tile_fill": (4, 4 + 3 * 4, 0),
    "v1_clip_count": (7, 4, 0),
    "v1_clip_fill": (11, 5, 0),
    "v2_cull": (6, 8 + 3 * 12, 4),
    "v2_setup": (7, 2, 2),
    "v3_planes": (17, 7, 2),
    "v4_tiles": (4, 4, 0),
    "d1_deferred_shade": (25, 18, 0),
    "c1_cutout_peel": (14, 6, 0),
}
# name -> int args of the kernel-info functions, which end with an int[5].
_INFO_SIGNATURES = {"raster_kernel_info": 1, "p1_kernel_info": 2, "k5_kernel_info": 1, "occ_kernel_info": 1,
                    "p23_kernel_info": 1, "f1_kernel_info": 1, "shadow_front_kernel_info": 1,
                    "view_front_kernel_info": 1, "d1_kernel_info": 1, "c1_kernel_info": 1}

_lib: Optional[ctypes.CDLL] = None
last_build: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (set CUDA_HOME)")
    return path


def _library_path() -> str:
    h = hashlib.sha1()
    for name in SOURCES + HEADERS:
        with open(os.path.join(_SRC_DIR, name), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"librend3_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels if the library for the current sources is
    missing; returns its path. `verbose` adds -Xptxas -v (registers, shared
    memory and spills per kernel) and keeps the compiler's output in
    `last_build["log"]`."""
    path = _library_path()
    if os.path.exists(path) and not verbose:
        return path
    tmp = f"{path}.{os.getpid()}.tmp"
    obj_dir = f"{tmp}.d"
    os.makedirs(obj_dir, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for s in SOURCES:
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()), "-c"]
        cmd += ["-o", os.path.join(obj_dir, s + ".o"), os.path.join(_SRC_DIR, s)]
        procs.append((s, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    for s, proc in procs:
        out, _ = proc.communicate()
        log.append(f"[{s}]\n{out}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {s} ({proc.returncode}):\n{out}")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *(os.path.join(obj_dir, s + ".o") for s in SOURCES)],
        capture_output=True, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    os.replace(tmp, path)
    shutil.rmtree(obj_dir, ignore_errors=True)
    last_build.update(path=path, seconds=time.perf_counter() - t0, built=True, log="".join(log))
    return path


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, (n_t, n_i, n_f) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = (
                [ctypes.c_void_p] * n_t + [ctypes.c_int] * n_i + [ctypes.c_float] * n_f + [ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
        for name, n_i in _INFO_SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_int] * n_i + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.rend3_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rend3_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def call(name: str, *tensors: torch.Tensor, ints=(), floats=()) -> None:
    """Launch kernel `name` on the current stream of the tensors' device
    (the first tensor's; the current CUDA device for a kernel that takes
    none); a tensor given as None passes a null pointer."""
    n_t, n_i, n_f = _SIGNATURES[name]
    if len(tensors) != n_t or len(ints) != n_i or len(floats) != n_f:
        raise TypeError(f"{name}: expected {n_t} tensors, {n_i} ints, {n_f} floats")
    dev = tensors[0].device if tensors else torch.device("cuda", torch.cuda.current_device())
    if dev.type != "cuda":
        raise ValueError(f"{name}: CUDA kernel called with tensors on {dev}")
    lib = library()
    # Plain Python values: the argtypes set in library() convert them.
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, name)(
            *[None if t is None else t.data_ptr() for t in tensors],
            *[int(i) for i in ints],
            *[float(f) for f in floats],
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: {lib.rend3_cuda_error_string(rc).decode()}")


# The instances of csrc/raster.cu's tiles_kernel and vis_kernel, by
# raster_kernel_info's index.
RASTER_INSTANCES = ("K1", "K1 bound", "K1 count", "K1 bound + count", "K2", "K6 1 sample", "K6 4 samples")
# csrc/shadow_occ.cu occ_kernel's instances, by occ_kernel_info's index.
OCC_INSTANCES = ("K7", "K8")
# P1's instances (csrc/probe_bf16.cu dot_kernel), by p1_kernel_info's index.
P1_INSTANCES = ("f32 scalar", "bf16 scalar", "f32 vector", "bf16 vector", "f32 vector transposed",
                "bf16 vector transposed")
# P2's reduce_kernel and P3's lerp_kernel instances, by p23_kernel_info's index.
P23_INSTANCES = ("P2 reduce_kernel", "P3 lerp_kernel x-lerp", "P3 lerp_kernel 128-lane sum")
# F1's instances (csrc/fma.cu), by f1_kernel_info's index: 4 * form + path.
F1_INSTANCES = tuple(f"F1 {form} {path}" for form in ("fma", "dot3", "ab_minus_cd")
                     for path in ("strided_kernel 32-bit", "strided_kernel 64-bit", "rows4_kernel 32-bit",
                                  "rows4_kernel 64-bit"))
# csrc/shadow_front.cu's kernels, by shadow_front_kernel_info's index.
SHADOW_FRONT_INSTANCES = ("S1 s1_kernel", "S2 scan_kernel", "S2 fill_kernel")
# csrc/view_front.cu's kernels, by view_front_kernel_info's index.
VIEW_FRONT_INSTANCES = ("V1 clip_count_kernel", "V1 clip_fill_kernel", "V2 cull_kernel", "V2 cull_scan_kernel",
                        "V2 setup_kernel", "V3 planes_kernel", "V4 tiles_kernel")
# csrc/deferred_shade.cu's kernel, by d1_kernel_info's index.
D1_INSTANCES = ("D1 d1_kernel",)
# csrc/deferred_shade.cu's C1 kernel, by c1_kernel_info's index.
C1_INSTANCES = ("C1 c1_kernel",)


def kernel_info(fn: str, *ints: int) -> dict:
    """Registers a thread, local (spill) bytes, static shared bytes and
    resident CTAs per SM of one kernel instance, and the SM count, from the
    CUDA runtime on the current device: `raster_kernel_info(which)` for
    RASTER_INSTANCES[which], `occ_kernel_info(which)` for
    OCC_INSTANCES[which], `p1_kernel_info(which, K)` for P1_INSTANCES[which]
    at K's dynamic shared memory, `k5_kernel_info(n)` for K5 with n taps,
    `p23_kernel_info(which)` for P23_INSTANCES[which], `f1_kernel_info(which)`
    for F1_INSTANCES[which], `shadow_front_kernel_info(which)` for
    SHADOW_FRONT_INSTANCES[which], `view_front_kernel_info(which)` for
    VIEW_FRONT_INSTANCES[which], `d1_kernel_info(which)` for
    D1_INSTANCES[which], `c1_kernel_info(which)` for C1_INSTANCES[which]."""
    lib = library()
    info = (ctypes.c_int * 5)()
    rc = getattr(lib, fn)(*ints, ctypes.cast(info, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc}: {lib.rend3_cuda_error_string(rc).decode()}")
    return dict(zip(("registers", "local_bytes", "smem", "ctas_per_sm", "sms"), info))
