"""Float32 arithmetic in the forms the JAX reference computes on the CPU.

XLA:CPU compiles a jitted JAX program with LLVM, which contracts a product
followed by an add into one fused multiply-add wherever both sit in one
fusion. The parity tests hold the port to those programs bit for bit, so
where the JAX code's sums are contracted the port computes the same fmas:
`fma32`, and the two shapes XLA:CPU gives the JAX front end's sums,
`ab_minus_cd` and `dot3`. On CUDA tensors each is one launch of the
hand-written kernel F1 (csrc/fma.cu, `__fmaf_rn`); on CPU tensors, where
PyTorch has no fused float32 fma, each runs its plain version, which
emulates the correctly rounded fma in float64 (`fma32_plain`). Both round
correctly, so the card and the CPU give the same bits (a NaN's payload
aside). The inputs must be float32 tensors on one device; they broadcast.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import torch

__all__ = ["fma32", "sqrt32", "ab_minus_cd", "dot3", "fma32_plain", "ab_minus_cd_plain", "dot3_plain",
           "launches", "capture"]

# F1 launches by form; each name is a row of chip_smoke.py's kernels line.
launches = {"fma": 0, "fma_dot3": 0, "fma_ab_minus_cd": 0}
# When a dict: (form, call site) -> the inputs of the largest call of that
# form from that site ("path/in/package.py:line function"), on any device.
capture: Optional[dict] = None
# F1's form codes (csrc/fma.cu `Form`), its dimensions and inputs at most.
_FORMS = {"fma": 0, "fma_dot3": 1, "fma_ab_minus_cd": 2}
MAX_DIMS = 6
_MAX_IN = 6
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _device(form: str, xs) -> torch.device:
    """The one device of the inputs; raises unless all are float32 tensors
    on one device."""
    for x in xs:
        if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
            got = x.dtype if isinstance(x, torch.Tensor) else type(x).__name__
            raise TypeError(f"{form}: every input must be a float32 tensor, got {got}")
    dev = xs[0].device
    if any(x.device != dev for x in xs):
        raise ValueError(f"{form}: inputs on mixed devices {sorted({str(x.device) for x in xs})}")
    if capture is not None:
        caller = sys._getframe(2)
        site = (f"{os.path.relpath(caller.f_code.co_filename, _PKG)}:{caller.f_lineno} "
                f"{caller.f_code.co_name}")
        numel = torch.broadcast_shapes(*(x.shape for x in xs)).numel()
        old = capture.get((form, site))
        if old is None or numel > torch.broadcast_shapes(*(x.shape for x in old)).numel():
            capture[(form, site)] = tuple(xs)
    return dev


def _collapse(shape, strides):
    """(sizes, per-input strides) of a broadcast shape with its size-1
    dimensions dropped and each dimension merged into the one before it
    wherever every input steps through both as through one."""
    sizes, out = [], [[] for _ in strides]
    for d, size in enumerate(shape):
        if size == 1:
            continue
        if sizes and all(st[-1] == s[d] * size for st, s in zip(out, strides)):
            sizes[-1] *= size
            for st, s in zip(out, strides):
                st[-1] = s[d]
        else:
            sizes.append(size)
            for st, s in zip(out, strides):
                st.append(s[d])
    return sizes, out


def _launch(form: str, xs) -> torch.Tensor:
    """F1 in `form` over the broadcast inputs: one new contiguous float32
    tensor, one launch (none for an empty output)."""
    from . import cuda_kernels

    xs = torch.broadcast_tensors(*xs)
    out = torch.empty(xs[0].shape, dtype=torch.float32, device=xs[0].device)
    if out.numel() == 0:
        return out
    sizes, strides = _collapse(out.shape, [x.stride() for x in xs])
    if len(sizes) > MAX_DIMS:
        raise ValueError(f"{form}: {len(sizes)} dimensions after merging, F1 takes at most {MAX_DIMS}")
    if max(sizes + [s for st in strides for s in st], default=0) >= 2**31:
        raise ValueError(f"{form}: a size or stride of {tuple(out.shape)} passes 2^31 elements")
    pad = [0] * (MAX_DIMS - len(sizes))
    ints = [_FORMS[form], len(sizes), *sizes, *pad]
    for k in range(_MAX_IN):
        ints += (strides[k] + pad) if k < len(xs) else [0] * MAX_DIMS
    cuda_kernels.call("f1_fma", *xs, *([None] * (_MAX_IN - len(xs))), out, ints=ints)
    launches[form] += 1
    return out


def fma32_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Plain version of fma32: the correctly rounded float32 fma(a, b, c),
    emulated in float64.

    a*b is exact in float64 and the float64 sum's rounding error is
    recovered exactly (TwoSum). The sum is then rounded to odd: of the two
    doubles around the exact value, the one whose last bit is odd (the sum
    itself when exact). Rounding that to float32 is the correctly rounded
    result, since a double carries more than 24 + 2 bits."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    i = s.view(torch.int64)
    # One step of the bit pattern moves |s| up (+1) or down (-1).
    step = torch.where(err * s > 0, 1, -1)
    odd = torch.where((err != 0) & ((i & 1) == 0) & torch.isfinite(s), i + step, i)
    return odd.view(torch.float64).float()


def ab_minus_cd_plain(a, b, c, d):
    """Plain version of ab_minus_cd."""
    return fma32_plain(a, b, -(c * d))


def dot3_plain(a0, b0, a1, b1, a2, b2):
    """Plain version of dot3."""
    return fma32_plain(a2, b2, fma32_plain(a1, b1, a0 * b0))


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 fma(a, b, c): F1 on CUDA tensors, the
    plain version on CPU tensors."""
    if _device("fma", (a, b, c)).type == "cpu":
        return fma32_plain(a, b, c)
    return _launch("fma", (a, b, c))


def ab_minus_cd(a, b, c, d):
    """a*b - c*d as XLA:CPU contracts it: fma(a, b, -(c*d)); F1 on CUDA
    tensors, the plain version on CPU tensors."""
    if _device("fma_ab_minus_cd", (a, b, c, d)).type == "cpu":
        return ab_minus_cd_plain(a, b, c, d)
    return _launch("fma_ab_minus_cd", (a, b, c, d))


def dot3(a0, b0, a1, b1, a2, b2):
    """a0*b0 + a1*b1 + a2*b2, summed left to right as XLA:CPU contracts
    it: fma(a2, b2, fma(a1, b1, a0*b0)); F1 on CUDA tensors, the plain
    version on CPU tensors."""
    if _device("fma_dot3", (a0, b0, a1, b1, a2, b2)).type == "cpu":
        return dot3_plain(a0, b0, a1, b1, a2, b2)
    return _launch("fma_dot3", (a0, b0, a1, b1, a2, b2))


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt, as XLA and CUDA compute it.

    The CPU float32 torch.sqrt of some PyTorch builds is off by an ulp on a
    sizeable share of inputs; there the sqrt is taken in float64 and
    rounded, which is exact (53 >= 2*24 + 2 bits, so no double rounding)."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)
