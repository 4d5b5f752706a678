"""Float32 arithmetic in the forms the JAX reference computes on the CPU.

XLA:CPU compiles a jitted JAX program with LLVM, which contracts a product
followed by an add into one fused multiply-add wherever both sit in one
fusion. The parity tests hold the port to those programs bit for bit, so
where the JAX code's sums are contracted the port computes the same fmas:
`fma32` emulates a correctly rounded float32 fma in float64 (on every
device, so the card and the CPU give the same bits), and the helpers below
spell the two shapes XLA:CPU gives the JAX front end's sums.
"""

from __future__ import annotations

import torch

__all__ = ["fma32", "sqrt32", "ab_minus_cd", "dot3"]


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Exactly rounded float32 fma(a, b, c), emulated in float64.

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


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt, as XLA and CUDA compute it.

    The CPU float32 torch.sqrt of some PyTorch builds is off by an ulp on a
    sizeable share of inputs; there the sqrt is taken in float64 and
    rounded, which is exact (53 >= 2*24 + 2 bits, so no double rounding)."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


def ab_minus_cd(a, b, c, d):
    """a*b - c*d as XLA:CPU contracts it: fma(a, b, -(c*d))."""
    return fma32(a, b, -(c * d))


def dot3(a0, b0, a1, b1, a2, b2):
    """a0*b0 + a1*b1 + a2*b2, summed left to right as XLA:CPU contracts
    it: fma(a2, b2, fma(a1, b1, a0*b0))."""
    return fma32(a2, b2, fma32(a1, b1, a0 * b0))
