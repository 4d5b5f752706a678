"""The port's float32 fma forms (rend3_tpu_torch/ops/fp.py) on the CPU.

fma32 / ab_minus_cd / dot3 run F1 (csrc/fma.cu) on CUDA tensors and their
plain versions, a float64 emulation of the correctly rounded fma, on CPU
tensors. Here the plain versions are held bit for bit (NaN positions
equal) against an exact reference: each fma's value in fractions.Fraction
arithmetic, rounded to the nearest float32 with ties to even by testing
the neighbours, on testing.fma_stress_case (random bit patterns over all
exponents, cancellation, constructed halfway cases, double-rounding traps,
subnormal results, overflow to +-inf, signed zeros, NaN positions). Then
against the contraction the frame's parity rests on: jax.jit of a*b + c,
a*b - c*d and a1*b1 + a0*b0 + a2*b2 on the CPU. XLA:CPU contracts each
into the same fmas (it fuses an add's left product: a0*b0 + a1*b1 + a2*b2
would be fma(a2, b2, fma(a0, b0, a1*b1))), but it runs with subnormals
flushed to zero, inputs and results alike, so that comparison holds on the
rows where no input, intermediate or result is subnormal (bit for bit, NaN
positions equal), and the exact reference stays the one for all rows.
Also the dispatch: CPU tensors take the plain version, and anything but
float32 tensors on one device is refused.
"""

from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

from rend3_tpu_torch import testing
from rend3_tpu_torch.ops import deferred, fp

F32 = np.float32
# FLT_MAX + half its ulp (2^103): at or above it a float32 sum rounds to inf.
OVERFLOW = Fraction((2**24 - 1) * 2**104 + 2**103)


def _round_f32(x: Fraction) -> F32:
    """x rounded to the nearest float32, ties to even: float(x) is the
    correctly rounded double, its float32 rounding lies within an ulp of the
    answer, so the nearest of it and its two neighbours is the answer."""
    if x == 0:
        return F32(0.0)
    neg, ax = x < 0, abs(x)
    if ax >= OVERFLOW:
        out = F32(np.inf)
    else:
        f = F32(float(ax)) if float(ax) < 2.0**128 else F32(np.inf)
        with np.errstate(over="ignore"):
            cands = {f, np.nextafter(f, F32(0.0)), np.nextafter(f, F32(np.inf))}

        def value(c):
            return Fraction(2**128) if np.isinf(c) else Fraction(float(c))

        def key(c):  # distance, then odd mantissa last (inf counts as even)
            odd = 0 if np.isinf(c) else int(np.array(c, F32).view(np.int32)) & 1
            return abs(value(c) - ax), odd

        out = min(cands, key=key)
    return -out if neg else out


def ref_fma(a: F32, b: F32, c: F32) -> F32:
    """IEEE 754 fma(a, b, c) in float32, round to nearest even."""
    if np.isnan(a) or np.isnan(b) or np.isnan(c):
        return F32(np.nan)
    sign_p = bool(np.signbit(a)) != bool(np.signbit(b))
    if np.isinf(a) or np.isinf(b):
        if a == 0 or b == 0 or (np.isinf(c) and bool(np.signbit(c)) != sign_p):
            return F32(np.nan)
        return F32(-np.inf if sign_p else np.inf)
    if np.isinf(c):
        return c
    p = Fraction(float(a)) * Fraction(float(b))
    s = p + Fraction(float(c))
    if s == 0:
        # An exact zero sum is +0, but -0 when both terms are -0.
        both_neg = p == 0 and c == 0 and sign_p and bool(np.signbit(c))
        return F32(-0.0) if both_neg else F32(0.0)
    return _round_f32(s)


def ref_form(form, xs):
    """The form's exact value at each row of the numpy inputs xs (its f32
    products c*d and a0*b0 rounded by numpy, IEEE's float32 multiply)."""
    out = np.empty(xs[0].shape, F32)
    with np.errstate(all="ignore"):  # products of infinities and NaNs
        for i in range(out.size):
            r = [x[i] for x in xs]
            if form == "fma":
                out[i] = ref_fma(*r)
            elif form == "fma_ab_minus_cd":
                out[i] = ref_fma(r[0], r[1], -(r[2] * r[3]))
            else:
                out[i] = ref_fma(r[4], r[5], ref_fma(r[2], r[3], r[0] * r[1]))
    return out


PLAIN = {"fma": fp.fma32_plain, "fma_ab_minus_cd": fp.ab_minus_cd_plain, "fma_dot3": fp.dot3_plain}
PUBLIC = {"fma": fp.fma32, "fma_ab_minus_cd": fp.ab_minus_cd, "fma_dot3": fp.dot3}
JAX_FORM = {
    "fma": lambda a, b, c: a * b + c,
    "fma_ab_minus_cd": lambda a, b, c, d: a * b - c * d,
    "fma_dot3": lambda a0, b0, a1, b1, a2, b2: a1 * b1 + a0 * b0 + a2 * b2,
}
N = 2048
FORMS = ("fma", "fma_ab_minus_cd", "fma_dot3")


def _assert_same_bits(got, want, label):
    got, want = np.asarray(got, F32), np.asarray(want, F32)
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    assert np.array_equal(nan_g, nan_w), f"{label}: NaN at {np.flatnonzero(nan_g != nan_w)[:8]}"
    bad = (got.view(np.int32) != want.view(np.int32)) & ~nan_w
    assert not bad.any(), (f"{label}: {int(bad.sum())} rows differ, e.g. row {np.flatnonzero(bad)[0]}: "
                           f"{got[bad][0]!r} vs {want[bad][0]!r}")


@pytest.fixture(scope="module", params=FORMS)
def case(request):
    form = request.param
    xs = testing.fma_stress_case(form, N, seed=5)
    return form, xs, ref_form(form, xs)


def test_stress_case_covers_its_kinds(case):
    """The reference's results hold what the stress set promises: halfway
    cases that round to even, subnormal and zero results of both signs,
    infinities and NaNs."""
    form, xs, want = case
    assert all(x.dtype == F32 and x.shape == (N,) for x in xs)
    finite = np.isfinite(want)
    tiny = finite & (want != 0) & (np.abs(want) < np.finfo(F32).tiny)
    assert tiny.sum() >= 20, tiny.sum()
    assert (np.isposinf(want).sum() >= 5) and (np.isneginf(want).sum() >= 5)
    assert np.isnan(want).sum() >= 20
    zeros = want[finite & (want == 0)]
    assert np.signbit(zeros).sum() >= 5 and (~np.signbit(zeros)).sum() >= 5
    # The constructed halfway cases are ties, and double rounding through
    # float64 misses somewhere (the traps work).
    if form == "fma":
        assert sum(_is_tie(*(x[i] for x in xs)) for i in range(N)) >= N // 16
        with np.errstate(all="ignore"):
            naive = (xs[0].astype(np.float64) * xs[1] + xs[2]).astype(F32)
        assert ((naive.view(np.int32) != want.view(np.int32)) & finite).sum() >= 50


def _is_tie(a, b, c) -> bool:
    """Whether a*b + c (finite) lies exactly halfway between two floats."""
    if not all(np.isfinite(v) for v in (a, b, c)):
        return False
    s = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = ref_fma(a, b, c)
    if not np.isfinite(f) or Fraction(float(f)) == s:
        return False
    with np.errstate(over="ignore"):
        g = np.nextafter(f, F32(np.inf) if s > Fraction(float(f)) else F32(-np.inf))
    return np.isfinite(g) and abs(Fraction(float(g)) - s) == abs(Fraction(float(f)) - s)


def test_plain_matches_exact_reference(case):
    """fma32_plain / ab_minus_cd_plain / dot3_plain and the public forms on
    CPU tensors, bit for bit against the Fraction reference."""
    form, xs, want = case
    ts = [torch.from_numpy(x) for x in xs]
    _assert_same_bits(PLAIN[form](*ts).numpy(), want, f"{form} plain")
    _assert_same_bits(PUBLIC[form](*ts).numpy(), want, f"{form} on CPU tensors")


def _subnormal(x):
    x = np.asarray(x, F32)
    return np.isfinite(x) & (x != 0) & (np.abs(x) < np.finfo(F32).tiny)


def _no_subnormals(form, xs, want):
    """Rows where no input, no intermediate (the f32 product c*d or a0*b0,
    dot3's inner fma) and not the result is subnormal."""
    mid = []
    with np.errstate(all="ignore"):
        if form == "fma_ab_minus_cd":
            mid = [xs[2] * xs[3]]
        elif form == "fma_dot3":
            p0 = xs[0] * xs[1]
            mid = [p0, np.array([ref_fma(a, b, c) for a, b, c in zip(xs[2], xs[3], p0)], F32)]
    return ~np.any([_subnormal(x) for x in (*xs, *mid, want)], axis=0)


def test_plain_matches_xla_cpu_contraction(case):
    """jax.jit of the form's sum on the CPU is the same fma chain (XLA:CPU
    contracts it), so its bits equal the plain version's wherever XLA:CPU's
    flush of subnormals to zero plays no part."""
    form, xs, want = case
    ok = _no_subnormals(form, xs, want)
    assert ok.sum() >= 0.75 * N, ok.sum()
    with np.errstate(all="ignore"):
        got = np.asarray(jax.jit(JAX_FORM[form])(*xs))
    _assert_same_bits(got[ok], want[ok], f"{form} under jax.jit on the CPU")
    # The flush is real: XLA:CPU misses the exact value on subnormal rows.
    assert (got[~ok].view(np.int32) != want[~ok].view(np.int32)).any()


def test_dispatch_takes_plain_on_cpu(monkeypatch):
    """CPU tensors go to the plain versions (and no launch is counted), with
    broadcasting; deferred re-exports fp.fma32."""
    called = []
    for name in ("fma32_plain", "ab_minus_cd_plain", "dot3_plain"):
        orig = getattr(fp, name)
        monkeypatch.setattr(fp, name, lambda *a, _n=name, _o=orig: called.append(_n) or _o(*a))
    before = dict(fp.launches)
    x = torch.tensor([[1.5], [2.0]])
    y = torch.tensor([3.0, -4.0, 0.5])
    assert fp.fma32(x, y, torch.tensor(1.0)).shape == (2, 3)
    assert fp.ab_minus_cd(x, y, y, x).shape == (2, 3)
    assert fp.dot3(x, y, x, y, x, y).shape == (2, 3)
    # (the plain forms' own fmas are fma32_plain's)
    assert called == ["fma32_plain", "ab_minus_cd_plain", "fma32_plain", "dot3_plain", "fma32_plain", "fma32_plain"]
    assert fp.launches == before
    assert deferred.fma32 is fp.fma32
    want = torch.tensor([[5.5, -5.0, 1.75], [7.0, -7.0, 2.0]])
    assert torch.equal(fp.fma32(x, y, torch.tensor(1.0)), want)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("bad", ["float64", "bfloat16", "int32", "python float"])
def test_dispatch_refuses_non_float32(form, bad):
    xs = [torch.ones(4) for _ in range(testing.FMA_ARITY[form])]
    xs[1] = 1.0 if bad == "python float" else torch.ones(4, dtype=getattr(torch, bad))
    with pytest.raises(TypeError, match="float32"):
        PUBLIC[form](*xs)


def test_dispatch_refuses_mixed_devices():
    meta = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="mixed devices"):
        fp.fma32(torch.ones(4), meta, torch.ones(4))


def test_collapse_merges_and_drops_dims():
    """The wrapper's layout: size-1 dimensions dropped, dimensions every
    input steps through as one merged, broadcast strides 0 kept."""
    a, b, c = torch.broadcast_tensors(torch.ones(5, 1, 1), torch.ones(1, 4, 3), torch.ones(5, 4, 3))
    sizes, strides = fp._collapse(a.shape, [a.stride(), b.stride(), c.stride()])
    assert sizes == [5, 12] and strides == [[1, 0], [0, 1], [12, 1]]
    sizes, strides = fp._collapse((), [(), ()])
    assert sizes == [] and strides == [[], []]
    x = torch.ones(2, 3, 4).permute(2, 0, 1)
    assert fp._collapse(x.shape, [x.stride()]) == ([4, 6], [[1, 4]])


def test_launch_refuses_too_many_dims():
    """Seven dimensions that no merge removes are refused before any
    launch (F1 takes six)."""
    x = torch.ones([2] * 7).permute(6, 5, 4, 3, 2, 1, 0)
    with pytest.raises(ValueError, match="at most 6"):
        fp._launch("fma", (x, x, x))


def test_capture_records_largest_call_per_site():
    """fp.capture keeps, per (form, call site), the largest call's inputs."""
    fp.capture = {}
    try:
        for n in (3, 7, 5):
            fp.fma32(torch.ones(n), torch.ones(n), torch.ones(n))
        fp.dot3(*[torch.ones(2)] * 6)
        got = dict(fp.capture)
    finally:
        fp.capture = None
    (fma_key,) = [k for k in got if k[0] == "fma"]
    assert "test_torch_fp.py:" in fma_key[1] and fma_key[1].endswith("test_capture_records_largest_call_per_site")
    assert got[fma_key][0].shape == (7,)
    assert [k[0] for k in got].count("fma_dot3") == 1

