"""The bf16 probes P1-P3 of the PyTorch port (rend3_tpu_torch.tools, kernels
in ops/probe_bf16.py, their plain versions here on the CPU) against the JAX
probes under tools/, run as the suite runs Pallas on the CPU: the test
patches `pallas_call` to interpret mode for its own duration (nothing under
tools/ changes) and then imports the probe.

Tolerances. P1 is held bit for bit: XLA:CPU computes the dot as a
sequential fma over its rows, in ascending order, which the kernel and its
plain version do too. P2 and P3 are held with NaN positions equal and
values within rtol = atol = 1e-5: their 128-lane sum follows XLA:CPU's
order where it was found (four sequential 32-lane sums added in order,
ROADMAP §3), and they matched bit for bit there, but that order comes from
XLA's vectorisation of the reduce, which another CPU may change; 128-term
f32 sums of values below 1 round by at most 128 x 2^-24 relative. Where
JAX cannot give values (v7 and P3 without its init branch revisit output
blocks, which interpret mode with zeroed memory refuses), the port's
zero-initialised output is held to a float64 numpy oracle within the same
tolerance.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rend3_tpu_torch import testing
from rend3_tpu_torch.ops import probe_bf16 as pb
from rend3_tpu_torch.tools import probe_bf16_dot as PD
from rend3_tpu_torch.tools import probe_bf16_kernel as PK
from rend3_tpu_torch.tools import probe_bf16_real as PREAL

_PALLAS_CALL = pl.pallas_call
ZERO_MEMORY = pltpu.InterpretParams(uninitialized_memory="zero")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def jax_probe(monkeypatch):
    """load(name, interpret) -> the JAX probe module tools/<name>.py with
    pallas_call running in the given interpret mode."""

    def load(name, interpret=True):
        monkeypatch.setattr(pl, "pallas_call", functools.partial(_PALLAS_CALL, interpret=interpret))
        return importlib.import_module(f"tools.{name}")

    return load


def _bf16(a):
    return np.asarray(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float())


# ---------------------------------------------------------------------------
# P1
# ---------------------------------------------------------------------------

P1_KERNELS = ("k_f32", "k_bf16", "k_bf16_T", "k_bf16_pad128")


@pytest.mark.parametrize("k", range(4), ids=[v[0] for v in PD.VARIANTS])
def test_p1_matches_jax(jax_probe, k):
    J = jax_probe("probe_bf16_dot")
    np.random.seed(k)
    # The body of the JAX probe's run(), which prints but returns nothing.
    a = jnp.asarray(np.random.rand(J.R, J.CW), jnp.float32)
    b = jnp.asarray(np.random.rand(J.R, J.NPB), jnp.float32)
    want = np.asarray(
        pl.pallas_call(getattr(J, P1_KERNELS[k]), out_shape=jax.ShapeDtypeStruct((J.CW, J.NPB), jnp.float32))(a, b)
    )
    got = PD.variant(k, np.random.RandomState(k), "cpu")
    np.testing.assert_array_equal(got.out.numpy(), want)
    assert got.out.shape == (PD.CW, PD.NPB) and got.note.startswith(", max err ")


# ---------------------------------------------------------------------------
# P2
# ---------------------------------------------------------------------------

P2_FUNCS = ("v1", "v2", "v3", "v4", "v5", "v6", ("v7", jnp.bfloat16), ("v7", jnp.float32))


def _jax_p2(J, k):
    np.random.seed(k)
    f = P2_FUNCS[k]
    return np.asarray(getattr(J, f[0])(f[1]) if isinstance(f, tuple) else getattr(J, f)())


@pytest.mark.parametrize("k", range(8), ids=[v[0].split()[0] + v[0].split()[-1] for v in PK.VARIANTS])
def test_p2_matches_jax_interpret(jax_probe, k):
    """NaN where interpret mode leaves output memory unwritten, values
    elsewhere (v1's channel rows)."""
    want = _jax_p2(jax_probe("probe_bf16_kernel"), k)
    got = PK.variant(k, np.random.RandomState(k), "cpu").out.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, equal_nan=True)
    assert np.isnan(want).any()


@pytest.mark.parametrize("k", range(6), ids=[v[0].split()[0] for v in PK.VARIANTS[:6]])
def test_p2_values_match_jax_zero_memory(jax_probe, k):
    want = _jax_p2(jax_probe("probe_bf16_kernel", ZERO_MEMORY), k)
    got = PK.variant(k, np.random.RandomState(k), "cpu", init="zero").out.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(want[:4]).min() > 0 and not want[4:].any() and not got[4:].any()


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_p2_v7_against_float64_oracle(bf16):
    k = 6 if bf16 else 7
    got = PK.variant(k, np.random.RandomState(k), "cpu", init="zero").out.numpy()
    rng = np.random.RandomState(k)
    R, CW, NPX = PK.R, PK.CW, PK.NPX
    t = rng.rand(4, R, CW).astype(np.float32)
    f = rng.rand(8, 3, NPX).astype(np.float32)
    rho = _bf16 if bf16 else (lambda v: np.asarray(v, np.float32))
    want = np.zeros((8, 8, NPX))
    for s in range(16):
        tile, cell = s % 8, s % 4
        fy = f[tile, 1]
        ry = np.round(f[tile, 2] * np.float32(R - 8)).astype(np.int64)
        wlo, whi = rho(np.float32(1) - fy).astype(np.float64), rho(fy).astype(np.float64)
        tc = rho(t[cell]).astype(np.float64)
        rows = tc[ry] * wlo[:, None] + tc[ry + 1] * whi[:, None]          # (NPX, 512)
        want[tile, :4] += rows.reshape(NPX, 4, 128).sum(-1).T
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# P3
# ---------------------------------------------------------------------------


def _jax_p3(J, name):
    flags = dict(PREAL.VARIANTS)[name]
    kw = {"ohx_lerp": True, "int_coords": True, "w_area_in_ohy": True, "init_branch": True}
    kw.update({k: v for k, v in flags.items() if k != "bf16"})
    return np.asarray(J.build(jnp.float32 if flags.get("bf16") is False else jnp.bfloat16, **kw)())


@pytest.mark.parametrize("k", range(len(PREAL.VARIANTS)), ids=[v[0].replace(" ", "-") for v in PREAL.VARIANTS])
def test_p3_matches_jax_interpret(jax_probe, k):
    name, kw = PREAL.VARIANTS[k]
    want = _jax_p3(jax_probe("probe_bf16_real"), name)
    got = PREAL.build(name, "cpu", **kw).out.numpy()
    assert got.shape == want.shape == (4, 8, 4096)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, equal_nan=True)
    if kw.get("init_branch", True):
        assert not np.isnan(want).any() and want[:, :4].any()
    else:
        assert np.isnan(want).all()


def test_p3_no_init_against_float64_oracle():
    got = PREAL.build("bf16 no-init", "cpu", init_branch=False, init="zero").out.numpy()
    rng = np.random.default_rng(0)
    R, nT, npx, npb, lt = 72, 4, 4096, 1024, PREAL.LT
    tiles = rng.random((16, R, 512), np.float32)
    S = 5 * nT + 16 * 8
    st, sp, sf = rng.integers(0, nT, S), rng.integers(0, 16, S), rng.integers(0, 32, S)
    coords = rng.integers(0, 250, (nT, 2, npx))
    fr = rng.random((nT, 3, npx), np.float32)
    want = np.zeros((nT, 8, npx))
    p = np.arange(npx)
    for s in range(S):
        tile, cell = st[s], sp[s]
        cy, cx = divmod(cell, 4)
        bx, by = coords[tile, 0], coords[tile, 1]
        rel_x, rel_y = bx - cx * lt, by - cy * lt
        sel = ((sf[s] >> (p // npb)) & 1).astype(bool)
        own = sel & (rel_y >= 0) & (rel_y < lt) & (rel_x >= 0) & (rel_x < lt) & (bx + 1 < 256) & (by + 1 < 256)
        fx, fy, w = fr[tile, 0], fr[tile, 1], fr[tile, 2]
        wlo = _bf16(w * (np.float32(1) - fy)).astype(np.float64)
        whi = _bf16(w * fy).astype(np.float64)
        tc = _bf16(tiles[cell]).astype(np.float64)
        q = p[own]
        for c in range(4):
            col = 128 * c + rel_x[q]
            left = tc[rel_y[q], col] * wlo[q] + tc[rel_y[q] + 1, col] * whi[q]
            right = tc[rel_y[q], col + 1] * wlo[q] + tc[rel_y[q] + 1, col + 1] * whi[q]
            want[tile, c, q] += (1.0 - fx[q]) * left + fx[q] * right
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (want[:, :4] != 0).mean() > 0.01


# ---------------------------------------------------------------------------
# P3's stress input (testing.probe_lerp_stress_case)
# ---------------------------------------------------------------------------


def _owned(a, st, sc):
    """(steps, npx) bool: pixels of the step's tile whose base texel lies in
    the step's cell, inside the source (the kernel's `own`)."""
    coords = a["coords"].numpy()
    lt, gx, hs, ws = a["lt"], a["gx"], a["hs"], a["ws"]
    bx, by = coords[st, 0], coords[st, 1]
    rel_x, rel_y = bx - (sc % gx)[:, None] * lt, by - (sc // gx)[:, None] * lt
    return ((rel_x >= 0) & (rel_x < lt) & (rel_y >= 0) & (rel_y < lt) & (bx >= 0) & (bx + 1 < ws) & (by >= 0)
            & (by + 1 < hs))


def test_p3_stress_case_has_what_it_should():
    a = testing.probe_lerp_stress_case("cpu")
    st, sc, sf = (a[k].numpy() for k in ("st", "sc", "sf"))
    assert np.bincount(st, minlength=4).tolist() == list(testing.LERP_STRESS_STEPS)
    assert testing.LERP_STRESS_STEPS[0] >= 600 and testing.LERP_STRESS_STEPS[1] == 0
    # Init steps mid-list: two in tile 0, one in tile 3, none elsewhere.
    for tile, n in ((0, 2), (1, 0), (2, 0), (3, 1)):
        at = np.flatnonzero((sf[st == tile] >> 4) & 1) / max(1, testing.LERP_STRESS_STEPS[tile])
        assert at.size == n and ((at > 0.1) & (at < 0.9)).all()
    b = testing.probe_lerp_stress_case("cpu", init_steps=False)
    assert not ((b["sf"].numpy() >> 4) & 1).any() and np.array_equal(b["sf"].numpy(), sf & 15)
    assert all(((sf >> band) & 1).any() for band in range(4))
    # A step owns most pixels of the bands it selects.
    sel = ((sf[:, None] >> (np.arange(4096) // a["npb"])) & 1).astype(bool)
    share = (_owned(a, st, sc) & sel).sum() / sel.sum()
    assert 0.6 < share < 0.95
    assert a["mode"] == pb.LERP_YCELL | pb.LERP_WAREA | pb.LERP_INIT | pb.LERP_BF16 | pb.LERP_XLERP
    c = testing.probe_lerp_stress_case("cpu", bf16=False, xlerp=False, init="zero")
    assert c["mode"] == pb.LERP_YCELL | pb.LERP_WAREA | pb.LERP_INIT and not c["out"].any()
    assert torch.isnan(a["out"]).all()


def _stress_oracle(a, bf16, xlerp):
    """probe_lerp on a zero-initialised stress case in float64 from the f32
    (or bf16) texels and weights."""
    t, f, st, sc, sf = (a[k].numpy() for k in ("t", "f", "st", "sc", "sf"))
    rho = _bf16 if bf16 else (lambda v: np.asarray(v, np.float32))
    tc = rho(t).astype(np.float64)
    lt, gx, npb = a["lt"], a["gx"], a["npb"]
    coords = a["coords"].numpy()
    own = _owned(a, st, sc)
    want = np.zeros(a["out"].shape)
    p = np.arange(f.shape[2])
    for s in range(st.shape[0]):
        tile, cell = st[s], sc[s]
        if (sf[s] >> 4) & 1:
            want[tile] = 0.0
        q = p[own[s] & ((sf[s] >> (p // npb)) & 1).astype(bool)]
        fx, fy, w = f[tile, 0, q], f[tile, 1, q], f[tile, 2, q]
        wlo = rho(w * (np.float32(1) - fy)).astype(np.float64)
        whi = rho(w * fy).astype(np.float64)
        rx = coords[tile, 0, q] - (cell % gx) * lt
        ry = coords[tile, 1, q] - (cell // gx) * lt
        for c in range(4):
            if xlerp:
                col = 128 * c + rx
                left = tc[cell, ry, col] * wlo + tc[cell, ry + 1, col] * whi
                right = tc[cell, ry, col + 1] * wlo + tc[cell, ry + 1, col + 1] * whi
                v = (1.0 - fx) * left + fx * right
            else:
                lanes = slice(128 * c, 128 * (c + 1))
                v = (tc[cell, ry, lanes] * wlo[:, None] + tc[cell, ry + 1, lanes] * whi[:, None]).sum(-1)
            want[tile, c, q] += v
    return want


# (bf16, x-lerp, init steps, steps per tile): the plain version cut to a few
# hundred steps (the 128-lane sum, about 500 launches a band and step, to
# a few dozen).
STRESS_CASES = {
    "x-lerp-bf16-init": (True, True, True, (200, 0, 40, 60)),
    "x-lerp-f32-no-init": (False, True, False, (200, 0, 40, 60)),
    "lane-sum-bf16-init": (True, False, True, (12, 0, 6, 8)),
}


@pytest.mark.parametrize("case", list(STRESS_CASES))
def test_p3_stress_plain_against_float64_oracle(case):
    bf16, xlerp, init_steps, counts = STRESS_CASES[case]
    a = testing.probe_lerp_stress_case("cpu", bf16=bf16, xlerp=xlerp, init_steps=init_steps, init="zero",
                                       counts=counts)
    got = pb.probe_lerp(**a).numpy()
    want = _stress_oracle(a, bf16, xlerp)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (want[[0, 2, 3], :4] != 0).mean() > 0.5 and not want[1].any()
