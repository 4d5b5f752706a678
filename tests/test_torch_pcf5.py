"""K3 (fused PCF5) plain version and resolve_shadow_pcf5 of the PyTorch
port against the JAX package, on two row-stacked maps of different sizes.

The JAX sampler runs in Pallas interpret mode on the CPU. Inputs come from a
numpy seed: sample positions reaching past every map edge (taps there read
the zero padding), positions snapped to texel centres, reference depths
equal to the texels they compare against (GreaterEqual must hold), and
invalid pixels. Tolerance: abs <= 1e-6 (XLA may contract the bilinear
blend into fmas and skips fully lit cells; the values differ only by
rounding)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rend3_tpu.ops import mxu_gather as JMG
from rend3_tpu.ops import shadow as JS
from rend3_tpu_torch.ops import samplers as PS
from rend3_tpu_torch.ops import shadow as PSh

SIZES = (64, 32)
H, W = 32, 128  # per entry (one screen tile of the JAX sampler)
TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _maps(rng):
    maps = []
    for s in SIZES:
        m = rng.uniform(0.0, 1.0, (s, s)).astype(np.float32)
        m[rng.random((s, s)) < 0.3] = 0.0          # texels no caster covers
        maps.append(m)
    return maps


def _entry(rng, m):
    size = m.shape[0]
    sx = rng.uniform(-3.0, size + 3.0, (H, W)).astype(np.float32)
    sy = rng.uniform(-3.0, size + 3.0, (H, W)).astype(np.float32)
    snap = rng.random((H, W)) < 0.2                  # texel centres: fx = fy = 0
    sx[snap] = np.floor(sx[snap]) + 0.5
    sy[snap] = np.floor(sy[snap]) + 0.5
    ref = rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)
    bx = np.floor(sx - 0.5).astype(np.int64)
    by = np.floor(sy - 0.5).astype(np.int64)
    inside = (bx >= 0) & (bx < size) & (by >= 0) & (by < size)
    eq = inside & (rng.random((H, W)) < 0.3)         # ref equal to the base texel
    ref[eq] = m[by[eq], bx[eq]]
    hit = rng.random((H, W)) < 0.85
    return sx, sy, ref, hit


@pytest.fixture(scope="module", params=[0, 1])
def case(request):
    rng = np.random.default_rng(request.param)
    maps = _maps(rng)
    entries = [(0, *_entry(rng, maps[0])), (1, *_entry(rng, maps[1])), (0, *_entry(rng, maps[0]))]
    jout, ovf, _q = JS.resolve_shadow_pcf5(
        [jnp.asarray(m) for m in maps],
        [(k, jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), jnp.asarray(d)) for k, a, b, c, d in entries],
        pair_cap=64, interpret=True,
    )
    assert int(ovf) <= 64
    pout = PSh.resolve_shadow_pcf5(
        [torch.from_numpy(m) for m in maps],
        [(k, *(torch.from_numpy(x) for x in (a, b, c, d))) for k, a, b, c, d in entries],
    )
    return maps, entries, [np.asarray(o) for o in jout], [o.numpy() for o in pout]


def test_stacked_maps_match(case):
    maps = case[0]
    js, jb = JS.stack_shadow_maps([jnp.asarray(m) for m in maps])
    ps, pb = PSh.stack_shadow_maps([torch.from_numpy(m) for m in maps])
    np.testing.assert_array_equal(np.asarray(js), ps.numpy())
    assert list(jb) == pb


def test_resolve_shadow_pcf5_matches(case):
    _maps_, _entries, jout, pout = case
    for j, p in zip(jout, pout):
        assert p.shape == j.shape
        np.testing.assert_allclose(p, j, rtol=0, atol=TOL)


def test_fixture_covers_edges_and_equal_refs(case):
    maps, entries, jout, pout = case
    for k, sx, sy, ref, hit in entries:
        size = maps[k].shape[0]
        bx = np.floor(sx - 0.5)
        assert ((bx == size - 1) & hit).any() or ((bx == -1) & hit).any()
    # Lit, shadowed and partly shadowed pixels all occur.
    allv = np.concatenate([p.ravel() for p in pout])
    assert (allv == 1.0).any() and (allv == 0.0).any() and ((allv > 0) & (allv < 1)).any()


def test_plain_k3_matches_jax_kernel(case):
    """The K3 plain version against mxu_gather.sample_grid_pcf5 directly on
    the stacked image, invalid pixels included (both give 0 there)."""
    maps, entries, _j, _p = case
    stacked, bases = PSh.stack_shadow_maps([torch.from_numpy(m) for m in maps])
    cols = {n: [] for n in ("bx", "by", "fx", "fy", "ref", "ok")}
    for k, sx, sy, ref, hit in entries:
        xb, yb = np.floor(sx - 0.5), np.floor(sy - 0.5)
        bx, by = xb.astype(np.int32), yb.astype(np.int32)
        size = maps[k].shape[0]
        cols["bx"].append(bx)
        cols["by"].append(by + bases[k])
        cols["fx"].append((sx - 0.5) - xb)
        cols["fy"].append((sy - 0.5) - yb)
        cols["ref"].append(ref)
        cols["ok"].append(hit & (bx >= 0) & (bx < size) & (by >= 0) & (by < size))
    a = {n: np.concatenate(v) for n, v in cols.items()}
    j, _need, _q = JMG.sample_grid_pcf5(
        jnp.asarray(stacked.numpy()), *(jnp.asarray(a[n]) for n in ("bx", "by", "fx", "fy", "ref", "ok")),
        pair_cap=64, interpret=True,
    )
    p = PS.sample_grid_pcf5(stacked, *(torch.from_numpy(a[n]) for n in ("bx", "by", "fx", "fy", "ref", "ok")))
    np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=0, atol=TOL)
    assert (p.numpy()[~a["ok"]] == 0).all()
