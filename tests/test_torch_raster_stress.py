"""K1 and K2 plain versions against the JAX kernels on the raster stress input.

rend3_tpu_torch.testing.raster_stress_case (raster_stress_input: numpy,
seed 0, 256x128, through the port's front end) presses
the CUDA kernels' list walk: every 32x128 tile lists more than the 128
entries a staging chunk (and a K2 segment) holds, the left ones more than
256, most entries skipped by a given warp's bbox test; equal-depth
duplicates come later in the list, across quarter-tile, chunk and 32-entry
ballot boundaries; a grid of quads puts edges on pixel centres, where the
top-left rule decides. The same tables (the ones chip_smoke.py and the
card-only tests hold the CUDA kernels to) go through JAX's
raster_resolve_packed in Pallas interpret mode, compiled once with a bound
and a strict count floor and run for every mode: opaque (a bound of 2 is no
bound, as z <= 1), bound, strict count, and count (z >= f is
z > nextafter(f, -inf), so a strict floor one float lower). The port's
plain versions run each mode as the kernels are called. K2's plain version
is held to JAX's K2 (raster_depth_packed, _depth_launch) on the same packed
tables, in interpret mode in the same program, and the
port's tile lists to JAX's binning of the same setup table (the setup
table itself is held to JAX's by test_torch_frontend.py). Tolerances as
test_torch_raster.py: depth, hit, material and counts bit-exact, the other
channels within 1 ulp. K6's plain version is held to JAX's rasterize_binned
in interpret mode on the case's 8x128 tables at 1 and 4 samples (set up as
raster_scene does), whose lists outrun the CUDA walk's 128-entry staging
chunk: ids and depth bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rend3_tpu.ops import deferred as JD
from rend3_tpu.ops import geometry as JG
from rend3_tpu.ops import raster as JRaster
from rend3_tpu.ops import raster_pallas as JRP
from rend3_tpu_torch import interop, testing
from rend3_tpu_torch.ops import deferred as PD
from rend3_tpu_torch.ops import geometry as PG
from rend3_tpu_torch.ops import raster as PR
from rend3_tpu_torch.ops import raster_binned as PRB

W, H = testing.STRESS_W, testing.STRESS_H
MODES = ("opaque", "bound", "count_strict", "count")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_tables(case):
    """The port's setup table and tile lists as JAX's TriSetup and
    BinnedTris ((n_tiles, K) ids, -1 padded)."""
    tris, binned = case["tris"], case["binned"]
    offs = binned.offsets.numpy()
    lens = offs[1:] - offs[:-1]
    ids = np.full((lens.size, int(lens.max())), -1, np.int32)
    for i, (a, n) in enumerate(zip(offs[:-1], lens)):
        ids[i, :n] = binned.ids.numpy()[a:a + n]
    t = JG.TriSetup(
        setup=jnp.asarray(tris.setup.numpy()), bbox=jnp.asarray(tris.bbox.numpy()),
        count=jnp.int32(tris.count), src=jnp.asarray(tris.src.numpy().astype(np.int32)),
        flip=jnp.asarray(tris.flip.numpy()),
    )
    b = JG.BinnedTris(ids=jnp.asarray(ids), counts=jnp.asarray(lens.astype(np.int32)),
                      overflow=jnp.int32(0), need=jnp.int32(lens.max()))
    return t, b, lens


@pytest.fixture(scope="module")
def stress():
    """testing.raster_stress_case's tables (the port's front end, as the
    card runs it) through JAX's K1 and the port's plain K1 in each mode."""
    case = testing.raster_stress_case("cpu")
    t, b, lens = _jax_tables(case)
    planes = jnp.asarray(case["planes"].numpy())
    flat_cap = int((-(-lens // JD.CHUNK) * JD.CHUNK).sum())

    # Packing, K1 and K2 in one program for every mode: its compile takes
    # most of the test's time.
    @jax.jit
    def jax_k1_k2(bound, floor):
        pk = JD.pack_raster(t, planes, b, W, H, flat_cap=flat_cap)
        k1 = JD.raster_resolve_packed(pk, W, H, interpret=True, bound=bound, count_floor=floor, count_strict=True)
        return k1, JD.raster_depth_packed(pk, W, H, interpret=True)

    no_bound = np.full((H, W), 2.0, np.float32)
    bound, floor = case["bound"].numpy(), case["floor"].numpy()
    below = np.nextafter(floor, np.float32(-np.inf)).astype(np.float32)
    jax_out = {}
    for mode, (bd, fl) in {
        "opaque": (no_bound, floor), "bound": (bound, floor), "count_strict": (no_bound, floor),
        "count": (no_bound, below),
    }.items():
        (g, ovf, c), (depth, d_ovf) = jax_k1_k2(jnp.asarray(bd), jnp.asarray(fl))
        assert int(ovf) == 0 and int(d_ovf) == 0
        jax_out[mode] = (np.asarray(g.data), np.asarray(c) if mode.startswith("count") else None)
    jax_out["depth"] = np.asarray(depth)
    args = (case["tris"], case["planes"], case["binned"], W, H)
    port = {
        "opaque": (PD.raster_resolve_plain(*args), None),
        "bound": (PD.raster_resolve_plain(*args, bound=case["bound"]), None),
        "count_strict": PD.raster_resolve_plain(*args, count_floor=case["floor"], count_strict=True),
        "count": PD.raster_resolve_plain(*args, count_floor=case["floor"]),
    }
    return dict(case=case, jax_tables=(t, b), jax=jax_out, port=port, lens=lens)


def test_stress_input_presses_the_walk(stress):
    lens = stress["lens"]
    assert lens.min() > 128 and (lens > 256).sum() >= 2, lens
    s = stress["case"]["tris"].setup.numpy()
    py, px = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    on_edge = sum(
        int((row[PG.S_EA + k] * px + row[PG.S_EB + k] * py + row[PG.S_EC + k] == 0).sum())
        for row in s[:100] for k in range(3)
    )
    assert on_edge > 0
    # Duplicates (material 100 + row) show where they tie an earlier entry.
    mat = stress["port"]["opaque"][0][PD.G_MAT].numpy()
    assert len(np.unique(mat[mat >= 100])) >= 50


@pytest.mark.parametrize("mode", MODES)
def test_k1_stress_matches_jax(stress, mode):
    jg, jc = stress["jax"][mode]
    pg, pc = stress["port"][mode]
    pg = pg.numpy()
    for ch in (PD.G_DEPTH, PD.G_HIT, PD.G_MAT):
        np.testing.assert_array_equal(pg[ch], jg[ch])
    np.testing.assert_array_max_ulp(pg, jg, maxulp=1)
    if jc is not None:
        np.testing.assert_array_equal(pc.numpy(), jc)
        assert pc.max() >= 2


def test_k2_stress_matches_jax(stress):
    c = stress["case"]
    depth = PD.raster_depth_plain(c["tris"], c["binned"], W, H).numpy()
    np.testing.assert_array_equal(depth, stress["jax"]["depth"])
    assert (depth > 0).sum() > 0


def test_port_binning_matches_jax(stress):
    """JAX's binning of the same setup table gives the port's tile lists."""
    t, b = stress["jax_tables"]
    own = JG.bin_triangles(t, W, H, tile_cap=int(t.count), tile_h=JD.DTILE_H, tile_w=JD.DTILE_W)
    np.testing.assert_array_equal(np.asarray(own.counts), np.asarray(b.counts))
    np.testing.assert_array_equal(np.asarray(own.ids)[:, : b.ids.shape[1]], np.asarray(b.ids))


@pytest.mark.parametrize("samples", [1, 4])
def test_k6_stress_matches_jax(stress, samples):
    """K6's plain version against JAX's rasterize_binned (interpret mode)
    on the stress input's 8x128 tables, padded past the longest list."""
    vt, vb = stress["case"]["vis"][samples]
    t, b, lens = _jax_tables({"tris": vt, "binned": vb})
    assert lens.max() > 128
    offsets = PR.CENTER_OFFSET if samples == 1 else PR.MSAA4_OFFSETS
    j = JRP.rasterize_binned(t, b, W, H, offsets, interpret=True)
    p = PRB.rasterize_binned_plain(vt, vb, W, H, offsets)
    np.testing.assert_array_equal(p.tri.numpy(), np.asarray(j.tri))
    np.testing.assert_array_equal(p.depth.numpy(), np.asarray(j.depth))
    assert (p.tri.numpy() >= 0).mean() > 0.2
