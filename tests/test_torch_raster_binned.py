"""The visibility raster (K6) and raster_scene of the PyTorch port against
the JAX package on the CPU.

tests/test_raster_fast.py's random triangle soups (64 triangles, 128x128,
numpy seeds) at the centre offset and at the four MSAA offsets, culling
BACK, FRONT and NONE:

- the port's K6 plain version (rasterize_binned_plain) against JAX's
  rasterize_binned in Pallas interpret mode, on the same setup table and
  8x128 tile lists (interop): ids equal, depth bit for bit. Both evaluate
  the planes as fma(a, px, b*py) + c (the form XLA:CPU gives the kernel);
- the port's raster_scene (cull, setup, 8x128 CSR binning, K6's plain
  version, crop) against JAX's raster_scene(backend="binned_xla") from the
  same clip-space triangles: ids equal, depth bit for bit (the soups' depth
  planes are flat, so the eager XLA oracle's uncontracted planes give the
  same depths). JAX's "pallas" backend calls the kernel without interpret
  mode and cannot run on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rend3_tpu.ops import geometry as JG
from rend3_tpu.ops import raster as JR
from rend3_tpu.ops import raster_pallas as JRP
from rend3_tpu.routine import base as JB
from rend3_tpu_torch import interop
from rend3_tpu_torch.ops import raster as PR
from rend3_tpu_torch.ops import raster_binned as PRB
from rend3_tpu_torch.routine.base import raster_scene

W = H = 128
N = 64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def random_clip_tris(n, seed, z_range=(0.0, 1.0)):
    """tests/test_raster_fast.py's soup."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1.2, 1.2, (n, 3, 2)).astype(np.float32)
    z = rng.uniform(*z_range, (n, 1, 1)).astype(np.float32) * np.ones((n, 3, 1), np.float32)
    w = np.ones((n, 3, 1), np.float32)
    return np.concatenate([xy, z, w], axis=2)


@pytest.mark.parametrize("samples", [1, 4])
@pytest.mark.parametrize("seed,cull", [(0, JR.CullMode.BACK), (1, JR.CullMode.FRONT), (2, JR.CullMode.NONE)],
                         ids=["back", "front", "none"])
def test_visibility_raster_matches_jax(seed, cull, samples):
    offsets = JR.CENTER_OFFSET if samples == 1 else JR.MSAA4_OFFSETS
    assert offsets == (PR.CENTER_OFFSET if samples == 1 else PR.MSAA4_OFFSETS)
    clip = random_clip_tris(N, seed + 10 * samples)
    valid = np.ones(N, bool)

    # K6 on the JAX side's own tables.
    t = JG.cull_and_setup(jnp.asarray(clip), jnp.asarray(valid), W, H, cull_mode=cull, front_is_cw=True,
                          subpixel=samples == 1)
    b = JG.bin_triangles(t, W, H, tile_cap=N)
    assert int(b.overflow) == 0
    jvis = JRP.rasterize_binned(t, b, W, H, offsets, interpret=True)
    pvis = PRB.rasterize_binned(
        interop.tri_setup(t.setup, t.bbox, t.count, t.src, t.flip), interop.binned(b.ids, b.counts), W, H, offsets
    )
    jv = interop.vis_buffer(jvis.depth, jvis.tri)
    assert pvis.tri.shape == (samples, H, W)
    assert torch.equal(pvis.tri, jv.tri)
    assert torch.equal(pvis.depth, jv.depth)
    assert float((pvis.tri >= 0).float().mean()) > 0.3

    # raster_scene from the clip-space triangles.
    jscene = JB.raster_scene(jnp.asarray(clip), jnp.asarray(valid), W, H, cull_mode=cull, front_is_cw=True,
                             sample_offsets=offsets, backend="binned_xla")
    pscene = raster_scene(torch.from_numpy(clip), torch.from_numpy(valid), W, H, cull_mode=cull,
                          front_is_cw=True, sample_offsets=offsets)
    js = interop.vis_buffer(jscene.depth, jscene.tri)
    assert torch.equal(pscene.tri, js.tri)
    assert torch.equal(pscene.depth, js.depth)
