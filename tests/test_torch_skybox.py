"""The skybox of the PyTorch port on the CPU against the JAX package.

- `build_cube_array`: faces, sizes and K4's padded face store (the JAX
  grid planes rounded to the bf16 texels K4 reads), and the same arrays
  carried over from JAX's faces and sizes (interop.cube_arrays);
- `_cube_face_coords` against JAX's under jit (the frame's compilation):
  faces exactly, texel coordinates within 2e-6 (an ulp at 16; they matched
  bit for bit where the fma form was found, but which products XLA:CPU
  contracts may change with the CPU);
- `sample_cube_grid` through K4's plain version against the scalar
  `sample_cube`, as tests/test_units.py:459 holds JAX's (bf16 texels:
  6e-3), and the port's `sample_cube` against JAX's (1e-6: the texel
  coordinate is one fma in the port, as in the jitted frame, and two
  roundings in an eager JAX call);
- the frame's view directions against the JAX frame's expressions under
  jit: within 5e-7 (the (N, 4) x (4, 4) product bit for bit, the
  normalisation to an ulp or two, ROADMAP §3);
- a 64x64 frame with a 16x16 skybox behind an unlit cube, at 1 and 4
  samples: the u8 images within 1 level of JAX's at 99.9% of the pixels or
  more (a direction an ulp off can pick another face or texel at an edge;
  they matched bit for bit when written), and sky pixels present.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import rend3_tpu.testing as jax_testing
from rend3_tpu import types as jax_types
from rend3_tpu.ops import texture as JT
from rend3_tpu.routine.base import FrameRenderTarget as JaxTarget
from rend3_tpu.utils import math as jax_m3
from rend3_tpu_torch import interop, scenes, types
from rend3_tpu_torch.ops import samplers as S
from rend3_tpu_torch.ops import texture as PT
from rend3_tpu_torch.routine.base import FrameRenderTarget, sky_directions
from rend3_tpu_torch.testing import TestRunner
from rend3_tpu_torch.utils import math as m3

SIZE = 64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


class _Tex:
    def __init__(self, mip):
        self.mips = [mip]


def _cubes():
    rng = np.random.default_rng(3)
    return {0: _Tex(rng.random((6, 16, 16, 4)).astype(np.float32)), 2: _Tex(rng.random((6, 8, 8, 4)).astype(np.float32))}


def _dirs(n=2048):
    rng = np.random.default_rng(4)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:6] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]]
    d[6:10] = [[1, 1, 0], [1, 0, 1], [1, 1, 1], [-1, -1, 1]]  # edges and a corner
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def test_build_cube_array_matches_jax():
    want = JT.build_cube_array(_cubes())
    got = PT.build_cube_array(_cubes())
    np.testing.assert_array_equal(got.faces.numpy(), np.asarray(want.faces))
    np.testing.assert_array_equal(got.sizes.numpy(), np.asarray(want.sizes))
    planes = np.moveaxis(np.asarray(want.grid_planes), 0, -1)
    assert got.store.dtype == torch.bfloat16 and got.store.shape == planes.shape == (4 * 6 * 18, 18, 4)
    np.testing.assert_array_equal(got.store.float().numpy(), torch.tensor(planes).bfloat16().float().numpy())
    assert PT.build_cube_array({}) is None
    carried = interop.cube_arrays(want.faces, want.sizes)
    for a, b in zip(carried, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("slot", [1, 3])
def test_cube_face_coords_match_jax(slot):
    cube_j = JT.build_cube_array(_cubes())
    cube_p = PT.build_cube_array(_cubes())
    d = _dirs()
    face_j, xf_j, yf_j = jax.jit(JT._cube_face_coords, static_argnums=1)(cube_j, slot, jnp.asarray(d))
    face_p, xf_p, yf_p = PT._cube_face_coords(cube_p, slot, torch.from_numpy(d))
    np.testing.assert_array_equal(face_p.numpy(), np.asarray(face_j))
    np.testing.assert_allclose(xf_p.numpy(), np.asarray(xf_j), rtol=0, atol=2e-6)
    np.testing.assert_allclose(yf_p.numpy(), np.asarray(yf_j), rtol=0, atol=2e-6)
    assert set(face_p.tolist()) == set(range(6))


def test_sample_cube_grid_matches_scalar_sampler():
    cube = PT.build_cube_array(_cubes())
    d = torch.from_numpy(_dirs())
    want = PT.sample_cube(cube, 1, d)
    valid = torch.rand(d.shape[0], generator=torch.Generator().manual_seed(0)) < 0.8
    cap = {}
    got_all, got_masked = PT.sample_cube_grid(cube, 1, [d, d], [None, valid], capture=cap)
    np.testing.assert_allclose(got_all.numpy(), want.numpy(), rtol=6e-3, atol=6e-3)
    np.testing.assert_array_equal(got_masked[valid].numpy(), got_all[valid].numpy())
    assert not got_masked[~valid].any()
    # One K4 query set over both entries, through K4's entry point.
    assert cap["bilinear"][1].numel() == 2 * d.shape[0]
    np.testing.assert_array_equal(S.sample_grid_bilinear(*cap["bilinear"]).T[: d.shape[0]].numpy(), got_all.numpy())
    want_j = np.asarray(JT.sample_cube(JT.build_cube_array(_cubes()), 1, jnp.asarray(_dirs())))
    np.testing.assert_allclose(want.numpy(), want_j, rtol=0, atol=1e-6)


def _jax_sky_directions(inv, width, height, hp, wp, ox, oy):
    """The JAX frame's direction expressions (rend3_tpu/routine/base.py:1577-1591)."""
    cols = jnp.arange(wp, dtype=jnp.float32) + ox
    rows_f = jnp.arange(hp, dtype=jnp.int32).astype(jnp.float32) + oy
    py, px = jnp.meshgrid(rows_f, cols, indexing="ij")
    ndc_x = px / width * 2.0 - 1.0
    ndc_y = 1.0 - py / height * 2.0
    clip4 = jnp.stack([ndc_x, ndc_y, jnp.ones_like(ndc_x), jnp.ones_like(ndc_x)], axis=-1).reshape(-1, 4)
    world = clip4 @ inv.T
    wdir = world[:, :3] / jnp.where(world[:, 3:4] == 0.0, 1.0, world[:, 3:4])
    nlen = jnp.sqrt((wdir * wdir).sum(-1, keepdims=True))
    return wdir / jnp.where(nlen == 0.0, 1.0, nlen)


@pytest.mark.parametrize("sofs", [(0.5, 0.5), (0.875, 0.375)])
def test_sky_directions_match_jax_frame(sofs):
    view = m3.look_at_lh([1.0, 0.7, -1.5], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    proj = m3.perspective_infinite_reverse_lh(np.deg2rad(100.0), 1.0, 0.1)
    rot = np.eye(4, dtype=np.float32)
    rot[:3, :3] = view[:3, :3]
    inv = np.linalg.inv(proj @ rot).astype(np.float32)
    want = np.asarray(jax.jit(_jax_sky_directions, static_argnums=(1, 2, 3, 4, 5, 6))(jnp.asarray(inv), SIZE, SIZE,
                                                                                          SIZE, 128, *sofs))
    got = sky_directions(torch.from_numpy(inv), SIZE, SIZE, SIZE, 128, sofs).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)


def sky_scene(runner, T, mm3):
    keep = scenes.skybox_cube(runner, types=T, m3=mm3)
    runner.renderer.swap_instruction_buffers()
    return keep, keep[-1].idx, runner.renderer.evaluate_instructions()


@pytest.mark.parametrize("samples", [1, 4])
def test_skybox_frame_matches_jax(samples):
    pr = TestRunner(device="cpu")
    keep, sky, ev = sky_scene(pr, types, m3)
    pr.base_graph.captured = {}
    got = pr.base_graph.render_frame(ev, FrameRenderTarget(SIZE, SIZE, samples), skybox_slot=sky)
    jr = jax_testing.TestRunner()
    jkeep, jsky, jev = sky_scene(jr, jax_types, jax_m3)
    want = jr.base_graph.render_frame(jev, JaxTarget(SIZE, SIZE, samples), skybox_slot=jsky)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(-1)
    assert (diff > 1).mean() <= 0.001, f"{(diff > 1).sum()} pixels differ by more than 1 (max {diff.max()})"
    n_sky = int(pr.base_graph.captured["bilinear_sky"][-1].sum())
    assert 0.3 * samples * SIZE * SIZE < n_sky < samples * SIZE * SIZE
    assert (got[..., 3] == 255).all()
    del keep, jkeep


def test_cube_manager_evaluates_once():
    runner = TestRunner(device="cpu")
    keep, _sky, _ev = sky_scene(runner, types, m3)
    cm = runner.renderer.d2c_texture_manager
    a = cm.evaluate()
    assert isinstance(a, PT.CubeArrays) and a.store.dtype == torch.bfloat16
    assert cm.evaluate() is a
    del keep
