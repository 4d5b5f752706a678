"""The overlay (UI) routine of the PyTorch port on the CPU against the JAX
package (rend3_tpu/overlay.py; reference rend3-egui/src/lib.rs:16-175).

- The four cases of tests/test_overlay.py, run against the port.
- The same jobs through both packages' `render`: fractional vertices (the
  edge functions' products are inexact, and XLA:CPU computes them in the
  plain form, so pixels on an edge agree), clip rects, a texture and a
  panel wider than the window raster (WIN): within 1 u8. The port takes
  the triangle's area as the one fma XLA:CPU computes (overlay._areas).
- `bake`'s P and A against JAX's within 1e-4 (on the parity jobs P within
  1e-3 on its 0-255 scale: test_bake_matches_jax says why).
- The device pass against the host compositor within 1 u8, and its band
  form (row0 = 32) equal to the same rows of the full pass.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rend3_tpu import overlay as J
from rend3_tpu_torch import overlay as P
from rend3_tpu_torch.overlay import WIN, OverlayRoutine, PaintJob


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _frame(h=64, w=128, val=40):
    return np.full((h, w, 3), val, np.uint8)


def test_overlay_solid_triangle_and_order():
    o = OverlayRoutine(device="cpu")
    # opaque red triangle then half-transparent blue quad over part of it
    red = PaintJob(
        vertices=np.array([[8, 8], [40, 8], [8, 40]], np.float32),
        colors=np.tile(np.array([255, 0, 0, 255], np.uint8), (3, 1)),
        indices=np.array([[0, 1, 2]], np.uint32),
    )
    blue = PaintJob(
        vertices=np.array([[8, 8], [24, 8], [24, 24], [8, 24]], np.float32),
        colors=np.tile(np.array([0, 0, 255, 128], np.uint8), (4, 1)),
        indices=np.array([[0, 1, 2], [2, 3, 0]], np.uint32),
    )
    out = o.render(_frame(), [red, blue])
    assert out.shape == (64, 128, 3)
    np.testing.assert_array_equal(out[30, 10], [255, 0, 0])
    px = out[12, 12].astype(int)
    a = 128 / 255
    want = np.array([255 * (1 - a), 0, 255 * a])
    assert np.abs(px - want).max() <= 2, (px, want)
    np.testing.assert_array_equal(out[60, 120], [40, 40, 40])


def test_overlay_textured_quad_and_clip():
    o = OverlayRoutine(device="cpu")
    tex = np.zeros((8, 8, 4), np.uint8)
    tex[:, :4] = [0, 255, 0, 255]     # left half green
    tex[:, 4:] = [255, 255, 0, 255]   # right half yellow
    tid = o.add_texture(tex)
    quad = PaintJob(
        vertices=np.array([[16, 16], [48, 16], [48, 48], [16, 48]], np.float32),
        colors=np.tile(np.array([255, 255, 255, 255], np.uint8), (4, 1)),
        uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
        indices=np.array([[0, 1, 2], [2, 3, 0]], np.uint32),
        texture=tid,
        clip_rect=(16, 16, 48, 40),
    )
    out = o.render(_frame(), [quad])
    np.testing.assert_array_equal(out[20, 20], [0, 255, 0])
    np.testing.assert_array_equal(out[20, 44], [255, 255, 0])
    np.testing.assert_array_equal(out[44, 20], [40, 40, 40])


def test_overlay_large_panel_full_image_path():
    o = OverlayRoutine(device="cpu")
    panel = PaintJob(
        vertices=np.array([[0, 0], [128, 0], [128, 64], [0, 64]], np.float32),
        colors=np.tile(np.array([10, 20, 30, 255], np.uint8), (4, 1)),
        indices=np.array([[0, 1, 2], [2, 3, 0]], np.uint32),
    )
    out = o.render(_frame(), [panel])
    np.testing.assert_array_equal(out[32, 64], [10, 20, 30])
    np.testing.assert_array_equal(out[0, 0], [10, 20, 30])


def _device_pass_jobs(mod, o):
    tex = np.zeros((8, 8, 4), np.uint8)
    tex[:, :4] = [0, 255, 0, 200]
    tex[:, 4:] = [255, 255, 0, 90]
    tid = o.add_texture(tex)
    return [
        mod.PaintJob(  # translucent panel
            vertices=np.array([[4, 4], [100, 4], [100, 60], [4, 60]], np.float32),
            colors=np.tile(np.array([30, 30, 40, 180], np.uint8), (4, 1)),
            indices=np.array([[0, 1, 2], [2, 3, 0]], np.uint32),
        ),
        mod.PaintJob(  # textured, semi-transparent, over the panel
            vertices=np.array([[16, 8], [80, 8], [80, 40], [16, 40]], np.float32),
            colors=np.tile(np.array([255, 200, 255, 255], np.uint8), (4, 1)),
            uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
            indices=np.array([[0, 1, 2], [2, 3, 0]], np.uint32),
            texture=tid,
        ),
    ]


def test_device_pass_matches_host_compositor():
    """The baked pass (P + (1 - A) * dst on the frame's u8 tensor) against
    the host compositor within 1 u8; the band form (row0 = 32) equals the
    same rows of the full pass."""
    o = OverlayRoutine(device="cpu")
    jobs = _device_pass_jobs(P, o)
    rng = np.random.default_rng(11)
    frame = rng.integers(0, 255, size=(64, 128, 4), dtype=np.uint8)
    want = o.render(frame[..., :3], jobs)

    dev = o.device_pass(jobs, 128, 64)
    got = dev(torch.from_numpy(frame), None, None, 0)
    assert got.dtype == torch.uint8 and got.shape == (64, 128, 4)
    got = got.numpy()
    np.testing.assert_array_equal(got[..., 3], frame[..., 3])
    diff = got[..., :3].astype(int) - want.astype(int)
    assert np.abs(diff).max() <= 1, np.abs(diff).max()

    got_band = dev(torch.from_numpy(frame[32:].copy()), None, None, 32).numpy()
    np.testing.assert_array_equal(got_band, got[32:])


def _parity_jobs(mod, o, W, H):
    """Jobs of every kind: fractional vertices (windowed and full-image),
    vertex colours with alpha, a clip rect, a texture, a panel wider than
    WIN, a degenerate triangle and a quad whose diagonal crosses pixel
    centres."""
    rng = np.random.default_rng(3)
    tex = rng.integers(0, 256, size=(16, 12, 4), dtype=np.uint8)
    tid = o.add_texture(tex)
    jobs = [
        mod.PaintJob(  # a panel wider than WIN, on fractional coordinates
            vertices=np.array([[1.3, 2.7], [W - 3.1, 2.7], [W - 3.1, H - 5.9], [1.3, H - 5.9]], np.float32),
            colors=np.tile(np.array([20, 30, 45, 200], np.uint8), (4, 1)),
            indices=np.array([[0, 1, 2], [2, 3, 0]], np.uint32),
        ),
        mod.PaintJob(  # a quad whose diagonal runs through pixel centres
            vertices=np.array([[10.5, 10.5], [42.5, 10.5], [42.5, 42.5], [10.5, 42.5]], np.float32),
            colors=np.tile(np.array([200, 60, 60, 150], np.uint8), (4, 1)),
            indices=np.array([[0, 1, 2], [2, 3, 0]], np.uint32),
        ),
        mod.PaintJob(  # degenerate
            vertices=np.array([[5, 5], [20, 20], [35, 35]], np.float32),
            colors=np.full((3, 4), 255, np.uint8),
            indices=np.array([[0, 1, 2]], np.uint32),
        ),
    ]
    for k in range(24):
        span = 90.0 if k % 4 == 0 else 30.0
        c = rng.uniform(0, [W, H])
        v = (c + rng.uniform(-span, span, size=(3, 2))).astype(np.float32)
        textured = k % 2 == 1
        jobs.append(mod.PaintJob(
            vertices=v,
            colors=rng.integers(0, 256, size=(3, 4), dtype=np.uint8),
            indices=np.array([[0, 1, 2]], np.uint32),
            uvs=rng.uniform(-0.1, 1.1, size=(3, 2)).astype(np.float32) if textured else None,
            texture=tid if textured else None,
            clip_rect=(7.5, 4.25, W - 20.0, H - 10.5) if k % 3 == 0 else None,
        ))
    return jobs


W_PAR, H_PAR = 200, 96


@pytest.fixture(scope="module")
def parity():
    """(JAX routine, its jobs, port routine, its jobs) on one job set."""
    jo, po = J.OverlayRoutine(), OverlayRoutine(device="cpu")
    return jo, _parity_jobs(J, jo, W_PAR, H_PAR), po, _parity_jobs(P, po, W_PAR, H_PAR)


def test_render_matches_jax(parity):
    jo, jjobs, po, pjobs = parity
    assert W_PAR > WIN
    frame = np.random.default_rng(5).integers(0, 256, size=(H_PAR, W_PAR, 4), dtype=np.uint8)
    want = jo.render(frame, jjobs)
    got = po.render(frame, pjobs)
    assert got.shape == want.shape == (H_PAR, W_PAR, 4) and got.dtype == np.uint8
    np.testing.assert_array_equal(got[..., 3], frame[..., 3])
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, (diff.max(), int((diff > 1).sum()))
    assert (got[..., :3] != frame[..., :3]).any(-1).mean() > 0.5  # the jobs cover the frame


def test_bake_matches_jax(parity):
    """A within 1e-4. P is premultiplied colour on the 0-255 scale: on the
    two panels of the device-pass test it holds at 1e-4 as it is; on the
    parity jobs it is held within 1e-3 on the same scale. There, large
    triangles interpolate colour from barycentrics of order 1e4 / area,
    which XLA:CPU contracts into fmas in a form that changes from element
    to element (vectorised and scalar loops), so the colour differs by a
    few parts in 1e6 and P by up to 5.7e-4 after 27 overlapping jobs
    (ROADMAP §3)."""
    jo, jjobs, po, pjobs = parity
    jp, ja = jo.bake(jjobs, W_PAR, H_PAR)
    pp, pa = po.bake(pjobs, W_PAR, H_PAR)
    assert pp.shape == (H_PAR, W_PAR, 3) and pa.shape == (H_PAR, W_PAR, 1)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=0, atol=1e-3)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=0, atol=1e-4)
    assert float(pa.max()) <= 1.0 and (pa.numpy() > 0).mean() > 0.5

    jo2, po2 = J.OverlayRoutine(), OverlayRoutine(device="cpu")
    jp2, ja2 = jo2.bake(_device_pass_jobs(J, jo2), 128, 64)
    pp2, pa2 = po2.bake(_device_pass_jobs(P, po2), 128, 64)
    np.testing.assert_allclose(pp2.numpy(), np.asarray(jp2), rtol=0, atol=1e-4)
    np.testing.assert_allclose(pa2.numpy(), np.asarray(ja2), rtol=0, atol=1e-4)


def test_device_pass_matches_jax(parity):
    """Both packages' baked passes on the same frame, and the port's pass
    against its host compositor, within 1 u8."""
    jo, jjobs, po, pjobs = parity
    frame = np.random.default_rng(6).integers(0, 256, size=(H_PAR, W_PAR, 4), dtype=np.uint8)
    want = np.asarray(jo.device_pass(jjobs, W_PAR, H_PAR)(jnp.asarray(frame), None, None, jnp.int32(0)))
    got = po.device_pass(pjobs, W_PAR, H_PAR)(torch.from_numpy(frame), None, None, 0).numpy()
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    host = po.render(frame, pjobs)
    assert np.abs(got.astype(int) - host.astype(int)).max() <= 1

