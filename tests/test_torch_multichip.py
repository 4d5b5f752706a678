"""Row bands of the PyTorch port (rend3_tpu_torch.parallel.tiles) on the CPU.

The scenes of tests/test_multichip.py (rend3_tpu_torch.scenes: shadow_cube,
band_features, mipmapped_floor) go through the local mesh (n bands on one
device, in lockstep) and through the port's one-device frame on the same
eval_output: every banded image and every carried predicted-visible mask
equals the one-device frame's bit for bit, over two frames (the first
predicts every triangle, the second renders the carried mask). Also the
skybox scene at MSAA 4 with a 4-parameter pass that reads its band's first
row, and two gloo processes of a distributed mesh (file:// rendezvous in
tmp_path, a 60 s process-group timeout, the processes joined with a
timeout of their own).

Against the JAX package (tolerances stated per test):
- the 8-band shadow scene against JAX's tiled program on its 8 virtual CPU
  devices, within 1 u8 (the one JAX tiled program in this file);
- K1's plain version with a band offset (row0 = 32 and 64 of the 256x128
  raster stress soup) against JAX's raster_resolve(y0=) in Pallas
  interpret mode on the same tables: depth, hit and material bit for bit,
  the other channels within 1 ulp, as tests/test_torch_raster.py holds K1;
- cull_and_setup(y_range=) and bin_triangles(y0=) against JAX's, bit for
  bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rend3_tpu_torch import interop, scenes, testing
from rend3_tpu_torch.ops import deferred as PD
from rend3_tpu_torch.ops import geometry as PG
from rend3_tpu_torch.parallel.tiles import build_tiled_frame_callable, device_mesh
from rend3_tpu_torch.routine.base import BaseRenderGraphSettings, FrameRenderTarget
from rend3_tpu_torch.testing import TestRunner


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _row0_pass(img, gbuf, uniforms, row0):
    """An hdr pass that reads its band's first row: every 7th target row
    loses its green."""
    rows = torch.arange(img.shape[0], device=img.device) + row0
    keep = (rows % 7 != 0).to(img.dtype)[:, None, None]
    return torch.cat([img[..., :1], img[..., 1:2] * keep, img[..., 2:]], dim=-1)


def _frames(build, width, height, n, samples=1, frames=2, skybox=False, passes=()):
    """Per mode ("bands": the local mesh of n bands; "single": the
    one-device frame) the images and carried masks of `frames` frames of
    one scene, each mode from no carried mask."""
    runner = TestRunner(device="cpu")
    keep = build(runner)
    graph = runner.base_graph
    for fn, stage in passes:
        graph.register_pass(fn, stage=stage)
    slot = keep[-1].idx if skybox else None
    target = FrameRenderTarget(width, height, samples)
    settings = BaseRenderGraphSettings()
    mesh = device_mesh(n, device="cpu")
    out = {}
    for mode in ("bands", "single"):
        graph._prev_visible_mask = None
        imgs, masks = [], []
        for _ in range(frames):
            runner.renderer.swap_instruction_buffers()
            ev = runner.renderer.evaluate_instructions()
            if mode == "bands":
                program, args = build_tiled_frame_callable(graph, ev, target, settings, slot, mesh=mesh)
                img, mask, aux = program(*args)
                assert aux["samples"] == samples
                img = img.numpy()
            else:
                img = graph.render_frame(ev, target, settings, slot)
                mask = graph._prev_visible_mask
            imgs.append(img)
            masks.append(mask.clone())
        out[mode] = (imgs, masks)
    del keep
    return out


CASES = {
    # name: (scene, width, height, bands, samples, skybox, passes)
    "shadow-8": (scenes.shadow_cube, 64, 64, 8, 1, False, ()),
    "shadow-2": (scenes.shadow_cube, 64, 64, 2, 1, False, ()),
    "textured-cutout-blend-4": (scenes.band_features, 128, 64, 4, 1, False, ()),
    "mipmapped-floor-8": (scenes.mipmapped_floor, 64, 64, 8, 1, False, ()),
    "mipmapped-floor-msaa4-4": (scenes.mipmapped_floor, 64, 64, 4, 4, False, ()),
    "skybox-pass-msaa4-4": (scenes.skybox_cube, 64, 64, 4, 4, True, ((_row0_pass, "hdr"),)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bands_equal_one_device(case):
    build, w, h, n, samples, skybox, passes = CASES[case]
    out = _frames(build, w, h, n, samples, skybox=skybox, passes=passes)
    (bimgs, bmasks), (simgs, smasks) = out["bands"], out["single"]
    assert bimgs[0].shape == (h, w, 4) and bimgs[0].dtype == np.uint8
    assert bimgs[0][..., :3].max() > 0, "empty render"
    for k in range(len(simgs)):
        diff = int((bimgs[k] != simgs[k]).any(-1).sum())
        assert diff == 0, f"frame {k}: the {n}-band image differs from one device at {diff} pixels"
        assert torch.equal(bmasks[k], smasks[k]), f"frame {k}: the carried masks differ"


def test_bands_touch_the_band_paths():
    """The textured scene's bands run the cutout and blend peels, and the
    mask they carry into the next frame leaves some triangle out."""
    runner = TestRunner(device="cpu")
    keep = scenes.band_features(runner)
    graph = runner.base_graph
    mesh = device_mesh(4, device="cpu")
    stats = []
    for _ in range(2):
        runner.renderer.swap_instruction_buffers()
        program, args = build_tiled_frame_callable(
            graph, runner.renderer.evaluate_instructions(), FrameRenderTarget(128, 64), mesh=mesh
        )
        stats.append(program(*args)[2])
    assert stats[1]["cut_survivors"] > 0 and stats[1]["cut_peels"] >= 1
    assert stats[1]["blend_px"] > 0 and stats[1]["blend_peels"] >= 1
    assert graph._prev_visible_mask is not None and not bool(graph._prev_visible_mask.all())
    del keep


def test_same_program_twice():
    """One tiled program run twice gives the same image, the one-device
    frame's."""
    runner = TestRunner(device="cpu")
    keep = scenes.mipmapped_floor(runner)
    runner.renderer.swap_instruction_buffers()
    ev = runner.renderer.evaluate_instructions()
    target = FrameRenderTarget(64, 64)
    program, args = build_tiled_frame_callable(runner.base_graph, ev, target, mesh=device_mesh(8, device="cpu"))
    a = program(*args)[0].numpy()
    b = program(*args)[0].numpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, runner.base_graph.render_frame(ev, target))
    del keep


def test_bands_refuse_what_they_cannot_render(monkeypatch):
    """The height must divide across the bands, and the reference forward
    backend renders whole frames only (JAX's band frame is the deferred
    pipeline's)."""
    runner = TestRunner(device="cpu")
    keep = scenes.shadow_cube(runner)
    graph = runner.base_graph
    runner.renderer.swap_instruction_buffers()
    ev = runner.renderer.evaluate_instructions()
    with pytest.raises(ValueError, match="must divide"):
        build_tiled_frame_callable(graph, ev, FrameRenderTarget(64, 64), mesh=device_mesh(3, device="cpu"))
    monkeypatch.setenv("REND3_TPU_RASTER", "reference")
    program, args = build_tiled_frame_callable(graph, ev, FrameRenderTarget(64, 64), mesh=device_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="deferred frame"):
        program(*args)
    del keep


# ---------------------------------------------------------------------------
# The distributed mesh: two gloo processes
# ---------------------------------------------------------------------------


def test_gloo_two_processes(tmp_path):
    """Two gloo ranks, one band each, render the textured, cutout and blend
    scene (two frames, testing.run_band_ranks: processes joined with a
    timeout of their own); every rank's image and mask equal the
    one-device frame's bit for bit."""
    ranks = testing.run_band_ranks(str(tmp_path), 2, "cpu")
    single = _frames(scenes.band_features, *testing.BAND_RANK_SIZE, 1)["single"]
    for got in ranks:
        for k in range(2):
            np.testing.assert_array_equal(got["imgs"][k], single[0][k])
            np.testing.assert_array_equal(got["masks"][k], single[1][k].numpy())


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def test_shadow_8_bands_against_jax_tiled(record_property):
    """The 8-band shadow scene against JAX's build_tiled_frame_callable on
    the 8 virtual CPU devices: within 1 u8 (the largest difference is
    recorded as max_u8_diff)."""
    import jax

    import rend3_tpu.testing as jax_testing
    from rend3_tpu import types as jtypes
    from rend3_tpu.parallel import tiles as jtiles
    from rend3_tpu.routine.base import FrameRenderTarget as JaxTarget
    from rend3_tpu.routine.pbr import material as jmat
    from rend3_tpu.utils import math as jm3

    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    jrunner = jax_testing.TestRunner()
    jkeep = scenes.shadow_cube(jrunner, mat=jmat, types=jtypes, m3=jm3)
    jr = jrunner.renderer
    jr.swap_instruction_buffers()
    program, args = jtiles.build_tiled_frame_callable(
        jrunner.base_graph, jr.evaluate_instructions(), JaxTarget(64, 64, 1), mesh=jtiles.device_mesh(8)
    )
    ref = np.asarray(jax.device_get(program(*args)[0]))
    port = _frames(scenes.shadow_cube, 64, 64, 8, frames=1)["bands"][0][0]
    diff = int(np.abs(port.astype(np.int32) - ref.astype(np.int32)).max())
    record_property("max_u8_diff", diff)
    print(f"8-band shadow scene, port vs JAX tiled: max u8 difference {diff}")
    assert ref[..., :3].max() > 0
    assert diff <= 1, diff
    del jkeep


BAND_H = 64


def _jax_band(row0):
    """The stress soup's band [row0, row0 + 64) through JAX's front end and
    K1 (interpret mode): (setup, binned, gbuf, plane table)."""
    from rend3_tpu.ops import deferred as JD
    from rend3_tpu.ops import geometry as JG
    from rend3_tpu.ops import raster as JRaster

    clip, planes = testing.raster_stress_input(0)
    t = JG.cull_and_setup(
        jnp.asarray(clip), jnp.ones(clip.shape[0], bool), testing.STRESS_W, testing.STRESS_H,
        cull_mode=JRaster.CullMode.NONE, front_is_cw=True, subpixel=True,
        y_range=(float(row0), float(row0 + BAND_H)),
    )
    n = int(t.count)
    jplanes = planes[np.clip(np.asarray(t.src), 0, clip.shape[0] - 1)]
    binned = JG.bin_triangles(
        t, testing.STRESS_W, BAND_H, tile_cap=n, tile_h=JD.DTILE_H, tile_w=JD.DTILE_W, y0=row0
    )
    assert int(binned.overflow) == 0
    gbuf, ovf = JD.raster_resolve(
        t, jnp.asarray(jplanes), binned, testing.STRESS_W, BAND_H, interpret=True, flat_cap=1 << 15, y0=row0
    )
    assert int(ovf) == 0
    return clip, t, binned, np.asarray(gbuf.data), jplanes


@pytest.fixture(scope="module")
def jax_bands():
    return {row0: _jax_band(row0) for row0 in (32, 64)}


@pytest.mark.parametrize("row0", [32, 64])
def test_k1_band_offset_against_jax(jax_bands, row0):
    """K1's plain version at the band's first row on JAX's tables: depth,
    hit and material bit for bit, the other channels within 1 ulp."""
    _clip, t, binned, jgbuf, jplanes = jax_bands[row0]
    n = int(t.count)
    pt = interop.tri_setup(t.setup, t.bbox, n, t.src, t.flip)
    pgbuf = PD.raster_resolve(
        pt, interop.planes(jplanes, n), interop.binned(binned.ids), testing.STRESS_W, BAND_H, y0=row0
    ).data.numpy()
    assert (pgbuf[PD.G_HIT] > 0).mean() > 0.3
    for ch in (PD.G_DEPTH, PD.G_HIT, PD.G_MAT):
        np.testing.assert_array_equal(pgbuf[ch], jgbuf[ch])
    np.testing.assert_array_max_ulp(pgbuf, jgbuf, maxulp=1)


@pytest.mark.parametrize("row0", [32, 64])
def test_band_front_end_against_jax(jax_bands, row0):
    """cull_and_setup(y_range=) and bin_triangles(y0=) of the port on the
    same clip table equal JAX's bit for bit: the survivors, their setup
    rows and bboxes, and each tile's list. The band's viewport reject drops
    triangles the whole target keeps."""
    clip, t, binned, _g, _p = jax_bands[row0]
    n = int(t.count)
    c = torch.from_numpy(clip)
    valid = torch.ones(c.shape[0], dtype=torch.bool)
    own = PG.cull_and_setup(
        c, valid, testing.STRESS_W, testing.STRESS_H, cull_mode=PG.CullMode.NONE, front_is_cw=True, subpixel=True,
        y_range=(row0, row0 + BAND_H),
    )
    whole = PG.cull_and_setup(
        c, valid, testing.STRESS_W, testing.STRESS_H, cull_mode=PG.CullMode.NONE, front_is_cw=True, subpixel=True,
    )
    assert 0 < own.count == n < whole.count
    np.testing.assert_array_equal(own.src.numpy(), np.asarray(t.src)[:n])
    np.testing.assert_array_equal(own.setup.numpy(), np.asarray(t.setup)[:n])
    np.testing.assert_array_equal(own.bbox.numpy(), np.asarray(t.bbox)[:n])
    own_b = PG.bin_triangles(own, testing.STRESS_W, BAND_H, tile_h=PD.DTILE_H, tile_w=PD.DTILE_W, y0=row0)
    ref_b = interop.binned(binned.ids)
    assert torch.equal(own_b.offsets, ref_b.offsets)
    assert torch.equal(own_b.ids, ref_b.ids)
