"""The port's frame callable, bench line and graft entry points on the CPU.

- BaseRenderGraph.build_frame_callable: program(*args) gives
  render_frame_tensor's image and carried mask bit for bit on the bench
  city (16 buildings, 128x72), with occlusion culling on and off, from no
  carried mask and from a carried one; two calls of one program give the
  same image, mask and stats, run no `upload` stage and leave args as they
  were; a device OOM in the build or in the program reaches the caller as
  DeviceOutOfMemoryError.
- The shadow-pass callable (`_last_shadow_call`) re-renders both lights'
  maps and their PCF stack bit for bit equal to the cached ones, without
  reading or writing the cache.
- The rich scene of the graft entry points (scenes.rich_scene) at 64x64
  through the port's program against __graft_entry__._build_rich_scene(64)
  through JAX's build_frame_callable (interpret mode): the image within 1
  u8, the carried masks equal (the scene is small enough that JAX's Hi-Z
  sampler's pair cap is not hit).
- bench.main / bench.run at a small size: one stdout line with exactly
  bench.py's keys, dynamic_ms = static_ms + shadow_pass_ms, vs_baseline =
  16 / value, empty caps; utils.devbench.time_op's median.
- graft_entry.dryrun_multichip at 2, 3 and 4 bands on the CPU (64x64, the
  rows rounded down to a multiple of the bands).
"""

import json

import numpy as np
import pytest
import torch

from rend3_tpu_torch import bench, graft_entry
from rend3_tpu_torch.routine import base
from rend3_tpu_torch.routine.base import StageTimer
from rend3_tpu_torch.types.error import DeviceOutOfMemoryError
from rend3_tpu_torch.utils.devbench import time_op

W, H, N_BUILDINGS = 128, 72, 16
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "static_ms", "shadow_pass_ms", "dynamic_ms", "steady_caps",
              "stats"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def city():
    runner, keep, ev, target, settings = bench.scene("cpu", n_buildings=N_BUILDINGS, width=W, height=H)
    yield runner, ev, target, settings
    del keep


def _run_pair(graph, ev, target, settings, mask0):
    """(render_frame_tensor's (image, mask), program's (image, mask, stats)),
    each from the carried mask mask0."""
    graph._prev_visible_mask = mask0
    img = graph.render_frame_tensor(ev, target, settings)
    want = (img, graph._prev_visible_mask)
    graph._prev_visible_mask = mask0
    program, args = graph.build_frame_callable(ev, target, settings)
    return want, program(*args)


@pytest.mark.parametrize("occlusion", [True, False], ids=["occlusion-on", "occlusion-off"])
def test_program_equals_render_frame(city, occlusion):
    runner, ev, target, settings = city
    graph = runner.base_graph
    graph.occlusion_culling = occlusion
    try:
        mask0 = None
        for frame in range(2):  # from no carried mask, then from frame 1's
            (want_img, want_mask), (img, mask, stats) = _run_pair(graph, ev, target, settings, mask0)
            assert img.shape == (H, W, 4) and img.dtype == torch.uint8
            assert torch.equal(img, want_img), f"frame {frame + 1}: {int((img != want_img).any(-1).sum())} pixels"
            if occlusion:
                assert torch.equal(mask, want_mask)
                mask0 = mask.clone()
            else:
                assert mask is mask0 is None
            assert stats == graph.last_stats and stats is not graph.last_stats
        assert stats["cut_survivors"] > 0 and stats["blend_px"] > 0
        if occlusion:
            assert not bool(mask0.all())
    finally:
        graph.occlusion_culling = True


def test_program_is_reentrant(city):
    """Two calls of one program: the same image, mask and stats bit for bit,
    no upload stage in either, and the frame in args left as it was."""
    runner, ev, target, settings = city
    graph = runner.base_graph
    graph.render_frame_tensor(ev, target, settings)  # carry a mask
    graph.timer = StageTimer("cpu")
    try:
        program, args = graph.build_frame_callable(ev, target, settings)
        assert set(graph.timer.ms()) == {"upload"}
        graph.timer = StageTimer("cpu")
        frame = dict(vars(args[1]))
        a = program(*args)
        stages = graph.timer.ms()
        b = program(*args)
        assert "upload" not in graph.timer.ms()
    finally:
        graph.timer = None
    assert "upload" not in stages and {"clip", "gbuffer", "pcf", "blit"} <= set(stages)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2] == b[2]
    assert vars(args[1]).keys() == frame.keys()
    assert all(vars(args[1])[k] is v for k, v in frame.items())


def test_shadow_pass_callable_matches_cache(city):
    runner, ev, target, settings = city
    graph = runner.base_graph
    graph._shadow_cache = None
    graph.render_frame_tensor(ev, target, settings)
    fn, inputs = graph._last_shadow_call
    state, (maps, stacked) = graph._shadow_cache
    graph._shadow_cache = None
    got_maps, got_stacked = fn(*inputs)
    assert graph._shadow_cache is None
    assert len(maps) == len(got_maps) == 2  # both lights
    for want, got in zip(maps, got_maps):
        assert (want > 0).any()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got_stacked[0], stacked[0]) and got_stacked[1] == stacked[1]
    graph._shadow_cache = (state, (maps, stacked))


@pytest.mark.parametrize("where", ["build", "program"])
def test_device_oom_reaches_callers(city, monkeypatch, where):
    runner, ev, target, settings = city
    graph = runner.base_graph
    raised = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    def fail(*_a, **_k):
        raise raised

    if where == "build":
        monkeypatch.setattr(base.BaseRenderGraph, "_upload", fail)
        with pytest.raises(DeviceOutOfMemoryError) as info:
            graph.build_frame_callable(ev, target, settings)
    else:
        program, args = graph.build_frame_callable(ev, target, settings)
        monkeypatch.setattr(base.BaseRenderGraph, "_clip", fail)
        with pytest.raises(DeviceOutOfMemoryError) as info:
            program(*args)
    assert info.value.__cause__ is raised


def test_rich_scene_matches_jax(record_property):
    """The entry points' scene at 64x64, frame 2 (the carried mask of frame
    1) through each package's build_frame_callable; JAX's frame 2 needs no
    capacity growth (render_frame would accept it)."""
    import jax

    import __graft_entry__ as jax_entry
    from rend3_tpu.routine.base import BaseRenderGraphSettings as JaxSettings
    from rend3_tpu.routine.base import FrameRenderTarget as JaxTarget

    jrunner, jsky = jax_entry._build_rich_scene(64)
    jr = jrunner.renderer
    jr.swap_instruction_buffers()
    jev = jr.evaluate_instructions()
    jg = jrunner.base_graph
    for _frame in range(2):
        jprogram, jargs = jg.build_frame_callable(jev, JaxTarget(64, 64, 1), JaxSettings(), skybox_slot=jsky)
        jout = jprogram(*jargs)
        jg._prev_visible_mask = jout[1]  # as render_frame carries it
    jimg, jmask, jaux = jax.device_get(jout)
    assert not jg._grow_caps(np.asarray(jaux))

    runner, sky = graft_entry.build_rich_scene(64, device="cpu")
    runner.renderer.swap_instruction_buffers()
    ev = runner.renderer.evaluate_instructions()
    target = base.FrameRenderTarget(64, 64, 1)
    for _frame in range(2):
        program, args = runner.base_graph.build_frame_callable(ev, target, skybox_slot=sky)
        img, mask, stats = program(*args)
    img = img.numpy()

    diff = int(np.abs(img.astype(np.int32) - np.asarray(jimg).astype(np.int32)).max())
    record_property("max_u8_diff", diff)
    assert img[..., :3].max() > 0 and stats["cut_survivors"] > 0 and stats["blend_px"] > 0
    assert stats["sky_k4_launches"] == 0  # the CPU runs K4's plain version
    assert diff <= 1, diff
    T = mask.shape[0]
    jmask = np.asarray(jmask)
    assert not jmask[T:].any()
    np.testing.assert_array_equal(mask.numpy(), jmask[:T])
    assert not mask.all()


def test_bench_line(monkeypatch, capsys):
    """bench.main at a small size (main's run with its sizes cut, and a
    4-building heavy city): exactly one stdout line, bench.py's keys."""
    real_run = bench.run

    def small_run(**kw):
        return real_run(n_buildings=8, width=64, height=36, iters=2, **kw)

    monkeypatch.setattr(bench, "run", small_run)
    monkeypatch.setattr(bench, "HEAVY", (4, 2))
    assert bench.main(["--device", "cpu", "--flat", "--heavy"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert list(r) == BENCH_KEYS + ["flat_scene_ms", "heavy_ms", "heavy_caps"]
    assert r["metric"] == bench.METRIC and r["unit"] == "ms"
    assert r["value"] == r["static_ms"] > 0 and r["shadow_pass_ms"] > 0
    assert r["dynamic_ms"] == round(r["static_ms"] + r["shadow_pass_ms"], 3)
    assert r["vs_baseline"] == round(16.0 / r["value"], 4)
    assert r["steady_caps"] == {} and r["heavy_caps"] == {}
    assert r["stats"]["main_survivors"] > 0 and r["stats"]["shadow_survivors_1"] > 0
    assert r["flat_scene_ms"] > 0 and r["heavy_ms"] > 0


def test_time_op_median():
    calls = []
    ms = time_op(calls.append, 7, iters=3)
    assert calls == [7, 7, 7] and ms >= 0.0
    with pytest.raises(ValueError):
        time_op(calls.append, 7, iters=0)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_dryrun_multichip(n):
    lines = []
    img = graft_entry.dryrun_multichip(n, device="cpu", size=64, log=lines.append)
    assert img.shape == (64 // n * n, 64, 4)
    assert len(lines) == 1 and "OK" in lines[0]
