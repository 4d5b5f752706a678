"""Package rules of the PyTorch port (rend3_tpu_torch): it never pulls in
jax or the JAX package, not even when its scenes are built; its entry points
render on the card unless asked for the CPU (the probes' entry points too), and a CUDA
renderer needs a card; features outside the ported slice refuse loudly."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import rend3_tpu_torch as P
from rend3_tpu_torch.testing import FrameRenderSettings, TestRunner


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_import_leaves_jax_out():
    code = (
        "import sys, rend3_tpu_torch, rend3_tpu_torch.routine.base, rend3_tpu_torch.interop, "
        "rend3_tpu_torch.scenes, rend3_tpu_torch.ops.cuda_kernels, rend3_tpu_torch.probe_shadow, "
        "rend3_tpu_torch.frame_profile, rend3_tpu_torch.routine.registry, rend3_tpu_torch.ops.skin, "
        "rend3_tpu_torch.ops.probe_bf16, rend3_tpu_torch.tools.probe_bf16_dot, "
        "rend3_tpu_torch.tools.probe_bf16_kernel, rend3_tpu_torch.tools.probe_bf16_real, "
        "rend3_tpu_torch.utils.profiling, rend3_tpu_torch.overlay, rend3_tpu_torch.framework, "
        "rend3_tpu_torch.framework.assets, rend3_tpu_torch.framework.camera, rend3_tpu_torch.framework.viewer, "
        "rend3_tpu_torch.gltf.compressed, rend3_tpu_torch.gltf.loader, rend3_tpu_torch.anim, "
        "rend3_tpu_torch.examples, rend3_tpu_torch.examples.cube, rend3_tpu_torch.examples.cube_no_framework, "
        "rend3_tpu_torch.examples.overlay, rend3_tpu_torch.examples.textured_quad, "
        "rend3_tpu_torch.examples.static_gltf, rend3_tpu_torch.examples.skinning, "
        "rend3_tpu_torch.examples.animation, rend3_tpu_torch.examples.scene_viewer, "
        "rend3_tpu_torch.ops.fp, rend3_tpu_torch.ops.raster, rend3_tpu_torch.tools.bench_host, "
        "rend3_tpu_torch.parallel, rend3_tpu_torch.parallel.tiles, rend3_tpu_torch.bench, "
        "rend3_tpu_torch.graft_entry, rend3_tpu_torch.utils.devbench, rend3_tpu_torch.tools.frame_launches, "
        "rend3_tpu_torch.testing; "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'rend3_tpu' or m.startswith('rend3_tpu.')); print(bad)"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_tf32_off():
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_cuda_renderer_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.Renderer(device="cuda")


@pytest.mark.parametrize(
    "entry",
    ["Renderer", "TestRunner", "framework.start", "render_single_frame", "OverlayRoutine", "serve_app", "bench_host",
     "device_mesh", "build_tiled_frame_callable", "bench.main", "bench.run", "graft_entry.entry",
     "dryrun_multichip"],
)
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Renderer(), TestRunner(), framework.start, render_single_frame,
    OverlayRoutine(), serve_app, tools.bench_host, the row bands'
    parallel.tiles.device_mesh() and build_tiled_frame_callable (its mesh
    left to the default), the bench line (bench.main, bench.run) and the
    graft entry points (graft_entry.entry, dryrun_multichip) run on the
    card unless asked for the CPU; without a card they raise instead of
    falling back, before the app is set up or a frame rendered, and
    serve_app before it binds a socket."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from rend3_tpu_torch import bench, framework, graft_entry
    from rend3_tpu_torch.framework import viewer
    from rend3_tpu_torch.overlay import OverlayRoutine
    from rend3_tpu_torch.parallel import tiles
    from rend3_tpu_torch.routine.base import FrameRenderTarget
    from rend3_tpu_torch.tools import bench_host

    class App(framework.App):
        def setup(self, context):
            raise AssertionError("setup ran without a card")

    def no_socket(*a, **k):
        raise AssertionError("serve_app bound a socket without a card")

    monkeypatch.setattr(viewer, "ThreadingHTTPServer", no_socket)
    cpu_runner = TestRunner(device="cpu")
    make = {
        "Renderer": P.Renderer,
        "TestRunner": TestRunner,
        "framework.start": lambda: framework.start(App(), 64, 64, frames=2),
        "render_single_frame": lambda: framework.render_single_frame(App(), 64, 64),
        "OverlayRoutine": OverlayRoutine,
        "serve_app": lambda: viewer.serve_app(App(), 64, 64, port=0),
        "bench_host": lambda: bench_host.main(["10"]),
        "device_mesh": tiles.device_mesh,
        "build_tiled_frame_callable": lambda: tiles.build_tiled_frame_callable(
            cpu_runner.base_graph, cpu_runner.renderer.evaluate_instructions(), FrameRenderTarget(64, 64)
        ),
        "bench.main": lambda: bench.main(["--flat"]),
        "bench.run": lambda: bench.run(n_buildings=4, width=64, height=36),
        "graft_entry.entry": graft_entry.entry,
        "dryrun_multichip": lambda: graft_entry.dryrun_multichip(2),
    }[entry]
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        make()


def test_scenes_import_no_jax_package_when_called():
    """Building the bench and test scenes through the port pulls in neither
    jax nor the JAX package."""
    code = (
        "import sys, numpy as np; from rend3_tpu_torch import scenes; "
        "from rend3_tpu_torch.testing import TestRunner; "
        "r = TestRunner(device='cpu'); k = scenes.textured_planes(r); "
        "k2 = scenes.build_city_scene(r, n_buildings=4, representative=True); k3 = scenes.rich_scene(r); "
        "scenes.set_bench_camera(r, 256, 128); "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'rend3_tpu' or m.startswith('rend3_tpu.')); print(bad)"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


@pytest.mark.parametrize("probe", ["probe_bf16_dot", "probe_bf16_kernel", "probe_bf16_real"])
def test_probe_entry_points_need_the_card(probe):
    """tools.probe_bf16_*.run() defaults to the card and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import importlib

    mod = importlib.import_module(f"rend3_tpu_torch.tools.{probe}")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        mod.run(log=lambda _line: None)


@pytest.mark.parametrize("fn", ["probe_bf16_dot.variant", "probe_bf16_kernel.variant", "probe_bf16_real.build"])
def test_probe_public_functions_need_the_card(fn):
    """The probes' public one-variant functions default to the card, as
    run() does, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import importlib

    import numpy as np

    mod_name, name = fn.split(".")
    f = getattr(importlib.import_module(f"rend3_tpu_torch.tools.{mod_name}"), name)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        f("full bf16") if name == "build" else f(0, np.random.RandomState(0))


def test_multi_device_not_ported():
    with pytest.raises(NotImplementedError, match=r"rend3_tpu_torch\.parallel\.tiles"):
        P.Renderer(device=["cuda:0", "cuda:1"])


def test_cuda_kernel_rejects_cpu_tensors():
    from rend3_tpu_torch.ops import cuda_kernels

    t = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda_kernels.call("k3_pcf5", *([t] * 8), ints=(1, 1, 1))


@pytest.mark.parametrize("error", ["cuda_oom", "runtime_oom", "other"])
def test_render_frame_types_device_oom(monkeypatch, error):
    """A device OOM in a frame stage reaches the caller as
    DeviceOutOfMemoryError with the original as its cause; any other
    RuntimeError passes through unchanged."""
    from rend3_tpu_torch.routine import base
    from rend3_tpu_torch.types.error import DeviceOutOfMemoryError

    raised = {
        "cuda_oom": torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
        "runtime_oom": RuntimeError("CUDA error: out of memory"),
        "other": RuntimeError("shape mismatch"),
    }[error]

    def clip(self, f):
        raise raised

    monkeypatch.setattr(base.BaseRenderGraph, "_clip", clip)
    runner = TestRunner(device="cpu")
    if error == "other":
        with pytest.raises(RuntimeError, match="shape mismatch") as info:
            runner.render_frame(FrameRenderSettings(size=64))
        assert info.value is raised
        return
    with pytest.raises(DeviceOutOfMemoryError, match="out of memory") as info:
        runner.render_frame(FrameRenderSettings(size=64))
    assert info.value.__cause__ is raised


def test_empty_scene_renders_clear_color():
    runner = TestRunner(device="cpu")
    img = runner.render_frame(FrameRenderSettings(size=64))
    assert img.shape == (64, 64, 4) and img.dtype == np.uint8
    assert not img.any()
