"""The PyTorch port's CUDA kernels against their plain versions on the card.

These need a CUDA device (and nvcc to build csrc/); without one they skip.
On the card, where jax is not installed, skip the suite's conftest:
python -m pytest tests/test_torch_cuda.py --noconftest -q. Each kernel runs
on the same inputs as its plain version; tolerance: K1's depth, hit and
material channels and all of K2 bit-exact, the other K1 channels within
1 ulp, K3 abs <= 1e-6.
"""

import numpy as np
import pytest
import torch

from rend3_tpu_torch import scenes
from rend3_tpu_torch.ops import deferred as D
from rend3_tpu_torch.ops import samplers as S
from rend3_tpu_torch.routine.base import BaseRenderGraphSettings, FrameRenderTarget
from rend3_tpu_torch.testing import TestRunner

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def captured():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    runner = TestRunner(device="cuda")
    keep = scenes.build_city_scene(runner, n_buildings=48, seed=7, representative=False)
    scenes.set_bench_camera(runner, 512, 256)
    runner.base_graph.captured = {}
    runner.renderer.swap_instruction_buffers()
    img = runner.base_graph.render_frame(
        runner.renderer.evaluate_instructions(), FrameRenderTarget(512, 256, 1),
        BaseRenderGraphSettings(ambient_color=(0.08, 0.08, 0.1, 1.0)),
    )
    del keep
    return runner.base_graph.captured, img


def test_k1_matches_plain(captured):
    tris, planes, binned, wp, hp = captured[0]["raster_resolve"]
    k = D.raster_resolve(tris, planes, binned, wp, hp).data
    p = D.raster_resolve_plain(tris, planes, binned, wp, hp)
    for ch in (D.G_DEPTH, D.G_HIT, D.G_MAT):
        assert torch.equal(k[ch], p[ch])
    np.testing.assert_array_max_ulp(k.cpu().numpy(), p.cpu().numpy(), maxulp=1)


def test_k2_matches_plain(captured):
    stris, sbinned, swp, shp = captured[0]["raster_depth"]
    assert torch.equal(D.raster_depth(stris, sbinned, swp, shp), D.raster_depth_plain(stris, sbinned, swp, shp))


def test_k3_matches_plain(captured):
    args = captured[0]["pcf5"]
    err = (S.sample_grid_pcf5(*args) - S.sample_grid_pcf5_plain(*args)).abs().max()
    assert float(err) <= 1e-6


def test_card_frame_matches_cpu(captured):
    runner = TestRunner(device="cpu")
    keep = scenes.build_city_scene(runner, n_buildings=48, seed=7, representative=False)
    scenes.set_bench_camera(runner, 512, 256)
    runner.renderer.swap_instruction_buffers()
    img = runner.base_graph.render_frame(
        runner.renderer.evaluate_instructions(), FrameRenderTarget(512, 256, 1),
        BaseRenderGraphSettings(ambient_color=(0.08, 0.08, 0.1, 1.0)),
    )
    del keep
    assert int(np.abs(img.astype(np.int32) - captured[1].astype(np.int32)).max()) <= 1
