"""The examples of the PyTorch port (rend3_tpu_torch.examples) on the CPU.

- cube and overlay at 128x72 against the JAX package's examples (imported
  from examples/ by file path), within 1 u8.
- Every example at 128x72 through its main() with --device cpu, the
  assets built in memory (testing.make_test_gltf(), a checker PNG) and
  written to a temporary directory: the PNG is written and the image is
  not the clear colour.
- An absent asset stops the example with an error that names the file.
"""

import importlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from rend3_tpu import framework as JF
from rend3_tpu_torch import framework
from rend3_tpu_torch.testing import load_png, make_test_gltf

W, H = 128, 72
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLEAR = np.array([0.10, 0.05, 0.10])  # the examples' clear colour (linear)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name, cls", [("cube", "CubeExample"), ("overlay", "OverlayExample")])
def test_example_matches_jax(name, cls):
    want = JF.render_single_frame(getattr(_jax_example(name), cls)(), W, H)
    port = importlib.import_module(f"rend3_tpu_torch.examples.{name}")
    got = framework.render_single_frame(getattr(port, cls)(), W, H, device="cpu")
    assert got.shape == want.shape == (H, W, 4) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("assets")
    glb = d / "scene.glb"
    glb.write_bytes(make_test_gltf())
    yy, xx = np.mgrid[0:64, 0:64]
    checker = np.zeros((64, 64, 4), np.uint8)
    checker[..., :3] = np.where(((xx // 8) + (yy // 8)) % 2 == 0, 230, 30)[..., None]
    checker[..., 3] = 255
    from PIL import Image

    Image.fromarray(checker).save(d / "checker.png")
    return {"glb": str(glb), "checker": str(d / "checker.png")}


ARGS = {
    "cube": [],
    "cube_no_framework": [],
    "overlay": [],
    "textured_quad": ["{checker}"],
    "static_gltf": ["{glb}"],
    "skinning": ["{glb}"],
    "animation": ["{glb}", "{glb}"],
    "scene_viewer": ["{glb}", "--eye", "0", "2", "-7", "--pitch", "-15", "--yaw", "0", "--shadow-resolution", "256"],
}


@pytest.mark.parametrize("name", sorted(ARGS))
def test_example_main_writes_png(name, assets, tmp_path):
    out = tmp_path / f"{name}.png"
    argv = [a.format(**assets) for a in ARGS[name]]
    argv += ["--width", str(W), "--height", str(H), "--device", "cpu", "--out", str(out)]
    img = importlib.import_module(f"rend3_tpu_torch.examples.{name}").main(argv)
    assert img.shape == (H, W, 4) and img.dtype == np.uint8
    png = load_png(str(out))
    np.testing.assert_array_equal(png, img[..., :3])
    background = img[0, 0, :3].astype(int)
    assert (np.abs(img[..., :3].astype(int) - background) > 2).any(-1).mean() > 0.02


@pytest.mark.parametrize("name", ["textured_quad", "static_gltf", "skinning", "animation", "scene_viewer"])
def test_missing_asset_stops_with_its_name(name, tmp_path):
    missing = str(tmp_path / "absent.glb")
    with pytest.raises(SystemExit, match="absent.glb"):
        importlib.import_module(f"rend3_tpu_torch.examples.{name}").main([missing, "--device", "cpu"])
