"""Test harness (counterpart of rend3-test), port of rend3_tpu/testing.py.

The runner renders through the port's Renderer on the device it is given and
reads the same wgpu goldens as the JAX package's harness. Reference: rend3-test/src/runner.rs — a TestRunner that builds the full
renderer + base graph, renders one frame offscreen, and compares against
golden images with thresholds; helpers.rs scene builders (plane/cube/lights).
Goldens are the *wgpu reference renders* checked into the reference repo —
the cross-implementation oracle.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .core.renderer import Renderer
from .routine.base import BaseRenderGraph, BaseRenderGraphSettings, FrameRenderTarget
from .routine.pbr.material import AlbedoComponent, PbrMaterial
from .types import (
    Camera,
    DirectionalLight,
    Handedness,
    MeshBuilder,
    Object,
    StaticMeshKind,
)
from .utils.compare import compare_images

__all__ = ["TestRunner", "FrameRenderSettings", "Threshold", "compare_to_golden", "REFERENCE_RESULTS"]

# Directory of the reference's golden images (rend3-test/tests/results);
# relative golden names resolve against it.
REFERENCE_RESULTS = os.environ.get("REND3_REFERENCE_RESULTS", "")


@dataclass
class FrameRenderSettings:
    """reference: runner.rs:20-46 (64x64 default, size % 64 == 0)."""

    size: int = 64
    samples: int = 1

    def __post_init__(self):
        assert self.size % 64 == 0, "size must be a multiple of 64"


@dataclass
class Threshold:
    """Pass criteria against a golden. Every set bound must hold; at least
    one bound must be set — "no checks means it always fails", the
    reference's rule (rend3-test/src/threshold.rs:8-14). `mae`/`ssim` are
    this harness's native bounds; `flip` bounds the mean FLIP perceptual
    error and `flip_percentiles` is the reference's `Threshold::Percentile`
    (threshold.rs:22-46): ((percentile, bound), ...) pairs over the
    per-pixel FLIP error map, e.g. ((50.0, 0.04),) = FLIP P50 <= 0.04 (the
    shadow-test gate, rend3-test/tests/shadow.rs:33)."""

    mae: float = 0.01
    ssim: float = 0.98
    flip: float = None
    flip_percentiles: tuple = ()


def load_png(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def save_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    arr = np.asarray(img)
    if arr.shape[-1] == 4:
        arr = arr[..., :3]
    Image.fromarray(arr).save(path)


def compare_to_golden(test_img: np.ndarray, golden_path: str, threshold: Threshold, out_dir: str = "tests/output"):
    if not os.path.exists(golden_path):
        # Reference semantics (runner.rs:235-239): a missing golden is
        # created from this render and the test passes.
        save_png(golden_path, test_img)
        return {"created": True}
    golden = load_png(golden_path)
    stats = compare_images(test_img[..., :3], golden)
    name = os.path.splitext(os.path.basename(golden_path))[0]
    os.makedirs(out_dir, exist_ok=True)
    save_png(os.path.join(out_dir, f"{name}-render.png"), test_img)
    checks = []  # "no checks = fail" (ref threshold.rs:8-14)
    if threshold.mae is not None:
        checks.append(stats["mae"] <= threshold.mae)
    if threshold.ssim is not None:
        checks.append(stats["ssim"] >= threshold.ssim)
    if threshold.flip is not None or threshold.flip_percentiles:
        from .utils.flip import flip

        err = flip(golden, test_img[..., :3])
        stats["flip"] = float(err.mean())
        if threshold.flip is not None:
            checks.append(stats["flip"] <= threshold.flip)
        for pct, bound in threshold.flip_percentiles:
            v = float(np.percentile(err, pct))
            stats[f"flip_p{pct:g}"] = v
            checks.append(v <= bound)
    ok = bool(checks) and all(checks)
    assert ok, (
        f"golden mismatch vs {golden_path}: {stats} (threshold {threshold})"
        if checks
        else f"threshold has no checks (always fails, ref threshold.rs:8-14): {threshold}"
    )
    return stats


class TestRunner:
    __test__ = False  # not a pytest class

    def __init__(self, handedness: Handedness = Handedness.LEFT, device="cuda"):
        self.renderer = Renderer(handedness=handedness, device=device)
        self.base_graph = BaseRenderGraph(self.renderer)

    # -- reference helpers.rs ------------------------------------------------

    def add_mesh(self, mesh):
        return self.renderer.add_mesh(mesh)

    def add_object(self, obj: Object):
        return self.renderer.add_object(obj)

    def set_camera_data(self, camera: Camera):
        self.renderer.set_camera_data(camera)

    def add_unlit_material(self, color):
        return self.renderer.add_material(
            PbrMaterial(albedo=AlbedoComponent.new_value(np.asarray(color, np.float32)), unlit=True)
        )

    def add_lit_material(self, color):
        return self.renderer.add_material(
            PbrMaterial(albedo=AlbedoComponent.new_value(np.asarray(color, np.float32)), unlit=False)
        )

    def add_directional_light(self, direction):
        return self.renderer.add_directional_light(
            DirectionalLight(color=np.ones(3), resolution=256, distance=5.0, intensity=1.0, direction=direction)
        )

    def plane(self, material, transform):
        mesh = (
            MeshBuilder(
                np.array(
                    [[-1.0, -1.0, 0.0], [-1.0, 1.0, 0.0], [1.0, 1.0, 0.0], [1.0, -1.0, 0.0]], np.float32
                ),
                Handedness.LEFT,
            )
            .with_indices(np.array([0, 2, 1, 0, 3, 2], np.uint32))
            .build()
        )
        return self.add_object(
            Object(mesh_kind=StaticMeshKind(self.add_mesh(mesh)), material=material, transform=transform)
        )

    def cube(self, material, transform):
        # reference: helpers.rs cube() vertex/index data (a [-1, 1] cube).
        p = np.array(
            [
                [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],       # far
                [-1, 1, -1], [1, 1, -1], [1, -1, -1], [-1, -1, -1],   # near
                [1, -1, -1], [1, 1, -1], [1, 1, 1], [1, -1, 1],       # right
                [-1, -1, 1], [-1, 1, 1], [-1, 1, -1], [-1, -1, -1],   # left
                [1, 1, -1], [-1, 1, -1], [-1, 1, 1], [1, 1, 1],       # top
                [1, -1, 1], [-1, -1, 1], [-1, -1, -1], [1, -1, -1],   # bottom
            ],
            np.float32,
        )
        idx = np.array(
            [0, 1, 2, 2, 3, 0, 4, 5, 6, 6, 7, 4, 8, 9, 10, 10, 11, 8,
             12, 13, 14, 14, 15, 12, 16, 17, 18, 18, 19, 16, 20, 21, 22, 22, 23, 20],
            np.uint32,
        )
        mesh = MeshBuilder(p, Handedness.LEFT).with_indices(idx).build()
        return self.add_object(
            Object(mesh_kind=StaticMeshKind(self.add_mesh(mesh)), material=material, transform=transform)
        )

    # -- frame ----------------------------------------------------------------

    def render_frame(self, settings: FrameRenderSettings = None) -> np.ndarray:
        settings = settings or FrameRenderSettings()
        self.renderer.swap_instruction_buffers()
        eval_output = self.renderer.evaluate_instructions()
        return self.base_graph.render_frame(
            eval_output,
            FrameRenderTarget(settings.size, settings.size, settings.samples),
            BaseRenderGraphSettings(ambient_color=(0, 0, 0, 0), clear_color=(0, 0, 0, 0)),
        )

    def render_and_compare(self, settings: FrameRenderSettings, golden: str, threshold: Threshold):
        img = self.render_frame(settings)
        if not os.path.isabs(golden) and not REFERENCE_RESULTS:
            raise ValueError("relative golden name: set REND3_REFERENCE_RESULTS or pass an absolute path")
        path = golden if os.path.isabs(golden) else os.path.join(REFERENCE_RESULTS, golden)
        return compare_to_golden(img, path, threshold)
