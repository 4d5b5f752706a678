"""Application framework (counterpart of rend3-framework; port of
rend3_tpu/framework/__init__.py).

Reference: rend3-framework/src/lib.rs — the App trait + start(): build
renderer, base graph and default routines, call the app's setup(), then run
the frame loop. Windowing is replaced by offscreen rendering to PNG (the
headless path rend3's own example tests use, examples/src/tests.rs:16-88);
framework.viewer streams the same loop to a browser. The renderer and the
overlay run on `device`, the card unless the caller passes "cpu".
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.renderer import Renderer
from ..routine.base import BaseRenderGraph, BaseRenderGraphSettings, FrameRenderTarget
from ..types import Handedness
from .assets import AssetLoader, AssetPath

__all__ = [
    "App",
    "SetupContext",
    "RedrawContext",
    "start",
    "render_single_frame",
    "AssetLoader",
    "AssetPath",
    "BaseRenderGraphSettings",
    "FrameRenderTarget",
]


@dataclass
class SetupContext:
    renderer: Renderer
    base_graph: BaseRenderGraph
    resolution: tuple
    overlay: object = None       # OverlayRoutine — register UI textures here
    loader: AssetLoader = None   # AssetLoader for the app's base path


@dataclass
class RedrawContext:
    renderer: Renderer
    base_graph: BaseRenderGraph
    resolution: tuple
    delta_t_seconds: float
    elapsed: float
    overlay: object = None


class App:
    """Subclass and override; mirrors rend3_framework::App."""

    HANDEDNESS = Handedness.LEFT

    def sample_count(self) -> int:
        return 1

    def ambient_color(self):
        return (0.0, 0.0, 0.0, 0.0)

    def clear_color(self):
        return (0.0, 0.0, 0.0, 1.0)

    def skybox_slot(self) -> Optional[int]:
        return None

    def asset_base(self) -> str:
        """Base path for the AssetLoader handed to setup() (the reference's
        new_local base file path, assets.rs:41-54)."""
        return ""

    def setup(self, context: SetupContext) -> None:  # pragma: no cover
        pass

    def handle_redraw(self, context: RedrawContext) -> None:
        """Per-frame scene mutation (animation etc.); default no-op."""

    #: When True, overlay_jobs are baked once and composited on the device
    #: inside the frame through register_pass (the reference draws egui in
    #: the renderpass, rend3-egui/src/lib.rs:52-94). The bake is keyed on
    #: job + texture content, so static UI costs one bake and then rides
    #: every frame; per-frame-changing UI should leave this False (the host
    #: compositor — rebaking every frame walks the triangles twice).
    OVERLAY_ON_DEVICE = False

    def overlay_jobs(self, context: RedrawContext) -> list:
        """UI paint jobs (overlay.PaintJob) composited over this frame —
        the rend3-egui integration point (the reference adds the egui node
        after the tonemap node, rend3-egui/src/lib.rs:16-60). Return an
        empty list for no overlay."""
        return []


def _overlay_key(overlay_routine, jobs) -> str:
    """Content hash of paint jobs + registered UI textures: the on-device
    overlay pass rebakes only when this changes."""
    h = hashlib.sha1()
    for job in jobs:
        for arr in (job.vertices, job.colors, job.indices):
            h.update(np.ascontiguousarray(arr).tobytes())
        if job.uvs is not None:
            h.update(np.ascontiguousarray(job.uvs).tobytes())
        h.update(repr((job.texture, job.clip_rect)).encode())
    for tid in sorted(overlay_routine._textures):
        h.update(str(tid).encode())
        h.update(overlay_routine._textures[tid].tobytes())
    return h.hexdigest()


def _setup(app: App, width: int, height: int, device):
    """Renderer, base graph and overlay on `device`, the app's setup() run;
    returns (renderer, base_graph, overlay, settings, target)."""
    from ..overlay import OverlayRoutine

    renderer = Renderer(handedness=app.HANDEDNESS, aspect_ratio=width / height, device=device)
    base_graph = BaseRenderGraph(renderer)
    overlay_routine = OverlayRoutine(renderer.device)
    app.overlay = overlay_routine  # texture registration from setup/redraw
    app.setup(
        SetupContext(
            renderer=renderer,
            base_graph=base_graph,
            resolution=(width, height),
            overlay=overlay_routine,
            loader=AssetLoader(app.asset_base()),
        )
    )
    renderer.set_aspect_ratio(width / height)
    settings = BaseRenderGraphSettings(
        ambient_color=tuple(app.ambient_color()), clear_color=tuple(app.clear_color())
    )
    target = FrameRenderTarget(width, height, app.sample_count())
    return renderer, base_graph, overlay_routine, settings, target


def render_single_frame(app: App, width: int, height: int, device="cuda") -> np.ndarray:
    """Run setup + one frame; returns (H, W, 4) u8."""
    return start(app, width, height, frames=1, device=device)[-1]


def start(app: App, width: int, height: int, frames: int = 1, frame_dt: float = 0.0, device="cuda") -> list:
    """Headless event loop: setup once, then `frames` redraws. Returns the
    rendered images ((H, W, 4) u8 numpy arrays).

    frame_dt defaults to 0.0 to mirror the reference's headless screenshot
    harness (examples/src/tests.rs:79 `delta_t_seconds: 0.0`), so animated
    examples render their t=0 pose; live viewers pass a real delta."""
    renderer, base_graph, overlay_routine, settings, target = _setup(app, width, height, device)

    images = []
    elapsed = 0.0
    dev_overlay_key = None
    dev_overlay_fn = None
    for _ in range(frames):
        ctx = RedrawContext(
            renderer=renderer,
            base_graph=base_graph,
            resolution=(width, height),
            delta_t_seconds=frame_dt,
            elapsed=elapsed,
            overlay=overlay_routine,
        )
        app.handle_redraw(ctx)
        jobs = app.overlay_jobs(ctx)
        if jobs and app.OVERLAY_ON_DEVICE:
            key = _overlay_key(overlay_routine, jobs)
            if key != dev_overlay_key:
                if dev_overlay_fn is not None:
                    base_graph.unregister_pass(dev_overlay_fn)
                dev_overlay_fn = overlay_routine.device_pass(jobs, width, height)
                base_graph.register_pass(dev_overlay_fn)
                dev_overlay_key = key
        renderer.swap_instruction_buffers()
        eval_output = renderer.evaluate_instructions()
        img = base_graph.render_frame(eval_output, target, settings, skybox_slot=app.skybox_slot())
        if jobs and not app.OVERLAY_ON_DEVICE:
            img = overlay_routine.render(img, jobs)
        images.append(img)
        elapsed += frame_dt
    return images
