"""scene_viewer — the flag-driven CLI viewer (port of
examples/scene_viewer.py; reference: examples/src/scene_viewer/mod.rs:234-266
flag set).

Renders a glTF scene offscreen with the full pipeline (culling, shadows,
PBR) and writes PNG frames; --benchmark reports ms/frame; --serve streams
frames to a browser on localhost.

    python3 -m rend3_tpu_torch.examples.scene_viewer SCENE.glb [--device cpu]
"""

import json
import time

import numpy as np

from .. import framework
from ..framework.camera import FirstPersonControls
from ..gltf.loader import GltfLoadSettings, load_gltf
from ..testing import save_png
from ..types import DirectionalLight, Handedness
from . import asset_bytes, parser


class SceneViewer(framework.App):
    HANDEDNESS = Handedness.LEFT

    def __init__(self, args):
        """args: parse_args()'s namespace; args.gltf is the scene's path or
        its bytes."""
        self.args = args
        self.data, self.base_dir = asset_bytes(args.gltf, "the scene")
        self._samples = 4 if args.msaa == 4 else 1
        # First-person controls (reference mod.rs:583-643); --walk scripts
        # and the live viewer both drive them.
        # Sign note: this CLI's --pitch/--yaw historically bake directly
        # into rotation_x(pitch) @ rotation_y(yaw); the controls' euler is
        # rotation_x(-pitch) @ rotation_y(-yaw) (the reference's), so negate
        # on ingest to keep existing flag values rendering identically.
        self.controls = FirstPersonControls(
            location=np.array(args.eye, np.float32),
            pitch=float(-np.deg2rad(args.pitch)),
            yaw=float(-np.deg2rad(args.yaw)),
            vfov=args.fov,
        )
        self._walk = self.controls.run_script(args.walk) if args.walk else None

    def sample_count(self):
        return self._samples

    def ambient_color(self):
        a = self.args.ambient
        return (a, a, a, 1.0)

    def clear_color(self):
        return (0.0, 0.0, 0.0, 1.0)

    def setup(self, context):
        r = context.renderer
        settings = GltfLoadSettings(
            scale=self.args.scale,
            directional_light_shadow_distance=self.args.shadow_distance,
            directional_light_resolution=self.args.shadow_resolution,
            enable_directional=not self.args.no_gltf_lights,
        )
        self.loaded, self.instance, _ = load_gltf(r, self.data, settings, base_dir=self.base_dir)

        if self.args.directional_light is not None:
            d = np.array(self.args.directional_light, np.float32)
            self.extra_light = r.add_directional_light(
                DirectionalLight(
                    color=np.ones(3),
                    intensity=self.args.directional_light_intensity,
                    direction=d,
                    distance=self.args.shadow_distance,
                    resolution=self.args.shadow_resolution,
                )
            )

        r.set_camera_data(self.controls.camera())

    def handle_redraw(self, context):
        # Scripted flythrough: advance the walk script one frame, then
        # re-upload the camera (reference mod.rs:583-643 per-redraw update).
        if self._walk is not None:
            next(self._walk, None)
        context.renderer.set_camera_data(self.controls.camera())


def parse_args(argv=None):
    p = parser("rend3 scene viewer", "scene_viewer-torch.png")
    p.add_argument("gltf", help="path to .gltf/.glb scene")
    p.add_argument("--msaa", type=int, default=1, choices=[1, 4])
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--eye", type=float, nargs=3, default=[3.0, 3.0, -5.0])
    p.add_argument("--pitch", type=float, default=-30.0)
    p.add_argument("--yaw", type=float, default=30.0)
    p.add_argument("--ambient", type=float, default=0.1)
    p.add_argument("--shadow-distance", type=float, default=100.0)
    p.add_argument("--shadow-resolution", type=int, default=2048)
    p.add_argument("--no-gltf-lights", action="store_true")
    p.add_argument("--directional-light", type=float, nargs=3, default=None,
                   help="add a light with this direction")
    p.add_argument("--directional-light-intensity", type=float, default=4.0)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--walk", default=None,
                   help="scripted first-person flythrough: comma-separated "
                        "held-key frames and commands, e.g. "
                        "'w,w,w,yaw:15,wd,wd,pitch:-10,W,W' (uppercase=run); "
                        "writes one frame per movement step")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="live viewer: stream frames over http://localhost:PORT "
                        "with WASD/mouse-drag controls in the browser")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    try:
        app = SceneViewer(args)
    except FileNotFoundError as e:
        raise SystemExit(str(e)) from e
    if args.serve is not None:
        from ..framework.viewer import serve_app

        serve_app(app, args.width, args.height, port=args.serve, device=args.device)
        return None
    frames = args.frames
    if args.walk:
        steps = sum(1 for t in args.walk.split(",") if t.strip() and ":" not in t)
        frames = max(frames, steps + 1)
    t0 = time.perf_counter()
    images = framework.start(app, args.width, args.height, frames=frames,
                             frame_dt=(1.0 / 60.0 if args.walk else 0.0), device=args.device)
    elapsed = time.perf_counter() - t0

    if args.walk and len(images) > 1:
        stem, _, ext = args.out.rpartition(".")
        for i, im in enumerate(images):
            save_png(f"{stem or 'frame'}_{i:03d}.{ext or 'png'}", im)
        print(f"wrote {len(images)} flythrough frames ({stem or 'frame'}_NNN.{ext or 'png'})")
    save_png(args.out, images[-1])
    print(f"wrote {args.out}")
    if args.benchmark:
        per = elapsed / max(1, args.frames) * 1000.0
        print(json.dumps({"metric": "scene_viewer ms/frame", "value": round(per, 2), "unit": "ms"}))
    return images[-1]


if __name__ == "__main__":
    main()
