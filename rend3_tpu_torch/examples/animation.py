"""Animation example (port of examples/animation.py; reference:
examples/src/animation/mod.rs): two animated glTF scenes posed per frame via
rend3_tpu_torch.anim. Golden: animation/screenshot.png.

    python3 -m rend3_tpu_torch.examples.animation [GLTF ...] [--device cpu]
"""

import numpy as np

from .. import anim, framework
from ..gltf.loader import GltfLoadSettings, load_gltf
from ..types import Camera, DirectionalLight, Handedness, Perspective
from ..utils import math as m3
from . import asset_bytes, parser, reference_asset, run

SCENE = reference_asset("examples/src/animation/resources/scene.gltf")
CUBE3 = reference_asset("examples/src/animation/resources/cube_3.gltf")


class AnimationExample(framework.App):
    HANDEDNESS = Handedness.LEFT

    def __init__(self, sources=(SCENE, CUBE3)):
        """sources: the animated scenes, each a path or its bytes."""
        self.sources = [asset_bytes(s, "an animation scene") for s in sources]

    def clear_color(self):
        return (0.10, 0.05, 0.10, 1.0)

    def setup(self, context):
        r = context.renderer
        # NOTE reference view: translation(+view_location) with (0, -1.5, 5)
        view = m3.translation([0.0, -1.5, 5.0])
        r.set_camera_data(Camera(projection=Perspective(vfov=60.0, near=0.1), view=view))

        self.objects = []
        for data, base_dir in self.sources:
            loaded, instance, _ = load_gltf(r, data, GltfLoadSettings(enable_directional=False), base_dir=base_dir)
            data = anim.AnimationData.from_gltf_scene(loaded, instance)
            self.objects.append({"loaded": loaded, "instance": instance, "data": data, "t": 0.0})

        self.light = r.add_directional_light(
            DirectionalLight(
                color=np.ones(3),
                intensity=10.0,
                direction=np.array([-1.0, -4.0, 2.0], np.float32),
                distance=20.0,
                resolution=2048,
            )
        )

    def handle_redraw(self, context):
        for ob in self.objects:
            if not ob["loaded"].animations:
                continue
            dur = max(
                (float(ch["times"].max()) for ch in ob["loaded"].animations[0]["channels"] if len(ch["times"])),
                default=0.0,
            )
            if dur > 0:
                ob["t"] = (ob["t"] + context.delta_t_seconds) % dur
            anim.pose_animation_frame(
                context.renderer, ob["loaded"], ob["instance"], ob["data"], 0, ob["t"]
            )


def main(argv=None):
    p = parser("rend3 animation example", "animation-torch.png")
    p.add_argument("gltf", nargs="*", default=[SCENE, CUBE3], help="the animated scenes")
    args = p.parse_args(argv)
    return run(lambda: AnimationExample(args.gltf), args)


if __name__ == "__main__":
    main()
