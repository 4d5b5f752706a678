"""Skinning example (port of examples/skinning.py; reference:
examples/src/skinning/mod.rs): the RiggedSimple glb with the skeleton posed
via explicit joint transforms. Golden: skinning/screenshot.png.

    python3 -m rend3_tpu_torch.examples.skinning [GLB] [--device cpu]
"""

import numpy as np

from .. import framework
from ..gltf.loader import GltfLoadSettings, load_gltf
from ..types import Camera, DirectionalLight, Handedness, Perspective, Skeleton
from ..utils import math as m3
from . import asset_bytes, parser, reference_asset, run

GLB_PATH = reference_asset("examples/src/skinning/RiggedSimple.glb")


class SkinningExample(framework.App):
    HANDEDNESS = Handedness.LEFT

    def __init__(self, source=GLB_PATH):
        """source: the .glb, as a path or its bytes."""
        self.data, self.base_dir = asset_bytes(source, "the skinning scene")

    def clear_color(self):
        return (0.10, 0.05, 0.10, 1.0)

    def setup(self, context):
        r = context.renderer
        self.loaded, self.instance, self.file = load_gltf(
            r, self.data, GltfLoadSettings(enable_directional=False), base_dir=self.base_dir
        )
        # reference poses the two joints explicitly (skinning/mod.rs:33-55):
        # joint 0 = T(0,0,-4.18), joint 1 = Rx(30*sin(5t)) (0 at t=0).
        ibm = self.loaded.skins[0]["inverse_bind_matrices"]
        globals0 = np.stack([m3.translation([0.0, 0.0, -4.18]), np.eye(4, dtype=np.float32)])
        jm = Skeleton.compute_joint_matrices(globals0, ibm)
        for handles in self.instance.skeletons.values():
            for sk in handles:
                r.set_skeleton_joint_matrices(sk, jm)

        view = m3.translation([0.0, 0.0, 10.0])  # -(-10) along z
        r.set_camera_data(Camera(projection=Perspective(vfov=60.0, near=0.1), view=view))
        self.light = r.add_directional_light(
            DirectionalLight(
                color=np.ones(3),
                intensity=10.0,
                direction=np.array([-1.0, -4.0, 2.0], np.float32),
                distance=400.0,
                resolution=2048,
            )
        )


def main(argv=None):
    p = parser("rend3 skinning example", "skinning-torch.png")
    p.add_argument("glb", nargs="?", default=GLB_PATH, help="the rigged scene (.glb)")
    args = p.parse_args(argv)
    return run(lambda: SkinningExample(args.glb), args)


if __name__ == "__main__":
    main()
