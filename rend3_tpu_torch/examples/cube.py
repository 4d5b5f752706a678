"""Cube example (port of examples/cube.py; reference:
examples/src/cube/mod.rs): one lit grey cube, a directional light with
shadows, and two colored point lights, on a purple clear color. Golden:
examples/src/cube/screenshot.png at 1280x720 (the JAX package's render is
the repository's cube.png).

    python3 -m rend3_tpu_torch.examples.cube [--out cube-torch.png] [--device cpu]
"""

import numpy as np

from .. import framework
from ..routine.pbr.material import AlbedoComponent, PbrMaterial
from ..types import (
    Camera,
    DirectionalLight,
    Handedness,
    MeshBuilder,
    Object,
    Perspective,
    PointLight,
    StaticMeshKind,
)
from ..utils import math as m3
from . import parser, run

CUBE_POSITIONS = np.array(
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
CUBE_INDICES = np.array(
    [0, 1, 2, 2, 3, 0, 4, 5, 6, 6, 7, 4, 8, 9, 10, 10, 11, 8,
     12, 13, 14, 14, 15, 12, 16, 17, 18, 18, 19, 16, 20, 21, 22, 22, 23, 20],
    np.uint32,
)


def cube_view() -> np.ndarray:
    """The examples' camera: at (3, 3, -5), glam from_euler(XYZ, -0.55,
    0.5, 0) = Rx(-0.55) @ Ry(0.5)."""
    view_location = np.array([3.0, 3.0, -5.0], np.float32)
    return m3.rotation_x(-0.55) @ m3.rotation_y(0.5) @ m3.translation(-view_location)


class CubeExample(framework.App):
    HANDEDNESS = Handedness.LEFT

    def clear_color(self):
        return (0.10, 0.05, 0.10, 1.0)

    def setup(self, context):
        r = context.renderer
        mesh = MeshBuilder(CUBE_POSITIONS, Handedness.LEFT).with_indices(CUBE_INDICES).build()
        mesh_handle = r.add_mesh(mesh)
        material = r.add_material(
            PbrMaterial(albedo=AlbedoComponent.new_value([0.5, 0.5, 0.5, 1.0]))
        )
        self.object = r.add_object(
            Object(mesh_kind=StaticMeshKind(mesh_handle), material=material, transform=np.eye(4))
        )
        r.set_camera_data(Camera(projection=Perspective(vfov=60.0, near=0.1), view=cube_view()))

        self.light = r.add_directional_light(
            DirectionalLight(
                color=np.ones(3, np.float32),
                intensity=1.0,
                direction=np.array([-1.0, -4.0, 2.0], np.float32),
                distance=400.0,
                resolution=2048,
            )
        )
        self.point_lights = [
            r.add_point_light(PointLight(position=p, color=c, radius=2.0, intensity=4.0))
            for p, c in [
                ([0.1, 1.2, -1.5], [1.0, 0.0, 0.0]),
                ([1.5, 1.2, -0.1], [0.0, 1.0, 0.0]),
            ]
        ]


def main(argv=None):
    args = parser("rend3 cube example", "cube-torch.png").parse_args(argv)
    return run(CubeExample, args)


if __name__ == "__main__":
    main()
