"""textured_quad example (port of examples/textured_quad.py; reference:
examples/src/textured_quad/mod.rs): a 300px checker-textured quad under a
pixel-matched orthographic camera, purple clear color. Golden:
textured_quad/screenshot.png.

    python3 -m rend3_tpu_torch.examples.textured_quad [PNG] [--device cpu]
"""

import io

import numpy as np

from .. import framework
from ..routine.pbr.material import AlbedoComponent, PbrMaterial
from ..types import (
    Camera,
    Handedness,
    MeshBuilder,
    MipmapCount,
    Object,
    Orthographic,
    StaticMeshKind,
    Texture,
    TextureFormat,
)
from ..utils import math as m3
from . import asset_bytes, parser, reference_asset, run

CHECKER = reference_asset("examples/src/textured_quad/checker.png")
CAMERA_DEPTH = 10.0


class TexturedQuadExample(framework.App):
    HANDEDNESS = Handedness.LEFT

    def __init__(self, checker=CHECKER):
        """checker: the texture's PNG, as a path or its bytes."""
        from PIL import Image

        data, _ = asset_bytes(checker, "the checker texture")
        self.image = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))

    def clear_color(self):
        return (0.10, 0.05, 0.10, 1.0)

    def setup(self, context):
        r = context.renderer
        size = 300.0
        mesh = (
            MeshBuilder(
                np.array(
                    [
                        [-size * 0.5, size * 0.5, 0.0],
                        [size * 0.5, size * 0.5, 0.0],
                        [size * 0.5, -size * 0.5, 0.0],
                        [-size * 0.5, -size * 0.5, 0.0],
                    ],
                    np.float32,
                ),
                Handedness.LEFT,
            )
            .with_vertex_uv0(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32))
            .with_indices(np.array([0, 1, 2, 2, 3, 0], np.uint32))
            .build()
        )
        mesh_handle = r.add_mesh(mesh)

        tex = r.add_texture_2d(
            Texture(label="checker", data=self.image, format=TextureFormat.RGBA8_UNORM_SRGB,
                    mip_count=MipmapCount.ONE)
        )
        material = r.add_material(PbrMaterial(albedo=AlbedoComponent.new_texture(tex), unlit=True))
        self.object = r.add_object(
            Object(mesh_kind=StaticMeshKind(mesh_handle), material=material, transform=np.eye(4))
        )
        w, h = context.resolution
        r.set_camera_data(
            Camera(
                projection=Orthographic(size=np.array([w, h, CAMERA_DEPTH], np.float32)),
                view=m3.translation([0.0, 0.0, 1.0]),
            )
        )


def main(argv=None):
    p = parser("rend3 textured_quad example", "textured_quad-torch.png")
    p.add_argument("checker", nargs="?", default=CHECKER, help="the checker texture (PNG)")
    args = p.parse_args(argv)
    return run(lambda: TexturedQuadExample(args.checker), args)


if __name__ == "__main__":
    main()
