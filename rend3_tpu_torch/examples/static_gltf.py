"""static_gltf example (port of examples/static_gltf.py; reference:
examples/src/static_gltf/mod.rs): load the first mesh primitive of data.glb
with a value-albedo PBR material, render with one shadowed directional
light. Golden: static_gltf/screenshot.png.

    python3 -m rend3_tpu_torch.examples.static_gltf [GLB] [--device cpu]
"""

import numpy as np

from .. import framework
from ..gltf.loader import _GltfFile
from ..routine.pbr.material import AlbedoComponent, PbrMaterial
from ..types import Camera, DirectionalLight, Handedness, MeshBuilder, Object, Perspective, StaticMeshKind
from ..utils import math as m3
from . import asset_bytes, parser, reference_asset, run

GLB_PATH = reference_asset("examples/src/static_gltf/data.glb")


class StaticGltfExample(framework.App):
    HANDEDNESS = Handedness.LEFT

    def __init__(self, source=GLB_PATH):
        """source: the .glb, as a path or its bytes."""
        self.data, _ = asset_bytes(source, "the static_gltf scene")

    def clear_color(self):
        return (0.10, 0.05, 0.10, 1.0)

    def setup(self, context):
        r = context.renderer
        file = _GltfFile(self.data)
        prim = file.json["meshes"][0]["primitives"][0]
        attrs = prim["attributes"]
        # reference builds the mesh as right-handed and flips winding.
        builder = MeshBuilder(file.accessor(attrs["POSITION"]).astype(np.float32), Handedness.RIGHT)
        builder = builder.with_vertex_normals(file.accessor(attrs["NORMAL"]).astype(np.float32))
        if "TANGENT" in attrs:
            builder = builder.with_vertex_tangents(file.accessor(attrs["TANGENT"])[:, :3].astype(np.float32))
        if "TEXCOORD_0" in attrs:
            builder = builder.with_vertex_uv0(file.accessor(attrs["TEXCOORD_0"]).astype(np.float32))
        builder = builder.with_indices(file.accessor(prim["indices"]).reshape(-1).astype(np.uint32))
        builder = builder.with_flip_winding_order()
        mesh_handle = r.add_mesh(builder.build())

        mats = file.json.get("materials", [])
        mi = prim.get("material")
        base_color = (
            mats[mi].get("pbrMetallicRoughness", {}).get("baseColorFactor", [1, 1, 1, 1])
            if mi is not None and mi < len(mats)
            else [1, 1, 1, 1]
        )
        material = r.add_material(PbrMaterial(albedo=AlbedoComponent.new_value(base_color)))

        self.object = r.add_object(
            Object(
                mesh_kind=StaticMeshKind(mesh_handle),
                material=material,
                transform=m3.scale([1.0, 1.0, -1.0]),
            )
        )

        view = m3.rotation_x(-0.55) @ m3.rotation_y(0.5)
        view = view @ m3.translation([-3.0, -3.0, 5.0])
        r.set_camera_data(Camera(projection=Perspective(vfov=60.0, near=0.1), view=view))

        self.light = r.add_directional_light(
            DirectionalLight(
                color=np.ones(3),
                intensity=4.0,
                direction=np.array([-1.0, -4.0, 2.0], np.float32),
                distance=20.0,
                resolution=2048,
            )
        )


def main(argv=None):
    p = parser("rend3 static_gltf example", "static_gltf-torch.png")
    p.add_argument("glb", nargs="?", default=GLB_PATH, help="the scene (.glb)")
    args = p.parse_args(argv)
    return run(lambda: StaticGltfExample(args.glb), args)


if __name__ == "__main__":
    main()
