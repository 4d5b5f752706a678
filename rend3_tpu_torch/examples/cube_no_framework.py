"""Cube without the framework (port of examples/cube_no_framework.py;
reference: examples/src/cube_no_framework/mod.rs): the same lit cube as the
cube example, but driving the raw renderer API directly — create the
Renderer, build the base graph, push instructions, swap + evaluate, render —
exactly the sequence an integrating application performs without
`rend3_tpu_torch.framework`.

    python3 -m rend3_tpu_torch.examples.cube_no_framework [--device cpu]
"""

import numpy as np

from ..core.renderer import Renderer
from ..routine.base import BaseRenderGraph, BaseRenderGraphSettings, FrameRenderTarget
from ..routine.pbr.material import AlbedoComponent, PbrMaterial
from ..testing import save_png
from ..types import Camera, DirectionalLight, Handedness, MeshBuilder, Object, Perspective, StaticMeshKind
from . import parser
from .cube import CUBE_INDICES, CUBE_POSITIONS, cube_view


def render(width=1280, height=720, device="cuda") -> np.ndarray:
    # cube_no_framework/mod.rs:96-116 — create the renderer + base routines.
    renderer = Renderer(handedness=Handedness.LEFT, aspect_ratio=width / height, device=device)
    base_graph = BaseRenderGraph(renderer)

    # mod.rs:118-143 — mesh, material, object (held alive for the render).
    mesh = MeshBuilder(CUBE_POSITIONS, Handedness.LEFT).with_indices(CUBE_INDICES).build()
    mesh_handle = renderer.add_mesh(mesh)
    material = renderer.add_material(
        PbrMaterial(albedo=AlbedoComponent.new_value([0.0, 0.5, 0.5, 1.0]))
    )
    _object = renderer.add_object(
        Object(mesh_kind=StaticMeshKind(mesh_handle), material=material, transform=np.eye(4))
    )

    # mod.rs:145-160 — camera.
    renderer.set_camera_data(Camera(projection=Perspective(vfov=60.0, near=0.1), view=cube_view()))

    # mod.rs:162-172 — one directional light.
    _light = renderer.add_directional_light(
        DirectionalLight(
            color=np.ones(3, np.float32),
            intensity=10.0,
            direction=np.array([-1.0, -4.0, 2.0], np.float32),
            distance=400.0,
            resolution=2048,
        )
    )

    # mod.rs:183-196 — swap buffers, evaluate instructions, draw the frame.
    renderer.swap_instruction_buffers()
    eval_output = renderer.evaluate_instructions()
    return base_graph.render_frame(
        eval_output,
        FrameRenderTarget(width, height, 1),
        BaseRenderGraphSettings(clear_color=(0.10, 0.05, 0.10, 1.0)),
    )


def main(argv=None):
    args = parser("rend3 cube example without the framework", "cube_no_framework-torch.png").parse_args(argv)
    img = render(args.width, args.height, args.device)
    save_png(args.out, img)
    print(f"wrote {args.out}")
    return img


if __name__ == "__main__":
    main()
