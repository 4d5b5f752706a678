"""Overlay (UI) example (port of examples/overlay.py) — the reference's
`egui` example (examples/src/egui/mod.rs): a lit cube with a floating UI
window composited over the frame. The window carries a title bar, a label,
a color swatch (mod.rs:182-192's color_edit button, here showing the cube's
current albedo) and an image widget (mod.rs:194-196's logo ImageButton). UI
meshes are egui-style PaintJobs rendered by rend3_tpu_torch.overlay
.OverlayRoutine, wired through the framework's overlay hook
(App.overlay_jobs); the static UI is baked once and blended on the device
(OVERLAY_ON_DEVICE).

    python3 -m rend3_tpu_torch.examples.overlay [--out overlay-torch.png] [--device cpu]
"""

import numpy as np

from .. import framework
from ..overlay import PaintJob
from ..routine.pbr.material import AlbedoComponent, PbrMaterial
from ..types import Camera, DirectionalLight, Handedness, MeshBuilder, Object, Perspective, StaticMeshKind
from . import parser, run
from .cube import CUBE_INDICES, CUBE_POSITIONS, cube_view

CUBE_COLOR = (0.0, 0.5, 0.5, 1.0)


def _quad(x0, y0, x1, y1, rgba, uv=None):
    """Axis-aligned rect as a 2-triangle PaintJob (egui tessellates panels
    the same way)."""
    v = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float32)
    c = np.tile(np.asarray(rgba, np.float32) * 255.0, (4, 1)).astype(np.uint8)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32) if uv else None
    return v, c, idx, uvs


def _text_image(text, scale=2):
    """Rasterize `text` with Pillow's built-in bitmap font -> (H, W, 4) u8
    straight-alpha white glyphs (the egui font-atlas role)."""
    from PIL import Image, ImageDraw

    im = Image.new("L", (8 * len(text) + 4, 14), 0)
    ImageDraw.Draw(im).text((2, 1), text, fill=255)
    a = np.asarray(im, np.uint8)
    a = np.kron(a, np.ones((scale, scale), np.uint8))  # nearest upscale
    out = np.zeros(a.shape + (4,), np.uint8)
    out[..., :3] = 255
    out[..., 3] = a
    return out


class OverlayExample(framework.App):
    HANDEDNESS = Handedness.LEFT
    # Static UI: bake once and blend on the device inside the frame (the
    # reference draws egui in the renderpass, rend3-egui/src/lib.rs:52-94).
    OVERLAY_ON_DEVICE = True

    def clear_color(self):
        return (0.10, 0.05, 0.10, 1.0)

    def setup(self, context):
        r = context.renderer
        mesh = MeshBuilder(CUBE_POSITIONS, Handedness.LEFT).with_indices(CUBE_INDICES).build()
        mesh_handle = r.add_mesh(mesh)
        self.material = r.add_material(
            PbrMaterial(albedo=AlbedoComponent.new_value(list(CUBE_COLOR)))
        )
        self.object = r.add_object(
            Object(mesh_kind=StaticMeshKind(mesh_handle), material=self.material, transform=np.eye(4))
        )
        r.set_camera_data(Camera(projection=Perspective(vfov=60.0, near=0.1), view=cube_view()))
        self.light = r.add_directional_light(
            DirectionalLight(
                color=np.ones(3, np.float32),
                intensity=4.0,
                direction=np.array([-1.0, -4.0, 2.0], np.float32),
                distance=400.0,
                resolution=2048,
            )
        )

        # UI textures (EguiRenderRoutine::create_egui_texture, mod.rs:120-127).
        self.title_tex = context.overlay.add_texture(_text_image("Change color"))
        self.label_tex = context.overlay.add_texture(_text_image("Cube albedo"))
        logo = np.zeros((64, 64, 4), np.uint8)
        yy, xx = np.mgrid[0:64, 0:64]
        ring = (((xx - 32) ** 2 + (yy - 32) ** 2) ** 0.5).astype(np.float32)
        logo[..., 0] = np.where((ring > 18) & (ring < 28), 222, 40)
        logo[..., 1] = 40
        logo[..., 2] = 30
        logo[..., 3] = 255
        self.logo_tex = context.overlay.add_texture(logo)

    def overlay_jobs(self, context):
        ov = context.overlay
        jobs = []
        x0, y0 = 40.0, 40.0
        w, h = 280.0, 220.0

        def quad_job(x0, y0, x1, y1, rgba, texture=None):
            v, c, idx, uvs = _quad(x0, y0, x1, y1, rgba, uv=texture is not None)
            return PaintJob(vertices=v, colors=c, indices=idx, uvs=uvs, texture=texture)

        # Window panel + title bar (egui Window chrome).
        jobs.append(quad_job(x0, y0, x0 + w, y0 + h, (0.11, 0.11, 0.13, 0.92)))
        jobs.append(quad_job(x0, y0, x0 + w, y0 + 30, (0.23, 0.23, 0.28, 1.0)))
        th, tw = ov._textures[self.title_tex].shape[:2]
        jobs.append(quad_job(x0 + 10, y0 + 2, x0 + 10 + tw, y0 + 2 + th, (1, 1, 1, 1), self.title_tex))
        # Label + color swatch for the cube's albedo.
        lh, lw = ov._textures[self.label_tex].shape[:2]
        jobs.append(quad_job(x0 + 14, y0 + 44, x0 + 14 + lw, y0 + 44 + lh, (1, 1, 1, 1), self.label_tex))
        jobs.append(quad_job(x0 + 14, y0 + 84, x0 + 46, y0 + 116, CUBE_COLOR))
        # Image widget (the logo ImageButton).
        jobs.append(quad_job(x0 + 14, y0 + 136, x0 + 78, y0 + 200, (1, 1, 1, 1), self.logo_tex))
        return jobs


def main(argv=None):
    args = parser("rend3 overlay (egui) example", "overlay-torch.png").parse_args(argv)
    return run(OverlayExample, args)


if __name__ == "__main__":
    main()
