"""Submits the benchmark's scene arrays to the port and drives its frame.

The only file of the harness that calls the system under test, and only
through its public API: `Renderer`, `BaseRenderGraph`, the `types` and
`PbrMaterial`. One frame is what an application's render loop does:

1. apply the mix's instructions for this frame (`Traffic.apply`: the camera,
   object transforms);
2. `Renderer.swap_instruction_buffers()`;
3. `Renderer.evaluate_instructions()`;
4. `BaseRenderGraph.render_frame_tensor(...)` at the configuration's target;
5. `torch.cuda.synchronize()` (on a card).
"""

from __future__ import annotations

import time

import numpy as np

from .scene import Scene

__all__ = ["Port"]


class Port:
    def __init__(self, scene: Scene, traffic, device: str):
        import torch

        from rend3_tpu_torch.core.renderer import Renderer
        from rend3_tpu_torch.routine.base import BaseRenderGraph, BaseRenderGraphSettings, FrameRenderTarget
        from rend3_tpu_torch.routine.pbr.material import AlbedoComponent, AoMRTextures, PbrMaterial, Transparency
        from rend3_tpu_torch.types import (
            DirectionalLight, Handedness, MeshBuilder, MipmapCount, Object, StaticMeshKind, Texture, TextureFormat,
        )

        self.torch = torch
        self.scene, self.traffic = scene, traffic
        self.cuda = device == "cuda"
        r = self.renderer = Renderer(handedness=Handedness.LEFT, device=device)
        self.graph = BaseRenderGraph(r)
        self.target = FrameRenderTarget(scene.width, scene.height, scene.samples)
        self.settings = BaseRenderGraphSettings(ambient_color=tuple(scene.ambient))
        self.keep = []
        meshes = []
        for m in scene.meshes:
            b = MeshBuilder(m.positions, Handedness.LEFT).with_vertex_normals(m.normals)
            if m.uv0 is not None:
                b = b.with_vertex_uv0(m.uv0)
            meshes.append(r.add_mesh(b.with_indices(m.indices.astype(np.uint32).reshape(-1)).build()))
        textures = [
            r.add_texture_2d(Texture(
                label="bench", data=t.rgba, mip_count=MipmapCount.MAXIMUM,
                format=TextureFormat.RGBA8_UNORM_SRGB if t.srgb else TextureFormat.RGBA8_UNORM,
            ))
            for t in scene.textures
        ]
        materials = []
        for m in scene.materials:
            albedo = AlbedoComponent(value=np.asarray(m.albedo, np.float32),
                                     texture=textures[m.albedo_tex] if m.albedo_tex >= 0 else None)
            kw = {}
            if m.aomr_tex >= 0:
                kw["aomr_textures"] = AoMRTextures(mode="combined", aomr_texture=textures[m.aomr_tex])
            if m.cutout > 0:
                kw["transparency"] = Transparency.cutout_at(m.cutout)
            elif m.blend:
                kw["transparency"] = Transparency.blend()
            materials.append(r.add_material(PbrMaterial(
                albedo=albedo, roughness_factor=m.roughness, metallic_factor=m.metallic, **kw)))
        self.objects = [
            r.add_object(Object(mesh_kind=StaticMeshKind(meshes[mi]), material=materials[ma], transform=t))
            for mi, ma, t in zip(scene.obj_mesh, scene.obj_material, scene.transforms)
        ]
        for light in scene.lights:
            self.keep.append(r.add_directional_light(DirectionalLight(
                color=light.color, intensity=light.intensity, direction=light.direction,
                distance=light.distance, resolution=light.resolution,
            )))
        self.keep += meshes + textures + materials
        r.set_aspect_ratio(scene.width / scene.height)
        self.set_camera(traffic.state(0)["view"])

    def set_camera(self, view: np.ndarray) -> None:
        from rend3_tpu_torch.types import Camera, Perspective

        self.renderer.set_camera_data(
            Camera(projection=Perspective(vfov=self.scene.vfov, near=self.scene.near), view=view))

    def apply(self, frame: int) -> None:
        """Step 1: this frame's instructions."""
        self.traffic.apply(self, frame)

    def evaluate(self):
        """Steps 2 and 3."""
        self.renderer.swap_instruction_buffers()
        return self.renderer.evaluate_instructions()

    def render(self, ev):
        """Steps 4 and 5: the (H, W, 4) u8 image, on the device."""
        img = self.graph.render_frame_tensor(ev, self.target, self.settings)
        if self.cuda:
            self.torch.cuda.synchronize()
        return img

    def frame(self, frame: int, mark=None):
        """One frame: (image, seconds, seconds of steps 1-3). mark: an
        optional context manager factory (a profiler range) named around
        steps 1-3."""
        t0 = time.perf_counter()
        if mark is None:
            self.apply(frame)
            ev = self.evaluate()
        else:
            with mark("host:scene"):
                self.apply(frame)
                ev = self.evaluate()
        t1 = time.perf_counter()
        img = self.render(ev)
        return img, time.perf_counter() - t0, t1 - t0

    def close(self) -> None:
        self.objects = self.keep = None
        self.graph = self.renderer = None
