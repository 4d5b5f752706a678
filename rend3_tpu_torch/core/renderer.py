"""The Renderer: public handle-and-instruction API + per-frame evaluation.

Port of rend3_tpu/core/renderer.py. Reference: rend3/src/renderer/mod.rs
(API surface), rend3/src/renderer/eval.rs (instruction drain + manager
evaluation in dependency order). Scene state lives in host numpy inside the
managers and is mirrored to torch tensors on the renderer's `device` on
evaluation; the frame itself is rendered stage by stage in routine/base.py.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..types import (
    Camera,
    DirectionalLight,
    Handedness,
    Mesh,
    Object,
    PointLight,
    RawResourceHandle,
    ResourceHandle,
    Skeleton,
    Texture,
)
from .instruction import InstructionKind, InstructionStreamPair
from .managers.alloc import HandleAllocator
from .managers.camera import CameraState
from .managers.directional import DirectionalLightManager
from .managers.material import MaterialManager
from .managers.mesh import MeshManager
from .managers.object import ObjectManager
from .managers.point import PointLightManager
from .managers.skeleton import SkeletonManager
from .managers.texture import TextureManager

__all__ = ["Renderer", "InstructionEvaluationOutput"]

# The instructions applied under the span objects::evaluate.
_OBJECT_KINDS = frozenset((
    InstructionKind.ADD_OBJECT, InstructionKind.DUPLICATE_OBJECT, InstructionKind.SET_OBJECT_TRANSFORM,
    InstructionKind.DELETE_OBJECT,
))


@dataclass
class InstructionEvaluationOutput:
    """Everything the frame program needs from this frame's evaluation
    (reference: graph/graph.rs:30-37 InstructionEvaluationOutput)."""

    shadow_atlas_extent: Tuple[int, int]
    shadow_plan: tuple            # ((light_idx, (ox, oy), size), ...)
    shadow_cameras: Dict[int, CameraState]
    dir_light_arrays: dict
    point_light_arrays: dict
    mesh_buffer: object           # GeometryArrays (device)


class GraphStorage:
    """Renderer-lifetime typed storage for cross-frame routine state
    (reference: rend3/src/managers/graph_storage.rs)."""

    def __init__(self):
        self._data: Dict[int, Any] = {}
        self._next = 0

    def add(self, value: Any) -> int:
        idx = self._next
        self._next += 1
        self._data[idx] = value
        return idx

    def get(self, idx: int) -> Any:
        return self._data[idx]

    def set(self, idx: int, value: Any) -> None:
        self._data[idx] = value

    def remove(self, idx: int) -> None:
        self._data.pop(idx, None)


def _resolve_device(device, owner: str = "Renderer") -> torch.device:
    """One device per renderer, the card unless the caller asks for "cpu".
    A CUDA device needs a card: there is no CPU fall-back, so a missing card
    raises here instead of rendering slowly. `owner` names the caller in
    the error. A renderer keeps one device, as JAX's does: a frame is split
    across devices by rend3_tpu_torch.parallel.tiles."""
    if isinstance(device, (list, tuple)):
        raise NotImplementedError(
            f"{owner} keeps one device; render row bands across devices with "
            "rend3_tpu_torch.parallel.tiles (device_mesh, build_tiled_frame_callable)"
        )
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{owner}(device='cuda') needs a CUDA device; none is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


class Renderer:
    def __init__(
        self,
        handedness: Handedness = Handedness.LEFT,
        aspect_ratio: Optional[float] = None,
        device="cuda",
    ):
        self.device = _resolve_device(device)
        self.handedness = handedness
        self.instructions = InstructionStreamPair()
        self.lock = threading.Lock()  # guards evaluation + managers

        self.mesh_manager = MeshManager(self.device)
        self.skeleton_manager = SkeletonManager()
        self.d2_texture_manager = TextureManager("d2", self.device)
        self.d2c_texture_manager = TextureManager("cube", self.device)
        self.material_manager = MaterialManager(self.device)
        self.object_manager = ObjectManager()
        self.directional_light_manager = DirectionalLightManager()
        self.point_light_manager = PointLightManager()
        self.camera = CameraState(Camera(), handedness, aspect_ratio)
        self.graph_storage = GraphStorage()

        self._alloc = {
            "mesh": HandleAllocator("mesh"),
            "skeleton": HandleAllocator("skeleton"),
            "texture2d": HandleAllocator("texture2d"),
            "texturecube": HandleAllocator("texturecube"),
            "material": HandleAllocator("material"),
            # Objects are reclaimed one frame late for temporal culling
            # (reference: handle_alloc.rs:22-29).
            "object": HandleAllocator("object", delayed_reclaim=True),
            "dirlight": HandleAllocator("dirlight"),
            "pointlight": HandleAllocator("pointlight"),
        }

    # -- handles --------------------------------------------------------------

    def _handle(self, kind: str, delete_kind: InstructionKind) -> ResourceHandle:
        idx = self._alloc[kind].allocate()
        raw = RawResourceHandle(idx, kind)

        def destroy(r: RawResourceHandle) -> None:
            self.instructions.push(delete_kind, r)

        return ResourceHandle(raw, destroy)

    # -- resource API (reference: renderer/mod.rs:126-424) --------------------

    def add_mesh(self, mesh: Mesh) -> ResourceHandle:
        mesh.validate()
        handle = self._handle("mesh", InstructionKind.DELETE_MESH)
        with self.lock:
            self.mesh_manager.add(handle.idx, mesh)
        return handle

    def add_skeleton(self, skeleton: Skeleton) -> ResourceHandle:
        handle = self._handle("skeleton", InstructionKind.DELETE_SKELETON)
        self.instructions.push(InstructionKind.ADD_SKELETON, (handle.idx, skeleton))
        return handle

    def add_texture_2d(self, texture: Texture) -> ResourceHandle:
        handle = self._handle("texture2d", InstructionKind.DELETE_TEXTURE_2D)
        self.instructions.push(InstructionKind.ADD_TEXTURE_2D, (handle.idx, texture))
        return handle

    def add_texture_2d_from_texture(self, tft) -> ResourceHandle:
        """New 2D texture from a mip range of an existing one
        (reference: rend3/src/renderer/mod.rs:203)."""
        handle = self._handle("texture2d", InstructionKind.DELETE_TEXTURE_2D)
        self.instructions.push(
            InstructionKind.ADD_TEXTURE_2D_FROM_TEXTURE,
            (handle.idx, tft.src.idx, tft.start_mip, tft.mip_count),
        )
        return handle

    def add_texture_cube(self, texture: Texture) -> ResourceHandle:
        handle = self._handle("texturecube", InstructionKind.DELETE_TEXTURE_CUBE)
        self.instructions.push(InstructionKind.ADD_TEXTURE_CUBE, (handle.idx, texture))
        return handle

    def add_material(self, material) -> ResourceHandle:
        handle = self._handle("material", InstructionKind.DELETE_MATERIAL)
        self.instructions.push(InstructionKind.ADD_MATERIAL, (handle.idx, material))
        return handle

    def update_material(self, handle: ResourceHandle, material) -> None:
        self.instructions.push(InstructionKind.CHANGE_MATERIAL, (handle.idx, material))

    def add_object(self, obj: Object) -> ResourceHandle:
        handle = self._handle("object", InstructionKind.DELETE_OBJECT)
        self.instructions.push(InstructionKind.ADD_OBJECT, (handle.idx, obj))
        return handle

    def duplicate_object(
        self,
        src: ResourceHandle,
        *,
        transform=None,
        material: Optional[ResourceHandle] = None,
        mesh_kind=None,
    ) -> ResourceHandle:
        """Duplicate with optional ObjectChange overrides
        (reference: renderer/mod.rs duplicate_object + ObjectChange)."""
        handle = self._handle("object", InstructionKind.DELETE_OBJECT)
        change = {}
        if transform is not None:
            change["transform"] = np.asarray(transform, dtype=np.float32).reshape(4, 4)
        if material is not None:
            change["material"] = material
        if mesh_kind is not None:
            change["mesh_kind"] = mesh_kind
        self.instructions.push(InstructionKind.DUPLICATE_OBJECT, (src.idx, handle.idx, change))
        return handle

    def set_object_transform(self, handle: ResourceHandle, transform) -> None:
        self.instructions.push(
            InstructionKind.SET_OBJECT_TRANSFORM,
            (handle.idx, np.asarray(transform, dtype=np.float32).reshape(4, 4)),
        )

    def set_skeleton_joint_matrices(self, handle: ResourceHandle, joint_matrices) -> None:
        self.instructions.push(
            InstructionKind.SET_SKELETON_JOINT_DELTAS,
            (handle.idx, np.asarray(joint_matrices, dtype=np.float32).reshape(-1, 4, 4)),
        )

    def set_skeleton_joint_transforms(
        self, handle: ResourceHandle, joint_global_transforms, inverse_bind_matrices
    ) -> None:
        """Set joints from global transforms + inverse bind matrices
        (reference: rend3/src/renderer/mod.rs:314-323: matrices =
        global_transform * inverse_bind)."""
        g = np.asarray(joint_global_transforms, dtype=np.float32).reshape(-1, 4, 4)
        ib = np.asarray(inverse_bind_matrices, dtype=np.float32).reshape(-1, 4, 4)
        self.set_skeleton_joint_matrices(handle, g @ ib)

    def add_directional_light(self, light: DirectionalLight) -> ResourceHandle:
        handle = self._handle("dirlight", InstructionKind.DELETE_DIRECTIONAL_LIGHT)
        self.instructions.push(InstructionKind.ADD_DIRECTIONAL_LIGHT, (handle.idx, light))
        return handle

    def update_directional_light(self, handle: ResourceHandle, **changes) -> None:
        self.instructions.push(InstructionKind.CHANGE_DIRECTIONAL_LIGHT, (handle.idx, changes))

    def add_point_light(self, light: PointLight) -> ResourceHandle:
        handle = self._handle("pointlight", InstructionKind.DELETE_POINT_LIGHT)
        self.instructions.push(InstructionKind.ADD_POINT_LIGHT, (handle.idx, light))
        return handle

    def update_point_light(self, handle: ResourceHandle, **changes) -> None:
        self.instructions.push(InstructionKind.CHANGE_POINT_LIGHT, (handle.idx, changes))

    def set_aspect_ratio(self, ratio: float) -> None:
        self.instructions.push(InstructionKind.SET_ASPECT_RATIO, ratio)

    def set_camera_data(self, camera: Camera) -> None:
        self.instructions.push(InstructionKind.SET_CAMERA_DATA, camera)

    # -- frame ----------------------------------------------------------------

    def swap_instruction_buffers(self) -> None:
        from ..utils.profiling import scope

        with scope("Renderer::swap_instruction_buffers"):
            self.instructions.swap()

    def evaluate_instructions(self) -> InstructionEvaluationOutput:
        from ..utils.profiling import scope

        with scope("Renderer::evaluate_instructions"), self.lock:
            return self._evaluate_locked()

    def _evaluate_locked(self) -> InstructionEvaluationOutput:
        from ..utils import profiling

        # Reclaim objects deleted last frame (eval.rs:14).
        reclaimed = self._alloc["object"].reclaim()
        if reclaimed:
            with profiling.scope("objects::evaluate"):
                for idx in reclaimed:
                    self.object_manager.remove(idx)

        K = InstructionKind
        drained = self.instructions.drain()
        i, moved = 0, 0
        while i < len(drained):
            if drained[i].kind in _OBJECT_KINDS:
                # One span per run of object instructions: one a frame where
                # the application sends its object changes together.
                with profiling.scope("objects::evaluate"):
                    i, n = self._apply_objects(drained, i)
                moved += n
                continue
            kind, p = drained[i].kind, drained[i].payload
            i += 1
            if kind == K.ADD_SKELETON:
                self.skeleton_manager.add(p[0], p[1], self.mesh_manager)
            elif kind == K.ADD_TEXTURE_2D:
                self.d2_texture_manager.add(p[0], p[1])
            elif kind == K.ADD_TEXTURE_2D_FROM_TEXTURE:
                self.d2_texture_manager.add_from(p[0], p[1], p[2], p[3])
            elif kind == K.ADD_TEXTURE_CUBE:
                self.d2c_texture_manager.add(p[0], p[1])
            elif kind == K.ADD_MATERIAL:
                self.material_manager.add(p[0], p[1], self.d2_texture_manager)
            elif kind == K.CHANGE_MATERIAL:
                self.material_manager.update(p[0], p[1], self.d2_texture_manager)
            elif kind in (K.SET_SKELETON_JOINT_MATRICES, K.SET_SKELETON_JOINT_DELTAS):
                self.skeleton_manager.set_joint_matrices(p[0], p[1])
            elif kind == K.ADD_DIRECTIONAL_LIGHT:
                self.directional_light_manager.add(p[0], p[1])
            elif kind == K.CHANGE_DIRECTIONAL_LIGHT:
                self.directional_light_manager.update(p[0], **p[1])
            elif kind == K.ADD_POINT_LIGHT:
                self.point_light_manager.add(p[0], p[1])
            elif kind == K.CHANGE_POINT_LIGHT:
                self.point_light_manager.update(p[0], **p[1])
            elif kind == K.SET_ASPECT_RATIO:
                self.camera.set_aspect_ratio(p)
            elif kind == K.SET_CAMERA_DATA:
                self.camera.set_data(p)
            elif kind == K.DELETE_MESH:
                self.mesh_manager.remove(p.idx)
                self._alloc["mesh"].deallocate(p.idx)
            elif kind == K.DELETE_SKELETON:
                self.skeleton_manager.remove(p.idx, self.mesh_manager)
                self._alloc["skeleton"].deallocate(p.idx)
            elif kind == K.DELETE_TEXTURE_2D:
                self.d2_texture_manager.remove(p.idx)
                self._alloc["texture2d"].deallocate(p.idx)
            elif kind == K.DELETE_TEXTURE_CUBE:
                self.d2c_texture_manager.remove(p.idx)
                self._alloc["texturecube"].deallocate(p.idx)
            elif kind == K.DELETE_MATERIAL:
                self.material_manager.remove(p.idx)
                self._alloc["material"].deallocate(p.idx)
            elif kind == K.DELETE_DIRECTIONAL_LIGHT:
                self.directional_light_manager.remove(p.idx)
                self._alloc["dirlight"].deallocate(p.idx)
            elif kind == K.DELETE_POINT_LIGHT:
                self.point_light_manager.remove(p.idx)
                self._alloc["pointlight"].deallocate(p.idx)
            else:  # pragma: no cover
                raise AssertionError(f"unhandled instruction {kind}")
        profiling.count("objects.transforms", moved)

        # Managers evaluate in dependency order (eval.rs:158-184).
        mesh_buffer = self.mesh_manager.evaluate()
        extent, plan, cameras, dir_arrays = self.directional_light_manager.evaluate(self.camera)
        point_arrays = self.point_light_manager.evaluate()

        return InstructionEvaluationOutput(
            shadow_atlas_extent=extent,
            shadow_plan=tuple((li, tuple(off), sz) for (li, off, sz) in plan),
            shadow_cameras=cameras,
            dir_light_arrays=dir_arrays,
            point_light_arrays=point_arrays,
            mesh_buffer=mesh_buffer,
        )

    def _apply_objects(self, drained: list, i: int) -> Tuple[int, int]:
        """Applies the run of object instructions (add, duplicate, transform,
        delete) that begins at drained[i]: (the index after the run, the
        transforms applied)."""
        K = InstructionKind
        om = self.object_manager
        moved = 0
        while i < len(drained):
            kind, p = drained[i].kind, drained[i].payload
            if kind is K.SET_OBJECT_TRANSFORM:
                om.set_transform(p[0], p[1])
                moved += 1
            elif kind is K.ADD_OBJECT:
                om.add(p[0], p[1], self.mesh_manager, self.material_manager, self.skeleton_manager)
            elif kind is K.DUPLICATE_OBJECT:
                src_obj = om.duplicate(p[0])
                change = p[2] if len(p) > 2 else {}
                new_obj = Object(
                    mesh_kind=change.get("mesh_kind", src_obj.mesh_kind),
                    material=change.get("material", src_obj.material),
                    transform=change.get("transform", src_obj.transform),
                )
                om.add(p[1], new_obj, self.mesh_manager, self.material_manager, self.skeleton_manager)
            elif kind is K.DELETE_OBJECT:
                # Disable now; slot reclaimed at the top of next frame.
                om.disable(p.idx)
                self._alloc["object"].deallocate(p.idx)
            else:
                break
            i += 1
        return i, moved
