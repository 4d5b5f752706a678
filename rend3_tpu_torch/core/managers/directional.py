"""DirectionalLightManager: lights + shadow atlas.

Reference: rend3/src/managers/directional.rs — quadtree atlas packing of
per-light power-of-two shadow maps into one depth texture
(directional/shadow_alloc.rs:7-136), per-light orthographic shadow camera
snapped to the texel grid (directional/shadow_camera.rs:6-33), and a
ShaderDirectionalLight buffer {view_proj, color*intensity, direction,
inv_resolution, atlas offset/size}.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...types.camera import Camera, Orthographic
from ...types.light import DirectionalLight
from ...types.mesh import Handedness
from ...utils import math as m3
from .camera import CameraState

__all__ = ["DirectionalLightManager", "ShadowMap", "allocate_shadow_atlas", "MINIMUM_SHADOW_MAP_SIZE"]

MINIMUM_SHADOW_MAP_SIZE = 32


@dataclass
class ShadowMap:
    offset: Tuple[int, int]  # (x, y) texels
    size: int                # square side in texels
    light_idx: int


def allocate_shadow_atlas(
    maps: List[Tuple[int, int]], max_dimension: int
) -> Optional[Tuple[Tuple[int, int], List[ShadowMap]]]:
    """Quadtree atlas packer (behavioral port of shadow_alloc.rs:59-136).

    maps: [(light_idx, resolution_pow2)]; returns ((W, H), placed maps)."""
    if not maps or max_dimension == 0:
        return None

    maps = sorted(maps, key=lambda m: -m[1])
    root_size = maps[0][1]

    VACANT, LEAF, CHILDREN = 0, 1, 2
    nodes: List[list] = []  # [kind, payload]
    roots: List[int] = []

    def try_alloc(node_idx: int, order: int, light_idx: int) -> bool:
        kind, payload = nodes[node_idx]
        if kind == VACANT:
            if order == 0:
                nodes[node_idx] = [LEAF, light_idx]
                return True
            base = len(nodes)
            nodes[node_idx] = [CHILDREN, [base, base + 1, base + 2, base + 3]]
            nodes.extend([[VACANT, None] for _ in range(4)])
            return try_alloc(node_idx, order, light_idx)
        if kind == LEAF:
            return False
        if order == 0:
            return False
        return any(try_alloc(c, order - 1, light_idx) for c in payload)

    nodes.append([VACANT, None])
    roots.append(0)
    for light_idx, resolution in maps:
        order = root_size.bit_length() - resolution.bit_length()
        while not try_alloc(roots[-1], order, light_idx):
            nodes.append([VACANT, None])
            roots.append(len(nodes) - 1)

    available_columns = max(1, max_dimension // root_size)
    root_count = len(roots)
    rows_needed = int(np.ceil(root_count / available_columns))
    columns_needed = int(np.ceil(root_count / rows_needed))
    dims = (columns_needed * root_size, rows_needed * root_size)

    out: List[ShadowMap] = []
    to_visit = deque()
    for root_i, node_idx in enumerate(roots):
        ox = (root_i % columns_needed) * root_size
        oy = (root_i // columns_needed) * root_size
        to_visit.append((1, (ox, oy), node_idx))
    while to_visit:
        divisor, (ox, oy), node_idx = to_visit.popleft()
        size = root_size // divisor
        half = size // 2
        kind, payload = nodes[node_idx]
        if kind == LEAF:
            out.append(ShadowMap(offset=(ox, oy), size=size, light_idx=payload))
        elif kind == CHILDREN:
            for ci, child in enumerate(payload):
                to_visit.append((divisor * 2, (ox + half * (ci % 2), oy + half * (ci // 2)), child))
    return dims, out


def shadow_camera(light: DirectionalLight, user_camera: CameraState) -> CameraState:
    """Texel-snapped orthographic shadow camera
    (reference: directional/shadow_camera.rs:6-33)."""
    camera_location = user_camera.location()
    shadow_texel_size = light.distance / float(light.resolution)

    look_at = m3.look_at_lh if user_camera.handedness == Handedness.LEFT else m3.look_at_rh

    origin_view = look_at(np.zeros(3), light.direction, np.array([0.0, 1.0, 0.0]))
    camera_origin_view = m3.transform_point(origin_view, camera_location)

    offset = np.fmod(camera_origin_view, shadow_texel_size)
    shadow_location = camera_origin_view - offset

    inv_origin_view = np.linalg.inv(origin_view).astype(np.float32)
    new_loc = m3.transform_point(inv_origin_view, shadow_location)

    return CameraState(
        Camera(
            projection=Orthographic(size=np.full(3, light.distance, dtype=np.float32)),
            view=look_at(new_loc, new_loc + light.direction, np.array([0.0, 1.0, 0.0])),
        ),
        user_camera.handedness,
        None,
    )


MAX_ATLAS_DIMENSION = 8192


class DirectionalLightManager:
    def __init__(self):
        self.data: Dict[int, DirectionalLight] = {}

    def add(self, idx: int, light: DirectionalLight) -> None:
        self.data[idx] = light

    def update(self, idx: int, **changes) -> None:
        self.data[idx].update_from_changes(**changes)

    def remove(self, idx: int) -> None:
        self.data.pop(idx)

    def evaluate(self, user_camera: CameraState):
        """Returns (atlas_extent (w,h), shadow plan [(light_idx, offset, size)],
        shadow cameras {light_idx: CameraState}, shader arrays dict)."""
        maps = [(idx, l.resolution) for idx, l in sorted(self.data.items())]
        atlas = allocate_shadow_atlas(maps, MAX_ATLAS_DIMENSION)
        if atlas is None:
            extent = (MINIMUM_SHADOW_MAP_SIZE, MINIMUM_SHADOW_MAP_SIZE)
            placed: List[ShadowMap] = []
        else:
            (w, h), placed = atlas
            extent = (max(w, MINIMUM_SHADOW_MAP_SIZE), max(h, MINIMUM_SHADOW_MAP_SIZE))

        cameras: Dict[int, CameraState] = {}
        n = len(placed)
        cap = max(1, n)
        view_proj = np.tile(np.eye(4, dtype=np.float32), (cap, 1, 1))
        color = np.zeros((cap, 3), dtype=np.float32)
        direction = np.zeros((cap, 3), dtype=np.float32)
        inv_resolution = np.zeros((cap, 2), dtype=np.float32)
        atlas_offset = np.zeros((cap, 2), dtype=np.float32)
        atlas_size = np.zeros((cap, 2), dtype=np.float32)
        mask = np.zeros(cap, dtype=bool)
        extent_f = np.array(extent, dtype=np.float32)

        plan = []
        for i, sm in enumerate(placed):
            light = self.data[sm.light_idx]
            cam = shadow_camera(light, user_camera)
            cameras[sm.light_idx] = cam
            view_proj[i] = cam.view_proj()
            color[i] = light.color * np.float32(light.intensity)
            direction[i] = light.direction
            inv_resolution[i] = 1.0 / extent_f
            atlas_offset[i] = np.array(sm.offset, dtype=np.float32) / extent_f
            atlas_size[i] = np.float32(sm.size) / extent_f
            mask[i] = True
            plan.append((sm.light_idx, sm.offset, sm.size))

        arrays = dict(
            view_proj=view_proj,
            color=color,
            direction=direction,
            inv_resolution=inv_resolution,
            atlas_offset=atlas_offset,
            atlas_size=atlas_size,
            mask=mask,
        )
        return extent, plan, cameras, arrays
