"""CameraState (reference: rend3/src/managers/camera.rs)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ...types.camera import Camera, compute_projection_matrix
from ...types.mesh import Handedness
from ...utils.math import Frustum

__all__ = ["CameraState"]


class CameraState:
    def __init__(self, data: Camera, handedness: Handedness, aspect_ratio: Optional[float] = None):
        self.handedness = handedness
        self.aspect_ratio = aspect_ratio if aspect_ratio is not None else 1.0
        self.set_data(data)

    def set_data(self, data: Camera) -> None:
        self.data = data
        self.proj = compute_projection_matrix(data, self.handedness, self.aspect_ratio)
        self.orig_view = data.view.copy()
        self.orig_view[:3, 3] = 0.0
        self.inv_view = np.linalg.inv(data.view).astype(np.float32)
        self.world_frustum = Frustum.from_matrix(self.proj @ data.view)

    def set_aspect_ratio(self, aspect_ratio: Optional[float]) -> None:
        self.aspect_ratio = aspect_ratio if aspect_ratio is not None else 1.0
        self.set_data(self.data)

    @property
    def view(self) -> np.ndarray:
        return self.data.view

    def view_proj(self) -> np.ndarray:
        return (self.proj @ self.data.view).astype(np.float32)

    def origin_view_proj(self) -> np.ndarray:
        return (self.proj @ self.orig_view).astype(np.float32)

    def location(self) -> np.ndarray:
        return self.inv_view[:3, 3]
