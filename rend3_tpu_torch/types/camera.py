"""Camera projection types (reference: rend3-types/src/lib.rs:1076-1103)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Union

import numpy as np

from ..utils import math as m3
from .mesh import Handedness

__all__ = ["CameraProjection", "Orthographic", "Perspective", "RawProjection", "Camera"]


@dataclass
class Orthographic:
    """Box-shaped orthographic projection; ``size`` is the full xyz extent."""

    size: np.ndarray  # (3,) full extents

    def __post_init__(self):
        self.size = np.broadcast_to(np.asarray(self.size, dtype=np.float32), (3,)).copy()


@dataclass
class Perspective:
    """Infinite reversed-Z perspective (vfov in degrees)."""

    vfov: float = 60.0
    near: float = 0.1


@dataclass
class RawProjection:
    matrix: np.ndarray

    def __post_init__(self):
        self.matrix = np.asarray(self.matrix, dtype=np.float32).reshape(4, 4)


CameraProjection = Union[Orthographic, Perspective, RawProjection]


@dataclass
class Camera:
    projection: CameraProjection = field(default_factory=Perspective)
    view: np.ndarray = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.view is None:
            self.view = m3.IDENTITY.copy()
        self.view = np.asarray(self.view, dtype=np.float32).reshape(4, 4)


def compute_projection_matrix(camera: Camera, handedness: Handedness, aspect_ratio: float) -> np.ndarray:
    """Reference: rend3/src/managers/camera.rs:88-107.

    Orthographic maps near=+half.z, far=-half.z (reverse-Z ortho box).
    """
    proj = camera.projection
    if isinstance(proj, Orthographic):
        half = proj.size * 0.5
        if handedness == Handedness.LEFT:
            return m3.orthographic_lh(-half[0], half[0], -half[1], half[1], half[2], -half[2])
        return m3.orthographic_rh(-half[0], half[0], -half[1], half[1], half[2], -half[2])
    if isinstance(proj, Perspective):
        vfov_rad = float(np.deg2rad(proj.vfov))
        if handedness == Handedness.LEFT:
            return m3.perspective_infinite_reverse_lh(vfov_rad, aspect_ratio, proj.near)
        return m3.perspective_infinite_reverse_rh(vfov_rad, aspect_ratio, proj.near)
    if isinstance(proj, RawProjection):
        return proj.matrix
    raise TypeError(f"unknown projection {proj!r}")
