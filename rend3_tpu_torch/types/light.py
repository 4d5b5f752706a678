"""Light types (reference: rend3-types/src/lib.rs changeable_struct lights)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


def _vec3(v) -> np.ndarray:
    return np.broadcast_to(np.asarray(v, dtype=np.float32), (3,)).copy()


@dataclass
class DirectionalLight:
    """Sun-style light with a square shadow map.

    ``resolution`` must be a power of two (shadow atlas quadtree packing);
    ``distance`` is the side length of the orthographic shadow volume
    (reference: rend3/src/managers/directional/shadow_camera.rs:6-33).
    """

    color: np.ndarray = field(default_factory=lambda: np.ones(3, dtype=np.float32))
    intensity: float = 1.0
    direction: np.ndarray = field(default_factory=lambda: np.array([0.0, -1.0, 0.0], dtype=np.float32))
    distance: float = 50.0
    resolution: int = 512

    def __post_init__(self):
        self.color = _vec3(self.color)
        self.direction = _vec3(self.direction)

    def update_from_changes(self, **changes) -> None:
        for k, v in changes.items():
            if v is None:
                continue
            if k in ("color", "direction"):
                v = _vec3(v)
            setattr(self, k, v)


@dataclass
class PointLight:
    """Omni light with smooth radius falloff; no shadows (reference parity:
    rend3/src/managers/point.rs, shadow warning rend3/src/renderer/mod.rs:353-355)."""

    position: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=np.float32))
    color: np.ndarray = field(default_factory=lambda: np.ones(3, dtype=np.float32))
    radius: float = 10.0
    intensity: float = 1.0

    def __post_init__(self):
        self.position = _vec3(self.position)
        self.color = _vec3(self.color)

    def update_from_changes(self, **changes) -> None:
        for k, v in changes.items():
            if v is None:
                continue
            if k in ("color", "position"):
                v = _vec3(v)
            setattr(self, k, v)
