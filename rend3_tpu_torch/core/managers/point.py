"""PointLightManager (reference: rend3/src/managers/point.rs)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from ...types.light import PointLight

__all__ = ["PointLightManager"]


class PointLightManager:
    def __init__(self):
        self.data: Dict[int, PointLight] = {}

    def add(self, idx: int, light: PointLight) -> None:
        self.data[idx] = light

    def update(self, idx: int, **changes) -> None:
        self.data[idx].update_from_changes(**changes)

    def remove(self, idx: int) -> None:
        self.data.pop(idx)

    def evaluate(self) -> dict:
        n = len(self.data)
        cap = max(1, n)
        position = np.zeros((cap, 3), dtype=np.float32)
        color = np.zeros((cap, 3), dtype=np.float32)
        radius = np.ones(cap, dtype=np.float32)
        mask = np.zeros(cap, dtype=bool)
        for i, (idx, l) in enumerate(sorted(self.data.items())):
            position[i] = l.position
            color[i] = l.color * np.float32(l.intensity)
            radius[i] = l.radius
            mask[i] = True
        return dict(position=position, color=color, radius=radius, mask=mask)
