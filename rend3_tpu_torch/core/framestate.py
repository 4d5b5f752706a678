"""Device-resident frame state.

Counterpart of rend3_tpu/core/framestate.py: every manager owns a slice of
the frame's device tables, held here as torch tensors on the renderer's
device. The tables are sized from the scene's real counts; nothing is padded
to a static capacity because nothing is compiled per shape.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["GeometryArrays", "ATTR_ORDER"]

# Attribute order for the per-object base-offset table (matches the
# reference's vertex_attribute_start_offsets idea,
# rend3/src/managers/object.rs:236-300).
ATTR_ORDER = ("position", "normal", "tangent", "texture_coords_0", "texture_coords_1", "color_0")


class GeometryArrays(NamedTuple):
    """The mesh megabuffer: one dense arena per vertex attribute
    (reference: rend3/src/managers/mesh.rs single megabuffer)."""

    position: torch.Tensor  # (V, 3) f32
    normal: torch.Tensor    # (V, 3) f32
    tangent: torch.Tensor   # (V, 3) f32
    uv0: torch.Tensor       # (V, 2) f32
    uv1: torch.Tensor       # (V, 2) f32
    color0: torch.Tensor    # (V, 4) f32
