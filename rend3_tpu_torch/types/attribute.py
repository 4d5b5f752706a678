"""Vertex attribute registry.

TPU-native counterpart of the reference's globally-registered typed vertex
attributes (reference: rend3-types/src/attribute.rs:1-135). Each attribute
names a SoA arena in the mesh megabuffer; `numpy_dtype`/`components` replace
the reference's WGSL metadata (`shader_extract_fn`, `shader_type`) because on
TPU every attribute is just a dense (capacity, components) array gathered by
vertex index.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "VertexAttribute",
    "POSITION",
    "NORMAL",
    "TANGENT",
    "TEXTURE_COORDINATES_0",
    "TEXTURE_COORDINATES_1",
    "COLOR_0",
    "COLOR_1",
    "JOINT_INDICES",
    "JOINT_WEIGHTS",
    "ALL_ATTRIBUTES",
    "ATTRIBUTE_BY_NAME",
]


@dataclass(frozen=True)
class VertexAttribute:
    """A typed, named per-vertex attribute.

    ``default`` is the fill value used when a mesh lacks the attribute but a
    material supports it (matching the reference shaders' guarded defaults,
    rend3/src/shader.rs:240-320).
    """

    name: str
    components: int
    numpy_dtype: np.dtype
    default: tuple

    def __repr__(self) -> str:  # pragma: no cover
        return f"VertexAttribute({self.name})"


F32 = np.dtype(np.float32)
U16 = np.dtype(np.uint16)

POSITION = VertexAttribute("position", 3, F32, (0.0, 0.0, 0.0))
NORMAL = VertexAttribute("normal", 3, F32, (0.0, 0.0, 0.0))
TANGENT = VertexAttribute("tangent", 3, F32, (0.0, 0.0, 0.0))
TEXTURE_COORDINATES_0 = VertexAttribute("texture_coords_0", 2, F32, (0.0, 0.0))
TEXTURE_COORDINATES_1 = VertexAttribute("texture_coords_1", 2, F32, (0.0, 0.0))
# Reference stores color as unorm8x4; we keep float for TPU friendliness. The
# default is opaque white (rend3 shader default for color_0 is vec4(1.0)).
COLOR_0 = VertexAttribute("color_0", 4, F32, (1.0, 1.0, 1.0, 1.0))
COLOR_1 = VertexAttribute("color_1", 4, F32, (1.0, 1.0, 1.0, 1.0))
JOINT_INDICES = VertexAttribute("joint_indices", 4, U16, (0, 0, 0, 0))
JOINT_WEIGHTS = VertexAttribute("joint_weights", 4, F32, (0.0, 0.0, 0.0, 0.0))

ALL_ATTRIBUTES = (
    POSITION,
    NORMAL,
    TANGENT,
    TEXTURE_COORDINATES_0,
    TEXTURE_COORDINATES_1,
    COLOR_0,
    COLOR_1,
    JOINT_INDICES,
    JOINT_WEIGHTS,
)

ATTRIBUTE_BY_NAME = {a.name: a for a in ALL_ATTRIBUTES}
