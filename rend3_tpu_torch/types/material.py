"""Material protocol (reference: rend3-types/src/lib.rs:936-1058).

A material is: N optional texture handles + a POD data block (flat float32
vector here — the TPU-side material table is a dense (M, D) array) + a sort
key + a sorting mode + required/supported vertex attribute lists.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from .attribute import VertexAttribute

__all__ = ["SortingOrder", "SortingReason", "Sorting", "Material"]


class SortingOrder(Enum):
    FRONT_TO_BACK = 0
    BACK_TO_FRONT = 1


class SortingReason(Enum):
    OPTIMIZATION = 0  # draw order freely reorderable (depth tested)
    REQUIREMENT = 1   # order is semantically required (alpha blending)


@dataclass(frozen=True)
class Sorting:
    order: SortingOrder
    reason: SortingReason

    @staticmethod
    def opaque() -> "Sorting":
        return Sorting(SortingOrder.FRONT_TO_BACK, SortingReason.OPTIMIZATION)

    @staticmethod
    def blending() -> "Sorting":
        return Sorting(SortingOrder.BACK_TO_FRONT, SortingReason.REQUIREMENT)


@runtime_checkable
class Material(Protocol):
    """Anything with data/textures/key/sorting can be a material.

    Implementations are grouped into per-type archetypes by the
    MaterialManager, one dense device table per archetype
    (reference: rend3/src/managers/material.rs:43-61).
    """

    @classmethod
    def required_attributes(cls) -> Sequence[VertexAttribute]: ...

    @classmethod
    def supported_attributes(cls) -> Sequence[VertexAttribute]: ...

    @classmethod
    def data_size(cls) -> int:
        """Number of float32 words in the POD data block."""
        ...

    @classmethod
    def texture_count(cls) -> int: ...

    def key(self) -> int: ...

    def sorting(self) -> Sorting: ...

    def to_textures(self) -> List[Optional[object]]:
        """Raw Texture2D handles (or None), length == texture_count()."""
        ...

    def to_data(self) -> np.ndarray:
        """Flat float32 data block, length == data_size()."""
        ...
