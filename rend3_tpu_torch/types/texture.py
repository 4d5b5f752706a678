"""CPU-side texture types (reference: rend3-types/src/lib.rs:891-933)."""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Optional, Union

import numpy as np

__all__ = ["TextureFormat", "MipmapCount", "MipmapSource", "Texture", "TextureFromTexture", "SampleCount"]


class TextureFormat(Enum):
    """Subset of wgpu texture formats the renderer ingests. All device-side
    storage is linear float; *_SRGB formats are EOTF-decoded at upload."""

    RGBA8_UNORM = "rgba8unorm"
    RGBA8_UNORM_SRGB = "rgba8unorm-srgb"
    RGBA16_FLOAT = "rgba16float"
    RGBA32_FLOAT = "rgba32float"
    BGRA8_UNORM = "bgra8unorm"
    BGRA8_UNORM_SRGB = "bgra8unorm-srgb"

    @property
    def srgb(self) -> bool:
        return self in (TextureFormat.RGBA8_UNORM_SRGB, TextureFormat.BGRA8_UNORM_SRGB)

    @property
    def bgra(self) -> bool:
        return self in (TextureFormat.BGRA8_UNORM, TextureFormat.BGRA8_UNORM_SRGB)


class MipmapCount(Enum):
    MAXIMUM = "maximum"
    ONE = "one"


class MipmapSource(Enum):
    UPLOADED = "uploaded"
    GENERATED = "generated"


class SampleCount(Enum):
    """MSAA sample count (reference: rend3-types/src/lib.rs:1139-1203).
    Implemented as ordered-grid supersampling on TPU."""

    ONE = 1
    FOUR = 4


@dataclass
class Texture:
    """A 2D (or cube, size 6 layers) bitmap handed to the renderer."""

    label: str
    data: np.ndarray  # (H, W, 4) u8/f32 or (6, H, W, 4) for cube
    format: TextureFormat = TextureFormat.RGBA8_UNORM_SRGB
    mip_count: Union[MipmapCount, int] = MipmapCount.ONE
    mip_source: MipmapSource = MipmapSource.GENERATED

    def __post_init__(self):
        self.data = np.asarray(self.data)

    @property
    def size(self) -> tuple:
        return self.data.shape[-3], self.data.shape[-2]


@dataclass
class TextureFromTexture:
    """Descriptor to create a new texture as a mip-range view of another."""

    label: str
    src: object  # Texture2DHandle
    start_mip: int = 0
    mip_count: Optional[int] = None
