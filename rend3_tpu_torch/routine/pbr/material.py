"""PbrMaterial — the full PBR material of the reference
(rend3-routine/src/pbr/material.rs): albedo / normal / AoMR / clearcoat /
emissive / reflectance / anisotropy components with per-component texture-vs-
value packing flags, transparency modes, unlit, nearest/linear sampling.

The POD data block layout matches ops/shade.py (PBR_* offsets), the flag bits
match MaterialFlags (material.rs:11-31) exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional, Sequence, Union

import numpy as np

from ...ops.shade import (
    MF,
    PBR_ALBEDO,
    PBR_ALPHA_CUTOUT,
    PBR_AMBIENT_OCCLUSION,
    PBR_ANISOTROPY,
    PBR_CLEAR_COAT,
    PBR_CLEAR_COAT_ROUGHNESS,
    PBR_DATA_SIZE,
    PBR_EMISSIVE,
    PBR_METALLIC,
    PBR_REFLECTANCE,
    PBR_ROUGHNESS,
    PBR_UVT0,
    PBR_UVT1,
)
from ...types import attribute as attr
from ...types.material import Sorting

__all__ = [
    "AlbedoComponent",
    "NormalTexture",
    "AoMRTextures",
    "ClearcoatTextures",
    "MaterialComponent",
    "Transparency",
    "TransparencyType",
    "SampleType",
    "PbrMaterial",
]


class TransparencyType(Enum):
    OPAQUE = 0
    CUTOUT = 1
    BLEND = 2


@dataclass
class Transparency:
    kind: TransparencyType = TransparencyType.OPAQUE
    cutout: float = 0.0

    @staticmethod
    def opaque() -> "Transparency":
        return Transparency(TransparencyType.OPAQUE)

    @staticmethod
    def cutout_at(cutout: float) -> "Transparency":
        return Transparency(TransparencyType.CUTOUT, cutout)

    @staticmethod
    def blend() -> "Transparency":
        return Transparency(TransparencyType.BLEND)


class SampleType(Enum):
    NEAREST = 0
    LINEAR = 1


@dataclass
class AlbedoComponent:
    """reference: pbr/material.rs AlbedoComponent (8 variants collapsed to
    orthogonal fields: value x vertex(srgb) x texture)."""

    value: Optional[np.ndarray] = None            # Vec4
    texture: Optional[object] = None              # Texture2DHandle
    vertex: bool = False
    vertex_srgb: bool = False
    active: bool = True                           # False == AlbedoComponent::None

    @staticmethod
    def none() -> "AlbedoComponent":
        return AlbedoComponent(active=False)

    @staticmethod
    def new_value(v) -> "AlbedoComponent":
        return AlbedoComponent(value=np.asarray(v, dtype=np.float32))

    @staticmethod
    def new_texture(t) -> "AlbedoComponent":
        return AlbedoComponent(texture=t)

    def to_value(self) -> np.ndarray:
        return np.ones(4, np.float32) if self.value is None else np.asarray(self.value, np.float32)

    def to_flags(self) -> int:
        if not self.active:
            return 0
        f = MF.ALBEDO_ACTIVE
        if self.vertex:
            f |= MF.ALBEDO_BLEND
            if self.vertex_srgb:
                f |= MF.ALBEDO_VERTEX_SRGB
        return f


@dataclass
class NormalTexture:
    """reference: NormalTexture {None, Tricomponent, Bicomponent, BicomponentSwizzled}."""

    texture: Optional[object] = None
    bicomponent: bool = False
    swizzled: bool = False
    y_down: bool = False

    def to_flags(self) -> int:
        f = 0
        if self.bicomponent:
            f |= MF.BICOMPONENT_NORMAL
        if self.swizzled:
            f |= MF.BICOMPONENT_NORMAL | MF.SWIZZLED_NORMAL
        if self.y_down:
            f |= MF.YDOWN_NORMAL
        return f


@dataclass
class AoMRTextures:
    """reference: AoMRTextures {None, Combined, SwizzledSplit, Split, BWSplit}."""

    mode: str = "none"  # none | combined | split | swizzled_split | bw_split
    aomr_texture: Optional[object] = None       # combined / split modes' mr texture
    ao_texture: Optional[object] = None
    metallic_texture: Optional[object] = None   # bw_split only
    roughness_texture: Optional[object] = None  # bw_split only

    def to_roughness_texture(self):
        if self.mode in ("combined", "split", "swizzled_split"):
            return self.aomr_texture
        if self.mode == "bw_split":
            return self.roughness_texture
        return None

    def to_metallic_texture(self):
        return self.metallic_texture if self.mode == "bw_split" else None

    def to_ao_texture(self):
        if self.mode in ("split", "swizzled_split", "bw_split"):
            return self.ao_texture
        return None

    def to_flags(self) -> int:
        return {
            # Reference maps None -> AOMR_COMBINED so the shader bails early.
            "none": MF.AOMR_COMBINED,
            "combined": MF.AOMR_COMBINED,
            "split": MF.AOMR_SPLIT,
            "swizzled_split": MF.AOMR_SWIZZLED_SPLIT,
            "bw_split": MF.AOMR_BW_SPLIT,
        }[self.mode]


@dataclass
class ClearcoatTextures:
    mode: str = "none"  # none | gltf_combined | gltf_split | bw_split
    clearcoat_texture: Optional[object] = None
    clearcoat_roughness_texture: Optional[object] = None

    def to_clearcoat_texture(self):
        return self.clearcoat_texture if self.mode != "none" else None

    def to_clearcoat_roughness_texture(self):
        if self.mode in ("gltf_split", "bw_split"):
            return self.clearcoat_roughness_texture
        return None

    def to_flags(self) -> int:
        return {
            "none": MF.CC_GLTF_COMBINED,  # reference: shader checks cc texture then bails
            "gltf_combined": MF.CC_GLTF_COMBINED,
            "gltf_split": MF.CC_GLTF_SPLIT,
            "bw_split": MF.CC_BW_SPLIT,
        }[self.mode]


@dataclass
class MaterialComponent:
    """Value and/or texture scalar/vector component."""

    value: Optional[object] = None
    texture: Optional[object] = None

    def to_value(self, default):
        return default if self.value is None else self.value


@dataclass
class PbrMaterial:
    albedo: AlbedoComponent = field(default_factory=AlbedoComponent.none)
    transparency: Transparency = field(default_factory=Transparency.opaque)
    normal: NormalTexture = field(default_factory=NormalTexture)
    aomr_textures: AoMRTextures = field(default_factory=AoMRTextures)
    ao_factor: Optional[float] = None
    metallic_factor: Optional[float] = None
    roughness_factor: Optional[float] = None
    clearcoat_textures: ClearcoatTextures = field(default_factory=ClearcoatTextures)
    clearcoat_factor: Optional[float] = None
    clearcoat_roughness_factor: Optional[float] = None
    emissive: MaterialComponent = field(default_factory=MaterialComponent)
    reflectance: MaterialComponent = field(default_factory=MaterialComponent)
    anisotropy: MaterialComponent = field(default_factory=MaterialComponent)
    uv_transform0: np.ndarray = None  # type: ignore[assignment]
    uv_transform1: np.ndarray = None  # type: ignore[assignment]
    unlit: bool = False
    sample_type: SampleType = SampleType.LINEAR

    def __post_init__(self):
        if self.uv_transform0 is None:
            self.uv_transform0 = np.eye(3, dtype=np.float32)
        if self.uv_transform1 is None:
            self.uv_transform1 = np.eye(3, dtype=np.float32)

    # -- Material protocol ----------------------------------------------------

    @classmethod
    def required_attributes(cls) -> Sequence:
        return (attr.POSITION,)

    @classmethod
    def supported_attributes(cls) -> Sequence:
        return (
            attr.POSITION,
            attr.NORMAL,
            attr.TANGENT,
            attr.TEXTURE_COORDINATES_0,
            attr.TEXTURE_COORDINATES_1,
            attr.COLOR_0,
        )

    @classmethod
    def data_size(cls) -> int:
        return PBR_DATA_SIZE

    @classmethod
    def texture_count(cls) -> int:
        return 10

    def key(self) -> int:
        return self.transparency.kind.value

    def sorting(self) -> Sorting:
        if self.transparency.kind == TransparencyType.BLEND:
            return Sorting.blending()
        return Sorting.opaque()

    def to_textures(self) -> List[Optional[object]]:
        return [
            self.albedo.texture,
            self.normal.texture,
            self.aomr_textures.to_roughness_texture(),
            self.aomr_textures.to_metallic_texture(),
            self.reflectance.texture,
            self.clearcoat_textures.to_clearcoat_texture(),
            self.clearcoat_textures.to_clearcoat_roughness_texture(),
            self.emissive.texture,
            self.anisotropy.texture,
            self.aomr_textures.to_ao_texture(),
        ]

    def to_flags(self) -> int:
        f = self.albedo.to_flags()
        f |= self.normal.to_flags()
        f |= self.aomr_textures.to_flags()
        f |= self.clearcoat_textures.to_flags()
        if self.unlit:
            f |= MF.UNLIT
        if self.sample_type == SampleType.NEAREST:
            f |= MF.NEAREST
        return f

    def to_data(self) -> np.ndarray:
        d = np.zeros(PBR_DATA_SIZE, dtype=np.float32)
        d[PBR_UVT0 : PBR_UVT0 + 9] = np.asarray(self.uv_transform0, np.float32).reshape(9)
        d[PBR_UVT1 : PBR_UVT1 + 9] = np.asarray(self.uv_transform1, np.float32).reshape(9)
        d[PBR_ALBEDO : PBR_ALBEDO + 4] = self.albedo.to_value()
        d[PBR_EMISSIVE : PBR_EMISSIVE + 3] = np.broadcast_to(
            np.asarray(self.emissive.to_value(np.zeros(3)), np.float32), (3,)
        )
        # Reference defaults (ShaderMaterial::from_material): roughness 0,
        # metallic 0, reflectance 0.5, ao 1.
        d[PBR_ROUGHNESS] = self.roughness_factor if self.roughness_factor is not None else 0.0
        d[PBR_METALLIC] = self.metallic_factor if self.metallic_factor is not None else 0.0
        d[PBR_REFLECTANCE] = self.reflectance.to_value(0.5)
        d[PBR_CLEAR_COAT] = self.clearcoat_factor if self.clearcoat_factor is not None else 0.0
        d[PBR_CLEAR_COAT_ROUGHNESS] = (
            self.clearcoat_roughness_factor if self.clearcoat_roughness_factor is not None else 0.0
        )
        d[PBR_ANISOTROPY] = self.anisotropy.to_value(0.0)
        d[PBR_AMBIENT_OCCLUSION] = self.ao_factor if self.ao_factor is not None else 1.0
        d[PBR_ALPHA_CUTOUT] = (
            self.transparency.cutout if self.transparency.kind == TransparencyType.CUTOUT else 0.0
        )
        return d
