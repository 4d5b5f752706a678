"""Vocabulary types for the TPU renderer (counterpart of rend3-types)."""

from .attribute import (  # noqa: F401
    ALL_ATTRIBUTES,
    ATTRIBUTE_BY_NAME,
    COLOR_0,
    COLOR_1,
    JOINT_INDICES,
    JOINT_WEIGHTS,
    NORMAL,
    POSITION,
    TANGENT,
    TEXTURE_COORDINATES_0,
    TEXTURE_COORDINATES_1,
    VertexAttribute,
)
from .camera import Camera, CameraProjection, Orthographic, Perspective, RawProjection, compute_projection_matrix  # noqa: F401
from .handle import RawResourceHandle, ResourceHandle  # noqa: F401
from .light import DirectionalLight, PointLight  # noqa: F401
from .material import Material, Sorting, SortingOrder, SortingReason  # noqa: F401
from .mesh import MAX_INDEX_COUNT, MAX_VERTEX_COUNT, Handedness, Mesh, MeshBuilder, MeshValidationError  # noqa: F401
from .object import AnimatedMeshKind, Object, ObjectMeshKind, Skeleton, StaticMeshKind  # noqa: F401
from .texture import MipmapCount, MipmapSource, SampleCount, Texture, TextureFormat, TextureFromTexture  # noqa: F401
