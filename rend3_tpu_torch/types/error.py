"""Typed renderer errors.

Behavioral port of rend3/src/renderer/error.rs:6-52 re-grounded in the TPU
runtime: adapter/limit/feature failures become backend/HBM/compile
failures. Raised instead of letting raw XLA exceptions escape the public
API surface.
"""

from __future__ import annotations

__all__ = [
    "RendererError",
    "RendererInitializationError",
    "DeviceLimitError",
    "DeviceOutOfMemoryError",
    "RenderCapacityError",
    "MeshValidationError",
    "AssetError",
]


class RendererError(Exception):
    """Base class for all typed renderer errors."""


class RendererInitializationError(RendererError):
    """No usable accelerator backend (the reference's MissingAdapter /
    RequestDeviceFailed)."""


class DeviceLimitError(RendererError):
    """A resource exceeds what the device can hold (the reference's
    LowDeviceLimit): e.g. a texture larger than the atlas can grow to."""

    def __init__(self, what: str, requested: int, limit: int):
        self.what = what
        self.requested = requested
        self.limit = limit
        super().__init__(
            f"device limit exceeded for {what}: requested {requested}, limit {limit}"
        )


class DeviceOutOfMemoryError(RendererError):
    """A device allocation failure during a frame (torch.cuda.OutOfMemoryError,
    chained as the cause), raised by BaseRenderGraph.render_frame."""


class RenderCapacityError(RendererError):
    """A per-frame adaptive capacity exceeded its hard ceiling (SMEM step
    budget, tile-list multiplier, gather pair cap). Raised instead of
    rendering a silently-wrong frame — the reference grows its culling
    buffers to the storage cap and never drops
    (rend3-routine/src/culling/suballoc.rs:164-214); where growth is
    physically bounded on TPU we fail loudly instead."""

    def __init__(self, what: str, needed: int, ceiling: int):
        self.what = what
        self.needed = needed
        self.ceiling = ceiling
        super().__init__(
            f"frame capacity ceiling exceeded for {what}: needs {needed}, "
            f"ceiling {ceiling} — the scene cannot render exactly at this "
            f"configuration (reduce geometry density or raise the ceiling)"
        )


class AssetError(RendererError):
    """Asset fetch failure (rend3-framework/src/assets.rs:8-20 AssetError);
    subclassed by the framework's file/network variants."""


# Re-export the existing mesh validation error under the typed family.
from .mesh import MeshValidationError  # noqa: E402
