"""Material-archetype shading routines: the registration seam.

Port of rend3_tpu/routine/registry.py. Reference: rend3 is generic over
materials; a per-archetype vtable (rend3/src/managers/material.rs:43-61)
lets an application register a draw routine for a new material type, and
objects of an archetype with no registered routine do not draw.

The deferred frame rasterizes every registered archetype's objects into the
shared G-buffer, whose material channel carries a global slot (the
PbrMaterial table first, then each registered archetype's table after it,
in archetype-name order); after the built-in PBR lighting each routine
shades the pixels whose slot falls in its archetype's range
(`ops/lighting.py apply_material_routines`). Registration:

    graph.register_routine(MaterialRoutine(MyMaterial, shade=my_shade_fn))

A routine works on torch tensors on the renderer's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

__all__ = ["GBufferPixels", "MaterialRoutine", "unlit_routine"]


class GBufferPixels(NamedTuple):
    """Perspective-corrected per-pixel surface attributes handed to a
    shading routine (the resolved vertex-stage outputs of opaque.wgsl
    vs_main), flattened to N pixels."""

    view_pos: torch.Tensor  # (N, 3) view-space position
    nrm: torch.Tensor       # (N, 3) view-space normal (unnormalized lerp)
    tan: torch.Tensor       # (N, 3) view-space tangent
    uv0: torch.Tensor       # (N, 2)
    uv1: torch.Tensor       # (N, 2)
    vcol: torch.Tensor      # (N, 4) vertex color
    hit: torch.Tensor       # (N,) bool


@dataclass(frozen=True)
class MaterialRoutine:
    """Shading routine for one material archetype.

    shade(pixels: GBufferPixels, mdata: (N, D), mflags: (N,) int32,
          dir_lights, point_lights, shadow_values: (L, N) or None,
          uniforms) -> (N, 4) linear HDR rgba.

    mdata / mflags are the archetype's own table rows (material.to_data()
    / to_flags()) gathered per pixel.

    transparency selects the draw pipeline, like the reference's
    ForwardRoutine depth / cutout / blend variants built for every
    archetype (rend3-routine/src/forward.rs:62-83):
      * "opaque": the deferred opaque path (default);
      * "cutout": objects render through the cutout depth-peel loop; the
        per-pixel alpha test calls `alpha(pixels, mdata, mflags) -> (N,)`
        against `alpha_cutoff` (the depth.wgsl discard);
      * "blend": the material's sorting() must be REQUIREMENT so its
        objects enter the ordered blend peels; each peel's pixels are
        shaded by `shade` (alpha = rgba[:, 3]).
    """

    material_cls: type
    shade: Callable
    transparency: str = "opaque"
    alpha: Callable = None
    alpha_cutoff: float = 0.5

    def __post_init__(self):
        if self.transparency not in ("opaque", "cutout", "blend"):
            raise ValueError(f"transparency must be opaque, cutout or blend, got {self.transparency!r}")
        if self.transparency == "cutout" and self.alpha is None:
            raise ValueError("cutout routines need an alpha callback")

    @property
    def archetype(self) -> str:
        return self.material_cls.__name__


def unlit_routine(material_cls) -> MaterialRoutine:
    """A minimal routine: rgba = the first 4 floats of the material data
    block, vertex-color modulated. Useful as a template and for tests."""

    def shade(pixels, mdata, mflags, dir_lights, point_lights, shadow_values, uniforms):
        return mdata[:, :4] * pixels.vcol

    return MaterialRoutine(material_cls, shade)
