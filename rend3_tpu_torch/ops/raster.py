"""Visibility-buffer types and the sample offsets.

Port of rend3_tpu/ops/raster.py:34-53: the per-sample visibility buffer that
the binned visibility raster (ops/raster_binned.py, K6) writes, and the
pixel-relative sample positions of one sample and of wgpu's standard 4x
MSAA pattern, which the frame's K1 launches and K6 share. The O(T x P)
reference rasterizer `rasterize` is not ported (ROADMAP queue 1 item 14).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .geometry import CullMode

__all__ = ["VisBuffer", "CullMode", "NEG_DEPTH", "CENTER_OFFSET", "MSAA4_OFFSETS", "sample_offsets"]

NEG_DEPTH = -1.0  # sentinel "no coverage" depth; real depths are >= 0

# wgpu / Vulkan standard sample positions (pixel-relative).
CENTER_OFFSET = ((0.5, 0.5),)
MSAA4_OFFSETS = ((0.375, 0.125), (0.875, 0.375), (0.125, 0.625), (0.625, 0.875))


class VisBuffer(NamedTuple):
    """Per-sample visibility: depth (S, H, W) f32 and triangle id (S, H, W)
    int32 into the clipped-triangle table, -1 = no hit."""

    depth: torch.Tensor
    tri: torch.Tensor


def sample_offsets(samples: int) -> Tuple[Tuple[float, float], ...]:
    """The sample positions of a target with `samples` samples (1 or 4)."""
    if samples == 1:
        return CENTER_OFFSET
    if samples == 4:
        return MSAA4_OFFSETS
    raise ValueError(f"samples={samples}: the renderer takes 1 or 4 samples")
