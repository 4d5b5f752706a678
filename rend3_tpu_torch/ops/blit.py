"""Output conversion: HDR resolve, sRGB encode, quantization.

Port of rend3_tpu/ops/blit.py (the reference's tonemapping blit,
tonemapping.rs + blit.wgsl): the scene is rendered to an Rgba16Float
intermediate, resolved, and encoded to 8-bit sRGB.
"""

from __future__ import annotations

import torch

from .shade import srgb_scene_to_display

__all__ = ["resolve_samples", "hdr_to_srgb_u8", "f16_roundtrip"]


def f16_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Quantize through f16 to mirror the Rgba16Float intermediate target."""
    return x.to(torch.float16).to(torch.float32)


def resolve_samples(img: torch.Tensor) -> torch.Tensor:
    """(S, H, W, 4) -> (H, W, 4) MSAA resolve (box average)."""
    return img.mean(dim=0)


def hdr_to_srgb_u8(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) linear -> (H, W, 4) u8 with sRGB-encoded color channels;
    alpha is stored linearly. torch.round rounds half to even, as jnp.round
    does (blit.py:20-35)."""
    rgb = srgb_scene_to_display(torch.clamp(img[..., :3], 0.0, 1.0))
    a = torch.clamp(img[..., 3:4], 0.0, 1.0)
    out = torch.cat([rgb, a], dim=-1)
    return torch.round(out * 255.0).to(torch.uint8)
