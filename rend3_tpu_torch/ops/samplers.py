"""Grid samplers: the fused PCF5 shadow sampler, kernel K3.

Port of rend3_tpu/ops/mxu_gather.py sample_grid_pcf5, named for what it does
on the GPU. On the TPU a per-pixel gather is slow, so the JAX kernel gathers
by one-hot matmuls over (screen tile, map cell) pair lists; on Hopper a
gather is a load, so the CUDA kernel (csrc/pcf5.cu) is one thread per pixel
reading its 12 texels directly, and the pair lists, step queues and pre-tiled
grid stores are gone. The wrapper runs the kernel for CUDA tensors and the
plain PyTorch version below for CPU tensors.
"""

from __future__ import annotations

import torch

__all__ = ["sample_grid_pcf5", "sample_grid_pcf5_plain", "PCF5_OFFSETS"]

# The 12 texels around the base texel floor(s - 0.5) that the five bilinear
# taps of PCF5 read: dy in [-1, 2], dx in [-1, 2], minus the corners.
PCF5_OFFSETS = (
    (0, -1), (1, -1),
    (-1, 0), (0, 0), (1, 0), (2, 0),
    (-1, 1), (0, 1), (1, 1), (2, 1),
    (0, 2), (1, 2),
)

launches = {"pcf5": 0}


def sample_grid_pcf5_plain(img, bx, by, fx, fy, ref, valid):
    """Plain version of K3: PCF5 with a bilinear GreaterEqual compare.

    Texels outside img read 0.0 (the JAX zero padding). Returns 0 where
    `valid` is false or the base texel lies outside img; callers substitute
    1.0 there (shadow.py:757-759)."""
    Hs, Ws = img.shape
    cmp = {}
    for dx, dy in PCF5_OFFSETS:
        x = bx + dx
        y = by + dy
        inside = (x >= 0) & (x < Ws) & (y >= 0) & (y < Hs)
        occ = torch.where(inside, img[y.clamp(0, Hs - 1), x.clamp(0, Ws - 1)], torch.zeros_like(fx))
        cmp[(dx, dy)] = (ref >= occ).float()

    def tap(ox, oy):
        top = cmp[(ox, oy)] * (1.0 - fx) + cmp[(ox + 1, oy)] * fx
        bot = cmp[(ox, oy + 1)] * (1.0 - fx) + cmp[(ox + 1, oy + 1)] * fx
        return top * (1.0 - fy) + bot * fy

    total = tap(0, 0) + tap(0, 1) + tap(0, -1) + tap(1, 0) + tap(-1, 0)
    own = valid & (bx >= 0) & (bx < Ws) & (by >= 0) & (by < Hs)
    return torch.where(own, total * 0.2, torch.zeros_like(total))


def sample_grid_pcf5(img, bx, by, fx, fy, ref, valid):
    """K3: PCF5 resolved per pixel (mxu_gather.sample_grid_pcf5 without
    the pair caps). img (Hs, Ws) f32 reverse-Z depth; bx, by (H, W) int32
    base texel floor(s - 0.5); fx, fy (H, W) f32 bilinear fractions; ref
    (H, W) f32 reference depth; valid (H, W) bool. Returns (H, W) f32."""
    H, W = bx.shape
    dev = img.device
    for name, t, dt in (
        ("img", img, torch.float32), ("bx", bx, torch.int32), ("by", by, torch.int32),
        ("fx", fx, torch.float32), ("fy", fy, torch.float32), ("ref", ref, torch.float32),
        ("valid", valid, torch.bool),
    ):
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous {dt} on {dev}, got {t.dtype} on {t.device}")
        if name != "img" and t.shape != (H, W):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {(H, W)}")
    if img.dim() != 2:
        raise ValueError(f"img must be 2-D, got {tuple(img.shape)}")
    if dev.type == "cpu":
        return sample_grid_pcf5_plain(img, bx, by, fx, fy, ref, valid)
    from . import cuda_kernels

    out = torch.empty(H, W, dtype=torch.float32, device=dev)
    cuda_kernels.call(
        "k3_pcf5", img, bx, by, fx, fy, ref, valid, out,
        ints=(img.shape[0], img.shape[1], H * W),
    )
    launches["pcf5"] += 1
    return out
