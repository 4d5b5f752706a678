"""The yardstick of the kernels: the card's published peaks and K1's bound.

A frozen copy of the arithmetic of chip_smoke.py (`_nbytes`, `_bound`,
`_raster_fragments`, `_k1_bound`), computed from the tensors each K1 launch
was passed. Bytes count each input read once and each output written once;
operations are K1's float32 work on the pixels its tile lists make it test.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "F32_OPS_PER_S", "bound_ms", "raster_fragments", "k1_bound_ms"]

# NVIDIA H100 SXM data sheet, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
GB_CH = 25          # K1's G-buffer channels
DTILE_H, DTILE_W = 32, 128
# f32 operations per tested (pixel, triangle): three edge planes and the
# depth plane (a multiply, an fma and an add each), their sign and top-left
# tests and the depth range; per pixel K1's finalize evaluates 21 planes
# (three operations each) and the four uv derivatives (about six each).
RASTER_TEST_OPS = 24
K1_FINALIZE_OPS = 21 * 3 + 4 * 6


def bound_ms(bytes_moved: float, ops: float) -> float:
    """The larger of the bytes over the memory rate and the operations over
    the float32 rate, in milliseconds."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def raster_fragments(bbox, offsets, ids, width: int, y0: int = 0) -> int:
    """Pixels K1 must test: per listed (tile, triangle) pair, the tile's
    pixels inside the triangle's bounding box."""
    import torch

    offs = offsets.long()
    tile = torch.repeat_interleave(torch.arange(offs.numel() - 1, device=offs.device), offs[1:] - offs[:-1])
    bb = bbox[ids.long()]
    n_cols = width // DTILE_W
    tx0 = (tile % n_cols) * DTILE_W
    ty0 = (tile // n_cols) * DTILE_H + y0
    nx = torch.minimum(torch.ceil(bb[:, 2]).long(), tx0 + DTILE_W) - torch.maximum(torch.floor(bb[:, 0]).long(), tx0)
    ny = torch.minimum(torch.ceil(bb[:, 3]).long(), ty0 + DTILE_H) - torch.maximum(torch.floor(bb[:, 1]).long(), ty0)
    return int((nx.clamp_min(0) * ny.clamp_min(0)).sum())


def k1_bound_ms(call: dict) -> float:
    """K1's bound for one launch recorded by the harness: its tables (setup,
    bbox, planes, lists, counts) read or written once, its bound / floor
    images read over the tiles whose lists are not empty, the G-buffer
    written once."""
    w, h = call["width"], call["height"]
    offs = call["offsets"]
    listed = float((offs[1:] > offs[:-1]).float().mean())
    frags = raster_fragments(call["bbox"], offs, call["ids"], w, call["y0"])
    bytes_moved = call["table_bytes"] + listed * sum(call["in_bytes"]) + GB_CH * w * h * 4
    return bound_ms(bytes_moved, frags * RASTER_TEST_OPS + w * h * K1_FINALIZE_OPS)
