"""The binned visibility raster, K6: depth and triangle id per sample.

Port of rend3_tpu/ops/raster_pallas.py (rasterize_binned, the Pallas
kernel; rasterize_binned_xla, its XLA oracle). For every pixel and sample
offset, walk the pixel's 8x128 tile list (CSR, ascending setup-row id) and
keep the covering triangle of greatest reverse-Z depth; on equal depth the
later entry wins. Coverage is the three top-left edge tests and the depth
plane inside [0, 1], as K1's. Depth starts at 0 and the id at -1; the id
written is the winner's S_ID (its clipped-table row,
rend3_tpu/ops/geometry.py:273), not the setup-row index K1 keeps.

The TPU kernel's per-tile gather of setup rows into a padded (tiles, K)
block and its scalar-prefetched counts are gone: the CUDA kernel
(csrc/raster.cu, `k6_raster_vis`) reads the CSR lists and stages setup rows
through shared memory once for all sample offsets. Planes are evaluated as
K1's, fma(a, px, b*py) + c (ops/deferred.py), the form XLA:CPU gives the
Pallas kernel in interpret mode. The wrapper runs the kernel for CUDA
tensors and the plain version, in this module, for CPU tensors.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import deferred as def_ops
from .geometry import S_ID, TILE_H, TILE_W, BinnedTris, TriSetup
from .raster import VisBuffer

__all__ = ["rasterize_binned", "rasterize_binned_plain", "launches"]

# Launch count of the CUDA kernel (plain-version runs do not count).
launches = {"raster_vis": 0}

# The sample counts K6 takes (the renderer's: one, or MSAA 4).
SAMPLE_COUNTS = (1, 4)


def rasterize_binned_plain(
    tris: TriSetup, binned: BinnedTris, width: int, height: int, sample_offsets: Sequence[Tuple[float, float]],
) -> VisBuffer:
    """Plain version of K6 (the counterpart of rasterize_binned_xla): per
    sample, the winner of deferred._winners_plain's depth-then-later-row
    key over the 8x128 tile lists, its S_ID as the id."""
    depths, ids = [], []
    for sofs in sample_offsets:
        win, depth, _ = def_ops._winners_plain(tris, binned, width, height, sofs, tile_h=TILE_H, tile_w=TILE_W)
        hit = win >= 0
        tri = torch.full_like(win, -1)
        tri[hit] = tris.setup[win[hit], S_ID].long()
        depths.append(depth.reshape(height, width))
        ids.append(tri.to(torch.int32).reshape(height, width))
    return VisBuffer(depth=torch.stack(depths), tri=torch.stack(ids))


def rasterize_binned(
    tris: TriSetup, binned: BinnedTris, width: int, height: int, sample_offsets: Sequence[Tuple[float, float]],
) -> VisBuffer:
    """K6: the (S, H, W) visibility buffer of the setup table over 8x128
    CSR tile lists, S = 1 or 4 sample offsets. width / height are padded
    to the tile. CUDA tensors launch the kernel in csrc/raster.cu; CPU
    tensors run rasterize_binned_plain."""
    dev = def_ops._check(tris, binned, width, height, tile_h=TILE_H, tile_w=TILE_W)
    ns = len(sample_offsets)
    if ns not in SAMPLE_COUNTS:
        raise ValueError(f"{ns} sample offsets; K6 takes {SAMPLE_COUNTS}")
    if dev.type == "cpu":
        return rasterize_binned_plain(tris, binned, width, height, sample_offsets)
    from . import cuda_kernels

    depth = torch.empty(ns, height, width, dtype=torch.float32, device=dev)
    tri = torch.empty(ns, height, width, dtype=torch.int32, device=dev)
    # The C entry takes four (x, y) pairs; those past ns are ignored.
    offs = [float(v) for o in sample_offsets for v in o] + [0.0] * (8 - 2 * ns)
    cuda_kernels.call(
        "k6_raster_vis",
        tris.setup, tris.bbox, binned.offsets, binned.ids, depth, tri,
        ints=(width, height, ns), floats=offs,
    )
    launches["raster_vis"] += 1
    return VisBuffer(depth=depth, tri=tri)
