"""Shadow-map stacking and the per-frame PCF5 resolve.

Port of rend3_tpu/ops/shadow.py stack_shadow_maps and resolve_shadow_pcf5
(shadow.py:669-766): the frame's shadow maps are stacked row-wise with zero
gap rows (so a tap past a map's edge reads 0.0, as in the JAX build) and
every (G-buffer, light) entry resolves through one K3 launch
(samplers.sample_grid_pcf5).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .samplers import sample_grid_pcf5

__all__ = ["stack_shadow_maps", "resolve_shadow_pcf5"]

# Gap unit: maps are padded to a multiple of GAP rows plus one more GAP of
# zeros, well past the PCF5 halo (two texels), as mxu_gather.LT.
GAP = 64


def _stacked_rows(h: int) -> int:
    return -(-h // GAP) * GAP + GAP


def stack_shadow_maps(smaps: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, List[int]]:
    """Row-stack maps with zero gaps: (stacked (R, maxw) f32, row base per
    map)."""
    maxw = max(int(m.shape[1]) for m in smaps)
    rows = sum(_stacked_rows(int(m.shape[0])) for m in smaps)
    stacked = torch.zeros(rows, maxw, dtype=torch.float32, device=smaps[0].device)
    bases = []
    r = 0
    for m in smaps:
        bases.append(r)
        stacked[r : r + m.shape[0], : m.shape[1]] = m
        r += _stacked_rows(int(m.shape[0]))
    return stacked, bases


def resolve_shadow_pcf5(smaps, entries, stacked=None, capture=None):
    """All PCF5 shadow resolves of a frame in one K3 launch.

    smaps: list of (size, size) maps; entries: list of (map index, sx, sy,
    ref, hit) per (G-buffer, light), each of one shape per entry (a padded
    frame, or compacted pixels). stacked: optional (stacked, bases) from
    stack_shadow_maps, built once with cached maps. capture: optional dict
    that receives the K3 launch's inputs. The entries' queries are
    flattened into one vector, so entries of any shapes share the launch.
    Returns a list of factors shaped like each entry, 1.0 where the pixel
    is invalid."""
    if not entries:
        return []
    stacked, bases = stacked if stacked is not None else stack_shadow_maps(smaps)
    bxs, bys, fxs, fys, refs, oks = [], [], [], [], [], []
    for mi, sx, sy, ref, hit in entries:
        h_m, w_m = smaps[mi].shape
        sx, sy = sx.flatten(), sy.flatten()
        xb = torch.floor(sx - 0.5)
        yb = torch.floor(sy - 0.5)
        bx = xb.to(torch.int32)
        by = yb.to(torch.int32)
        bxs.append(bx)
        bys.append(by + bases[mi])
        fxs.append((sx - 0.5) - xb)
        fys.append((sy - 0.5) - yb)
        refs.append(ref.flatten())
        oks.append(hit.flatten() & (bx >= 0) & (bx < w_m) & (by >= 0) & (by < h_m))

    args = (stacked, *(torch.cat(xs).contiguous() for xs in (bxs, bys, fxs, fys, refs, oks)))
    if capture is not None:
        capture["pcf5"] = args
    ok_all = args[-1]
    pcf_all = sample_grid_pcf5(*args)
    # Invalid pixels read 0 from the sampler; they are lit (1.0).
    pcf_all = torch.where(ok_all, pcf_all, torch.ones_like(pcf_all))
    return [p.reshape(e[1].shape) for p, e in zip(torch.split(pcf_all, [e[1].numel() for e in entries]), entries)]
