"""GPU skinning: 4-weight linear blend skinning over the vertex arenas.

Port of rend3_tpu/ops/skin.py (reference: rend3-routine/src/skinning.rs and
shaders/src/skinning.wgsl). Per skeleton, the source position / normal /
tangent ranges are blended by 4 joint matrices and written into the
skeleton's override ranges. All skeletons form one flat per-vertex work
list, built on the host and uploaded once per change of the skeleton
manager's version; the blend is a torch gather and a 4-joint weighted sum.
The JAX package runs no Pallas kernel here, and neither does the port.

Numerics, bit for bit with the JAX function as XLA:CPU runs it (found by
matching): the blended matrix is M0*w0, then fma(Mk, wk, acc) for joints 1-3;
the 3x3 product is a0*v0, then fma(a1, v1, .) and fma(a2, v2, .); positions
then add the translation column. `deferred.fma32` (ops/fp.py) is the
correctly rounded fma: the F1 kernel on the card, its float64 emulation on
the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .deferred import fma32

__all__ = ["SkinInputs", "build_skin_inputs", "apply_skinning"]


class SkinInputs(NamedTuple):
    """Flat per-vertex skinning work list across all skeletons. Rows whose
    normal / tangent source or destination is missing (-1 in the JAX list)
    are left out of those lists."""

    src_ids: torch.Tensor         # (V,) int64 source vertex (position arena)
    dst_ids: torch.Tensor         # (V,) int64 destination (override range)
    joint_ids: torch.Tensor       # (V, 4) int64 into joint_matrices
    joint_weights: torch.Tensor   # (V, 4) f32
    joint_matrices: torch.Tensor  # (J, 4, 4) f32
    normal: tuple                 # (rows into the V list, src, dst) int64, for normals
    tangent: tuple                # the same for tangents


def direction_list(src: np.ndarray, dst: np.ndarray, device):
    """(rows, src, dst) int64 tensors of the work-list rows whose normal or
    tangent source and destination both exist (not -1)."""
    ok = np.nonzero((src >= 0) & (dst >= 0))[0]
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (ok, src[ok], dst[ok]))


def build_skin_inputs(skeleton_mgr, mesh_mgr, device="cpu") -> Optional[SkinInputs]:
    """The work list of every skeleton in index order (build_skin_inputs of
    skin.py:34-75), on `device`; None when there are no skeletons."""
    if not skeleton_mgr.data:
        return None
    lists = {k: [] for k in ("sp", "sn", "stg", "dp", "dn", "dtg", "j", "w")}
    mats = []
    joint_base = 0
    for _idx, rec in sorted(skeleton_mgr.data.items()):
        vc = rec.vertex_count
        mesh = mesh_mgr.data[rec.mesh_idx]
        jr = mesh.joints_range
        ar = np.arange(vc)

        def rng(d, name):
            r = d.get(name)
            return (r[0] + ar) if r is not None else np.full(vc, -1, np.int64)

        for key, ranges, name in (
            ("sp", rec.source_ranges, "position"), ("sn", rec.source_ranges, "normal"),
            ("stg", rec.source_ranges, "tangent"), ("dp", rec.override_ranges, "position"),
            ("dn", rec.override_ranges, "normal"), ("dtg", rec.override_ranges, "tangent"),
        ):
            lists[key].append(rng(ranges, name))
        lists["j"].append(mesh_mgr._joint_indices[jr[0] : jr[0] + vc].astype(np.int64) + joint_base)
        lists["w"].append(mesh_mgr._joint_weights[jr[0] : jr[0] + vc])
        mats.append(np.asarray(rec.joint_matrices, np.float32).reshape(-1, 4, 4))
        joint_base += len(mats[-1])
    cat = {k: np.concatenate(v) for k, v in lists.items()}

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(device)

    return SkinInputs(
        src_ids=up(cat["sp"], torch.int64),
        dst_ids=up(cat["dp"], torch.int64),
        joint_ids=up(cat["j"], torch.int64),
        joint_weights=up(cat["w"], torch.float32),
        joint_matrices=up(np.concatenate(mats), torch.float32),
        normal=direction_list(cat["sn"], cat["dn"], device),
        tangent=direction_list(cat["stg"], cat["dtg"], device),
    )


def _blend(si: SkinInputs) -> torch.Tensor:
    """(V, 4, 4) joint blend: M0*w0, then fma(Mk, wk, acc)."""
    M = si.joint_matrices[si.joint_ids]       # (V, 4, 4, 4)
    w = si.joint_weights[:, :, None, None].expand(M.shape)
    acc = M[:, 0] * w[:, 0]
    for k in range(1, 4):
        acc = fma32(M[:, k], w[:, k], acc)
    return acc


def _apply3(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(V, 3, 3) @ (V, 3) as a0*v0, fma(a1, v1, .), fma(a2, v2, .)."""
    r = A[:, :, 0] * v[:, None, 0]
    for b in (1, 2):
        r = fma32(A[:, :, b], v[:, None, b].expand(r.shape), r)
    return r


def apply_skinning(geo, si: SkinInputs):
    """The geometry with each skeleton's override ranges rewritten from its
    source ranges (apply_skinning of skin.py:78-102). Returns a new
    GeometryArrays; only position, normal and tangent are new tensors."""
    blended = _blend(si)
    A = blended[:, :3, :3]
    n = geo.position.shape[0]
    src = si.src_ids.clamp(0, n - 1)
    new_pos = _apply3(A, geo.position[src]) + blended[:, :3, 3]
    keep = si.dst_ids >= 0
    position = geo.position.index_copy(0, si.dst_ids[keep], new_pos[keep])

    def skin_dir(arena, lst):
        rows, s, d = lst
        if rows.numel() == 0:
            return arena
        return arena.index_copy(0, d, _apply3(A[rows], arena[s]))

    return geo._replace(
        position=position, normal=skin_dir(geo.normal, si.normal), tangent=skin_dir(geo.tangent, si.tangent)
    )
