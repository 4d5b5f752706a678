"""GPU skinning: 4-weight linear blend skinning over the vertex arenas.

Port of rend3_tpu/ops/skin.py (reference: rend3-routine/src/skinning.rs and
shaders/src/skinning.wgsl). Per skeleton, the source position / normal /
tangent ranges are blended by 4 joint matrices and written into the
skeleton's override ranges; the blend is a torch gather and a 4-joint
weighted sum. The JAX package runs no Pallas kernel here, and neither does
the port.

Two pieces with their own lifetimes, as the reference's skinner keeps them
(per-skeleton inputs and joint buffer each frame, joint ids and weights
with the mesh):

- the layout (`SkinLayout`): every skeleton's per-vertex lists in index
  order (source and destination rows, joint ids with the skeleton's joint
  base added, weights, the normal and tangent lists), built on the host and
  kept on the device until a skeleton is added or removed or the mesh
  arenas change (`SkeletonManager.layout_version`, the mesh manager's
  version);
- the palette: every skeleton's joint matrices in index order, one (J, 4,
  4) float32 upload whenever a pose changes (`SkeletonManager.version`).

`Skinner` holds both across frames and the skinned arenas of the last pose.

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

from ..utils import profiling
from ..utils.profiling import scope as profiling_scope
from .deferred import fma32

__all__ = ["SkinLayout", "Skinner", "build_skin_layout", "skin_palette", "build_skin_inputs", "apply_skinning"]


class SkinLayout(NamedTuple):
    """Flat per-vertex skinning lists across all skeletons, without the
    joint matrices. Rows whose normal / tangent source or destination is
    missing (-1 in the JAX list) are left out of those lists."""

    src_ids: torch.Tensor         # (V,) int64 source vertex (position arena)
    dst_ids: torch.Tensor         # (V,) int64 destination (override range)
    joint_ids: torch.Tensor       # (V, 4) int64 into the palette
    joint_weights: torch.Tensor   # (V, 4) f32
    normal: tuple                 # (rows into the V list, src, dst) int64, for normals
    tangent: tuple                # the same for tangents

    @property
    def nbytes(self) -> int:
        tensors = (self.src_ids, self.dst_ids, self.joint_ids, self.joint_weights) + self.normal + self.tangent
        return sum(t.numel() * t.element_size() for t in tensors)


def direction_list(src: np.ndarray, dst: np.ndarray, device):
    """(rows, src, dst) int64 tensors of the work-list rows whose normal or
    tangent source and destination both exist (not -1)."""
    ok = np.nonzero((src >= 0) & (dst >= 0))[0]
    return tuple(_upload(a, device) for a in (ok, src[ok], dst[ok]))


def _upload(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A host array on `device`, as `dtype` when given."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    with profiling_scope("sync::upload.skin"):
        return (t if dtype is None else t.to(dtype)).to(device)


def build_skin_layout(skeleton_mgr, mesh_mgr, device="cpu") -> Optional[SkinLayout]:
    """The layout of every skeleton in index order (the lists of
    build_skin_inputs of skin.py:34-75), on `device`; None when there are no
    skeletons."""
    if not skeleton_mgr.data:
        return None
    lists = {k: [] for k in ("sp", "sn", "stg", "dp", "dn", "dtg", "j", "w")}
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
        joint_base += len(rec.joint_matrices)
    cat = {k: np.concatenate(v) for k, v in lists.items()}

    return SkinLayout(
        src_ids=_upload(cat["sp"], device, torch.int64),
        dst_ids=_upload(cat["dp"], device, torch.int64),
        joint_ids=_upload(cat["j"], device, torch.int64),
        joint_weights=_upload(cat["w"], device, torch.float32),
        normal=direction_list(cat["sn"], cat["dn"], device),
        tangent=direction_list(cat["stg"], cat["dtg"], device),
    )


def skin_palette(skeleton_mgr) -> np.ndarray:
    """(J, 4, 4) f32: every skeleton's joint matrices in index order, the
    rows the layout's joint ids index."""
    return np.concatenate([rec.joint_matrices for _idx, rec in sorted(skeleton_mgr.data.items())])


def build_skin_inputs(skeleton_mgr, mesh_mgr, device="cpu") -> Optional[tuple]:
    """(layout, (J, 4, 4) f32 palette), apply_skinning's arguments, built at
    once on `device`; None when there are no skeletons."""
    layout = build_skin_layout(skeleton_mgr, mesh_mgr, device)
    if layout is None:
        return None
    return layout, _upload(skin_palette(skeleton_mgr), device, torch.float32)


class Skinner:
    """A graph's skinning across frames: the layout, rebuilt when the
    skeletons' layout version or the mesh arenas change; the palette,
    uploaded when a pose changes (a frame that rebuilt the layout uploads it
    too); the skinned arenas of the last pose and arenas. Spans
    `skin::layout`, `skin::palette` (its copy under `sync::upload.skin`),
    `skin::apply`; counters `skin.vertices` (rows skinned this frame),
    `skin.skeletons`, `skin.layout_builds` and `upload.skin_bytes` (the
    layout's and the palette's bytes copied this frame), each counted 0 on a
    frame with nothing to do."""

    def __init__(self):
        self.layout: Optional[SkinLayout] = None
        self.palette: Optional[torch.Tensor] = None  # (J, 4, 4) f32, the last pose's
        self.skinned = None                          # (key, GeometryArrays)
        self._layout_key = self._palette_key = None

    def __call__(self, geo, skeleton_mgr, mesh_mgr, device):
        """`geo` with every skeleton's override ranges skinned (`geo` itself
        when there is no skeleton)."""
        vertices = built = copied = 0
        if not skeleton_mgr.data:
            self.layout = self.palette = self.skinned = self._layout_key = self._palette_key = None
        else:
            key = (skeleton_mgr.layout_version, mesh_mgr.version)
            if self._layout_key != key:
                with profiling_scope("skin::layout"):
                    self.layout = build_skin_layout(skeleton_mgr, mesh_mgr, device)
                self._layout_key, self._palette_key = key, None
                built, copied = 1, self.layout.nbytes
            if self._palette_key != skeleton_mgr.version:
                with profiling_scope("skin::palette"):
                    palette = skin_palette(skeleton_mgr)
                    self.palette = _upload(palette, device, torch.float32)
                self._palette_key = skeleton_mgr.version
                copied += palette.nbytes
            key = (skeleton_mgr.version, mesh_mgr.version, id(geo))
            if self.skinned is None or self.skinned[0] != key:
                with profiling_scope("skin::apply"):
                    self.skinned = (key, apply_skinning(geo, self.layout, self.palette))
                vertices = self.layout.src_ids.shape[0]
            geo = self.skinned[1]
        profiling.count("skin.skeletons", len(skeleton_mgr.data))
        profiling.count("skin.vertices", vertices)
        profiling.count("skin.layout_builds", built)
        profiling.count("upload.skin_bytes", copied)
        return geo


def _blend(layout: SkinLayout, palette: torch.Tensor) -> torch.Tensor:
    """(V, 4, 4) joint blend: M0*w0, then fma(Mk, wk, acc)."""
    M = palette[layout.joint_ids]             # (V, 4, 4, 4)
    w = layout.joint_weights[:, :, None, None].expand(M.shape)
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


def apply_skinning(geo, layout: SkinLayout, palette: torch.Tensor):
    """The geometry with each skeleton's override ranges rewritten from its
    source ranges by the (J, 4, 4) `palette` (apply_skinning of
    skin.py:78-102). Returns a new GeometryArrays; only position, normal and
    tangent are new tensors."""
    blended = _blend(layout, palette)
    A = blended[:, :3, :3]
    n = geo.position.shape[0]
    src = layout.src_ids.clamp(0, n - 1)
    new_pos = _apply3(A, geo.position[src]) + blended[:, :3, 3]
    keep = layout.dst_ids >= 0
    position = geo.position.index_copy(0, layout.dst_ids[keep], new_pos[keep])

    def skin_dir(arena, lst):
        rows, s, d = lst
        if rows.numel() == 0:
            return arena
        return arena.index_copy(0, d, _apply3(A[rows], arena[s]))

    return geo._replace(
        position=position, normal=skin_dir(geo.normal, layout.normal),
        tangent=skin_dir(geo.tangent, layout.tangent)
    )
