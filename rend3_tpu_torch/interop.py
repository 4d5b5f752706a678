"""Carry the JAX package's tables into the port's tensors.

The parity tests run a stage in both packages from the same numbers: they
turn the JAX side's arrays into numpy (`np.asarray`) and hand them to the
functions here, which build the port's structures. Nothing here imports
jax; the inputs are numpy arrays or anything `np.asarray` accepts.

- geometry arenas, triangle / object / material tables: `tensor`,
  `geometry_arrays`;
- light arrays: `dir_lights`, `point_lights`;
- the setup table (`TriSetup`, padding rows past `count` dropped) and
  attribute planes (`planes`);
- per-tile lists: `binned` turns JAX's (n_tiles, K) -1-padded `BinnedTris`
  ids into CSR, at any tile size (K1's 32x128, K6's 8x128, the shadow
  occlusion's 32x128 screen tiles);
- the visibility buffer: `vis_buffer`;
- shadow maps: `tensor`;
- the texture atlas and its tables (`texture_arrays`), from the JAX
  `TextureArrays`;
- cube textures (`cube_arrays`) from the JAX `CubeArrays` faces and sizes;
- the skinning work list (`skin_inputs`) from the JAX `SkinInputs`.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.framestate import GeometryArrays
from .ops.geometry import BinnedTris, TriSetup
from .ops.raster import VisBuffer
from .ops import texture as _texture
from .ops.shade import DirLightArrays, PointLightArrays
from .ops.skin import SkinLayout, direction_list
from .ops.texture import CubeArrays, TextureArrays

__all__ = [
    "tensor", "geometry_arrays", "tri_setup", "planes", "binned", "vis_buffer", "dir_lights",
    "point_lights", "texture_arrays", "cube_arrays", "skin_inputs",
]


def tensor(a, device="cpu", dtype=None) -> torch.Tensor:
    """numpy (or array-like) -> contiguous tensor on `device`."""
    t = torch.from_numpy(np.array(a, copy=True, order="C"))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def geometry_arrays(geo, device="cpu") -> GeometryArrays:
    """Any object with GeometryArrays' fields (the JAX NamedTuple)."""
    return GeometryArrays(**{f: tensor(getattr(geo, f), device) for f in GeometryArrays._fields})


def tri_setup(setup, bbox, count, src, flip, device="cpu") -> TriSetup:
    """The JAX TriSetup's arrays, cut to its `count` survivor rows."""
    n = int(count)
    return TriSetup(
        setup=tensor(np.asarray(setup)[:n], device, torch.float32),
        bbox=tensor(np.asarray(bbox)[:n], device, torch.float32),
        src=tensor(np.asarray(src)[:n], device, torch.int64),
        flip=tensor(np.asarray(flip)[:n], device, torch.bool),
    )


def planes(planes_arr, count, device="cpu") -> torch.Tensor:
    return tensor(np.asarray(planes_arr)[: int(count)], device, torch.float32)


def binned(ids, counts=None, device="cpu") -> BinnedTris:
    """(n_tiles, K) per-tile ids, -1 padded -> CSR (padding stripped, the
    order of each list kept). With `counts` (n_tiles,), only each row's
    first counts[t] entries are kept."""
    ids = np.asarray(ids)
    keep = ids >= 0
    if counts is not None:
        keep &= np.arange(ids.shape[1])[None, :] < np.asarray(counts)[:, None]
    counts = keep.sum(axis=1)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return BinnedTris(
        offsets=tensor(offsets, device), ids=tensor(ids[keep].astype(np.int32), device)
    )


def vis_buffer(depth, tri, device="cpu") -> VisBuffer:
    """The JAX VisBuffer's (S, H, W) arrays."""
    return VisBuffer(depth=tensor(depth, device, torch.float32), tri=tensor(tri, device, torch.int32))


def dir_lights(arrays, device="cpu") -> DirLightArrays:
    """From the JAX DirLightArrays (or the evaluation output's dict)."""
    get = arrays.__getitem__ if isinstance(arrays, dict) else lambda k: getattr(arrays, k)
    return DirLightArrays(
        **{
            k: tensor(get(k), device, torch.bool if k == "mask" else torch.float32)
            for k in DirLightArrays._fields
        }
    )


def point_lights(arrays, device="cpu") -> PointLightArrays:
    get = arrays.__getitem__ if isinstance(arrays, dict) else lambda k: getattr(arrays, k)
    return PointLightArrays(
        **{
            k: tensor(get(k), device, torch.bool if k == "mask" else torch.float32)
            for k in PointLightArrays._fields
        }
    )


def texture_arrays(atlas, rects, mip_counts, device="cpu") -> TextureArrays:
    """From the JAX TextureArrays' fields: the (AH, AW, 4) f32 atlas is
    rounded to the port's bf16 texels (the JAX sampler's own bf16 cast)."""
    return TextureArrays(
        atlas=tensor(atlas, device, torch.float32).to(torch.bfloat16),
        rects=tensor(rects, device, torch.float32),
        mip_counts=tensor(mip_counts, device, torch.int32),
    )


def cube_arrays(faces, sizes, device="cpu") -> CubeArrays:
    """From the JAX CubeArrays' (N+1, 6, E, E, 4) f32 faces and (N+1,)
    sizes; K4's padded bf16 store is built from them as the port builds it."""
    return _texture.cube_arrays(np.asarray(faces, np.float32), np.asarray(sizes, np.int32), device)


def skin_inputs(si, device="cpu") -> tuple:
    """(SkinLayout, (J, 4, 4) f32 palette), apply_skinning's arguments, from
    any object with the JAX SkinInputs' fields (src_ids, src_ids_n,
    src_ids_t, dst_ids, dst_ids_n, dst_ids_t, joint_ids, joint_weights,
    joint_matrices); the -1 normal and tangent rows are left out of their
    lists, as the port's build_skin_inputs does."""
    a = {f: np.asarray(getattr(si, f)) for f in (
        "src_ids", "src_ids_n", "src_ids_t", "dst_ids", "dst_ids_n", "dst_ids_t", "joint_ids", "joint_weights",
        "joint_matrices",
    )}
    layout = SkinLayout(
        src_ids=tensor(a["src_ids"], device, torch.int64),
        dst_ids=tensor(a["dst_ids"], device, torch.int64),
        joint_ids=tensor(a["joint_ids"], device, torch.int64),
        joint_weights=tensor(a["joint_weights"], device, torch.float32),
        normal=direction_list(a["src_ids_n"].astype(np.int64), a["dst_ids_n"].astype(np.int64), device),
        tangent=direction_list(a["src_ids_t"].astype(np.int64), a["dst_ids_t"].astype(np.int64), device),
    )
    return layout, tensor(a["joint_matrices"], device, torch.float32)
