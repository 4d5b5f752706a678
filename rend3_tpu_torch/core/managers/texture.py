"""TextureManager (2D and cube instances), host side.

Port of rend3_tpu/core/managers/texture.py. Reference:
rend3/src/managers/texture.rs — slot vector of textures, 1-based shader
indices with 0 = null. The host side (decode to linear f32, box mip chains,
slots) carries across unchanged. The device side of the 2D manager is a
mip-chained texture atlas (ops/texture.py): a full shelf pack on the first
`evaluate`, later adds placed incrementally into the resident atlas, removes
clearing only the rect table. The atlas lives on the renderer's device in
bf16, (AH, AW, 4) interleaved, the texel type kernel K4 reads. The cube
manager's device side (the skybox) is ops/texture.CubeArrays: the faces and
K4's padded bf16 face store, rebuilt whole when a cube texture changes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...types.texture import Texture, TextureFormat, MipmapCount, MipmapSource

__all__ = ["TextureManager", "InternalTexture"]


def _decode_to_linear_f32(tex: Texture) -> np.ndarray:
    """Convert uploaded bytes to linear float32 RGBA (EOTF for *-Srgb)."""
    data = tex.data
    if data.dtype == np.uint8:
        f = data.astype(np.float32) / 255.0
    else:
        f = data.astype(np.float32)
    if f.shape[-1] == 3:
        f = np.concatenate([f, np.ones(f.shape[:-1] + (1,), np.float32)], axis=-1)
    if tex.format.bgra:
        f = f[..., [2, 1, 0, 3]]
    if tex.format.srgb:
        rgb = f[..., :3]
        rgb = np.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
        f = np.concatenate([rgb, f[..., 3:]], axis=-1)
    return f.astype(np.float32)


def _mip_chain(img: np.ndarray, levels: int) -> List[np.ndarray]:
    """2x2 box-filter mip chain (reference: rend3/shaders/mipmap.wgsl)."""
    mips = [img]
    cur = img
    for _ in range(1, levels):
        h, w = cur.shape[0], cur.shape[1]
        nh, nw = max(1, h // 2), max(1, w // 2)
        c = cur[: nh * 2, : nw * 2]
        cur = c.reshape(nh, 2, nw, 2, 4).mean(axis=(1, 3))
        mips.append(cur.astype(np.float32))
    return mips


@dataclass
class InternalTexture:
    size: Tuple[int, int]
    mips: List[np.ndarray]


class TextureManager:
    """One instance per dimensionality (d2 / cube), like the reference."""

    def __init__(self, kind: str = "d2", device="cpu"):
        self.kind = kind
        self.device = torch.device(device)
        self.data: Dict[int, InternalTexture] = {}
        self.dirty = True
        self._device_arrays = None
        # Incremental atlas state: pending adds are shelf-placed into the
        # resident device atlas instead of rebuilding it; removes only clear
        # the rect table (holes are reclaimed by the next full pack).
        self._pending_adds: list = []
        self._shelf = None
        self._rects = None
        self._mip_counts = None
        self._atlas_dev = None

    def add(self, idx: int, tex: Texture) -> None:
        f = _decode_to_linear_f32(tex)
        if self.kind == "cube":
            assert f.ndim == 4 and f.shape[0] == 6, "cube texture needs (6, H, W, 4) data"
            if tex.mip_count == MipmapCount.MAXIMUM:
                levels = int(max(f.shape[1], f.shape[2])).bit_length()
            elif isinstance(tex.mip_count, int):
                levels = tex.mip_count
            else:
                levels = 1
            # Per-face box mip chain, stacked back to (6, h, w, 4) per level
            # (reference generates cube mips face-by-face the same way).
            chains = [_mip_chain(f[i], levels) for i in range(6)]
            mips = [np.stack([chains[i][l] for i in range(6)]) for l in range(levels)]
            self.data[idx] = InternalTexture(size=(f.shape[1], f.shape[2]), mips=mips)
        else:
            h, w = f.shape[0], f.shape[1]
            if tex.mip_count == MipmapCount.MAXIMUM:
                levels = int(max(h, w)).bit_length()
            elif isinstance(tex.mip_count, int):
                levels = tex.mip_count
            else:
                levels = 1
            self.data[idx] = InternalTexture(size=(h, w), mips=_mip_chain(f, levels))
            self._pending_adds.append(idx)
        self.dirty = True

    def add_from(self, idx: int, src_idx: int, start_mip: int, mip_count) -> None:
        """New texture as a mip-range view of another
        (reference: rend3/src/managers/texture.rs:198-242 TextureFromTexture;
        a GPU blit there, a mip-list slice here)."""
        src = self.data[src_idx]
        end = len(src.mips) if mip_count is None else start_mip + mip_count
        mips = [m.copy() for m in src.mips[start_mip:end]]
        assert mips, "TextureFromTexture: empty mip range"
        self.data[idx] = InternalTexture(size=(mips[0].shape[0], mips[0].shape[1]), mips=mips)
        self._pending_adds.append(idx)
        self.dirty = True

    def remove(self, idx: int) -> None:
        self.data.pop(idx, None)
        if idx in self._pending_adds:
            self._pending_adds.remove(idx)
        elif self.kind == "d2" and self._rects is not None and idx + 1 < len(self._rects):
            self._rects[idx + 1] = 0.0
            self._mip_counts[idx + 1] = 0
        self.dirty = True

    def shader_index(self, handle) -> int:
        """1-based shader index; 0 reserved for 'no texture'
        (reference: texture.rs translation_fn)."""
        return handle.idx + 1

    def _block(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device).to(torch.bfloat16)

    def _full_pack(self, tex_ops) -> None:
        atlas, rects, mip_counts, shelf = tex_ops.build_texture_atlas_state(self.data)
        self._rects = rects
        self._mip_counts = mip_counts
        self._shelf = shelf
        self._atlas_dev = self._block(atlas)
        self._pending_adds.clear()

    def _try_incremental(self, tex_ops) -> bool:
        """Place pending adds into the resident atlas; False -> repack."""
        n_slots = (max(self.data.keys()) + 1) if self.data else 0
        if n_slots + 1 > len(self._rects):
            grown_r = np.zeros((n_slots + 1, tex_ops.MAX_MIPS, 4), np.float32)
            grown_r[: len(self._rects)] = self._rects
            self._rects = grown_r
            grown_m = np.zeros(n_slots + 1, np.int32)
            grown_m[: len(self._mip_counts)] = self._mip_counts
            self._mip_counts = grown_m
        placements = []
        for idx in self._pending_adds:
            t = self.data.get(idx)
            if t is None:
                continue
            for mi, mip in enumerate(t.mips[: tex_ops.MAX_MIPS]):
                h, w = mip.shape[0], mip.shape[1]
                pos = self._shelf.place(w + 2, h + 2)
                if pos is None:
                    return False
                placements.append((idx, mi, mip, pos))
        for idx, mi, mip, (x, y) in placements:
            h, w = mip.shape[0], mip.shape[1]
            self._atlas_dev[y : y + h + 2, x : x + w + 2] = self._block(tex_ops.gutter_block(mip))
            self._rects[idx + 1, mi] = (x + 1, y + 1, w, h)
            self._mip_counts[idx + 1] = max(self._mip_counts[idx + 1], mi + 1)
        self._pending_adds.clear()
        return True

    def evaluate(self):
        """The device texture arrays (ops/texture.TextureArrays, or
        CubeArrays for the cube manager, None without cube textures),
        rebuilt only when textures changed since the last call."""
        if not self.dirty and self._device_arrays is not None:
            return self._device_arrays
        from ...ops import texture as tex_ops

        if self.kind == "cube":
            self._device_arrays = tex_ops.build_cube_array(self.data, self.device)
            self.dirty = False
            return self._device_arrays

        if self._atlas_dev is None or not self._try_incremental(tex_ops):
            self._full_pack(tex_ops)
        self._device_arrays = tex_ops.TextureArrays(
            atlas=self._atlas_dev,
            rects=torch.from_numpy(self._rects.copy()).to(self.device),
            mip_counts=torch.from_numpy(self._mip_counts.copy()).to(self.device),
        )
        self.dirty = False
        return self._device_arrays
