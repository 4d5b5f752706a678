"""TextureManager (2D and cube instances), host side.

Port of rend3_tpu/core/managers/texture.py. Reference:
rend3/src/managers/texture.rs — slot vector of textures, 1-based shader
indices with 0 = null. The host side (decode to linear f32, box mip chains,
slots) carries across; the device atlas and its sampler are not ported yet
(ROADMAP queue 1, item 6 "Textures"), so `evaluate` raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

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

    def __init__(self, kind: str = "d2"):
        self.kind = kind
        self.data: Dict[int, InternalTexture] = {}
        self.dirty = True

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
        self.dirty = True

    def remove(self, idx: int) -> None:
        self.data.pop(idx, None)
        self.dirty = True

    def shader_index(self, handle) -> int:
        """1-based shader index; 0 reserved for 'no texture'
        (reference: texture.rs translation_fn)."""
        return handle.idx + 1

    def evaluate(self):
        raise NotImplementedError(
            "texture sampling is not ported yet (ROADMAP queue 1, item 6 'Textures', kernel K4)"
        )
