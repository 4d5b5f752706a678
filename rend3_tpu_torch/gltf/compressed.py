"""KTX2 / DDS container parsing + block-compression decode to RGBA u8
(port of rend3_tpu/gltf/compressed.py, host numpy).

Behavioral port of rend3-gltf's compressed-texture support
(rend3-gltf/src/lib.rs:1185-1627: ktx2/ddsfile parsing + TextureFormat
mapping). The reference hands BCn payloads to the GPU's native sampler;
the port's texture atlas holds linear RGBA, so the BC blocks are decoded on
the host: BC1-BC5 in vectorized numpy here, BC6H/BC7 through Pillow's
native BCn decoder, and Zstandard-supercompressed KTX2 via the zstandard
module. BasisLZ supercompression is rejected with a clear
error (needs a UASTC transcoder).
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

__all__ = ["decode_ktx2", "decode_dds", "decode_bc"]

_KTX2_MAGIC = b"\xabKTX 20\xbb\r\n\x1a\n"

# Vulkan format numbers used by KTX2 (subset).
_VK_FORMATS = {
    37: ("rgba8", False),     # R8G8B8A8_UNORM
    43: ("rgba8", True),      # R8G8B8A8_SRGB
    131: ("bc1", False), 132: ("bc1", True),
    135: ("bc2", False), 136: ("bc2", True),
    137: ("bc3", False), 138: ("bc3", True),
    139: ("bc4", False), 140: ("bc4", False),
    141: ("bc5", False), 142: ("bc5", False),
    143: ("bc6h", False), 144: ("bc6hs", False),   # UFLOAT / SFLOAT
    145: ("bc7", False), 146: ("bc7", True),
}


def _bc_block_bytes(kind: str) -> int:
    return 8 if kind in ("bc1", "bc4") else 16


def _decode_bcn_pillow(kind: str, payload: bytes, width: int, height: int) -> np.ndarray:
    """BC6H (half-float HDR, clamped to LDR u8 by Pillow) and BC7 via
    Pillow's C BCn decoder — the mode/partition/anchor tables are large
    spec constants best left to a battle-tested implementation. Returns
    (height, width, 4) u8."""
    from PIL import Image

    bw, bh = -(-width // 4), -(-height // 4)
    n = bw * bh * 16
    if len(payload) < n:
        raise ValueError(f"{kind} payload too short: {len(payload)} < {n}")
    # Pillow requires the image size itself; it reads ceil(w/4)*ceil(h/4)
    # blocks, so pad the logical extent up to the block grid first.
    if kind == "bc7":
        im = Image.frombytes("RGBA", (bw * 4, bh * 4), payload[:n], "bcn", (7, "BC7"))
    else:
        pf = "BC6HS" if kind == "bc6hs" else "BC6H"
        im = Image.frombytes("RGB", (bw * 4, bh * 4), payload[:n], "bcn", (6, pf))
        im = im.convert("RGBA")
    return np.asarray(im, np.uint8)[:height, :width]


def _decode_bc1_color(block: np.ndarray, out: np.ndarray, alpha_from=None):
    """block: (N, 8) u8 color portion of BC1/2/3 -> out (N, 16, 4)."""
    c0 = block[:, 0].astype(np.uint16) | (block[:, 1].astype(np.uint16) << 8)
    c1 = block[:, 2].astype(np.uint16) | (block[:, 3].astype(np.uint16) << 8)

    def c565(c):
        r = ((c >> 11) & 31).astype(np.float32) * (255.0 / 31.0)
        g = ((c >> 5) & 63).astype(np.float32) * (255.0 / 63.0)
        b = (c & 31).astype(np.float32) * (255.0 / 31.0)
        return np.stack([r, g, b], axis=-1)

    p0 = c565(c0)
    p1 = c565(c1)
    four = (c0 > c1) | (alpha_from is not None)  # BC2/3 always 4-color mode
    p2 = np.where(four[:, None], (2 * p0 + p1) / 3.0, (p0 + p1) / 2.0)
    p3 = np.where(four[:, None], (p0 + 2 * p1) / 3.0, np.zeros_like(p0))
    palette = np.stack([p0, p1, p2, p3], axis=1)  # (N, 4, 3)

    bits = (
        block[:, 4].astype(np.uint32)
        | (block[:, 5].astype(np.uint32) << 8)
        | (block[:, 6].astype(np.uint32) << 16)
        | (block[:, 7].astype(np.uint32) << 24)
    )
    idx = (bits[:, None] >> (2 * np.arange(16, dtype=np.uint32))) & 3  # (N, 16)
    out[..., :3] = np.take_along_axis(palette, idx[..., None].astype(np.int64), axis=1)
    if alpha_from is None:
        # BC1 3-color mode index 3 = transparent black
        transparent = (~four[:, None]) & (idx == 3)
        out[..., 3] = np.where(transparent, 0.0, 255.0)
    else:
        out[..., 3] = alpha_from


def _decode_bc4_channel(block8: np.ndarray) -> np.ndarray:
    """block8: (N, 8) u8 single-channel BC4 block -> (N, 16) f32."""
    a0 = block8[:, 0].astype(np.float32)
    a1 = block8[:, 1].astype(np.float32)
    pal = np.zeros((len(block8), 8), np.float32)
    pal[:, 0] = a0
    pal[:, 1] = a1
    eight = a0 > a1
    for i in range(1, 7):
        pal[:, 1 + i] = np.where(
            eight, ((7 - i) * a0 + i * a1) / 7.0, pal[:, 1 + i]
        )
    for i in range(1, 5):
        pal[:, 1 + i] = np.where(
            ~eight, ((5 - i) * a0 + i * a1) / 5.0, pal[:, 1 + i]
        )
    pal[:, 6] = np.where(~eight, 0.0, pal[:, 6])
    pal[:, 7] = np.where(~eight, 255.0, pal[:, 7])

    bits = np.zeros(len(block8), np.uint64)
    for i in range(6):
        bits |= block8[:, 2 + i].astype(np.uint64) << np.uint64(8 * i)
    idx = (bits[:, None] >> (3 * np.arange(16, dtype=np.uint64))) & np.uint64(7)
    return np.take_along_axis(pal, idx.astype(np.int64), axis=1)


def decode_bc(kind: str, payload: bytes, width: int, height: int) -> np.ndarray:
    """Decode one BCn mip payload to (height, width, 4) u8."""
    bw, bh = -(-width // 4), -(-height // 4)
    n = bw * bh
    bb = _bc_block_bytes(kind)
    blocks = np.frombuffer(payload[: n * bb], np.uint8).reshape(n, bb)
    out = np.zeros((n, 16, 4), np.float32)

    if kind == "bc1":
        _decode_bc1_color(blocks, out)
    elif kind == "bc2":
        abits = np.zeros(n, np.uint64)
        for i in range(8):
            abits |= blocks[:, i].astype(np.uint64) << np.uint64(8 * i)
        a4 = ((abits[:, None] >> (4 * np.arange(16, dtype=np.uint64))) & np.uint64(15)).astype(np.float32)
        _decode_bc1_color(blocks[:, 8:], out, alpha_from=a4 * 17.0)
    elif kind == "bc3":
        alpha = _decode_bc4_channel(blocks[:, :8])
        _decode_bc1_color(blocks[:, 8:], out, alpha_from=alpha)
    elif kind == "bc4":
        r = _decode_bc4_channel(blocks)
        out[..., 0] = r
        out[..., 1] = r
        out[..., 2] = r
        out[..., 3] = 255.0
    elif kind == "bc5":
        out[..., 0] = _decode_bc4_channel(blocks[:, :8])
        out[..., 1] = _decode_bc4_channel(blocks[:, 8:])
        out[..., 2] = 0.0
        out[..., 3] = 255.0
    elif kind in ("bc6h", "bc6hs", "bc7"):
        return _decode_bcn_pillow(kind, payload, width, height)
    else:
        raise ValueError(f"unsupported block-compressed format: {kind}")

    img = (
        out.reshape(bh, bw, 4, 4, 4)
        .transpose(0, 2, 1, 3, 4)
        .reshape(bh * 4, bw * 4, 4)
    )
    return np.rint(np.clip(img[:height, :width], 0, 255)).astype(np.uint8)


def decode_ktx2(data: bytes) -> Tuple[np.ndarray, bool]:
    """KTX2 level-0 -> ((H, W, 4) u8, is_srgb). Supercompression rejected."""
    if data[:12] != _KTX2_MAGIC:
        raise ValueError("not a KTX2 file")
    (vk_format, type_size, width, height, depth, layers, faces, level_count,
     supercompression) = struct.unpack_from("<9I", data, 12)
    if supercompression not in (0, 2):
        raise ValueError(
            "unsupported KTX2 supercompression scheme "
            f"{supercompression} (only none/Zstandard; BasisLZ needs a UASTC transcoder)"
        )
    if vk_format not in _VK_FORMATS:
        raise ValueError(f"unsupported KTX2 vkFormat {vk_format}")
    kind, srgb = _VK_FORMATS[vk_format]
    # level index starts at byte 80; 3 u64 per level
    off, length, ulength = struct.unpack_from("<3Q", data, 80)
    payload = data[off : off + length]
    if supercompression == 2:
        import zstandard

        payload = zstandard.ZstdDecompressor().decompress(
            payload, max_output_size=max(int(ulength), 1)
        )
    if kind == "rgba8":
        img = np.frombuffer(payload[: width * height * 4], np.uint8).reshape(height, width, 4).copy()
    else:
        img = decode_bc(kind, payload, width, height)
    return img, srgb


_DDS_FOURCC = {
    b"DXT1": "bc1",
    b"DXT3": "bc2",
    b"DXT5": "bc3",
    b"BC4U": "bc4",
    b"ATI1": "bc4",
    b"BC5U": "bc5",
    b"ATI2": "bc5",
}
_DXGI = {
    28: ("rgba8", False), 29: ("rgba8", True),
    71: ("bc1", False), 72: ("bc1", True),
    74: ("bc2", False), 75: ("bc2", True),
    77: ("bc3", False), 78: ("bc3", True),
    80: ("bc4", False), 83: ("bc5", False),
    95: ("bc6h", False), 96: ("bc6hs", False),
    98: ("bc7", False), 99: ("bc7", True),
}


def decode_dds(data: bytes) -> Tuple[np.ndarray, bool]:
    """DDS top mip -> ((H, W, 4) u8, is_srgb)."""
    if data[:4] != b"DDS ":
        raise ValueError("not a DDS file")
    height, width = struct.unpack_from("<2I", data, 12)
    fourcc = data[84:88]
    off = 128
    srgb = False
    if fourcc == b"DX10":
        dxgi = struct.unpack_from("<I", data, 128)[0]
        if dxgi not in _DXGI:
            raise ValueError(f"unsupported DDS DXGI format {dxgi}")
        kind, srgb = _DXGI[dxgi]
        off = 148
    elif fourcc in _DDS_FOURCC:
        kind = _DDS_FOURCC[fourcc]
    else:
        # uncompressed RGBA8 via pixel-format masks (common legacy layout)
        kind = "rgba8"
    payload = data[off:]
    if kind == "rgba8":
        img = np.frombuffer(payload[: width * height * 4], np.uint8).reshape(height, width, 4).copy()
    else:
        img = decode_bc(kind, payload, width, height)
    return img, srgb
