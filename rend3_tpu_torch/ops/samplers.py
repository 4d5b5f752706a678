"""Grid samplers: kernels K3 (PCF5), K4 (weighted bilinear) and K5 (static taps).

Port of rend3_tpu/ops/mxu_gather.py sample_grid_pcf5, sample_grid_bilinear
and sample_grid, named for what they do on the GPU. On the TPU a per-pixel
gather is slow, so the JAX kernels gather by one-hot matmuls over (screen
tile, source cell) pair lists; on Hopper a gather is a load, so each CUDA
kernel (csrc/pcf5.cu, csrc/bilinear.cu, csrc/gather.cu) is one thread per
query reading its texels directly, and the pair lists, their caps, the step
queues and the pre-tiled grid stores are gone. Each wrapper runs the kernel
for CUDA tensors and the plain PyTorch version below for CPU tensors.
"""

from __future__ import annotations

import torch

__all__ = [
    "sample_grid_pcf5",
    "sample_grid_pcf5_plain",
    "sample_grid_bilinear",
    "sample_grid_bilinear_plain",
    "sample_grid",
    "sample_grid_plain",
    "PCF5_OFFSETS",
    "MAX_TAPS",
]

# The 12 texels around the base texel floor(s - 0.5) that the five bilinear
# taps of PCF5 read: dy in [-1, 2], dx in [-1, 2], minus the corners.
PCF5_OFFSETS = (
    (0, -1), (1, -1),
    (-1, 0), (0, 0), (1, 0), (2, 0),
    (-1, 1), (0, 1), (1, 1), (2, 1),
    (0, 2), (1, 2),
)

MAX_TAPS = 12  # static offsets K5 takes (csrc/gather.cu)

# Launch counts of the CUDA kernels (plain-version runs do not count).
launches = {"pcf5": 0, "bilinear": 0, "gather": 0}


def _check(tensors, shape=None):
    """Contiguous tensors of the given dtypes on one device, the query
    tensors all of one shape; returns (device, query shape)."""
    dev = tensors[0][1].device
    for name, t, dt in tensors:
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous {dt} on {dev}, got {t.dtype} on {t.device}")
    for name, t, _dt in tensors[1:]:
        if shape is None:
            shape = t.shape
        elif t.shape != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    return dev, shape


# ---------------------------------------------------------------------------
# K3: PCF5
# ---------------------------------------------------------------------------


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
    dev, shape = _check([
        ("img", img, torch.float32), ("bx", bx, torch.int32), ("by", by, torch.int32),
        ("fx", fx, torch.float32), ("fy", fy, torch.float32), ("ref", ref, torch.float32),
        ("valid", valid, torch.bool),
    ])
    if img.dim() != 2:
        raise ValueError(f"img must be 2-D, got {tuple(img.shape)}")
    if dev.type == "cpu":
        return sample_grid_pcf5_plain(img, bx, by, fx, fy, ref, valid)
    from . import cuda_kernels

    out = torch.empty(shape, dtype=torch.float32, device=dev)
    cuda_kernels.call(
        "k3_pcf5", img, bx, by, fx, fy, ref, valid, out,
        ints=(img.shape[0], img.shape[1], bx.numel()),
    )
    launches["pcf5"] += 1
    return out


# ---------------------------------------------------------------------------
# K4: weighted bilinear of 4 interleaved bf16 channels
# ---------------------------------------------------------------------------


def sample_grid_bilinear_plain(atlas, bx, by, fx, fy, wt, valid):
    """Plain version of K4: wt * bilerp(atlas, by + fy, bx + fx) for all 4
    channels, (4, *query shape) f32; 0 where a query is invalid or its 2x2
    footprint leaves the atlas (the `own` mask of mxu_gather.py:762-763).

    The JAX kernel's numerics with its default bf16 dot: texels in bf16;
    the y-weights wt*(1-fy) and wt*fy computed in f32 and rounded to bf16
    (they ride in the bf16 one-hot matrix, mxu_gather.py:768,785); the two
    y-products (exact in f32) summed in f32; the x-lerp
    (1-fx)*left + fx*right as two f32 products and one f32 add (no fma:
    XLA:CPU does not contract this reduce, found by matching bit for bit)."""
    AH, AW = atlas.shape[0], atlas.shape[1]
    own = valid & (bx >= 0) & (bx + 1 < AW) & (by >= 0) & (by + 1 < AH)
    x = torch.where(own, bx, torch.zeros_like(bx)).long().flatten()
    y = torch.where(own, by, torch.zeros_like(by)).long().flatten()
    w = torch.where(own, wt, torch.zeros_like(wt)).flatten()
    fxf, fyf = fx.flatten()[:, None], fy.flatten()[:, None]
    wy0 = (w[:, None] * (1.0 - fyf)).to(torch.bfloat16).float()
    wy1 = (w[:, None] * fyf).to(torch.bfloat16).float()

    def tex(yy, xx):
        return atlas[yy, xx].float()  # (Q, 4)

    left = tex(y, x) * wy0 + tex(y + 1, x) * wy1
    right = tex(y, x + 1) * wy0 + tex(y + 1, x + 1) * wy1
    v = (1.0 - fxf) * left + fxf * right
    v = torch.where(own.flatten()[:, None], v, torch.zeros_like(v)) + 0.0  # +0.0: no -0 out
    return v.T.reshape((4,) + tuple(bx.shape))


def sample_grid_bilinear(atlas, bx, by, fx, fy, wt, valid):
    """K4: the weighted 2x2 bilinear gather of mxu_gather.sample_grid_bilinear
    with C = 4, without the pair caps. atlas (AH, AW, 4) bf16 interleaved;
    bx, by int32 left / top tap; fx, fy f32 lerp fractions; wt f32 weight;
    valid bool, all of one query shape. Returns (4, *query shape) f32."""
    dev, shape = _check([
        ("atlas", atlas, torch.bfloat16), ("bx", bx, torch.int32), ("by", by, torch.int32),
        ("fx", fx, torch.float32), ("fy", fy, torch.float32), ("wt", wt, torch.float32),
        ("valid", valid, torch.bool),
    ])
    if atlas.dim() != 3 or atlas.shape[2] != 4:
        raise ValueError(f"atlas must be (AH, AW, 4), got {tuple(atlas.shape)}")
    if dev.type == "cpu":
        return sample_grid_bilinear_plain(atlas, bx, by, fx, fy, wt, valid)
    from . import cuda_kernels

    out = torch.empty((4,) + tuple(shape), dtype=torch.float32, device=dev)
    cuda_kernels.call(
        "k4_bilinear", atlas, bx, by, fx, fy, wt, valid, out,
        ints=(atlas.shape[0], atlas.shape[1], bx.numel()),
    )
    launches["bilinear"] += 1
    return out


# ---------------------------------------------------------------------------
# K5: static taps
# ---------------------------------------------------------------------------


def sample_grid_plain(img, bx, by, valid, offsets):
    """Plain version of K5: img[by + dy, bx + dx] for each static (dx, dy),
    (n_off, *query shape) f32; 0 where a query is invalid, its base texel
    lies outside img, or the tap does (the JAX zero padding)."""
    Hs, Ws = img.shape
    own = valid & (bx >= 0) & (bx < Ws) & (by >= 0) & (by < Hs)
    outs = []
    for dx, dy in offsets:
        x = bx + dx
        y = by + dy
        inside = own & (x >= 0) & (x < Ws) & (y >= 0) & (y < Hs)
        v = img[y.clamp(0, Hs - 1).long(), x.clamp(0, Ws - 1).long()]
        # + 0.0: the JAX kernel sums into a zeroed block, so -0 reads +0.
        outs.append(torch.where(inside, v, torch.zeros_like(v)) + 0.0)
    return torch.stack(outs)


def sample_grid(img, bx, by, valid, offsets):
    """K5: mxu_gather.sample_grid without the pair caps. img (Hs, Ws) f32;
    bx, by int32 base texel; valid bool, all of one query shape; offsets a
    static sequence of at most MAX_TAPS (dx, dy). Returns (n_off, *query
    shape) f32."""
    dev, shape = _check([
        ("img", img, torch.float32), ("bx", bx, torch.int32), ("by", by, torch.int32),
        ("valid", valid, torch.bool),
    ])
    if img.dim() != 2:
        raise ValueError(f"img must be 2-D, got {tuple(img.shape)}")
    if not 0 < len(offsets) <= MAX_TAPS:
        raise ValueError(f"K5 takes 1..{MAX_TAPS} offsets, got {len(offsets)}")
    if dev.type == "cpu":
        return sample_grid_plain(img, bx, by, valid, offsets)
    from . import cuda_kernels

    out = torch.empty((len(offsets),) + tuple(shape), dtype=torch.float32, device=dev)
    taps = [int(d) for tap in offsets for d in tap]  # by value, padded to MAX_TAPS pairs
    cuda_kernels.call(
        "k5_gather", img, bx, by, valid, out,
        ints=(img.shape[0], img.shape[1], bx.numel(), len(offsets), *taps, *(0,) * (2 * MAX_TAPS - len(taps))),
    )
    launches["gather"] += 1
    return out
