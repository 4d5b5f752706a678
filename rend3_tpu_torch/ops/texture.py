"""Texture atlas and filtered sampling.

Port of rend3_tpu/ops/texture.py for 2D textures. Every texture's mip chain
is shelf-packed, each mip with a one-texel wrapped gutter, into one atlas;
a per-(texture, mip) rect table drives bilinear / trilinear sampling with
repeat addressing, emulating `textureSampleGrad` (opaque.wgsl). The packer
and its incremental state run on the host in numpy, as in the JAX package,
so both packages place every mip at the same texel.

On the device the atlas is kept in bf16 at rest, interleaved (AH, AW, 4),
so one bilinear tap is one 8-byte load (the JAX package's default texel
type, TEX_DOT_DTYPE, and its pre-tiled store are bf16 too).

`sample_textures_grid` is the plain shading chain's sampler and the cutout
alpha test's: it turns each active slot's per-pixel uv and gradients into
two mip queries (`texture_queries`) and runs them all through one launch of
kernel K4 (samplers.sample_grid_bilinear). On the card the frame's shading
takes the same queries inside D1 (ops/lighting.py). The TPU build's
one-hot MXU lookups of the rect and mip tables become index gathers.
`sample_textures` is the scalar sampler, kept as the tests' oracle.

Cube textures (the skybox): `build_cube_array` keeps every cube's faces
and, for the sampler, the padded face grid with a replicated one-texel
border, stacked row-wise and held as the same bf16 interleaved store K4
reads; `sample_cube_grid` turns directions into face texel queries and
runs them through the same K4 entry point as the atlas. `sample_cube` is
the scalar sampler, the tests' oracle.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from ..utils.profiling import scope as profiling_scope
from .deferred import fma32, sqrt32
from .samplers import sample_grid_bilinear

__all__ = [
    "TextureArrays",
    "CubeArrays",
    "build_texture_atlas_state",
    "build_cube_array",
    "cube_arrays",
    "gutter_block",
    "ShelfState",
    "sample_textures",
    "sample_textures_grid",
    "texture_queries",
    "sample_cube",
    "sample_cube_grid",
    "MAX_MIPS",
    "NSLOT",
]

MAX_MIPS = 14
NSLOT = 10  # material texture slots (shade.TEX_* order)


class TextureArrays(NamedTuple):
    atlas: torch.Tensor       # (AH, AW, 4) bf16 linear texels
    rects: torch.Tensor       # (N+1, MAX_MIPS, 4) f32: x, y, w, h texels
    mip_counts: torch.Tensor  # (N+1,) int32 (slot 0 = null texture)


class CubeArrays(NamedTuple):
    faces: torch.Tensor       # (N+1, 6, E, E, 4) f32 (slot 0 empty), for the scalar sampler
    sizes: torch.Tensor       # (N+1,) int32 actual face extent
    # K4's store: every face padded with a replicated one-texel border and
    # stacked row-wise, ((N+1)*6*(E+2), E+2, 4) bf16 interleaved.
    store: torch.Tensor


def _shelf_pack(sizes):
    """Simple shelf packer; sizes: [(w, h)] -> (positions, (W, H)) pow2 square-ish."""
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i][1])
    total_area = sum(w * h for w, h in sizes) or 1
    side = 1
    while side * side < total_area * 1.2:
        side *= 2
    while True:
        pos = [None] * len(sizes)
        x = y = shelf_h = 0
        ok = True
        for i in order:
            w, h = sizes[i]
            if w > side:
                ok = False
                break
            if x + w > side:
                x = 0
                y += shelf_h
                shelf_h = 0
            if y + h > side:
                ok = False
                break
            pos[i] = (x, y)
            x += w
            shelf_h = max(shelf_h, h)
        if ok:
            return pos, (side, side)
        side *= 2


def gutter_block(mip: np.ndarray) -> np.ndarray:
    """(h+2, w+2, 4) block: the mip surrounded by a 1-texel WRAPPED gutter,
    so bilinear taps at rect edges (including the floor tap at -1) read the
    repeat-addressed texel with plain +0/+1 offsets."""
    h, w = mip.shape[0], mip.shape[1]
    g = np.zeros((h + 2, w + 2, 4), dtype=np.float32)
    g[1 : h + 1, 1 : w + 1] = mip
    g[0, 1 : w + 1] = mip[h - 1]
    g[h + 1, 1 : w + 1] = mip[0]
    g[:, 0] = g[:, w]
    g[:, w + 1] = g[:, 1]
    return g


class ShelfState:
    """Incremental shelf packer state (texture atlas placements)."""

    def __init__(self, side: int = 4):
        self.side = side
        self.x = 0
        self.y = 0
        self.shelf_h = 0

    def place(self, w: int, h: int):
        """(x, y) for a w x h block, or None when the atlas is full."""
        if w > self.side:
            return None
        if self.x + w > self.side:
            self.x = 0
            self.y += self.shelf_h
            self.shelf_h = 0
        if self.y + h > self.side:
            return None
        pos = (self.x, self.y)
        self.x += w
        self.shelf_h = max(self.shelf_h, h)
        return pos


def build_texture_atlas_state(textures: Dict[int, object]):
    """Full shelf pack of every texture's gutter-bordered mips. Returns
    (atlas np f32, rects np, mip_counts np, ShelfState); the state lets the
    manager place later adds incrementally."""
    n_slots = (max(textures.keys()) + 1) if textures else 0
    entries = []  # (slot, mip, array)
    sizes = []
    for idx, t in textures.items():
        for mi, mip in enumerate(t.mips[:MAX_MIPS]):
            entries.append((idx, mi, mip))
            sizes.append((mip.shape[1] + 2, mip.shape[0] + 2))
    if entries:
        pos, (W, H) = _shelf_pack(sizes)
    else:
        pos, (W, H) = [], (4, 4)

    atlas = np.zeros((H, W, 4), dtype=np.float32)
    rects = np.zeros((n_slots + 1, MAX_MIPS, 4), dtype=np.float32)
    mip_counts = np.zeros(n_slots + 1, dtype=np.int32)
    max_y = 0
    for (idx, mi, mip), p in zip(entries, pos):
        x, y = p
        h, w = mip.shape[0], mip.shape[1]
        atlas[y : y + h + 2, x : x + w + 2] = gutter_block(mip)
        rects[idx + 1, mi] = (x + 1, y + 1, w, h)
        mip_counts[idx + 1] = max(mip_counts[idx + 1], mi + 1)
        max_y = max(max_y, y + h + 2)
    # Later adds continue on a fresh shelf below everything the full pack
    # used (sorted-shelf rows are not resumable exactly).
    state = ShelfState(side=W)
    state.y = max_y
    return atlas, rects, mip_counts, state


def _bilinear_from_rect(atlas, rect, u, v):
    """Bilinear sample of atlas (AH, AW, 4) f32 at repeat-addressed uv
    inside rect (N, 4); returns (N, 4)."""
    rx, ry, rw, rh = rect.unbind(-1)
    uu = u - torch.floor(u)
    vv = v - torch.floor(v)
    xf = uu * rw - 0.5
    yf = vv * rh - 0.5
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    fx = (xf - x0)[:, None]
    fy = (yf - y0)[:, None]
    zero = torch.zeros_like(rw)

    def fetch(xi, yi):
        xi = torch.where(rw > 0, torch.remainder(xi, torch.clamp_min(rw, 1.0)), zero)
        yi = torch.where(rh > 0, torch.remainder(yi, torch.clamp_min(rh, 1.0)), zero)
        ax = (rx + xi).to(torch.int32).clamp(0, atlas.shape[1] - 1).long()
        ay = (ry + yi).to(torch.int32).clamp(0, atlas.shape[0] - 1).long()
        return atlas[ay, ax]

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def _nearest_from_rect(atlas, rect, u, v):
    rx, ry, rw, rh = rect.unbind(-1)
    uu = u - torch.floor(u)
    vv = v - torch.floor(v)
    xi = torch.minimum(torch.floor(uu * rw), rw - 1)
    yi = torch.minimum(torch.floor(vv * rh), rh - 1)
    ax = (rx + xi).to(torch.int32).clamp(0, atlas.shape[1] - 1).long()
    ay = (ry + yi).to(torch.int32).clamp(0, atlas.shape[0] - 1).long()
    return atlas[ay, ax]


def _log2(x: torch.Tensor) -> torch.Tensor:
    """log(x) / log(2) in float32, the form jnp.log2 takes."""
    with profiling_scope("sync::const.texture_ln2"):
        two = torch.tensor(2.0, dtype=x.dtype, device=x.device)
    return torch.log(x) / torch.log(two)


def sample_textures(tex: TextureArrays, slots, uv, duv, mflags) -> torch.Tensor:
    """Scalar textureSampleGrad over the atlas (texture.py:347-385).

    slots: (N,) 1-based texture ids (0 = none -> 1.0, an unbound white
    texture); uv: (N, 2); duv: (N, 2, 2) or None; mflags for the NEAREST
    material flag. Returns (N, 4). Texels are read in f32 from the bf16
    atlas."""
    from .shade import MF  # local import to avoid a cycle

    atlas = tex.atlas.float()
    s = slots.clamp(0, tex.rects.shape[0] - 1).long()
    nmips = torch.clamp_min(tex.mip_counts[s], 1)
    if duv is not None:
        base_rect = tex.rects[s, 0]
        twh = base_rect[:, 2:4]
        dx = duv[:, 0] * twh
        dy = duv[:, 1] * twh
        rho = torch.maximum(sqrt32((dx * dx).sum(-1)), sqrt32((dy * dy).sum(-1)))
        lam = _log2(torch.clamp_min(rho, 1e-12))
        lam = torch.minimum(torch.clamp_min(lam, 0.0), (nmips - 1).float())
    else:
        lam = torch.zeros(uv.shape[0], dtype=torch.float32, device=uv.device)
    l0 = torch.floor(lam)
    lf = (lam - l0)[:, None]
    l0i = l0.long().clamp(0, MAX_MIPS - 1)  # a NaN lambda reads mip 0
    l1i = torch.minimum(l0i + 1, (nmips - 1).long())
    u, v = uv[:, 0], uv[:, 1]
    nearest = (mflags & MF.NEAREST) != 0
    r0 = tex.rects[s, l0i]
    r1 = tex.rects[s, l1i]
    c_lin = _bilinear_from_rect(atlas, r0, u, v) * (1 - lf) + _bilinear_from_rect(atlas, r1, u, v) * lf
    c_near = _nearest_from_rect(atlas, r0, u, v)
    out = torch.where(nearest[:, None], c_near, c_lin)
    return torch.where((slots > 0)[:, None], out, torch.ones_like(out))


def texture_queries(
    tex: TextureArrays,
    mtex: torch.Tensor,      # (NSLOT, N) 1-based texture ids
    coords: torch.Tensor,    # (2, N) uv
    duv,                     # (4, N) rows [du/dx, dv/dx, du/dy, dv/dy], or None
    mflags: torch.Tensor,    # (N,) material flags
    active_slots,            # slot indices to sample
    hit: torch.Tensor = None,  # optional (N,) bool: sample only these pixels
):
    """K4's arguments for sample_textures_grid (texture.py:416-557): every
    active slot's trilinear lookup as two mip queries (the mip lerp weight
    rides in each query's weight), slot i's at rows 2 i and 2 i + 1 of each
    (2 * n_active, N) query tensor."""
    from .shade import MF  # local import to avoid a cycle

    S = tex.rects.shape[0]
    N = coords.shape[1]
    u, v = coords[0], coords[1]
    uu = u - torch.floor(u)
    vv = v - torch.floor(v)
    nearest = (mflags & MF.NEAREST) != 0
    one = torch.ones((), dtype=torch.float32, device=coords.device)
    zero = torch.zeros((), dtype=torch.float32, device=coords.device)
    minus_half = torch.full((), -0.5, dtype=torch.float32, device=coords.device)

    q_bx, q_by, q_fx, q_fy, q_wt, q_valid = [], [], [], [], [], []
    for q in active_slots:
        slv = mtex[q]
        s = slv.clamp(0, S - 1).long()
        nmips = torch.clamp_min(tex.mip_counts[s].float(), 1.0)
        if duv is not None:
            tw, th = tex.rects[s, 0, 2], tex.rects[s, 0, 3]
            dxu, dxv = duv[0] * tw, duv[1] * th
            dyu, dyv = duv[2] * tw, duv[3] * th
            rho = torch.maximum(sqrt32(dxu * dxu + dxv * dxv), sqrt32(dyu * dyu + dyv * dyv))
            lam = torch.minimum(torch.clamp_min(_log2(torch.clamp_min(rho, 1e-12)), 0.0), nmips - 1.0)
        else:
            lam = torch.zeros(N, dtype=torch.float32, device=coords.device)
        l0 = torch.floor(lam)
        lf = lam - l0
        # A NaN lambda (degenerate gradients) reads mip 0, as the JAX
        # package's level select does (texture.py:502-506).
        l0i = l0.long().clamp(0, MAX_MIPS - 1)
        l1i = torch.minimum(l0i + 1, (nmips - 1.0).long())

        valid0 = (slv > 0) if hit is None else ((slv > 0) & hit)
        for k, (li, wt) in enumerate(
            ((l0i, torch.where(nearest, one, 1.0 - lf)), (l1i, torch.where(nearest, zero, lf)))
        ):
            rx, ry, rw, rh = tex.rects[s, li].unbind(-1)
            # linear: floor tap of uu*rw - 0.5 (may be -1 -> left gutter),
            # as one fma: the form XLA:CPU gives the JAX sampler (found by
            # matching bit for bit).
            xf = fma32(uu, rw, minus_half)
            yf = fma32(vv, rh, minus_half)
            x0 = torch.floor(xf)
            y0 = torch.floor(yf)
            # nearest: the texel itself, zero fractions
            xn = torch.minimum(torch.floor(uu * rw), rw - 1.0)
            yn = torch.minimum(torch.floor(vv * rh), rh - 1.0)
            q_bx.append((torch.where(nearest, xn, x0) + rx).to(torch.int32))
            q_by.append((torch.where(nearest, yn, y0) + ry).to(torch.int32))
            q_fx.append(torch.where(nearest, zero, xf - x0))
            q_fy.append(torch.where(nearest, zero, yf - y0))
            q_wt.append(wt)
            q_valid.append(valid0 if k == 0 else (valid0 & ~nearest & (lf > 0.0)))
    return (tex.atlas, *(torch.stack(a) for a in (q_bx, q_by, q_fx, q_fy, q_wt, q_valid)))


def sample_textures_grid(
    tex: TextureArrays,
    mtex: torch.Tensor,      # (NSLOT, N) 1-based texture ids
    coords: torch.Tensor,    # (2, N) uv
    duv,                     # (4, N) rows [du/dx, dv/dx, du/dy, dv/dy], or None
    mflags: torch.Tensor,    # (N,) material flags
    active_slots,            # slot indices to sample
    *,
    hit: torch.Tensor = None,  # optional (N,) bool: sample only these pixels
    capture: dict = None,      # optional: receives the K4 launch's inputs
):
    """Deferred textureSampleGrad, planar (texture.py:416-557).

    Every active slot's two mip queries (texture_queries) go through one K4
    launch; a slot's two results are summed. Returns a list of NSLOT
    entries: (4, N) samples for active slots (1.0 where the slot holds no
    texture) and None for inactive ones."""
    if not active_slots:
        return [None] * NSLOT
    args = texture_queries(tex, mtex, coords, duv, mflags, active_slots, hit)
    if capture is not None:
        capture["bilinear"] = args
    out = sample_grid_bilinear(*args)  # (4, 2 * n_active, N)
    samples = [None] * NSLOT
    for i, q in enumerate(active_slots):
        res = out[:, 2 * i] + out[:, 2 * i + 1]
        samples[q] = torch.where((mtex[q] > 0)[None, :], res, torch.ones_like(res))
    return samples


# ---------------------------------------------------------------------------
# Cube textures (the skybox)
# ---------------------------------------------------------------------------


def build_cube_array(textures: Dict[int, object], device="cpu"):
    """CubeArrays of every cube texture's base level (texture.py:184-224),
    or None without cube textures. Slot idx + 1 holds texture idx."""
    if not textures:
        return None
    n_slots = max(textures.keys()) + 1
    ext = max(t.mips[0].shape[1] for t in textures.values())
    faces = np.zeros((n_slots + 1, 6, ext, ext, 4), dtype=np.float32)
    sizes = np.zeros(n_slots + 1, dtype=np.int32)
    for idx, t in textures.items():
        e = t.mips[0].shape[1]
        faces[idx + 1, :, :e, :e] = t.mips[0]
        sizes[idx + 1] = e
    return cube_arrays(faces, sizes, device)


def cube_arrays(faces: np.ndarray, sizes: np.ndarray, device="cpu"):
    """CubeArrays from (N+1, 6, E, E, 4) f32 faces and (N+1,) sizes: the
    faces, and K4's store of every face padded with a replicated border
    (the scalar sampler clamps each tap to [0, e-1]; with base bx / by =
    tap0 + 1 in [0, e] the taps stay inside the padded block and read the
    same clamped texels)."""
    P = faces.shape[2] + 2
    grid = np.zeros(faces.shape[:2] + (P, P, 4), dtype=np.float32)
    for slot, e in enumerate(np.asarray(sizes).tolist()):
        if e == 0:
            continue
        f = faces[slot, :, :e, :e]
        g = grid[slot]
        g[:, 1 : e + 1, 1 : e + 1] = f
        g[:, 0, 1 : e + 1] = f[:, 0]
        g[:, e + 1, 1 : e + 1] = f[:, e - 1]
        g[:, :, 0] = g[:, :, 1]
        g[:, :, e + 1] = g[:, :, e]
    with profiling_scope("sync::upload.cube"):
        faces_t = torch.tensor(faces, dtype=torch.float32, device=device)
    with profiling_scope("sync::upload.cube"):
        sizes_t = torch.tensor(sizes, dtype=torch.int32, device=device)
    with profiling_scope("sync::upload.cube"):
        store = torch.from_numpy(grid.reshape(-1, P, 4)).to(device).to(torch.bfloat16)
    return CubeArrays(faces=faces_t, sizes=sizes_t, store=store)


def _cube_face_coords(cube: CubeArrays, slot: int, dirs: torch.Tensor):
    """Face selection and in-face texel coordinates of (N, 3) directions
    (texture.py:227-244): (face (N,) int64, xf, yf (N,) f32, unfloored).
    `u * e - 0.5` is one fma, the form XLA:CPU gives the JAX frame."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)

    def pick(a, b):
        return torch.where(is_x, a, b)

    def sel(c, a, b):
        with profiling_scope("sync::const.cube_faces"):
            ta = torch.as_tensor(a, device=dirs.device)
        with profiling_scope("sync::const.cube_faces"):
            tb = torch.as_tensor(b, device=dirs.device)
        return torch.where(c, ta, tb)

    face = pick(sel(x > 0, 0, 1), torch.where(is_y, sel(y > 0, 2, 3), sel(z > 0, 4, 5)))
    ma = torch.clamp_min(pick(ax, torch.where(is_y, ay, az)), 1e-20)
    uc = pick(torch.where(x > 0, -z, z), torch.where(is_y, x, torch.where(z > 0, x, -x)))
    vc = torch.where(is_y, torch.where(y > 0, z, -z), -y)
    u = 0.5 * (uc / ma + 1.0)
    v = 0.5 * (vc / ma + 1.0)
    e = cube.sizes[slot].float()
    minus_half = torch.full((), -0.5, dtype=torch.float32, device=dirs.device)
    return face.long(), fma32(u, e, minus_half), fma32(v, e, minus_half)


def sample_cube(cube: CubeArrays, slot: int, dirs: torch.Tensor) -> torch.Tensor:
    """Scalar bilinear cube sample with clamped taps, wgpu face order +X,
    -X, +Y, -Y, +Z, -Z (texture.py:388-413): (N, 3) directions -> (N, 4)
    from the f32 faces."""
    face, xf, yf = _cube_face_coords(cube, slot, dirs)
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    fx = (xf - x0)[:, None]
    fy = (yf - y0)[:, None]
    faces = cube.faces[slot]
    e = int(cube.sizes[slot])

    def fetch(xi, yi):
        return faces[face, yi.long().clamp(0, e - 1), xi.long().clamp(0, e - 1)]

    top = fetch(x0, y0) * (1 - fx) + fetch(x0 + 1, y0) * fx
    bot = fetch(x0, y0 + 1) * (1 - fx) + fetch(x0 + 1, y0 + 1) * fx
    return top * (1 - fy) + bot * fy


def sample_cube_grid(cube: CubeArrays, slot: int, dirs_list, valid_list=None, *, capture: dict = None):
    """Cube bilinear sampling through K4 (texture.py:247-303): every entry's
    (N, 3) directions become queries into the padded face grid (base texel
    floor + 1, so the replicated border stands in for the clamp), all
    entries in one launch. Returns a list of (N, 4) samples; 0 where an
    entry's optional (N,) bool valid mask is false."""
    P = cube.store.shape[1]
    q_bx, q_by, q_fx, q_fy, q_valid = [], [], [], [], []
    for i, dirs in enumerate(dirs_list):
        face, xf, yf = _cube_face_coords(cube, slot, dirs)
        x0 = torch.floor(xf)
        y0 = torch.floor(yf)
        q_bx.append((x0.to(torch.int32) + 1))
        q_by.append(((slot * 6 + face) * P + y0.long() + 1).to(torch.int32))
        q_fx.append(xf - x0)
        q_fy.append(yf - y0)
        v = None if valid_list is None else valid_list[i]
        q_valid.append(torch.ones_like(xf, dtype=torch.bool) if v is None else v)
    bx, by, fx, fy, valid = (torch.cat(a) for a in (q_bx, q_by, q_fx, q_fy, q_valid))
    args = (cube.store, bx, by, fx, fy, torch.ones_like(fx), valid)
    if capture is not None:
        capture["bilinear"] = args
    out = sample_grid_bilinear(*args)  # (4, sum N)
    return list(out.T.split([int(d.shape[0]) for d in dirs_list]))
