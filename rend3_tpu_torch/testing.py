"""Test harness (counterpart of rend3-test), port of rend3_tpu/testing.py.

The runner renders through the port's Renderer on the device it is given and
reads the same wgpu goldens as the JAX package's harness. Reference: rend3-test/src/runner.rs — a TestRunner that builds the full
renderer + base graph, renders one frame offscreen, and compares against
golden images with thresholds; helpers.rs scene builders (plane/cube/lights).
Goldens are the *wgpu reference renders* checked into the reference repo —
the cross-implementation oracle.
"""

from __future__ import annotations

import base64
import json
import os
import struct
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np

from . import anim
from .core.renderer import Renderer
from .framework import App
from .gltf.loader import GltfLoadSettings, load_gltf
from .routine.base import BaseRenderGraph, BaseRenderGraphSettings, FrameRenderTarget
from .routine.pbr.material import AlbedoComponent, PbrMaterial
from .types import (
    Camera,
    DirectionalLight,
    Handedness,
    MeshBuilder,
    Object,
    Perspective,
    StaticMeshKind,
)
from .utils import math as m3
from .utils.compare import compare_images

__all__ = ["TestRunner", "FrameRenderSettings", "Threshold", "compare_to_golden", "REFERENCE_RESULTS"]

# Directory of the reference's golden images (rend3-test/tests/results);
# relative golden names resolve against it.
REFERENCE_RESULTS = os.environ.get("REND3_REFERENCE_RESULTS", "")


@dataclass
class FrameRenderSettings:
    """reference: runner.rs:20-46 (64x64 default, size % 64 == 0)."""

    size: int = 64
    samples: int = 1

    def __post_init__(self):
        assert self.size % 64 == 0, "size must be a multiple of 64"


@dataclass
class Threshold:
    """Pass criteria against a golden. Every set bound must hold; at least
    one bound must be set — "no checks means it always fails", the
    reference's rule (rend3-test/src/threshold.rs:8-14). `mae`/`ssim` are
    this harness's native bounds; `flip` bounds the mean FLIP perceptual
    error and `flip_percentiles` is the reference's `Threshold::Percentile`
    (threshold.rs:22-46): ((percentile, bound), ...) pairs over the
    per-pixel FLIP error map, e.g. ((50.0, 0.04),) = FLIP P50 <= 0.04 (the
    shadow-test gate, rend3-test/tests/shadow.rs:33)."""

    mae: float = 0.01
    ssim: float = 0.98
    flip: float = None
    flip_percentiles: tuple = ()


def load_png(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def save_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    arr = np.asarray(img)
    if arr.shape[-1] == 4:
        arr = arr[..., :3]
    Image.fromarray(arr).save(path)


def compare_to_golden(test_img: np.ndarray, golden_path: str, threshold: Threshold, out_dir: str = "tests/output"):
    if not os.path.exists(golden_path):
        # Reference semantics (runner.rs:235-239): a missing golden is
        # created from this render and the test passes.
        save_png(golden_path, test_img)
        return {"created": True}
    golden = load_png(golden_path)
    stats = compare_images(test_img[..., :3], golden)
    name = os.path.splitext(os.path.basename(golden_path))[0]
    os.makedirs(out_dir, exist_ok=True)
    save_png(os.path.join(out_dir, f"{name}-render.png"), test_img)
    checks = []  # "no checks = fail" (ref threshold.rs:8-14)
    if threshold.mae is not None:
        checks.append(stats["mae"] <= threshold.mae)
    if threshold.ssim is not None:
        checks.append(stats["ssim"] >= threshold.ssim)
    if threshold.flip is not None or threshold.flip_percentiles:
        from .utils.flip import flip

        err = flip(golden, test_img[..., :3])
        stats["flip"] = float(err.mean())
        if threshold.flip is not None:
            checks.append(stats["flip"] <= threshold.flip)
        for pct, bound in threshold.flip_percentiles:
            v = float(np.percentile(err, pct))
            stats[f"flip_p{pct:g}"] = v
            checks.append(v <= bound)
    ok = bool(checks) and all(checks)
    assert ok, (
        f"golden mismatch vs {golden_path}: {stats} (threshold {threshold})"
        if checks
        else f"threshold has no checks (always fails, ref threshold.rs:8-14): {threshold}"
    )
    return stats


class TestRunner:
    __test__ = False  # not a pytest class

    def __init__(self, handedness: Handedness = Handedness.LEFT, device="cuda"):
        self.renderer = Renderer(handedness=handedness, device=device)
        self.base_graph = BaseRenderGraph(self.renderer)

    # -- reference helpers.rs ------------------------------------------------

    def add_mesh(self, mesh):
        return self.renderer.add_mesh(mesh)

    def add_object(self, obj: Object):
        return self.renderer.add_object(obj)

    def set_camera_data(self, camera: Camera):
        self.renderer.set_camera_data(camera)

    def add_unlit_material(self, color):
        return self.renderer.add_material(
            PbrMaterial(albedo=AlbedoComponent.new_value(np.asarray(color, np.float32)), unlit=True)
        )

    def add_lit_material(self, color):
        return self.renderer.add_material(
            PbrMaterial(albedo=AlbedoComponent.new_value(np.asarray(color, np.float32)), unlit=False)
        )

    def add_directional_light(self, direction):
        return self.renderer.add_directional_light(
            DirectionalLight(color=np.ones(3), resolution=256, distance=5.0, intensity=1.0, direction=direction)
        )

    def plane(self, material, transform):
        mesh = (
            MeshBuilder(
                np.array(
                    [[-1.0, -1.0, 0.0], [-1.0, 1.0, 0.0], [1.0, 1.0, 0.0], [1.0, -1.0, 0.0]], np.float32
                ),
                Handedness.LEFT,
            )
            .with_indices(np.array([0, 2, 1, 0, 3, 2], np.uint32))
            .build()
        )
        return self.add_object(
            Object(mesh_kind=StaticMeshKind(self.add_mesh(mesh)), material=material, transform=transform)
        )

    def cube(self, material, transform):
        # reference: helpers.rs cube() vertex/index data (a [-1, 1] cube).
        p = np.array(
            [
                [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],       # far
                [-1, 1, -1], [1, 1, -1], [1, -1, -1], [-1, -1, -1],   # near
                [1, -1, -1], [1, 1, -1], [1, 1, 1], [1, -1, 1],       # right
                [-1, -1, 1], [-1, 1, 1], [-1, 1, -1], [-1, -1, -1],   # left
                [1, 1, -1], [-1, 1, -1], [-1, 1, 1], [1, 1, 1],       # top
                [1, -1, 1], [-1, -1, 1], [-1, -1, -1], [1, -1, -1],   # bottom
            ],
            np.float32,
        )
        idx = np.array(
            [0, 1, 2, 2, 3, 0, 4, 5, 6, 6, 7, 4, 8, 9, 10, 10, 11, 8,
             12, 13, 14, 14, 15, 12, 16, 17, 18, 18, 19, 16, 20, 21, 22, 22, 23, 20],
            np.uint32,
        )
        mesh = MeshBuilder(p, Handedness.LEFT).with_indices(idx).build()
        return self.add_object(
            Object(mesh_kind=StaticMeshKind(self.add_mesh(mesh)), material=material, transform=transform)
        )

    # -- frame ----------------------------------------------------------------

    def render_frame(self, settings: FrameRenderSettings = None) -> np.ndarray:
        settings = settings or FrameRenderSettings()
        self.renderer.swap_instruction_buffers()
        eval_output = self.renderer.evaluate_instructions()
        return self.base_graph.render_frame(
            eval_output,
            FrameRenderTarget(settings.size, settings.size, settings.samples),
            BaseRenderGraphSettings(ambient_color=(0, 0, 0, 0), clear_color=(0, 0, 0, 0)),
        )

    def render_and_compare(self, settings: FrameRenderSettings, golden: str, threshold: Threshold):
        img = self.render_frame(settings)
        if not os.path.isabs(golden) and not REFERENCE_RESULTS:
            raise ValueError("relative golden name: set REND3_REFERENCE_RESULTS or pass an absolute path")
        path = golden if os.path.isabs(golden) else os.path.join(REFERENCE_RESULTS, golden)
        return compare_to_golden(img, path, threshold)


# ---------------------------------------------------------------------------
# A stress input for the raster kernels K1 and K2
# ---------------------------------------------------------------------------

STRESS_W, STRESS_H = 256, 128


def raster_stress_input(seed: int = 0, width: int = STRESS_W, height: int = STRESS_H):
    """Clip-space triangles (T, 3, 4) f32 and per-triangle plane rows
    (T, PLANES_W) f32, from a numpy generator, that press the raster
    kernels' list walk over 32x128 tiles:

    - a 10x5 grid of 24-pixel quads at w = 1 whose corners, edges and
      diagonals pass through pixel centres (the top-left rule decides
      those pixels), across the 32-pixel quarter-tile and 4-row warp
      boundaries;
    - 2,800 small triangles (2 to 6 pixels) of random depth and w, three in
      four left of x = 128, so the left tiles list more than 256 entries and
      the right ones more than 128 (one staging chunk), most of which a
      given warp's bbox test skips;
    - coplanar duplicates, equal in depth at every pixel, later in the list:
      of 60 grid triangles (20 of them twice) at random later positions, so
      the later entry must win across quarter, 128-entry chunk and 32-entry
      ballot boundaries; of 200 small triangles, half right after their
      original (the same ballot); of 6 of 12 large triangles (30 to 100
      pixels across, spanning tiles).

    The list order is the row order: the grid first, then the rest
    shuffled. A duplicate's plane row has its own material, 100 + its row,
    so the material channel shows where a duplicate won."""
    from .ops.deferred import P_MAT, PLANES_W

    rng = np.random.default_rng(seed)

    def to_clip(xs, ys, z, w):
        cx = (xs / width - 0.5) * 2.0 * w
        cy = (0.5 - ys / height) * 2.0 * w
        return np.stack([cx, cy, z * w, w], axis=-1).astype(np.float32)

    def around(n, lo, hi, left_share):
        """n triangles of radius in [lo, hi) about random centres."""
        left = rng.random(n) < left_share
        cx = np.where(left, rng.uniform(-2.0, width / 2, n), rng.uniform(width / 2, width + 2.0, n))
        cy = rng.uniform(-2.0, height + 2.0, n)
        ang = rng.uniform(0.0, 2.0 * np.pi, (n, 3))
        rad = rng.uniform(lo, hi, (n, 1)) * rng.uniform(0.5, 1.0, (n, 3))
        return cx[:, None] + rad * np.cos(ang), cy[:, None] + rad * np.sin(ang)

    quads = []
    for j in range(5):
        for i in range(10):
            x0, y0 = 4.5 + 24 * i, 4.5 + 24 * j
            a, b, c, d = (x0, y0), (x0 + 24, y0), (x0 + 24, y0 + 24), (x0, y0 + 24)
            quads += [(a, b, c), (a, c, d)]
    g = np.array(quads, np.float64)
    zg = 0.3 + 0.0005 * g[..., 0] + 0.0007 * g[..., 1]
    grid = to_clip(g[..., 0], g[..., 1], zg, np.ones_like(zg))
    xs, ys = around(2800, 1.0, 3.0, 0.75)
    small = to_clip(xs, ys, rng.uniform(0.05, 0.9, xs.shape), rng.uniform(0.8, 1.25, xs.shape))
    xs, ys = around(12, 15.0, 50.0, 0.5)
    large = to_clip(xs, ys, rng.uniform(0.2, 0.7, xs.shape), rng.uniform(0.9, 1.1, xs.shape))

    # The rest of the list sorts by key; a later duplicate of row k gets a
    # key past k's (1e-9 past it: the next entry).
    rest = np.concatenate([small, large])
    key = rng.random(rest.shape[0])
    rows, keys = [rest], [key]
    gdup = rng.choice(grid.shape[0], 60, replace=False)
    gdup = np.concatenate([gdup, gdup[:20]])
    rows.append(grid[gdup])
    keys.append(rng.random(gdup.shape[0]))
    sdup = rng.choice(small.shape[0], 200, replace=False)
    ldup = small.shape[0] + rng.choice(large.shape[0], 6, replace=False)
    later = np.concatenate([sdup[100:], ldup])
    rows += [rest[sdup[:100]], rest[later]]
    keys += [key[sdup[:100]] + 1e-9, key[later] + rng.random(later.shape[0]) * (1.0 - key[later])]
    order = np.argsort(np.concatenate(keys), kind="stable")
    rows = np.concatenate(rows)
    clip = np.concatenate([grid, rows[order]]).astype(np.float32)
    is_dup = np.concatenate([np.zeros(grid.shape[0], bool), (np.arange(rows.shape[0]) >= rest.shape[0])[order]])

    planes = rng.standard_normal((clip.shape[0], PLANES_W)).astype(np.float32)
    planes[:, P_MAT] = rng.integers(0, 9, clip.shape[0]).astype(np.float32)
    planes[is_dup, P_MAT] = 100.0 + np.flatnonzero(is_dup)
    return clip, planes


def raster_stress_case(device="cuda", seed: int = 0) -> dict:
    """raster_stress_input through the port's front end on `device`: the
    setup table (tris), its plane rows (planes), the 32x128 CSR tile lists
    (binned), width, height, the peel images (bound, floor) from the
    plain K1's opaque pass, and K6's inputs: vis[S] = (setup table, 8x128
    CSR tile lists) at S = 1 and 4 samples, set up as raster_scene does
    (the sub-pixel cull at one sample only)."""
    import torch

    from .ops import deferred as D
    from .ops import geometry as G

    clip, planes = raster_stress_input(seed)
    dev = torch.device(device)
    c = torch.from_numpy(clip).to(dev)
    tris = G.cull_and_setup(
        c, torch.ones(c.shape[0], dtype=torch.bool, device=dev), STRESS_W, STRESS_H,
        cull_mode=G.CullMode.NONE, front_is_cw=True, subpixel=True,
    )
    pl = torch.from_numpy(planes).to(dev)[tris.src].contiguous()
    binned = G.bin_triangles(tris, STRESS_W, STRESS_H, tile_h=D.DTILE_H, tile_w=D.DTILE_W)
    # Peel images from the opaque depth: the depth itself at hit pixels, so
    # fragments tie them exactly, 0 (bound) or -1 (floor) elsewhere, and a
    # third of the pixels at random depths.
    g0 = D.raster_resolve_plain(tris, pl, binned, STRESS_W, STRESS_H)
    depth, hit = g0[D.G_DEPTH].cpu().numpy(), (g0[D.G_HIT] > 0).cpu().numpy()
    rng = np.random.default_rng(seed + 1)
    noise = rng.random(depth.shape) < 0.33
    rand = rng.uniform(0.0, 0.7, depth.shape).astype(np.float32)
    bound = np.where(noise, rand, np.where(hit, depth, 0.0)).astype(np.float32)
    floor = np.where(noise, rand, np.where(hit, depth, -1.0)).astype(np.float32)
    vis = {}
    for samples in (1, 4):
        vt = tris if samples == 1 else G.cull_and_setup(
            c, torch.ones(c.shape[0], dtype=torch.bool, device=dev), STRESS_W, STRESS_H,
            cull_mode=G.CullMode.NONE, front_is_cw=True, subpixel=False,
        )
        vis[samples] = (vt, G.bin_triangles(vt, STRESS_W, STRESS_H, tile_h=G.TILE_H, tile_w=G.TILE_W))
    return dict(
        tris=tris, planes=pl, binned=binned, width=STRESS_W, height=STRESS_H,
        bound=torch.from_numpy(bound).to(dev), floor=torch.from_numpy(floor).to(dev), vis=vis,
    )


# ---------------------------------------------------------------------------
# A stress input for the map-free shadow occlusion K7 and K8
# ---------------------------------------------------------------------------

SHADOW_STRESS_W, SHADOW_STRESS_H, SHADOW_STRESS_SIZE = 256, 64, 256


def shadow_stress_input(seed: int = 0):
    """Caster triangles in light clip space (T, 3, 4) f32 for a
    SHADOW_STRESS_SIZE² light, and the light-space coordinates sx, sy and
    hit mask (H, W) of a SHADOW_STRESS_W x SHADOW_STRESS_H screen, its four
    32x128 tiles (row-major) each pressing one path of the occlusion
    kernels, from a numpy generator:

    - tile 0: every pixel hit, a depth discontinuity: its left half maps
      to about 22 x 10 texels at one corner of a 190 x 100 texel rect, its
      right half to the opposite corner (0.35 texels a pixel, sub-texel
      noise), and 5,000 small casters (2 to 12 texels across) fill the
      rect in random order: its rect list spans several of the CUDA
      kernel's 2,048-entry segments, nearly all of it far from any warp's
      pixels, and a pixel's casters fall in every segment; its light-cell
      list holds only the casters near the two corners;
    - tile 1: no hit pixel (its coordinates lie over the casters all the
      same): no list;
    - tile 2: every pixel hit, over texels where no caster lies: an empty
      rect list at hit pixels, whose values must be 0;
    - tile 3: hit pixels only in its left 64 columns and, there, rows 32 to
      43 (so some of the CUDA kernel's 8x32 pixel blocks and 4x8 warp
      blocks have none, and some warps are hit in part),
      over 300 casters of their own.

    Casters have random winding and random depth in (0.05, 0.95), but for
    40 with depth 0 at every vertex, so exactly 0 at every tap they cover."""
    rng = np.random.default_rng(seed)
    size = SHADOW_STRESS_SIZE
    W, H = SHADOW_STRESS_W, SHADOW_STRESS_H

    def casters(n, x0, x1, y0, y1, lo, hi):
        cx, cy = rng.uniform(x0, x1, n), rng.uniform(y0, y1, n)
        ang = rng.uniform(0.0, 2.0 * np.pi, (n, 3))
        rad = rng.uniform(lo, hi, (n, 1)) * rng.uniform(0.5, 1.0, (n, 3))
        return cx[:, None] + rad * np.cos(ang), cy[:, None] + rad * np.sin(ang)

    xa, ya = casters(5000, 18.0, 212.0, 18.0, 118.0, 2.0, 6.0)
    xb, yb = casters(300, 120.0, 200.0, 150.0, 196.0, 2.0, 6.0)
    xs, ys = np.concatenate([xa, xb]), np.concatenate([ya, yb])
    z = rng.uniform(0.05, 0.95, xs.shape)
    z[rng.choice(xs.shape[0], 40, replace=False)] = 0.0
    clip = np.stack([(xs / size - 0.5) * 2.0, (0.5 - ys / size) * 2.0, z, np.ones_like(z)], axis=-1)

    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    noise = lambda: rng.uniform(-0.45, 0.45, (H, W))  # noqa: E731
    sx = np.empty((H, W))
    sy = np.empty((H, W))
    t0a = (yy < 32) & (xx < 64)
    t0b = (yy < 32) & (xx >= 64) & (xx < 128)
    t1 = (yy < 32) & (xx >= 128)
    t2 = (yy >= 32) & (xx < 128)
    t3 = (yy >= 32) & (xx >= 128)
    sx[t0a] = (22.0 + 0.35 * xx + noise())[t0a]
    sy[t0a] = (22.0 + 0.3 * yy + noise())[t0a]
    sx[t0b] = (180.0 + 0.35 * (xx - 64) + noise())[t0b]
    sy[t0b] = (100.0 + 0.35 * yy + noise())[t0b]
    sx[t1] = (xx - 100.0 + noise())[t1]
    sy[t1] = (40.0 + yy + noise())[t1]
    sx[t2] = (222.0 + 0.2 * xx + noise())[t2]
    sy[t2] = (180.0 + 2.0 * (yy - 32) + noise())[t2]
    sx[t3] = (125.0 + 1.1 * (xx - 128) + noise())[t3]
    sy[t3] = (152.0 + 0.1 * (xx - 128) + 3.0 * (yy - 32) + noise())[t3]
    hit = t0a | t0b | t2 | (t3 & (xx < 192) & (yy < 44))
    return clip.astype(np.float32), sx.astype(np.float32), sy.astype(np.float32), hit


def shadow_stress_case(device="cuda", seed: int = 0) -> dict:
    """shadow_stress_input through the port's setup on `device`: the caster
    table (tris, set up as the shadow pass does, culling nothing), sx, sy,
    hit, width, height, the light's size, and both list builders' CSR
    lists (rects for K7, cells for K8)."""
    import torch

    from .ops import geometry as G
    from .ops import shadow as SH

    clip, sx, sy, hit = shadow_stress_input(seed)
    dev = torch.device(device)
    c = torch.from_numpy(clip).to(dev)
    size = SHADOW_STRESS_SIZE
    tris = G.cull_and_setup(
        c, torch.ones(c.shape[0], dtype=torch.bool, device=dev), size, size,
        cull_mode=G.CullMode.NONE, front_is_cw=True, subpixel=False,
    )
    sx, sy, hit = (torch.from_numpy(a).to(dev) for a in (sx, sy, hit))
    W, H = SHADOW_STRESS_W, SHADOW_STRESS_H
    return dict(
        tris=tris, sx=sx, sy=sy, hit=hit, width=W, height=H, size=size,
        rects=SH.rect_lists(tris, sx, sy, hit, W, H), cells=SH.cell_lists(tris, sx, sy, hit, W, H, size),
    )


# ---------------------------------------------------------------------------
# A stress input for the step-list lerp (P3's probe_lerp)
# ---------------------------------------------------------------------------

# Tiles of 32x128 pixels, 16 cells of 72 texel rows (a 4x4 grid of 64x64
# cells over a 256x256 source), as tools/probe_bf16_real.py; steps per tile.
LERP_STRESS_STEPS = (640, 0, 40, 120)


def probe_lerp_stress_case(device="cuda", seed: int = 0, *, bf16: bool = True, xlerp: bool = True,
                           init_steps: bool = True, init: str = "nan", counts=LERP_STRESS_STEPS) -> dict:
    """probe_lerp's arguments (t, f, coords, st, sc, sf, out, and mode, npb,
    gx, lt, hs, ws), from a numpy generator, that press the kernel's walk
    harder than P3's probe (whose tiles hold about 37 steps each, most of
    them for pixels whose base texel lies in another cell):

    - four tiles with `counts` steps (640, 0, 40 and 120), interleaved at
      random in one list (tile 0's longer than the kernel's compaction round;
      tile 1's empty, so its output stays as it was);
    - each tile has a home cell: 90% of its pixels' base texels lie inside
      it and 85% of its steps use it (the rest: anywhere), so a step owns
      most of the pixels of the bands it selects;
    - flags: random band bits 0-3 (a step may select none); with
      `init_steps`, bit 4 at about 30% and 65% of tile 0's list and midway
      through tile 3's, else nowhere (the init branch stays on);
    - the cell mode with area weights, bf16 or f32 texels and weights, the
      x-lerp or the 128-lane sum, NaN or zero initial outputs."""
    import torch

    from .ops import probe_bf16 as pb
    from .tools import init_out

    rng = np.random.default_rng(seed)
    C, R, lt, gx = 4, 72, 64, 4
    hs = ws = lt * gx
    npx, npb = 32 * 128, 8 * 128
    nT, n_cells = len(counts), gx * gx
    t = rng.random((n_cells, R, C * 128), np.float32)
    f = rng.random((nT, 3, npx), np.float32)
    home = rng.choice(n_cells, nT, replace=False)
    inside = rng.random((nT, npx)) < 0.9
    hx, hy = (home % gx)[:, None] * lt, (home // gx)[:, None] * lt
    bx = np.where(inside, hx + rng.integers(0, lt, (nT, npx)), rng.integers(0, hs, (nT, npx)))
    by = np.where(inside, hy + rng.integers(0, lt, (nT, npx)), rng.integers(0, hs, (nT, npx)))
    coords = np.stack([bx, by], axis=1).astype(np.int32)
    st = rng.permutation(np.repeat(np.arange(nT), counts)).astype(np.int32)
    sc = np.where(rng.random(st.shape[0]) < 0.85, home[st], rng.integers(0, n_cells, st.shape[0])).astype(np.int32)
    sf = rng.integers(0, 16, st.shape[0]).astype(np.int32)
    if init_steps:
        for tile, at in ((0, 0.3), (0, 0.65), (3, 0.5)):
            sf[np.flatnonzero(st == tile)[int(at * counts[tile])]] |= 16
    mode = (pb.LERP_YCELL | pb.LERP_WAREA | pb.LERP_INIT | (pb.LERP_BF16 if bf16 else 0)
            | (pb.LERP_XLERP if xlerp else 0))
    dev = torch.device(device)
    up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return dict(t=up(t), f=up(f), coords=up(coords), st=up(st), sc=up(sc), sf=up(sf),
                out=init_out((nT, pb.OUT_ROWS, npx), init, dev), mode=mode, npb=npb, gx=gx, lt=lt, hs=hs, ws=ws)


# ---------------------------------------------------------------------------
# F1: inputs that stress a float32 fma
# ---------------------------------------------------------------------------

# The kinds of fma_stress_case's rows, in order, each about n / 8 of them.
FMA_STRESS_KINDS = ("bits", "cancel", "tie", "double_rounding", "subnormal", "overflow", "zero", "nan")
FMA_ARITY = {"fma": 3, "fma_ab_minus_cd": 4, "fma_dot3": 6}
F32_MAX = float(np.finfo(np.float32).max)


def _rand_f32(rng, m, lo, hi):
    """m float32 values of random sign, mantissa and exponent in [lo, hi]."""
    sign = rng.choice(np.array([-1.0, 1.0]), m)
    return (sign * rng.uniform(1.0, 2.0, m) * np.exp2(rng.integers(lo, hi + 1, m))).astype(np.float32)


def _signs(rng, m):
    return rng.choice(np.array([-1.0, 1.0]), m)


def _fma_kind(kind, rng, m):
    """(a, b, c) float32 arrays of m rows of one kind of fma_stress_case
    (all but "bits", which fma_stress_case draws for every input)."""
    f32 = np.float32
    if kind == "cancel":  # c within 3 ulps of -(a*b): the sum cancels to its last bits
        a, b = _rand_f32(rng, m, -60, 60), _rand_f32(rng, m, -60, 60)
        c = (-(a.astype(np.float64) * b)).astype(f32)
        return a, b, (c.view(np.int32) + rng.integers(-3, 4, m).astype(np.int32)).view(f32)
    if kind == "tie":
        # a = A 2^ea, b = B 2^eb with odd 12-bit A, B; c = C 2^(ea+eb-d), C
        # odd and small, d so that A B 2^d has 25 bits: a*b + c lies halfway
        # between two floats (or, where C carries past 25 bits, a quarter).
        A = 2 * rng.integers(2**10, 2**11, m) + 1
        B = 2 * rng.integers(2**10, 2**11, m) + 1
        d = np.where(A * B >= 2**23, 1, 2)
        C = 2 * rng.integers(-(2**9), 2**9, m) + 1
        ea, eb = rng.integers(-50, 51, m), rng.integers(-50, 51, m)
        a = (_signs(rng, m) * A * np.exp2(ea)).astype(f32)
        b = (_signs(rng, m) * B * np.exp2(eb)).astype(f32)
        return a, b, (C * np.exp2(ea + eb - d)).astype(f32)
    if kind == "double_rounding":
        # A B = 2^47 + r with 24-bit A, B and 0 < |r| < 2^18, c = C 2^(ea+eb+48)
        # with a 24-bit C: a*b + c is a float's midpoint plus or minus a
        # sliver below a double's half ulp, so a float64 sum rounded again to
        # float32 (double rounding) lands on the midpoint and ties wrongly.
        A = rng.integers(2**23, 2**24, 64 * m)
        B = np.rint(2.0**47 / A).astype(np.int64)
        r = A * B - 2**47
        ok = (r != 0) & (np.abs(r) < 2**18) & (B >= 2**23) & (B < 2**24)
        A, B = A[ok][:m], B[ok][:m]
        if A.size < m:
            raise RuntimeError("fma_stress_case: too few double-rounding pairs; raise the sample")
        ea, eb = rng.integers(-60, 26, m), rng.integers(-60, 26, m)
        C = rng.integers(2**23, 2**24, m)
        a = (_signs(rng, m) * A * np.exp2(ea)).astype(f32)
        b = (_signs(rng, m) * B * np.exp2(eb)).astype(f32)
        return a, b, (_signs(rng, m) * C * np.exp2(ea + eb + 48)).astype(f32)
    if kind == "subnormal":  # products near and below 2^-126, subnormal or zero addends
        a, b = _rand_f32(rng, m, -78, -58), _rand_f32(rng, m, -78, -58)
        c = (rng.integers(0, 2**23, m).astype(np.uint32) | np.where(rng.random(m) < 0.5, 2**31, 0).astype(
            np.uint32)).view(f32)
        near = rng.random(m) < 0.3  # or the subnormal nearest -(a*b): a result in the last bits
        c = np.where(near, (-(a.astype(np.float64) * b)).astype(f32), c)
        return a, b, c
    if kind == "overflow":  # sums around the float32 range's end, including its midpoint to 2^128
        a, b = _rand_f32(rng, m, 58, 66), _rand_f32(rng, m, 58, 66)
        c = _rand_f32(rng, m, 100, 127)
        edge = np.arange(m) % 4  # every other row: FLT_MAX + 2^103 (ties to inf) or just below
        under = np.float32((2**24 - 1) * 2.0**27)  # 2^51 - 2^27
        pick = rng.random(m) < 0.5
        a = np.where(pick, np.float32(2.0**52) * np.where(edge % 2 == 0, 1, -1).astype(f32), a)
        b = np.where(pick, np.where(edge < 2, np.float32(2.0**51), under), b)
        c = np.where(pick, np.float32(F32_MAX) * np.where(edge % 2 == 0, 1, -1).astype(f32), c)
        return a.astype(f32), b.astype(f32), c.astype(f32)
    if kind == "zero":  # signed zeros: a*b and c zero, and sums that cancel exactly
        a = rng.choice(np.array([0.0, -0.0, 1.5, -1.5], f32), m)
        b = rng.choice(np.array([0.0, -0.0, 2.0, -2.0], f32), m)
        which = rng.integers(0, 3, m)
        c = np.where(which == 0, rng.choice(np.array([0.0, -0.0], f32), m),
                     np.where(which == 1, -(a * b), rng.choice(np.array([3.0, -3.0], f32), m)))
        return a, b, c.astype(f32)
    if kind == "nan":  # NaNs, infinities, inf * 0 and inf - inf
        pool = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -2.5, F32_MAX, 1e-40], f32)
        return tuple(rng.choice(pool, m) for _ in range(3))
    raise ValueError(kind)


def fma_stress_case(form: str = "fma", n: int = 1 << 12, seed: int = 0):
    """Inputs that stress F1 and its plain versions (ops/fp.py): n rows,
    about n / 8 of each kind of FMA_STRESS_KINDS (random bit patterns over
    all exponents, cancellation, exact halfway cases, double-rounding traps,
    subnormal results, overflow to +-inf at the range's end, signed zeros,
    NaN and infinity operands). A tuple of FMA_ARITY[form] float32 numpy
    arrays, the form's inputs in order: fma (a, b, c); fma_ab_minus_cd (a,
    b, c, d), where outside the "bits" rows c*d = -c' exactly for the fma's
    addend c'; fma_dot3 (a0, b0, a1, b1, a2, b2), where outside the "bits"
    rows a0*b0 is the addend and the stressed product is (a1, b1) with a2 =
    +-0 in half the rows and (a2, b2) with (a1, b1) = (+-0, 1) in the
    others."""
    rng = np.random.default_rng(seed)
    k = len(FMA_STRESS_KINDS)
    sizes = [n // k + (1 if i < n % k else 0) for i in range(k)]
    cols = [[] for _ in range(FMA_ARITY[form])]
    one = np.float32(1.0)
    for kind, m in zip(FMA_STRESS_KINDS, sizes):
        if kind == "bits":  # any bit pattern: every exponent, subnormals, infinities, NaNs
            rows = tuple(rng.integers(0, 2**32, m, dtype=np.uint64).astype(np.uint32).view(np.float32)
                         for _ in cols)
        else:
            a, b, c = _fma_kind(kind, rng, m)
            ones = np.full(m, one)
            if form == "fma":
                rows = (a, b, c)
            elif form == "fma_ab_minus_cd":
                rows = (a, b, -c, ones)
            else:
                inner = rng.random(m) < 0.5
                zero = rng.choice(np.array([0.0, -0.0], np.float32), m)
                rows = (c, ones, np.where(inner, a, zero), np.where(inner, b, ones),
                        np.where(inner, zero, a), np.where(inner, ones, b))
        for col, x in zip(cols, rows):
            col.append(np.asarray(x, np.float32))
    return tuple(np.concatenate(col) for col in cols)


def f1_call_trace(calls):
    """What each call fn(*args) of `calls` does on the card, all traced in
    one torch.profiler context (CPU and CUDA activity): (the names of the
    device kernels launched, in launch order; per call, the dtypes of every
    tensor its aten ops returned, from a dispatch mode). Synchronized."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class _Dtypes(TorchDispatchMode):
        def __init__(self, out):
            super().__init__()
            self.out = out

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            res = func(*args, **(kwargs or {}))
            self.out.extend(t.dtype for t in tree_flatten(res)[0] if isinstance(t, torch.Tensor))
            return res

    dtypes = [[] for _ in calls]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for (fn, args), out in zip(calls, dtypes):
            with _Dtypes(out):
                fn(*args)
        torch.cuda.synchronize()
    # Device work only: a program span's range (utils.profiling) also shows
    # on the device's timeline, as a user annotation.
    device = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False))
    return [name for _t, name in device], dtypes


# ---------------------------------------------------------------------------
# Rule 2: which hand-written kernel to redesign next
# ---------------------------------------------------------------------------

# chip_smoke.py phase 11's kernel rows, by the TPU kernel each one ports.
KERNEL_OF_ROW = {
    "raster_resolve": "K1", "raster_msaa": "K1", "raster_count": "K1", "raster_bound": "K1",
    "raster_depth": "K2", "pcf5": "K3", "bilinear": "K4", "gather": "K5", "raster_vis": "K6",
    "shadow_occ": "K7", "shadow_occ_lt": "K8", "probe_dot": "P1", "probe_reduce": "P2", "probe_lerp": "P3",
    "fma": "F1", "fma_dot3": "F1", "fma_ab_minus_cd": "F1",
}
# Kernels redesigned for the H100 after their port; rule 2 does not take
# them again. K8 came with K7: both are instances of one CUDA kernel
# (csrc/shadow_occ.cu occ_kernel), so redesigning K7's redesigned K8's.
# With P2 and P3 every kernel but K3 and K4 (at their bounds) is here. F1's
# first design (one element a thread wherever a broadcast left more than
# one dimension) gave way to rows of four (csrc/fma.cu rows4_kernel),
# timed against it in turns by kernel_ab.py's F1 group; what stays over its
# bound is its smallest row, setup's ab_minus_cd, which sits at the launch
# floor.
REDESIGNED = frozenset({"K1", "K2", "P1", "K5", "K6", "K7", "K8", "P2", "P3", "F1"})


def redesign_order(rows, frame_launches, redesigned=REDESIGNED):
    """Rule 2's order of phase 11's kernel rows (dicts with name, ms,
    bound_ms, library_ms and launches, the launches on chip_smoke's paths):
    first the kernels slower than one PyTorch call computing the same
    function, by the factor; then by launches per main-path frame
    (`frame_launches`: row name -> launches in one representative frame at
    1 sample) x (ms - bound_ms), ties broken by the launches on chip_smoke's
    paths x (ms - bound_ms), which orders the kernels no frame launches.
    Skipped: kernels in `redesigned`, and rows at half their bound or better
    (bound_ms >= ms / 2) that are not slower than their library call. A
    kernel with several rows takes its first place. Returns [(kernel, row
    name, why)] in order."""
    slower, rest = [], []
    for r in rows:
        kernel = KERNEL_OF_ROW[r["name"]]
        if kernel in redesigned:
            continue
        gap = r["ms"] - r["bound_ms"]
        lib = r.get("library_ms")
        if lib is not None and r["ms"] > lib:
            slower.append((r["ms"] / lib, kernel, r["name"], f"{r['ms'] / lib:.3f}x its library call"))
        elif r["bound_ms"] < r["ms"] / 2:
            f = frame_launches.get(r["name"], 0)
            rest.append(((f * gap, r["launches"] * gap), kernel, r["name"],
                         f"{f:g} launches a frame, {r['launches']} on the paths, x {gap:.6f} ms over the bound"))
    order, seen = [], set()
    for _key, kernel, name, why in sorted(slower, reverse=True) + sorted(rest, reverse=True):
        if kernel not in seen:
            seen.add(kernel)
            order.append((kernel, name, why))
    return order


# -- an in-memory glTF scene ---------------------------------------------------

TEST_GLTF_DURATION = 2.0  # seconds: the last key time of make_test_gltf()'s animation


def _png_bytes(rgba: np.ndarray) -> bytes:
    """(H, W, 4) u8 -> PNG bytes (8-bit RGBA, filter 0 on every row)."""
    h, w = rgba.shape[:2]
    raw = b"".join(b"\x00" + rgba[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def _box(half, center=(0.0, 0.0, 0.0)):
    """(positions, normals, uvs, indices) of an axis-aligned box, four
    vertices a face, counter-clockwise seen from outside (glTF's front)."""
    pos, nrm, uvs, idx = [], [], [], []
    half = np.asarray(half, np.float32)
    for axis in range(3):
        for sign in (1.0, -1.0):
            n = np.zeros(3, np.float32)
            n[axis] = sign
            u = np.zeros(3, np.float32)
            u[(axis + 1) % 3] = 1.0
            v = np.cross(n, u)
            base = len(pos)
            for cu, cv, tu, tv in ((-1, -1, 0, 1), (1, -1, 1, 1), (1, 1, 1, 0), (-1, 1, 0, 0)):
                pos.append((n + cu * u + cv * v) * half + np.asarray(center, np.float32))
                nrm.append(n)
                uvs.append((tu, tv))
            idx += [base, base + 1, base + 2, base, base + 2, base + 3]
    return (np.array(pos, np.float32), np.array(nrm, np.float32), np.array(uvs, np.float32),
            np.array(idx, np.uint16))


def make_test_gltf() -> bytes:
    """A small .glb built in memory (numpy and the standard library only):

    - node 0: a textured PBR box, its base colour an 8x8 PNG in a data URI;
    - node 1: a rigid box whose T/R/S animate (LINEAR translation and
      scale, a quaternion rotation);
    - node 2: a two-joint skinned column (JOINTS_0 / WEIGHTS_0, inverse
      bind matrices) under joints 3 and 4; joint 4's rotation animates,
      joint 3's translation holds still;
    - node 5: a KHR_lights_punctual directional light, tilted down;
    - node 6: a ground slab.

    One animation with keys at 0, 1 and TEST_GLTF_DURATION seconds."""
    blob = bytearray()
    views, accessors = [], []

    def accessor(arr, ctype, atype, target=None):
        arr = np.ascontiguousarray(arr)
        while len(blob) % 4:
            blob.append(0)
        view = {"buffer": 0, "byteOffset": len(blob), "byteLength": arr.nbytes}
        if target is not None:
            view["target"] = target
        blob.extend(arr.tobytes())
        views.append(view)
        accessors.append({"bufferView": len(views) - 1, "componentType": ctype,
                          "count": int(arr.shape[0]), "type": atype})
        return len(accessors) - 1

    F32, U8, U16 = 5126, 5121, 5123

    def mesh(pos, nrm, idx, material, uvs=None, joints=None, weights=None):
        attrs = {"POSITION": accessor(pos, F32, "VEC3", 34962), "NORMAL": accessor(nrm, F32, "VEC3", 34962)}
        if uvs is not None:
            attrs["TEXCOORD_0"] = accessor(uvs, F32, "VEC2", 34962)
        if joints is not None:
            attrs["JOINTS_0"] = accessor(joints, U8, "VEC4", 34962)
            attrs["WEIGHTS_0"] = accessor(weights, F32, "VEC4", 34962)
        return {"primitives": [{"attributes": attrs, "indices": accessor(idx, U16, "SCALAR", 34963),
                                "material": material}]}

    pos, nrm, uvs, idx = _box((0.7, 0.7, 0.7))
    meshes = [mesh(pos, nrm, idx, 0, uvs=uvs)]
    pos, nrm, _, idx = _box((0.5, 0.5, 0.5))
    meshes.append(mesh(pos, nrm, idx, 1))
    # The column: two stacked boxes around x = 2, y in [0, 2]; y = 0 follows
    # joint 0, y = 2 joint 1, y = 1 both halves.
    parts = [_box((0.25, 0.5, 0.25), (2.0, 0.5 + k, 0.0)) for k in range(2)]
    pos = np.concatenate([p[0] for p in parts])
    nrm = np.concatenate([p[1] for p in parts])
    idx = np.concatenate([parts[0][3], parts[1][3] + len(parts[0][0])]).astype(np.uint16)
    w1 = np.clip(pos[:, 1] / 2.0, 0.0, 1.0)
    joints = np.tile(np.array([0, 1, 0, 0], np.uint8), (len(pos), 1))
    weights = np.stack([1.0 - w1, w1, np.zeros_like(w1), np.zeros_like(w1)], axis=1).astype(np.float32)
    meshes.append(mesh(pos, nrm, idx, 2, joints=joints, weights=weights))
    pos, nrm, _, idx = _box((4.0, 0.1, 3.0), (0.0, -0.8, 0.0))
    meshes.append(mesh(pos, nrm, idx, 3))

    # Inverse binds of joints at (2, 0, 0) and (2, 1, 0), column-major.
    ibm = np.stack([np.eye(4, dtype=np.float32)] * 2)
    ibm[0, :3, 3] = (-2.0, 0.0, 0.0)
    ibm[1, :3, 3] = (-2.0, -1.0, 0.0)
    ibm_acc = accessor(ibm.transpose(0, 2, 1).reshape(2, 16), F32, "MAT4")

    times = accessor(np.array([0.0, 1.0, TEST_GLTF_DURATION], np.float32), F32, "SCALAR")
    s45, c45 = np.sin(np.pi / 8), np.cos(np.pi / 8)
    samplers = [
        accessor(np.array([[-2.5, 0.0, 0.5], [-2.5, 0.8, 0.0], [-2.0, 1.2, -0.5]], np.float32), F32, "VEC3"),
        accessor(np.array([[1.0, 1.0, 1.0], [0.6, 0.9, 1.2], [0.8, 0.8, 0.8]], np.float32), F32, "VEC3"),
        accessor(np.array([[0, 0, 0, 1], [0, np.sin(np.pi / 4), 0, np.cos(np.pi / 4)], [0, 1, 0, 0]],
                          np.float32), F32, "VEC4"),
        accessor(np.array([[0, 0, 0, 1], [0, 0, s45, c45], [0, 0, -s45, c45]], np.float32), F32, "VEC4"),
        accessor(np.array([[2.0, 0.0, 0.0]] * 3, np.float32), F32, "VEC3"),
    ]
    # Joint 3 holds its place through a constant channel: a joint no channel
    # touches poses as identity (rend3-anim's convention, anim.py).
    channels = [(1, "translation"), (1, "scale"), (1, "rotation"), (4, "rotation"), (3, "translation")]

    yy, xx = np.mgrid[0:8, 0:8]
    tex = np.zeros((8, 8, 4), np.uint8)
    tex[..., 0] = np.where((xx + yy) % 2, 230, 40)
    tex[..., 1] = 40 + 25 * xx
    tex[..., 2] = 40 + 25 * yy
    tex[..., 3] = 255
    a = np.sin(-np.pi / 6)  # the light: -60 degrees about x
    light_q = [float(a), 0.0, 0.0, float(np.cos(-np.pi / 6))]

    doc = {
        "asset": {"version": "2.0", "generator": "rend3_tpu_torch.testing.make_test_gltf"},
        "extensionsUsed": ["KHR_lights_punctual"],
        "extensions": {"KHR_lights_punctual": {"lights": [
            {"type": "directional", "color": [1.0, 0.95, 0.9], "intensity": 3.0}]}},
        "scene": 0,
        "scenes": [{"nodes": [0, 1, 2, 3, 5, 6]}],
        "nodes": [
            {"mesh": 0, "translation": [0.0, 0.0, 0.0], "rotation": [0.0, 0.3826834, 0.0, 0.9238795]},
            {"mesh": 1, "translation": [-2.5, 0.0, 0.5]},
            {"mesh": 2, "skin": 0},
            {"translation": [2.0, 0.0, 0.0], "children": [4]},
            {"translation": [0.0, 1.0, 0.0]},
            {"rotation": light_q, "extensions": {"KHR_lights_punctual": {"light": 0}}},
            {"mesh": 3},
        ],
        "meshes": meshes,
        "materials": [
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}, "metallicFactor": 0.0,
                                      "roughnessFactor": 0.7}},
            {"pbrMetallicRoughness": {"baseColorFactor": [0.85, 0.25, 0.2, 1.0], "metallicFactor": 0.0,
                                      "roughnessFactor": 0.5}},
            {"pbrMetallicRoughness": {"baseColorFactor": [0.2, 0.55, 0.9, 1.0], "metallicFactor": 0.1,
                                      "roughnessFactor": 0.6}},
            {"pbrMetallicRoughness": {"baseColorFactor": [0.6, 0.6, 0.55, 1.0], "metallicFactor": 0.0,
                                      "roughnessFactor": 0.9}},
        ],
        "textures": [{"source": 0}],
        "images": [{"mimeType": "image/png",
                    "uri": "data:image/png;base64," + base64.b64encode(_png_bytes(tex)).decode()}],
        "skins": [{"joints": [3, 4], "inverseBindMatrices": ibm_acc}],
        "animations": [{"name": "move", "samplers": [
            {"input": times, "output": out, "interpolation": "LINEAR"} for out in samplers],
            "channels": [{"sampler": i, "target": {"node": n, "path": p}} for i, (n, p) in enumerate(channels)]}],
        "accessors": accessors,
        "bufferViews": views,
        "buffers": [{"byteLength": len(blob)}],
    }
    while len(blob) % 4:
        blob.append(0)
    js = json.dumps(doc, separators=(",", ":")).encode()
    js += b" " * (-len(js) % 4)
    chunks = struct.pack("<II", len(js), 0x4E4F534A) + js + struct.pack("<II", len(blob), 0x004E4942) + bytes(blob)
    return struct.pack("<III", 0x46546C67, 2, 12 + len(chunks)) + chunks


def gltf_scene_view() -> np.ndarray:
    """The camera that frames make_test_gltf()'s scene (left-handed, from
    the -z side, looking down a little)."""
    return m3.rotation_x(-0.35) @ m3.translation([0.0, -2.0, 7.0])


class GltfAnimationApp(App):
    """make_test_gltf()'s scene (or another glTF's bytes) as a framework
    App: loaded through gltf.loader.load_gltf in setup(), and posed by
    anim.pose_animation_frame at the frame's elapsed time (frame k of
    start(frames=n, frame_dt=dt) poses t = k * dt, clamped to the
    animation)."""

    def __init__(self, data: Optional[bytes] = None, shadow_resolution: int = 2048):
        self.data = make_test_gltf() if data is None else data
        self.shadow_resolution = shadow_resolution

    def ambient_color(self):
        return (0.1, 0.1, 0.1, 1.0)

    def clear_color(self):
        return (0.1, 0.05, 0.1, 1.0)

    def setup(self, context):
        r = context.renderer
        settings = GltfLoadSettings(directional_light_resolution=self.shadow_resolution,
                                    directional_light_shadow_distance=20.0)
        self.loaded, self.instance, _ = load_gltf(r, self.data, settings)
        self.anim_data = anim.AnimationData.from_gltf_scene(self.loaded, self.instance)
        r.set_camera_data(Camera(projection=Perspective(vfov=60.0, near=0.1), view=gltf_scene_view()))

    def handle_redraw(self, context):
        anim.pose_animation_frame(context.renderer, self.loaded, self.instance, self.anim_data, 0, context.elapsed)


# ---------------------------------------------------------------------------
# One rank of a distributed row-band run
# ---------------------------------------------------------------------------

BAND_RANK_SIZE = (128, 64)


def run_band_ranks(tmp_dir: str, world: int, device: str = "cpu", timeout: float = 150.0):
    """Runs band_rank in `world` processes of this interpreter (a file://
    rendezvous in tmp_dir; `device` may name the rank, as "cuda:{rank}"),
    joins them with a timeout of their own (killing any left) and returns
    each rank's saved arrays. Raises with the processes' output if one
    failed."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")  # the ranks share this host: NCCL's bootstrap stays on loopback
    init = "file://" + os.path.join(tmp_dir, "rendezvous")
    outs = [os.path.join(tmp_dir, f"rank{rank}.npz") for rank in range(world)]
    code = "import sys; from rend3_tpu_torch.testing import band_rank; band_rank(*sys.argv[1:])"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code, str(rank), str(world), init, outs[rank], device.format(rank=rank)],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("a band rank failed:\n" + "\n".join(logs))
    return [np.load(o) for o in outs]


def band_rank(rank, world, init: str, out: str, device: str = "cpu", frames: int = 2) -> None:
    """One rank of a distributed row-band run (run_band_ranks), each rank
    its own process: joins a `world`-rank process group at `init` (gloo on the
    CPU; NCCL with `device` a card, one rank a card), renders `frames`
    frames of scenes.band_features at BAND_RANK_SIZE through
    parallel.tiles' distributed mesh (the first from no carried mask) and
    saves the images and carried masks to `out` (.npz)."""
    import datetime

    import torch
    import torch.distributed as dist

    from . import scenes
    from .parallel.tiles import build_tiled_frame_callable, device_mesh

    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        runner = TestRunner(device=device)
        keep = scenes.band_features(runner)
        mesh = device_mesh(world, device=device, distributed=True)
        imgs, masks = [], []
        for _ in range(frames):
            runner.renderer.swap_instruction_buffers()
            program, args = build_tiled_frame_callable(
                runner.base_graph, runner.renderer.evaluate_instructions(), FrameRenderTarget(*BAND_RANK_SIZE),
                mesh=mesh,
            )
            img, mask, _aux = program(*args)
            imgs.append(img.cpu().numpy())
            masks.append(mask.cpu().numpy())
        np.savez(out, imgs=np.stack(imgs), masks=np.stack(masks))
        del keep
    finally:
        dist.destroy_process_group()
