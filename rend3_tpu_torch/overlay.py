"""2D overlay (UI) routine — the rend3-egui equivalent (port of
rend3_tpu/overlay.py).

Reference: rend3-egui/src/lib.rs:16-175 (EguiRenderRoutine: screen-space
textured, vertex-colored, alpha-blended triangle meshes composited over the
rendered frame, with per-mesh clip rects and a managed UI texture set, e.g.
the egui font atlas).

Paint jobs arrive from the host every frame (UI meshes are tiny and
dynamic), so each triangle is rasterized into a fixed-size window around
its bbox and composited in order, the window written back into the image;
triangles larger than the window take a full-image pass (background panels
— few). The per-frame cost follows the covered UI pixels, not the frame.
Each triangle is a handful of torch ops on the routine's device, walked in
order on the host. Compositing happens in display (sRGB u8) space with
straight alpha, like egui's own software blending.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .core.renderer import _resolve_device
from .ops.deferred import fma32

__all__ = ["OverlayRoutine", "PaintJob"]

WIN = 128  # windowed-raster extent (px); larger triangles take the full-image path


@dataclass
class PaintJob:
    """One UI mesh (egui ClippedPrimitive equivalent)."""

    vertices: np.ndarray            # (V, 2) f32 pixel positions
    colors: np.ndarray              # (V, 4) u8 straight-alpha sRGB
    indices: np.ndarray             # (T, 3) u32
    uvs: Optional[np.ndarray] = None      # (V, 2) f32 in [0,1], or None
    texture: Optional[int] = None         # id from add_texture
    clip_rect: Optional[Tuple[float, float, float, float]] = None  # x0,y0,x1,y1


class OverlayRoutine:
    def __init__(self, device="cuda"):
        self.device = _resolve_device(device, "OverlayRoutine")
        self._textures: Dict[int, np.ndarray] = {}
        self._next = 0

    def add_texture(self, image: np.ndarray) -> int:
        """Register a UI texture ((H, W, 4) u8, e.g. the egui font atlas)."""
        tid = self._next
        self._next += 1
        self._textures[tid] = np.asarray(image, np.uint8)
        return tid

    def update_texture(self, tid: int, image: np.ndarray) -> None:
        self._textures[tid] = np.asarray(image, np.uint8)

    def remove_texture(self, tid: int) -> None:
        self._textures.pop(tid, None)

    def render(self, frame: np.ndarray, jobs: List[PaintJob]) -> np.ndarray:
        """Composite paint jobs over frame ((H, W, 3/4) u8) in order."""
        frame = np.asarray(frame)
        H, W = frame.shape[:2]
        rgb = torch.from_numpy(frame[..., :3].astype(np.float32)).to(self.device)
        out = self.composite(rgb, jobs, H, W)
        res = torch.clamp(torch.round(out), 0, 255).to(torch.uint8).cpu().numpy()
        if frame.shape[-1] == 4:
            return np.concatenate([res, frame[..., 3:]], axis=-1)
        return res

    def composite(self, out: torch.Tensor, jobs: List[PaintJob], H: int, W: int) -> torch.Tensor:
        """Composite jobs in order over a float (H, W, 3) display-space image."""
        for job in jobs:
            out = self._render_job(out, job, H, W)
        return out

    def bake(self, jobs: List[PaintJob], width: int, height: int):
        """Flatten jobs ONCE into (P, A): P (H, W, 3) f32 premultiplied
        display-space color composited over a transparent canvas and
        A (H, W, 1) f32 total coverage, such that `P + (1 - A) * dst`
        equals compositing the jobs over dst in order (premultiplied-over
        algebra; the iterative over-black composite IS the premultiplied
        accumulation). A comes from a second composite with every vertex
        color and texture texel whitened (rgb=255, alpha kept)."""
        zeros = torch.zeros((height, width, 3), dtype=torch.float32, device=self.device)
        P = self.composite(zeros, jobs, height, width)
        white = OverlayRoutine(self.device)
        white._textures = {
            tid: np.concatenate([np.full_like(t[..., :3], 255), t[..., 3:]], axis=-1)
            for tid, t in self._textures.items()
        }
        white._next = self._next
        wjobs = []
        for job in jobs:
            wc = np.asarray(job.colors, np.uint8).copy()
            wc[:, :3] = 255
            wjobs.append(dataclasses.replace(job, colors=wc))
        A = white.composite(zeros, wjobs, height, width)[..., :1] / 255.0
        return P, A

    def device_pass(self, jobs: List[PaintJob], width: int, height: int):
        """Bake jobs and return a pass for BaseRenderGraph.register_pass: the
        overlay composites inside the frame, on the (H, W, 4) u8 image on the
        device, instead of on the host after the copy back (the reference
        draws egui in the renderpass, rend3-egui/src/lib.rs:52-94). The pass
        takes row0 (4-parameter form), so a band of rows [row0, row0 + bh)
        blends the same rows of the baked image. Static UI only — rebaking
        means a new pass; keep per-frame dynamic UI on the host compositor."""
        P, A = self.bake(jobs, width, height)

        def overlay_pass(img, gbuf, uniforms, row0):
            bh = img.shape[0]
            r0 = int(row0)
            Pb = P[r0 : r0 + bh].to(img.device)
            Ab = A[r0 : r0 + bh].to(img.device)
            rgb = img[..., :3].float()
            out = torch.clamp(torch.round(Pb + (1.0 - Ab) * rgb), 0, 255).to(torch.uint8)
            return torch.cat([out, img[..., 3:]], dim=-1)

        return overlay_pass

    # -- internals ----------------------------------------------------------

    def _render_job(self, out: torch.Tensor, job: PaintJob, H: int, W: int) -> torch.Tensor:
        v = np.asarray(job.vertices, np.float32)
        col = np.asarray(job.colors, np.float32) / 255.0
        idx = np.asarray(job.indices, np.int64).reshape(-1, 3)
        uv = np.asarray(job.uvs, np.float32) if job.uvs is not None else None
        tex = (
            torch.from_numpy(self._textures[job.texture].astype(np.float32)).to(self.device)
            if job.texture is not None and job.texture in self._textures
            else None
        )
        clip = job.clip_rect or (0.0, 0.0, float(W), float(H))

        # Host-side split: triangles whose bbox fits the window raster there;
        # the rest (background panels) go full-image.
        p = v[idx]                                    # (T, 3, 2)
        bbmin = p.min(axis=1)
        bbmax = p.max(axis=1)
        win_w = min(WIN, W)
        win_h = min(WIN, H)
        small = ((bbmax - bbmin) < [win_w - 1, win_h - 1]).all(axis=1)

        def tri_arrays(sel):
            t = idx[sel]
            return (
                torch.from_numpy(v[t]).to(self.device),                                # (T, 3, 2)
                _areas(v[t]).to(self.device),                                          # (T,)
                torch.from_numpy(col[t]).to(self.device),                              # (T, 3, 4)
                torch.from_numpy(uv[t]).to(self.device) if uv is not None else None,   # (T, 3, 2)
            )

        if small.any():
            origin = np.clip(np.floor(bbmin[small]), 0, [W - win_w, H - win_h]).astype(np.int64)
            out = _scan_windowed(out, *tri_arrays(small), origin, tex, clip, win_h, win_w)
        if (~small).any():
            out = _scan_full(out, *tri_arrays(~small), tex, clip)
        return out


def _areas(tv: np.ndarray) -> torch.Tensor:
    """(T,) f32 twice the signed areas of (T, 3, 2) triangles on the host,
    each one fma as XLA:CPU contracts the JAX package's scalar area
    (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)."""
    t = torch.from_numpy(tv)
    d1, d2 = t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]
    return fma32(d1[:, 0], d2[:, 1], -(d2[:, 0] * d1[:, 1]))


def _shade(px, py, pv, area, pc, puv, tex, clip):
    """Coverage + color of one triangle (area from _areas) at pixel grids
    px/py (2D)."""
    x0, y0 = pv[0, 0], pv[0, 1]
    x1, y1 = pv[1, 0], pv[1, 1]
    x2, y2 = pv[2, 0], pv[2, 1]
    e0 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)
    e1 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)
    e2 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)
    # Orientation-normalized edge tests with the wgpu top-left fill rule
    # (ops/raster._top_left) so a quad's shared diagonal never double-blends.
    sgn = torch.where(area >= 0.0, 1.0, -1.0)

    def tl(ax_, ay_, bx_, by_):
        dxe = (bx_ - ax_) * sgn
        dye = (by_ - ay_) * sgn
        return ((dye == 0.0) & (dxe > 0.0)) | (dye < 0.0)

    def edge_in(e, ax_, ay_, bx_, by_):
        es = e * sgn
        return (es > 0.0) | ((es == 0.0) & tl(ax_, ay_, bx_, by_))

    inside = (
        edge_in(e0, x0, y0, x1, y1)
        & edge_in(e1, x1, y1, x2, y2)
        & edge_in(e2, x2, y2, x0, y0)
        & (area != 0.0)
    )
    inside &= (px >= clip[0]) & (px < clip[2]) & (py >= clip[1]) & (py < clip[3])
    inv = 1.0 / torch.where(area == 0.0, 1.0, area)
    l0 = e1 * inv
    l1 = e2 * inv
    l2 = e0 * inv
    rgba = l0[..., None] * pc[0] + l1[..., None] * pc[1] + l2[..., None] * pc[2]
    if puv is not None and tex is not None:
        u = l0 * puv[0, 0] + l1 * puv[1, 0] + l2 * puv[2, 0]
        vv = l0 * puv[0, 1] + l1 * puv[1, 1] + l2 * puv[2, 1]
        th, tw = tex.shape[0], tex.shape[1]
        xi = torch.clamp((u * tw).to(torch.int32), 0, tw - 1).long()
        yi = torch.clamp((vv * th).to(torch.int32), 0, th - 1).long()
        rgba = rgba * tex[yi, xi] / 255.0
    return inside, rgba


def _blend(rgba, inside, dst):
    a = torch.where(inside, rgba[..., 3], 0.0)[..., None]
    return rgba[..., :3] * 255.0 * a + dst * (1.0 - a)


def _scan_windowed(out, tv, areas, tc, tuv, origins, tex, clip, win_h, win_w):
    """Each triangle in order over the win_h x win_w window at its origin
    (host ints), the blended window written back into the image."""
    dev = out.device
    ys = torch.arange(win_h, dtype=torch.float32, device=dev)
    xs = torch.arange(win_w, dtype=torch.float32, device=dev)
    out = out.clone()
    for i, (ox, oy) in enumerate(origins.tolist()):
        win = out[oy : oy + win_h, ox : ox + win_w]
        py = ys[:, None] + float(oy) + 0.5
        px = xs[None, :] + float(ox) + 0.5
        inside, rgba = _shade(px, py, tv[i], areas[i], tc[i], None if tuv is None else tuv[i], tex, clip)
        out[oy : oy + win_h, ox : ox + win_w] = _blend(rgba, inside, win)
    return out


def _scan_full(out, tv, areas, tc, tuv, tex, clip):
    """Each triangle in order over the whole image."""
    H, W = out.shape[0], out.shape[1]
    dev = out.device
    py = torch.arange(H, dtype=torch.float32, device=dev)[:, None] + 0.5
    px = torch.arange(W, dtype=torch.float32, device=dev)[None, :] + 0.5
    for i in range(tv.shape[0]):
        inside, rgba = _shade(px, py, tv[i], areas[i], tc[i], None if tuv is None else tuv[i], tex, clip)
        out = _blend(rgba, inside, out)
    return out
