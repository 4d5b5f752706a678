"""The plain reference renderer the benchmark holds the port's images to.

Plain PyTorch over the benchmark's own scene arrays (scene.py) and the mix's
per-frame state (traffic.py); it imports nothing of the program and takes
nothing the program made. It renders the frame the port's deferred pipeline
renders, written the straightforward way:

- every triangle in world space, then clip space, clipped at the near plane
  (z <= w), back faces culled (a left-handed scene: clockwise is front);
- a rasterizer over each triangle's pixel bounding box: pixel centres, the
  top-left rule with edges anchored at their lexicographically smaller end
  (so a shared edge is evaluated the same from both sides), reverse-Z depth
  (the greatest wins, on a tie the later triangle), depth kept in [0, 1];
- opaque triangles, then alpha-tested ones (the nearest fragment in front of
  the opaque one whose alpha passes the cutoff), then alpha-blended ones
  (every fragment at or in front of the surface, composited front to back,
  one per distinct depth);
- directional lights with texel-snapped orthographic shadow maps (front
  faces culled, blended triangles cast nothing) read by 5-tap PCF with a
  bilinear "ref >= stored" compare, and the shadow atlas's bounds test;
- textures decoded to linear light with box-filtered mip chains, sampled
  trilinearly with repeat addressing at the level of the analytic uv
  gradients; Lambert diffuse plus GGX / Smith / Schlick specular, the result
  no less than ambient x albedo;
- a half-float round trip, then sRGB encoding to u8 (round half to even).

`tf32=True` rounds the operands of every matrix product to TF32 (10 stored
mantissa bits, as the card's TF32 matrix units read them): the control that
the comparison must refuse.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from .scene import Scene, look_at_lh

__all__ = ["Reference", "projection", "shadow_view_proj", "atlas_plan"]

W_EPS = 1e-6
# Where the nearest two surfaces lie within this share of the depth, or a
# shadow tap within this of its texel's depth, rounding (the order of sums,
# fused products) decides which answer is drawn: the check accepts either.
DEPTH_TIE = 2e-5
SHADOW_TIE = 2e-5
PI = 3.14159265358979


# -- matrices (numpy float32, the application's side) -------------------------------


def projection(vfov_deg: float, aspect: float, near: float) -> np.ndarray:
    """Left-handed infinite reverse-Z perspective (near -> 1, far -> 0)."""
    f = 1.0 / np.tan(0.5 * float(np.deg2rad(vfov_deg)))
    return np.array([[f / aspect, 0, 0, 0], [0, f, 0, 0], [0, 0, 0, near], [0, 0, 1, 0]], np.float32)


def _ortho(half: np.ndarray) -> np.ndarray:
    """Left-handed orthographic box with near = +half.z -> 0 and far = -half.z -> 1."""
    left, right, bottom, top, near, far = -half[0], half[0], -half[1], half[1], half[2], -half[2]
    rw, rh, r = 1.0 / (right - left), 1.0 / (top - bottom), 1.0 / (far - near)
    return np.array([[2 * rw, 0, 0, -(left + right) * rw], [0, 2 * rh, 0, -(top + bottom) * rh],
                     [0, 0, r, -r * near], [0, 0, 0, 1]], np.float32)


def _point(m: np.ndarray, p) -> np.ndarray:
    return (m @ np.append(np.asarray(p, np.float32), 1.0).astype(np.float32))[:3]


def shadow_view_proj(direction, distance: float, resolution: int, view: np.ndarray) -> np.ndarray:
    """A directional light's view-projection: an orthographic box of side
    `distance` centred on the camera, its origin snapped to the map's texel
    grid in the light's frame."""
    location = np.linalg.inv(view).astype(np.float32)[:3, 3]
    texel = distance / float(resolution)
    origin_view = look_at_lh(np.zeros(3), direction)
    in_light = _point(origin_view, location)
    snapped = in_light - np.fmod(in_light, texel)
    loc = _point(np.linalg.inv(origin_view).astype(np.float32), snapped)
    lview = look_at_lh(loc, loc + np.asarray(direction, np.float32))
    return (_ortho(np.full(3, distance, np.float32) * 0.5) @ lview).astype(np.float32)


def atlas_plan(resolutions):
    """[(light index, (x, y) offset, size)] of a quadtree shadow atlas
    (largest maps first, new square roots as needed, roots in a row of up
    to 8192 texels), and the atlas extent (w, h)."""
    maps = sorted(enumerate(resolutions), key=lambda m: -m[1])
    root = maps[0][1]
    nodes, roots = [[0, None]], [0]   # node: [0 vacant | 1 leaf | 2 children, payload]

    def alloc(n, order, li):
        kind, payload = nodes[n]
        if kind == 0:
            if order == 0:
                nodes[n] = [1, li]
                return True
            nodes[n] = [2, list(range(len(nodes), len(nodes) + 4))]
            nodes.extend([0, None] for _ in range(4))
            return alloc(n, order, li)
        if kind == 1 or order == 0:
            return False
        return any(alloc(c, order - 1, li) for c in payload)

    for li, res in maps:
        while not alloc(roots[-1], root.bit_length() - res.bit_length(), li):
            nodes.append([0, None])
            roots.append(len(nodes) - 1)
    cols = max(1, 8192 // root)
    rows = -(-len(roots) // cols)
    cols = -(-len(roots) // rows)
    plan = []
    todo = deque((1, ((i % cols) * root, (i // cols) * root), n) for i, n in enumerate(roots))
    while todo:
        div, (ox, oy), n = todo.popleft()
        size = root // div
        if nodes[n][0] == 1:
            plan.append((nodes[n][1], (ox, oy), size))
        elif nodes[n][0] == 2:
            for ci, c in enumerate(nodes[n][1]):
                todo.append((div * 2, (ox + size // 2 * (ci % 2), oy + size // 2 * (ci // 2)), c))
    return plan, (max(cols * root, 32), max(rows * root, 32))


# -- helpers ------------------------------------------------------------------------


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32: 10 stored mantissa bits, to nearest, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt((v * v).sum(-1, keepdim=True))
    return v / torch.where(n == 0.0, torch.ones_like(n), n)


def _mip_chain(img: np.ndarray) -> list:
    mips = [img]
    for _ in range(1, int(max(img.shape[:2])).bit_length()):
        h, w = mips[-1].shape[:2]
        nh, nw = max(1, h // 2), max(1, w // 2)
        mips.append(mips[-1][: nh * 2, : nw * 2].reshape(nh, 2, nw, 2, 4).mean(axis=(1, 3)).astype(np.float32))
    return mips


class _Tris:
    """A set-up triangle table: screen corners in positive-area order."""

    def __init__(self, x, y, z, w, src, bary):
        self.x, self.y, self.z, self.w, self.src, self.bary = x, y, z, w, src, bary
        self.area = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0])
        ax, ay = x, y
        bx, by = torch.roll(x, -1, 1), torch.roll(y, -1, 1)
        dx, dy = bx - ax, by - ay
        self.tl = ((dy == 0.0) & (dx > 0.0)) | (dy < 0.0)
        swap = (bx < ax) | ((bx == ax) & (by < ay))
        self.sgn = torch.where(swap, -1.0, 1.0)
        self.lx, self.ly = torch.where(swap, bx, ax), torch.where(swap, by, ay)
        self.hx, self.hy = torch.where(swap, ax, bx), torch.where(swap, ay, by)

    def __len__(self):
        return self.x.shape[0]

    def edges(self, rows, px, py):
        """(N, 3) edge values E_k (edge k -> k+1) and (N,) coverage."""
        lx, ly, hx, hy = self.lx[rows], self.ly[rows], self.hx[rows], self.hy[rows]
        e = self.sgn[rows] * ((hx - lx) * (py[:, None] - ly) - (hy - ly) * (px[:, None] - lx))
        cov = ((e > 0.0) | ((e == 0.0) & self.tl[rows])).all(1)
        return e, cov

    def lam(self, rows, e):
        """Screen barycentrics (N, 3) from edge values."""
        return e[:, [1, 2, 0]] / self.area[rows, None]

    def depth(self, rows, lam):
        return (lam * self.z[rows]).sum(1)


class Reference:
    SAMPLES = (1,)   # the sample counts it renders

    def __init__(self, scene: Scene, device: str = "cpu", tf32: bool = False, chunk: int = 1 << 23):
        self.scene, self.dev, self.tf32, self.chunk = scene, torch.device(device), tf32, chunk
        dev = self.dev
        pos, nrm, uv, obj = [], [], [], []
        for o, m in enumerate(scene.obj_mesh):
            mesh = scene.meshes[m]
            pos.append(mesh.positions[mesh.indices])
            nrm.append(mesh.normals[mesh.indices])
            uv.append(np.zeros(mesh.indices.shape + (2,), np.float32) if mesh.uv0 is None else mesh.uv0[mesh.indices])
            obj.append(np.full(len(mesh.indices), o, np.int64))
        self.tri_pos = torch.from_numpy(np.concatenate(pos)).to(dev)
        self.tri_nrm = torch.from_numpy(np.concatenate(nrm)).to(dev)
        self.tri_uv = torch.from_numpy(np.concatenate(uv)).to(dev)
        self.tri_obj = torch.from_numpy(np.concatenate(obj)).to(dev)
        mats = scene.materials
        self.obj_mat = torch.tensor(scene.obj_material, dtype=torch.long, device=dev)
        self.m_albedo = torch.tensor(np.stack([m.albedo for m in mats]), dtype=torch.float32, device=dev)
        self.m_albedo_tex = torch.tensor([m.albedo_tex for m in mats], dtype=torch.long, device=dev)
        self.m_aomr_tex = torch.tensor([m.aomr_tex for m in mats], dtype=torch.long, device=dev)
        self.m_scalar = torch.tensor([[m.roughness, m.metallic, m.reflectance, m.cutout] for m in mats],
                                     dtype=torch.float32, device=dev)
        blend = torch.tensor([m.blend for m in mats], device=dev)[self.obj_mat][self.tri_obj]
        cut = (self.m_scalar[:, 3] > 0)[self.obj_mat][self.tri_obj]
        self.kind = torch.where(blend, 2, torch.where(cut, 1, 0))   # 0 opaque, 1 cutout, 2 blend
        self._textures()
        self.plan, extent = atlas_plan([lt.resolution for lt in scene.lights])
        self.extent = np.asarray(extent, np.float32)
        self.proj = projection(scene.vfov, scene.width / scene.height, scene.near)

    # -- textures -------------------------------------------------------------------

    def _textures(self):
        chains = []
        for t in self.scene.textures:
            f = t.rgba.astype(np.float32) / 255.0
            if t.srgb:
                rgb = f[..., :3]
                f = np.concatenate([np.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92),
                                    f[..., 3:]], -1).astype(np.float32)
            chains.append(_mip_chain(f))
        self.tex_levels, self.tex_sizes, self.tex_mips = [], None, None
        if not chains:
            return
        n_lv = max(len(c) for c in chains)
        sizes = np.zeros((len(chains), n_lv, 2), np.int64)
        for lv in range(n_lv):
            hmax = max(c[lv].shape[0] for c in chains if lv < len(c))
            wmax = max(c[lv].shape[1] for c in chains if lv < len(c))
            stack = np.zeros((len(chains), hmax, wmax, 4), np.float32)
            for i, c in enumerate(chains):
                if lv < len(c):
                    stack[i, : c[lv].shape[0], : c[lv].shape[1]] = c[lv]
                    sizes[i, lv] = c[lv].shape[:2]
            self.tex_levels.append(torch.from_numpy(stack).to(self.dev))
        self.tex_sizes = torch.from_numpy(sizes).to(self.dev)
        self.tex_mips = torch.tensor([len(c) for c in chains], dtype=torch.long, device=self.dev)

    def _bilinear(self, tid, lv, u, v):
        hw = self.tex_sizes[tid, lv].float()
        h, w = hw[:, 0], hw[:, 1]
        xf = (u - torch.floor(u)) * w - 0.5
        yf = (v - torch.floor(v)) * h - 0.5
        x0, y0 = torch.floor(xf), torch.floor(yf)
        fx, fy = (xf - x0)[:, None], (yf - y0)[:, None]
        out = torch.zeros(tid.shape[0], 4, device=self.dev)
        for level in torch.unique(lv).tolist():
            sel = lv == level
            img = self.tex_levels[level]

            def tap(xi, yi, sel=sel, img=img):
                xi = torch.remainder(xi[sel], w[sel]).long()
                yi = torch.remainder(yi[sel], h[sel]).long()
                return img[tid[sel], yi, xi]

            top = tap(x0, y0) * (1 - fx[sel]) + tap(x0 + 1, y0) * fx[sel]
            bot = tap(x0, y0 + 1) * (1 - fx[sel]) + tap(x0 + 1, y0 + 1) * fx[sel]
            out[sel] = top * (1 - fy[sel]) + bot * fy[sel]
        return out

    def sample(self, tid, uv, duv):
        """Trilinear samples (N, 4) of textures tid (-1: white) at uv (N, 2)
        with gradients duv (N, 4) = du/dx, dv/dx, du/dy, dv/dy."""
        out = torch.ones(tid.shape[0], 4, device=self.dev)
        has = tid >= 0
        if not bool(has.any()):
            return out
        t, uvh, d = tid[has], uv[has], duv[has]
        base = self.tex_sizes[t, 0].float()
        nm = self.tex_mips[t]
        rho = torch.maximum(torch.sqrt((d[:, 0] * base[:, 1]) ** 2 + (d[:, 1] * base[:, 0]) ** 2),
                            torch.sqrt((d[:, 2] * base[:, 1]) ** 2 + (d[:, 3] * base[:, 0]) ** 2))
        lam = torch.log2(torch.clamp_min(rho, 1e-12)).clamp_min(0.0)
        lam = torch.minimum(lam, (nm - 1).float())
        lam = torch.where(torch.isnan(lam), torch.zeros_like(lam), lam)
        l0 = torch.floor(lam)
        lf = (lam - l0)[:, None]
        l0 = l0.long()
        l1 = torch.minimum(l0 + 1, nm - 1)
        u, v = uvh[:, 0], uvh[:, 1]
        out[has] = self._bilinear(t, l0, u, v) * (1 - lf) + self._bilinear(t, l1, u, v) * lf
        return out

    # -- geometry -------------------------------------------------------------------

    def _mm(self, a, b):
        return torch.matmul(_tf32(a), _tf32(b)) if self.tf32 else torch.matmul(a, b)

    def _world(self, transforms: torch.Tensor) -> torch.Tensor:
        m = transforms[self.tri_obj]                                        # (T, 4, 4)
        return self._mm(self.tri_pos, m[:, :3, :3].transpose(1, 2)) + m[:, None, :3, 3]

    def _clip_space(self, world: torch.Tensor, vp: np.ndarray) -> torch.Tensor:
        vp = torch.from_numpy(vp).to(self.dev)
        return self._mm(world, vp[:, :3].T) + vp[:, 3]

    def _setup(self, clip, valid, width, height, keep_front: bool) -> _Tris:
        """Near-plane clip, viewport transform, face cull and viewport reject."""
        dev = clip.device
        d = clip[..., 3] - clip[..., 2]
        inside = (d >= 0.0) & (clip[..., 3] > W_EPS)
        n_in = inside.sum(1)
        eye3 = torch.eye(3, device=dev)
        rows = [torch.nonzero(valid & (n_in == 3)).flatten()]
        clips, srcs, barys = [clip[rows[0]]], [rows[0]], [eye3.expand(rows[0].shape[0], 3, 3)]
        for n_inside in (1, 2):
            g = torch.nonzero(valid & (n_in == n_inside)).flatten()
            if g.numel() == 0:
                continue
            # Rotate so corner 0 is the lone inside (one in) or outside (two in) corner.
            r = torch.argmax((inside[g] if n_inside == 1 else ~inside[g]).int(), 1)
            order = (r[:, None] + torch.arange(3, device=dev)) % 3
            v = torch.gather(clip[g], 1, order[:, :, None].expand(-1, -1, 4))
            b = eye3[order]
            dd = torch.gather(d[g], 1, order)

            def cut(i, j):  # the crossing on edge i -> j
                t = (dd[:, i] / (dd[:, i] - dd[:, j]))[:, None]
                return v[:, i] + (v[:, j] - v[:, i]) * t, b[:, i] + (b[:, j] - b[:, i]) * t

            if n_inside == 1:
                p01, b01 = cut(0, 1)
                p02, b02 = cut(0, 2)
                tris = [(torch.stack([v[:, 0], p01, p02], 1), torch.stack([b[:, 0], b01, b02], 1))]
            else:
                p10, b10 = cut(1, 0)
                p20, b20 = cut(2, 0)
                tris = [(torch.stack([p10, v[:, 1], v[:, 2]], 1), torch.stack([b10, b[:, 1], b[:, 2]], 1)),
                        (torch.stack([p10, v[:, 2], p20], 1), torch.stack([b10, b[:, 2], b20], 1))]
            for c, bb in tris:
                clips.append(c)
                srcs.append(g)
                barys.append(bb)
        c, src, bary = torch.cat(clips), torch.cat(srcs), torch.cat(barys)
        w = c[..., 3]
        x = (c[..., 0] / w * 0.5 + 0.5) * width
        y = (0.5 - c[..., 1] / w * 0.5) * height
        z = c[..., 2] / w
        area = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0])
        front = area > 0.0
        keep = (area != 0.0) & (front if keep_front else ~front)
        keep &= (x.amax(1) > 0) & (x.amin(1) < width) & (y.amax(1) > 0) & (y.amin(1) < height)
        k = torch.nonzero(keep).flatten()
        x, y, z, w, src, bary = x[k], y[k], z[k], w[k], src[k], bary[k]
        flip = (area[k] < 0.0)[:, None]
        sw = [0, 2, 1]
        x, y, z, w = (torch.where(flip, t[:, sw], t) for t in (x, y, z, w))
        bary = torch.where(flip[:, :, None], bary[:, sw], bary)
        return _Tris(x, y, z, w, src, bary)

    def _fragments(self, t: _Tris, width: int, height: int):
        """Yields (rows, pixel ids, px, py, lam, z) of the covered pixel
        centres with depth in [0, 1], in chunks."""
        if len(t) == 0:
            return
        x0 = (torch.floor(t.x.amin(1)) - 1).clamp(0, width).long()
        x1 = (torch.ceil(t.x.amax(1)) + 1).clamp(0, width).long()
        y0 = (torch.floor(t.y.amin(1)) - 1).clamp(0, height).long()
        y1 = (torch.ceil(t.y.amax(1)) + 1).clamp(0, height).long()
        nx = (x1 - x0).clamp_min(0)
        n = nx * (y1 - y0).clamp_min(0)
        csum = torch.cumsum(n, 0)
        total = int(csum[-1])
        marks = torch.tensor(list(range(self.chunk, total, self.chunk)), dtype=csum.dtype, device=csum.device)
        cuts = sorted(set([0] + torch.searchsorted(csum, marks).tolist())) + [len(t)]
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            nn = n[lo:hi]
            cnt = int(nn.sum())
            if cnt == 0:
                continue
            rows = torch.repeat_interleave(torch.arange(lo, hi, device=nn.device), nn)
            local = torch.arange(cnt, device=nn.device) - torch.repeat_interleave(torch.cumsum(nn, 0) - nn, nn)
            xi = x0[rows] + local % nx[rows]
            yi = y0[rows] + local // nx[rows]
            px, py = xi.float() + 0.5, yi.float() + 0.5
            e, cov = t.edges(rows, px, py)
            lam = t.lam(rows, e)
            z = t.depth(rows, lam)
            cov &= (z >= 0.0) & (z <= 1.0)
            k = torch.nonzero(cov).flatten()
            yield rows[k], (yi * width + xi)[k], px[k], py[k], lam[k], z[k]

    def _nearest(self, t, width, height, accept=None):
        """Per pixel the winning row (-1 none) and its depth: the greatest
        depth, on a tie the later row. accept(rows, pix, px, py, lam, z) ->
        bool mask filters fragments first."""
        key = torch.full((width * height,), -1, dtype=torch.int64, device=self.dev)
        for rows, pix, px, py, lam, z in self._fragments(t, width, height):
            if accept is not None:
                ok = accept(rows, pix, px, py, lam, z)
                rows, pix, z = rows[ok], pix[ok], z[ok]
            zbits = (z + 0.0).view(torch.int32).long()
            key.scatter_reduce_(0, pix, (zbits << 32) | rows, reduce="amax")
        row = torch.where(key >= 0, key & 0xFFFFFFFF, torch.full_like(key, -1))
        depth = torch.where(key >= 0, key >> 32, torch.zeros_like(key)).to(torch.int32).view(torch.float32)
        return row, depth

    def _surface(self, t: _Tris, rows, lam, frame):
        """Per-fragment surface: world position, normal, uv and its screen
        gradients, material index."""
        src = t.src[rows]
        inv_w = 1.0 / t.w[rows]
        pl = lam * inv_w
        mu = pl / pl.sum(1, keepdim=True)
        bc = t.bary[rows]                                   # (N, 3 clipped, 3 source)
        beta = (mu[:, :, None] * bc).sum(1)
        world = (beta[:, :, None] * frame["world"][src]).sum(1)
        nrm = _normalize((beta[:, :, None] * frame["normals"](src)).sum(1))
        uv_c = torch.bmm(bc, self.tri_uv[src])             # uv at the clipped corners
        uv = (mu[:, :, None] * uv_c).sum(1)
        x, y, area = t.x[rows], t.y[rows], t.area[rows, None]
        dldx = torch.stack([y[:, 1] - y[:, 2], y[:, 2] - y[:, 0], y[:, 0] - y[:, 1]], 1) / area
        dldy = torch.stack([x[:, 2] - x[:, 1], x[:, 0] - x[:, 2], x[:, 1] - x[:, 0]], 1) / area
        den = pl.sum(1, keepdim=True)
        grads = []
        for dl in (dldx, dldy):
            dw = dl * inv_w
            grads.append(((dw[:, :, None] * uv_c).sum(1) - uv * dw.sum(1, keepdim=True)) / den)
        duv = torch.cat(grads, 1)
        mat = self.obj_mat[self.tri_obj[src]]
        return world, nrm, uv, duv, mat

    def _alpha(self, mat, uv, duv):
        tex = self.sample(self.m_albedo_tex[mat], uv, duv)
        return tex[:, 3] * self.m_albedo[mat, 3]

    # -- shadows --------------------------------------------------------------------

    def _shadow_maps(self, frame):
        maps = []
        for li, _off, size in self.plan:
            vp = shadow_view_proj(self.scene.lights[li].direction, self.scene.lights[li].distance, size, frame["view"])
            t = self._setup(self._clip_space(frame["world"], vp), self.kind != 2, size, size, keep_front=False)
            depth = torch.zeros(size * size, device=self.dev)
            for _rows, pix, _px, _py, _lam, z in self._fragments(t, size, size):
                depth.scatter_reduce_(0, pix, z, reduce="amax")
            maps.append((vp, depth.reshape(size, size)))
        return maps

    def _shadow(self, maps, world, tie: float):
        """(L, N) shadow factors at world positions (N, 3); a tap within
        `tie` of its texel is lit when tie < 0 and shadowed when tie > 0."""
        out = []
        ones = torch.ones(world.shape[0], device=self.dev)
        for (li, (ox, oy), size), (vp, smap) in zip(self.plan, maps):
            vpt = torch.from_numpy(vp).to(self.dev)
            ndc = self._mm(world, vpt[:3, :3].T) + vpt[:3, 3]
            sx = (ndc[:, 0] * 0.5 + 0.5) * size
            sy = (0.5 - ndc[:, 1] * 0.5) * size
            ref = ndc[:, 2]
            fx_, fy_ = ndc[:, 0] * 0.5 + 0.5, ndc[:, 1] * 0.5 + 0.5
            off = np.array([ox, oy], np.float32) / self.extent
            border = 1.5 / self.extent
            tl = off + border
            br = off + np.float32(size) / self.extent - border
            inb = (((fx_ >= float(tl[0])) | (fy_ >= float(tl[1]))) & ((fx_ <= float(br[0])) | (fy_ <= float(br[1])))
                   & (ref >= 0.0) & (ref <= 1.0))
            xb, yb = torch.floor(sx - 0.5), torch.floor(sy - 0.5)
            fx, fy = (sx - 0.5) - xb, (sy - 0.5) - yb
            bx, by = xb.long(), yb.long()

            def cmp(dx, dy):
                xi, yi = bx + dx, by + dy
                ins = (xi >= 0) & (xi < size) & (yi >= 0) & (yi < size)
                occ = torch.where(ins, smap[yi.clamp(0, size - 1), xi.clamp(0, size - 1)], torch.zeros_like(ref))
                return (ref >= occ + tie).float()

            c = {(dx, dy): cmp(dx, dy) for dx in (-1, 0, 1, 2) for dy in (-1, 0, 1, 2)}

            def tap(ox_, oy_):
                top = c[(ox_, oy_)] * (1 - fx) + c[(ox_ + 1, oy_)] * fx
                bot = c[(ox_, oy_ + 1)] * (1 - fx) + c[(ox_ + 1, oy_ + 1)] * fx
                return top * (1 - fy) + bot * fy

            pcf = (tap(0, 0) + tap(0, 1) + tap(0, -1) + tap(1, 0) + tap(-1, 0)) * 0.2
            own = (bx >= 0) & (bx < size) & (by >= 0) & (by < size)
            out.append(torch.where(inb & own, pcf, ones))
        return torch.stack(out) if out else ones[None]

    # -- shading --------------------------------------------------------------------

    def _shade(self, world, nrm, uv, duv, mat, shadow, eye):
        """(N, 4) linear RGBA."""
        albedo = self.sample(self.m_albedo_tex[mat], uv, duv) * self.m_albedo[mat]
        ao = torch.ones_like(albedo[:, 0])
        rough, metal, refl = self.m_scalar[mat, 0], self.m_scalar[mat, 1], self.m_scalar[mat, 2]
        aomr_t = self.m_aomr_tex[mat]
        if bool((aomr_t >= 0).any()):
            s = self.sample(aomr_t, uv, duv)
            has = aomr_t >= 0
            ao = torch.where(has, ao * s[:, 0], ao)
            rough = torch.where(has, rough * s[:, 1], rough)
            metal = torch.where(has, metal * s[:, 2], metal)
        diffuse = albedo[:, :3] * (1 - metal)[:, None]
        f0 = albedo[:, :3] * metal[:, None] + (0.16 * refl * refl * (1 - metal))[:, None]
        a = (rough * rough)[:, None]
        a2 = a * a
        v = _normalize(torch.from_numpy(eye).to(self.dev) - world)
        n = nrm
        color = torch.zeros_like(diffuse)
        for k, (li, _off, _size) in enumerate(self.plan):
            light = self.scene.lights[li]
            ld = torch.from_numpy(-light.direction).to(self.dev)
            ld = (ld / torch.sqrt((ld * ld).sum()))[None].expand_as(n)
            h = _normalize(v + ld)
            nov = (n * v).sum(1, keepdim=True).abs() + 0.00001
            nol = (n * ld).sum(1, keepdim=True).clamp(0, 1)
            noh = (n * h).sum(1, keepdim=True).clamp(0, 1)
            loh = (ld * h).sum(1, keepdim=True).clamp(0, 1)
            f90 = (f0 * (50.0 * 0.33)).sum(1, keepdim=True).clamp(0, 1)
            f = (noh * a2 - noh) * noh + 1.0
            dterm = a2 / (PI * f * f)
            fterm = f0 + (f90 - f0) * (1.0 - loh) ** 5
            vterm = 0.5 / (nov * torch.sqrt((-nol * a2 + nol) * nol + a2)
                           + nol * torch.sqrt((-nov * a2 + nov) * nov + a2))
            lcol = torch.from_numpy(light.color * np.float32(light.intensity)).to(self.dev)
            contrib = (diffuse / PI + dterm * vterm * fterm) * lcol * (nol * shadow[k][:, None] * ao[:, None])
            color = color + torch.where(torch.isfinite(contrib), contrib, torch.zeros_like(contrib))
        amb = torch.tensor(self.scene.ambient, dtype=torch.float32, device=self.dev)
        rgb = torch.maximum(amb[:3] * albedo[:, :3], color)
        alpha = torch.maximum(amb[3] * albedo[:, 3], albedo[:, 3])
        return torch.cat([rgb, alpha[:, None]], 1)

    # -- the frame ------------------------------------------------------------------

    @torch.no_grad()
    def render(self, view: np.ndarray, transforms: np.ndarray) -> dict:
        """One frame of a camera view and object transforms: {"image": the
        (H, W, 4) u8 sRGB image, "lo" / "hi": per channel the least and the
        greatest of the images where rounding decides (see _ambiguous),
        "ambiguous": the share of pixels whose surface it decides}."""
        W, H = self.scene.width, self.scene.height
        eye = np.linalg.inv(view).astype(np.float32)[:3, 3]
        tr = torch.from_numpy(np.ascontiguousarray(transforms, np.float32)).to(self.dev)
        world = self._world(tr)
        m3 = tr[:, :3, :3]
        inv_s2 = 1.0 / torch.clamp_min((m3 * m3).sum(1), 1e-30)          # per column

        def normals(src):
            o = self.tri_obj[src]
            nn = self._mm(self.tri_nrm[src] * inv_s2[o][:, None, :], m3[o].transpose(1, 2))
            return _normalize(nn)

        frame = {"world": world, "normals": normals, "view": view}
        vp = (self.proj @ view).astype(np.float32)
        t = self._setup(self._clip_space(world, vp), self.kind != 2, W, H, keep_front=True)
        kind = self.kind[t.src]
        tri_o = _subset(t, kind == 0)
        row, depth = self._nearest(tri_o, W, H)
        # The nearest fragment of another triangle: where it lies within
        # DEPTH_TIE of the winner, rounding picks the surface.
        row2, depth2 = self._nearest(tri_o, W, H, lambda rows, pix, *_: rows != row[pix])
        alt = torch.where((row >= 0) & (row2 >= 0) & (depth - depth2 <= DEPTH_TIE * depth), row2, -1)
        surf_t, surf_row = tri_o, row
        if bool((kind == 1).any()):
            tri_c = _subset(t, kind == 1)

            def passes(rows, pix, px, py, lam, z):
                front = (row[pix] < 0) | (z > depth[pix])
                ok = front.clone()
                if bool(front.any()):
                    f = torch.nonzero(front).flatten()
                    _w, _n, uv, duv, mat = self._surface(tri_c, rows[f], lam[f], frame)
                    alpha = self._alpha(mat, uv, duv)
                    ok[f] = alpha >= self.m_scalar[mat, 3]
                return ok

            crow, cdepth = self._nearest(tri_c, W, H, passes)
            take = crow >= 0
            near_tie = take & (row >= 0) & (cdepth - depth <= DEPTH_TIE * cdepth)
            alt = torch.where(take, torch.where(near_tie, row, -1), alt)
            depth = torch.where(take, cdepth, depth)
            surf_t = _merge(tri_o, tri_c)
            surf_row = torch.where(take, crow + len(tri_o), row)
        maps = self._shadow_maps(frame)
        # Images: the surface with shadow ties lit, then shadowed; the
        # alternative surface (where there is one) the same two ways.
        imgs = [torch.zeros(W * H, 4, device=self.dev) for _ in range(2)]
        for sel_row, out in ((surf_row, None), (alt, True)):
            hit = torch.nonzero(sel_row >= 0).flatten()
            if not hit.numel():
                if out:
                    imgs += [imgs[0].clone(), imgs[1].clone()]
                continue
            rows = sel_row[hit]
            px, py = (hit % W).float() + 0.5, (hit // W).float() + 0.5
            e, _ = surf_t.edges(rows, px, py)
            wpos, nrm, uv, duv, mat = self._surface(surf_t, rows, surf_t.lam(rows, e), frame)
            shaded = [self._shade(wpos, nrm, uv, duv, mat, self._shadow(maps, wpos, tie), eye)
                      for tie in (-SHADOW_TIE, SHADOW_TIE)]
            if out:
                for k in range(2):
                    img = imgs[k].clone()
                    img[hit] = shaded[k]
                    imgs.append(img)
            else:
                for k in range(2):
                    imgs[k][hit] = shaded[k]
        if bool((self.kind == 2).any()):
            tb = self._setup(self._clip_space(world, vp), self.kind == 2, W, H, keep_front=True)
            cover = self._blend(tb, surf_row, depth, frame, maps, eye)
            if cover is not None:
                C, A = cover
                imgs = [torch.cat([C + (1.0 - A)[:, None] * i[:, :3], (A + (1.0 - A) * i[:, 3])[:, None]], 1)
                        for i in imgs]
        u8 = torch.stack([_to_srgb_u8(i.reshape(H, W, 4)) for i in imgs])
        return {"image": u8[0], "lo": u8.amin(0), "hi": u8.amax(0),
                "ambiguous": float((alt >= 0).double().mean())}

    def _blend(self, tb, surf_row, depth, frame, maps, eye):
        """(C, A): the blend layers' colour and coverage, composited front
        to back, or None where no blend fragment lies in front."""
        W, H = self.scene.width, self.scene.height
        frags = []
        for rows, pix, px, py, lam, z in self._fragments(tb, W, H):
            ok = (surf_row[pix] < 0) | (z >= depth[pix])
            frags.append((rows[ok], pix[ok], lam[ok], z[ok]))
        if not frags:
            return None
        rows, pix, lam, z = (torch.cat(f) for f in zip(*frags))
        if rows.numel() == 0:
            return None
        # Front to back per pixel; on a tie the later triangle first, and one
        # fragment per distinct depth.
        o = torch.sort(rows, descending=True, stable=True).indices
        o = o[torch.sort(z[o], descending=True, stable=True).indices]
        o = o[torch.sort(pix[o], stable=True).indices]
        rows, pix, lam, z = rows[o], pix[o], lam[o], z[o]
        first = torch.ones_like(pix, dtype=torch.bool)
        first[1:] = pix[1:] != pix[:-1]
        dup = torch.zeros_like(first)
        dup[1:] = (~first[1:]) & (z[1:] == z[:-1])
        keep = torch.nonzero(~dup).flatten()
        rows, pix, lam, z, first = rows[keep], pix[keep], lam[keep], z[keep], first[keep]
        starts = torch.nonzero(first).flatten()
        seg = torch.cumsum(first.long(), 0) - 1
        rank = torch.arange(pix.numel(), device=pix.device) - starts[seg]
        wpos, nrm, uv, duv, mat = self._surface(tb, rows, lam, frame)
        rgba = self._shade(wpos, nrm, uv, duv, mat, self._shadow(maps, wpos, 0.0), eye)
        C = torch.zeros(W * H, 3, device=self.dev)
        A = torch.zeros(W * H, device=self.dev)
        for r in range(int(rank.max()) + 1):
            s = rank == r
            p, c = pix[s], rgba[s]
            a = c[:, 3]
            C[p] = C[p] + ((1.0 - A[p]) * a)[:, None] * c[:, :3]
            A[p] = A[p] + (1.0 - A[p]) * a
        return C, A


def _to_srgb_u8(img: torch.Tensor) -> torch.Tensor:
    """Linear (H, W, 4) -> u8 through the half-float target, sRGB colour."""
    img = img.half().float()
    rgb = img[..., :3].clamp(0, 1)
    rgb = torch.where(rgb > 0.0031308, 1.055 * rgb ** (1.0 / 2.4) - 0.055, rgb * 12.92)
    return torch.round(torch.cat([rgb, img[..., 3:].clamp(0, 1)], -1) * 255.0).to(torch.uint8)


def _subset(t: _Tris, mask) -> _Tris:
    k = torch.nonzero(mask).flatten()
    return _Tris(t.x[k], t.y[k], t.z[k], t.w[k], t.src[k], t.bary[k])


def _merge(a: _Tris, b: _Tris) -> _Tris:
    return _Tris(*(torch.cat([getattr(a, f), getattr(b, f)]) for f in ("x", "y", "z", "w", "src", "bary")))
