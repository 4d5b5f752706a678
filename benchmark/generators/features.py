"""The Bistro proxy city through rend3's whole frame: a skybox, custom
material routines in all three transparency modes, swaying skinned props,
and a tonemap pass and a HUD pass after the resolve.

The city is scene.build_scene's, from the configuration's "scene" group
(the bistro-proxy-1080p keys). The "features" group adds what every
application built on rend3-framework draws around it (DefaultRoutines:
PBR, skybox, tonemapping; user graph nodes after them):

- the sky: one cube texture of 6 faces of `sky_size`² in RGBA16_FLOAT
  (SKY_FORMAT): rend3_tpu_torch.scenes.sky_faces' horizon-to-zenith
  gradient, noise drawn from the run's seed, and a sun disc whose core
  reads `sun.peak` (above 1.0: HDR), at `sun.elevation` degrees above the
  horizon in the azimuth of the key light;
- signs: a double-sided quad each, of its own material, on one wall of a
  building (the wall nearest its grid cell's street; a second round of
  signs takes each building's next-nearest wall), 0.05 m off the wall,
  3-5 m up, 1.5-3 m wide and half as tall, in four archetypes
  (ARCHETYPES): "SignMaterial", lit by an opaque routine (Lambert from the
  frame's directional lights times their shadow factors, plus ambient, times
  the colour); "CutoutSignMaterial", a cutout routine (a 4x4 uv checker's
  alpha, cutoff 0.5) shaded unlit; "GlassSignMaterial", a blend routine
  (rgba = colour x vertex colour, alpha 0.45); "HiddenSignMaterial", an
  archetype with no routine, which must neither draw nor cast shadows;
- props: `columns` skinned columns (scene.subdivided_cube(8): 486 vertices,
  768 triangles, 4 joints up its height, a vertex blending the two around
  it), 0.6 m wide and 3-6 m tall, on street spots whose distance to every
  building footprint is at least `clearance`;
- passes: "hdr" (an exposure scale, then Narkowicz's ACES filmic fit,
  clamped to [0, 1], on each RGB channel of the resolved linear image) and
  "srgb" (a HUD: an RGBA8 image the size of the target, alpha-composited
  over the u8 frame: a bottom bar, a minimap panel top right and lines of
  glyph blocks; built once at set-up and uploaded once).

Placements (signs and columns) come from the group's `layout_seed`, so
the scene's geometry is the same for every run seed; the run's seed draws
the city's texture colours, the signs' colours and the sky's noise.

The mix (`Traffic`) flies the flythrough mix's camera loop and poses
every column every frame through set_skeleton_joint_transforms: a bend
about z and a twist about y that grow up the column (column_pose), of
`bend` sin(phase + `bend_offset` k) and `twist` cos(phase + `twist_offset`
k) for column k, the phase 2 pi frame / `cycle_frames`.

The reference (`Reference`) renders what reference.Reference renders, plus
what it lacks, in plain float32 PyTorch (TF32 off): the cube-map sky
where no surface covers a pixel (the port's face selection, in-face
coordinates and clamped bilinear taps over the linear faces; the port
samples a bf16 copy of them), the three routines (the lit routine as the
surface's colour, the checker alpha in place of the albedo alpha, the
glass routine's colour in the front-to-back composite), the hidden
archetype left out of the frame and of the shadow maps, the columns
skinned by their joint globals x inverse binds blended by the weights, and
the two passes in order where the port runs them: the tonemap on the
linear image after its half-float round trip, the HUD on the encoded u8
image. Where it departs from rend3: rend3's skybox samples its cube with
the card's seamless filtering, where this frame clamps each face's taps to
its own edge; rend3's TonemappingRoutine only encodes, so the tonemap here
is the application's pass.

The check also sees close-ups (the mix's "closeup" group), after the
window: a column's top from below, from `eye_height` metres up and
`distance` times the column's height away, along a heading on which the
ground line from the eye through the column to `beyond` metres past it
passes no building (so the top is seen against the sky); a sign of each
archetype in `signs` from in front, at up to twice its width; and, for each
entry of `lit` ("light" or "shadow"), a lit sign whose wall faces the key
light, from 0.7 times its half-width in front, so that the sign fills the
view, with the scene's own lights and ambient: "light" one that no caster's
box (the object's mesh bounds, a column's widened by its sway) stands
between and the key light, "shadow" one that a building hides from it, each
over a margin of 3.5 shadow texels about the sign and with nothing between
the eye and the sign, so no shadow edge is in view. From the cell's camera
a column or a sign covers a few hundred pixels, too few for
compare.LIMITS to see a wrong pose, a routine dropped or its lights and
shadows misread. All but the lit views are lit by the ambient term alone
(CLOSEUP_AMBIENT, the directional lights at intensity 0), so each surface
shows its colour. The reference judges them by compare.judge under its
limits; where they fail, it answers every checked frame with an interval
no image meets. Nothing here imports the port; `Port` calls its public API
from inside its methods, as adapter.Port does.
"""

import contextlib
import dataclasses
import math
import sys

import numpy as np
import torch

from benchmark import adapter, compare, reference
from benchmark import scene as S
from benchmark import traffic as T
from benchmark.generators import crowd
from benchmark.generators.crowd import CLOSEUP_AMBIENT, clearance
from benchmark.scene import look_at_lh

__all__ = ["ARCHETYPES", "SKY_FORMAT", "CLOSEUP_AMBIENT", "FeatureScene", "sky_faces", "sign_mesh", "column_weights",
           "column_pose", "hud_image", "build_scene", "Traffic", "Port", "Reference", "lit_shade", "unlit_shade",
           "checker_alpha", "aces_pass", "hud_pass"]

# Archetype names, in the order of the signs; the routine each has (None:
# no routine, so the archetype must not draw).
ARCHETYPES = {"SignMaterial": "opaque", "CutoutSignMaterial": "cutout", "GlassSignMaterial": "blend",
              "HiddenSignMaterial": None}
SKY_FORMAT = "RGBA16_FLOAT"
WALL_GAP = 0.05
# The reference's routine codes, per material.
_PBR, _LIT, _UNLIT = 0, 1, 2


@dataclasses.dataclass
class FeatureScene(S.Scene):
    sky: np.ndarray = None            # (6, E, E, 4) f16 linear faces
    hud: np.ndarray = None            # (H, W, 4) u8
    exposure: float = 1.0
    routine: list = None              # per material: its archetype name, or None (PBR)
    first_sign: int = -1              # the first sign's object index (the rest follow, then the columns)
    first_column: int = -1            # the first column's object index (the last objects)
    column_mesh: int = -1
    joint_ids: np.ndarray = None      # (V, 4) int64
    weights: np.ndarray = None        # (V, 4) f32
    inverse_binds: np.ndarray = None  # (4, 4, 4) f32
    heights: np.ndarray = None        # (C,) each column's height
    sign_boxes: list = None           # per sign: (centre (3,), outward normal (3,), width)

    @property
    def columns(self) -> int:
        return len(self.obj_mesh) - self.first_column


def sky_faces(features: dict, seed: int, direction) -> np.ndarray:
    """(6, E, E, 4) f16 linear faces (the module's docstring): the gradient
    of rend3_tpu_torch.scenes.sky_faces, N(0, 0.05) noise from `seed` and
    the sun disc, its core within `radius` degrees at `peak`, falling to
    the sky over as many degrees again."""
    e, sun = int(features["sky_size"]), features["sun"]
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 6])
    t = (np.arange(e, dtype=np.float32) + 0.5) / e
    horizon = np.array([0.85, 0.8, 0.7], np.float32)
    zenith = np.array([0.15, 0.35, 0.8], np.float32)
    up = (1.0 - t)[:, None, None]
    side = horizon + (zenith - horizon) * up
    # Each face's texel directions (the port's face mapping, inverted).
    uc = np.broadcast_to((2.0 * t - 1.0)[None, :], (e, e))
    vc = np.broadcast_to((2.0 * t - 1.0)[:, None], (e, e))
    one = np.ones((e, e), np.float32)
    dirs = [(one, -vc, -uc), (-one, -vc, uc), (uc, one, vc), (uc, -one, -vc), (uc, -vc, one), (-uc, -vc, -one)]
    az = np.asarray(direction, np.float64)[[0, 2]]
    az = -az / np.linalg.norm(az)
    el = math.radians(float(sun["elevation"]))
    s = np.array([math.cos(el) * az[0], math.sin(el), math.cos(el) * az[1]], np.float32)
    r0 = math.radians(float(sun["radius"]))
    faces = np.empty((6, e, e, 4), np.float32)
    for f in range(6):
        base = zenith if f == 2 else np.array([0.3, 0.28, 0.25], np.float32) if f == 3 else side
        faces[f, ..., :3] = base + 0.05 * rng.standard_normal((e, e, 3), dtype=np.float32)
        d = dirs[f]
        cos = (d[0] * s[0] + d[1] * s[1] + d[2] * s[2]) / np.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        w = np.clip(2.0 - np.arccos(np.clip(cos, -1.0, 1.0)) / r0, 0.0, 1.0)
        w = w * w * (3.0 - 2.0 * w)
        faces[f, ..., :3] += (float(sun["peak"]) * w)[..., None].astype(np.float32)
    faces[..., 3] = 1.0
    return np.clip(faces, 0.0, None).astype(np.float16)


def sign_mesh() -> S.MeshArrays:
    """A double-sided [-1, 1]² quad at z = 0 with uv0: the front (its
    triangles facing a camera at -z, normals -z) on vertices 0-3, the back
    on 4-7."""
    p = np.array([[-1, 1, 0], [1, 1, 0], [1, -1, 0], [-1, -1, 0]], np.float32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([[0, 1, 2], [2, 3, 0], [4, 6, 5], [6, 4, 7]], np.int64)
    pos = np.concatenate([p, p])
    return S.MeshArrays(pos, S.smooth_normals(pos, idx), idx, np.concatenate([uv, uv]))


def column_weights(positions: np.ndarray, joints: int = 4) -> tuple:
    """((V, 4) joint ids, (V, 4) weights) of the column mesh: a vertex at
    height y blends the two joints around it linearly (scenes'
    skinned_column_mesh)."""
    s = (positions[:, 1] + 1.0) * 0.5 * (joints - 1)
    j0 = np.minimum(np.floor(s), joints - 2).astype(np.int64)
    w1 = (s - j0).astype(np.float32)
    ji = np.zeros((len(positions), 4), np.int64)
    ji[:, 0], ji[:, 1] = j0, j0 + 1
    jw = np.zeros((len(positions), 4), np.float32)
    jw[:, 0], jw[:, 1] = 1.0 - w1, w1
    return ji, jw


def column_pose(bend, twist, joints: int = 4) -> tuple:
    """((..., J, 4, 4) global transforms, (J, 4, 4) inverse binds) of
    columns' joints at bends and twists of any shape (scenes.column_pose):
    joint k sits at height y = -1 + 2k / (J - 1) and turns by bend * k /
    (J - 1) about z and twist * k / (J - 1) about y around that point, the
    global T(0, y, 0) Rz Ry."""
    a = np.arange(joints) / (joints - 1)
    y = -1.0 + 2.0 * a
    b = np.asarray(bend, np.float64)[..., None] * a
    t = np.asarray(twist, np.float64)[..., None] * a
    cb, sb, ct, st = np.cos(b), np.sin(b), np.cos(t), np.sin(t)
    g = np.zeros(b.shape + (4, 4), np.float32)
    g[..., 0, 0], g[..., 0, 1], g[..., 0, 2] = cb * ct, -sb, cb * st
    g[..., 1, 0], g[..., 1, 1], g[..., 1, 2], g[..., 1, 3] = sb * ct, cb, sb * st, y
    g[..., 2, 0], g[..., 2, 2], g[..., 3, 3] = -st, ct, 1.0
    return g, np.stack([S.translation([0.0, -v, 0.0]) for v in y])


def hud_image(width: int, height: int, hud: dict) -> np.ndarray:
    """(H, W, 4) u8: the HUD (the module's docstring), from `layout_seed`:
    a bottom bar `bar_height` high, a `minimap`² panel `margin` from the top
    right corner with a grid every 32 pixels, and `lines` lines of glyph
    blocks from the top left, each glyph a 3x5 pattern of 2x2 cells; parts
    past a smaller target are cut."""
    rng = np.random.default_rng(int(hud["layout_seed"]))
    img = np.zeros((height, width, 4), np.uint8)
    bar, mm, margin = int(hud["bar_height"]), int(hud["minimap"]), int(hud["margin"])
    img[max(0, height - bar):] = (20, 24, 32, round(255 * hud["bar_alpha"]))
    x0, y1 = max(0, width - margin - mm), min(height, margin + mm)
    panel = img[margin:y1, x0:width - margin]
    panel[:] = (30, 60, 40, round(255 * hud["minimap_alpha"]))
    yy, xx = np.mgrid[0:panel.shape[0], 0:panel.shape[1]]
    panel[((yy % 32) == 0) | ((xx % 32) == 0), :3] = (90, 140, 100)
    for line in range(int(hud["lines"])):
        y = margin + 14 * line
        for k in range(int(rng.integers(8, 48))):
            x = margin + 8 * k
            cells = rng.random((5, 3)) < 0.55
            block = np.repeat(np.repeat(cells, 2, 0), 2, 1)
            sub = img[y:y + 10, x:x + 6]
            sub[block[:sub.shape[0], :sub.shape[1]]] = (235, 235, 220, 255)
    return img


def _walls(b: int, buildings, side: int) -> list:
    """The outward normals (x, z) of building b's four walls, the wall
    nearest its grid cell's street first."""
    _oi, (x, _h, z), (w, _hy, _wz) = buildings[b]
    cx, cz = (b % side - side / 2) * 8.0, (b // side - side / 2) * 8.0
    gaps = []
    for n in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        centre, street = (x, cx) if n[0] else (z, cz)
        sgn = n[0] + n[1]
        gaps.append(((street + 4.0 * sgn - (centre + w * sgn)) * sgn, n))
    return [n for _g, n in sorted(gaps)]


def _signs(city: S.Scene, features: dict, rng) -> list:
    """[(archetype, transform, centre, normal, width)] of the signs, the
    archetypes in ARCHETYPES' order."""
    counts = features["signs"]
    n = sum(counts.values())
    nb = len(city.buildings)
    if n > 2 * nb:
        raise ValueError(f"{n} signs for {nb} buildings (two walls a building)")
    side = int(np.ceil(np.sqrt(nb)))
    order = rng.permutation(nb)
    kinds = np.repeat(np.arange(len(ARCHETYPES)), [counts[a] for a in ARCHETYPES])
    kinds = kinds[rng.permutation(n)]
    out = []
    for k in range(n):
        b = int(order[k % nb])
        _oi, (x, h, z), (w, _hy, _wz) = city.buildings[b]
        nx, nz = _walls(b, city.buildings, side)[k // nb]
        width = rng.uniform(1.5, min(3.0, 2.0 * w - 0.2))
        height = 0.5 * width
        y = rng.uniform(3.0, max(3.0, min(5.0, 2.0 * h - 0.5 * height - 0.1)))
        t = rng.uniform(-1.0, 1.0) * (w - 0.5 * width - 0.1)
        centre = np.array([x + nx * (w + WALL_GAP) - nz * t, y, z + nz * (w + WALL_GAP) + nx * t], np.float32)
        m = S.translation(centre) @ S.rotation_y(math.atan2(-nx, -nz)) @ S.scale([0.5 * width, 0.5 * height, 1.0])
        out.append((list(ARCHETYPES)[kinds[k]], m, centre, np.array([nx, 0.0, nz], np.float32), width))
    return out


def _column_spots(city: S.Scene, features: dict, rng) -> np.ndarray:
    """(C, 2) x, z: street spots at least `clearance` from every footprint
    and 1.5 m from each other, drawn uniformly over the city."""
    n, need, hw = int(features["columns"]), float(features["clearance"]), city.half_width
    out = np.zeros((0, 2))
    for _ in range(1000):
        pts = rng.uniform(-hw, hw, (4 * n, 2))
        for p in pts[clearance(city.buildings, pts) >= need]:
            if len(out) < n and (not len(out) or np.hypot(*(out - p).T).min() >= 1.5):
                out = np.concatenate([out, p[None]])
        if len(out) == n:
            return out.astype(np.float32)
    raise ValueError(f"found {len(out)} spots for {n} columns")


def build_scene(config: dict, seed: int) -> FeatureScene:
    """The city of `config` and its features (the module's docstring)."""
    city = S.build_scene(config, seed)
    out = FeatureScene(**{f.name: getattr(city, f.name) for f in dataclasses.fields(S.Scene)})
    ft = config["features"]
    layout = np.random.default_rng(int(ft["layout_seed"]))
    colour = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 7])
    out.sky = sky_faces(ft, seed, city.lights[0].direction)
    out.hud = hud_image(city.width, city.height, ft["hud"])
    out.exposure = float(ft["exposure"])
    out.routine = [None] * len(out.materials)

    out.meshes.append(sign_mesh())
    quad = len(out.meshes) - 1
    out.first_sign = len(out.obj_mesh)
    out.sign_boxes = []
    for arch, m, centre, normal, width in _signs(city, ft, layout):
        c = colour.uniform(0.15, 0.95, 3)
        if arch == "HiddenSignMaterial":
            c = np.array([1.0, 0.0, 1.0])
        alpha = 0.45 if ARCHETYPES[arch] == "blend" else 1.0
        out.materials.append(S.MaterialArrays(albedo=np.array([*c, alpha], np.float32),
                                              cutout=0.5 if ARCHETYPES[arch] == "cutout" else 0.0,
                                              blend=ARCHETYPES[arch] == "blend"))
        out.routine.append(arch)
        out.add_object(quad, len(out.materials) - 1, m)
        out.sign_boxes.append((centre, normal, width))

    col = S.subdivided_cube(8)
    out.meshes.append(col)
    out.column_mesh = len(out.meshes) - 1
    out.joint_ids, out.weights = column_weights(col.positions)
    out.inverse_binds = column_pose(0.0, 0.0)[1]
    out.materials.append(S.MaterialArrays(albedo=np.array([0.75, 0.72, 0.68, 1.0], np.float32), roughness=0.6))
    out.routine.append(None)
    out.first_column = len(out.obj_mesh)
    spots = _column_spots(city, ft, layout)
    out.heights = layout.uniform(3.0, 6.0, len(spots)).astype(np.float32)
    for (x, z), h in zip(spots, out.heights):
        out.add_object(out.column_mesh, len(out.materials) - 1,
                       S.translation([x, 0.5 * h, z]) @ S.scale([0.3, 0.5 * h, 0.3]))
    return out


class Traffic(T.Traffic):
    """The mix's camera (traffic.Traffic's), the columns' sway and the
    close-up views of the check (`closeups`, filled by Port.close)."""

    def __init__(self, mix: dict, scene: FeatureScene, seed: int):
        super().__init__(mix, scene, seed)
        self.sway = mix["sway"]
        self.period = math.lcm(self.period, int(self.sway["cycle_frames"]))
        self.seed = int(seed)
        self.closeups = []

    def joint_globals(self, frame: int) -> np.ndarray:
        """(C, 4, 4, 4) f32 joint globals of every column at `frame`."""
        sw = self.sway
        phase = 2 * np.pi * (frame % int(sw["cycle_frames"])) / int(sw["cycle_frames"])
        k = np.arange(self.scene.columns)
        return column_pose(sw["bend"] * np.sin(phase + sw["bend_offset"] * k),
                           sw["twist"] * np.cos(phase + sw["twist_offset"] * k))[0]

    def apply(self, port, frame: int) -> None:
        super().apply(port, frame)
        r, ib = port.renderer, self.scene.inverse_binds
        for sk, g in zip(port.skeletons, self.joint_globals(frame)):
            r.set_skeleton_joint_transforms(sk, g, ib)

    def state(self, frame: int) -> dict:
        return {**super().state(frame), "joints": self.joint_globals(frame), "closeups": self.closeups}

    def closeup_views(self) -> list:
        """[(frame, label, view, lit)]: a column, a sign of each archetype of
        the close-ups' `signs`, then a lit sign for each entry of `lit` (the
        module's docstring), each at a frame drawn from the seed; lit: in the
        scene's own light (else the ambient term alone)."""
        rng = np.random.default_rng([self.seed & 0xFFFFFFFF, self.seed >> 32, 8])
        cu = self.mix["closeup"]
        views = ([self._column_view(rng) + (False,)] + [self._sign_view(rng, arch) + (False,) for arch in cu["signs"]]
                 + [self._lit_sign_view(rng, mode) + (True,) for mode in cu.get("lit", ())])
        frames = rng.integers(self.period, size=len(views))
        return [(int(f), f"frame {f}, {label}", view, lit) for f, (label, view, lit) in zip(frames, views)]

    def _column_view(self, rng) -> tuple:
        """(label, view) of the first column, in an order drawn from `rng`,
        that a heading (of 64, from one drawn) sees from below with the
        ground line clear of every building by 0.3 m."""
        sc, cu = self.scene, self.mix["closeup"]
        for c in rng.permutation(sc.columns):
            h = float(sc.heights[c])
            foot = sc.transforms[sc.first_column + c][[0, 2], 3].astype(np.float64)
            d = cu["distance"] * h
            line = np.linspace(-cu["beyond"], d, 64)[:, None]
            for a in rng.uniform(0, 2 * np.pi) + 2 * np.pi * np.arange(64) / 64:
                heading = np.array([math.cos(a), math.sin(a)])
                if clearance(sc.buildings, foot + line * heading).min() >= 0.3:
                    eye = np.array([foot[0] + d * heading[0], cu["eye_height"], foot[1] + d * heading[1]])
                    return f"column {c}", look_at_lh(eye, [foot[0], h, foot[1]])
        raise ValueError("no column's top is in sight from below")

    def _sign_view(self, rng, arch: str) -> tuple:
        """(label, view) of the first sign of archetype `arch`, in an order
        drawn from `rng`, seen from in front at the farthest of 8 distances
        from twice its width to 1 m whose sight line passes 0.3 m clear of
        every building."""
        sc = self.scene
        signs = [k for k in range(len(sc.sign_boxes)) if sc.routine[sc.obj_material[sc.first_sign + k]] == arch]
        for k in rng.permutation(signs):
            centre, normal, width = sc.sign_boxes[k]
            for d in np.linspace(2.0 * width, 1.0, 8):
                line = (centre + np.linspace(0.5, d, 16)[:, None] * normal)[:, [0, 2]]
                if clearance(sc.buildings, line).min() >= 0.3:
                    return f"{arch} sign {k}", look_at_lh(centre + d * normal, centre)
        raise ValueError(f"no {arch} sign is in sight from in front")

    def _lit_sign_view(self, rng, mode: str) -> tuple:
        """(label, view) of the first SignMaterial sign, in an order drawn
        from `rng`, whose wall faces the key light and that is wholly in it
        ("light") or wholly in a building's shadow ("shadow"), seen from 0.7
        times its half-width in front (the module's docstring). A light
        behind the sign's wall is not looked at; any other that it faces
        must light it wholly or not at all."""
        sc = self.scene
        lo, hi, building = _caster_boxes(sc)
        to_light = [-lt.direction / np.linalg.norm(lt.direction) for lt in sc.lights]
        lit = [k for k in range(len(sc.sign_boxes)) if sc.routine[sc.obj_material[sc.first_sign + k]] == "SignMaterial"]
        for k in rng.permutation(lit):
            centre, normal, width = sc.sign_boxes[k]
            if float(normal @ to_light[0]) < 0.3:
                continue
            keep = np.ones(len(lo), bool)
            keep[sc.first_sign + k] = False
            keep[_wall_of(sc, centre, normal)] = False
            m = sc.transforms[sc.first_sign + k]
            right = m[:3, 0] / np.linalg.norm(m[:3, 0])
            a, b = np.meshgrid(np.linspace(-0.5, 0.5, 7) * width, np.linspace(-0.25, 0.25, 4) * width)
            face = centre + 0.01 * normal + a.reshape(-1, 1) * right + b.reshape(-1, 1) * np.array([0.0, 1.0, 0.0])
            if not self._lit_as(mode, face[:1], to_light[0], sc.lights[0], lo, hi, keep, building, margin=False):
                continue
            if not all(self._lit_as(mode if li == 0 else "either", face, d, lt, lo, hi, keep, building)
                       for li, (lt, d) in enumerate(zip(sc.lights, to_light)) if float(normal @ d) > 0.0):
                continue
            eye = centre + 0.35 * width * normal
            if _ray_hits(np.repeat(eye[None], len(face), 0), face - eye, lo[keep], hi[keep], 1.0).any():
                continue
            return f"SignMaterial sign {k} in {mode}", look_at_lh(eye, centre)
        raise ValueError(f"no SignMaterial sign facing the key light is wholly in {mode}")

    @staticmethod
    def _lit_as(mode, points, to_light, light, lo, hi, keep, building, margin=True) -> bool:
        """Whether every ray toward the light from `points` (moved across the
        light's direction over 3.5 of its shadow texels each way, where
        `margin`) meets no caster's box ("light"), a building's box
        ("shadow"), or either of the two for all of them ("either")."""
        if margin:
            e1 = np.cross(to_light, [0.0, 1.0, 0.0])
            e1 /= np.linalg.norm(e1)
            e2 = np.cross(to_light, e1)
            o = np.linspace(-3.5, 3.5, 5) * light.distance / light.resolution
            shift = (o[:, None, None] * e1 + o[None, :, None] * e2).reshape(-1, 3)
            points = (points[:, None] + shift[None]).reshape(-1, 3)
        dirs = np.broadcast_to(to_light, points.shape)
        clear = mode != "shadow" and not _ray_hits(points, dirs, lo[keep], hi[keep], 1e4).any()
        hidden = mode != "light" and _ray_hits(points, dirs, lo[keep & building], hi[keep & building], 1e4).all()
        return clear or hidden


def _caster_boxes(scene: FeatureScene) -> tuple:
    """((N, 3) low and (N, 3) high world corners of each object's box, the
    mesh's bounds moved by its transform; a column's widened by 0.2 of its
    height and 0.3 m for its sway), (N,) whether it is a building; the
    ground (object 0) a box no ray from above meets."""
    lo, hi = [], []
    for oi, (mi, m) in enumerate(zip(scene.obj_mesh, scene.transforms)):
        p = scene.meshes[mi].positions @ m[:3, :3].T + m[:3, 3]
        lo.append(p.min(0))
        hi.append(p.max(0))
    lo, hi = np.array(lo), np.array(hi)
    lo[0, 1] = hi[0, 1] = -1.0
    grow = 0.2 * scene.heights + 0.3
    for axis in (0, 2):
        lo[scene.first_column:, axis] -= grow
        hi[scene.first_column:, axis] += grow
    building = np.zeros(len(lo), bool)
    building[[oi for oi, _c, _s in scene.buildings]] = True
    return lo, hi, building


def _wall_of(scene: FeatureScene, centre, normal) -> int:
    """The object index of the building whose wall a sign is on."""
    p = (centre - 0.06 * normal)[[0, 2]]
    for oi, (x, _h, z), (w, _hy, _wz) in scene.buildings:
        if abs(p[0] - x) <= w + 1e-3 and abs(p[1] - z) <= w + 1e-3:
            return oi
    raise ValueError("a sign on no building's wall")


def _ray_hits(origins, dirs, lo, hi, t_max: float) -> np.ndarray:
    """(R,) whether each ray origin + t dir, 1e-3 < t < t_max, meets any of
    the boxes [lo, hi] (slabs)."""
    if not len(lo):
        return np.zeros(len(origins), bool)
    d = np.where(np.abs(dirs) < 1e-12, 1e-12, dirs)[:, None]
    t0, t1 = (lo[None] - origins[:, None]) / d, (hi[None] - origins[:, None]) / d
    near = np.minimum(t0, t1).max(-1)
    far = np.maximum(t0, t1).min(-1)
    return ((near <= far) & (far > 1e-3) & (near < t_max)).any(1)


# -- the application's code on the port: routines and passes ------------------------


def lit_shade(pixels, mdata, mflags, dir_lights, point_lights, shadow_values, uniforms):
    """The opaque routine: rgb = colour x (ambient + the sum over the
    directional lights of colour x intensity x max(0, n . l) x shadow),
    alpha = the colour's, in view space."""
    n = pixels.nrm
    n = n / torch.sqrt((n * n).sum(1, keepdim=True)).clamp_min(1e-20)
    view3 = uniforms.view[:3, :3]
    light = torch.zeros_like(n)
    for k in range(dir_lights.mask.shape[0]):
        d = -dir_lights.direction[k]
        l = (view3[:, 0] * d[0] + view3[:, 1] * d[1] + view3[:, 2] * d[2])
        l = l / torch.sqrt((l * l).sum())
        nol = (n[:, 0] * l[0] + n[:, 1] * l[1] + n[:, 2] * l[2]).clamp(0.0, 1.0)
        if shadow_values is not None:
            nol = nol * shadow_values[k]
        light = light + torch.where(dir_lights.mask[k], nol[:, None] * dir_lights.color[k], torch.zeros_like(light))
    return torch.cat([mdata[:, :3] * (uniforms.ambient[:3] + light), mdata[:, 3:4]], 1)


def unlit_shade(pixels, mdata, mflags, dir_lights, point_lights, shadow_values, uniforms):
    """The cutout and blend routines: rgba = colour x vertex colour."""
    return mdata[:, :4] * pixels.vcol


def checker_alpha(pixels, mdata, mflags):
    """The cutout routine's alpha: a 4x4 checker over uv0, 0 or 1."""
    u, v = pixels.uv0[:, 0], pixels.uv0[:, 1]
    return torch.remainder(torch.floor(u * 4.0) + torch.floor(v * 4.0), 2.0)


def aces_pass(exposure: float):
    """The "hdr" pass: exposure, then the ACES fit on RGB, alpha kept."""

    def tonemap(img, gbuf, uniforms):
        x = img[..., :3] * exposure
        y = (x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14)
        return torch.cat([y.clamp(0.0, 1.0), img[..., 3:]], -1)

    return tonemap


def hud_pass(hud: torch.Tensor):
    """The "srgb" pass: the (H, W, 4) u8 HUD over the u8 frame,
    rgb + (hud - rgb) x hud alpha / 255 rounded half to even, alpha kept."""
    over = hud[..., :3].float()
    a = hud[..., 3:].float() / 255.0

    def composite(img, gbuf, uniforms):
        rgb = img[..., :3].float()
        return torch.cat([torch.round(rgb + (over - rgb) * a).to(torch.uint8), img[..., 3:]], -1)

    return composite


def _material_class(types, name: str, blend: bool):
    """A non-PBR material class whose archetype is `name`: a 4-float rgba
    data block, no textures (rend3_tpu_torch.scenes.flat_material_class)."""

    def init(self, color):
        self.color = np.asarray(color, np.float32)

    return type(name, (), {
        "__init__": init,
        "required_attributes": classmethod(lambda cls: (types.POSITION,)),
        "supported_attributes": classmethod(lambda cls: (types.POSITION,)),
        "data_size": classmethod(lambda cls: 4),
        "texture_count": classmethod(lambda cls: 0),
        "key": lambda self: 0,
        "sorting": lambda self: types.Sorting.blending() if blend else types.Sorting.opaque(),
        "to_textures": lambda self: [],
        "to_data": lambda self: self.color,
        "to_flags": lambda self: 0,
    })


class Port(adapter.Port):
    """The city through adapter.Port (its lights added here, whose handles
    the close-ups need); then the sky cube, the routines, the signs, the
    skinned columns (a skeleton and an AnimatedMeshKind object each) and
    the two passes; `render` passes the sky's slot."""

    def __init__(self, scene: FeatureScene, traffic, device: str):
        from rend3_tpu_torch import types
        from rend3_tpu_torch.routine.pbr.material import AlbedoComponent, PbrMaterial
        from rend3_tpu_torch.routine.registry import MaterialRoutine

        n_city = scene.first_sign
        city = {f.name: getattr(scene, f.name) for f in dataclasses.fields(S.Scene)}
        city.update(meshes=scene.meshes[:-2], materials=scene.materials[:scene.obj_material[n_city]],
                    obj_mesh=scene.obj_mesh[:n_city], obj_material=scene.obj_material[:n_city],
                    transforms=scene.transforms[:n_city], lights=[])
        super().__init__(S.Scene(**city), traffic, device)
        self.scene = scene
        r = self.renderer
        self.lights = [r.add_directional_light(types.DirectionalLight(
            color=light.color, intensity=light.intensity, direction=light.direction, distance=light.distance,
            resolution=light.resolution)) for light in scene.lights]
        self.sky = r.add_texture_cube(types.Texture(label="sky", data=scene.sky,
                                                    format=types.TextureFormat[SKY_FORMAT],
                                                    mip_count=types.MipmapCount.ONE))
        classes = {a: _material_class(types, a, kind == "blend") for a, kind in ARCHETYPES.items()}
        for rt in (MaterialRoutine(classes["SignMaterial"], lit_shade),
                   MaterialRoutine(classes["CutoutSignMaterial"], unlit_shade, transparency="cutout",
                                   alpha=checker_alpha, alpha_cutoff=0.5),
                   MaterialRoutine(classes["GlassSignMaterial"], unlit_shade, transparency="blend")):
            self.graph.register_routine(rt)
        m = scene.meshes[-2]
        quad = r.add_mesh(types.MeshBuilder(m.positions, types.Handedness.LEFT).with_vertex_normals(m.normals)
                          .with_vertex_uv0(m.uv0).with_indices(m.indices.astype(np.uint32).reshape(-1)).build())
        self.keep += [quad, self.sky]
        for oi in range(scene.first_sign, scene.first_column):
            mi = scene.obj_material[oi]
            mat = r.add_material(classes[scene.routine[mi]](scene.materials[mi].albedo))
            self.keep.append(mat)
            self.objects.append(r.add_object(types.Object(mesh_kind=types.StaticMeshKind(quad), material=mat,
                                                          transform=scene.transforms[oi])))
        m = scene.meshes[scene.column_mesh]
        mesh = r.add_mesh(types.MeshBuilder(m.positions, types.Handedness.LEFT).with_vertex_normals(m.normals)
                          .with_vertex_uv0(m.uv0).with_vertex_joint_indices(scene.joint_ids)
                          .with_vertex_joint_weights(scene.weights)
                          .with_indices(m.indices.astype(np.uint32).reshape(-1)).build())
        ma = scene.materials[scene.obj_material[scene.first_column]]
        mat = r.add_material(PbrMaterial(albedo=AlbedoComponent(value=ma.albedo), roughness_factor=ma.roughness,
                                         metallic_factor=ma.metallic))
        self.keep += [mesh, mat]
        rest = np.tile(np.eye(4, dtype=np.float32), (len(scene.inverse_binds), 1, 1))
        self.skeletons = []
        for oi in range(scene.first_column, len(scene.obj_mesh)):
            sk = r.add_skeleton(types.Skeleton(mesh=mesh, joint_matrices=rest))
            self.skeletons.append(sk)
            self.objects.append(r.add_object(types.Object(mesh_kind=types.AnimatedMeshKind(sk), material=mat,
                                                          transform=scene.transforms[oi])))
        self.graph.register_pass(aces_pass(scene.exposure), stage="hdr")
        self.graph.register_pass(hud_pass(self.torch.from_numpy(scene.hud).to(device)), stage="srgb")

    def render(self, ev):
        """Steps 4 and 5, with the sky cube's slot."""
        img = self.graph.render_frame_tensor(ev, self.target, self.settings, skybox_slot=self.sky.idx)
        if self.cuda:
            self.torch.cuda.synchronize()
        return img

    def close(self) -> None:
        """Renders the check's close-up views (the module's docstring) into
        the traffic's `closeups`, then frees the port."""
        from rend3_tpu_torch.routine.base import BaseRenderGraphSettings

        lit_settings = self.settings
        self.traffic.closeups = []
        for frame, label, view, lit in self.traffic.closeup_views():
            for light, src in zip(self.lights, self.scene.lights):
                self.renderer.update_directional_light(light, intensity=src.intensity if lit else 0.0)
            self.settings = lit_settings if lit else BaseRenderGraphSettings(ambient_color=CLOSEUP_AMBIENT)
            self.apply(frame)
            self.set_camera(view)
            state = {**self.traffic.state(frame), "view": view, "lit": lit}
            del state["closeups"]
            self.traffic.closeups.append((label, state, self.render(self.evaluate())))
        self.skeletons = self.lights = self.sky = None
        super().close()


# -- the reference -----------------------------------------------------------------


def _encode_u8(img: torch.Tensor) -> torch.Tensor:
    """Linear (..., 4) -> u8, sRGB colour, alpha linear, round half to even."""
    rgb = img[..., :3].clamp(0, 1)
    rgb = torch.where(rgb > 0.0031308, 1.055 * rgb ** (1.0 / 2.4) - 0.055, rgb * 12.92)
    return torch.round(torch.cat([rgb, img[..., 3:].clamp(0, 1)], -1) * 255.0).to(torch.uint8)


class Reference(reference.Reference):
    """reference.Reference with the features (the module's docstring). The
    columns' skinning, the close-ups' ambient light and the answer are
    crowd.Reference's: its `skin` over this scene's column mesh, and its
    `render`, which judges the close-ups once (judge_closeups, each view in
    its own light) and answers each frame with `posed`."""

    skin = crowd.Reference.skin
    closeup_light = crowd.Reference.closeup_light
    render = crowd.Reference.render

    def __init__(self, scene: FeatureScene, device: str = "cpu", tf32: bool = False, chunk: int = 1 << 23):
        super().__init__(scene, device, tf32, chunk)
        dev = self.dev
        code = {None: _PBR, "SignMaterial": _LIT, "CutoutSignMaterial": _UNLIT, "GlassSignMaterial": _UNLIT,
                "HiddenSignMaterial": -1}
        self.m_routine = torch.tensor([code[a] for a in scene.routine], dtype=torch.long, device=dev)
        # The hidden archetype's triangles leave the frame and the maps.
        keep = torch.nonzero(self.m_routine[self.obj_mat][self.tri_obj] >= 0).flatten()
        for name in ("tri_pos", "tri_nrm", "tri_uv", "tri_obj", "kind"):
            setattr(self, name, getattr(self, name)[keep])
        m = scene.meshes[scene.column_mesh]
        self.n_static = len(self.tri_pos) - scene.columns * len(m.indices)
        self.rest_pos, self.rest_nrm = self.tri_pos, self.tri_nrm
        self.v_pos = torch.from_numpy(m.positions).to(dev)
        self.v_nrm = torch.from_numpy(m.normals).to(dev)
        self.v_idx = torch.from_numpy(m.indices).to(dev)
        self.joint_ids = torch.from_numpy(scene.joint_ids).to(dev)
        self.weights = torch.from_numpy(scene.weights).to(dev)
        self.inverse_binds = torch.from_numpy(scene.inverse_binds).to(dev)
        self.sky = torch.from_numpy(scene.sky.astype(np.float32)).to(dev)
        self.hud = torch.from_numpy(scene.hud).to(dev)
        self.closeups_ok = None
        self.cover = None

    def judge_closeups(self, closeups: list) -> bool:
        """Whether the port's close-up images ([(label, state, image)], the
        state's `lit` saying whether the view is in the scene's light or in
        the close-ups' ambient light) pass compare.judge against this
        reference's; logs each one's numbers."""
        per_view = []
        for label, state, image in closeups:
            state = dict(state)
            with contextlib.nullcontext() if state.pop("lit") else self.closeup_light():
                answer = self.posed(**state)
            per_view.append(compare.frame_numbers(image.to(answer["lo"].device), answer))
            print(f"[bench] close-up ({label}): " + ", ".join(f"{k} {v:.6g}" for k, v in per_view[-1].items()),
                  file=sys.stderr, flush=True)
        ok, worst = compare.judge(per_view)
        print(f"[bench] close-ups: {'passed' if ok else 'refused'}; worst {worst}", file=sys.stderr, flush=True)
        return ok

    # -- the routines --------------------------------------------------------------

    def _alpha(self, mat, uv, duv):
        chk = torch.remainder(torch.floor(uv[:, 0] * 4.0) + torch.floor(uv[:, 1] * 4.0), 2.0)
        return torch.where(self.m_routine[mat] == _UNLIT, chk, super()._alpha(mat, uv, duv))

    def _shade(self, world, nrm, uv, duv, mat, shadow, eye):
        out = super()._shade(world, nrm, uv, duv, mat, shadow, eye)
        r = self.m_routine[mat]
        if not bool((r != _PBR).any()):
            return out
        col = self.m_albedo[mat]
        light = torch.zeros_like(col[:, :3])
        for k, (li, _off, _size) in enumerate(self.plan):
            lt = self.scene.lights[li]
            ld = torch.from_numpy(-lt.direction).to(self.dev)
            ld = ld / torch.sqrt((ld * ld).sum())
            nol = (nrm * ld).sum(1).clamp(0, 1) * shadow[k]
            light = light + nol[:, None] * torch.from_numpy(lt.color * np.float32(lt.intensity)).to(self.dev)
        amb = torch.tensor(self.scene.ambient, dtype=torch.float32, device=self.dev)
        lit = torch.cat([col[:, :3] * (amb[:3] + light), col[:, 3:]], 1)
        return torch.where((r == _LIT)[:, None], lit, torch.where((r == _UNLIT)[:, None], col, out))

    # -- the sky, the skinning, the passes -----------------------------------------

    def sky_rgb(self, view: np.ndarray) -> torch.Tensor:
        """(H * W, 3) the sky at every pixel centre: the view ray's world
        direction, its major axis's face, in-face texel coordinates, the four
        taps clamped to the face, bilinear."""
        W, H = self.scene.width, self.scene.height
        f = 1.0 / math.tan(math.radians(self.scene.vfov) / 2)
        py, px = torch.meshgrid(torch.arange(H, device=self.dev) + 0.5, torch.arange(W, device=self.dev) + 0.5,
                                indexing="ij")
        d_view = torch.stack([(px / W * 2 - 1) * (W / H) / f, (1 - py / H * 2) / f, torch.ones_like(px)], -1)
        rot = torch.from_numpy(np.ascontiguousarray(view[:3, :3])).to(self.dev)
        d = (d_view.reshape(-1, 3)[:, :, None] * rot).sum(1)        # R^T d, a sum over the rows
        x, y, z = d[:, 0], d[:, 1], d[:, 2]
        ax, ay, az = x.abs(), y.abs(), z.abs()
        is_x = (ax >= ay) & (ax >= az)
        is_y = ~is_x & (ay >= az)
        face = torch.where(is_x, torch.where(x > 0, 0, 1), torch.where(is_y, torch.where(y > 0, 2, 3),
                                                                       torch.where(z > 0, 4, 5)))
        ma = torch.where(is_x, ax, torch.where(is_y, ay, az))
        uc = torch.where(is_x, torch.where(x > 0, -z, z), torch.where(is_y, x, torch.where(z > 0, x, -x)))
        vc = torch.where(is_y, torch.where(y > 0, z, -z), -y)
        e = self.sky.shape[1]
        xf = 0.5 * (uc / ma + 1.0) * e - 0.5
        yf = 0.5 * (vc / ma + 1.0) * e - 0.5
        x0, y0 = torch.floor(xf), torch.floor(yf)
        fx, fy = (xf - x0)[:, None], (yf - y0)[:, None]

        def tap(xi, yi):
            return self.sky[face, yi.long().clamp(0, e - 1), xi.long().clamp(0, e - 1), :3]

        top = tap(x0, y0) * (1 - fx) + tap(x0 + 1, y0) * fx
        bot = tap(x0, y0 + 1) * (1 - fx) + tap(x0 + 1, y0 + 1) * fx
        return top * (1 - fy) + bot * fy

    def tonemap(self, img: torch.Tensor) -> torch.Tensor:
        """The "hdr" pass on (..., 4) linear values."""
        x = img[..., :3] * self.scene.exposure
        y = (x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14)
        return torch.cat([y.clamp(0.0, 1.0), img[..., 3:]], -1)

    def overlay(self, img: torch.Tensor) -> torch.Tensor:
        """The "srgb" pass on an (H, W, 4) u8 image."""
        a = self.hud[..., 3:].float() / 255.0
        rgb = img[..., :3].float()
        return torch.cat([torch.round(rgb + (self.hud[..., :3].float() - rgb) * a).to(torch.uint8), img[..., 3:]], -1)

    # -- the frame ------------------------------------------------------------------

    @torch.no_grad()
    def posed(self, view: np.ndarray, transforms: np.ndarray, joints: np.ndarray) -> dict:
        """reference.Reference.render's answer over the posed columns, with
        the sky, the routines, the tonemap and the HUD; `cover` keeps where
        the sky and each surface's material lie."""
        pos, nrm = self.skin(joints)
        self.tri_pos = torch.cat([self.rest_pos[: self.n_static], pos.reshape(-1, 3, 3)])
        self.tri_nrm = torch.cat([self.rest_nrm[: self.n_static], nrm.reshape(-1, 3, 3)])
        try:
            imgs, alt = self._linear(view, transforms)
        finally:
            self.tri_pos, self.tri_nrm = self.rest_pos, self.rest_nrm
        H, W = self.scene.height, self.scene.width
        u8 = torch.stack([self.overlay(_encode_u8(self.tonemap(i.reshape(H, W, 4).half().float()))) for i in imgs])
        return {"image": u8[0], "lo": u8.amin(0), "hi": u8.amax(0), "ambiguous": float((alt >= 0).double().mean())}

    def _linear(self, view, transforms):
        """reference.Reference.render up to its encoding, with the sky where
        no opaque or cutout surface covers a pixel: ([the four linear
        (H * W, 4) images], the alternative surface's rows)."""
        R = reference
        W, H = self.scene.width, self.scene.height
        eye = np.linalg.inv(view).astype(np.float32)[:3, 3]
        tr = torch.from_numpy(np.ascontiguousarray(transforms, np.float32)).to(self.dev)
        world = self._world(tr)
        m3 = tr[:, :3, :3]
        inv_s2 = 1.0 / torch.clamp_min((m3 * m3).sum(1), 1e-30)

        def normals(src):
            o = self.tri_obj[src]
            return R._normalize(self._mm(self.tri_nrm[src] * inv_s2[o][:, None, :], m3[o].transpose(1, 2)))

        frame = {"world": world, "normals": normals, "view": view}
        vp = (self.proj @ view).astype(np.float32)
        t = self._setup(self._clip_space(world, vp), self.kind != 2, W, H, keep_front=True)
        kind = self.kind[t.src]
        tri_o = R._subset(t, kind == 0)
        row, depth = self._nearest(tri_o, W, H)
        row2, depth2 = self._nearest(tri_o, W, H, lambda rows, pix, *_: rows != row[pix])
        alt = torch.where((row >= 0) & (row2 >= 0) & (depth - depth2 <= R.DEPTH_TIE * depth), row2, -1)
        surf_t, surf_row = tri_o, row
        if bool((kind == 1).any()):
            tri_c = R._subset(t, kind == 1)

            def passes(rows, pix, px, py, lam, z):
                front = (row[pix] < 0) | (z > depth[pix])
                ok = front.clone()
                if bool(front.any()):
                    f = torch.nonzero(front).flatten()
                    _w, _n, uv, duv, mat = self._surface(tri_c, rows[f], lam[f], frame)
                    ok[f] = self._alpha(mat, uv, duv) >= self.m_scalar[mat, 3]
                return ok

            crow, cdepth = self._nearest(tri_c, W, H, passes)
            take = crow >= 0
            near_tie = take & (row >= 0) & (cdepth - depth <= R.DEPTH_TIE * cdepth)
            alt = torch.where(take, torch.where(near_tie, row, -1), alt)
            depth = torch.where(take, cdepth, depth)
            surf_t = R._merge(tri_o, tri_c)
            surf_row = torch.where(take, crow + len(tri_o), row)
        maps = self._shadow_maps(frame)
        sky = torch.cat([self.sky_rgb(view), torch.ones(W * H, 1, device=self.dev)], 1)
        background = torch.where((surf_row < 0)[:, None], sky, torch.zeros_like(sky))
        imgs = [background.clone() for _ in range(2)]
        surf_code = torch.full_like(surf_row, -1)
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
                      for tie in (-R.SHADOW_TIE, R.SHADOW_TIE)]
            if out:
                for k in range(2):
                    img = imgs[k].clone()
                    img[hit] = shaded[k]
                    imgs.append(img)
            else:
                surf_code[hit] = mat
                for k in range(2):
                    imgs[k][hit] = shaded[k]
        self.cover = {"sky": surf_row < 0, "surface_material": surf_code, "depth": depth}
        if bool((self.kind == 2).any()):
            tb = self._setup(self._clip_space(world, vp), self.kind == 2, W, H, keep_front=True)
            cover = self._blend(tb, surf_row, depth, frame, maps, eye)
            if cover is not None:
                C, A = cover
                imgs = [torch.cat([C + (1.0 - A)[:, None] * i[:, :3], (A + (1.0 - A) * i[:, 3])[:, None]], 1)
                        for i in imgs]
        return imgs, alt
