"""The benchmark's scene generator: the port's procedural city as plain arrays.

A copy of rend3_tpu_torch/scenes.py's `build_city_scene`, `_subdivided_cube`,
`_proc_texture` and `set_bench_camera`, rewritten to return NumPy arrays
(meshes, textures, materials, object transforms, lights and the camera)
instead of calling a renderer. `adapter.py` submits them to the port and
`reference.py` renders them, so both read the same inputs.

The layout (building positions and sizes, foliage and glass placement) is
drawn from the configuration's `layout_seed` in the bench's own order, so
seed 7 gives the bench's city. The run's seed draws only what changes no
amount of work: the texture colours, the roughness texels and the flat
materials' colours. Normals are computed here (area-weighted smooth normals,
MeshBuilder's rule) and handed to the port, so the two sides shade the same
normals.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

__all__ = [
    "MeshArrays", "TextureArrays", "MaterialArrays", "LightArrays", "Scene", "build_scene", "look_at_lh",
    "translation", "scale", "rotation_x", "rotation_y", "smooth_normals",
]


@dataclass
class MeshArrays:
    positions: np.ndarray            # (V, 3) f32
    normals: np.ndarray              # (V, 3) f32
    indices: np.ndarray              # (T, 3) int64
    uv0: Optional[np.ndarray] = None  # (V, 2) f32, or None (no texture coordinates)


@dataclass
class TextureArrays:
    rgba: np.ndarray   # (H, W, 4) u8
    srgb: bool         # sRGB-encoded colour channels


@dataclass
class MaterialArrays:
    albedo: np.ndarray           # (4,) f32 factor
    albedo_tex: int = -1         # texture index, -1 for none
    aomr_tex: int = -1           # combined AO (r) / roughness (g) / metallic (b) texture, -1 for none
    roughness: float = 0.0
    metallic: float = 0.0
    reflectance: float = 0.5
    cutout: float = 0.0          # alpha cutoff; 0 for none
    blend: bool = False          # alpha blended


@dataclass
class LightArrays:
    color: np.ndarray       # (3,)
    intensity: float
    direction: np.ndarray   # (3,), not normalised
    distance: float         # side of the orthographic shadow volume
    resolution: int         # shadow map side (a power of two)


@dataclass
class Scene:
    width: int
    height: int
    ambient: tuple
    vfov: float
    near: float
    eye: np.ndarray
    target: np.ndarray
    half_width: float
    samples: int = 1
    meshes: List[MeshArrays] = field(default_factory=list)
    textures: List[TextureArrays] = field(default_factory=list)
    materials: List[MaterialArrays] = field(default_factory=list)
    lights: List[LightArrays] = field(default_factory=list)
    obj_mesh: List[int] = field(default_factory=list)
    obj_material: List[int] = field(default_factory=list)
    transforms: List[np.ndarray] = field(default_factory=list)
    # Buildings: object index, base position (x, h, z) and scale (w, h, w).
    buildings: List[tuple] = field(default_factory=list)

    def add_object(self, mesh: int, material: int, transform: np.ndarray) -> int:
        self.obj_mesh.append(mesh)
        self.obj_material.append(material)
        self.transforms.append(np.asarray(transform, np.float32))
        return len(self.obj_mesh) - 1

    def triangles(self) -> int:
        return sum(len(self.meshes[m].indices) for m in self.obj_mesh)


# -- float32 matrices, as the port's utils/math builds them --------------------


def _mat4(rows) -> np.ndarray:
    return np.array(rows, dtype=np.float32)


def translation(t) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(t, dtype=np.float32)
    return m


def scale(s) -> np.ndarray:
    s = np.broadcast_to(np.asarray(s, dtype=np.float32), (3,))
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def rotation_x(rad: float) -> np.ndarray:
    c, s = np.cos(rad), np.sin(rad)
    return _mat4([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]])


def rotation_y(rad: float) -> np.ndarray:
    c, s = np.cos(rad), np.sin(rad)
    return _mat4([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]])


def look_at_lh(eye, center, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Left-handed look-at view matrix (the camera looks down +Z)."""
    eye = np.asarray(eye, dtype=np.float32)
    center = np.asarray(center, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(up, f)
    s = s / np.linalg.norm(s)
    u = np.cross(f, s)
    m = np.eye(4, dtype=np.float32)
    m[0, :3], m[1, :3], m[2, :3] = s, u, f
    m[0, 3], m[1, 3], m[2, 3] = -np.dot(s, eye), -np.dot(u, eye), -np.dot(f, eye)
    return m


# -- meshes and textures -----------------------------------------------------------


def smooth_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted smooth normals of a left-handed mesh (edge1 x edge2
    summed at each corner, then normalised; a vertex whose faces cancel
    keeps a zero normal), MeshBuilder's rule."""
    tris = indices.astype(np.int64)
    p0 = positions[tris[:, 0]]
    face_n = np.cross(positions[tris[:, 1]] - p0, positions[tris[:, 2]] - p0)
    normals = np.zeros((len(positions), 3), np.float32)
    for k in range(3):
        np.add.at(normals, tris[:, k], face_n)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    return np.where(lens > 0, normals / np.maximum(lens, 1e-30), 0.0).astype(np.float32)


def _mesh(positions, indices, uv0=None) -> MeshArrays:
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int64).reshape(-1, 3)
    return MeshArrays(positions, smooth_normals(positions, indices), indices,
                      None if uv0 is None else np.asarray(uv0, np.float32))


def subdivided_cube(g: int) -> MeshArrays:
    """A [-1, 1] cube, each face a g x g quad grid (12 g^2 triangles)."""
    verts, idx, uvs = [], [], []
    for na, ua, va, sgn in ((0, 1, 2, 1), (0, 1, 2, -1), (1, 0, 2, 1), (1, 0, 2, -1), (2, 0, 1, 1), (2, 0, 1, -1)):
        base = len(verts)
        for j in range(g + 1):
            for i in range(g + 1):
                p = [0.0, 0.0, 0.0]
                p[na] = float(sgn)
                p[ua] = -1.0 + 2.0 * i / g
                p[va] = -1.0 + 2.0 * j / g
                verts.append(p)
                uvs.append([i / g, j / g])
        for j in range(g):
            for i in range(g):
                a = base + j * (g + 1) + i
                b, c = a + 1, a + g + 1
                d = c + 1
                idx += [a, b, d, d, c, a] if sgn > 0 else [a, d, b, d, a, c]
    return _mesh(verts, idx, uvs)


def proc_texture(colour_rng, kind: str, size: int = 128) -> np.ndarray:
    """Procedural RGBA8 texture: brick-ish checker, AO / roughness /
    metallic, or foliage alpha; `colour_rng` draws its colours only."""
    yy, xx = np.mgrid[0:size, 0:size]
    img = np.zeros((size, size, 4), np.uint8)
    if kind == "albedo":
        base = colour_rng.uniform(0.25, 0.85, 3)
        checker = (((xx // 16) + (yy // 8)) % 2).astype(np.float32)
        mortar = ((xx % 16 < 1) | (yy % 8 < 1)).astype(np.float32)
        c = base[None, None] * (0.75 + 0.25 * checker[..., None])
        c = c * (1.0 - 0.5 * mortar[..., None])
        img[..., :3] = np.clip(c * 255, 0, 255).astype(np.uint8)
        img[..., 3] = 255
    elif kind == "aomr":
        img[..., 0] = 255
        img[..., 1] = colour_rng.uniform(0.4, 0.9) * 255
        img[..., 2] = 0
        img[..., 3] = 255
    elif kind == "leaf":
        cx = size / 2
        r = np.sqrt((xx - cx) ** 2 + (yy - cx) ** 2) / cx
        blob = (r + 0.35 * np.sin(np.arctan2(yy - cx, xx - cx) * 7.0)) < 0.9
        img[..., 0] = 30
        img[..., 1] = int(colour_rng.uniform(0.3, 0.7) * 255)
        img[..., 2] = 25
        img[..., 3] = np.where(blob, 255, 0)
    return img


# Doubles each texture kind drew from the bench's one generator.
_TEXTURE_DRAWS = {"albedo": 3, "aomr": 1, "leaf": 1}


def build_scene(config: dict, seed: int) -> Scene:
    """The city of `config` (its "scene" and "camera" groups) with the run's
    texture colours drawn from `seed`."""
    sc, cam = config["scene"], config["camera"]
    n_buildings, subdiv, representative = sc["n_buildings"], sc["subdiv"], sc["representative"]
    layout = np.random.default_rng(sc["layout_seed"])
    colour = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 1])

    def texture(kind):
        layout.random(_TEXTURE_DRAWS[kind])  # keeps the bench's layout stream
        return proc_texture(colour, kind)

    side = int(np.ceil(np.sqrt(n_buildings)))
    out = Scene(
        width=config["width"], height=config["height"], ambient=tuple(config["ambient"]), vfov=cam["vfov"],
        near=cam["near"], eye=np.asarray(cam["eye"], np.float32), target=np.asarray(cam["target"], np.float32),
        half_width=side * 4.0, samples=int(config["samples"]),
    )
    out.materials.append(MaterialArrays(albedo=np.array(sc["ground_albedo"], np.float32)))
    out.meshes.append(_mesh([[-1.0, -1.0, 0.0], [-1.0, 1.0, 0.0], [1.0, 1.0, 0.0], [1.0, -1.0, 0.0]],
                            [0, 2, 1, 0, 3, 2]))
    out.add_object(0, 0, rotation_x(-np.pi / 2) @ scale(sc["ground_half_size"]))

    mats = []
    if representative:
        for _ in range(24):
            out.textures.append(TextureArrays(texture("albedo"), srgb=True))
            out.textures.append(TextureArrays(texture("aomr"), srgb=False))
            out.materials.append(MaterialArrays(albedo=np.ones(4, np.float32), albedo_tex=len(out.textures) - 2,
                                                aomr_tex=len(out.textures) - 1))
            mats.append(len(out.materials) - 1)
    else:
        for _ in range(64):
            layout.random(3)
            out.materials.append(MaterialArrays(albedo=np.array([*colour.uniform(0.2, 0.9, 3), 1.0], np.float32)))
            mats.append(len(out.materials) - 1)

    cubes = []
    for g in (subdiv, subdiv + 1, subdiv + 2):
        out.meshes.append(subdivided_cube(g))
        cubes.append(len(out.meshes) - 1)

    for i in range(n_buildings):
        gx, gz = i % side, i // side
        x = (gx - side / 2) * 8.0 + layout.uniform(-1, 1)
        z = (gz - side / 2) * 8.0 + layout.uniform(-1, 1)
        h = layout.uniform(2.0, 18.0)
        w = layout.uniform(1.5, 3.5)
        oi = out.add_object(cubes[i % 3], mats[i % len(mats)], translation([x, h, z]) @ scale([w, h, w]))
        out.buildings.append((oi, (x, h, z), (w, h, w)))

    if representative:
        # Alpha-tested foliage: crossed double-sided quads.
        out.meshes.append(_mesh([[-1, 1, 0], [1, 1, 0], [1, -1, 0], [-1, -1, 0]],
                                [0, 1, 2, 2, 3, 0, 0, 2, 1, 2, 0, 3], [[0, 0], [1, 0], [1, 1], [0, 1]]))
        quad = len(out.meshes) - 1
        leaf_mats = []
        for _ in range(4):
            out.textures.append(TextureArrays(texture("leaf"), srgb=True))
            out.materials.append(MaterialArrays(albedo=np.ones(4, np.float32), albedo_tex=len(out.textures) - 1,
                                                cutout=0.5))
            leaf_mats.append(len(out.materials) - 1)
        for count, lo, hi in ((150, -side * 4.0, side * 4.0), (20, -8.0, 12.0)):
            for i in range(count):
                x = layout.uniform(lo, hi)
                z = layout.uniform(lo, hi)
                s = layout.uniform(1.5, 3.0)
                base = translation([x, s, z]) @ scale(s)
                for rot in (0.0, np.pi / 2):
                    out.add_object(quad, leaf_mats[i % 4], base @ rotation_y(rot))
        # Glass panes: random ones, then four on the bench camera's sight line.
        out.materials.append(MaterialArrays(albedo=np.array([0.4, 0.7, 0.9, 0.35], np.float32), blend=True))
        glass = len(out.materials) - 1
        for _ in range(12):
            x = layout.uniform(-20.0, 20.0)
            z = layout.uniform(-30.0, 10.0)
            s = layout.uniform(2.0, 4.0)
            out.add_object(quad, glass, translation([x, s, z]) @ scale(s))
        for p, s in (((26.0, 21.0, -39.0), 5.0), ((20.0, 17.5, -30.0), 4.0), ((20.5, 17.2, -29.0), 3.0),
                     ((14.0, 14.0, -21.0), 3.5)):
            out.add_object(quad, glass, translation(p) @ scale(s))

    for light in sc["lights"][: 2 if representative else 1]:
        out.lights.append(LightArrays(
            color=np.asarray(light["color"], np.float32), intensity=float(light["intensity"]),
            direction=np.asarray(light["direction"], np.float32), distance=float(light["distance"]),
            resolution=int(light["resolution"]),
        ))
    return out
