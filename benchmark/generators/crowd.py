"""A crowd of skinned pedestrians walking through the Bistro proxy city.

The city is scene.build_scene's, from the configuration's "scene" group
(the bistro-proxy-1080p keys). The crowd (the "crowd" group) is
`pedestrians` instances of one character on one rig, each with its own
skeleton:

- the rig: 65 joints in Mixamo's humanoid topology (RIG), in a T-pose 1.75 m
  tall standing on the ground at its origin, facing +z; the inverse bind
  matrices are the rest pose's;
- the mesh: a capsule on each of the 64 bones (a joint and its parent): 5
  rings of 8 vertices along the bone, each end closed by a fan over its
  ring, so 40 vertices and 76 triangles a bone, 2,560 and 4,864 a
  pedestrian; normals by scene.smooth_normals. A ring's vertices follow
  four joints (RING_WEIGHTS, in sixteenths, summing to 1): the bone's joint
  (the parent, whose rotation swings the bone), that joint's parent, the
  child at the bone's end and the joint's grandparent, the parent's share
  falling and the child's rising along the bone; a joint the rig lacks
  (above the root) gives its share to the bone's joint;
- the spots: points of a 1.5 m lattice within `area_radius` of the centre
  whose distance to every building's footprint (`clearance`) is at least
  the crowd's `clearance`, `pedestrians` of them chosen with the crowd's
  own `layout_seed`, so the scene is the same for every run seed;
  pedestrian i takes material i % `materials` (flat lit).

The mix (`Traffic`, the mix's "walk" group) moves every pedestrian every
frame: it walks a circle around its spot, one turn per `frames_per_turn`
frames, heading along the circle, of a radius drawn from the run's seed in
`radius` and cut to the spot's clearance less `margin` (the body's reach),
so that no walk enters a building; its joints follow a `cycle_frames`-frame
walk cycle from a phase drawn from the seed (POSE: hips and thighs, knees,
arms, spine twist, finger curl, and every other joint a little). Each frame
sends one set_object_transform and one set_skeleton_joint_transforms a
pedestrian.

The reference (`Reference`) takes the frame's joint globals from
Traffic.state, multiplies them by the inverse binds, blends the rest pose's
positions and normals by the 4 weights in plain float32 and renders the
city and the crowd through reference.Reference.

The check also sees the crowd from close by (the mix's "closeup" group):
seen from the cell's camera a pedestrian covers a few hundred pixels, too
few for compare.LIMITS to see a wrong pose. After the window, `Port.close`
renders `views` frames of the port, each at a frame and pedestrian drawn
from the seed and from a camera `distance` m from its chest, `elevation`
degrees up, on a heading whose sight line no building crosses, so that the
pedestrian fills the frame's height. The close-ups check geometry: they
are lit by the ambient term alone, at CLOSEUP_AMBIENT, the directional
lights at intensity 0, so each surface shows its albedo. (A close view
magnifies a shadow map's texels: one texel whose cover rounding decides
spreads over a tenth of a square metre of the ground's PCF, most of a
percent of a close-up.) The reference renders the same views in the same
light and judges them by compare.judge under its limits; where they fail,
it answers every checked frame with an interval no image meets, so the run
reads not `correct`. Nothing here imports the port; `Port` calls its public
API from inside its methods, as adapter.Port does.
"""

import contextlib
import dataclasses
import math
import sys

import numpy as np
import torch

from benchmark import adapter, compare, reference
from benchmark import scene as S
from benchmark.scene import look_at_lh
from benchmark import traffic as T

__all__ = ["RIG", "POSE", "RING_WEIGHTS", "CLOSEUP_AMBIENT", "Rig", "CrowdScene", "rig", "character", "clearance",
           "spots", "build_scene", "Port", "Reference", "Traffic"]

_FINGERS = (  # name, base offset from the hand (x away from the body), phalanx lengths
    ("Thumb", (0.025, -0.01, 0.035), (0.035, 0.03, 0.025)),
    ("Index", (0.09, 0.0, 0.03), (0.04, 0.025, 0.02)),
    ("Middle", (0.095, 0.0, 0.01), (0.045, 0.03, 0.022)),
    ("Ring", (0.09, 0.0, -0.01), (0.04, 0.028, 0.02)),
    ("Pinky", (0.08, 0.0, -0.03), (0.03, 0.02, 0.018)),
)


def _rig_rows():
    """(name, parent, offset from the parent in the rest pose, radius of the
    bone that ends at this joint) in Mixamo's order: trunk, left arm, right
    arm, left leg, right leg."""
    rows = [("Hips", None, (0.0, 0.95, 0.0), 0.0), ("Spine", "Hips", (0.0, 0.10, 0.0), 0.13),
            ("Spine1", "Spine", (0.0, 0.12, 0.0), 0.13), ("Spine2", "Spine1", (0.0, 0.12, 0.0), 0.14),
            ("Neck", "Spine2", (0.0, 0.16, 0.0), 0.06), ("Head", "Neck", (0.0, 0.10, 0.0), 0.05),
            ("HeadTop_End", "Head", (0.0, 0.20, 0.0), 0.10)]
    for side, sx in (("Left", 1.0), ("Right", -1.0)):
        rows += [(f"{side}Shoulder", "Spine2", (0.07 * sx, 0.12, 0.0), 0.06),
                 (f"{side}Arm", f"{side}Shoulder", (0.12 * sx, 0.0, 0.0), 0.06),
                 (f"{side}ForeArm", f"{side}Arm", (0.28 * sx, 0.0, 0.0), 0.05),
                 (f"{side}Hand", f"{side}ForeArm", (0.25 * sx, 0.0, 0.0), 0.04)]
        for finger, base, lengths in _FINGERS:
            rows.append((f"{side}Hand{finger}1", f"{side}Hand", (base[0] * sx, base[1], base[2]), 0.015))
            for k, length in enumerate(lengths):
                rows.append((f"{side}Hand{finger}{k + 2}", f"{side}Hand{finger}{k + 1}", (length * sx, 0.0, 0.0),
                             (0.01, 0.009, 0.008)[k]))
    for side, sx in (("Left", 1.0), ("Right", -1.0)):
        rows += [(f"{side}UpLeg", "Hips", (0.09 * sx, -0.05, 0.0), 0.08),
                 (f"{side}Leg", f"{side}UpLeg", (0.0, -0.42, 0.0), 0.075),
                 (f"{side}Foot", f"{side}Leg", (0.0, -0.40, 0.0), 0.055),
                 (f"{side}ToeBase", f"{side}Foot", (0.0, -0.04, 0.13), 0.045),
                 (f"{side}Toe_End", f"{side}ToeBase", (0.0, 0.0, 0.08), 0.035)]
    return rows


RIG = _rig_rows()

# The walk cycle: per joint name pattern, the factors of its local rotation
# (applied left to right): (axis, base degrees, amplitude degrees, wave,
# phase offset in cycles); a wave "sin" is sin(phi + offset), "curl" is
# (1 - cos(phi + offset)) / 2, in [0, 1]. "S" in a name is the side; a side's
# angles about y and z take its sign (mirrored), about x not.
POSE = {
    "Hips": [("y", 0.0, 5.0, "sin", 0.0)],
    "Spine": [("y", 0.0, -5.0, "sin", 0.0)],
    "Spine1": [("y", 0.0, -5.0, "sin", 0.05)],
    "Spine2": [("y", 0.0, -5.0, "sin", 0.1)],
    "Neck": [("x", 0.0, 3.0, "sin", 0.25)],
    "Head": [("x", 0.0, 3.0, "sin", 0.5)],
    "HeadTop_End": [("x", 0.0, 2.0, "sin", 0.0)],
    "SShoulder": [("z", 0.0, 3.0, "sin", 0.0)],
    "SArm": [("x", 0.0, 20.0, "sin", 0.5), ("z", -70.0, 3.0, "sin", 0.0)],
    "SForeArm": [("y", -20.0, -10.0, "sin", 0.25)],
    "SHand": [("z", 0.0, 5.0, "sin", 0.0)],
    "SHandF": [("z", 0.0, -20.0, "curl", 0.0)],
    "SUpLeg": [("x", 0.0, -30.0, "sin", 0.0)],
    "SLeg": [("x", 0.0, 60.0, "curl", 0.25)],
    "SFoot": [("x", 0.0, 10.0, "sin", 0.5)],
    "SToeBase": [("x", 0.0, 8.0, "sin", 0.5)],
    "SToe_End": [("x", 0.0, 3.0, "sin", 0.0)],
}


@dataclasses.dataclass
class Rig:
    names: list
    parents: np.ndarray          # (J,) int64, -1 at the root
    offsets: np.ndarray          # (J, 3) f32 rest offset from the parent
    rest: np.ndarray             # (J, 3) f32 rest positions
    radii: np.ndarray            # (J,) f32 radius of the bone ending at the joint
    inverse_binds: np.ndarray    # (J, 4, 4) f32
    # The factors of POSE, slot by slot (a joint's local rotation is slot 0's
    # times slot 1's; a joint with one factor has an identity in slot 1): per
    # slot (axis (J,) 0 x / 1 y / 2 z, base and amplitude radians (J,), curl
    # (J,) bool, phase offset radians (J,)), with the side's sign and shift.
    factors: list
    levels: list                 # joint indices by depth below the root, depth 1 first


def rig() -> Rig:
    names = [r[0] for r in RIG]
    index = {n: i for i, n in enumerate(names)}
    parents = np.array([-1 if r[1] is None else index[r[1]] for r in RIG], np.int64)
    offsets = np.array([r[2] for r in RIG], np.float32)
    rest = np.zeros_like(offsets)
    for j, p in enumerate(parents):
        rest[j] = offsets[j] + (rest[p] if p >= 0 else 0.0)
    inverse_binds = np.stack([S.translation(-rest[j]) for j in range(len(names))])
    slots = [[(0, 0.0, 0.0, False, 0.0)] * len(names) for _ in range(2)]
    for j, name in enumerate(names):
        sx, key = 0.0, name
        for s, v in (("Left", 1.0), ("Right", -1.0)):
            if name.startswith(s):
                sx, key = v, "S" + name[len(s):]
        if key.startswith("SHand") and key != "SHand":
            key = "SHandF"
        for k, (axis, base, amp, wave, off) in enumerate(POSE[key]):
            sign = sx if (sx and axis in "yz") else 1.0
            # The right side's limbs swing half a cycle after the left's.
            shift = 0.5 if sx < 0 else 0.0
            slots[k][j] = ("xyz".index(axis), math.radians(base) * sign, math.radians(amp) * sign, wave == "curl",
                           2 * math.pi * (off + shift))
    factors = [tuple(np.array(col) for col in zip(*slot)) for slot in slots]
    depth = np.zeros(len(names), np.int64)
    for j, p in enumerate(parents):
        depth[j] = depth[p] + 1 if p >= 0 else 0
    levels = [np.nonzero(depth == d)[0] for d in range(1, int(depth.max()) + 1)]
    return Rig(names, parents, offsets, rest, np.array([r[3] for r in RIG], np.float32), inverse_binds, factors,
               levels)


_RING_SCALE = (0.55, 0.9, 1.0, 0.9, 0.55)
CLOSEUP_AMBIENT = (1.0, 1.0, 1.0, 1.0)
# Per ring along a bone, the sixteenths of (the bone's joint, its parent, the
# child at the bone's end, its grandparent).
RING_WEIGHTS = ((8, 6, 1, 1), (11, 3, 1, 1), (13, 1, 1, 1), (11, 1, 3, 1), (8, 1, 6, 1))


def character(rg: Rig) -> tuple:
    """(positions (V, 3), normals (V, 3), indices (T, 3), joint ids (V, 4),
    weights (V, 4)) of the character in the rest pose: a capsule a bone."""
    pos, idx, jid, wts = [], [], [], []
    ang = 2 * np.pi * np.arange(8) / 8
    for c in range(len(rg.names)):
        j = int(rg.parents[c])
        if j < 0:
            continue
        a, b = rg.rest[j].astype(np.float64), rg.rest[c].astype(np.float64)
        u = (b - a) / np.linalg.norm(b - a)
        helper = np.array([0.0, 0.0, 1.0]) if abs(u[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
        e1 = np.cross(u, helper)
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(u, e1)
        base = 40 * len(idx)
        rings = []
        for k in range(5):
            centre = a + (b - a) * k / 4
            r = rg.radii[c] * _RING_SCALE[k]
            rings.append(centre + r * (np.cos(ang)[:, None] * e1 + np.sin(ang)[:, None] * e2))
            pj = int(rg.parents[j])
            joints = [j, pj, c, int(rg.parents[pj]) if pj >= 0 else -1]
            w = list(RING_WEIGHTS[k])
            for slot in (1, 3):
                if joints[slot] < 0:
                    joints[slot], w[0], w[slot] = 0, w[0] + w[slot], 0
            jid.append(np.tile(joints, (8, 1)))
            wts.append(np.tile(np.array(w) / 16.0, (8, 1)))
        verts = np.concatenate(rings)
        pos.append(verts)
        tris = []
        for k in range(4):
            for i in range(8):
                p0, p1 = 8 * k + i, 8 * k + (i + 1) % 8
                tris += [(p0, p1, p1 + 8), (p1 + 8, p0 + 8, p0)]
        tris += [(0, i + 1, i) for i in range(1, 7)] + [(32, 32 + i, 32 + i + 1) for i in range(1, 7)]
        tris = np.array(tris, np.int64)
        # Each face's edge1 x edge2 points out of the capsule (front faces).
        p = verts[tris]
        n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        centre = p.mean(1)
        radial = centre - (a + np.outer((centre - a) @ u, u))
        out = np.concatenate([radial[:64], np.tile(-u, (6, 1)), np.tile(u, (6, 1))])
        flip = (n * out).sum(1) < 0
        tris[flip] = tris[flip][:, ::-1]
        idx.append(tris + base)
    positions = np.concatenate(pos).astype(np.float32)
    indices = np.concatenate(idx)
    return (positions, S.smooth_normals(positions, indices), indices, np.concatenate(jid).astype(np.int64),
            np.concatenate(wts).astype(np.float32))


def clearance(buildings, pts: np.ndarray) -> np.ndarray:
    """(N,) the distance from each (N, 2) x, z point to the nearest
    building's footprint, 0 inside one."""
    box = np.array([[x, z, s[0]] for _oi, (x, _h, z), s in buildings], np.float64)
    dx = np.maximum(np.abs(pts[:, None, 0] - box[None, :, 0]) - box[None, :, 2], 0.0)
    dz = np.maximum(np.abs(pts[:, None, 1] - box[None, :, 1]) - box[None, :, 2], 0.0)
    return np.hypot(dx, dz).min(1)


def spots(buildings, crowd: dict) -> np.ndarray:
    """(P, 2) x, z: the crowd's spots (see the module's docstring)."""
    r, step = float(crowd["area_radius"]), float(crowd["spacing"])
    g = np.arange(-r, r + step / 2, step)
    pts = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    pts = pts[np.hypot(pts[:, 0], pts[:, 1]) <= r]
    free = pts[clearance(buildings, pts) >= float(crowd["clearance"])]
    n = int(crowd["pedestrians"])
    if len(free) < n:
        raise ValueError(f"{len(free)} free spots for {n} pedestrians")
    pick = np.random.default_rng(int(crowd["layout_seed"])).choice(len(free), size=n, replace=False)
    return free[np.sort(pick)].astype(np.float32)


@dataclasses.dataclass
class CrowdScene(S.Scene):
    rig: Rig = None
    spots: np.ndarray = None      # (P, 2) x, z
    clear: np.ndarray = None      # (P,) each spot's clearance
    mesh: int = -1                # the character's mesh index
    material: int = -1            # the crowd's first material index (the rest follow)
    first: int = -1               # the first pedestrian's object index (the rest follow)
    joint_ids: np.ndarray = None  # (V, 4) int64
    weights: np.ndarray = None    # (V, 4) f32

    @property
    def pedestrians(self) -> int:
        return len(self.spots)


def build_scene(config: dict, seed: int) -> CrowdScene:
    """The city of `config` and its crowd (the module's docstring); `seed`
    draws the city's texture colours only."""
    city = S.build_scene(config, seed)
    out = CrowdScene(**{f.name: getattr(city, f.name) for f in dataclasses.fields(S.Scene)})
    crowd = config["crowd"]
    out.rig = rig()
    positions, normals, indices, out.joint_ids, out.weights = character(out.rig)
    out.meshes.append(S.MeshArrays(positions, normals, indices))
    out.mesh = len(out.meshes) - 1
    out.material = len(out.materials)
    for k in range(int(crowd["materials"])):
        h = k / int(crowd["materials"])
        out.materials.append(S.MaterialArrays(
            albedo=np.array([0.35 + 0.4 * h, 0.3 + 0.3 * (1 - h), 0.25 + 0.5 * ((3 * h) % 1), 1.0], np.float32),
            roughness=0.7))
    out.spots = spots(city.buildings, crowd)
    out.clear = clearance(city.buildings, out.spots).astype(np.float32)
    out.first = len(out.obj_mesh)
    for i, (x, z) in enumerate(out.spots):
        out.add_object(out.mesh, out.material + i % int(crowd["materials"]), S.translation([x, 0.0, z]))
    return out


class Traffic(T.Traffic):
    """The mix's camera (traffic.Traffic's), the crowd's walk and the
    close-up views of the check (`closeups`, filled by Port.close)."""

    def __init__(self, mix: dict, scene: CrowdScene, seed: int):
        super().__init__(mix, scene, seed)
        walk = mix["walk"]
        self.turn, self.cycle = int(walk["frames_per_turn"]), int(walk["cycle_frames"])
        self.period = math.lcm(self.period, self.turn, self.cycle)
        self.seed = int(seed)
        rng = np.random.default_rng([self.seed & 0xFFFFFFFF, self.seed >> 32, 4])
        n = scene.pedestrians
        self.radius = np.minimum(rng.uniform(*walk["radius"], n), scene.clear - walk["margin"]).astype(np.float32)
        self.start = rng.uniform(0, 2 * np.pi, n)
        self.phase = rng.uniform(0, 2 * np.pi, n)
        self.closeups = []

    def walkers(self, frame: int) -> np.ndarray:
        """(P, 4, 4) f32 object transforms: on the circle, facing along it."""
        a = self.start + 2 * np.pi * (frame % self.turn) / self.turn
        sp = self.scene.spots
        out = np.zeros((len(a), 4, 4), np.float32)
        c, s = np.cos(-a), np.sin(-a)
        out[:, 0, 0], out[:, 0, 2], out[:, 2, 0], out[:, 2, 2] = c, s, -s, c
        out[:, 1, 1] = out[:, 3, 3] = 1.0
        out[:, 0, 3] = sp[:, 0] + self.radius * np.cos(a)
        out[:, 2, 3] = sp[:, 1] + self.radius * np.sin(a)
        return out

    def joint_globals(self, frame: int) -> np.ndarray:
        """(P, J, 4, 4) f32 global joint transforms of the walk cycle."""
        rg = self.scene.rig
        phi = (self.phase + 2 * np.pi * (frame % self.cycle) / self.cycle)[:, None]
        local = np.broadcast_to(np.eye(4, dtype=np.float32), (len(phi), len(rg.names), 4, 4)).copy()
        local[..., :3, 3] = rg.offsets
        rot = None
        for axis, base, amp, curl, off in rg.factors:
            w = np.where(curl, 0.5 * (1 - np.cos(phi + off)), np.sin(phi + off))
            r = _rotations(axis, base + amp * w)
            rot = r if rot is None else rot @ r
        local[..., :3, :3] = rot
        out = local
        for js in rg.levels:
            out[:, js] = out[:, rg.parents[js]] @ local[:, js]
        return out

    def transforms(self, frame: int) -> np.ndarray:
        t = np.stack(self.scene.transforms).astype(np.float32)
        t[self.scene.first:] = self.walkers(frame)
        return t

    def apply(self, port, frame: int) -> None:
        if self.loop is not None:
            port.set_camera(self.view(frame))
        r, first = port.renderer, self.scene.first
        ib = self.scene.rig.inverse_binds
        for k, (m, g) in enumerate(zip(self.walkers(frame), self.joint_globals(frame))):
            r.set_object_transform(port.objects[first + k], m)
            r.set_skeleton_joint_transforms(port.skeletons[k], g, ib)

    def state(self, frame: int) -> dict:
        return {**super().state(frame), "joints": self.joint_globals(frame), "closeups": self.closeups}

    def closeup_views(self) -> list:
        """[(frame, pedestrian, view)]: the check's close-up views (the
        module's docstring), drawn from the seed."""
        rng = np.random.default_rng([self.seed & 0xFFFFFFFF, self.seed >> 32, 5])
        out = []
        for _ in range(int(self.mix["closeup"]["views"])):
            frame = int(rng.integers(self.period))
            out.append((frame, *self._closeup(frame, rng)))
        return out

    def _closeup(self, frame: int, rng) -> tuple:
        """(pedestrian, view): the first pedestrian, in an order drawn from
        `rng`, that a heading (16, from one drawn) sees over a sight line
        that passes no building within 0.3 m."""
        cu = self.mix["closeup"]
        d, e = float(cu["distance"]), math.radians(float(cu["elevation"]))
        reach = np.linspace(0.0, d * math.cos(e) + 0.3, 16)
        walkers = self.walkers(frame)
        for p in rng.permutation(self.scene.pedestrians):
            chest = walkers[p, :3, 3] + np.array([0.0, cu["height"], 0.0], np.float32)
            for a in rng.uniform(0, 2 * np.pi) + 2 * np.pi * np.arange(16) / 16:
                heading = np.array([math.cos(a), math.sin(a)])
                if clearance(self.scene.buildings, chest[[0, 2]] + reach[:, None] * heading).min() >= 0.3:
                    eye = chest + d * np.array([math.cos(e) * heading[0], math.sin(e), math.cos(e) * heading[1]],
                                               np.float32)
                    return int(p), look_at_lh(eye, chest)
        raise ValueError(f"no pedestrian is in sight at frame {frame}")


def _rotations(axis: np.ndarray, rad: np.ndarray) -> np.ndarray:
    """(N, J, 3, 3) f32 rotations of `rad` (N, J) about each joint's
    principal axis (J,: 0 x, 1 y, 2 z), in scene.py's forms."""
    c, s = np.cos(rad).astype(np.float32), np.sin(rad).astype(np.float32)
    out = np.zeros(rad.shape + (3, 3), np.float32)
    for k, (i, j) in enumerate(((1, 2), (2, 0), (0, 1))):
        m = axis == k
        out[:, m, k, k] = 1.0
        out[:, m, i, i] = out[:, m, j, j] = c[:, m]
        out[:, m, i, j], out[:, m, j, i] = -s[:, m], s[:, m]
    return out


class Port(adapter.Port):
    """The city through adapter.Port (its lights added here, whose handles
    the close-ups need), then the character mesh with its joints, a
    skeleton and an AnimatedMeshKind object a pedestrian."""

    def __init__(self, scene: CrowdScene, traffic, device: str):
        from rend3_tpu_torch.routine.pbr.material import AlbedoComponent, PbrMaterial
        from rend3_tpu_torch.types import (
            AnimatedMeshKind, DirectionalLight, Handedness, MeshBuilder, Object, Skeleton,
        )

        city = {f.name: getattr(scene, f.name) for f in dataclasses.fields(S.Scene)}
        city.update(meshes=scene.meshes[: scene.mesh], materials=scene.materials[: scene.material],
                    obj_mesh=scene.obj_mesh[: scene.first], obj_material=scene.obj_material[: scene.first],
                    transforms=scene.transforms[: scene.first], lights=[])
        super().__init__(S.Scene(**city), traffic, device)
        self.scene = scene
        r = self.renderer
        self.lights = [r.add_directional_light(DirectionalLight(
            color=light.color, intensity=light.intensity, direction=light.direction, distance=light.distance,
            resolution=light.resolution)) for light in scene.lights]
        m = scene.meshes[scene.mesh]
        mesh = r.add_mesh(MeshBuilder(m.positions, Handedness.LEFT).with_vertex_normals(m.normals)
                          .with_vertex_joint_indices(scene.joint_ids).with_vertex_joint_weights(scene.weights)
                          .with_indices(m.indices.astype(np.uint32).reshape(-1)).build())
        mats = {k: r.add_material(PbrMaterial(albedo=AlbedoComponent(value=scene.materials[k].albedo),
                                              roughness_factor=scene.materials[k].roughness,
                                              metallic_factor=scene.materials[k].metallic))
                for k in range(scene.material, len(scene.materials))}
        rest = np.tile(np.eye(4, dtype=np.float32), (len(scene.rig.names), 1, 1))
        self.skeletons = []
        for k in range(scene.pedestrians):
            oi = scene.first + k
            sk = r.add_skeleton(Skeleton(mesh=mesh, joint_matrices=rest))
            self.skeletons.append(sk)
            self.objects.append(r.add_object(Object(mesh_kind=AnimatedMeshKind(sk),
                                                    material=mats[scene.obj_material[oi]],
                                                    transform=scene.transforms[oi])))
        self.keep += [mesh] + list(mats.values())

    def close(self) -> None:
        """Renders the check's close-up views (the module's docstring) into
        the traffic's `closeups`, then frees the port."""
        from rend3_tpu_torch.routine.base import BaseRenderGraphSettings

        for light in self.lights:
            self.renderer.update_directional_light(light, intensity=0.0)
        self.settings = BaseRenderGraphSettings(ambient_color=CLOSEUP_AMBIENT)
        self.traffic.closeups = []
        for frame, p, view in self.traffic.closeup_views():
            self.apply(frame)
            self.set_camera(view)
            state = {**self.traffic.state(frame), "view": view}
            del state["closeups"]
            self.traffic.closeups.append((f"frame {frame}, pedestrian {p}", state, self.render(self.evaluate())))
        self.skeletons = self.lights = None
        super().close()


class Reference(reference.Reference):
    """reference.Reference over the crowd posed by the frame's joint
    globals: joint matrices = globals x inverse binds, the rest pose's
    positions and normals blended by the 4 weights, in plain float32 (TF32
    off; with tf32=True its matrix products round their operands, as the
    base class's do); and the port's close-up views, judged once."""

    def __init__(self, scene: CrowdScene, device: str = "cpu", tf32: bool = False, chunk: int = 1 << 23):
        super().__init__(scene, device, tf32, chunk)
        self.closeups_ok = None
        dev = self.dev
        m = scene.meshes[scene.mesh]
        self.n_city = len(self.tri_pos) - scene.pedestrians * len(m.indices)
        self.rest_pos, self.rest_nrm = self.tri_pos, self.tri_nrm
        self.v_pos = torch.from_numpy(m.positions).to(dev)
        self.v_nrm = torch.from_numpy(m.normals).to(dev)
        self.v_idx = torch.from_numpy(m.indices).to(dev)
        self.joint_ids = torch.from_numpy(scene.joint_ids).to(dev)
        self.weights = torch.from_numpy(scene.weights).to(dev)
        self.inverse_binds = torch.from_numpy(scene.rig.inverse_binds).to(dev)

    def skin(self, joints: np.ndarray, batch: int = 64) -> tuple:
        """((P, T, 3, 3) posed corner positions, the same for normals) of the
        crowd's triangles, from (P, J, 4, 4) joint globals."""
        pos, nrm = [], []
        g = torch.from_numpy(np.ascontiguousarray(joints, np.float32)).to(self.dev)
        for p0 in range(0, len(g), batch):
            mats = self._mm(g[p0 : p0 + batch], self.inverse_binds)            # (B, J, 4, 4)
            m = mats[:, self.joint_ids]                                        # (B, V, 4, 4, 4)
            w = self.weights[None, :, :, None, None]
            blend = m[:, :, 0] * w[:, :, 0] + m[:, :, 1] * w[:, :, 1] + m[:, :, 2] * w[:, :, 2] \
                + m[:, :, 3] * w[:, :, 3]                                      # (B, V, 4, 4)
            a = blend[..., :3, :3]
            p = self._mm(a, self.v_pos[None, :, :, None])[..., 0] + blend[..., :3, 3]
            n = self._mm(a, self.v_nrm[None, :, :, None])[..., 0]
            pos.append(p[:, self.v_idx])
            nrm.append(n[:, self.v_idx])
        return torch.cat(pos), torch.cat(nrm)

    @contextlib.contextmanager
    def closeup_light(self):
        """The close-ups' light (the module's docstring) for the renders
        inside: the scene's lights at intensity 0, CLOSEUP_AMBIENT."""
        scene = self.scene
        lights, ambient = scene.lights, scene.ambient
        scene.lights = [dataclasses.replace(light, intensity=0.0) for light in lights]
        scene.ambient = CLOSEUP_AMBIENT
        try:
            yield
        finally:
            scene.lights, scene.ambient = lights, ambient

    def judge_closeups(self, closeups: list) -> bool:
        """Whether the port's close-up images ([(label, state, image)]) pass
        compare.judge against this reference's, in the close-ups' light;
        logs each one's numbers."""
        per_view = []
        with self.closeup_light():
            for label, state, image in closeups:
                answer = self.posed(**state)
                per_view.append(compare.frame_numbers(image.to(answer["lo"].device), answer))
                print(f"[bench] close-up ({label}): " + ", ".join(f"{k} {v:.6g}" for k, v in per_view[-1].items()),
                      file=sys.stderr, flush=True)
        ok, worst = compare.judge(per_view)
        print(f"[bench] close-ups: {'passed' if ok else 'refused'}; worst {worst}", file=sys.stderr, flush=True)
        return ok

    @torch.no_grad()
    def render(self, view: np.ndarray, transforms: np.ndarray, joints: np.ndarray, closeups=()) -> dict:
        """The frame's answer; where the port's close-ups failed the check,
        with an interval (lo 255, hi 0) that no image meets."""
        if closeups and self.closeups_ok is None:
            self.closeups_ok = self.judge_closeups(closeups)
        answer = self.posed(view, transforms, joints)
        if self.closeups_ok is False:
            answer = {**answer, "lo": torch.full_like(answer["lo"], 255), "hi": torch.zeros_like(answer["hi"])}
        return answer

    @torch.no_grad()
    def posed(self, view: np.ndarray, transforms: np.ndarray, joints: np.ndarray) -> dict:
        """reference.Reference.render over the city and the crowd posed by
        `joints`."""
        pos, nrm = self.skin(joints)
        self.tri_pos = torch.cat([self.rest_pos[: self.n_city], pos.reshape(-1, 3, 3)])
        self.tri_nrm = torch.cat([self.rest_nrm[: self.n_city], nrm.reshape(-1, 3, 3)])
        try:
            return super().render(view, transforms)
        finally:
            self.tri_pos, self.tri_nrm = self.rest_pos, self.rest_nrm
