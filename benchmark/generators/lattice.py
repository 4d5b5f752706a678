"""The host micro-bench's 50,000-object scene as plain arrays: one cube on a
lattice, many times over.

The layout is rend3_tpu_torch/tools/bench_host.py's, copied here (the
reference side loads this file too, so it imports nothing of the port):
`n_objects` instances of the tool's cube (8 vertices, 12 triangles) on a
lattice of side ceil(n ** (1/3)) at `spacing` metres, object i at
(i % side, (i // side) % side, i // side^2), each scaled by `cube_scale`
and taking material i % 4 (flat lit, albedo [0.5, 0.5 + 0.1 k, 0.5, 1]).
The lattice is moved so that its vertical axis passes through the origin,
where traffic.py's loop circles; its half-width is side * spacing / 2.
Normals are scene.smooth_normals (area-weighted, as the port computes
them); there are no texture coordinates. Every cube is a "building" that
traffic.py's movers may pick. Nothing in the scene is drawn from the run's
seed.
"""

from __future__ import annotations

import numpy as np

from benchmark import scene as S

__all__ = ["CUBE_POSITIONS", "CUBE_INDICES", "build_scene"]

# bench_host.CUBE_POSITIONS / CUBE_INDICES.
CUBE_POSITIONS = np.array(
    [[-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
     [-1, 1, -1], [1, 1, -1], [1, -1, -1], [-1, -1, -1]], np.float32)
CUBE_INDICES = np.array([0, 1, 2, 2, 3, 0, 4, 5, 6, 6, 7, 4,
                         1, 6, 5, 5, 2, 1, 0, 3, 4, 4, 7, 0,
                         3, 2, 5, 5, 4, 3, 0, 7, 6, 6, 1, 0], np.int64).reshape(-1, 3)


def build_scene(config: dict, seed: int) -> S.Scene:
    """The lattice of `config` (its "scene" and "camera" groups); `seed`
    draws nothing here (traffic.py draws the movers from it)."""
    sc, cam = config["scene"], config["camera"]
    n, spacing, s = int(sc["n_objects"]), float(sc["spacing"]), float(sc["cube_scale"])
    side = int(np.ceil(n ** (1 / 3)))  # the tool's rounding
    shift = (side - 1) * spacing / 2
    out = S.Scene(
        width=config["width"], height=config["height"], ambient=tuple(config["ambient"]), vfov=cam["vfov"],
        near=cam["near"], eye=np.asarray(cam["eye"], np.float32), target=np.asarray(cam["target"], np.float32),
        half_width=side * spacing / 2, samples=int(config["samples"]),
    )
    out.meshes.append(S.MeshArrays(CUBE_POSITIONS, S.smooth_normals(CUBE_POSITIONS, CUBE_INDICES), CUBE_INDICES))
    for k in range(int(sc["n_materials"])):
        out.materials.append(S.MaterialArrays(albedo=np.array([0.5, 0.5 + 0.1 * k, 0.5, 1.0], np.float32)))
    m = len(out.materials)
    i = np.arange(n)
    pos = np.stack([(i % side) * spacing - shift, ((i // side) % side) * spacing,
                    (i // (side * side)) * spacing - shift], 1).astype(np.float32)
    base = np.broadcast_to(S.scale(s), (n, 4, 4)).copy()
    base[:, :3, 3] = pos
    out.obj_mesh = [0] * n
    out.obj_material = [k % m for k in range(n)]
    out.transforms = list(base)
    out.buildings = [(k, tuple(float(v) for v in pos[k]), s) for k in range(n)]
    for light in sc["lights"]:
        out.lights.append(S.LightArrays(
            color=np.asarray(light["color"], np.float32), intensity=float(light["intensity"]),
            direction=np.asarray(light["direction"], np.float32), distance=float(light["distance"]),
            resolution=int(light["resolution"]),
        ))
    return out
