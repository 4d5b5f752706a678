"""The one traffic generator: what an application changes between frames.

A mix is a data file of parameters (mixes/<name>.json) with two groups:

- "camera": {"path": "fixed"} keeps the configuration's camera; {"path":
  "loop", ...} flies a closed loop through the city: `points` control
  points at evenly spaced angles (jittered by `angle_jitter` of a step),
  orbit radius drawn in `radius` (a share of the city's half-width), eye
  height in `height`, look targets within `target_radius` of the centre
  at a height in `target_height`, `frames` frames to a loop, on a periodic
  Catmull-Rom spline. The loop is drawn from the mix's own `path_seed`, so
  every run sees the same views in the same order; the position depends on
  the frame index, not on the clock.
- "movers" (optional): {"count", "radius", "frames_per_turn"}: that many
  buildings, chosen from the run's seed, each move every frame on a
  horizontal circle of `radius` metres from a phase drawn from the seed.
  Every building moved re-rasters the whole shadow maps, so which ones move
  changes no amount of work.

`warmup_frames` is how many frames set-up renders before the window, spread
evenly over one period of the mix. The window starts at frame 0.

A mix that needs other instructions names its own generator,
`"generator": "<name>"`, the file generators/<name>.py (see harness.parts),
which defines a class of this one's interface: `Traffic(mix, scene, seed)`
with `period`, `warmup_frames()`, `apply(port, frame)` (the frame's
instructions through the port's public API) and `state(frame)` (the keyword
arguments of the reference's `render` for that frame).
"""

from __future__ import annotations

import numpy as np

from .scene import Scene, look_at_lh, scale, translation

__all__ = ["Traffic"]


def _catmull_rom(p: np.ndarray, t: float) -> np.ndarray:
    """Periodic Catmull-Rom spline through the rows of p at t in [0, len(p))."""
    n = len(p)
    k = int(np.floor(t)) % n
    u = t - np.floor(t)
    p0, p1, p2, p3 = p[(k - 1) % n], p[k], p[(k + 1) % n], p[(k + 2) % n]
    return 0.5 * ((2 * p1) + (-p0 + p2) * u + (2 * p0 - 5 * p1 + 4 * p2 - p3) * u * u
                  + (-p0 + 3 * p1 - 3 * p2 + p3) * u * u * u)


class Traffic:
    def __init__(self, mix: dict, scene: Scene, seed: int):
        self.mix = mix
        self.scene = scene
        cam = mix["camera"]
        self.loop = None
        self.period = 1
        if cam["path"] == "loop":
            rng = np.random.default_rng(cam["path_seed"])
            n = cam["points"]
            ang = 2 * np.pi * (np.arange(n) + rng.uniform(-cam["angle_jitter"], cam["angle_jitter"], n)) / n
            rad = rng.uniform(*cam["radius"], n) * scene.half_width
            eyes = np.stack([rad * np.cos(ang), rng.uniform(*cam["height"], n), rad * np.sin(ang)], 1)
            ta = rng.uniform(0, 2 * np.pi, n)
            tr = cam["target_radius"] * np.sqrt(rng.uniform(0, 1, n))
            targets = np.stack([tr * np.cos(ta), rng.uniform(*cam["target_height"], n), tr * np.sin(ta)], 1)
            self.loop = (eyes, targets)
            self.period = cam["frames"]
        elif cam["path"] != "fixed":
            raise ValueError(f"unknown camera path {cam['path']!r}")
        self.movers = []
        mv = mix.get("movers")
        if mv and mv["count"]:
            rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 2])
            picks = rng.choice(len(scene.buildings), size=mv["count"], replace=False)
            phases = rng.uniform(0, 2 * np.pi, mv["count"])
            self.movers = [(scene.buildings[int(b)], float(ph)) for b, ph in zip(picks, phases)]
            self.period = max(self.period, mv["frames_per_turn"])

    @property
    def moves_camera(self) -> bool:
        return self.loop is not None

    def warmup_frames(self) -> list:
        n = self.mix["warmup_frames"]
        return [int(round(k * self.period / n)) % self.period for k in range(n)]

    def camera(self, frame: int):
        """(eye, target) of this frame."""
        if self.loop is None:
            return self.scene.eye, self.scene.target
        t = (frame % self.period) / self.period * len(self.loop[0])
        return (_catmull_rom(self.loop[0], t).astype(np.float32), _catmull_rom(self.loop[1], t).astype(np.float32))

    def view(self, frame: int) -> np.ndarray:
        return look_at_lh(*self.camera(frame))

    def moved(self, frame: int) -> list:
        """[(object index, transform)] of the objects that move this frame."""
        if not self.movers:
            return []
        mv = self.mix["movers"]
        out = []
        for (oi, (x, h, z), s), phase in self.movers:
            a = phase + 2 * np.pi * frame / mv["frames_per_turn"]
            r = mv["radius"]
            out.append((oi, translation([x + r * np.cos(a), h, z + r * np.sin(a)]) @ scale(s)))
        return out

    def transforms(self, frame: int) -> np.ndarray:
        """(O, 4, 4) f32 object transforms of this frame."""
        t = np.stack(self.scene.transforms).astype(np.float32)
        for oi, m in self.moved(frame):
            t[oi] = m
        return t

    def apply(self, port, frame: int) -> None:
        """This frame's instructions, through the port (adapter.Port)."""
        if self.loop is not None:
            port.set_camera(self.view(frame))
        for oi, m in self.moved(frame):
            port.renderer.set_object_transform(port.objects[oi], m)

    def state(self, frame: int) -> dict:
        """The reference's inputs of this frame (Reference.render's keywords)."""
        return {"view": self.view(frame), "transforms": self.transforms(frame)}
