"""First-person walk controls (port of rend3_tpu/framework/camera.py;
reference: examples/src/scene_viewer/mod.rs camera handling — mouse-look
at :545-577, WASD velocity integration at :583-612, view assembly at
:641-643).

The control model is the reference's exactly: yaw/pitch accumulate from
mouse deltas (yaw wraps to [0, 2π), pitch clamps just inside ±π/2), and held
keys integrate `rotation · axis · speed · dt` into the camera location with
forward = -Z of the transposed XYZ-euler rotation, side = -X, up = +Y, and
shift selecting run_speed over walk_speed. Events arrive as key set/strings
instead of winit scancodes so both scripted flythroughs (`--walk`) and the
live browser viewer share it."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable, Set

import numpy as np

from ..types import Camera, Perspective
from ..utils import math as m3

__all__ = ["FirstPersonControls"]

TAU = math.tau


@dataclass
class FirstPersonControls:
    location: np.ndarray = field(default_factory=lambda: np.array([3.0, 3.0, -5.0], np.float32))
    pitch: float = 0.0               # radians
    yaw: float = 0.0                 # radians
    walk_speed: float = 10.0         # mod.rs:316-317 defaults
    run_speed: float = 50.0
    vfov: float = 60.0
    held: Set[str] = field(default_factory=set)

    # -- input ---------------------------------------------------------------

    def key(self, name: str, pressed: bool = True) -> None:
        """Track held keys: w/a/s/d/q (move), shift (run)."""
        name = name.lower()
        if pressed:
            self.held.add(name)
        else:
            self.held.discard(name)

    def mouse(self, dx: float, dy: float) -> None:
        """Mouse-look; deltas in the reference's pixel units (÷1000 rad)."""
        self.yaw -= dx / 1000.0
        self.pitch -= dy / 1000.0
        self.yaw %= TAU
        limit = math.pi / 2 - 1e-4
        self.pitch = min(max(self.pitch, -limit), limit)

    # -- integration ---------------------------------------------------------

    def _rotation(self) -> np.ndarray:
        """Mat3 from_euler(XYZ, -pitch, -yaw, 0).transpose() (mod.rs:595)."""
        return (m3.rotation_x(-self.pitch) @ m3.rotation_y(-self.yaw))[:3, :3].T

    def update(self, dt: float) -> None:
        rot = self._rotation()
        forward = -rot[:, 2]
        up = rot[:, 1]
        side = -rot[:, 0]
        v = self.run_speed if "shift" in self.held else self.walk_speed
        step = v * dt
        if "w" in self.held:
            self.location = self.location + forward * step
        if "s" in self.held:
            self.location = self.location - forward * step
        if "a" in self.held:
            self.location = self.location + side * step
        if "d" in self.held:
            self.location = self.location - side * step
        if "q" in self.held:
            self.location = self.location + up * step

    # -- output --------------------------------------------------------------

    def view_matrix(self) -> np.ndarray:
        """mod.rs:641-643: euler(XYZ, -pitch, -yaw, 0) · translate(-loc)."""
        view = m3.rotation_x(-self.pitch) @ m3.rotation_y(-self.yaw)
        return (view @ m3.translation(-np.asarray(self.location, np.float32))).astype(np.float32)

    def camera(self, near: float = 0.1) -> Camera:
        return Camera(projection=Perspective(vfov=self.vfov, near=near), view=self.view_matrix())

    # -- scripted flythroughs -------------------------------------------------

    def run_script(self, script: str) -> Iterable[None]:
        """Apply a `--walk` script: comma-separated steps, each either held
        keys for one frame at dt (`w`, `wd`, `W` = shift+w) or a camera
        command `yaw:+15` / `pitch:-10` (degrees) / `dt:0.05` /
        `speed:20`. Yields after each movement frame."""
        dt = 1.0 / 60.0
        for tok in script.split(","):
            tok = tok.strip()
            if not tok:
                continue
            if ":" in tok:
                k, _, val = tok.partition(":")
                v = float(val)
                if k == "yaw":
                    self.yaw = (self.yaw + math.radians(v)) % TAU
                elif k == "pitch":
                    limit = math.pi / 2 - 1e-4
                    self.pitch = min(max(self.pitch + math.radians(v), -limit), limit)
                elif k == "dt":
                    dt = v
                elif k == "speed":
                    self.walk_speed = v
                else:
                    raise ValueError(f"unknown walk command {tok!r}")
                continue
            self.held = {"shift"} if any(c.isupper() for c in tok) else set()
            self.held |= {c for c in tok.lower() if c in "wasdq"}
            self.update(dt)
            yield
        self.held = set()
