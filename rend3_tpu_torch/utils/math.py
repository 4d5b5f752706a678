"""Matrix / projection / frustum math for the TPU renderer.

Column-vector convention throughout (``M @ v``), matching the semantics of the
reference's glam `Mat4` (reference: rend3/src/managers/camera.rs:88-107,
rend3/src/util/frustum.rs:9-162). All host math is float32 numpy; the same
formulas are usable on jnp arrays inside jit (they only use *, +, /).

The projection matrices reproduce glam's `perspective_infinite_reverse_lh/rh`,
`orthographic_lh/rh`, and `look_at_lh/rh` behaviorally (wgpu depth range
[0, 1], reverse-Z for perspective).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "IDENTITY",
    "perspective_infinite_reverse_lh",
    "perspective_infinite_reverse_rh",
    "orthographic_lh",
    "orthographic_rh",
    "look_at_lh",
    "look_at_rh",
    "translation",
    "scale",
    "rotation_x",
    "rotation_y",
    "rotation_z",
    "transform_point",
    "transform_vector",
    "Frustum",
    "BoundingSphere",
]

IDENTITY = np.eye(4, dtype=np.float32)


def _mat4(rows) -> np.ndarray:
    return np.array(rows, dtype=np.float32)


def perspective_infinite_reverse_lh(vfov_rad: float, aspect: float, near: float) -> np.ndarray:
    """Left-handed infinite-far reverse-Z perspective (depth: near->1, inf->0)."""
    f = 1.0 / np.tan(0.5 * vfov_rad)
    return _mat4([
        [f / aspect, 0.0, 0.0, 0.0],
        [0.0, f, 0.0, 0.0],
        [0.0, 0.0, 0.0, near],
        [0.0, 0.0, 1.0, 0.0],
    ])


def perspective_infinite_reverse_rh(vfov_rad: float, aspect: float, near: float) -> np.ndarray:
    """Right-handed infinite-far reverse-Z perspective."""
    f = 1.0 / np.tan(0.5 * vfov_rad)
    return _mat4([
        [f / aspect, 0.0, 0.0, 0.0],
        [0.0, f, 0.0, 0.0],
        [0.0, 0.0, 0.0, near],
        [0.0, 0.0, -1.0, 0.0],
    ])


def orthographic_lh(left, right, bottom, top, near, far) -> np.ndarray:
    """Left-handed orthographic with wgpu [0,1] depth range (glam semantics)."""
    rcp_w = 1.0 / (right - left)
    rcp_h = 1.0 / (top - bottom)
    r = 1.0 / (far - near)
    return _mat4([
        [2.0 * rcp_w, 0.0, 0.0, -(left + right) * rcp_w],
        [0.0, 2.0 * rcp_h, 0.0, -(top + bottom) * rcp_h],
        [0.0, 0.0, r, -r * near],
        [0.0, 0.0, 0.0, 1.0],
    ])


def orthographic_rh(left, right, bottom, top, near, far) -> np.ndarray:
    """Right-handed orthographic with wgpu [0,1] depth range (glam semantics)."""
    rcp_w = 1.0 / (right - left)
    rcp_h = 1.0 / (top - bottom)
    r = 1.0 / (near - far)
    return _mat4([
        [2.0 * rcp_w, 0.0, 0.0, -(left + right) * rcp_w],
        [0.0, 2.0 * rcp_h, 0.0, -(top + bottom) * rcp_h],
        [0.0, 0.0, r, r * near],
        [0.0, 0.0, 0.0, 1.0],
    ])


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def look_at_lh(eye, center, up) -> np.ndarray:
    """Left-handed look-at view matrix (camera looks down +Z in view space)."""
    eye = np.asarray(eye, dtype=np.float32)
    center = np.asarray(center, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)
    f = _normalize(center - eye)           # forward (+Z in view)
    s = _normalize(np.cross(up, f))        # right
    u = np.cross(f, s)                     # true up
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = -np.dot(f, eye)
    return m


def look_at_rh(eye, center, up) -> np.ndarray:
    """Right-handed look-at view matrix (camera looks down -Z in view space)."""
    eye = np.asarray(eye, dtype=np.float32)
    center = np.asarray(center, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)
    f = _normalize(center - eye)
    s = _normalize(np.cross(f, up))
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


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


def rotation_z(rad: float) -> np.ndarray:
    c, s = np.cos(rad), np.sin(rad)
    return _mat4([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])


def transform_point(m: np.ndarray, p) -> np.ndarray:
    p = np.asarray(p, dtype=np.float32)
    v = m @ np.append(p, 1.0).astype(np.float32)
    return v[:3]


def transform_vector(m: np.ndarray, p) -> np.ndarray:
    p = np.asarray(p, dtype=np.float32)
    v = m @ np.append(p, 0.0).astype(np.float32)
    return v[:3]


class BoundingSphere:
    """AABB-center bounding sphere (reference: rend3/src/util/frustum.rs:9-57)."""

    __slots__ = ("center", "radius")

    def __init__(self, center, radius: float):
        self.center = np.asarray(center, dtype=np.float32)
        self.radius = float(radius)

    @classmethod
    def from_points(cls, points: np.ndarray) -> "BoundingSphere":
        points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
        if len(points) == 0:
            return cls(np.zeros(3, dtype=np.float32), 0.0)
        center = (points.max(axis=0) + points.min(axis=0)) * 0.5
        radius = float(np.sqrt(((points - center) ** 2).sum(axis=1).max()))
        return cls(center, radius)

    def apply_transform(self, m: np.ndarray) -> "BoundingSphere":
        max_scale = float(np.sqrt((m[:3, :3] ** 2).sum(axis=0).max()))
        center = transform_point(m, self.center)
        return BoundingSphere(center, max_scale * self.radius)

    def as_vec4(self) -> np.ndarray:
        return np.append(self.center, np.float32(self.radius)).astype(np.float32)


class Frustum:
    """Five-plane frustum (no far plane: infinite reverse-Z).

    Gribb-Hartmann extraction from a view-projection matrix, with the "far"
    plane used as near because of reverse-Z
    (reference: rend3/src/util/frustum.rs:96-147).

    ``planes`` is a (5, 4) float32 array of (a, b, c, d), normalized.
    """

    __slots__ = ("planes",)

    def __init__(self, planes: np.ndarray):
        self.planes = np.asarray(planes, dtype=np.float32).reshape(5, 4)

    @classmethod
    def from_matrix(cls, m: np.ndarray) -> "Frustum":
        # Row i of the matrix in column-vector convention.
        r0, r1, r2, r3 = m[0], m[1], m[2], m[3]
        left = r3 + r0
        right = r3 - r0
        top = r3 - r1
        bottom = r3 + r1
        near = r3 - r2  # reverse-Z: algorithm's far plane acts as near
        planes = np.stack([left, right, top, bottom, near])
        norms = np.linalg.norm(planes[:, :3], axis=1, keepdims=True)
        return cls(planes / norms)

    def contains_sphere(self, sphere: BoundingSphere) -> bool:
        d = self.planes[:, :3] @ sphere.center + self.planes[:, 3]
        return bool((d >= -sphere.radius).all())

    def contains_spheres(self, spheres: np.ndarray) -> np.ndarray:
        """Vectorized test. spheres: (N, 4) [cx, cy, cz, r] -> (N,) bool."""
        spheres = np.asarray(spheres, dtype=np.float32).reshape(-1, 4)
        d = spheres[:, :3] @ self.planes[:, :3].T + self.planes[:, 3]  # (N, 5)
        return (d >= -spheres[:, 3:4]).all(axis=1)
