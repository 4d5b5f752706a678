"""Skeletal animation playback (counterpart of rend3-anim; port of
rend3_tpu/anim/__init__.py, host numpy).

Reference: rend3-anim/src/lib.rs — `AnimationData::from_gltf_scene` caches
node->joint maps and topological joint order per skin; `pose_animation_frame`
samples T/R/S channels with lerp/nlerp, composes local->global joint
transforms in topological order, and pushes object transforms + skeleton
joint matrices to the renderer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from ..types import Handedness, Skeleton

__all__ = ["AnimationData", "pose_animation_frame"]


def _decompose_trs(m: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mat4 -> (translation, rotation quat xyzw, scale), glam semantics."""
    t = m[:3, 3].copy()
    sx = np.linalg.norm(m[:3, 0])
    sy = np.linalg.norm(m[:3, 1])
    sz = np.linalg.norm(m[:3, 2])
    if np.linalg.det(m[:3, :3]) < 0:
        sx = -sx
    r = m[:3, :3] / np.array([sx, sy, sz])[None, :]
    # rotation matrix -> quaternion
    tr = r[0, 0] + r[1, 1] + r[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([(r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s, 0.25 * s])
    elif r[0, 0] > r[1, 1] and r[0, 0] > r[2, 2]:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
        q = np.array([0.25 * s, (r[0, 1] + r[1, 0]) / s, (r[0, 2] + r[2, 0]) / s, (r[2, 1] - r[1, 2]) / s])
    elif r[1, 1] > r[2, 2]:
        s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
        q = np.array([(r[0, 1] + r[1, 0]) / s, 0.25 * s, (r[1, 2] + r[2, 1]) / s, (r[0, 2] - r[2, 0]) / s])
    else:
        s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
        q = np.array([(r[0, 2] + r[2, 0]) / s, (r[1, 2] + r[2, 1]) / s, 0.25 * s, (r[1, 0] - r[0, 1]) / s])
    return t.astype(np.float32), q.astype(np.float32), np.array([sx, sy, sz], np.float32)


def _compose_trs(t: np.ndarray, q: np.ndarray, s: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    rot = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = rot * s[None, :]
    m[:3, 3] = t
    return m


def _sample(times: np.ndarray, values: np.ndarray, t: float, is_quat: bool) -> np.ndarray:
    """reference: lib.rs:165-176 sample_at_time (lerp / nlerp)."""
    nxt = int(np.searchsorted(times, t, side="right"))
    if nxt >= len(times):
        nxt = len(times) - 1
    prv = max(nxt - 1, 0)
    denom = times[nxt] - times[prv]
    f = float(np.clip((t - times[prv]) / denom, 0.0, 1.0)) if denom > 0 else 0.0
    a, b = values[prv], values[nxt]
    if is_quat and np.dot(a, b) < 0:
        b = -b
    v = a + (b - a) * f
    if is_quat:
        v = v / np.linalg.norm(v)
    return v


@dataclass
class AnimationData:
    """reference: lib.rs:78-143."""

    # skin index -> dict(node->joint idx, topo order of joint nodes, skeleton handles)
    skin_data: Dict[int, dict] = field(default_factory=dict)
    animation_skin_usage: Dict[int, List[int]] = field(default_factory=dict)

    @staticmethod
    def from_gltf_scene(scene, instance) -> "AnimationData":
        data = AnimationData()
        anim_nodes = [
            {ch["node"] for ch in anim["channels"]} for anim in scene.animations
        ]
        for ai, nodes_touched in enumerate(anim_nodes):
            for si, skin in enumerate(scene.skins):
                if any(j in nodes_touched for j in skin["joints"]):
                    data.animation_skin_usage.setdefault(ai, []).append(si)
        for si, skin in enumerate(scene.skins):
            joints = skin["joints"]
            node_to_joint = {n: j for j, n in enumerate(joints)}
            topo = [n for n in instance.topo_order if n in node_to_joint]
            # Skeleton handles: only skeletons instanced from nodes whose
            # armature uses THIS skin (reference lib.rs:127-135 filters by
            # armature.skin_index); collecting them all would write every
            # skin's joint matrices into every skeleton in multi-skin scenes.
            skeletons = []
            for node_idx, handles in instance.skeletons.items():
                if instance.node_skins.get(node_idx) == si:
                    skeletons.extend(handles)
            data.skin_data[si] = {
                "node_to_joint": node_to_joint,
                "topo": topo,
                "skeletons": skeletons,
            }
        return data


def pose_animation_frame(renderer, scene, instance, animation_data: AnimationData, animation_index: int, time: float):
    """reference: lib.rs:181-263."""
    anim = scene.animations[animation_index]
    duration = max((float(ch["times"].max()) for ch in anim["channels"] if len(ch["times"])), default=0.0)
    time = float(np.clip(time, 0.0, duration))

    # Group channels by node.
    by_node: Dict[int, dict] = {}
    for ch in anim["channels"]:
        by_node.setdefault(ch["node"], {})[ch["path"]] = ch

    local_matrices: Dict[int, np.ndarray] = {}
    for node_idx, chans in by_node.items():
        bind_t, bind_q, bind_s = _decompose_trs(instance.node_locals[node_idx])
        t = _sample(chans["translation"]["times"], chans["translation"]["values"], time, False) if "translation" in chans else bind_t
        q = _sample(chans["rotation"]["times"], chans["rotation"]["values"], time, True) if "rotation" in chans else bind_q
        s = _sample(chans["scale"]["times"], chans["scale"]["values"], time, False) if "scale" in chans else bind_s
        if renderer.handedness == Handedness.LEFT:
            s = s.copy()
            s[2] = -s[2]
        local_matrices[node_idx] = _compose_trs(np.asarray(t, np.float32), np.asarray(q, np.float32), np.asarray(s, np.float32))

    # Rigid (non-skinned) TRS animation: animated nodes that own mesh
    # primitives get their object transforms set to the sampled LOCAL matrix
    # (reference lib.rs:205-210 — the reference deliberately uses the local
    # matrix, not the composed world transform; kept for parity, including
    # the Z-scale flip applied above for left-handed renderers).
    for node_idx, m in local_matrices.items():
        for obj_handle in instance.objects_by_node.get(node_idx, []):
            renderer.set_object_transform(obj_handle, m)

    used_skins = animation_data.animation_skin_usage.get(animation_index, [])
    for si in used_skins:
        skin = scene.skins[si]
        per = animation_data.skin_data[si]
        node_to_joint = per["node_to_joint"]
        n_joints = len(skin["joints"])
        joint_local = [np.eye(4, dtype=np.float32)] * n_joints
        for node_idx, m in local_matrices.items():
            if node_idx in node_to_joint:
                joint_local[node_to_joint[node_idx]] = m
        global_joint = [np.eye(4, dtype=np.float32)] * n_joints
        for node_idx in per["topo"]:
            j = node_to_joint[node_idx]
            p = instance.node_parents[node_idx]
            pj = node_to_joint.get(p) if p is not None else None
            parent_m = global_joint[pj] if pj is not None else np.eye(4, dtype=np.float32)
            global_joint[j] = parent_m @ joint_local[j]
        jm = Skeleton.compute_joint_matrices(np.stack(global_joint), skin["inverse_bind_matrices"])
        for sk in per["skeletons"]:
            renderer.set_skeleton_joint_matrices(sk, jm)
