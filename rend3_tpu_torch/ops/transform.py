"""Vertex transform and near-plane clipping.

Port of rend3_tpu/ops/transform.py. The arithmetic follows the JAX
functions operand for operand (the parity tests hold the tables to them bit
for bit); only the TPU workarounds are gone: the crossing triangles are
compacted with `nonzero` to their real count instead of a static clip cap,
and per-triangle matrices are an index gather instead of a one-hot matmul.

Reference behavior being matched: wgpu clip volume 0 <= z <= w with reverse-Z
depth; the vertex stage itself is opaque.wgsl vs_main.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .fp import dot3, fma32

__all__ = [
    "ClippedTris",
    "object_uniforms",
    "tri_global_ids",
    "gather_tri_clip",
    "clip_triangles",
]

W_EPS = 1e-6


class ClippedTris(NamedTuple):
    """Post-clip triangle table: the T input rows, then up to three fan
    triangles per near-plane-crossing triangle (all first fans, then all
    second fans, then all third fans, as in the JAX table).

    clip:  (T', 3, 4) clip-space corner positions
    orig:  (T',) index of the source triangle in the pre-clip table
    bary:  (T', 3, 3) each clipped corner as barycentrics of the source tri
    valid: (T',) bool
    """

    clip: torch.Tensor
    orig: torch.Tensor
    bary: torch.Tensor
    valid: torch.Tensor


def _mat4_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for (..., 4, 4) operands with the k-sum taken pairwise,
    (k0 + k1) + (k2 + k3): the order XLA:CPU gives the JAX einsum, so the
    matrices agree bit for bit."""
    p = [a[..., :, k, None] * b[..., k, None, :] for k in range(4)]
    return (p[0] + p[1]) + (p[2] + p[3])


def object_uniforms(
    transforms: torch.Tensor, view: torch.Tensor, proj: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-object model_view and model_view_proj (the uniform-prep pass,
    reference: uniform_prep.wgsl:9-27).

    transforms: (O, 4, 4); view, proj: (4, 4) -> ((O,4,4), (O,4,4))
    """
    model_view = _mat4_mul(view, transforms)
    model_view_proj = _mat4_mul(proj, model_view)
    return model_view, model_view_proj


def tri_global_ids(
    tri_vlocal: torch.Tensor, tri_obj: torch.Tensor, base_position: torch.Tensor, n_verts: int
) -> torch.Tensor:
    """Global position-arena ids per corner: (T, 3) int64."""
    obj = tri_obj.clamp_min(0).long()
    ids = tri_vlocal.long() + base_position[obj].long()[:, None]
    return ids.clamp(0, n_verts - 1)


def gather_tri_clip(
    positions: torch.Tensor,     # (V, 3) position arena
    tri_vlocal: torch.Tensor,    # (T, 3) mesh-local vertex ids
    tri_obj: torch.Tensor,       # (T,) object ids (-1 invalid)
    base_position: torch.Tensor,  # (O,) per-object position arena base
    mvp: torch.Tensor,           # (O, 4, 4)
    tri_pos: torch.Tensor = None,  # optional pre-gathered (T, 3, 3) corners
    *,
    contract: bool = False,
) -> torch.Tensor:
    """Gather corner positions and transform to clip space: (T, 3, 4).

    contract: the form XLA:CPU gives the JAX function inside a jitted
    program, fma(m2, p2, fma(m1, p1, m0*p0)) + m3 (the frame's form); the
    default is the form of the eager JAX function."""
    if tri_pos is None:
        tri_pos = positions[tri_global_ids(tri_vlocal, tri_obj, base_position, positions.shape[0])]
    m = mvp[tri_obj.clamp_min(0).long()]                     # (T, 4, 4)
    p = tri_pos
    if contract:
        return dot3(*(t for k in range(3) for t in (m[:, None, :, k], p[:, :, None, k]))) + m[:, None, :, 3]
    # clip[t, c, a] = ((m[a,0] p0 + m[a,1] p1) + m[a,2] p2) + m[a,3]
    return (
        m[:, None, :, 0] * p[:, :, None, 0]
        + m[:, None, :, 1] * p[:, :, None, 1]
        + m[:, None, :, 2] * p[:, :, None, 2]
        + m[:, None, :, 3]
    )


def _clip_one_plane(verts, bary, count, plane_fn, contract=False):
    """Sutherland-Hodgman step against one plane for polygons of up to 4
    vertices in 5-slot buffers, vectorized over the leading axis.

    verts: (T, 5, 4), bary: (T, 5, 3), count: (T,) int64 in [0, 4];
    plane_fn(v) >= 0 means inside."""
    n_slots = verts.shape[1]
    d = plane_fn(verts)                  # (T, 5)
    inside = d >= 0.0
    out_v = torch.zeros_like(verts)
    out_b = torch.zeros_like(bary)
    out_n = torch.zeros_like(count)
    slots = torch.arange(n_slots, device=verts.device)

    def put(buf, idx, val, mask):
        sel = (slots[None, :] == idx[:, None]) & mask[:, None]
        return torch.where(sel[:, :, None], val[:, None, :], buf)

    for i in range(n_slots - 1):
        wrap = (i + 1) >= count
        live = i < count
        j = min(i + 1, n_slots - 1)

        def nxt(a):
            w = wrap.reshape((-1,) + (1,) * (a.dim() - 2))
            return torch.where(w, a[:, 0], a[:, j])

        vi, vj = verts[:, i], nxt(verts)
        bi, bj = bary[:, i], nxt(bary)
        di, dj = d[:, i], nxt(d)
        ini, inj = inside[:, i], nxt(inside)

        emit_cur = live & ini
        out_v = put(out_v, out_n, vi, emit_cur)
        out_b = put(out_b, out_n, bi, emit_cur)
        out_n = out_n + emit_cur.long()

        crosses = live & (ini != inj)
        den = di - dj
        t = di / torch.where(den.abs() < 1e-30, torch.full_like(den, 1e-30), den)
        if contract:
            v_int = fma32(vj - vi, t[:, None], vi)
            b_int = fma32(bj - bi, t[:, None], bi)
        else:
            v_int = vi + (vj - vi) * t[:, None]
            b_int = bi + (bj - bi) * t[:, None]
        out_v = put(out_v, out_n, v_int, crosses)
        out_b = put(out_b, out_n, b_int, crosses)
        out_n = out_n + crosses.long()
    return out_v, out_b, out_n


def _clip_triangles_full(clip: torch.Tensor, contract: bool = False) -> ClippedTris:
    """Full Sutherland-Hodgman against w >= eps and w - z >= 0 with fan
    triangulation, for the (already compacted) crossing triangles."""
    T = clip.shape[0]
    dev, dt = clip.device, clip.dtype
    verts = torch.cat([clip, torch.zeros(T, 2, 4, device=dev, dtype=dt)], dim=1)
    eye3 = torch.eye(3, device=dev, dtype=dt).expand(T, 3, 3)
    bary = torch.cat([eye3, torch.zeros(T, 2, 3, device=dev, dtype=dt)], dim=1)
    count = torch.full((T,), 3, dtype=torch.long, device=dev)
    verts, bary, count = _clip_one_plane(verts, bary, count, lambda v: v[..., 3] - W_EPS, contract)
    verts, bary, count = _clip_one_plane(verts, bary, count, lambda v: v[..., 3] - v[..., 2], contract)
    outs_v, outs_b, outs_m = [], [], []
    for k in range(3):
        outs_v.append(torch.stack([verts[:, 0], verts[:, k + 1], verts[:, k + 2]], dim=1))
        outs_b.append(torch.stack([bary[:, 0], bary[:, k + 1], bary[:, k + 2]], dim=1))
        outs_m.append(count >= k + 3)
    ids = torch.arange(T, device=dev)
    return ClippedTris(
        clip=torch.cat(outs_v), orig=ids.repeat(3), bary=torch.cat(outs_b), valid=torch.cat(outs_m)
    )


def clip_triangles(clip: torch.Tensor, tri_valid: torch.Tensor, *, contract: bool = False) -> ClippedTris:
    """Near-plane clipping with crossing-only expansion.

    Triangles fully inside (w > eps and w - z >= 0 at every corner) pass
    through untouched; fully outside ones are dropped; only crossing
    triangles are clipped, appending <= 3 fan triangles each.

    contract: the form XLA:CPU gives the JAX function inside a jitted
    program (the frame's form): each intersection vi + (vj - vi) * t as
    fma(vj - vi, t, vi). The default is the eager JAX form.

    Host read: `nonzero` sizes the crossing set (one device sync)."""
    T = clip.shape[0]
    d = clip[..., 3] - clip[..., 2]
    inside = (d >= 0.0) & (clip[..., 3] > W_EPS)
    all_in = inside.all(dim=-1)
    crossing = tri_valid & inside.any(dim=-1) & ~all_in
    g = torch.nonzero(crossing).flatten()
    sub = _clip_triangles_full(clip[g], contract)
    eye3 = torch.eye(3, device=clip.device, dtype=clip.dtype).expand(T, 3, 3)
    return ClippedTris(
        clip=torch.cat([clip, sub.clip]),
        orig=torch.cat([torch.arange(T, device=clip.device), g[sub.orig]]),
        bary=torch.cat([eye3, sub.bary]),
        valid=torch.cat([tri_valid & all_in, sub.valid]),
    )
