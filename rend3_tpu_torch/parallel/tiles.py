"""Row bands: the frame split into screen row bands, one a device.

Port of rend3_tpu/parallel/tiles.py. Each band runs the same deferred frame
as one device (routine/base.py `_render_frame_stages(band=(row0, band_h))`) on the
rows [row0, row0 + band_h) of the target, with the scene state (geometry
arenas, object / material / light tables) replicated. Pixel positions stay
in target coordinates, with integer row offsets added before any float
math, so the banded image equals the one-device frame bit for bit.

Shadow maps come from the cached shadow pass (`_ensure_shadow_maps`), so
every band holds the same maps and only the PCF resolve is banded. The
phase-1 occluder depth of every band is gathered into the target's Hi-Z
pyramid, so every band tests visibility at target coordinates and carries
the same predicted mask.

Two meshes, both explicit:

- `LocalMesh`: n bands on one device in one process, in lockstep (every
  band's phase 1, the gather, every band's phase 2): the counterpart of
  JAX's virtual CPU mesh, and the way to band on one card;
- `DistributedMesh`: one rank a device through `torch.distributed`, NCCL
  for CUDA tensors and gloo for CPU tensors; the band depth and the band
  images go through `dist.all_gather`. A CUDA mesh without NCCL raises:
  nothing falls back to gloo, the CPU or a plain kernel.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

__all__ = ["TILE_AXIS", "LocalMesh", "DistributedMesh", "device_mesh", "build_tiled_frame_callable"]

TILE_AXIS = "tiles"


class LocalMesh:
    """n row bands on one device, in one process."""

    def __init__(self, n: int, device):
        from ..core.renderer import _resolve_device

        if n < 1:
            raise ValueError(f"a mesh needs at least one band, not {n}")
        self.size = int(n)
        self.device = _resolve_device(device, "device_mesh")

    def __repr__(self):
        return f"LocalMesh({self.size}, {self.device})"


class DistributedMesh:
    """One row band per rank of a torch.distributed group: this rank's band
    is its rank's. The group's backend must suit the device: NCCL for CUDA,
    gloo for the CPU."""

    def __init__(self, device, group=None):
        import torch.distributed as dist

        from ..core.renderer import _resolve_device

        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("a distributed mesh needs torch.distributed.init_process_group first")
        self.device = _resolve_device(device, "device_mesh")
        self.group = group
        backend = str(dist.get_backend(group)).lower()  # "nccl", "gloo" or "cpu:gloo,cuda:nccl"
        want = "nccl" if self.device.type == "cuda" else "gloo"
        if want not in backend:
            raise RuntimeError(
                f"a {self.device.type} mesh needs a {want} process group, not {backend}: "
                "the band frame does not fall back to another backend or device"
            )
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def __repr__(self):
        return f"DistributedMesh(rank {self.rank} of {self.size}, {self.device})"


def device_mesh(n_devices: Optional[int] = None, *, device="cuda", distributed: bool = False):
    """The mesh of n_devices row bands, on the card unless `device` says
    "cpu" (a CUDA mesh needs a card; none is faked).

    distributed=False: a LocalMesh of n_devices bands on one device in this
    process (default: torch.cuda.device_count() for the card, 1 for the
    CPU). distributed=True: a DistributedMesh over the initialised default
    process group, one band a rank on this rank's `device` (default the
    current CUDA device); n_devices, if given, must be the world size."""
    if distributed:
        mesh = DistributedMesh(device)
        if n_devices is not None and n_devices != mesh.size:
            raise ValueError(f"n_devices={n_devices}, but the process group has {mesh.size} ranks")
        return mesh
    from ..core.renderer import _resolve_device

    dev = _resolve_device(device, "device_mesh")
    if n_devices is None:
        n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    return LocalMesh(n_devices, dev)


def _band_h(target, n: int) -> int:
    if target.height % n:
        raise ValueError(f"target height {target.height} must divide across {n} devices")
    return target.height // n


def _max_stats(stats):
    """Every stat is a per-band count or need; the frame's is the largest
    (JAX's pmax over the aux slots, parallel/tiles.py:85-92)."""
    out = {}
    for st in stats:
        for k, v in st.items():
            out[k] = max(out[k], v) if k in out else v
    return out


def _run_local(graph, mesh: LocalMesh, eval_output, frame):
    """The n bands in lockstep: each band's frame runs to its gather (its
    phase 1, which reads the carried mask before any band writes it), the
    bands' occluder rows are concatenated, and each band's frame runs on to
    its image. Each band keeps its own stats while it runs."""
    n = mesh.size
    bh = _band_h(frame.target, n)
    stats = [dict(graph.last_stats) for _ in range(n)]
    steps = [graph._render_frame_stages(eval_output, frame, band=(i * bh, bh)) for i in range(n)]
    images = [None] * n

    def resume(i, value):
        """Band i's next request (its occluder rows), or None once it returned its image."""
        graph.last_stats = stats[i]
        try:
            return steps[i].send(value)
        except StopIteration as done:
            images[i] = done.value
            return None

    rows = [resume(i, None) for i in range(n)]
    waiting = [r is not None for r in rows]
    if any(waiting):
        if not all(waiting):
            raise RuntimeError("the bands disagree on whether the frame gathers its occluder depth")
        depth = torch.cat(rows, dim=0)
        for i in range(n):
            if resume(i, depth) is not None:
                raise RuntimeError(f"band {i} asked for a second gather")
    graph.last_stats = _max_stats(stats)
    return torch.cat(images, dim=0)


def _all_gather(mesh: DistributedMesh, t: torch.Tensor):
    """Every rank's t (the same shape on every rank), in rank order. The
    list form of all_gather (all_gather_into_tensor is deprecated on newer
    torch)."""
    import torch.distributed as dist

    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(out, t, group=mesh.group)
    return out


def _run_distributed(graph, mesh: DistributedMesh, eval_output, frame):
    import torch.distributed as dist

    from ..routine.base import drive_frame

    bh = _band_h(frame.target, mesh.size)
    steps = graph._render_frame_stages(eval_output, frame, band=(mesh.rank * bh, bh))
    # NCCL's object gather stages through the current CUDA device.
    with torch.cuda.device(mesh.device) if mesh.device.type == "cuda" else contextlib.nullcontext():
        band = drive_frame(steps, lambda rows: torch.cat(_all_gather(mesh, rows), dim=0))
        image = torch.cat(_all_gather(mesh, band), dim=0)
        stats = [None] * mesh.size
        dist.all_gather_object(stats, dict(graph.last_stats), group=mesh.group)
    graph.last_stats = _max_stats(stats)
    return image


def build_tiled_frame_callable(
    graph,
    eval_output,
    target,
    settings=None,
    skybox_slot=None,
    *,
    mesh=None,
):
    """(program, args): the row-band frame of `graph` over `mesh` (default
    device_mesh(): the card). args are the one-device frame's, from
    graph.build_frame_callable (its upload, done once for every band);
    program(*args) returns (image, predicted_mask, aux) like the one-device
    program: the whole (H, W, 4) u8 image on the mesh's device (on every
    rank of a distributed mesh), the carried predicted-visible mask over the
    triangle table (the same on every band; the graph also keeps it for the
    next frame, as render_frame does) and the frame's stats, each the
    largest over the bands. The full pass list survives banding: two-phase
    occlusion culling, MSAA 1 and 4, cutout and blend peels, shadows over
    the cached maps, textures, the skybox and injected passes (4-parameter
    passes get their band's first row). The deferred frame only:
    REND3_TPU_RASTER=reference raises."""
    from ..routine.base import BaseRenderGraphSettings

    settings = settings or BaseRenderGraphSettings()
    mesh = mesh or device_mesh()
    _band_h(target, mesh.size)
    if graph.renderer.device != mesh.device:
        raise ValueError(f"the graph renders on {graph.renderer.device}, the mesh is on {mesh.device}")
    run = _run_local if isinstance(mesh, LocalMesh) else _run_distributed
    _one_device, args = graph.build_frame_callable(eval_output, target, settings, skybox_slot)

    def program(eval_output, frame):
        image = run(graph, mesh, eval_output, frame)
        return image, graph._prev_visible_mask, dict(graph.last_stats)

    return program, args
