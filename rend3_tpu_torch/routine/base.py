"""BaseRenderGraph: the canonical deferred frame, one plain function per stage.

Port of rend3_tpu/routine/base.py for the deferred frame at 1 or 4 samples
(MSAA 4): opaque, cutout (alpha-tested) and alpha-blended materials,
textures, shadows, two-phase Hi-Z occlusion culling, and the frame's
extension features: the skybox (on K4), GPU skinning, registered material
routines in all three transparency modes and injected passes. In the JAX package
`render_frame` traces one closure into one XLA program (base.py:1147-2110);
here each stage is a function over torch tensors on the renderer's device:

    upload (skinning) -> shadow maps (K2, cached) -> clip -> setup -> planes -> bin ->
    G-buffer per sample (K1) -> [occlusion on: Hi-Z pyramid of the min over
    samples + visibility test (K5) -> residual setup / planes / bin,
    G-buffer per sample (K1) and merge] -> [cutout peels: Hi-Z-tested setup
    (K5), planes, bin, then per sample K1 count and bound modes and the
    alpha test (K4)] -> [skybox where no fragment hit (K4)] -> [blend peels:
    shared geometry, per sample K1 count and bound modes, compacted hit
    pixels] -> shadow coordinates -> PCF (K3, every sample's opaque and
    blend pixels in one launch) -> per sample textures (K4), lighting,
    registered routines, blend shading and compositing -> f16 round trip ->
    resolve (mean over samples) -> [hdr passes] -> blit -> [srgb passes]

As in JAX, `build_frame_callable` does the upload once and returns
(program, args); program(*args) runs the rest of the frame, and
`render_frame` is the two together.

A row band (parallel/tiles.py) is the same frame restricted to the target
rows [row0, row0 + band_h) (JAX's band frame, base.py:1120-1203): the
viewport reject, the binning and K1 take the band's first row, every pixel
position stays in target coordinates (integer row offsets added before any
float math), and the phase-1 occluder depth of every band is gathered into
the target's Hi-Z pyramid, so a band's pixels equal the whole frame's bit
for bit. `_render_frame_stages` is the frame after its upload as a generator
that yields the band's occluder depth rows and is sent the target's;
`drive_frame` runs one.

Under MSAA the geometry work (cull, setup, planes, binning) runs once per
pass and K1 runs once per sample offset (base.py:1353-1374); sub-pixel
culling, a pixel-centre test, is off (base.py:1326-1329).

Every buffer is sized from the frame's real counts, so the TPU build's
survivor / flat-list / queue / peel caps, their growth and re-render loop
and the program cache have no counterpart. The counts are read on the host
where a `nonzero` or a pair total sizes a table (transform.clip_triangles,
geometry.cull_and_setup, geometry.bin_triangles, the plain raster versions'
fragment count) and where a peel loop sizes itself (_cutout_peels and
_blend_peels count theirs). Each such read, and each upload that
synchronizes the stream, is a `sync::<site>` span of utils/profiling.py;
each stage is a `graph::<stage>` span (BaseRenderGraph.stage).

The reference forward backend (REND3_TPU_RASTER=reference,
`default_raster_backend`) renders the JAX package's forward frame instead
(base.py:1249-2050 with use_deferred off): a shadow atlas rasterized by
raster.rasterize every frame, the skybox background, the main raster, then
shade.shade_deferred, and the blend triangles drawn one by one in order
(`_blend_pass`). It has no occlusion culling, draws cutout triangles as
opaque ones (JAX passes no fragment mask), and shades with the PBR table
only, so registered archetypes do not draw; injected passes get no
G-buffer. `raster_scene(backend="reference")` is raster.rasterize.
"""

from __future__ import annotations

import copy
import hashlib
import inspect
import os
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.renderer import InstructionEvaluationOutput, Renderer
from ..ops import blit as blit_ops
from ..ops import deferred as def_ops
from ..ops import fp as fp_ops
from ..ops import geometry as geom_ops
from ..ops import hi_z as hiz_ops
from ..ops import lighting as light_ops
from ..ops import raster as raster_ops
from ..ops import raster_binned as rb_ops
from ..ops import samplers as samplers_ops
from ..ops import shade as shade_ops
from ..ops import shadow as shadow_ops
from ..ops import skin as skin_ops
from ..ops import texture as tex_ops
from ..ops import transform as transform_ops
from ..types import Handedness
from ..types.error import DeviceOutOfMemoryError
from ..utils import profiling
from ..utils.profiling import scope as profiling_scope

__all__ = [
    "BaseRenderGraph", "BaseRenderGraphSettings", "FrameRenderTarget", "StageTimer", "default_raster_backend",
    "drive_frame", "raster_scene", "sky_directions",
]

RASTER_BACKENDS = ("pallas", "binned_xla", "reference")


@dataclass(frozen=True)
class BaseRenderGraphSettings:
    """reference: base.rs:94-98."""

    ambient_color: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    clear_color: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)


@dataclass(frozen=True)
class FrameRenderTarget:
    width: int
    height: int
    samples: int = 1  # 1, or 4 (MSAA)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def default_raster_backend() -> str:
    """The raster backend the frame uses (base.py:66-74): the value of
    REND3_TPU_RASTER, else "pallas". "pallas" and "binned_xla" both select
    the deferred frame on the hand-written kernels; "reference" selects the
    forward frame on raster.rasterize."""
    env = os.environ.get("REND3_TPU_RASTER") or "pallas"
    if env not in RASTER_BACKENDS:
        raise ValueError(f"REND3_TPU_RASTER={env!r}: the raster backend is one of {RASTER_BACKENDS}")
    return env


def raster_scene(
    clip: torch.Tensor,
    valid: torch.Tensor,
    width: int,
    height: int,
    *,
    cull_mode: int,
    front_is_cw: bool,
    sample_offsets,
    backend: str = "pallas",
) -> raster_ops.VisBuffer:
    """The scene's (S, height, width) visibility buffer (base.py:95-124):
    cull and set up (sub-pixel cull only at one sample), bin at K6's 8x128
    tiles, K6, crop. "pallas" and "binned_xla" both run K6 on a card and
    its plain version on the CPU; "reference" is raster.rasterize, the
    O(T x P) oracle."""
    if backend == "reference":
        return raster_ops.rasterize(
            clip, valid, width, height, cull_mode=cull_mode, front_is_cw=front_is_cw, sample_offsets=sample_offsets,
        )
    if backend not in ("pallas", "binned_xla"):
        raise ValueError(f"unknown raster backend {backend!r}")
    wp = _round_up(width, geom_ops.TILE_W)
    hp = _round_up(height, geom_ops.TILE_H)
    tris = geom_ops.cull_and_setup(
        clip, valid, width, height, cull_mode=cull_mode, front_is_cw=front_is_cw,
        subpixel=len(sample_offsets) == 1,
    )
    binned = geom_ops.bin_triangles(tris, wp, hp, tile_h=geom_ops.TILE_H, tile_w=geom_ops.TILE_W)
    vis = rb_ops.rasterize_binned(tris, binned, wp, hp, sample_offsets)
    if (wp, hp) != (width, height):
        vis = raster_ops.VisBuffer(depth=vis.depth[:, :height, :width], tri=vis.tri[:, :height, :width])
    return vis


def sky_directions(inv: torch.Tensor, width: int, height: int, hp: int, wp: int, sofs, row0: int = 0) -> torch.Tensor:
    """(hp * wp, 3) unit world view directions of the padded frame's pixels
    at sample offset sofs (base.py:1576-1591), the rows from target row
    row0 on (a row band's first row, added as an integer before the float
    conversion, base.py:1578): ndc from the sample position,
    times inv_origin_view_proj, divided by w and normalised. The product is
    summed column by column in order, with no fma, as XLA:CPU computes the
    JAX frame's (N, 4) x (4, 4) dot (bit for bit); the normalisation agrees
    with the JAX frame's to an ulp or two (XLA fuses it its own way)."""
    ox, oy = sofs
    dev = inv.device
    cols = torch.arange(wp, dtype=torch.float32, device=dev) + ox
    rows = (torch.arange(hp, dtype=torch.int32, device=dev) + row0).float() + oy
    py, px = torch.meshgrid(rows, cols, indexing="ij")
    ndc_x = (px / width * 2.0 - 1.0).reshape(-1)
    ndc_y = (1.0 - py / height * 2.0).reshape(-1)
    world = [((ndc_x * inv[i, 0] + ndc_y * inv[i, 1]) + inv[i, 2]) + inv[i, 3] for i in range(4)]
    w = world[3]
    wdir = torch.stack(world[:3], dim=1) / torch.where(w == 0.0, torch.ones_like(w), w)[:, None]
    nlen = def_ops.sqrt32((wdir * wdir).sum(-1))
    return wdir / torch.where(nlen == 0.0, torch.ones_like(nlen), nlen)[:, None]


class StageTimer:
    """Per-stage times of the frames rendered while it is installed
    (graph.timer): CUDA events on a card, the host clock after a
    synchronize on the CPU. `ms()` sums each stage's time in milliseconds."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"
        self._spans = []

    @contextmanager
    def __call__(self, name: str):
        if self.cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            yield
            e1.record()
            self._spans.append((name, e0, e1))
        else:
            t0 = time.perf_counter()
            yield
            self._spans.append((name, (time.perf_counter() - t0) * 1e3))

    def ms(self) -> Dict[str, float]:
        if self.cuda:
            torch.cuda.synchronize()
        out: Dict[str, float] = {}
        for span in self._spans:
            t = span[1].elapsed_time(span[2]) if self.cuda else span[1]
            out[span[0]] = out.get(span[0], 0.0) + t
        return out


# Span names of the graph's stages, by stage (built once each).
_STAGE_SPANS: Dict[str, str] = {}
# The stage of work timed as a part of its caller's stage: none of its own.
_WITHIN = nullcontext()


def _within(_name):
    return _WITHIN


@contextmanager
def _timed_stage(span, timed):
    """A stage's span around the installed StageTimer's stage."""
    with span, timed:
        yield


@contextmanager
def _device_oom():
    """A device out-of-memory inside reaches the caller as
    DeviceOutOfMemoryError, its cause chained; any other error passes
    through unchanged."""
    try:
        yield
    except RuntimeError as e:  # torch.cuda.OutOfMemoryError is one
        if isinstance(e, torch.cuda.OutOfMemoryError) or "out of memory" in str(e).lower():
            raise DeviceOutOfMemoryError(str(e)) from e
        raise


class _Frame:
    """One frame's device inputs (the upload stage's output)."""


def drive_frame(steps, gather):
    """Runs a BaseRenderGraph._render_frame_stages generator to its end and
    returns its image, answering its request (the band's (band_h, W)
    phase-1 occluder depth rows, with occlusion culling on) with
    gather(rows), the target's (H, W) occluder depth."""
    try:
        rows = next(steps)
        while True:
            rows = steps.send(gather(rows))
    except StopIteration as done:
        return done.value


class BaseRenderGraph:
    def __init__(self, renderer: Renderer):
        self.renderer = renderer
        # Two-phase Hi-Z occlusion culling (reference base.rs:155-172),
        # image-neutral, on by default as in the JAX package (base.py:156-161).
        # The predicted-visible mask over the triangle table is carried from
        # frame to frame.
        self.occlusion_culling = True
        self._prev_visible_mask: Optional[torch.Tensor] = None
        self.timer: Optional[StageTimer] = None
        # When a dict, each kernel's inputs of the last frame are kept here
        # (for comparing a kernel with its plain version on real inputs).
        self.captured: Optional[dict] = None
        self.last_stats: Dict[str, int] = {}
        self._tri_cache = None
        self._tri_dev = None
        self._obj_tbl_key = None
        self._cut_key = None
        self._cut_dev = None
        self._shadow_cache = None
        # (shadow pass, its inputs) of the last shadow maps rendered.
        self._last_shadow_call = None
        self._skin_key = None
        self._skin = None
        self._skinned = None
        # Registered per-archetype shading routines (routine/registry.py;
        # reference: the per-archetype vtable, material.rs:43-61). Objects
        # of archetypes other than PbrMaterial with no routine do not draw.
        self.routines: Dict[str, object] = {}
        self._gslot_key = None
        # Injected passes (fn, stage), run in registration order (the
        # reference graph's arbitrary-node seam, rend3/src/graph/node.rs).
        self.injected_passes: list = []

    def register_routine(self, routine) -> None:
        """Install a MaterialRoutine (routine/registry.py) so objects of
        its material archetype draw through the deferred frame (opaque,
        cutout depth peels, or ordered blend peels per its transparency)."""
        self.routines[routine.archetype] = routine
        self._gslot_key = None
        self._cut_key = None

    def register_pass(self, fn, stage: str = "srgb") -> None:
        """Inject a pass into the frame (base.py:194-216):

        - stage="srgb" (default): fn runs after tonemapping on the final
          (H, W, 4) u8 sRGB image;
        - stage="hdr": fn runs on the resolved (H, W, 4) f32 linear image,
          after the MSAA resolve and before the sRGB OETF.

        fn(img, gbuf, uniforms) -> img, where gbuf is sample 0's padded
        G-buffer (deferred.GBuffer); a 4-parameter fn also gets row0, the
        target row of the image's first row (a row band's; 0 for a whole
        frame)."""
        if stage not in ("srgb", "hdr"):
            raise ValueError(f"register_pass stage must be 'srgb' or 'hdr', got {stage!r}")
        self.injected_passes.append((fn, stage))

    def unregister_pass(self, fn) -> None:
        """Remove a registered pass (the next frame runs without it); no-op
        if absent."""
        self.injected_passes = [(f, s) for (f, s) in self.injected_passes if f is not fn]

    # -- stages ----------------------------------------------------------------

    def stage(self, name: str):
        """The context of the frame's stage `name`: the span graph::<name>
        and, while a StageTimer is installed (graph.timer), its stage."""
        span_name = _STAGE_SPANS.get(name)
        if span_name is None:
            span_name = _STAGE_SPANS[name] = "graph::" + name
        span = profiling_scope(span_name)
        return span if self.timer is None else _timed_stage(span, self.timer(name))

    def _upload(self, eval_output, target, settings, skybox_slot, forward: bool = False) -> _Frame:
        """Host scene state -> device tables (static tables cached against
        the managers' versions, as the JAX build does). forward: the
        forward frame's tables, in which no registered archetype draws
        (base.py:862-873)."""
        from .pbr.material import PbrMaterial

        r = self.renderer
        dev = r.device
        om = r.object_manager
        cam = r.camera
        f = _Frame()

        if om.topology_dirty or self._tri_cache is None:
            self._tri_cache = om.build_tri_tables(r.mesh_manager)
            om.topology_dirty = False
            self._tri_dev = None
            self._cut_key = None
        opaque, blend_items = self._tri_cache
        if self._tri_dev is None:
            with profiling_scope("sync::upload.triangles"):
                tri_vlocal = torch.from_numpy(np.ascontiguousarray(opaque[:, :3])).to(dev)
            with profiling_scope("sync::upload.triangles"):
                tri_obj = torch.from_numpy(np.ascontiguousarray(opaque[:, 3])).to(dev)
            self._tri_dev = (tri_vlocal, tri_obj)
        f.tri_vlocal, f.tri_obj = self._tri_dev

        if self._obj_tbl_key != om.version:
            with profiling_scope("sync::upload.objects"):
                transforms = torch.from_numpy(np.ascontiguousarray(om.transforms)).to(dev)
            with profiling_scope("sync::upload.objects"):
                bases = torch.from_numpy(np.ascontiguousarray(om.bases)).to(dev)
            self._obj_tbl = (transforms, bases)
            self._obj_tbl_key = om.version
        f.transforms, f.bases = self._obj_tbl

        # Materials (base.py:844-908): the PBR table first, then the table of
        # each registered archetype (name order) in one global slot space
        # carried by the G-buffer material channel. Objects of an archetype
        # with no registered routine do not draw (reference
        # material.rs:43-61): they leave the frame and the shadow maps.
        mm = r.material_manager
        mm.ensure_archetype(PbrMaterial)
        arch = PbrMaterial.__name__
        host = mm.archetypes[arch]
        data, flags, textures = mm.evaluate(arch)
        f.materials = shade_ops.PbrMaterialTable(data=data, flags=flags, textures=textures)
        named_extras = []  # (name, (base, count, routine, data, flags))
        gbase = self.last_stats["pbr_slots"] = int(data.shape[0])
        for n in sorted(mm.archetypes):
            if n == arch or mm.archetypes[n].next_slot == 0 or n not in self.routines or forward:
                continue
            d, fl, _t = mm.evaluate(n)
            named_extras.append((n, (gbase, int(d.shape[0]), self.routines[n], d, fl)))
            gbase += int(d.shape[0])
        f.extras = [e for _n, e in named_extras]
        arch_bases = {n: e[0] for n, e in named_extras}
        hidden_arch = any(
            n != arch and a.next_slot > 0 and n not in arch_bases for n, a in mm.archetypes.items()
        )
        gkey = (om.version, tuple(sorted(arch_bases.items())), hidden_arch)
        if self._gslot_key != gkey:
            gslots = om.material_slots.astype(np.int32)
            obj_pbr = np.ones(om.cap, bool)
            obj_hidden = np.zeros(om.cap, bool)
            if arch_bases or hidden_arch:
                for oidx, rec in om.data.items():
                    if rec.material_arch == arch:
                        continue
                    obj_pbr[oidx] = False
                    b = arch_bases.get(rec.material_arch)
                    if b is None:
                        obj_hidden[oidx] = True
                    else:
                        gslots[oidx] += b
            with profiling_scope("sync::upload.objects"):
                self._gslot_cache = (torch.from_numpy(gslots).to(dev), obj_pbr, obj_hidden)
            self._gslot_key = gkey
        f.material_slots, obj_pbr, obj_hidden = self._gslot_cache
        live = om.enabled & ~obj_hidden
        # Texture slots any material references (base.py:976-980); slots no
        # material uses are never sampled.
        f.textures = r.d2_texture_manager.evaluate() if r.d2_texture_manager.data else None
        f.active_tex_slots = tuple(int(q) for q in np.nonzero(host.textures.any(axis=0))[0])

        # Cutout triangles: PBR objects whose material has an alpha cutoff
        # (base.py:990-1022); the mask over the triangle table is cached
        # against the topology, object and material versions. None when the
        # frame has no cutout triangle.
        # Registered cutout routines' objects ride the same peel loop.
        cut_archs = tuple(sorted(n for n, e in named_extras if e[2].transparency == "cutout"))
        f.cut_extras = [e for _n, e in named_extras if e[2].transparency == "cutout"]
        cut_key = (om.version, host.version, cut_archs)
        if self._cut_key != cut_key:
            cutout_mat = host.data[:, shade_ops.PBR_ALPHA_CUTOUT] > 0.0
            obj_cut = obj_pbr & cutout_mat[np.clip(om.material_slots, 0, len(cutout_mat) - 1)]
            for oidx, rec in om.data.items():
                if rec.material_arch in cut_archs:
                    obj_cut[oidx] = True
            cutout_tri = obj_cut[opaque[:, 3]]
            with profiling_scope("sync::upload.objects"):
                self._cut_dev = torch.from_numpy(cutout_tri).to(dev) if cutout_tri.any() else None
            self._cut_key = cut_key
        f.cutout_tri = self._cut_dev

        # Blend triangles, sorted far first by object distance every frame
        # (base.py:780-814: a stable argsort of -distance, then one
        # concatenate). The order decides equal-depth ties in the peels (the
        # later entry wins), so it is kept exactly; nothing is padded.
        f.blend_vlocal = f.blend_obj = None
        f.blend_tex_slots = ()
        if blend_items:
            oidxs = np.fromiter((oidx for _t, oidx in blend_items), np.int64, len(blend_items))
            dists = np.linalg.norm(om.world_spheres[oidxs, :3] - cam.location()[None, :], axis=1)
            order = np.argsort(-dists, kind="stable")
            blend = np.concatenate([
                np.concatenate(
                    [blend_items[i][0], np.full((len(blend_items[i][0]), 1), blend_items[i][1], dtype=np.int32)],
                    axis=1,
                )
                for i in order
            ]).astype(np.int32)
            with profiling_scope("sync::upload.blend"):
                f.blend_vlocal = torch.from_numpy(np.ascontiguousarray(blend[:, :3])).to(dev)
            with profiling_scope("sync::upload.blend"):
                f.blend_obj = torch.from_numpy(np.ascontiguousarray(blend[:, 3])).to(dev)
            if f.textures is not None:
                # Only the slots blend materials reference (base.py:984-989).
                bslots = np.unique(om.material_slots[np.unique(blend[:, 3])])
                bl_tex = host.textures[np.clip(bslots, 0, len(host.textures) - 1)]
                f.blend_tex_slots = tuple(int(q) for q in np.nonzero(bl_tex.any(axis=0))[0])

        spheres = om.world_spheres
        visible = live & cam.world_frustum.contains_spheres(spheres)
        with profiling_scope("sync::upload.visible"):
            f.visible = torch.from_numpy(visible).to(dev)
        plan = eval_output.shadow_plan
        shadow_visible = np.zeros((max(1, len(plan)), om.cap), dtype=bool)
        for k, (li, _off, _sz) in enumerate(plan):
            sc = eval_output.shadow_cameras[li]
            shadow_visible[k] = live & sc.world_frustum.contains_spheres(spheres)
        f.shadow_visible_host = shadow_visible
        with profiling_scope("sync::upload.visible"):
            f.shadow_visible = torch.from_numpy(shadow_visible).to(dev)

        def t(a, dtype=torch.float32):
            with profiling_scope("sync::upload.uniforms"):
                return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        f.view, f.proj = t(cam.view), t(cam.proj)
        f.uniforms = shade_ops.FrameUniformsArrays(
            view=f.view,
            view_proj=t(cam.view_proj()),
            origin_view_proj=t(cam.origin_view_proj()),
            inv_view=t(cam.inv_view),
            inv_origin_view_proj=t(np.linalg.inv(cam.origin_view_proj()).astype(np.float32)),
            ambient=t(settings.ambient_color),
        )
        dl = eval_output.dir_light_arrays
        f.dir_lights = shade_ops.DirLightArrays(
            **{k: t(dl[k], torch.bool if k == "mask" else torch.float32) for k in shade_ops.DirLightArrays._fields}
        )
        pl = eval_output.point_light_arrays
        f.point_lights = shade_ops.PointLightArrays(
            **{k: t(pl[k], torch.bool if k == "mask" else torch.float32) for k in shade_ops.PointLightArrays._fields}
        )
        f.clear_color = t(settings.clear_color)
        cm = r.d2c_texture_manager
        f.cube = cm.evaluate() if skybox_slot is not None and cm.data else None
        f.skybox_slot = skybox_slot
        f.geo = r.mesh_manager.evaluate()
        skm = r.skeleton_manager
        if skm.data:
            # Skinning (base.py:944-948) rewrites the override ranges before
            # any triangle corner is gathered; its work list is rebuilt per
            # skeleton change, the skinned arenas per skeleton or mesh change.
            if self._skin_key != skm.version:
                self._skin = skin_ops.build_skin_inputs(skm, r.mesh_manager, dev)
                self._skin_key = skm.version
            key = (skm.version, r.mesh_manager.version, id(f.geo))
            if self._skinned is None or self._skinned[0] != key:
                self._skinned = (key, skin_ops.apply_skinning(f.geo, self._skin))
            f.geo = self._skinned[1]
        f.front_cw = r.handedness == Handedness.LEFT
        tri_gid = transform_ops.tri_global_ids(
            f.tri_vlocal, f.tri_obj, f.bases[:, 0], f.geo.position.shape[0]
        )
        f.tri_pos = f.geo.position[tri_gid]
        return f

    def _ensure_shadow_maps(self, eval_output, f: _Frame):
        """Per-light depth maps (K2) and their PCF stack, cached across
        frames on everything that can change them (base.py:650-735): the
        shadow plan, object / mesh / skeleton versions, light matrices and
        per-light visibility. A static frame re-rasters nothing."""
        plan = eval_output.shadow_plan
        r = self.renderer
        dl_vp = np.ascontiguousarray(eval_output.dir_light_arrays["view_proj"])
        state = (
            plan,
            r.object_manager.version,
            r.mesh_manager.version,
            r.skeleton_manager.version,
            hashlib.sha1(dl_vp.tobytes()).hexdigest(),
            hashlib.sha1(np.ascontiguousarray(f.shadow_visible_host).tobytes()).hexdigest(),
            f.tri_vlocal.shape[0],
        )
        if self._shadow_cache is not None and self._shadow_cache[0] == state:
            profiling.count("shadow_cache.hit")
            return self._shadow_cache[1]
        profiling.count("shadow_cache.miss")
        inputs = (
            plan, f.front_cw, f.transforms, f.dir_lights.view_proj, f.shadow_visible, f.geo.position, f.tri_vlocal,
            f.tri_obj, f.bases[:, 0], f.tri_pos,
        )
        bundle = self._shadow_pass(*inputs)
        self._shadow_cache = (state, bundle)
        # A fully dynamic scene (a caster moving every frame) pays this pass
        # on every frame; the bench times it (base.py:728-735).
        self._last_shadow_call = (self._shadow_pass, inputs)
        return bundle

    def _shadow_pass(self, plan, front_cw, transforms, light_vp, shadow_visible, position, tri_vlocal, tri_obj,
                     base0, tri_pos):
        """Every map of the shadow plan (K2) and their PCF stack, from these
        inputs alone: (maps, stack_shadow_maps(maps)). Reads no cache."""
        eye = torch.eye(4, dtype=torch.float32, device=transforms.device)
        smaps = []
        for k, (_li, _off, size) in enumerate(plan):
            _, smvp = transform_ops.object_uniforms(transforms, light_vp[k], eye)
            svalid = shadow_visible[k][tri_obj.long()]
            sclip = transform_ops.gather_tri_clip(position, tri_vlocal, tri_obj, base0, smvp, tri_pos=tri_pos,
                                                  contract=True)
            sclipped = transform_ops.clip_triangles(sclip, svalid, contract=True)
            swp = _round_up(size, def_ops.DTILE_W)
            shp = _round_up(size, def_ops.DTILE_H)
            stris = geom_ops.cull_and_setup(
                sclipped.clip, sclipped.valid, size, size,
                cull_mode=geom_ops.CullMode.FRONT, front_is_cw=front_cw,
                subpixel=True,  # sub-texel casters can't mark any texel center
                contract=True,
            )
            sbinned = geom_ops.bin_triangles(
                stris, swp, shp, tile_h=def_ops.DTILE_H, tile_w=def_ops.DTILE_W
            )
            if self.captured is not None and k == 0:
                self.captured["raster_depth"] = (stris, sbinned, swp, shp)
            smaps.append(def_ops.raster_depth(stris, sbinned, swp, shp)[:size, :size])
            self.last_stats[f"shadow_survivors_{k}"] = stris.count
        return smaps, shadow_ops.stack_shadow_maps(smaps)

    def _clip(self, f: _Frame) -> transform_ops.ClippedTris:
        f.mv, f.mvp = transform_ops.object_uniforms(f.transforms, f.view, f.proj)
        valid = f.visible[f.tri_obj.long()]
        clip = transform_ops.gather_tri_clip(
            f.geo.position, f.tri_vlocal, f.tri_obj, f.bases[:, 0], f.mvp, tri_pos=f.tri_pos, contract=True
        )
        return transform_ops.clip_triangles(clip, valid, contract=True)

    def _cull(self, f: _Frame, stage, table, valid, name: str, hiz=None) -> geom_ops.TriSetup:
        with stage(name):
            return geom_ops.cull_and_setup(
                table.clip, valid, f.width, f.height,
                cull_mode=geom_ops.CullMode.BACK, front_is_cw=f.front_cw, subpixel=f.subpixel, hiz=hiz,
                contract=True, y_range=f.y_range,
            )

    def _planes_bin(self, f: _Frame, stage, tris, table, tri_vlocal, tri_obj, names):
        """Attribute planes and CSR tile lists of a survivor table, timed
        under names[0] and names[1]."""
        with stage(names[0]):
            planes = def_ops.attribute_planes(
                tris, table.clip, table.bary, table.orig, tri_vlocal, tri_obj,
                f.bases, f.geo, f.mv, f.material_slots, f.width, f.height, contract=True,
            )
        with stage(names[1]):
            binned = geom_ops.bin_triangles(
                tris, f.wp, f.hp, tile_h=def_ops.DTILE_H, tile_w=def_ops.DTILE_W, y0=f.row0
            )
        return planes, binned

    def _capture(self, key: str, value) -> None:
        """Keeps the first of this frame's inputs under `key`."""
        if self.captured is not None and key not in self.captured:
            self.captured[key] = value

    def _cutout_peels(self, f: _Frame, stage, cmask, pyramid, gbufs):
        """Cutout (alpha-tested) depth peels over each sample's opaque
        G-buffer (base.py:1480-1557): raster the cutout set front to back,
        alpha-test each peel's candidate pixels, and take the first passing
        fragment in front of the opaque result. The cutout geometry (one
        Hi-Z-tested cull, planes, binning) is shared by the samples; the peel
        loop runs per sample, at its offset. Replaces the entries of `gbufs`
        (one (GB_CH, H, W) G-buffer per sample) and returns it.

        The cutout set is Hi-Z-tested against the opaque phase-1 depth when
        occlusion culling is on. Peel 0 also counts, per pixel, the cutout
        fragments strictly in front of the opaque result; the largest count
        bounds the peels a sample needs (no pixel needs more), so the loop
        has no cap, unlike the JAX build's 8 (base.py:492-498): past it the
        port keeps the wgpu discard semantics at any depth. Each sample's
        loop is sized by its own count (JAX sizes every sample by the
        largest, which gives the same images below its cap). The loop also
        stops once no pixel is still searching behind a failed fragment.

        Host reads: cull and binning one each, and per sample the count's
        maximum plus, per peel, the `nonzero` of its candidate pixels and,
        when there are any, the count of those that failed the test."""
        tris = self._cull(f, stage, f.clipped, f.clipped.valid & cmask, "cut_setup", hiz=pyramid)
        st = self.last_stats
        st["cut_survivors"] = tris.count
        if tris.count == 0:
            return gbufs
        planes, binned = self._planes_bin(f, stage, tris, f.clipped, f.tri_vlocal, f.tri_obj, ("cut_planes", "cut_bin"))
        for si, sofs in enumerate(f.offsets):
            gbufs[si], peels, layers = self._cutout_sample(f, stage, tris, planes, binned, sofs, gbufs[si])
            st["cut_peels"] = max(st["cut_peels"], peels)
            st["cut_layers"] = max(st["cut_layers"], layers)
        return gbufs

    def _cutout_sample(self, f: _Frame, stage, tris, planes, binned, sofs, gbuf):
        """One sample's cutout peel loop; returns (gbuf, peels, layers)."""
        wp, hp = f.wp, f.hp
        odepth = gbuf[def_ops.G_DEPTH]
        ohit = gbuf[def_ops.G_HIT] > 0.0
        done = torch.zeros_like(ohit)
        bound = None
        peels = layers = 0
        while True:
            with stage("cut_raster"):
                if peels == 0:
                    # Strict, matching `nearer` below.
                    floor = torch.where(ohit, odepth, torch.full_like(odepth, -1.0))
                    self._capture("raster_count", (tris, planes, binned, wp, hp, floor, True))
                    g, counts = def_ops.raster_resolve(
                        tris, planes, binned, wp, hp, sofs=sofs, count_floor=floor, count_strict=True, y0=f.row0
                    )
                    with profiling_scope("sync::cut.layers"):
                        layers = int(torch.round(counts.max()))
                else:
                    self._capture("raster_bound", (tris, planes, binned, wp, hp, bound))
                    g = def_ops.raster_resolve(tris, planes, binned, wp, hp, sofs=sofs, bound=bound, y0=f.row0)
                gc = g.data
            peels += 1
            with stage("cut_alpha"):
                chit = gc[def_ops.G_HIT] > 0.0
                cdepth = gc[def_ops.G_DEPTH]
                nearer = ~ohit | (cdepth > odepth)
                # The alpha test decides only where a pixel still searches
                # and the fragment is nearer than the opaque one.
                with profiling_scope("sync::cut.pixels"):
                    pix = torch.nonzero((~done & chit & nearer).flatten()).flatten()
                passed = torch.zeros(hp * wp, dtype=torch.bool, device=gc.device)
                searching = 0
                if pix.numel():
                    cap = {} if self.captured is not None else None
                    ok = light_ops.cutout_alpha_pass(
                        def_ops.GBuffer(gc.reshape(def_ops.GB_CH, -1)[:, pix][:, None]),
                        f.materials, f.textures, f.active_tex_slots, extras=f.cut_extras, capture=cap,
                    ).flatten()
                    if cap:
                        self._capture("bilinear_cutout", cap["bilinear"])
                    passed[pix] = ok
                    with profiling_scope("sync::cut.searching"):
                        searching = pix.numel() - int(ok.sum())
                passed = passed.reshape(hp, wp)
                # replace = ~done & chit & pass & nearer, which is `passed`.
                gbuf = torch.where(passed[None], gc, gbuf)
                done = done | ~chit | passed | (chit & ~nearer)
                bound = torch.where(done, torch.zeros_like(cdepth), cdepth)
            if searching == 0 or peels >= layers:
                break
        return gbuf, peels, layers

    def _blend_peels(self, f: _Frame, stage, gbufs):
        """Blend geometry and depth-peel rasters (base.py:1730-1792): the
        blend triangles (far-first object order, from _upload) are culled
        without Hi-Z once for every sample, and peeled front to back over
        each sample's final opaque depth at its offset. Peel 0 counts every
        blend fragment at or in front of the opaque result; the largest
        count is the number of peels the sample needs (no cap, unlike the
        JAX build's 16), and a peel with no hit pixel ends the loop early
        (every later one would be empty). Returns, per sample, a list with,
        per peel, the hit pixels' flat ids and their (GB_CH, n) G-buffer
        columns (compacted per (sample, peel), base.py:1803-1830).

        Host reads: clip, cull and binning one each, and per sample the
        count's maximum and per peel the `nonzero` of its hit pixels."""
        with stage("blend_geom"):
            bclip = transform_ops.gather_tri_clip(
                f.geo.position, f.blend_vlocal, f.blend_obj, f.bases[:, 0], f.mvp, contract=True
            )
            table = transform_ops.clip_triangles(bclip, f.visible[f.blend_obj.long()], contract=True)
            # Timed as a whole under "blend_geom".
            tris = self._cull(f, _within, table, table.valid, "blend_geom")
            planes, binned = self._planes_bin(
                f, _within, tris, table, f.blend_vlocal, f.blend_obj, ("blend_geom",) * 2
            )
        st = self.last_stats
        st["blend_survivors"] = tris.count
        if tris.count == 0:
            return [[] for _ in f.offsets]
        out = []
        for sofs, gbuf in zip(f.offsets, gbufs):
            peels, n = self._blend_sample(f, stage, tris, planes, binned, sofs, gbuf)
            st["blend_peels"] = max(st["blend_peels"], n)
            st["blend_px"] += sum(int(p.numel()) for p, _g in peels)
            out.append(peels)
        return out

    def _blend_sample(self, f: _Frame, stage, tris, planes, binned, sofs, gbuf):
        """One sample's blend peel loop; returns (peels, peel count)."""
        wp, hp = f.wp, f.hp
        odepth = gbuf[def_ops.G_DEPTH]
        ohit = gbuf[def_ops.G_HIT] > 0.0
        bound = None
        peels = []
        need = n = 0
        while True:
            with stage("blend_raster"):
                if n == 0:
                    floor = torch.where(ohit, odepth, torch.full_like(odepth, -1.0))
                    g, counts = def_ops.raster_resolve(
                        tris, planes, binned, wp, hp, sofs=sofs, count_floor=floor, y0=f.row0
                    )
                    with profiling_scope("sync::blend.layers"):
                        need = int(torch.round(counts.max()))
                else:
                    self._capture("raster_bound", (tris, planes, binned, wp, hp, bound))
                    g = def_ops.raster_resolve(tris, planes, binned, wp, hp, sofs=sofs, bound=bound, y0=f.row0)
                g = g.data
                n += 1
                bdepth = g[def_ops.G_DEPTH]
                bhit = (g[def_ops.G_HIT] > 0.0) & (~ohit | (bdepth >= odepth))
                with profiling_scope("sync::blend.pixels"):
                    pix = torch.nonzero(bhit.flatten()).flatten()
                if pix.numel():
                    peels.append((pix, g.reshape(def_ops.GB_CH, -1)[:, pix]))
                    bound = torch.where(bhit, bdepth, torch.zeros_like(bdepth))
            if not pix.numel() or n >= need:
                break
        return peels, n

    def _shadow_coords(self, gbuf: torch.Tensor, f: _Frame, plan):
        """Per plan entry (map index, sx, sy, ref, hit, in_bounds) at the
        fragments of a (CH, H, W) G-buffer (the padded frame, or compacted
        pixels as (CH, 1, N)): world reconstruct -> light NDC, with the
        reference's atlas-space bounds expressions including the any()
        quirk (opaque.wgsl:509-514, base.py:1642-1680). Both matrix
        products take the form XLA:CPU gives the JAX frame's:
        fma(m2, v2, fma(m0, v0, m1*v1)), then the translation added."""

        def mat_img(m, rows, img):  # (rows, 3) of m x three image channels, all rows at once
            col = [m[:rows, k].reshape(rows, *([1] * (img.dim() - 1))) for k in range(3)]
            return fp_ops.fma32(col[2], img[2:3], fp_ops.fma32(col[0], img[0:1], col[1] * img[1:2]))

        den = gbuf[def_ops.G_DEN]
        invden = torch.where(den.abs() < 1e-30, torch.ones_like(den), 1.0 / den)
        vp_img = gbuf[def_ops.G_VP : def_ops.G_VP + 3] * invden[None]
        hitp = gbuf[def_ops.G_HIT] > 0.0
        iv = f.uniforms.inv_view
        world = mat_img(iv[:3, :3], 3, vp_img) + iv[:3, 3][:, None, None]
        dl = f.dir_lights
        out = []
        for k, (_li, _off, size) in enumerate(plan):
            vp = dl.view_proj[k]
            ndc = mat_img(vp, 4, world) + vp[:, 3][:, None, None]
            ndcw = torch.where(ndc[3] == 0.0, torch.ones_like(ndc[3]), ndc[3])
            ndc_xyz = ndc[:3] / ndcw[None]
            sx = (ndc_xyz[0] * 0.5 + 0.5) * size
            sy = (0.5 - ndc_xyz[1] * 0.5) * size
            ref = ndc_xyz[2]
            flipped_x = ndc_xyz[0] * 0.5 + 0.5
            flipped_y = ndc_xyz[1] * 0.5 + 0.5
            border = dl.inv_resolution[k] * 1.5
            tl_b = dl.atlas_offset[k] + border
            tr_b = dl.atlas_offset[k] + dl.atlas_size[k] - border
            in_bounds = (
                ((flipped_x >= tl_b[0]) | (flipped_y >= tl_b[1]))
                & ((flipped_x <= tr_b[0]) | (flipped_y <= tr_b[1]))
                & (ref >= 0.0)
                & (ref <= 1.0)
            )
            out.append((k, sx, sy, ref, hitp, in_bounds))
        return out

    def _shadow_values(self, coord_sets, smaps, stacked, L: int):
        """(L, H, W) shadow factors for each G-buffer of `coord_sets` (one
        _shadow_coords list each, any shape) through one K3 launch; 1.0
        outside the light's bounds and for light slots without a map."""
        entries = [(k, sx, sy, ref, hitp) for coords in coord_sets for (k, sx, sy, ref, hitp, _ib) in coords]
        pcfs = iter(shadow_ops.resolve_shadow_pcf5(smaps, entries, stacked=stacked, capture=self.captured))
        out = []
        for coords in coord_sets:
            svals = []
            for *_c, ib in coords:
                p = next(pcfs)
                svals.append(torch.where(ib, p, torch.ones_like(p)))
            while len(svals) < L:
                svals.append(torch.ones_like(svals[0]))
            out.append(torch.stack(svals))
        return out

    # -- the frame ---------------------------------------------------------------

    def render_frame(
        self,
        eval_output: InstructionEvaluationOutput,
        target: FrameRenderTarget,
        settings: BaseRenderGraphSettings = BaseRenderGraphSettings(),
        skybox_slot: Optional[int] = None,
    ) -> np.ndarray:
        """Renders and returns an (H, W, 4) u8 sRGB image."""
        return self.render_frame_tensor(eval_output, target, settings, skybox_slot).cpu().numpy()

    def render_frame_tensor(
        self,
        eval_output: InstructionEvaluationOutput,
        target: FrameRenderTarget,
        settings: BaseRenderGraphSettings = BaseRenderGraphSettings(),
        skybox_slot: Optional[int] = None,
    ) -> torch.Tensor:
        """render_frame without the copy to the host: (H, W, 4) u8 on the
        renderer's device. build_frame_callable plus one call of its
        program, as JAX's render_frame is (rend3_tpu/routine/base.py:247-262);
        a device out-of-memory in any stage reaches the caller as
        DeviceOutOfMemoryError, its cause chained."""
        with profiling_scope(profiling.ROOT):
            program, args = self.build_frame_callable(eval_output, target, settings, skybox_slot)
            return program(*args)[0]

    def build_frame_callable(
        self,
        eval_output: InstructionEvaluationOutput,
        target: FrameRenderTarget,
        settings: BaseRenderGraphSettings = BaseRenderGraphSettings(),
        skybox_slot: Optional[int] = None,
    ):
        """(program, args) of this frame (rend3_tpu/routine/base.py:737-749).
        The host's share, the `upload` stage (scene state into device
        tables), runs once here; program(*args) runs every later stage, from
        the shadow maps through the passes, and returns (image,
        predicted_mask, stats): the (H, W, 4) u8 image on the renderer's
        device, the carried predicted-visible mask over the triangle table
        (graph state, as in JAX; it is what the next frame predicts) and a
        copy of last_stats. program leaves args as they were, so a second
        call renders the same frame again (on a static scene the same image,
        bit for bit) without uploading anything. A device out-of-memory in
        either reaches the caller as DeviceOutOfMemoryError, its cause
        chained, as JAX's render_frame maps RESOURCE_EXHAUSTED
        (rend3_tpu/routine/base.py:252-259)."""
        with _device_oom(), profiling_scope("BaseRenderGraph::build_frame_callable"):
            raster_ops.sample_offsets(target.samples)  # raises unless 1 or 4
            forward = default_raster_backend() == "reference"
            with self.stage("upload"):
                frame = self._upload(eval_output, target, settings, skybox_slot, forward=forward)
            frame.target, frame.forward = target, forward

        def program(eval_output, frame):
            with _device_oom():
                image = drive_frame(self._render_frame_stages(eval_output, frame), lambda rows: rows)
            return image, self._prev_visible_mask, dict(self.last_stats)

        return program, (eval_output, frame)

    def _render_frame_stages(self, eval_output, frame: _Frame, band=None):
        """The stages after the upload of a frame that build_frame_callable
        uploaded, as a generator that returns the u8 image. With occlusion
        culling on it yields once, the (band_h, W) phase-1 occluder depth
        rows, and must be sent the target's (H, W) occluder depth
        (drive_frame). band: None for the whole target, or (row0, band_h)
        for the rows [row0, row0 + band_h) of the JAX band frame
        (base.py:1120-1203), whose image is (band_h, W, 4); the deferred
        frame only (base.py:1143-1145). The stages keep their tables on a
        copy of `frame`, which stays as it was."""
        f = copy.copy(frame)
        target = f.target
        if f.forward:
            if band is not None:
                raise ValueError(
                    "row bands need the deferred frame; REND3_TPU_RASTER=reference renders whole frames only"
                )
            return self._render_forward(eval_output, f)
        stage = self.stage
        width, height = target.width, target.height
        row0, bh = (0, height) if band is None else band
        plan = eval_output.shadow_plan
        if self.captured is not None:
            for key in ("raster_count", "raster_bound", "bilinear_cutout", "bilinear_sky"):
                self.captured.pop(key, None)
        st = self.last_stats
        for key in ("cut_survivors", "cut_peels", "cut_layers", "blend_survivors", "blend_peels", "blend_px"):
            st[key] = 0
        if plan:
            with stage("shadow_maps"):
                smaps, stacked = self._ensure_shadow_maps(eval_output, f)
        with stage("clip"):
            clipped = self._clip(f)
        f.clipped = clipped
        # Setup, planes and pixel positions stay in target coordinates; the
        # band's rows start at target row row0 (0 for the whole target), its
        # padded G-buffers hold hp rows, and rows past bh are dropped.
        f.width, f.height = width, height
        f.row0, f.bh = row0, bh
        f.y_range = None if band is None else (row0, row0 + bh)
        f.wp = wp = _round_up(width, def_ops.DTILE_W)
        f.hp = hp = _round_up(bh, def_ops.DTILE_H)
        f.offsets = offsets = raster_ops.sample_offsets(target.samples)
        f.subpixel = len(offsets) == 1
        S = st["samples"] = len(offsets)
        # Cutout triangles go through the peel loop; the opaque passes, the
        # Hi-Z pyramid and the carried mask see only the rest (base.py:1312-1316).
        cmask = None if f.cutout_tri is None else f.cutout_tri[clipped.orig.long()]
        opaque_valid = clipped.valid if cmask is None else clipped.valid & ~cmask
        if self.captured is not None:
            self.captured["opaque_table"] = (clipped.clip, opaque_valid, f.front_cw, width, height)

        def raster_at(tris, planes, binned, sofs, name):
            """The G-buffer (K1) of shared geometry at one sample offset."""
            with stage(name):
                return def_ops.raster_resolve(tris, planes, binned, wp, hp, sofs=sofs, y0=row0).data

        T = f.tri_vlocal.shape[0]
        pm = None
        if self.occlusion_culling:
            # Two-phase Hi-Z occlusion culling (base.py:1376-1472, reference
            # base.rs:155-172, cull.wgsl:243-324), deferred-style: phase 1
            # renders the carried predicted set for real. It runs under MSAA
            # too, as in JAX (base.py:1384-1387).
            pm_tri = self._prev_visible_mask
            if pm_tri is None or pm_tri.shape[0] != T:
                # First frame, or the triangle table changed size: predict all.
                pm_tri = torch.ones(T, dtype=torch.bool, device=clipped.valid.device)
            pm = pm_tri[clipped.orig.long()]
        tris = self._cull(f, stage, clipped, opaque_valid if pm is None else opaque_valid & pm, "setup")
        planes, binned = self._planes_bin(f, stage, tris, clipped, f.tri_vlocal, f.tri_obj, ("planes", "bin"))
        if self.captured is not None and band is not None:
            # Each band's phase-1 inputs, by its first row.
            self.captured.setdefault("raster_band", {})[row0] = (tris, planes, binned, wp, hp, row0)
        elif self.captured is not None:
            self.captured["raster_resolve"] = (tris, planes, binned, wp, hp)
            if S > 1:
                self.captured["raster_sample"] = (tris, planes, binned, wp, hp, offsets[1])
        gbufs = [raster_at(tris, planes, binned, sofs, "gbuffer") for sofs in offsets]
        st["main_survivors"] = tris.count
        st["main_pairs"] = int(binned.ids.shape[0])
        pyramid = None
        if pm is not None:
            # Phase 1's depth is the occluder pyramid; every opaque row is
            # tested against it. The passers are the next frame's predicted
            # set; those not predicted (the residual set) are rendered and
            # merged on top by depth. Under MSAA the occluder depth is the
            # reverse-Z min over the samples (the farthest, so conservative;
            # base.py:1427-1437).
            with stage("hiz"):
                depth = gbufs[0][def_ops.G_DEPTH]
                for g in gbufs[1:]:
                    depth = torch.minimum(depth, g[def_ops.G_DEPTH])
            # The band's rows go out, the target's occluder depth comes back
            # (every band's rows, gathered in order: base.py:1430-1435), so
            # every band builds the same pyramid and tests visibility at
            # target coordinates, and the carried mask is the same in all.
            depth = yield depth[:bh, :width]
            with stage("hiz"):
                pyramid = hiz_ops.build_pyramid(depth)
                vis = geom_ops.visibility_mask(
                    clipped.clip, opaque_valid, width, height,
                    cull_mode=geom_ops.CullMode.BACK, front_is_cw=f.front_cw, subpixel=f.subpixel,
                    hiz=pyramid, capture=self.captured,
                )
                new_mask = torch.zeros(T, dtype=torch.bool, device=vis.device)
                with profiling_scope("sync::hiz.visible"):
                    new_mask[clipped.orig.long()[vis]] = True
            tris_r = self._cull(f, stage, clipped, vis & ~pm, "resid")
            st["resid_survivors"] = tris_r.count
            if tris_r.count:
                planes_r, binned_r = self._planes_bin(
                    f, stage, tris_r, clipped, f.tri_vlocal, f.tri_obj, ("resid", "resid")
                )
                for si, sofs in enumerate(offsets):
                    gbuf_r = raster_at(tris_r, planes_r, binned_r, sofs, "resid")
                    with stage("resid"):
                        # Merge on the hit flags, not bare depth (reverse-Z
                        # depth 0 is a valid farthest fragment); the residual
                        # wins ties.
                        g = gbufs[si]
                        take_r = (gbuf_r[def_ops.G_HIT] > 0.0) & (
                            (g[def_ops.G_HIT] <= 0.0) | (gbuf_r[def_ops.G_DEPTH] >= g[def_ops.G_DEPTH])
                        )
                        gbufs[si] = torch.where(take_r[None], gbuf_r, g)
            self._prev_visible_mask = new_mask
        if cmask is not None:
            gbufs = self._cutout_peels(f, stage, cmask, pyramid, gbufs)
        f.plan = plan
        if f.cube is not None:
            with stage("skybox"):
                backgrounds = self._skybox(f, gbufs)
        else:
            backgrounds = [f.clear_color.expand(bh, width, 4)] * S
        peels_s = self._blend_peels(f, stage, gbufs) if f.blend_obj is not None else [[] for _ in offsets]
        # Each sample's blend peels' hit pixels, compacted into one
        # (CH, 1, N) G-buffer that shares the opaque pixels' K3 launch and
        # is lit in one pass.
        bgbufs = [torch.cat([g for _pix, g in peels], dim=1)[:, None] if peels else None for peels in peels_s]
        L = f.dir_lights.mask.shape[0]
        dev = gbufs[0].device
        if plan:
            with stage("shadow_coords"):
                coord_sets = [self._shadow_coords(g, f, plan) for g in gbufs]
                coord_sets += [self._shadow_coords(b, f, plan) for b in bgbufs if b is not None]
            with stage("pcf"):
                svals = self._shadow_values(coord_sets, smaps, stacked, L)
            if self.captured is not None:
                # Light 0 at sample 0's opaque pixels (rend3_tpu_torch.probe_shadow).
                self.captured["shadow_light0"] = (coord_sets[0][0], svals[0][0], plan[0][2])
                self.captured["shadow_coords"] = coord_sets[0]  # every light, sample 0's opaque pixels
            shadow_s = [sv[:, :bh, :width] for sv in svals[:S]]
            rest = iter(svals[S:])
            blend_sv = [None if b is None else next(rest) for b in bgbufs]
        else:
            shadow_s = [torch.ones(L, bh, width, dtype=torch.float32, device=dev)] * S
            blend_sv = [None if b is None else torch.ones(L, *b.shape[1:], device=dev) for b in bgbufs]
        # Lighting (timed as "textures" and "lighting") on each sample's
        # cropped G-buffer: the padding pixels are never hit, so lighting
        # them (as the JAX package's texture path does) changes nothing.
        imgs = []
        for si in range(S):
            gbuf = def_ops.GBuffer(gbufs[si][:, :bh, :width])
            img = light_ops.light_gbuffer(
                gbuf, f.materials, f.dir_lights, f.point_lights, f.uniforms, backgrounds[si], shadow_s[si],
                textures=f.textures, active_tex_slots=f.active_tex_slots,
                stage=stage, capture=self.captured,
            )
            if f.extras:
                with stage("routines"):
                    img = light_ops.apply_material_routines(
                        img, gbuf, f.extras, f.dir_lights, f.point_lights, shadow_s[si] if plan else None,
                        f.uniforms,
                    )
            if si > 0 or not self.injected_passes:
                gbufs[si] = None  # the sample's G-buffer is no longer needed (passes get sample 0's)
            if peels_s[si]:
                with stage("blend_shade"):
                    img = self._blend_composite(f, peels_s[si], bgbufs[si], blend_sv[si], img)
            imgs.append(img)
        with stage("blit"):
            # f16 round trip per sample, then the resolve (base.py:2053-2054).
            img = blit_ops.resolve_samples(blit_ops.f16_roundtrip(torch.stack(imgs)))
        img = self._run_passes(stage, img, "hdr", gbufs[0], f.uniforms, row0)
        with stage("blit"):
            out = blit_ops.hdr_to_srgb_u8(img)
        return self._run_passes(stage, out, "srgb", gbufs[0], f.uniforms, row0)

    def _run_passes(self, stage, img, want_stage: str, gbuf0, uniforms, row0: int = 0):
        """The registered passes of one stage, in order (base.py:2061-2080);
        gbuf0 is sample 0's padded G-buffer (None in the forward frame,
        whose passes get no G-buffer), row0 the target row of img's row 0."""
        for fn, pstage in self.injected_passes:
            if pstage != want_stage:
                continue
            try:
                wants_row0 = len(inspect.signature(fn).parameters) >= 4
            except (TypeError, ValueError):
                wants_row0 = False
            with stage("passes"):
                gbuf = None if gbuf0 is None else def_ops.GBuffer(gbuf0)
                img = fn(img, gbuf, uniforms, *((row0,) if wants_row0 else ()))
        return img

    # -- the forward frame (REND3_TPU_RASTER=reference) ---------------------

    def _shadow_atlas(self, eval_output, f: _Frame) -> torch.Tensor:
        """The (ah, aw) shadow atlas, every plan entry's map rasterized by
        raster.rasterize into its rect, every frame (base.py:1249-1269);
        texels no caster covers hold 0.0."""
        aw, ah = eval_output.shadow_atlas_extent
        atlas = torch.zeros(ah, aw, dtype=torch.float32, device=f.view.device)
        eye = torch.eye(4, dtype=torch.float32, device=f.view.device)
        for k, (_li, (ox, oy), size) in enumerate(eval_output.shadow_plan):
            _, smvp = transform_ops.object_uniforms(f.transforms, f.dir_lights.view_proj[k], eye)
            sclip = transform_ops.gather_tri_clip(
                f.geo.position, f.tri_vlocal, f.tri_obj, f.bases[:, 0], smvp, tri_pos=f.tri_pos, contract=True
            )
            sclipped = transform_ops.clip_triangles(sclip, f.shadow_visible[k][f.tri_obj.long()], contract=True)
            svis = raster_ops.rasterize(
                sclipped.clip, sclipped.valid, size, size, cull_mode=raster_ops.CullMode.FRONT,
                front_is_cw=f.front_cw, sample_offsets=raster_ops.CENTER_OFFSET,
            )
            atlas[oy : oy + size, ox : ox + size] = svis.depth[0]
        return atlas

    def _render_forward(self, eval_output, f: _Frame):
        """The JAX package's forward frame (base.py:1249-2080 with
        use_deferred off) after its upload: shadow atlas, main raster
        (raster.rasterize), skybox background, shade.shade_deferred, the
        ordered blend pass, f16 round trip, resolve, passes and blit."""
        stage = self.stage
        width, height = f.target.width, f.target.height
        offsets = raster_ops.sample_offsets(f.target.samples)
        st = self.last_stats
        st["samples"] = len(offsets)
        with stage("shadow_maps"):
            atlas = self._shadow_atlas(eval_output, f)
        with stage("clip"):
            clipped = self._clip(f)
        S = len(offsets)
        if f.cube is not None:
            with stage("skybox"):
                background = _skybox_background(f.cube, f.skybox_slot + 1, f.uniforms, width, height, offsets)
        else:
            background = f.clear_color.expand(S, height, width, 4)
        with stage("raster"):
            vis = raster_ops.rasterize(
                clipped.clip, clipped.valid, width, height, cull_mode=raster_ops.CullMode.BACK,
                front_is_cw=f.front_cw, sample_offsets=offsets,
            )
        with profiling_scope("sync::forward.pixels"):
            st["forward_px"] = int((vis.tri >= 0).sum())
        if self.captured is not None:
            self.captured["forward"] = (vis, atlas, eval_output.shadow_plan)
        with stage("shade"):
            img = shade_ops.shade_deferred(
                vis, clipped, f.tri_vlocal, f.tri_obj, f.geo, f.bases, f.mv, f.material_slots, f.materials,
                f.dir_lights, f.point_lights, atlas, f.uniforms, width, height, offsets,
                textures=f.textures, background=background,
            )
        if f.blend_obj is not None:
            with stage("blend_shade"):
                img, st["blend_px"] = _blend_pass(img, vis, f, atlas, width, height, offsets)
        with stage("blit"):
            img = blit_ops.resolve_samples(blit_ops.f16_roundtrip(img))
        img = self._run_passes(stage, img, "hdr", None, f.uniforms)
        with stage("blit"):
            out = blit_ops.hdr_to_srgb_u8(img)
        return self._run_passes(stage, out, "srgb", None, f.uniforms)

    def _skybox(self, f: _Frame, gbufs):
        """Per sample, the (H, W, 4) background: the skybox where no
        fragment hit, with alpha 1, and the clear colour elsewhere
        (base.py:1562-1613). Every sample's sky pixels go through one K4
        launch."""
        hp, wp, dev = f.hp, f.wp, gbufs[0].device
        inv = f.uniforms.inv_origin_view_proj
        in_frame = (
            (torch.arange(hp, device=dev)[:, None] < f.bh) & (torch.arange(wp, device=dev)[None, :] < f.width)
        ).reshape(-1)
        dirs_list = [sky_directions(inv, f.width, f.height, hp, wp, sofs, f.row0) for sofs in f.offsets]
        need_list = [~(g[def_ops.G_HIT] > 0.0).reshape(-1) & in_frame for g in gbufs]
        cap = {} if self.captured is not None else None
        k4_before = samplers_ops.launches["bilinear"]
        sky = tex_ops.sample_cube_grid(f.cube, f.skybox_slot + 1, dirs_list, need_list, capture=cap)
        # K4 launches of the skybox (0 on the CPU, where K4's plain version runs).
        self.last_stats["sky_k4_launches"] = samplers_ops.launches["bilinear"] - k4_before
        if cap:
            self._capture("bilinear_sky", cap["bilinear"])
        out = []
        for si in range(len(f.offsets)):
            rgba = torch.cat([sky[si][:, :3], torch.ones_like(sky[si][:, 3:4])], dim=1)
            bg = torch.where(need_list[si][:, None], rgba, f.clear_color[None, :])
            out.append(bg.reshape(hp, wp, 4)[: f.bh, : f.width])
        return out

    def _blend_composite(self, f: _Frame, peels, bgbuf, blend_sv, img):
        """Light the compacted blend pixels (blend materials' texture slots,
        zero background), scatter each peel back, under-composite the peels
        front to back and the result over the opaque image
        (base.py:1931-2002)."""
        n_all = bgbuf.shape[2]
        rgba = light_ops.light_gbuffer(
            def_ops.GBuffer(bgbuf), f.materials, f.dir_lights, f.point_lights, f.uniforms,
            torch.zeros(1, n_all, 4, device=bgbuf.device), blend_sv,
            textures=f.textures, active_tex_slots=f.blend_tex_slots,
        )
        if f.extras:
            # Registered routines shade their peel pixels (alpha = rgba[:, 3]).
            rgba = light_ops.apply_material_routines(
                rgba, def_ops.GBuffer(bgbuf), f.extras, f.dir_lights, f.point_lights,
                blend_sv if f.plan else None, f.uniforms,
            )
        rgba = rgba.reshape(n_all, 4)
        npx = f.hp * f.wp
        C = torch.zeros(npx, 3, device=bgbuf.device)
        A = torch.zeros(npx, device=bgbuf.device)
        off = 0
        for pix, _g in peels:
            full = torch.zeros(npx, 4, device=bgbuf.device)
            full[pix] = rgba[off : off + pix.numel()]
            off += pix.numel()
            a = full[:, 3]   # alpha x the peel's hit flag (0 off its pixels)
            C = C + ((1.0 - A) * a)[:, None] * full[:, :3]
            A = A + (1.0 - A) * a
        C = C.reshape(f.hp, f.wp, 3)[: f.bh, : f.width]
        A = A.reshape(f.hp, f.wp)[: f.bh, : f.width]
        return torch.cat([C + (1.0 - A)[..., None] * img[..., :3], (A + (1.0 - A) * img[..., 3])[..., None]], dim=-1)


def _skybox_background(cube, slot: int, uniforms, width: int, height: int, offsets) -> torch.Tensor:
    """(S, H, W, 4) skybox colour with alpha 1 at every pixel of every
    sample (base.py:2116-2144), sampled per pixel by texture.sample_cube;
    slot is the 1-based cube slot."""
    outs = []
    for sofs in offsets:
        dirs = sky_directions(uniforms.inv_origin_view_proj, width, height, height, width, sofs)
        rgba = tex_ops.sample_cube(cube, slot, dirs)
        rgba = torch.cat([rgba[:, :3], torch.ones_like(rgba[:, 3:4])], dim=1)
        outs.append(rgba.reshape(height, width, 4))
    return torch.stack(outs)


def _blend_pass(img, vis, f: _Frame, atlas, width: int, height: int, offsets):
    """The alpha-blended triangles drawn over the shaded (S, H, W, 4) image
    one by one in their far-first order (base.py:2147-2228): each is
    rasterized against the running depth (blend writes depth), shaded at
    the pixels it covers and composited src-alpha over. Returns (image,
    covered sample count). Each triangle's edges are evaluated only over
    its pixel window (its bounding box grown by one pixel), and it is
    shaded only where it covers: per pixel the same values the JAX pass
    computes over the whole image."""
    dev = img.device
    valid = f.visible[f.blend_obj.long()]
    clip = transform_ops.gather_tri_clip(
        f.geo.position, f.blend_vlocal, f.blend_obj, f.bases[:, 0], f.mvp, contract=True
    )
    clipped = transform_ops.clip_triangles(clip, valid, contract=True)
    # The clip expansion back in source-triangle order: the scan keeps the
    # far-first order.
    order = torch.sort(clipped.orig, stable=True).indices
    cclip, cbary, corig, cvalid = clipped.clip[order], clipped.bary[order], clipped.orig[order], clipped.valid[order]
    xs, ys, zs, ws, keep, _ = raster_ops.prepare_tris(
        cclip, cvalid, width, height, raster_ops.CullMode.BACK, f.front_cw
    )
    img = img.clone()
    depth = vis.depth.clone()
    S = len(offsets)
    # Host reads: the blend triangles to draw and their pixel windows.
    with profiling_scope("sync::forward.blend_kept"):
        kept = torch.nonzero(keep).flatten()
    with profiling_scope("sync::forward.blend_windows"):
        wins = raster_ops.pixel_windows(xs[kept], ys[kept], width, height).tolist()
    with profiling_scope("sync::forward.blend_kept"):
        kept_ids = kept.tolist()
    n_px = 0

    def c4(v):
        return v[:, None, None, None]

    for t, (x0, y0, x1, y1) in zip(kept_ids, wins):
        if x1 <= x0 or y1 <= y0:
            continue
        cols = torch.arange(x0, x1, dtype=torch.float32, device=dev)
        rows = torch.arange(y0, y1, dtype=torch.float32, device=dev)
        grids = [torch.meshgrid(rows + oy, cols + ox, indexing="ij") for ox, oy in offsets]
        pys = torch.stack([g[0] for g in grids])
        pxs = torch.stack([g[1] for g in grids])
        x, y = xs[t], ys[t]
        ax, bx = x, torch.roll(x, -1)
        ay, by = y, torch.roll(y, -1)
        tl = raster_ops._top_left(ax, ay, bx, by)
        e = raster_ops._edge_canonical(c4(ax), c4(ay), c4(bx), c4(by), pxs[None], pys[None])
        inside = (e > 0.0) | ((e == 0.0) & c4(tl))
        bar = torch.stack([e[1], e[2], e[0]])
        bsum = (bar[0] + bar[1]) + bar[2]
        bar = bar / torch.where(bsum == 0.0, torch.ones_like(bsum), bsum)
        z = zs[t]
        zf = def_ops.fma32(bar[2], z[2], def_ops.fma32(bar[1], z[1], bar[0] * z[0]))
        dwin = depth[:, y0:y1, x0:x1]
        cov = inside.all(dim=0) & (zf >= dwin) & (zf >= 0.0) & (zf <= 1.0)
        with profiling_scope("sync::forward.blend_pixels"):
            sel = torch.nonzero(cov.flatten()).flatten()
        if sel.numel() == 0:
            continue
        n_px += int(sel.numel())
        pb = bar.reshape(3, -1)[:, sel] / ws[t][:, None]
        pb = pb / ((pb[0] + pb[1]) + pb[2])
        beta = (pb[:, :, None] * cbary[t][:, None, :]).sum(0)  # (n, 3) source barycentrics
        with profiling_scope("sync::forward.blend_source"):
            src = int(corig[t])
        rgba = _shade_blend_tri(src, beta, f, atlas)
        win = img[:, y0:y1, x0:x1].reshape(-1, 4)
        prev = win[sel]
        a = rgba[:, 3:4]
        win[sel] = torch.cat([rgba[:, :3] * a + prev[:, :3] * (1.0 - a), a + prev[:, 3:4] * (1.0 - a)], dim=1)
        img[:, y0:y1, x0:x1] = win.reshape(S, y1 - y0, x1 - x0, 4)
        dflat = dwin.reshape(-1).clone()
        dflat[sel] = zf.reshape(-1)[sel]
        depth[:, y0:y1, x0:x1] = dflat.reshape(dwin.shape)
    return img, n_px


def _shade_blend_tri(orig_id: int, beta, f: _Frame, atlas):
    """One blend triangle's (n, 4) RGBA at n pixels from their source
    barycentrics beta (n, 3) (base.py:2231-2278): its corners' attributes,
    one material, shadows from the atlas, textures with no gradients."""
    dev = beta.device
    vloc = f.blend_vlocal[orig_id].long()
    with profiling_scope("sync::forward.blend_object"):
        obj = int(f.blend_obj[orig_id].clamp_min(0))
    base = f.bases[obj].long()

    def gather(arena, ai, default):
        with profiling_scope("sync::forward.blend_attrs"):
            has = 1.0 if int(base[ai]) >= 0 else 0.0
        vals = arena[(vloc + base[ai]).clamp(0, arena.shape[0] - 1)]
        with profiling_scope("sync::const.blend_defaults"):
            dflt = torch.tensor(default, dtype=torch.float32, device=dev)
        return has * vals + (1.0 - has) * dflt

    m = f.mv[obj]
    mv3 = m[:3, :3]
    n = beta.shape[0]
    view_pos = (beta @ gather(f.geo.position, 0, [0.0, 0.0, 0.0])) @ mv3.T + m[:3, 3]
    inv_scale_sq = 1.0 / torch.clamp_min((mv3 * mv3).sum(0), 1e-30)

    def corner_dirs(ai):
        d = (gather(f.geo.normal if ai == 1 else f.geo.tangent, ai, [0.0, 0.0, 0.0]) * inv_scale_sq) @ mv3.T
        return d / torch.clamp_min(def_ops.sqrt32((d * d).sum(-1, keepdim=True)), 1e-20)

    nrm = beta @ corner_dirs(1)
    tan = beta @ corner_dirs(2)
    uv0 = beta @ gather(f.geo.uv0, 3, [0.0, 0.0])
    vcol = beta @ gather(f.geo.color0, 5, [1.0, 1.0, 1.0, 1.0])
    with profiling_scope("sync::forward.blend_object"):
        midx = int(f.material_slots[obj])
    mats = f.materials
    mdata = mats.data[midx][:, None].expand(mats.data.shape[1], n)
    mflags = mats.flags[midx].expand(n)
    mtex = mats.textures[midx][:, None].expand(mats.textures.shape[1], n) if f.textures is not None else None
    out_rgb, out_a = shade_ops._shade_pixels(
        mdata, mflags, mtex, vcol.T, nrm.T, tan.T, view_pos.T, f.dir_lights, f.point_lights, f.uniforms, None,
        textures=f.textures, uv0=uv0.T, duv=None, shadow_atlas=atlas,
    )
    return torch.cat([out_rgb, out_a], dim=0).T
