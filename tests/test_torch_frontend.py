"""Front-end parity of the PyTorch port against the JAX package.

The 24-building flat city scene of bench.py at 256x128 is built in both
packages from the same seed; the JAX stages run eagerly on the CPU, as the
suite runs them. Tolerance: none. The object matrices, clip-space table,
clipped table, setup and bbox rows, plane table and per-tile lists must
match bit for bit (the tile lists once JAX's -1 padding is stripped).

Two views: the main camera (back-face cull, 256x128 target) and the
shadow camera of the directional light (front-face cull, 256x256 map).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from rend3_tpu.ops import deferred as JD
from rend3_tpu.ops import geometry as JG
from rend3_tpu.ops import raster as JRaster
from rend3_tpu.ops import transform as JT
from rend3_tpu.testing import TestRunner as JaxRunner
from rend3_tpu.types import Camera, Perspective
from rend3_tpu.utils import math as jm3
from rend3_tpu_torch import interop, scenes
from rend3_tpu_torch.ops import deferred as PD
from rend3_tpu_torch.ops import geometry as PG
from rend3_tpu_torch.ops import transform as PT
from rend3_tpu_torch.testing import TestRunner as PortRunner

W, H = 256, 128
SHADOW = 256


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_scene():
    runner = JaxRunner()
    keep = bench.build_city_scene(runner, n_buildings=24, seed=7, representative=False)
    runner.set_camera_data(
        Camera(
            projection=Perspective(vfov=60.0, near=0.1),
            view=jm3.look_at_lh([40.0, 30.0, -60.0], [0.0, 5.0, 0.0], [0.0, 1.0, 0.0]),
        )
    )
    runner.renderer.set_aspect_ratio(W / H)
    runner.renderer.swap_instruction_buffers()
    return runner, keep, runner.renderer.evaluate_instructions()


def _port_scene():
    runner = PortRunner(device="cpu")
    keep = scenes.build_city_scene(runner, n_buildings=24, seed=7, representative=False)
    scenes.set_bench_camera(runner, W, H)
    runner.renderer.swap_instruction_buffers()
    return runner, keep, runner.renderer.evaluate_instructions()


def _view(runner, ev, view):
    """(view, proj, visible mask, width, height, cull mode name) of a view."""
    r = runner.renderer
    om = r.object_manager
    if view == "main":
        cam = r.camera
        vis = om.enabled & cam.world_frustum.contains_spheres(om.world_spheres)
        return cam.view, cam.proj, vis, W, H, "BACK"
    li = ev.shadow_plan[0][0]
    sc = ev.shadow_cameras[li]
    vis = om.enabled & sc.world_frustum.contains_spheres(om.world_spheres)
    return ev.dir_light_arrays["view_proj"][0], np.eye(4, dtype=np.float32), vis, SHADOW, SHADOW, "FRONT"


@pytest.fixture(scope="module")
def scenes_both():
    return _jax_scene(), _port_scene()


def _jax_tables(runner, ev, view):
    r = runner.renderer
    om = r.object_manager
    opaque, _ = om.build_tri_tables(r.mesh_manager)
    geo = r.mesh_manager.evaluate()
    tv, to = jnp.asarray(opaque[:, :3]), jnp.asarray(opaque[:, 3])
    v, p, vis, w, h, cull = _view(runner, ev, view)
    mv, mvp = JT.object_uniforms(jnp.asarray(om.transforms), jnp.asarray(v), jnp.asarray(p))
    clip = JT.gather_tri_clip(geo.position, tv, to, jnp.asarray(om.bases)[:, 0], mvp)
    cl = JT.clip_triangles(clip, jnp.asarray(vis)[to])
    t = JG.cull_and_setup(
        cl.clip, cl.valid, w, h, cull_mode=getattr(JRaster.CullMode, cull), front_is_cw=True,
        subpixel=True,
    )
    planes = JD.attribute_planes(
        t, cl.clip, cl.bary, cl.orig, tv, to, jnp.asarray(om.bases), geo, mv,
        jnp.asarray(om.material_slots), w, h,
    )
    n = int(t.count)
    binned = JG.bin_triangles(t, -(-w // 128) * 128, -(-h // 32) * 32, tile_cap=max(n, 1), tile_h=32, tile_w=128)
    return dict(
        opaque=opaque, mv=mv, mvp=mvp, clip=clip, cl=cl, t=t, n=n, planes=planes, binned=binned,
        T=len(opaque),
    )


def _port_tables(runner, ev, view):
    r = runner.renderer
    om = r.object_manager
    opaque, _ = om.build_tri_tables(r.mesh_manager)
    geo = r.mesh_manager.evaluate()
    tv, to = torch.from_numpy(opaque[:, :3]), torch.from_numpy(opaque[:, 3])
    v, p, vis, w, h, cull = _view(runner, ev, view)
    mv, mvp = PT.object_uniforms(
        torch.from_numpy(om.transforms), torch.from_numpy(np.asarray(v)), torch.from_numpy(np.asarray(p))
    )
    bases = torch.from_numpy(om.bases)
    clip = PT.gather_tri_clip(geo.position, tv, to, bases[:, 0], mvp)
    cl = PT.clip_triangles(clip, torch.from_numpy(vis)[to.long()])
    t = PG.cull_and_setup(
        cl.clip, cl.valid, w, h, cull_mode=getattr(PG.CullMode, cull), front_is_cw=True, subpixel=True
    )
    planes = PD.attribute_planes(
        t, cl.clip, cl.bary, cl.orig, tv, to, bases, geo, mv,
        torch.from_numpy(om.material_slots), w, h,
    )
    binned = PG.bin_triangles(t, -(-w // 128) * 128, -(-h // 32) * 32, tile_h=32, tile_w=128)
    return dict(opaque=opaque, mv=mv, mvp=mvp, clip=clip, cl=cl, t=t, planes=planes, binned=binned)


@pytest.fixture(scope="module", params=["main", "shadow"])
def tables(request, scenes_both):
    (jr, _jk, jev), (pr, _pk, pev) = scenes_both
    return _jax_tables(jr, jev, request.param), _port_tables(pr, pev, request.param)


def test_scene_tables_identical(tables, scenes_both):
    """Triangle tables and the mesh arenas (carried over by interop)."""
    j, p = tables
    np.testing.assert_array_equal(j["opaque"], p["opaque"])
    (jr, _jk, _jev), (pr, _pk, _pev) = scenes_both
    jgeo = interop.geometry_arrays(jr.renderer.mesh_manager.evaluate())
    pgeo = pr.renderer.mesh_manager.evaluate()
    for f in pgeo._fields:
        assert torch.equal(getattr(jgeo, f), getattr(pgeo, f)), f


def test_object_matrices(tables):
    j, p = tables
    np.testing.assert_array_equal(np.asarray(j["mv"]), p["mv"].numpy())
    np.testing.assert_array_equal(np.asarray(j["mvp"]), p["mvp"].numpy())


def test_clip_space_table(tables):
    j, p = tables
    np.testing.assert_array_equal(np.asarray(j["clip"]), p["clip"].numpy())


def test_clipped_table(tables):
    """The input rows pass through; the fan triangles of the near-plane
    crossing triangles (the ground plane crosses it from the bench camera)
    match once JAX's static clip-cap padding rows are dropped."""
    j, p = tables
    T = j["T"]
    jc, pc = j["cl"], p["cl"]
    for f in ("clip", "orig", "bary", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, f))[:T], getattr(pc, f).numpy()[:T])
    jv = np.asarray(jc.valid)[T:]
    pv = pc.valid.numpy()[T:]
    for f in ("clip", "orig", "bary"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, f))[T:][jv], getattr(pc, f).numpy()[T:][pv])


def test_setup_and_bbox(tables):
    """Setup rows bit-exact; the source-id column S_ID indexes each
    package's own clipped table, so it is compared through the rows it
    names."""
    j, p = tables
    n = j["n"]
    js, ps = np.asarray(j["t"].setup)[:n], p["t"].setup.numpy()
    assert ps.shape[0] == n
    np.testing.assert_array_equal(np.delete(js, PG.S_ID, 1), np.delete(ps, PG.S_ID, 1))
    np.testing.assert_array_equal(np.asarray(j["t"].bbox)[:n], p["t"].bbox.numpy())
    np.testing.assert_array_equal(np.asarray(j["t"].flip)[:n], p["t"].flip.numpy())
    jsrc, psrc = js[:, PG.S_ID].astype(np.int64), ps[:, PG.S_ID].astype(np.int64)
    np.testing.assert_array_equal(psrc, p["t"].src.numpy())
    for f in ("clip", "orig", "bary"):
        np.testing.assert_array_equal(
            np.asarray(getattr(j["cl"], f))[jsrc], getattr(p["cl"], f).numpy()[psrc]
        )


def test_attribute_planes(tables):
    j, p = tables
    np.testing.assert_array_equal(np.asarray(j["planes"])[: j["n"]], p["planes"].numpy())


def test_tile_lists(tables):
    j, p = tables
    ids = np.asarray(j["binned"].ids)
    offs, pids = p["binned"].offsets.numpy(), p["binned"].ids.numpy()
    assert len(offs) == ids.shape[0] + 1
    assert int(np.asarray(j["binned"].overflow)) == 0
    for tile in range(ids.shape[0]):
        np.testing.assert_array_equal(ids[tile][ids[tile] >= 0], pids[offs[tile] : offs[tile + 1]])
