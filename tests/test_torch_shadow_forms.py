"""Shadow compares at near-ties: the port's frame against the JAX package's
jitted frame and shadow programs on the CPU.

XLA:CPU contracts the JAX frame's and shadow pass's arithmetic into fused
multiply-adds; the port's frame computes the same forms (the `contract`
option of transform.gather_tri_clip / clip_triangles,
geometry.cull_and_setup and deferred.attribute_planes, and the light-space
products of routine.base._shadow_coords), so its shadow maps and the
receivers' light-space depths match JAX's bit for bit, and the PCF compares
at near-ties fall the same way.

- Each contracted function against the JAX function under jax.jit on the
  same inputs (the scene below, the main camera at 120x72 and the light's
  512x512 map), bit for bit; near-plane clipping on a soup of crossing
  triangles.
- The cube example with 20 more cubes placed from numpy seed 3 and its
  light's map at 512x512 over a 16-unit square, rendered at 128x72 by both
  packages: the shadow maps equal bit for bit, the frames within 1 u8.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rend3_tpu import framework as JF
from rend3_tpu import types as JTy
from rend3_tpu.core.framestate import GeometryArrays as JGeo
from rend3_tpu.ops import deferred as JD
from rend3_tpu.ops import geometry as JG
from rend3_tpu.ops import transform as JT
from rend3_tpu.routine import base as JB
from rend3_tpu.routine.pbr import material as JM
from rend3_tpu_torch import framework as PF
from rend3_tpu_torch import types as PTy
from rend3_tpu_torch.examples import cube as pcube
from rend3_tpu_torch.ops import deferred as PD
from rend3_tpu_torch.ops import geometry as PG
from rend3_tpu_torch.ops import transform as PT
from rend3_tpu_torch.routine import base as PB
from rend3_tpu_torch.routine.pbr import material as PM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 128, 72
MAP = 512


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_cube():
    spec = importlib.util.spec_from_file_location("jax_example_cube", os.path.join(REPO, "examples", "cube.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cubes(base, types, material):
    """base (a cube example App) with its light's map at MAP x MAP over a
    16-unit square and 20 small cubes of random place, size and yaw."""

    class Cubes(base):
        def setup(self, context):
            super().setup(context)
            r = context.renderer
            r.update_directional_light(self.light, resolution=MAP, distance=16.0)
            rng = np.random.default_rng(3)
            mesh = types.MeshBuilder(pcube.CUBE_POSITIONS, types.Handedness.LEFT)
            mh = r.add_mesh(mesh.with_indices(pcube.CUBE_INDICES).build())
            mat = r.add_material(material.PbrMaterial(albedo=material.AlbedoComponent.new_value([0.6, 0.5, 0.4, 1.0])))
            self.extra = []
            for _ in range(20):
                t = np.eye(4, dtype=np.float32)
                t[:3, 3] = rng.uniform(-3, 3, 3)
                t[:3, :3] *= rng.uniform(0.05, 0.3)
                th = rng.uniform(0, 6.28)
                rot = np.eye(4, dtype=np.float32)
                rot[0, 0], rot[0, 2], rot[2, 0], rot[2, 2] = np.cos(th), np.sin(th), -np.sin(th), np.cos(th)
                self.extra.append(r.add_object(types.Object(
                    mesh_kind=types.StaticMeshKind(mh), material=mat, transform=(t @ rot).astype(np.float32),
                )))

    return Cubes


def _keep(monkeypatch, graph_cls, name, store, key):
    orig = getattr(graph_cls, name)

    def wrapped(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        store[key] = (args, out)
        return out

    monkeypatch.setattr(graph_cls, name, wrapped)


@pytest.fixture(scope="module")
def frames():
    """Both packages' frames and shadow maps, and the port's frame inputs."""
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        _keep(mp, JB.BaseRenderGraph, "_ensure_shadow_maps", got, "jax")
        _keep(mp, PB.BaseRenderGraph, "_ensure_shadow_maps", got, "port")
        port = PF.render_single_frame(_cubes(pcube.CubeExample, PTy, PM)(), W, H, device="cpu")
        ref = np.asarray(JF.render_single_frame(_cubes(_jax_cube().CubeExample, JTy, JM)(), W, H))
    return port, ref, got


def test_shadow_maps_match_jax_bit_for_bit(frames):
    _port, _ref, got = frames
    pm = got["port"][1][0][0].numpy()
    jm = np.asarray(got["jax"][1][0][0])
    assert pm.shape == jm.shape == (MAP, MAP)
    assert (pm > 0).sum() > 5000
    np.testing.assert_array_equal(pm.view(np.int32), jm.view(np.int32))


def test_frame_matches_jax(frames):
    port, ref, _got = frames
    assert (port[..., :3] != port[0, 0, :3]).any(-1).mean() > 0.1
    assert int(np.abs(port.astype(np.int32) - ref.astype(np.int32)).max()) <= 1


@pytest.fixture(scope="module")
def views(frames):
    """(clip inputs, clipped table, setup) of the port's frame for the main
    camera at 120x72 and the light's map."""
    _p, _r, got = frames
    (ev, f), _out = got["port"]
    eye = torch.eye(4)
    out = {}
    for name, (view, proj, visible, w, h, cull) in {
        "main": (f.view, f.proj, f.visible, 120, 72, PG.CullMode.BACK),
        "shadow": (f.dir_lights.view_proj[0], eye, f.shadow_visible[0], MAP, MAP, PG.CullMode.FRONT),
    }.items():
        mv, mvp = PT.object_uniforms(f.transforms, view, proj)
        clip = PT.gather_tri_clip(f.geo.position, f.tri_vlocal, f.tri_obj, f.bases[:, 0], mvp, tri_pos=f.tri_pos,
                                  contract=True)
        cl = PT.clip_triangles(clip, visible[f.tri_obj.long()], contract=True)
        tris = PG.cull_and_setup(cl.clip, cl.valid, w, h, cull_mode=cull, front_is_cw=f.front_cw, subpixel=True,
                                 contract=True)
        out[name] = dict(f=f, mv=mv, mvp=mvp, clip=clip, cl=cl, tris=tris, w=w, h=h, cull=cull)
    return out


def _j(t):
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("view", ["main", "shadow"])
def test_contracted_clip_transform_matches_jitted_jax(views, view):
    v = views[view]
    f = v["f"]
    want = jax.jit(lambda *a: JT.gather_tri_clip(*a[:5], tri_pos=a[5]))(
        _j(f.geo.position), _j(f.tri_vlocal), _j(f.tri_obj), _j(f.bases[:, 0]), _j(v["mvp"]), _j(f.tri_pos))
    np.testing.assert_array_equal(v["clip"].numpy(), np.asarray(want))


@pytest.mark.parametrize("view", ["main", "shadow"])
def test_contracted_setup_matches_jitted_jax(views, view):
    v = views[view]
    kw = dict(width=v["w"], height=v["h"], cull_mode=v["cull"], front_is_cw=v["f"].front_cw, subpixel=True)
    want = jax.jit(functools.partial(JG.cull_and_setup, **kw))(_j(v["cl"].clip), _j(v["cl"].valid))
    n = int(want.count)
    tris = v["tris"]
    assert tris.count == n > 20
    np.testing.assert_array_equal(tris.src.numpy(), np.asarray(want.src)[:n])
    np.testing.assert_array_equal(tris.setup.numpy(), np.asarray(want.setup)[:n])
    np.testing.assert_array_equal(tris.bbox.numpy(), np.asarray(want.bbox)[:n])
    eager = PG.cull_and_setup(v["cl"].clip, v["cl"].valid, cull_mode=v["cull"], front_is_cw=v["f"].front_cw,
                              subpixel=True, width=v["w"], height=v["h"])
    assert not torch.equal(eager.setup, tris.setup)  # the eager form differs on this scene


def test_contracted_attribute_planes_match_jitted_jax(views):
    v = views["main"]
    f, cl = v["f"], v["cl"]
    kw = dict(width=v["w"], height=v["h"], cull_mode=v["cull"], front_is_cw=f.front_cw, subpixel=True)
    jt = jax.jit(functools.partial(JG.cull_and_setup, **kw))(_j(cl.clip), _j(cl.valid))
    want = jax.jit(lambda *a: JD.attribute_planes(*a, v["w"], v["h"]))(
        jt, _j(cl.clip), _j(cl.bary), _j(cl.orig.int()), _j(f.tri_vlocal), _j(f.tri_obj), _j(f.bases),
        JGeo(*(_j(a) for a in f.geo)), _j(v["mv"]), _j(f.material_slots))
    got = PD.attribute_planes(v["tris"], cl.clip, cl.bary, cl.orig, f.tri_vlocal, f.tri_obj, f.bases, f.geo, v["mv"],
                              f.material_slots, v["w"], v["h"], contract=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[: v["tris"].count])


def test_contracted_near_clip_matches_jitted_jax():
    """500 random triangles, about a third crossing the near plane: each
    source triangle's fans equal, corners and barycentrics bit for bit."""
    rng = np.random.default_rng(0)
    T = 500
    clip = rng.uniform(-2, 2, (T, 3, 4)).astype(np.float32)
    clip[..., 3] = rng.uniform(-0.5, 3, (T, 3)).astype(np.float32)
    valid = np.ones(T, bool)
    want = jax.jit(JT.clip_triangles)(jnp.asarray(clip), jnp.asarray(valid))
    got = PT.clip_triangles(torch.from_numpy(clip), torch.from_numpy(valid), contract=True)

    def fans(c, o, v, b):
        out = {}
        for i in np.nonzero(np.asarray(v))[0]:
            out.setdefault(int(o[i]), []).append((np.asarray(c)[i], np.asarray(b)[i]))
        return out

    fj = fans(want.clip, np.asarray(want.orig), want.valid, want.bary)
    fp = fans(got.clip, got.orig.numpy(), got.valid.numpy(), got.bary.numpy())
    assert fj.keys() == fp.keys() and sum(len(x) for x in fj.values()) > T
    for k in fj:
        assert len(fj[k]) == len(fp[k])
        for (a, ab), (c, cb) in zip(fj[k], fp[k]):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(ab, cb)
