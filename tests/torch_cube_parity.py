"""The cube example's frame at 1280x720 in the PyTorch port and in the JAX
package, both on the CPU, with their shadow maps; and the form XLA:CPU
gives the shadow pass's triangle setup when it compiles it.

Prints, for each scene: the texels where the two shadow maps differ, the
pixels where the two frames differ by more than 1 u8, and (for the cube)
each frame against the JAX package's committed render cube.png. Then, on
the scene's shadow-pass triangles: how many setup rows JAX's jitted
cull_and_setup shares with its eager one (the form the port computes), and
with the contracted form (each a*b - c*d as fma(a, b, -(c*d)), each depth
plane sum as fma(z2, e2, fma(z1, e1, z0*e0))) evaluated in float64.

    JAX_PLATFORMS=cpu python3 tests/torch_cube_parity.py [--many]

--many adds 150 small cubes at random (numpy seed 3) to the scene. A
diagnostic, not collected by pytest; it takes about a minute a scene.
"""

import argparse
import functools
import importlib.util
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rend3_tpu import framework as JF  # noqa: E402
from rend3_tpu import types as JT  # noqa: E402
from rend3_tpu.ops import geometry as JG  # noqa: E402
from rend3_tpu.ops import raster as JR  # noqa: E402
from rend3_tpu.routine import base as JB  # noqa: E402
from rend3_tpu.routine.pbr import material as JM  # noqa: E402
from rend3_tpu_torch import framework as PF  # noqa: E402
from rend3_tpu_torch import testing  # noqa: E402
from rend3_tpu_torch import types as PT  # noqa: E402
from rend3_tpu_torch.examples import cube as pcube  # noqa: E402
from rend3_tpu_torch.ops import transform as T  # noqa: E402
from rend3_tpu_torch.routine import base as PB  # noqa: E402
from rend3_tpu_torch.routine.pbr import material as PM  # noqa: E402

W, H = 1280, 720


def _jax_cube():
    spec = importlib.util.spec_from_file_location("jax_example_cube", os.path.join(REPO, "examples", "cube.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _many(base, types, material):
    """base with 150 small cubes of random place, size and yaw added."""

    class Many(base):
        def setup(self, context):
            super().setup(context)
            r = context.renderer
            rng = np.random.default_rng(3)
            mesh = types.MeshBuilder(pcube.CUBE_POSITIONS, types.Handedness.LEFT)
            mh = r.add_mesh(mesh.with_indices(pcube.CUBE_INDICES).build())
            mat = r.add_material(material.PbrMaterial(albedo=material.AlbedoComponent.new_value([0.6, 0.5, 0.4, 1.0])))
            self.extra = []
            for _ in range(150):
                t = np.eye(4, dtype=np.float32)
                t[:3, 3] = rng.uniform(-3, 3, 3)
                t[:3, :3] *= rng.uniform(0.05, 0.3)
                th = rng.uniform(0, 6.28)
                rot = np.eye(4, dtype=np.float32)
                rot[0, 0], rot[0, 2], rot[2, 0], rot[2, 2] = np.cos(th), np.sin(th), -np.sin(th), np.cos(th)
                obj = types.Object(mesh_kind=types.StaticMeshKind(mh), material=mat,
                                   transform=(t @ rot).astype(np.float32))
                self.extra.append(r.add_object(obj))

    return Many


def _keep(graph_cls, name, store, key):
    orig = getattr(graph_cls, name)

    def wrapped(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        store[key] = (self, args, out)
        return out

    setattr(graph_cls, name, wrapped)


def _off(a, b):
    d = np.abs(a[..., :3].astype(np.int32) - b[..., :3].astype(np.int32))
    return int((d > 1).any(-1).sum()), int(d.max())


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _contracted_planes(clip, keep, size):
    """Setup columns S_EC..S_ZC (6:12) of the surviving rows in the
    contracted form, from the clip-space corners (float64 emulated fma)."""
    c = clip[keep]
    inv_w = np.float32(1) / c[..., 3]
    x = (c[..., 0] * inv_w * np.float32(0.5) + np.float32(0.5)) * np.float32(size)
    y = (np.float32(0.5) - c[..., 1] * inv_w * np.float32(0.5)) * np.float32(size)
    z = c[..., 2] * inv_w
    area2 = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0])
    flip = area2 < 0
    xo, yo, zo = (np.where(flip[:, None], a[:, [0, 2, 1]], a) for a in (x, y, z))
    xn, yn = np.roll(xo, -1, 1), np.roll(yo, -1, 1)

    def ab_cd(a, b, c_, d):
        return _fma(a, b, -(c_ * d))

    swap = (xn < xo) | ((xn == xo) & (yn < yo))
    lx, hx, ly, hy = (np.where(swap, p, q) for p, q in ((xn, xo), (xo, xn), (yn, yo), (yo, yn)))
    ec_canon = np.where(swap, np.float32(-1), np.float32(1)) * ab_cd(hy - ly, lx, hx - lx, ly)
    area = ab_cd(xo[:, 1] - xo[:, 0], yo[:, 2] - yo[:, 0], xo[:, 2] - xo[:, 0], yo[:, 1] - yo[:, 0])
    inv = np.float32(1) / area
    ea, eb, ec = -(yn - yo), xn - xo, ab_cd(yn - yo, xo, xn - xo, yo)
    planes = []
    for e in (ea, eb, ec):
        o = e[:, [1, 2, 0]]
        planes.append(_fma(zo[:, 2], o[:, 2], _fma(zo[:, 1], o[:, 1], zo[:, 0] * o[:, 0])) * inv)
    return np.concatenate([ec_canon, np.stack(planes, 1)], axis=1)


def _setup_forms(clip, valid, front_cw, size):
    """Rows of JAX's jitted shadow setup equal to its eager one and to the
    contracted form, over the surviving rows."""
    kw = dict(width=size, height=size, cull_mode=JR.CullMode.FRONT, front_is_cw=front_cw, subpixel=True)
    jit = jax.jit(functools.partial(JG.cull_and_setup, **kw))(jnp.asarray(clip), jnp.asarray(valid))
    eager = JG.cull_and_setup(jnp.asarray(clip), jnp.asarray(valid), **kw)
    n = int(jit.count)
    js, es = np.asarray(jit.setup)[:n, 6:12], np.asarray(eager.setup)[:n, 6:12]
    keep = np.asarray(jit.src)[:n]
    cs = _contracted_planes(clip, keep, size)
    return n, int((js == es).all(1).sum()), int((js == cs).all(1).sum())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--many", action="store_true")
    args = ap.parse_args()
    got = {}
    _keep(JB.BaseRenderGraph, "_ensure_shadow_maps", got, "jax")
    _keep(PB.BaseRenderGraph, "_ensure_shadow_maps", got, "port")
    jcube = _jax_cube()
    scenes = [("cube", pcube.CubeExample, jcube.CubeExample)]
    if args.many:
        scenes.append(("150 cubes", _many(pcube.CubeExample, PT, PM), _many(jcube.CubeExample, JT, JM)))
    for name, port_cls, jax_cls in scenes:
        port = PF.render_single_frame(port_cls(), W, H, device="cpu")
        jax_img = np.asarray(JF.render_single_frame(jax_cls(), W, H))
        pm, jm = got["port"][2][0][0].numpy(), np.asarray(got["jax"][2][0][0])
        n_px, max_u8 = _off(port, jax_img)
        print(f"{name} at {W}x{H}: shadow map {pm.shape}, {int((pm > 0).sum())} texels covered, "
              f"{int((pm != jm).sum())} differ (max {float(np.abs(pm - jm).max()):.3g}); "
              f"port vs JAX {n_px} pixels more than 1 u8 off (largest {max_u8})")
        if name == "cube":
            ref = testing.load_png(os.path.join(REPO, "cube.png"))
            for label, img in (("port", port), ("JAX", jax_img)):
                n_px, max_u8 = _off(img, ref)
                print(f"  {label} vs cube.png: {n_px} pixels more than 1 u8 off (largest {max_u8})")
        # The shadow pass's clipped triangles, as the port builds them.
        _graph, (eval_output, f), _ = got["port"]
        size = eval_output.shadow_plan[0][2]
        eye = torch.eye(4, dtype=torch.float32)
        _, smvp = T.object_uniforms(f.transforms, f.dir_lights.view_proj[0], eye)
        sclip = T.gather_tri_clip(f.geo.position, f.tri_vlocal, f.tri_obj, f.bases[:, 0], smvp, tri_pos=f.tri_pos)
        cl = T.clip_triangles(sclip, f.shadow_visible[0][f.tri_obj.long()])
        n, eager_rows, contracted_rows = _setup_forms(cl.clip.numpy(), cl.valid.numpy(), f.front_cw, size)
        print(f"  shadow setup of {n} rows: jitted JAX equals eager JAX in {eager_rows}, "
              f"the contracted form in {contracted_rows}")


if __name__ == "__main__":
    main()
