"""Time this tree's K1 and K2 against another tree's on the same 1080p inputs.

    python3 raster_ab.py OTHER_DIR

OTHER_DIR holds another commit's tree, for example the parent's, unpacked
with `git archive` into the ignored `_checkout/`. Its rend3_tpu_torch
package is imported under another name, so it builds its own kernels into
its own `_build/` and launches them through its own wrappers
(`ops.deferred.raster_resolve` and `raster_depth`), whatever its kernels' C
interface. The inputs come from frames of this tree's renderer on the card
at 1920x1080, as chip_smoke.py renders them: K1 opaque and K2 (the 2048²
map) from the flat city after a building moved; K1's count and bound modes
from the representative frame's first cutout or blend peels (occlusion
off); K1 at an MSAA offset from the representative frame at 4 samples; K2
on the feature city's shadow map rebuilt for a new pose. Both trees'
outputs must be equal bit for bit (NaN at the same places). Device times:
chip_smoke._graph_ms (20 calls in one CUDA graph, replayed between CUDA
events), in turns other, this, this, other. Prints each case as it goes,
then one JSON object: per case the other's and this tree's mean device ms,
the four turns, and the tile lists' size.
"""

import importlib
import importlib.util
import json
import os
import sys

import chip_smoke as cs

WIDTH, HEIGHT = cs.WIDTH, cs.HEIGHT


def load_other(root):
    """The other tree's ops.deferred, its package imported as rend3_other."""
    pkg = os.path.join(os.path.abspath(root), "rend3_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "rend3_other", os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg]
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules["rend3_other"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("rend3_other.ops.deferred")


def capture(scene, samples=1, occlusion=False):
    """`captured` of a second frame of `scene` on the card: after a
    building moved (flat), a new pose (features), or unchanged."""
    from rend3_tpu_torch import scenes
    from rend3_tpu_torch.routine.base import BaseRenderGraphSettings, FrameRenderTarget
    from rend3_tpu_torch.testing import TestRunner
    from rend3_tpu_torch.utils import math as m3

    runner = TestRunner(device="cuda")
    sky = None
    if scene == "features":
        keep, info = scenes.feature_city(runner, n_buildings=600)
        sky = info["sky"].idx
    else:
        keep = scenes.build_city_scene(runner, n_buildings=600, representative=scene == "representative")
    scenes.set_bench_camera(runner, WIDTH, HEIGHT)
    graph = runner.base_graph
    graph.occlusion_culling = occlusion
    target = FrameRenderTarget(WIDTH, HEIGHT, samples)
    settings = BaseRenderGraphSettings(ambient_color=(0.08, 0.08, 0.1, 1.0))

    def frame():
        runner.renderer.swap_instruction_buffers()
        graph.render_frame_tensor(runner.renderer.evaluate_instructions(), target, settings, sky)

    frame()
    if scene == "flat":
        building = [h for h in keep if getattr(h, "kind", None) == "object"][-1]
        runner.renderer.set_object_transform(building, m3.translation([24.0, 25.0, -40.0]) @ m3.scale([3.0, 25.0, 3.0]))
    elif scene == "features":
        scenes.pose_columns(runner, info["skeletons"], 0.8)
    graph.captured = {}
    frame()
    del keep
    return graph.captured


def lists(binned):
    """Tile-list lengths: tiles, entries, max."""
    n = binned.offsets[1:] - binned.offsets[:-1]
    return {"tiles": int(n.numel()), "entries": int(n.sum()), "max": int(n.max())}


def main(argv):
    import torch

    if len(argv) != 1:
        raise SystemExit(__doc__.split("\n\n")[1])
    if not torch.cuda.is_available():
        raise SystemExit("raster_ab needs a CUDA device")
    from rend3_tpu_torch.ops import deferred as D

    OD = load_other(argv[0])
    flat = capture("flat")
    rep = capture("representative")
    msaa = capture("representative", samples=4, occlusion=True)
    feat = capture("features", occlusion=True)
    c_tris, c_planes, c_binned, c_wp, c_hp, floor, strict = rep["raster_count"]
    b_tris, b_planes, b_binned, b_wp, b_hp, bnd = rep["raster_bound"]
    m = msaa["raster_sample"]
    cases = {
        "K1 opaque (flat)": (D.raster_resolve, OD.raster_resolve, flat["raster_resolve"], {}),
        "K1 MSAA offset (representative, 4 samples)": (D.raster_resolve, OD.raster_resolve, m[:5], {"sofs": m[5]}),
        "K1 count (representative, first peel)": (
            D.raster_resolve, OD.raster_resolve, (c_tris, c_planes, c_binned, c_wp, c_hp),
            {"count_floor": floor, "count_strict": strict},
        ),
        "K1 bound (representative, first later peel)": (
            D.raster_resolve, OD.raster_resolve, (b_tris, b_planes, b_binned, b_wp, b_hp), {"bound": bnd},
        ),
        "K2 (flat, 2048² map)": (D.raster_depth, OD.raster_depth, flat["raster_depth"], {}),
        "K2 (features, map rebuilt for a new pose)": (D.raster_depth, OD.raster_depth, feat["raster_depth"], {}),
    }
    results = {}
    for label, (fn, other_fn, args, kw) in cases.items():
        outs = []
        for f in (fn, other_fn):
            out = f(*args, **kw)
            outs.append(out if isinstance(out, tuple) else (out,))
        for a, b in zip(*outs):
            a, b = getattr(a, "data", a), getattr(b, "data", b)
            if not cs._same_with_nan(a, b):
                raise AssertionError(f"{label}: this tree's kernel and the other's differ")
        t = [cs._graph_ms(lambda g=g: g(*args, **kw)) for g in (other_fn, fn, fn, other_fn)]
        binned = args[2] if fn is D.raster_resolve else args[1]
        results[label] = {"other_ms": (t[0] + t[3]) / 2, "this_ms": (t[1] + t[2]) / 2, "turns_ms": t,
                          "lists": lists(binned)}
        cs.log(f"{label}: {json.dumps(results[label])}")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": cs.nvidia_smi_line(), "cases": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
