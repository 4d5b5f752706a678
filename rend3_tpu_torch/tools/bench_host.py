"""The host-loop micro-bench: a 50,000-object scene's per-frame host work.

Port of tools/bench_host.py. The reference's one published number is a
50k-object scene whose CPU render-loop cost dropped from 16 ms to 1.75 ms
in its v0.2.0 (the JAX tool's docstring cites it). This tool measures the
port's counterpart of that loop: instruction swap + evaluate_instructions
+ the host assembly of the frame's device tables
(`BaseRenderGraph._upload`: frustum masks, blend sort, table caching),
with no device stage run. The scene is the JAX tool's: n instances of one
cube on a grid, 4 lit materials, one directional light, the same camera
and aspect.

    python3 -m rend3_tpu_torch.tools.bench_host [n_objects] [--profile] [--device D]

It prints the time to add the objects, the first evaluate_instructions,
the first `_upload`, then the min / median / max of 20 steady iterations,
each ending with a synchronize on a card. The device defaults to the card
("cuda") and the tool raises without one; pass --device cpu for the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

__all__ = ["CUBE_POSITIONS", "CUBE_INDICES", "build_scene", "run", "main"]

CUBE_POSITIONS = np.array(
    [[-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
     [-1, 1, -1], [1, 1, -1], [1, -1, -1], [-1, -1, -1]], np.float32)
CUBE_INDICES = np.array([0, 1, 2, 2, 3, 0, 4, 5, 6, 6, 7, 4,
                         1, 6, 5, 5, 2, 1, 0, 3, 4, 4, 7, 0,
                         3, 2, 5, 5, 4, 3, 0, 7, 6, 6, 1, 0], np.uint32)
ITERS = 20


def build_scene(runner, n_objects: int, types=None, m3=None, log=None):
    """The JAX tool's scene on `runner` (a TestRunner of this package, or
    of another with the same API when its `types` and `utils.math`
    modules are passed): n_objects instances of one cube on a grid with 4
    lit materials, one directional light and the tool's camera at 16:9.
    Returns the handles to keep; `log(add_seconds)` is called after the
    objects are added."""
    if types is None:
        from .. import types
    if m3 is None:
        from ..utils import math as m3
    r = runner.renderer
    keep = []
    t0 = time.perf_counter()
    mats = [runner.add_lit_material([0.5, 0.5 + 0.1 * i, 0.5, 1.0]) for i in range(4)]
    keep += mats
    cube = types.MeshBuilder(CUBE_POSITIONS, types.Handedness.LEFT).with_indices(CUBE_INDICES).build()
    mesh_h = runner.add_mesh(cube)
    keep.append(mesh_h)
    side = int(np.ceil(n_objects ** (1 / 3)))
    for i in range(n_objects):
        x, y, z = (i % side, (i // side) % side, i // (side * side))
        t = m3.translation([x * 2.0, y * 2.0, z * 2.0]) @ m3.scale(0.4)
        obj = types.Object(mesh_kind=types.StaticMeshKind(mesh_h), material=mats[i % 4], transform=t)
        keep.append(r.add_object(obj))
    if log is not None:
        log(time.perf_counter() - t0)
    keep.append(runner.add_directional_light(np.array([-1.0, -1.0, 1.0], np.float32)))
    runner.set_camera_data(types.Camera(
        projection=types.Perspective(vfov=60.0, near=0.1),
        view=m3.look_at_lh([40.0, 30.0, -60.0], [side * 1.0, side * 1.0, side * 1.0], [0.0, 1.0, 0.0]),
    ))
    r.set_aspect_ratio(16 / 9)
    return keep


def run(n_objects: int = 50_000, device="cuda", profile: bool = False, out=print) -> dict:
    """Builds the scene on `device`, prints the tool's lines through `out`
    and returns {"add_s", "first_evaluate_ms", "first_upload_ms", "ms"}
    (ms: the ITERS steady iterations, in order)."""
    from ..routine.base import BaseRenderGraphSettings, FrameRenderTarget
    from ..testing import TestRunner

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    runner = TestRunner(device=dev)
    r = runner.renderer
    res = {}

    def added(s):
        res["add_s"] = s
        out(f"added {n_objects} objects in {s:.2f}s ({1e6 * s / n_objects:.1f} us/object)")

    keep = build_scene(runner, n_objects, log=added)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    r.swap_instruction_buffers()
    eval_output = r.evaluate_instructions()
    sync()
    res["first_evaluate_ms"] = (time.perf_counter() - t0) * 1e3
    out(f"first evaluate_instructions: {res['first_evaluate_ms']:.1f} ms")

    target = FrameRenderTarget(1920, 1080, 1)
    settings = BaseRenderGraphSettings()
    graph = runner.base_graph
    # The first upload builds the triangle tables and copies them to the
    # device; the loop below is the steady per-frame host path.
    t0 = time.perf_counter()
    graph._upload(eval_output, target, settings, None)
    sync()
    res["first_upload_ms"] = (time.perf_counter() - t0) * 1e3
    out(f"first BaseRenderGraph._upload: {res['first_upload_ms']:.1f} ms")

    prof = None
    if profile:
        import cProfile

        prof = cProfile.Profile()
    ts = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        if prof is not None:
            prof.enable()
        r.swap_instruction_buffers()
        eval_output = r.evaluate_instructions()
        graph._upload(eval_output, target, settings, None)
        sync()
        if prof is not None:
            prof.disable()
        ts.append(time.perf_counter() - t0)
    if prof is not None:
        import io
        import pstats

        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(30)
        out(buf.getvalue())
    ms = np.asarray(ts) * 1e3
    res["ms"] = ms.tolist()
    out(f"steady-state host loop over {n_objects} objects ({dev.type}): "
        f"min {ms.min():.3f} ms  median {np.median(ms):.3f} ms  max {ms.max():.3f} ms")
    out("reference baseline: 1.75 ms CPU loop at 50k objects (its CHANGELOG, unspecified hardware)")
    del keep
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="50k-object host-loop micro-bench of the port")
    ap.add_argument("n_objects", nargs="?", type=int, default=50_000)
    ap.add_argument("--profile", action="store_true", help="print a cProfile of the steady loop")
    ap.add_argument("--device", default="cuda", help="cuda (default; needs a card) or cpu")
    args = ap.parse_args(argv)
    return run(args.n_objects, args.device, args.profile)


if __name__ == "__main__":
    main()
