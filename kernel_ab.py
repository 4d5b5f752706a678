"""Time this tree's kernels against another tree's on the same inputs.

    python3 kernel_ab.py OTHER_DIR [K1 K2 P1 K5]

OTHER_DIR holds another commit's tree, for example the parent's, unpacked
with `git archive` into the ignored `_checkout/`. Its rend3_tpu_torch
package is imported under another name, so it builds its own kernels into
its own `_build/` and launches them through its own wrappers
(`ops.deferred.raster_resolve` and `raster_depth`, `ops.probe_bf16.probe_dot`,
`ops.samplers.sample_grid`), whatever its kernels' C interface. The groups
named (all four by default) choose the cases. The inputs come from this
tree on the card, as chip_smoke.py makes them, at 1920x1080:

- K1 opaque and K2 (the 2048² map) from the flat city after a building
  moved; K1's count and bound modes from the representative frame's first
  cutout or blend peels (occlusion off); K1 at an MSAA offset from the
  representative frame at 4 samples; K2 on the feature city's shadow map
  rebuilt for a new pose;
- P1 on the four variants of tools.probe_bf16_dot and the dense dot of
  tools.probe_bf16_kernel v1 (K = 72 or 128, M = 512, N = 1024), and on
  random f32 operands of that shape at K = 8, 36 and 128;
- K5 on the Hi-Z test of the textured city's second occlusion-on frame.

Both trees' outputs must be equal bit for bit (NaN at the same places).
Device times: chip_smoke._graph_ms (20 calls in one CUDA graph, replayed
between CUDA events), in turns other, this, this, other; for P1 and K5 also
their library call's (torch.matmul; advanced indexing). For P1 and K5 it
prints each tree's ptxas lines (registers, spills, shared memory) and
resident CTAs per SM: this tree's from the CUDA runtime, the other's from
ptxas's registers and shared memory by the occupancy rules of the H100
(both ways for this tree, as a check). Prints each case as it goes, then
one JSON object: per case the other's and this tree's mean device ms, the
four turns, the library call's ms, and the tile lists' size for K1 / K2.
"""

import importlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import chip_smoke as cs

WIDTH, HEIGHT = cs.WIDTH, cs.HEIGHT
GROUPS = ("K1", "K2", "P1", "K5")


def load_other(root):
    """The other tree's package, imported as rend3_other."""
    pkg = os.path.join(os.path.abspath(root), "rend3_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "rend3_other", os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg]
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules["rend3_other"] = mod
    spec.loader.exec_module(mod)
    return mod


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
    elif scene == "textured":
        keep = scenes.textured_city(runner, n_buildings=600)
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


def raster_cases(groups, D, OD):
    """K1 / K2 cases: label -> (this, other, args, kwargs, binned)."""
    cases = {}
    flat = capture("flat")
    if "K1" in groups:
        rep = capture("representative")
        msaa = capture("representative", samples=4, occlusion=True)
        c_tris, c_planes, c_binned, c_wp, c_hp, floor, strict = rep["raster_count"]
        b_tris, b_planes, b_binned, b_wp, b_hp, bnd = rep["raster_bound"]
        m = msaa["raster_sample"]
        k1 = (D.raster_resolve, OD.raster_resolve)
        cases["K1 opaque (flat)"] = (*k1, flat["raster_resolve"], {}, flat["raster_resolve"][2])
        cases["K1 MSAA offset (representative, 4 samples)"] = (*k1, m[:5], {"sofs": m[5]}, m[2])
        cases["K1 count (representative, first peel)"] = (
            *k1, (c_tris, c_planes, c_binned, c_wp, c_hp), {"count_floor": floor, "count_strict": strict}, c_binned,
        )
        cases["K1 bound (representative, first later peel)"] = (
            *k1, (b_tris, b_planes, b_binned, b_wp, b_hp), {"bound": bnd}, b_binned,
        )
    if "K2" in groups:
        feat = capture("features", occlusion=True)
        k2 = (D.raster_depth, OD.raster_depth)
        cases["K2 (flat, 2048² map)"] = (*k2, flat["raster_depth"], {}, flat["raster_depth"][1])
        cases["K2 (features, map rebuilt for a new pose)"] = (*k2, feat["raster_depth"], {}, feat["raster_depth"][1])
    return cases


def p1_cases(PB, OPB):
    """P1 cases: label -> (this, other, args, kwargs, library call)."""
    import numpy as np
    import torch

    from rend3_tpu_torch.tools import probe_bf16_dot, probe_bf16_kernel

    cases = {}
    for r, (_name, kw) in zip(probe_bf16_dot.run("cuda", log=lambda _line: None), probe_bf16_dot.VARIANTS):
        a, b = r.args["a"], r.args["b"]
        kw = {"bf16": kw.get("bf16", True), "transposed": kw.get("transposed", False)}
        lib = (lambda a=a, b=b: torch.matmul(a, b)) if kw["transposed"] else (lambda a=a, b=b: torch.matmul(a.T, b))
        cases[f"P1 {r.name}"] = (PB.probe_dot, OPB.probe_dot, (a, b), kw, lib)
    # The f32 variant's shape at other contraction depths: what the time
    # owes to each staged row and what it owes to launch, staging and stores.
    rng = np.random.RandomState(1)
    for k in (8, 36, 128):
        a, b = (torch.from_numpy(rng.rand(k, n).astype(np.float32)).cuda() for n in (512, 1024))
        cases[f"P1 f32 K = {k} (random operands)"] = (PB.probe_dot, OPB.probe_dot, (a, b), {"bf16": False},
                                                      lambda a=a, b=b: torch.matmul(a.T, b))
    v1 = probe_bf16_kernel.variant(0, np.random.RandomState(0), "cuda")
    t, y = v1.args["t"], v1.args["y"]
    cases["P1 P2 v1's dense dot (bf16)"] = (PB.probe_dot, OPB.probe_dot, (t, y), {"bf16": True},
                                            lambda: torch.matmul(t.T, y))
    return cases


def k5_case(S, OS):
    import torch

    args = capture("textured", occlusion=True)["gather"]
    img, bx, by, valid, offs = args
    dx = torch.tensor([o[0] for o in offs], device=bx.device, dtype=torch.long)
    dy = torch.tensor([o[1] for o in offs], device=bx.device, dtype=torch.long)
    label = f"K5 Hi-Z taps (textured, {bx.numel()} queries, atlas {tuple(img.shape)})"
    return {label: (S.sample_grid, OS.sample_grid, args, {},
                    lambda: img[by.long()[:, None] + dy, bx.long()[:, None] + dx])}


def ptxas(log, pattern):
    """Registers, spill store and load bytes and static shared bytes of the
    kernels whose (demangled) name matches `pattern`, from an nvcc -Xptxas
    -v log."""
    names = re.findall(r"Compiling entry function '([^']+)'", log)
    filt = shutil.which("c++filt")
    if filt and names:
        plain = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True).stdout.split("\n")
        names_map = dict(zip(names, plain))
    else:
        names_map = {n: n for n in names}
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = names_map.get(m.group(1), m.group(1))
            cur = cur if re.search(pattern, cur) else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(cur, {}).update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out.setdefault(cur, {}).update(registers=int(m.group(1)), smem=int(smem.group(1)) if smem else 0)
    return out


def ctas_per_sm(registers, smem, threads):
    """Resident CTAs per SM of the H100 (sm_90): at most 32 CTAs and 64
    warps, 65,536 registers allocated 256 a warp, 233,472 bytes of shared
    memory with 1,024 reserved a CTA."""
    warps = -(-threads // 32)
    reg_warp = -(-registers * 32 // 256) * 256
    by_regs = (65536 // reg_warp) // warps if registers else 32
    by_smem = 233472 // (smem + 1024)
    return min(32, 64 // warps, by_regs, by_smem)


# Threads a CTA of P1's and K5's kernels: this tree's, and their earlier
# design's (the commit before their redesign), for the other tree's
# occupancy estimate.
THREADS = {"this": 128, "other": 256}


def log_kernels(this_ck, other_ck):
    """ptxas and runtime numbers of P1's and K5's kernels, both trees."""
    for label, ck in (("this", this_ck), ("other", other_ck)):
        ck.build(verbose=True)
        t = THREADS[label]
        for group, pattern in (("P1", r"dot_kernel"), ("K5", r"gather_kernel")):
            # This tree's P1 stages K = 72 rows of 96 floats in dynamic shared memory.
            dyn = 72 * 96 * 4 if label == "this" and group == "P1" else 0
            for name, info in ptxas(ck.last_build["log"], pattern).items():
                est = ctas_per_sm(info.get("registers", 0), info.get("smem", 0) + dyn, t)
                cs.log(f"{label} {group} {name}: {json.dumps(info)}, {t} threads, {dyn} dynamic shared bytes: "
                       f"{est} CTAs per SM by the occupancy rules")
    for i, name in enumerate(this_ck.P1_INSTANCES):
        cs.log(f"this P1 dot_kernel {name} (runtime, K = 72): {json.dumps(this_ck.kernel_info('p1_kernel_info', i, 72))}")
    cs.log(f"this K5 gather_kernel, 4 taps (runtime): {json.dumps(this_ck.kernel_info('k5_kernel_info', 4))}")


def main(argv):
    import torch

    if not argv or any(g not in GROUPS for g in argv[1:]):
        raise SystemExit(__doc__.split("\n\n")[1])
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA device")
    from rend3_tpu_torch.ops import cuda_kernels, deferred, probe_bf16, samplers

    groups = argv[1:] or GROUPS
    load_other(argv[0])
    OD, OPB, OS, OCK = (importlib.import_module(f"rend3_other.ops.{m}")
                        for m in ("deferred", "probe_bf16", "samplers", "cuda_kernels"))
    cases = {}
    if "K1" in groups or "K2" in groups:
        cases.update((k, v[:4] + (None, v[4])) for k, v in raster_cases(groups, deferred, OD).items())
    if "P1" in groups:
        cases.update((k, v + (None,)) for k, v in p1_cases(probe_bf16, OPB).items())
    if "K5" in groups:
        cases.update((k, v + (None,)) for k, v in k5_case(samplers, OS).items())
    if "P1" in groups or "K5" in groups:
        log_kernels(cuda_kernels, OCK)
    results = {}
    for label, (fn, other_fn, args, kw, lib, binned) in cases.items():
        outs = []
        for f in (fn, other_fn):
            out = f(*args, **kw)
            outs.append(out if isinstance(out, tuple) else (out,))
        for a, b in zip(*outs):
            a, b = getattr(a, "data", a), getattr(b, "data", b)
            if not cs._same_with_nan(a, b):
                raise AssertionError(f"{label}: this tree's kernel and the other's differ")
        t = [cs._graph_ms(lambda g=g: g(*args, **kw)) for g in (other_fn, fn, fn, other_fn)]
        results[label] = {"other_ms": (t[0] + t[3]) / 2, "this_ms": (t[1] + t[2]) / 2, "turns_ms": t}
        if lib is not None:
            results[label]["library_ms"] = cs._graph_ms(lib)
        if binned is not None:
            results[label]["lists"] = lists(binned)
        cs.log(f"{label}: {json.dumps(results[label])}")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": cs.nvidia_smi_line(), "cases": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
