"""Time this tree's kernels against other trees' on the same inputs.

    python3 kernel_ab.py OTHER_DIR [OTHER_DIR ...] [K1 K2 P1 K5 K6 K7 P2 P3 F1 D1 C1]

Each OTHER_DIR holds another tree: another commit's, for example the
parent's, unpacked with `git archive` into the ignored `_checkout/`, or a
copy of this one with a constant changed (a design variant). Its
rend3_tpu_torch package is imported under another name, so it builds its
own kernels into its own `_build/` and launches them through its own
wrappers
(`ops.deferred.raster_resolve` and `raster_depth`, `ops.probe_bf16.probe_dot`,
`ops.samplers.sample_grid`, `ops.raster_binned.rasterize_binned`,
`ops.shadow.occlusion_from_lists`), whatever its kernels' C interface; P2
and P3 run as raw launches through the tree's own `ops.cuda_kernels.call`
(P3's wrapper reads the device on the host, so no CUDA graph takes it), on
the C interface of P2 and P3, unchanged since their port; F1 through
`ops.fp.fma32`, `dot3` and `ab_minus_cd` (a tree without F1 runs its
float64 emulation there); D1 as a raw launch through the tree's own
`ops.lighting.launch_args` and `ops.cuda_kernels.call`, its arguments
prepared once; C1 likewise through the tree's own
`ops.lighting.peel_launch_args`. The groups named (all eleven by default)
choose the cases. The inputs come from
this tree on the card, as chip_smoke.py makes them, at 1920x1080:

- K1 opaque and K2 (the 2048² map) from the flat city after a building
  moved; K1's count and bound modes from the representative frame's first
  cutout or blend peels (occlusion off); K1 at an MSAA offset from the
  representative frame at 4 samples; K2 on the feature city's shadow map
  rebuilt for a new pose;
- P1 on the four variants of tools.probe_bf16_dot and the dense dot of
  tools.probe_bf16_kernel v1 (K = 72 or 128, M = 512, N = 1024), and on
  random f32 operands of that shape at K = 8, 36 and 128;
- K5 on the Hi-Z test of the textured city's second occlusion-on frame;
- K6 at 1 and 4 samples on the representative frame's opaque clipped
  table (chip_smoke.py phase 7's inputs);
- K7 on the rect lists and K8 on the light-cell lists of light 0 of the
  representative frame (phase 8's inputs; the frame that builds the
  shadow maps, occlusion off), and K7 again on the rect lists with the 4
  longest lists emptied (what the longest tiles cost);
- P2's reduce on v2's inputs (n = 1,024, accumulated) and at n = 1,000,
  with `torch.einsum` as its library call;
- P3 on its timed input (the full bf16 variant of tools.probe_bf16_real
  from zeros, as chip_smoke.py phase 11 times it) and in its 128-lane-sum
  variant (bf16 no-ohx-lerp), on testing.probe_lerp_stress_case (x-lerp
  without and with init steps, the 128-lane sum without), and on P2 v3's
  (one step of 128-lane sums over 4,096 pixels) and v7's (bf16) inputs;
- F1 at the representative frame's largest call of each form from
  ops/texture.py (the cutout alpha test's texture query),
  ops/transform.py (the clip transform) and ops/geometry.py (setup), with
  torch.addcmul(c, a, b) as the fma's library call;
- D1 on the representative frame's opaque G-buffer and its blend pixels
  (occlusion on), and on the flat city's opaque G-buffer (untextured, one
  map);
- C1 on the representative frame's first cutout peel (occlusion on), at 1
  sample and at sample 0 of 4.

Every tree's outputs must equal this tree's bit for bit (NaN at the same
places; K7 and K8 at hit pixels, the only ones where their values are
defined). Device times: chip_smoke._graph_ms (20 calls in one CUDA graph,
replayed between CUDA events), in turns other, this, this, other for each
other tree; for P1, K5 and P2 also
their library call's (torch.matmul; advanced indexing; torch.einsum). For
P1 and K5 it
prints each tree's ptxas lines (registers, spills, shared memory) and
resident CTAs per SM: this tree's from the CUDA runtime, the others' from
ptxas's registers and shared memory by the occupancy rules of the H100
(both ways for this tree, as a check). Prints each case as it goes, then
one JSON object: per case this tree's mean device ms over all its turns,
each other tree's mean device ms, this tree's beside it and the four
turns, the library call's ms, and the lists' size for K1 / K2 / K6 / K7 /
K8. For K6-K8 and P2 / P3 it also prints this tree's registers, spills,
shared memory and CTAs per SM from the CUDA runtime, and every tree's
ptxas lines.
"""

import functools
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
GROUPS = ("K1", "K2", "P1", "K5", "K6", "K7", "P2", "P3", "F1", "D1", "C1")


def load_other(root, name="rend3_other"):
    """Another tree's package, imported as `name`."""
    pkg = os.path.join(os.path.abspath(root), "rend3_tpu_torch")
    spec = importlib.util.spec_from_file_location(name, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def capture(scene, samples=1, occlusion=False, frames=2):
    """`captured` of a second frame of `scene` on the card: after a
    building moved (flat), a new pose (features), or unchanged; with
    frames=1 of the first frame (which builds the shadow maps)."""
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

    if frames == 1:
        graph.captured = {}
        frame()
        del keep
        return graph.captured
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


# A case: label -> (ops module, function, args, kwargs, library call, lists,
# mask of the values compared); each tree's ops.<module>.<function> runs it.


def raster_cases(groups):
    """K1 / K2 cases."""
    cases = {}
    flat = capture("flat")
    if "K1" in groups:
        rep = capture("representative")
        msaa = capture("representative", samples=4, occlusion=True)
        c_tris, c_planes, c_binned, c_wp, c_hp, floor, strict = rep["raster_count"]
        b_tris, b_planes, b_binned, b_wp, b_hp, bnd = rep["raster_bound"]
        m = msaa["raster_sample"]
        k1 = ("deferred", "raster_resolve")
        cases["K1 opaque (flat)"] = (*k1, flat["raster_resolve"], {}, None, flat["raster_resolve"][2], None)
        cases["K1 MSAA offset (representative, 4 samples)"] = (*k1, m[:5], {"sofs": m[5]}, None, m[2], None)
        cases["K1 count (representative, first peel)"] = (
            *k1, (c_tris, c_planes, c_binned, c_wp, c_hp), {"count_floor": floor, "count_strict": strict}, None,
            c_binned, None,
        )
        cases["K1 bound (representative, first later peel)"] = (
            *k1, (b_tris, b_planes, b_binned, b_wp, b_hp), {"bound": bnd}, None, b_binned, None,
        )
    if "K2" in groups:
        feat = capture("features", occlusion=True)
        k2 = ("deferred", "raster_depth")
        cases["K2 (flat, 2048² map)"] = (*k2, flat["raster_depth"], {}, None, flat["raster_depth"][1], None)
        cases["K2 (features, map rebuilt for a new pose)"] = (*k2, feat["raster_depth"], {}, None,
                                                              feat["raster_depth"][1], None)
    return cases


def p1_cases():
    """P1 cases."""
    import numpy as np
    import torch

    from rend3_tpu_torch.tools import probe_bf16_dot, probe_bf16_kernel

    cases = {}
    for r, (_name, kw) in zip(probe_bf16_dot.run("cuda", log=lambda _line: None), probe_bf16_dot.VARIANTS):
        a, b = r.args["a"], r.args["b"]
        kw = {"bf16": kw.get("bf16", True), "transposed": kw.get("transposed", False)}
        lib = (lambda a=a, b=b: torch.matmul(a, b)) if kw["transposed"] else (lambda a=a, b=b: torch.matmul(a.T, b))
        cases[f"P1 {r.name}"] = ("probe_bf16", "probe_dot", (a, b), kw, lib, None, None)
    # The f32 variant's shape at other contraction depths: what the time
    # owes to each staged row and what it owes to launch, staging and stores.
    rng = np.random.RandomState(1)
    for k in (8, 36, 128):
        a, b = (torch.from_numpy(rng.rand(k, n).astype(np.float32)).cuda() for n in (512, 1024))
        cases[f"P1 f32 K = {k} (random operands)"] = ("probe_bf16", "probe_dot", (a, b), {"bf16": False},
                                                      lambda a=a, b=b: torch.matmul(a.T, b), None, None)
    v1 = probe_bf16_kernel.variant(0, np.random.RandomState(0), "cuda")
    t, y = v1.args["t"], v1.args["y"]
    cases["P1 P2 v1's dense dot (bf16)"] = ("probe_bf16", "probe_dot", (t, y), {"bf16": True},
                                            lambda: torch.matmul(t.T, y), None, None)
    return cases


def k5_case():
    import torch

    args = capture("textured", occlusion=True)["gather"]
    img, bx, by, valid, offs = args
    dx = torch.tensor([o[0] for o in offs], device=bx.device, dtype=torch.long)
    dy = torch.tensor([o[1] for o in offs], device=bx.device, dtype=torch.long)
    label = f"K5 Hi-Z taps (textured, {bx.numel()} queries, atlas {tuple(img.shape)})"
    return {label: ("samplers", "sample_grid", args, {},
                    lambda: img[by.long()[:, None] + dy, bx.long()[:, None] + dx], None, None)}


# F1's cases: (form, fp's function, the call site's file in the package).
F1_SITES = (("fma", "fma32", "ops/texture.py"), ("fma_dot3", "dot3", "ops/transform.py"),
            ("fma_ab_minus_cd", "ab_minus_cd", "ops/geometry.py"))


def f1_cases():
    """F1 at the largest call of a form from each of F1_SITES' files, as
    fp.capture records them over the representative frame's two frames
    (occlusion on); torch.addcmul(c, a, b) beside the fma."""
    import torch

    from rend3_tpu_torch.ops import fp

    fp.capture = {}
    try:
        capture("representative", occlusion=True)
    finally:
        sites, fp.capture = fp.capture, None
    cases = {}
    for form, fname, prefix in F1_SITES:
        site, xs = max(((s, xs) for (f, s), xs in sites.items() if f == form and s.startswith(prefix)),
                       key=lambda c: torch.broadcast_shapes(*(x.shape for x in c[1])).numel())
        lib = (lambda a=xs[0], b=xs[1], c=xs[2]: torch.addcmul(c, a, b)) if form == "fma" else None
        shape = tuple(torch.broadcast_shapes(*(x.shape for x in xs)))
        cases[f"F1 {form} at {site} {shape}"] = ("fp", fname, xs, {}, lib, None, None)
    return cases


def d1_raw(pkg):
    """D1 in package `pkg` as a raw launch: light_gbuffer's arguments (this
    tree's, its ShadowMaps rebuilt as the package's) turned into the C
    arguments once a call site, then only the launch."""
    import torch

    lighting = importlib.import_module(f"{pkg}.ops.lighting")
    ck = importlib.import_module(f"{pkg}.ops.cuda_kernels")
    prepared = {}

    def run(*args):
        if id(args[0]) not in prepared:
            shadows = args[6]
            if shadows is not None and not isinstance(shadows, torch.Tensor):
                shadows = lighting.ShadowMaps(*shadows)
            a = (*args[:6], shadows, *args[7:])
            prepared[id(args[0])] = lighting.launch_args(*a, lighting.light_tensors(*a[2:5]))
        tensors, ints = prepared[id(args[0])]
        ck.call("d1_deferred_shade", *tensors, ints=ints)
        return tensors[2]

    return run


def d1_cases():
    """D1 on the representative frame's opaque G-buffer and blend pixels
    (occlusion on) and on the flat city's opaque G-buffer."""
    rep = capture("representative", occlusion=True)
    flat = capture("flat")
    return {f"D1 {label}": ("lighting", d1_raw, cap[key], {}, None, None, None)
            for label, cap, key in (("representative, opaque", rep, "deferred_shade"),
                                    ("representative, blend pixels", rep, "deferred_shade_blend"),
                                    ("flat city, opaque", flat, "deferred_shade"))}


def c1_raw(pkg):
    """C1 in package `pkg` as a raw launch: a captured peel's arguments
    turned into the C arguments once a case (the G-buffer a copy it writes
    the same pixels of at every call), then only the launch. Returns the
    G-buffer, done and bound."""
    lighting = importlib.import_module(f"{pkg}.ops.lighting")
    ck = importlib.import_module(f"{pkg}.ops.cuda_kernels")
    prepared = {}

    def run(gc, gbuf, floor, done, materials, textures, active, _extras):
        if id(gc) not in prepared:
            prepared[id(gc)] = lighting.peel_launch_args(gc, gbuf.clone(), floor, done, materials, textures, active)
        tensors, ints = prepared[id(gc)]
        ck.call("c1_cutout_peel", *tensors, ints=ints)
        return tensors[1], tensors[4], tensors[5]

    return run


def c1_cases():
    """C1 on the representative frame's first cutout peel (occlusion on), at
    1 sample and at sample 0 of 4."""
    return {f"C1 {label}": ("lighting", c1_raw, capture("representative", samples=s, occlusion=True)["cutout_peel"],
                            {}, None, None, None)
            for label, s in (("representative, first peel", 1), ("representative at 4 samples, sample 0", 4))}


def emptied(lists, k):
    """CSR lists with the k longest lists emptied."""
    import torch

    from rend3_tpu_torch.ops.geometry import BinnedTris

    lens = lists.offsets[1:] - lists.offsets[:-1]
    top = torch.argsort(lens, descending=True)[:k]
    keep = torch.ones(lists.ids.numel(), dtype=torch.bool, device=lens.device)
    for t in top.tolist():
        keep[int(lists.offsets[t]):int(lists.offsets[t + 1])] = False
    lens = lens.clone()
    lens[top] = 0
    offs = torch.zeros_like(lists.offsets)
    offs[1:] = torch.cumsum(lens, 0)
    return BinnedTris(offsets=offs, ids=lists.ids[keep].contiguous())


def vis_occ_cases(groups):
    """K6 / K7 / K8 cases on the representative frame."""
    from rend3_tpu_torch import probe_shadow
    from rend3_tpu_torch.ops import geometry as G
    from rend3_tpu_torch.ops import raster as R
    from rend3_tpu_torch.ops import shadow as SH

    cap = capture("representative", frames=1)
    cases = {}
    if "K6" in groups:
        clip, valid, front_cw, width, height = cap["opaque_table"]
        wp, hp = -(-width // G.TILE_W) * G.TILE_W, -(-height // G.TILE_H) * G.TILE_H
        for label, offs in (("1 sample", R.CENTER_OFFSET), ("4 samples", R.MSAA4_OFFSETS)):
            tris = G.cull_and_setup(clip, valid, width, height, cull_mode=G.CullMode.BACK, front_is_cw=front_cw,
                                    subpixel=len(offs) == 1)
            binned = G.bin_triangles(tris, wp, hp, tile_h=G.TILE_H, tile_w=G.TILE_W)
            cases[f"K6 {label} (representative)"] = ("raster_binned", "rasterize_binned",
                                                     (tris, binned, wp, hp, offs), {}, None, binned, None)
    if "K7" in groups:
        stris, sx, sy, hit, width, height, size = probe_shadow.inputs(cap)[:7]
        h = hit[None].expand(SH.N_OFF, -1, -1)
        rects = SH.rect_lists(stris, sx, sy, hit, width, height)
        for label, lists, lt in (("K7 rect lists", rects, False),
                                 ("K8 light-cell lists", SH.cell_lists(stris, sx, sy, hit, width, height, size), True),
                                 ("K7 rect lists, the 4 longest emptied", emptied(rects, 4), False)):
            cases[f"{label} (representative, light 0)"] = (
                "shadow", "occlusion_from_lists", (stris, lists, sx, sy, hit, width, height), {"lt_form": lt}, None,
                lists, h,
            )
    return cases


def probe_cases(groups):
    """P2 / P3 cases (raw launches)."""
    import numpy as np
    import torch

    from rend3_tpu_torch import testing
    from rend3_tpu_torch.ops import probe_bf16 as pb
    from rend3_tpu_torch.tools import probe_bf16_kernel, probe_bf16_real

    cases = {}
    if "P2" in groups:
        v2 = probe_bf16_kernel.variant(1, np.random.RandomState(0), "cuda")
        r2 = pb.probe_dot(v2.args["t"], v2.args["y"], bf16=True)
        rng = np.random.RandomState(5)
        for label, (r, x, acc) in (
            ("v2's inputs, n = 1024, accumulated", (r2, v2.args["x"], 1)),
            ("n = 1000, written", tuple(torch.from_numpy(rng.rand(k, 1000).astype(np.float32)).cuda()
                                        for k in (512, 128)) + (0,)),
        ):
            n = r.shape[1]
            out = torch.zeros(pb.OUT_ROWS, n, device="cuda")
            cases[f"P2 reduce ({label})"] = (
                None, functools.partial(cs.raw_launch, "p2_probe_reduce", (r, x, out), (n, acc), 2), (), {},
                lambda r=r, x=x: torch.einsum("jp,cjp->cp", x, r.view(4, 128, r.shape[1])), None, None,
            )
    if "P3" in groups:
        def lerp_case(a):
            a = {"coords": None, **a, "out": torch.zeros_like(a["out"])}
            return (None, functools.partial(cs.raw_launch, "p3_probe_lerp", *pb.lerp_launch_args(**a), 6), (), {},
                    None, None, None)

        for name, kw in (("full bf16", {}), ("bf16 no-ohx-lerp", {"ohx_lerp": False})):
            cases[f"P3 {name} (probe input, from zeros)"] = lerp_case(
                dict(probe_bf16_real.build(name, "cuda", **kw).args))
        for label, kw in (("x-lerp bf16, no init step", dict(init_steps=False)),
                          ("x-lerp bf16, init steps", {}),
                          ("128-lane sum bf16, no init step", dict(xlerp=False, init_steps=False))):
            cases[f"P3 stress ({label}, from zeros)"] = lerp_case(testing.probe_lerp_stress_case("cuda", **kw))
        rng = np.random.RandomState(0)
        runs = [probe_bf16_kernel.variant(k, rng, "cuda") for k in range(len(probe_bf16_kernel.VARIANTS))]
        for k in (2, 6):
            cases[f"P3's kernel on P2 {runs[k].name} (from zeros)"] = lerp_case(dict(runs[k].args))
    return cases


def log_probe_kernels(this_ck, others):
    """P2's and P3's kernels: this tree's runtime numbers, every tree's
    ptxas lines (others: [(dir, cuda_kernels module)])."""
    for i, name in enumerate(this_ck.P23_INSTANCES):
        cs.log(f"this {name} (runtime): {json.dumps(this_ck.kernel_info('p23_kernel_info', i))}")
    for label, ck in [("this", this_ck)] + others:
        ck.build(verbose=True)
        for name, info in ptxas(ck.last_build["log"], r"reduce_kernel|lerp_kernel").items():
            cs.log(f"{label} {name}: {json.dumps(info)}")


def log_vis_occ_kernels(this_ck, others):
    """K6's and K7 / K8's kernels: this tree's runtime numbers, every
    tree's ptxas lines (others: [(dir, cuda_kernels module)])."""
    for name in this_ck.RASTER_INSTANCES[5:]:
        cs.log(f"this {name} (runtime): "
               f"{json.dumps(this_ck.kernel_info('raster_kernel_info', this_ck.RASTER_INSTANCES.index(name)))}")
    for i, name in enumerate(this_ck.OCC_INSTANCES):
        cs.log(f"this {name} (runtime): {json.dumps(this_ck.kernel_info('occ_kernel_info', i))}")
    for label, ck in [("this", this_ck)] + others:
        ck.build(verbose=True)
        for name, info in ptxas(ck.last_build["log"], r"vis_kernel|occ_kernel").items():
            cs.log(f"{label} {name}: {json.dumps(info)}")


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
# design's (the commit before their redesign), for the other trees'
# occupancy estimate.
THREADS = {"this": 128, "other": 256}


def log_kernels(this_ck, others):
    """ptxas and runtime numbers of P1's and K5's kernels, every tree
    (others: [(dir, cuda_kernels module)])."""
    for label, ck in [("this", this_ck)] + others:
        ck.build(verbose=True)
        t = THREADS["this" if label == "this" else "other"]
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

    dirs = [a for a in argv if a not in GROUPS]
    if not dirs:
        raise SystemExit(__doc__.split("\n\n")[1])
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA device")
    from rend3_tpu_torch.ops import cuda_kernels

    groups = [a for a in argv if a in GROUPS] or GROUPS
    others = [(d, load_other(d, f"rend3_other{i}").__name__) for i, d in enumerate(dirs)]
    cases = {}
    if "K1" in groups or "K2" in groups:
        cases.update(raster_cases(groups))
    if "P1" in groups:
        cases.update(p1_cases())
    if "K5" in groups:
        cases.update(k5_case())
    if "K6" in groups or "K7" in groups:
        cases.update(vis_occ_cases(groups))
    if "P2" in groups or "P3" in groups:
        cases.update(probe_cases(groups))
    if "F1" in groups:
        cases.update(f1_cases())
    if "D1" in groups:
        cases.update(d1_cases())
    if "C1" in groups:
        cases.update(c1_cases())
    other_cks = [(d, importlib.import_module(f"{pkg}.ops.cuda_kernels")) for d, pkg in others]
    if "P1" in groups or "K5" in groups:
        log_kernels(cuda_kernels, other_cks)
    if "K6" in groups or "K7" in groups:
        log_vis_occ_kernels(cuda_kernels, other_cks)
    if "P2" in groups or "P3" in groups:
        log_probe_kernels(cuda_kernels, other_cks)
    for group, pattern in (("D1", r"d1_kernel"), ("C1", r"c1_kernel")):
        if group in groups:
            for label, ck in [("this", cuda_kernels)] + other_cks:
                ck.build(verbose=True)
                for name, info in ptxas(ck.last_build["log"], pattern).items():
                    cs.log(f"{label} {group} {name}: {json.dumps(info)}")

    def outputs(f, args, kw, mask):
        out = f(*args, **kw)
        out = out if isinstance(out, tuple) else (out,)
        out = [getattr(a, "data", a) for a in out]
        return [a.clone() for a in out] if mask is None else [a[mask] for a in out]

    def function(pkg, mod, fname):
        """A case's function in package `pkg`: ops.<mod>.<fname>, or what
        fname(pkg) makes (a raw launch)."""
        return fname(pkg) if callable(fname) else getattr(importlib.import_module(f"{pkg}.ops.{mod}"), fname)

    results = {}
    for label, (mod, fname, args, kw, lib, binned, mask) in cases.items():
        fn = function("rend3_tpu_torch", mod, fname)
        ref = outputs(fn, args, kw, mask)
        res = {"others": {}}
        this_turns = []
        for d, pkg in others:
            other_fn = function(pkg, mod, fname)
            if not all(cs._same_with_nan(a, b) for a, b in zip(outputs(other_fn, args, kw, mask), ref)):
                raise AssertionError(f"{label}: this tree's kernel and {d}'s differ")
            t = [cs._graph_ms(lambda g=g: g(*args, **kw)) for g in (other_fn, fn, fn, other_fn)]
            res["others"][d] = {"ms": (t[0] + t[3]) / 2, "this_ms": (t[1] + t[2]) / 2, "turns_ms": t}
            this_turns += t[1:3]
        res["this_ms"] = sum(this_turns) / len(this_turns)
        if lib is not None:
            res["library_ms"] = cs._graph_ms(lib)
        if binned is not None:
            res["lists"] = lists(binned)
        results[label] = res
        cs.log(f"{label}: {json.dumps(res)}")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": cs.nvidia_smi_line(), "cases": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
