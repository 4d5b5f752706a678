"""The PyTorch port's CUDA kernels against their plain versions on the card.

These need a CUDA device (and nvcc to build csrc/); without one they skip.
On the card, where jax is not installed, skip the suite's conftest:
python -m pytest tests/test_torch_cuda.py --noconftest -q. Each kernel runs
on the same inputs as its plain version; tolerance: K1's depth, hit and
material channels and all of K2 bit-exact, the other K1 channels within
1 ulp, K3 abs <= 1e-6, K4 and K5 bit-exact (random queries, including
footprints off the grid and invalid ones; K5 also at every tap count
1..12, on and past the last row and column, at q = 0 and on -0.0 texels). K1's count mode (strict and not)
and bound mode run on inputs captured from scenes.peel_slice, with the
counts bit-exact too. K1 at an MSAA sample offset as in its opaque mode.
K6 (raster_scene's visibility raster) at 1 and 4 samples: ids and depth
bit-exact. K7 and K8 on light 0 of the captured city frame: bit-exact at
hit pixels (their values elsewhere are not defined). The bf16 probes P1-P3
(every variant of tools.probe_bf16_*): bit-exact, NaN positions equal, and
for P2 and P3 again on zero-initialised outputs, which hold values; P1
also at K 1, 72, 128 and 130 on 100 x 333 and 100 x 332 outputs, both
layouts of a, f32 and bf16; P3 on testing.probe_lerp_stress_case (a list
longer than the kernel's compaction round, an empty list, init steps
mid-list or none, most pixels owned) in both modes, f32 and bf16, from NaN
and from zeros; P2's reduce at n = 1024, 1000 and 77, written and added. K4
on the skybox query of a 64x64 skybox frame at 4 samples: bit-exact.
K1 in every mode and K2 on testing.raster_stress_case (lists longer than
the kernels' 128-entry staging chunk and K2's 128-entry segment,
equal-depth duplicates across quarter-tile, chunk and ballot boundaries,
edges on pixel centres): as above, and K2 bit-exact at two offsets; K6 on
its 8x128 tables at 1 and 4 samples: ids and depth bit-exact. K7 and K8 on
testing.shadow_stress_case (a list over several segments, casters of depth
0, tiles with no hit pixel or an empty list, a tile hit in part):
bit-exact at hit pixels. A K1 launch that cannot be made raises, and so
does a K7 launch given too small a plan buffer. The app layer: the
overlay's device pass against its host compositor on the card (within 1
u8), and testing.make_test_gltf()'s animated scene (three poses through
framework.start) on the card against the CPU (within 1 u8). The reference
forward backend: rasterize card = CPU bit for bit, the forward frame card
vs CPU within 1 u8, K5 through shadow.sample_shadow_map(s) bit-exact. Row
bands: K1 in every mode at a band's first row (row0 = 32 and 64 of the
stress soup, through the band front end) bit for bit against its plain
version, and 4-band local-mesh frames on the card (the textured, cutout and
blend scene; the mip-mapped floor at 4 samples) bit for bit against the
card's one-device frame; with two or more cards, one NCCL rank a card,
bit for bit against the one-device frame (skips on one card). F1, the
float32 fma forms (fp.fma32, ab_minus_cd, dot3; csrc/fma.cu): one launch
each, bit for bit against the float64 emulation with NaN positions equal,
on testing.fma_stress_case at 2^24 rows, on broadcast (a 0-d input, (V, 1,
3) against (V, 3, 1), _shadow_coords' (rows, 1, 1) x (1, H, W)), strided
(select, the clip transform's matrix columns), unaligned (roll) and
odd-length inputs, and an input reaching past 2^31 elements; an empty output launches nothing; the profiler sees one
kernel and no float64 tensor is made; a failed launch raises. S1 and S2,
the shadow pass's front end (ops/shadow_front.py; csrc/shadow_front.cu):
against shadow_front_plain on the representative city's shadow pass and
on testing.shadow_front_case's soups (crossing, all crossing, no caster,
and 200,000 triangles, many CTAs appending to one counter), rows in slot
order bit for bit, tile offsets and each tile's list as a set; K2 on
their tables against K2 on the PyTorch chain's, bit for bit; the graph's
shadow pass twice in the same buffers; a moved frame counts
shadow_front.maps 2 and one sync::shadow_front.totals read, a static one
0; a refused S1 launch raises. V1-V4, the view's front end
(ops/view_front.py; csrc/view_front.cu): against the plain version on
testing.view_front_case's sets (the near-clip soup, under a Hi-Z pyramid,
a row band, without the sub-pixel cull, nothing visible, one triangle, no
triangle, 200,000 triangles), every table bit for bit and in order; each
call site (main, residual, cutout, blend) of a 1080p city frame likewise;
and the frame itself against the PyTorch chain's on the card, bit for bit.
D1, the deferred shade (ops/lighting.py; csrc/deferred_shade.cu), against
its plain version on the card: on testing.deferred_shade_case's G-buffers
(every flag and packing, precomputed factors, no texture, no shadow plan)
within D1_REL where powf rounds apart, and on the 1080p representative
frame (opaque G-buffer, blend pixels, sample 0 at MSAA 4, and untextured
with no plan) bit for bit; shade.gbuffers counts 2 G-buffers a city frame
(8 at 4 samples); a refused D1 launch raises. C1, the cutout alpha test of
a peel (ops/lighting.py cutout_peel_step; csrc/deferred_shade.cu), against
its plain version on the card: on
testing.cutout_peel_case's peels at 128x72 and at a 1920x1088 peel, three
chained, and again with passed pixels tested in later peels (which shows a
kernel reading the opaque depth from the G-buffer it writes), gbuf, done,
bound and the count bit for bit; the 1080p representative frame at 1 and
4 samples through C1 bit for bit against the frame through the chain, with
its counters and spans; a registered cutout routine's frame through C1
(the routine's verdict computed before it) against the chain; a refused
C1 launch raises.
"""

import numpy as np
import pytest
import torch

from rend3_tpu_torch import framework, probe_shadow, scenes, testing
from rend3_tpu_torch.ops import blit
from rend3_tpu_torch.ops import deferred as D
from rend3_tpu_torch.ops import fp
from rend3_tpu_torch.ops import geometry as G
from rend3_tpu_torch.ops import lighting
from rend3_tpu_torch.ops import raster as R
from rend3_tpu_torch.ops import raster_binned as RB
from rend3_tpu_torch.ops import samplers as S
from rend3_tpu_torch.ops import shadow as SH
from rend3_tpu_torch.ops import shadow_front as SF
from rend3_tpu_torch.overlay import OverlayRoutine, PaintJob
from rend3_tpu_torch.routine.base import BaseRenderGraphSettings, FrameRenderTarget, raster_scene
from rend3_tpu_torch.testing import FrameRenderSettings, TestRunner, shadow_front_chain
from rend3_tpu_torch.utils import math as m3
from rend3_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def captured():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    runner = TestRunner(device="cuda")
    keep = scenes.build_city_scene(runner, n_buildings=48, seed=7, representative=False)
    scenes.set_bench_camera(runner, 512, 256)
    runner.base_graph.captured = {}
    runner.renderer.swap_instruction_buffers()
    img = runner.base_graph.render_frame(
        runner.renderer.evaluate_instructions(), FrameRenderTarget(512, 256, 1),
        BaseRenderGraphSettings(ambient_color=(0.08, 0.08, 0.1, 1.0)),
    )
    del keep
    return runner.base_graph.captured, img


def test_k1_matches_plain(captured):
    tris, planes, binned, wp, hp = captured[0]["raster_resolve"]
    k = D.raster_resolve(tris, planes, binned, wp, hp).data
    p = D.raster_resolve_plain(tris, planes, binned, wp, hp)
    for ch in (D.G_DEPTH, D.G_HIT, D.G_MAT):
        assert torch.equal(k[ch], p[ch])
    np.testing.assert_array_max_ulp(k.cpu().numpy(), p.cpu().numpy(), maxulp=1)


@pytest.fixture(scope="module")
def peel_captured():
    """K1's peel-mode inputs captured from scenes.peel_slice on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    runner = TestRunner(device="cuda")
    keep = scenes.peel_slice(runner)
    runner.base_graph.captured = {}
    runner.render_frame(FrameRenderSettings(size=256))
    del keep
    return runner.base_graph.captured


def _k1_modes_match(k, p, kc=None, pc=None):
    for ch in (D.G_DEPTH, D.G_HIT, D.G_MAT):
        assert torch.equal(k[ch], p[ch])
    np.testing.assert_array_max_ulp(k.cpu().numpy(), p.cpu().numpy(), maxulp=1)
    if kc is not None:
        assert torch.equal(kc, pc)


def test_k1_count_mode_matches_plain(peel_captured):
    tris, planes, binned, wp, hp, floor, strict = peel_captured["raster_count"]
    for s in (strict, not strict):
        kg, kc = D.raster_resolve(tris, planes, binned, wp, hp, count_floor=floor, count_strict=s)
        pg, pc = D.raster_resolve_plain(tris, planes, binned, wp, hp, count_floor=floor, count_strict=s)
        _k1_modes_match(kg.data, pg, kc, pc)
        assert int(kc.max()) >= 1


def test_k1_bound_mode_matches_plain(peel_captured):
    tris, planes, binned, wp, hp, bound = peel_captured["raster_bound"]
    _k1_modes_match(
        D.raster_resolve(tris, planes, binned, wp, hp, bound=bound).data,
        D.raster_resolve_plain(tris, planes, binned, wp, hp, bound=bound),
    )


def test_k1_at_an_msaa_offset_matches_plain(captured):
    tris, planes, binned, wp, hp = captured[0]["raster_resolve"]
    sofs = R.MSAA4_OFFSETS[1]
    k = D.raster_resolve(tris, planes, binned, wp, hp, sofs=sofs).data
    p = D.raster_resolve_plain(tris, planes, binned, wp, hp, sofs=sofs)
    _k1_modes_match(k, p)
    assert not torch.equal(k[D.G_HIT], D.raster_resolve(tris, planes, binned, wp, hp).data[D.G_HIT])


@pytest.mark.parametrize("offsets", [R.CENTER_OFFSET, R.MSAA4_OFFSETS], ids=["1", "4"])
def test_k6_matches_plain(captured, offsets):
    clip, valid, front_cw, width, height = captured[0]["opaque_table"]
    tris = G.cull_and_setup(clip, valid, width, height, cull_mode=G.CullMode.BACK, front_is_cw=front_cw,
                            subpixel=len(offsets) == 1)
    binned = G.bin_triangles(tris, width, height, tile_h=G.TILE_H, tile_w=G.TILE_W)
    k = RB.rasterize_binned(tris, binned, width, height, offsets)
    p = RB.rasterize_binned_plain(tris, binned, width, height, offsets)
    assert k.tri.shape == (len(offsets), height, width)
    assert torch.equal(k.tri, p.tri) and torch.equal(k.depth, p.depth)
    assert float((k.tri >= 0).float().mean()) > 0.5
    v = raster_scene(clip, valid, width, height, cull_mode=G.CullMode.BACK, front_is_cw=front_cw,
                     sample_offsets=offsets)
    assert torch.equal(v.tri, k.tri) and torch.equal(v.depth, k.depth)


def test_k7_k8_match_plain(captured):
    stris, sx, sy, hit, width, height, size = probe_shadow.inputs(captured[0])[:7]
    h = hit[None].expand(SH.N_OFF, -1, -1)
    k7 = SH.shadow_occlusion(stris, sx, sy, hit, width, height)
    k8, overflow = SH.shadow_occlusion_lt(stris, sx, sy, hit, width, height, size)
    assert int(overflow) == 0
    assert torch.equal(k7[h], SH.shadow_occlusion_plain(stris, sx, sy, hit)[h])
    assert torch.equal(k8[h], SH.shadow_occlusion_lt_plain(stris, sx, sy, hit)[h])
    assert int((k8[h] > 0).sum()) > 0


def test_k2_matches_plain(captured):
    stris, sbinned, swp, shp = captured[0]["raster_depth"]
    assert torch.equal(D.raster_depth(stris, sbinned, swp, shp), D.raster_depth_plain(stris, sbinned, swp, shp))


def test_k3_matches_plain(captured):
    args = lighting.chain_inputs(*captured[0]["deferred_shade"])["pcf5"]
    err = (S.sample_grid_pcf5(*args) - S.sample_grid_pcf5_plain(*args)).abs().max()
    assert float(err) <= 1e-6


def _k4_inputs(seed, q=20000, ah=300, aw=260):
    """Random K4 queries, some with a footprint off the atlas or invalid."""
    g = torch.Generator().manual_seed(seed)
    atlas = torch.rand(ah, aw, 4, generator=g).to(torch.bfloat16)
    bx = torch.randint(-3, aw + 3, (q,), generator=g, dtype=torch.int32)
    by = torch.randint(-3, ah + 3, (q,), generator=g, dtype=torch.int32)
    fx, fy, wt = (torch.rand(q, generator=g) for _ in range(3))
    valid = torch.rand(q, generator=g) > 0.2
    return [t.cuda() for t in (atlas, bx, by, fx, fy, wt, valid)]


def test_k4_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _k4_inputs(4)
    k = S.sample_grid_bilinear(*args)
    p = S.sample_grid_bilinear_plain(*args)
    assert k.shape == (4, args[1].numel())
    assert torch.equal(k, p)
    assert bool((k == 0).all(0)[~args[-1]].all())  # invalid queries read 0


# A 12-tap list in [-2, 2]^2 whose first n taps make the case of n taps.
K5_TAPS = ((0, 0), (1, 0), (0, 1), (1, 1), (-1, 0), (0, -1), (2, 2), (-2, 1), (1, -2), (2, -1), (-1, -1), (0, 2))
K5_CASES = {
    "hiz": (((0, 0), (1, 0), (0, 1), (1, 1)), 30000),
    "pcf5": (S.PCF5_OFFSETS, 30000),
    **{f"taps{n}": (K5_TAPS[:n], 30001) for n in range(1, 13)},
    "q0": (K5_TAPS[:4], 0),
    "edges": (K5_TAPS, None),
}


@pytest.mark.parametrize("case", list(K5_CASES))
def test_k5_matches_plain(case):
    """K5 bit for bit against its plain version: random queries (q not a
    multiple of the 128-thread CTA) with base texels and taps off the image
    and invalid queries, or q = 0, or ("edges") every base texel from one
    outside the first row / column to one outside the last, each valid and
    invalid; a fifth of the texels are -0.0, which must read +0.0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    offsets, q = K5_CASES[case]
    g = torch.Generator().manual_seed(5)
    hs, ws = 200, 150
    img = torch.randn(hs, ws, generator=g)
    img[torch.rand(hs, ws, generator=g) < 0.2] = -0.0
    if q is None:
        xs, ys = torch.meshgrid(torch.tensor([-1, 0, 1, ws - 2, ws - 1, ws]), torch.tensor([-1, 0, 1, hs - 2, hs - 1, hs]),
                                indexing="ij")
        bx, by = (v.reshape(-1).repeat(2).to(torch.int32) for v in (xs, ys))
        valid = torch.arange(bx.numel()) < bx.numel() // 2
    else:
        bx = torch.randint(-10, ws + 10, (q,), generator=g, dtype=torch.int32)
        by = torch.randint(-10, hs + 10, (q,), generator=g, dtype=torch.int32)
        valid = torch.rand(q, generator=g) > 0.2
    args = [t.cuda() for t in (img, bx, by, valid)]
    k = S.sample_grid(*args, offsets)
    assert k.shape == (len(offsets), bx.numel())
    assert torch.equal(k, S.sample_grid_plain(*args, offsets))
    assert not bool((torch.signbit(k) & (k == 0)).any())  # -0.0 reads +0.0
    if bx.numel():
        assert bool((k != 0).any())


def test_card_frame_matches_cpu(captured):
    runner = TestRunner(device="cpu")
    keep = scenes.build_city_scene(runner, n_buildings=48, seed=7, representative=False)
    scenes.set_bench_camera(runner, 512, 256)
    runner.renderer.swap_instruction_buffers()
    img = runner.base_graph.render_frame(
        runner.renderer.evaluate_instructions(), FrameRenderTarget(512, 256, 1),
        BaseRenderGraphSettings(ambient_color=(0.08, 0.08, 0.1, 1.0)),
    )
    del keep
    assert int(np.abs(img.astype(np.int32) - captured[1].astype(np.int32)).max()) <= 1


# P1 on its own inputs: contraction K (130 runs two 128-row chunks), M x N
# off the 32 x 64 tile (N = 333 reads element by element, 332 16 bytes at
# a time), a (K, M) or (M, K) read transposed, f32 or bf16 operands.
P1_CASES = [f"dot-K{k}-{m}x{n}-{layout}-{dt}" for k in (1, 72, 128, 130) for m, n in ((100, 333), (100, 332))
            for layout in ("km", "mk") for dt in ("f32", "bf16")]


@pytest.mark.parametrize("probe", ["probe_bf16_dot", "probe_bf16_kernel", "probe_bf16_real"] + P1_CASES)
def test_probe_kernels_match_plain(probe):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import importlib

    from rend3_tpu_torch.ops import probe_bf16 as pb

    if probe.startswith("dot-"):
        _d, k, mn, layout, dt = probe.split("-")
        K, (M, N) = int(k[1:]), map(int, mn.split("x"))
        rng = np.random.RandomState(K * 7 + M + N)
        a = torch.from_numpy(rng.randn(*((M, K) if layout == "mk" else (K, M))).astype(np.float32)).cuda()
        b = torch.from_numpy(rng.randn(K, N).astype(np.float32)).cuda()
        kw = dict(bf16=dt == "bf16", transposed=layout == "mk")
        out = pb.probe_dot(a, b, **kw)
        assert out.shape == (M, N)
        assert torch.equal(out, pb.probe_dot_plain(a, b, **kw))
        assert bool((out != 0).all())
        return
    mod = importlib.import_module(f"rend3_tpu_torch.tools.{probe}")
    # As the entry point runs it (NaN-initialised), and for P2 and P3 again
    # from zeros, where the variants that add into an output they never
    # write first give values.
    for init in ("nan", "zero") if probe != "probe_bf16_dot" else ("nan",):
        kw = {"init": init} if probe != "probe_bf16_dot" else {}
        for r in mod.run("cuda", log=lambda _line: None, **kw):
            p = r.plain()
            nan = torch.isnan(r.out)
            assert torch.equal(nan, torch.isnan(p)), (r.name, init)
            assert torch.equal(r.out[~nan], p[~nan]), (r.name, init)
            if init == "zero" or probe == "probe_bf16_dot":
                assert bool((r.out[~nan] != 0).any()), (r.name, init)


# P3 on testing.probe_lerp_stress_case: (bf16, x-lerp, init steps, initial output).
LERP_STRESS = {
    f"{'xlerp' if xl else 'lanesum'}-{'bf16' if bf else 'f32'}-{'init' if ini else 'noinit'}-{init}":
        (bf, xl, ini, init)
    for xl in (True, False) for bf in (True, False) for ini in (True, False) for init in ("nan", "zero")
}


@pytest.mark.parametrize("case", list(LERP_STRESS))
def test_p3_stress_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rend3_tpu_torch.ops import probe_bf16 as pb

    bf16, xlerp, init_steps, init = LERP_STRESS[case]
    a = testing.probe_lerp_stress_case("cuda", bf16=bf16, xlerp=xlerp, init_steps=init_steps, init=init)
    k, p = pb.probe_lerp(**a), pb.probe_lerp_plain(**a)
    nan = torch.isnan(k)
    assert torch.equal(nan, torch.isnan(p)) and torch.equal(k[~nan], p[~nan])
    if init == "nan" and not init_steps:
        assert bool(nan.all())  # no init step: every value stays NaN
    else:
        assert bool((k[~nan] != 0).any()) and (init == "nan") == bool(nan.any())


# P2's reduce at widths its 32-column CTAs divide and do not, written or added.
@pytest.mark.parametrize("n", [1024, 1000, 77])
@pytest.mark.parametrize("accumulate", [False, True], ids=["write", "accumulate"])
def test_p2_reduce_matches_plain(n, accumulate):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rend3_tpu_torch.ops import probe_bf16 as pb

    rng = np.random.RandomState(n)
    r2, x = (torch.from_numpy(rng.rand(rows, n).astype(np.float32)).cuda() for rows in (512, 128))
    out = torch.full((pb.OUT_ROWS, n), float("nan"), device="cuda")
    out[:2] = torch.from_numpy(rng.rand(2, n).astype(np.float32)).cuda()
    k, p = pb.probe_reduce(r2, x, out, accumulate=accumulate), pb.probe_reduce_plain(r2, x, out, accumulate=accumulate)
    nan = torch.isnan(k)
    assert torch.equal(nan, torch.isnan(p)) and torch.equal(k[~nan], p[~nan])
    assert int((~nan).sum()) == (4 if not accumulate else 2) * n


def test_k4_skybox_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    runner = TestRunner(device="cuda")
    keep = scenes.skybox_cube(runner)
    runner.base_graph.captured = {}
    runner.renderer.swap_instruction_buffers()
    runner.base_graph.render_frame(
        runner.renderer.evaluate_instructions(), FrameRenderTarget(64, 64, 4), skybox_slot=keep[-1].idx
    )
    args = runner.base_graph.captured["bilinear_sky"]
    assert runner.base_graph.last_stats["sky_k4_launches"] == 1 and int(args[-1].sum()) > 0
    assert torch.equal(S.sample_grid_bilinear(*args), S.sample_grid_bilinear_plain(*args))
    del keep


@pytest.fixture(scope="module")
def stress():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return testing.raster_stress_case("cuda")


K1_MODES = {
    "opaque": {},
    "msaa_offset": {"sofs": R.MSAA4_OFFSETS[1]},
    "bound": {"bound": True},
    "count": {"floor": True},
    "count_strict": {"floor": True, "strict": True},
    "bound_count_strict": {"bound": True, "floor": True, "strict": True},
}


@pytest.mark.parametrize("mode", list(K1_MODES))
def test_k1_stress_matches_plain(stress, mode):
    m = K1_MODES[mode]
    c = stress
    kw = dict(
        sofs=m.get("sofs", (0.5, 0.5)), bound=c["bound"] if m.get("bound") else None,
        count_floor=c["floor"] if m.get("floor") else None, count_strict=bool(m.get("strict")),
    )
    args = (c["tris"], c["planes"], c["binned"], c["width"], c["height"])
    k, p = D.raster_resolve(*args, **kw), D.raster_resolve_plain(*args, **kw)
    if m.get("floor"):
        _k1_modes_match(k[0].data, p[0], k[1], p[1])
        assert int(k[1].max()) >= 2
    else:
        _k1_modes_match(k.data, p)
    # Duplicates (material 100 + row) win where they tie their originals.
    if not m.get("bound"):
        g = k[0].data if m.get("floor") else k.data
        assert int((g[D.G_MAT] >= 100).sum()) > 0


BAND_H = 64


@pytest.fixture(scope="module")
def band_stress():
    """The stress soup's row bands [row0, row0 + 64) for row0 = 32 and 64,
    through the port's band front end (cull_and_setup(y_range=),
    bin_triangles(y0=)) on the card, with peel images from the plain K1's
    band (its depth at hit pixels, 0 or -1 elsewhere, a third random)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    clip, planes = testing.raster_stress_input(0)
    c = torch.from_numpy(clip).cuda()
    rng = np.random.default_rng(5)
    out = {}
    for row0 in (32, 64):
        tris = G.cull_and_setup(
            c, torch.ones(c.shape[0], dtype=torch.bool, device="cuda"), testing.STRESS_W, testing.STRESS_H,
            cull_mode=G.CullMode.NONE, front_is_cw=True, subpixel=True, y_range=(row0, row0 + BAND_H),
        )
        pl = torch.from_numpy(planes).cuda()[tris.src].contiguous()
        binned = G.bin_triangles(tris, testing.STRESS_W, BAND_H, tile_h=D.DTILE_H, tile_w=D.DTILE_W, y0=row0)
        g0 = D.raster_resolve_plain(tris, pl, binned, testing.STRESS_W, BAND_H, y0=row0)
        depth, hit = g0[D.G_DEPTH].cpu().numpy(), (g0[D.G_HIT] > 0).cpu().numpy()
        noise = rng.random(depth.shape) < 0.33
        rand = rng.uniform(0.0, 0.7, depth.shape).astype(np.float32)
        bound = np.where(noise, rand, np.where(hit, depth, 0.0)).astype(np.float32)
        floor = np.where(noise, rand, np.where(hit, depth, -1.0)).astype(np.float32)
        out[row0] = dict(tris=tris, planes=pl, binned=binned, bound=torch.from_numpy(bound).cuda(),
                         floor=torch.from_numpy(floor).cuda())
    return out


@pytest.mark.parametrize("row0", [32, 64])
@pytest.mark.parametrize("mode", list(K1_MODES))
def test_k1_band_offset_matches_plain(band_stress, mode, row0):
    """K1 at a band's first row (row0 != 0) in every mode against its plain
    version on the same band tables: the whole G-buffer and the counts bit
    for bit, and the band launch counted as such."""
    m = K1_MODES[mode]
    c = band_stress[row0]
    kw = dict(
        sofs=m.get("sofs", (0.5, 0.5)), bound=c["bound"] if m.get("bound") else None,
        count_floor=c["floor"] if m.get("floor") else None, count_strict=bool(m.get("strict")), y0=row0,
    )
    args = (c["tris"], c["planes"], c["binned"], testing.STRESS_W, BAND_H)
    before = D.launches["raster_band"]
    k, p = D.raster_resolve(*args, **kw), D.raster_resolve_plain(*args, **kw)
    assert D.launches["raster_band"] == before + 1
    if m.get("floor"):
        assert torch.equal(k[0].data, p[0]) and torch.equal(k[1], p[1])
        g = k[0].data
    else:
        assert torch.equal(k.data, p)
        g = k.data
    assert int((g[D.G_HIT] > 0).sum()) > 0


@pytest.mark.parametrize("case", ["textured-cutout-blend", "mipmapped-floor-msaa4"])
def test_card_bands_match_card_frame(case):
    """A 4-band local-mesh frame on the card equals the card's one-device
    frame bit for bit (two frames: all predicted, then the carried mask),
    and its bands launch K1 at their first rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rend3_tpu_torch.parallel.tiles import build_tiled_frame_callable, device_mesh

    build, w, h, samples = {
        "textured-cutout-blend": (scenes.band_features, 128, 64, 1),
        "mipmapped-floor-msaa4": (scenes.mipmapped_floor, 64, 64, 4),
    }[case]
    runner = TestRunner(device="cuda")
    keep = build(runner)
    graph = runner.base_graph
    target = FrameRenderTarget(w, h, samples)
    imgs = {}
    for mode in ("bands", "single"):
        graph._prev_visible_mask = None
        imgs[mode] = []
        for _ in range(2):
            runner.renderer.swap_instruction_buffers()
            ev = runner.renderer.evaluate_instructions()
            if mode == "bands":
                before = D.launches["raster_band"]
                program, args = build_tiled_frame_callable(graph, ev, target, mesh=device_mesh(4))
                imgs[mode].append(program(*args)[0].cpu().numpy())
                assert D.launches["raster_band"] > before
            else:
                imgs[mode].append(graph.render_frame(ev, target))
    for a, b in zip(imgs["bands"], imgs["single"]):
        np.testing.assert_array_equal(a, b)
    del keep


def test_nccl_ranks_match_one_device(tmp_path):
    """With two or more cards, one NCCL rank a card (the most of 8, 4, 2
    that the cards allow; testing.run_band_ranks, processes joined with a
    timeout of their own) renders the textured, cutout and blend scene in
    row bands, two frames; every rank's image and carried mask equal the
    one-device frame's on cuda:0 bit for bit."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices (one NCCL rank a card)")
    world = max(w for w in (8, 4, 2) if w <= n)
    runner = TestRunner(device="cuda:0")
    keep = scenes.band_features(runner)
    single = []
    for _ in range(2):
        runner.renderer.swap_instruction_buffers()
        img = runner.base_graph.render_frame(
            runner.renderer.evaluate_instructions(), FrameRenderTarget(*testing.BAND_RANK_SIZE)
        )
        single.append((img, runner.base_graph._prev_visible_mask.cpu().numpy()))
    for got in testing.run_band_ranks(str(tmp_path), world, "cuda:{rank}"):
        for k, (img, mask) in enumerate(single):
            np.testing.assert_array_equal(got["imgs"][k], img)
            np.testing.assert_array_equal(got["masks"][k], mask)
    del keep


@pytest.mark.parametrize("sofs", [(0.5, 0.5), R.MSAA4_OFFSETS[2]], ids=["centre", "msaa"])
def test_k2_stress_matches_plain(stress, sofs):
    c = stress
    args = (c["tris"], c["binned"], c["width"], c["height"])
    k = D.raster_depth(*args, sofs=sofs)
    assert torch.equal(k, D.raster_depth_plain(*args, sofs=sofs))
    assert int((k > 0).sum()) > 0


@pytest.mark.parametrize("samples", [1, 4])
def test_k6_stress_matches_plain(stress, samples):
    vt, vb = stress["vis"][samples]
    offsets = R.CENTER_OFFSET if samples == 1 else R.MSAA4_OFFSETS
    k = RB.rasterize_binned(vt, vb, stress["width"], stress["height"], offsets)
    p = RB.rasterize_binned_plain(vt, vb, stress["width"], stress["height"], offsets)
    assert torch.equal(k.tri, p.tri) and torch.equal(k.depth, p.depth)
    assert int((k.tri >= 0).sum()) > 0


@pytest.fixture(scope="module")
def shadow_stress():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return testing.shadow_stress_case("cuda")


@pytest.mark.parametrize("kernel", ["k7", "k8"])
def test_k7_k8_stress_match_plain(shadow_stress, kernel):
    c = shadow_stress
    lt = kernel == "k8"
    args = (c["tris"], c["sx"], c["sy"], c["hit"])
    k = SH.occlusion_from_lists(c["tris"], c["cells" if lt else "rects"], *args[1:], c["width"], c["height"],
                                lt_form=lt)
    p = (SH.shadow_occlusion_lt_plain if lt else SH.shadow_occlusion_plain)(*args)
    h = c["hit"][None].expand(SH.N_OFF, -1, -1)
    assert torch.equal(k[h], p[h])
    assert int((k[h] > 0).sum()) > 0


def test_k7_small_plan_raises(shadow_stress):
    """The kernel refuses a plan buffer too small for its segments."""
    from rend3_tpu_torch.ops import cuda_kernels

    c = shadow_stress
    lists = c["rects"]
    out = torch.empty(SH.N_OFF, c["height"], c["width"], device="cuda")
    plan = torch.empty(3, dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="k7_shadow_occ: CUDA error"):
        cuda_kernels.call("k7_shadow_occ", c["tris"].setup, c["tris"].bbox, lists.offsets, lists.ids, c["sx"], c["sy"],
                          c["hit"], out, plan, ints=(c["width"], c["height"], 0, lists.ids.numel(), plan.numel()))


def test_k1_launch_failure_raises():
    """A K1 launch that cannot be made (a 4,194,304 x 524,288 target has
    2^29 tiles, so 2^31 quarter-tile CTAs, more than a grid may hold)
    raises instead of leaving the output unwritten."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rend3_tpu_torch.ops import cuda_kernels

    t = torch.zeros(64, dtype=torch.float32, device="cuda")
    i = torch.zeros(64, dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="k1_raster_resolve: CUDA error"):
        cuda_kernels.call("k1_raster_resolve", t, t, t, i, i, t, None, None, None,
                          ints=(128 << 15, 32 << 14, 0, 0), floats=(0.5, 0.5))


def _overlay_jobs(ov):
    """A translucent panel wider than the window raster, a textured quad and
    a fractional-vertex triangle with a clip rect."""
    tex = np.zeros((8, 8, 4), np.uint8)
    tex[:, :4] = [0, 255, 0, 200]
    tex[:, 4:] = [255, 255, 0, 90]
    tid = ov.add_texture(tex)
    quad = np.array([[0, 1, 2], [2, 3, 0]], np.uint32)
    return [
        PaintJob(vertices=np.array([[4, 4], [300, 4], [300, 120], [4, 120]], np.float32),
                 colors=np.tile(np.array([30, 30, 40, 180], np.uint8), (4, 1)), indices=quad),
        PaintJob(vertices=np.array([[16, 8], [80, 8], [80, 40], [16, 40]], np.float32),
                 colors=np.tile(np.array([255, 200, 255, 255], np.uint8), (4, 1)), indices=quad,
                 uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32), texture=tid),
        PaintJob(vertices=np.array([[50.3, 60.1], [140.7, 71.9], [63.2, 118.6]], np.float32),
                 colors=np.array([[255, 0, 0, 200], [0, 255, 0, 120], [0, 0, 255, 255]], np.uint8),
                 indices=np.array([[0, 1, 2]], np.uint32), clip_rect=(55.0, 62.5, 130.0, 110.0)),
    ]


def test_overlay_device_pass_matches_host_compositor_on_card():
    """The overlay's bake and device pass on the card against its host
    compositor on the card (within 1 u8), and the card's host compositor
    against the CPU's (within 1 u8); the band form equals the full pass."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    W, H = 320, 128
    frame = np.random.default_rng(11).integers(0, 256, size=(H, W, 4), dtype=np.uint8)
    ov = OverlayRoutine(device="cuda")
    jobs = _overlay_jobs(ov)
    host = ov.render(frame, jobs)
    dev = ov.device_pass(jobs, W, H)(torch.from_numpy(frame).cuda(), None, None, 0)
    assert dev.is_cuda and dev.dtype == torch.uint8
    dev = dev.cpu().numpy()
    assert np.abs(dev.astype(int) - host.astype(int)).max() <= 1
    band = ov.device_pass(jobs, W, H)(torch.from_numpy(frame[64:].copy()).cuda(), None, None, 64).cpu().numpy()
    np.testing.assert_array_equal(band, dev[64:])
    cpu = OverlayRoutine(device="cpu")
    assert np.abs(host.astype(int) - cpu.render(frame, _overlay_jobs(cpu)).astype(int)).max() <= 1


def test_gltf_scene_on_card_matches_cpu():
    """testing.make_test_gltf() posed at three times through framework.start
    on the card and on the CPU: every frame within 1 u8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    imgs = {dev: framework.start(testing.GltfAnimationApp(), 160, 96, frames=3,
                                 frame_dt=testing.TEST_GLTF_DURATION / 2, device=dev)
            for dev in ("cuda", "cpu")}
    for a, b in zip(imgs["cuda"], imgs["cpu"]):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert not np.array_equal(imgs["cuda"][0], imgs["cuda"][1])


def test_reference_path_on_card_matches_cpu(monkeypatch):
    """The reference forward backend: rasterize on a perspective soup
    (MSAA 4) card = CPU bit for bit; the forward frame of scenes.peel_slice
    at 64x64 on the card within 1 u8 of the CPU; sample_shadow_map and
    sample_shadow_maps (K5) on the card bit for bit against their plain
    version on the CPU, one K5 launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(4)
    w = rng.uniform(0.5, 2.0, (64, 3, 1)).astype(np.float32)
    soup = np.concatenate([rng.uniform(-1.2, 1.2, (64, 3, 2)).astype(np.float32) * w,
                           rng.uniform(0.0, 1.0, (64, 3, 1)).astype(np.float32) * w, w], axis=2)
    clip, valid = torch.from_numpy(soup), torch.ones(64, dtype=torch.bool)
    a = R.rasterize(clip.cuda(), valid.cuda(), 192, 128, cull_mode=R.CullMode.NONE, sample_offsets=R.MSAA4_OFFSETS)
    b = R.rasterize(clip, valid, 192, 128, cull_mode=R.CullMode.NONE, sample_offsets=R.MSAA4_OFFSETS)
    assert torch.equal(a.tri.cpu(), b.tri) and torch.equal(a.depth.cpu().view(torch.int32), b.depth.view(torch.int32))
    monkeypatch.setenv("REND3_TPU_RASTER", "reference")
    imgs = []
    for dev in ("cuda", "cpu"):
        runner = TestRunner(device=dev)
        keep = scenes.peel_slice(runner)
        imgs.append(runner.render_frame(FrameRenderSettings(size=64)))
        del keep
    assert np.abs(imgs[0].astype(int) - imgs[1].astype(int)).max() <= 1
    maps = [torch.from_numpy(rng.uniform(0.0, 1.0, (s, s)).astype(np.float32)) for s in (128, 64)]
    entries = [(mi, torch.from_numpy(rng.uniform(-3.0, 131.0, (32, 128)).astype(np.float32)),
                torch.from_numpy(rng.uniform(-3.0, 131.0, (32, 128)).astype(np.float32)),
                torch.from_numpy(rng.random((32, 128)) > 0.2)) for mi in (0, 1, 0)]
    before = S.launches["gather"]
    k0, _ = SH.sample_shadow_map(maps[0].cuda(), *(t.cuda() for t in entries[0][1:]))
    ks, _ = SH.sample_shadow_maps([m.cuda() for m in maps], [(mi, *(t.cuda() for t in e)) for mi, *e in entries])
    assert S.launches["gather"] == before + 2
    assert torch.equal(k0.cpu(), SH.sample_shadow_map(maps[0], *entries[0][1:])[0])
    for k, p in zip(ks, SH.sample_shadow_maps(maps, entries)[0]):
        assert torch.equal(k.cpu(), p)


# -- F1: the float32 fma forms (csrc/fma.cu) ------------------------------------

F1_FORMS = ("fma", "fma_ab_minus_cd", "fma_dot3")
F1_PUBLIC = {"fma": fp.fma32, "fma_ab_minus_cd": fp.ab_minus_cd, "fma_dot3": fp.dot3}
F1_PLAIN = {"fma": fp.fma32_plain, "fma_ab_minus_cd": fp.ab_minus_cd_plain, "fma_dot3": fp.dot3_plain}


def _f1_same(got, want, label):
    """Bit for bit as int32 patterns, NaN positions equal (payloads free)."""
    assert got.shape == want.shape and got.dtype == torch.float32 and got.is_contiguous(), label
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), f"{label}: NaN positions differ"
    bad = (got.view(torch.int32) != want.contiguous().view(torch.int32)) & ~nan
    assert not bool(bad.any()), f"{label}: {int(bad.sum())} of {got.numel()} values differ"


def _f1_check(form, xs, label, launches=1):
    before = fp.launches[form]
    got = F1_PUBLIC[form](*xs)
    torch.cuda.synchronize()
    assert fp.launches[form] == before + launches, label
    _f1_same(got, F1_PLAIN[form](*xs), label)
    return got


@pytest.mark.parametrize("form", F1_FORMS)
def test_f1_stress_matches_plain(form):
    """testing.fma_stress_case at 2^24 rows, one launch, bit for bit
    against the float64 emulation on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xs = [torch.from_numpy(x).cuda() for x in testing.fma_stress_case(form, 1 << 24, seed=11)]
    _f1_check(form, xs, f"{form} stress")


def _f1_layout(case, n_in, rng):
    """n_in inputs of one layout case on the card, values from rng."""
    def t(*shape):
        return torch.from_numpy(np.array(rng.standard_normal(shape) * 4.0, dtype=np.float32)).cuda()

    if case == "0-d":  # one 0-d input among (1000,) ones, then all 0-d
        return [t() if k == 1 else t(1000) for k in range(n_in)]
    if case == "all 0-d":
        return [t() for _ in range(n_in)]
    if case == "(V, 1, 3) x (V, 3, 1)":
        return [t(777, 1, 3) if k % 2 == 0 else t(777, 3, 1) for k in range(n_in)]
    if case == "shadow_coords":  # (rows, 1, 1) x (1, H, W), then (rows, H, W)
        return [t(4, 1, 1) if k % 3 == 0 else t(1, 270, 480) if k % 3 == 1 else t(4, 270, 480) for k in range(n_in)]
    if case == "select":  # strided columns of (N, 3) and (3, N)
        return [t(5001, 3).select(1, k % 3) if k % 2 == 0 else t(3, 5001).select(0, k % 3) for k in range(n_in)]
    if case == "roll":  # contiguous but 4 bytes past a 16-byte boundary, and a strided column
        return [torch.roll(t(4097), 1, 0)[1:] if k % 2 == 0 else t(4096, 2)[:, 1] for k in range(n_in)]
    if case == "clip columns":  # the clip transform's m[:, None, :, k] x p[:, :, None, k]
        m, q = t(3001, 4, 4), t(3001, 3, 3)
        return [m[:, None, :, k // 2 % 3] if k % 2 == 0 else q[:, :, None, k // 2 % 3] for k in range(n_in)]
    if case == "contiguous, n % 4 = 3":
        return [t(1_000_003) for _ in range(n_in)]
    if case == "7 dims, broadcast in 4":
        return [t(2, 3, 2, 5, 1, 7, 4) if k % 2 == 0 else t(2, 1, 2, 1, 1, 7, 1) for k in range(n_in)]
    raise ValueError(case)


F1_LAYOUTS = ("0-d", "all 0-d", "(V, 1, 3) x (V, 3, 1)", "shadow_coords", "select", "roll",
              "contiguous, n % 4 = 3", "7 dims, broadcast in 4", "clip columns")


@pytest.mark.parametrize("form", F1_FORMS)
@pytest.mark.parametrize("case", F1_LAYOUTS)
def test_f1_layouts_match_plain(form, case):
    """Broadcast, strided, unaligned and odd-length inputs: one launch,
    bit for bit against the emulation, output contiguous."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3 * F1_LAYOUTS.index(case) + F1_FORMS.index(form))
    xs = _f1_layout(case, testing.FMA_ARITY[form], rng)
    _f1_check(form, xs, f"{form} {case}")


@pytest.mark.parametrize("form", F1_FORMS)
def test_f1_empty_launches_nothing(form):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xs = [torch.ones(0, 3, device="cuda") for _ in range(testing.FMA_ARITY[form])]
    got = _f1_check(form, xs, f"{form} empty", launches=0)
    assert got.shape == (0, 3)


@pytest.mark.parametrize("n", [2049, 2048])
def test_f1_wide_index_matches_plain(n):
    """An input whose reach passes 2^31 elements (every (2^20 + 513)th of
    an 8 GiB buffer) takes a 64-bit instance: the strided one at 2,049
    elements, rows of four at 2,048."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    base = torch.empty(2**31 + 2**22, dtype=torch.float32, device="cuda")
    a = base[:: 2**20 + 513][:n]
    assert (n - 1) * a.stride(0) >= 2**31
    a.copy_(torch.from_numpy(np.random.default_rng(2).standard_normal(a.numel()).astype(np.float32)).cuda())
    b, c = torch.full_like(a, 1.5), torch.full_like(a, -0.25)
    _f1_check("fma", [a, b, c], "fma wide index")


@pytest.mark.parametrize("form", F1_FORMS)
def test_f1_one_launch_no_float64(form):
    """On CUDA tensors each form is one device kernel, F1's, and makes no
    float64 tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xs = [torch.from_numpy(x).cuda() for x in testing.fma_stress_case(form, 4096, seed=3)]
    F1_PUBLIC[form](*xs)  # built and loaded before the trace
    kernels, (dtypes,) = testing.f1_call_trace([(F1_PUBLIC[form], xs)])
    assert len(kernels) == 1 and f"_kernel<{fp._FORMS[form]}" in kernels[0], kernels
    assert torch.float64 not in dtypes and set(dtypes) <= {torch.float32}, dtypes


def test_f1_launch_failure_raises(monkeypatch):
    """A failed F1 launch (here a form code the kernel refuses) raises
    from fp.fma32 and does not run the emulation instead."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def no_emulation(*args):
        raise AssertionError("the emulation ran on the card")

    monkeypatch.setitem(fp._FORMS, "fma", 7)
    monkeypatch.setattr(fp, "fma32_plain", no_emulation)
    x = torch.ones(16, device="cuda")
    before = fp.launches["fma"]
    with pytest.raises(RuntimeError, match="f1_fma: CUDA error"):
        fp.fma32(x, x, x)
    assert fp.launches["fma"] == before


# -- S1 / S2, the shadow pass's front end (csrc/shadow_front.cu) ---------------


@pytest.fixture(scope="module")
def shadow_city():
    """A 512x256 frame of the representative city (48 buildings, maps of
    2048 and 1024 texels) on the card: (runner, its shadow pass's inputs,
    the frame's captures, the objects)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    runner = TestRunner(device="cuda")
    keep = scenes.build_city_scene(runner, n_buildings=48, seed=7, representative=True)
    scenes.set_bench_camera(runner, 512, 256)
    runner.base_graph.captured = {}
    runner.renderer.swap_instruction_buffers()
    runner.base_graph.render_frame(runner.renderer.evaluate_instructions(), FrameRenderTarget(512, 256, 1),
                                   BaseRenderGraphSettings(ambient_color=(0.08, 0.08, 0.1, 1.0)))
    objects = [h for h in keep if getattr(h, "kind", None) == "object"]
    return runner, runner.base_graph._last_shadow_call[1], runner.base_graph.captured, objects, keep


def _front_args(inputs):
    plan, cw, transforms, light_vp, vis, _p, _v, tri_obj, _b, tri_pos = inputs
    return [s for _l, _o, s in plan], cw, SF.light_mvp(transforms, light_vp, len(plan)), vis, tri_pos, tri_obj


def _front_inputs(case, shadow_city):
    if case == "city":
        return shadow_city[1]
    return testing.shadow_front_case(case, device="cuda", seed=5)


@pytest.mark.parametrize("case", ("city",) + testing.SHADOW_FRONT_KINDS)
def test_s1_s2_match_plain(shadow_city, case):
    """S1 and S2 against shadow_front_plain on the card: each map's rows
    in slot order bit for bit (S_ID, src and flip too), the tile offsets,
    and each tile's list as a set. "stress": 200,000 triangles, many CTAs'
    appends to one counter; a CTA's 256 threads append up to 4 slots
    each."""
    args = _front_args(_front_inputs(case, shadow_city))
    before = dict(SF.launches)
    got = SF.shadow_front(SF.ShadowFrontBuffers(), *args)
    assert {k: SF.launches[k] - before[k] for k in before} == {"shadow_setup": 1, "shadow_tiles": 2}
    want = SF.shadow_front_plain(*args)
    assert testing.shadow_front_diff(got, want) == []
    if case != "none":
        assert all(g.tris.count > 100 for g in got)
    if case == "stress":
        assert got[0].tris.count > 50_000 and bool((got[0].tris.src % SF.SLOTS > 0).any())


@pytest.mark.parametrize("case", ("city", "soup", "all_crossing", "stress"))
def test_shadow_front_maps_match_chain(shadow_city, case):
    """K2 on S1 / S2's tables against K2 on the PyTorch chain's tables, on
    the card and on the same inputs: every map bit for bit."""
    inputs = _front_inputs(case, shadow_city)
    got = SF.shadow_front(SF.ShadowFrontBuffers(), *_front_args(inputs))
    for g, (tris, binned, w, h) in zip(got, shadow_front_chain(*inputs)):
        assert tris.count == g.tris.count
        k = D.raster_depth(g.tris, g.binned, g.width, g.height)
        c = D.raster_depth(tris, binned, w, h)
        assert torch.equal(k.view(torch.int32), c.view(torch.int32)) and (k > 0).sum() > 100


def test_shadow_pass_on_card_matches_chain_and_keeps_its_buffers(shadow_city):
    """The graph's shadow pass (S1 / S2, then K2) twice on the city: both
    times the chain's maps bit for bit, the second time in the same
    buffers; its captures are map 0's tables and S1's arguments."""
    runner, inputs, captured, _objects, _keep = shadow_city
    graph = runner.base_graph
    want = [D.raster_depth(t, b, w, h)[:s, :s]
            for (t, b, w, h), (_l, _o, s) in zip(shadow_front_chain(*inputs), inputs[0])]
    setup = graph._shadow_front_bufs.setup
    for _ in range(2):
        maps, (stacked, _bases) = graph._shadow_pass(*inputs)
        for got, w in zip(maps, want):
            assert torch.equal(got.view(torch.int32), w.view(torch.int32))
        assert graph._shadow_front_bufs.setup is setup
    stris, sbinned, swp, shp = captured["raster_depth"]
    assert stris.setup.data_ptr() == setup.data_ptr() and (swp, shp) == (2048, 2048)
    assert captured["shadow_front"][0] == [2048, 1024]


def test_shadow_front_counter_and_one_read(shadow_city):
    """A frame whose objects moved rasters both maps through S1 / S2
    (shadow_front.maps 2) with one sync:: read in the shadow_maps stage; a
    frame with nothing changed hits the cache (0)."""
    runner, _inputs, _captured, objects, _keep = shadow_city
    target = FrameRenderTarget(512, 256, 1)
    settings = BaseRenderGraphSettings(ambient_color=(0.08, 0.08, 0.1, 1.0))

    def frame():
        runner.renderer.swap_instruction_buffers()
        runner.base_graph.render_frame_tensor(runner.renderer.evaluate_instructions(), target, settings)

    frame()
    counts = {}
    for kind in ("moved", "static"):
        if kind == "moved":
            runner.renderer.set_object_transform(objects[0], m3.translation([3.0, 2.0, 1.0]) @ m3.scale(2.0))
        profiling.enable()
        frame()
        profiling.disable()
        torch.cuda.synchronize()
        st = profiling.stats()
        counts[kind] = (st.counters.get("shadow_front.maps", 0), st.counts.get("sync::shadow_front.totals", 0))
    assert counts == {"moved": (2, 1), "static": (0, 0)}


def test_s1_launch_failure_raises(shadow_city):
    """S1 refuses a group of no maps: the wrapper raises."""
    from rend3_tpu_torch.ops import cuda_kernels

    sizes, _cw, mvp, vis, tri_pos, tri_obj = _front_args(testing.shadow_front_case("soup", device="cuda"))
    bufs = SF.ShadowFrontBuffers()
    bufs.fit(tri_pos.shape[0], sizes, tri_pos.device)
    with pytest.raises(RuntimeError, match="s1_shadow_setup: CUDA error"):
        cuda_kernels.call("s1_shadow_setup", tri_pos, tri_obj, mvp, vis, bufs.setup, bufs.bbox, bufs.src, bufs.flip,
                          bufs.counts, bufs.counts, ints=(tri_pos.shape[0], 16, 16, bufs.cap, 0, 0, 0) + (0,) * 8)


# -- V1-V4, the view's front end (csrc/view_front.cu) --------------------------


def _view_tables(case, card):
    """(clipped table, survivors, planes, tile lists) of a view_front_case
    on the card's kernels (card) or the plain version."""
    from rend3_tpu_torch.ops import view_front as VF

    _p, tri_vlocal, tri_obj, bases, _m, _v = case["clip"]
    table = (VF.clip if card else VF.clip_plain)(*case["clip"])
    valid = table.valid & case["rows"][: table.valid.shape[0]]
    size = (case["width"], case["height"])
    rest = (tri_vlocal, tri_obj, bases, case["geo"], case["model_view"], case["material"], *size)
    if card:
        culled = VF.cull(table.clip, valid, *size, wp=case["wp"], hp=case["hp"], y0=case["y0"], **case["cull"])
        return table, culled.tris, VF.planes(culled, table, *rest), VF.tiles(culled)
    tris = VF.cull_plain(table.clip, valid, *size, **case["cull"])
    return table, tris, VF.planes_plain(tris, table, *rest), VF.tiles_plain(tris, case["wp"], case["hp"], case["y0"])


def _table_faults(got, want) -> list:
    """Fields of two front-end results that differ in shape, dtype or bits,
    order included (a part given as None on both sides is skipped)."""
    faults = []
    for part, g, w in zip(("clipped", "setup", "planes", "tiles"), got, want):
        if g is None and w is None:
            continue
        g, w = ((g,), (w,)) if isinstance(g, torch.Tensor) else (g, w)
        for k, (a, b) in enumerate(zip(g, w)):
            a, b = (t.view(torch.int32) if t.dtype == torch.float32 else t for t in (a, b))
            if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
                faults.append(f"{part}[{k}]: {tuple(a.shape)} vs {tuple(b.shape)}")
    return faults


@pytest.mark.parametrize("kind", testing.VIEW_FRONT_KINDS + ("stress",))
def test_view_front_matches_plain(kind):
    """V1-V4 against the plain version on the card, bit for bit and in
    order: the clipped table, the survivors, the planes, the tile lists.
    "stress": 200,000 soup triangles, some 700 blocks of rows whose
    survivors share tiles; 1 + 2 + 3 + 1 + 1 launches a set with survivors."""
    from rend3_tpu_torch.ops import view_front as VF

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = testing.view_front_case("soup" if kind == "stress" else kind, device="cuda", seed=5,
                                   n=200_000 if kind == "stress" else None)
    before = dict(VF.launches)
    got = _view_tables(case, card=True)
    launched = {k: VF.launches[k] - before[k] for k in before}
    want = _view_tables(case, card=False)
    assert _table_faults(got, want) == []
    if kind == "stress":
        assert got[1].count > 20_000 and int(got[3].offsets[-1]) > got[1].count
    if got[1].count:
        assert launched == {"view_clip": 2, "view_setup": 3, "view_planes": 1, "view_tiles": 1}


@pytest.fixture(scope="module")
def view_city():
    """Two 1920x1080 frames of the representative city (48 buildings) with
    occlusion on, the camera moved between them: (the images, the second
    frame's captures), on V1-V4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _view_city_frames()


def _view_city_frames():
    from rend3_tpu_torch.types import Camera, Perspective

    runner = TestRunner(device="cuda")
    keep = scenes.build_city_scene(runner, n_buildings=48, seed=7, representative=True)
    scenes.set_bench_camera(runner, 1920, 1080)
    graph = runner.base_graph
    images = []
    for k in range(2):
        if k:
            runner.set_camera_data(Camera(projection=Perspective(vfov=60.0, near=0.1),
                                          view=m3.look_at_lh([30.0, 20.0, -50.0], [0.0, 4.0, 0.0], [0.0, 1.0, 0.0])))
            graph.captured = {}
        runner.renderer.swap_instruction_buffers()
        images.append(graph.render_frame(runner.renderer.evaluate_instructions(), FrameRenderTarget(1920, 1080, 1),
                                         BaseRenderGraphSettings(ambient_color=(0.08, 0.08, 0.1, 1.0))))
    del keep
    return images, graph.captured


@pytest.mark.parametrize("site", ("setup", "resid", "cut_setup", "blend_geom"))
def test_view_front_sites_match_plain(view_city, site):
    """Each call site of the 1080p city frame on the card: the tables V1-V4
    built equal the plain version's on the frame's inputs, bit for bit."""
    from rend3_tpu_torch.ops import view_front as VF

    _images, cap = view_city
    clip_site = {"setup": "main", "blend_geom": "blend"}.get(site)
    if clip_site is not None:
        args, table = cap["view_clip"][clip_site]
        assert _table_faults((table,), (VF.clip_plain(*args),)) == []
    (clip_rows, valid, width, height), kw, tris = cap["view_cull"][site]
    plain = VF.cull_plain(clip_rows, valid, width, height, **kw)
    assert _table_faults((None, tris), (None, plain)) == [] and tris.count > 0
    if site == "resid" and ("resid" not in cap["view_planes"]):
        return
    args, (wp, hp, y0), _tris, planes, binned = cap["view_planes"][
        {"setup": "planes", "cut_setup": "cut_planes"}.get(site, site)]
    assert _table_faults((None, None, planes, binned),
                         (None, None, VF.planes_plain(tris, *args), VF.tiles_plain(tris, wp, hp, y0))) == []


def _chain_front(monkeypatch):
    """Puts the PyTorch chain in place of view_front's clip, cull, planes
    and tiles, which the frame calls through the module."""
    from rend3_tpu_torch.ops import transform as TR
    from rend3_tpu_torch.ops import view_front as VF

    def clip(positions, tri_vlocal, tri_obj, bases, mvp, visible):
        c = TR.gather_tri_clip(positions, tri_vlocal, tri_obj, bases[:, 0], mvp, contract=True)
        return TR.clip_triangles(c, visible[tri_obj.long()], contract=True)

    def cull(clip_rows, valid, width, height, *, wp, hp, y0=0, **kw):
        tris = G.cull_and_setup(clip_rows, valid, width, height, contract=True, **kw)
        return VF.Culled(tris, None, None, None, 0, wp // D.DTILE_W, hp // D.DTILE_H, y0, None)

    def planes(culled, table, *rest):
        return D.attribute_planes(culled.tris, table.clip, table.bary, table.orig, *rest, contract=True)

    def tiles(culled):
        return G.bin_triangles(culled.tris, culled.n_cols * D.DTILE_W, culled.n_rows * D.DTILE_H, tile_h=D.DTILE_H,
                               tile_w=D.DTILE_W, y0=culled.y0)

    for name, fn in (("clip", clip), ("cull", cull), ("planes", planes), ("tiles", tiles)):
        monkeypatch.setattr(VF, name, fn)


def test_view_front_frame_matches_chain(view_city, monkeypatch):
    """The same two 1080p frames with the PyTorch chain in place of V1-V4
    on the card: both images bit for bit."""
    images, _cap = view_city
    _chain_front(monkeypatch)
    chain_images, _ = _view_city_frames()
    for got, want in zip(images, chain_images):
        assert np.array_equal(got, want)
    assert (images[1] != images[0]).any()


# -- D1, the deferred shade (ops/lighting.py; csrc/deferred_shade.cu) ----------


def _u8(img):
    return blit.hdr_to_srgb_u8(blit.f16_roundtrip(img[None])[0]).to(torch.int32)


def _d1_matches_chain(args, label, exact=False):
    """D1 (light_gbuffer on the card) against its plain version on the card
    (light_gbuffer_plain, the PyTorch chain): NaN at the same places and
    every other value bit for bit (`exact`), or within D1_REL of the chain's
    per channel where the two round powf apart: the sRGB decode of vertex
    colours, ((e + 0.055) / 1.055) ** 2.4, is the one operator where the
    device library's powf under D1's --fmad=false and PyTorch's build of it
    (nvcc's default contraction) were seen to differ, by up to 4 ulp in the
    lit colour (4.3e-7 relative, the card tests' synthetic G-buffers); the
    u8 image within 1 either way."""
    got = lighting.light_gbuffer(*args)
    want = lighting.light_gbuffer_plain(*args).contiguous()
    assert got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), label
    diff = (got.view(torch.int32) != want.view(torch.int32)) & ~nan
    if exact:
        assert not bool(diff.any()), f"{label}: {int(diff.sum())} of {diff.numel()} values differ"
    elif bool(diff.any()):
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30))[diff]
        assert float(rel.max()) <= D1_REL, f"{label}: {int(diff.sum())} values differ, max rel {float(rel.max())}"
    assert int((_u8(got) - _u8(want)).abs().max()) <= 1, label
    return got


D1_REL = 2e-6


@pytest.mark.parametrize("kind", testing.DEFERRED_SHADE_KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_d1_matches_chain(kind, seed):
    """testing.deferred_shade_case's G-buffers: every flag and packing, all
    sampled slots and one not sampled, two maps and the any() bounds,
    precomputed factors, no textures and no plan (the lattice's shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _d1_matches_chain(testing.deferred_shade_case(kind, "cuda", seed), f"{kind} seed {seed}")


@pytest.fixture(scope="module")
def shade_city():
    """The representative city (600 buildings) at 1920x1080 on the card, at
    1 and 4 samples: each frame's captures (D1's inputs at sample 0's
    opaque G-buffer and its blend pixels) and counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = {}
    for samples in (1, 4):
        runner = TestRunner(device="cuda")
        keep = scenes.build_city_scene(runner, n_buildings=600, representative=True)
        scenes.set_bench_camera(runner, 1920, 1080)
        graph = runner.base_graph
        graph.captured = {}
        runner.renderer.swap_instruction_buffers()
        profiling.enable()
        try:
            graph.render_frame_tensor(runner.renderer.evaluate_instructions(), FrameRenderTarget(1920, 1080, samples),
                                      BaseRenderGraphSettings(ambient_color=(0.08, 0.08, 0.1, 1.0)))
        finally:
            profiling.disable()
        torch.cuda.synchronize()
        out[samples] = (graph.captured, profiling.stats().counters)
        del keep
    return out


@pytest.mark.parametrize("case", ["opaque", "blend", "msaa4 sample 0", "untextured, no plan"])
def test_d1_matches_chain_on_the_city(shade_city, case):
    """The 1080p representative frame's opaque G-buffer and blend pixels,
    sample 0 of its MSAA-4 frame, and its opaque G-buffer shaded without
    textures or shadow maps (the lattice's shape): bit for bit (the city
    has no vertex-colour sRGB material)."""
    cap = shade_city[4 if case.startswith("msaa") else 1][0]
    args = cap["deferred_shade_blend" if case == "blend" else "deferred_shade"]
    if case.startswith("untextured"):
        args = (*args[:6], None, None, ())
    got = _d1_matches_chain(args, case, exact=True)
    hit = args[0].data[D.G_HIT] > 0
    assert int(hit.sum()) > (1000 if case == "blend" else 1_000_000)
    assert torch.equal(got[~hit].view(torch.int32), args[5][~hit].contiguous().view(torch.int32))


def test_d1_counts_the_gbuffers(shade_city):
    """shade.gbuffers: a city frame shades its opaque G-buffer and its blend
    pixels (2); at 4 samples each sample's two (8)."""
    assert shade_city[1][1].get("shade.gbuffers", 0) == 2
    assert shade_city[4][1].get("shade.gbuffers", 0) == 8


def test_d1_launch_failure_raises():
    """A D1 launch its C entry refuses (more maps than it takes) raises."""
    from rend3_tpu_torch.ops import cuda_kernels

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = testing.deferred_shade_case("opaque", "cuda", 0)
    tensors, ints = lighting.launch_args(*args, lighting.light_tensors(*args[2:5]))
    with pytest.raises(RuntimeError):
        cuda_kernels.call("d1_deferred_shade", *tensors, ints=(*ints[:-1], lighting.MAX_MAPS + 1))


# -- C1, the cutout alpha test of a peel (ops/lighting.py; csrc/deferred_shade.cu)


def _c1_matches_plain(case, retest):
    got = testing.run_cutout_peels(lighting.cutout_peel_step, case, retest)
    want = testing.run_cutout_peels(lighting.cutout_peel_step_plain, case, retest)
    for k, ((gb, dn, bd, n), (wgb, wdn, wbd, wn)) in enumerate(zip(got, want)):
        assert torch.equal(gb.view(torch.int32), wgb.view(torch.int32)), f"peel {k}: gbuf"
        assert torch.equal(dn, wdn), f"peel {k}: done"
        assert torch.equal(bd.view(torch.int32), wbd.view(torch.int32)), f"peel {k}: bound"
        assert n == wn, f"peel {k}: {n} still searching, the chain {wn}"
    assert all(n > 0 for *_t, n in want) and not torch.equal(want[0][0], case["gbuf"])


@pytest.mark.parametrize("retest", [False, True], ids=["chained", "retest"])
@pytest.mark.parametrize("kind", testing.CUTOUT_PEEL_KINDS)
def test_c1_matches_plain(kind, retest):
    """testing.cutout_peel_case at 128x72, three chained peels (NEAREST,
    ALBEDO_BLEND, no cutoff, untextured materials, misses, fragments behind
    the opaque depth, pixels already done), gbuf, done, bound and the count
    bit for bit; `retest` tests passed pixels again in later peels, which
    shows a kernel that read the opaque depth from the G-buffer it wrote."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _c1_matches_plain(testing.cutout_peel_case(kind, "cuda", seed=4), retest)


@pytest.mark.parametrize("retest", [False, True], ids=["chained", "retest"])
def test_c1_matches_plain_at_1080p(retest):
    """The same at a 1920x1088 peel (the padded 1080p frame's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _c1_matches_plain(testing.cutout_peel_case("textured", "cuda", seed=5, height=1088, width=1920), retest)


@pytest.fixture(scope="module")
def c1_frames():
    """The representative city at 1920x1080 on the card, at 1 and 4
    samples, rendered through C1 and through the chain (cutout_peel_step's
    plain version patched in) after two frames that settle the carried
    occlusion mask: (image, last_stats, counters, span counts) of each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rend3_tpu_torch.routine import base

    out = {}
    for samples in (1, 4):
        runner = TestRunner(device="cuda")
        keep = scenes.build_city_scene(runner, n_buildings=600, representative=True)
        scenes.set_bench_camera(runner, 1920, 1080)
        graph = runner.base_graph

        def frame():
            runner.renderer.swap_instruction_buffers()
            return graph.render_frame(runner.renderer.evaluate_instructions(), FrameRenderTarget(1920, 1080, samples),
                                      BaseRenderGraphSettings(ambient_color=(0.08, 0.08, 0.1, 1.0)))

        frame()
        frame()
        for path in ("C1", "chain"):
            op = lighting.cutout_peel_step
            if path == "chain":
                base.light_ops.cutout_peel_step = lambda *a, extras=(), capture=None: (
                    lighting.cutout_peel_step_plain(*a, extras, capture))
            profiling.enable()
            try:
                img = frame()
            finally:
                profiling.disable()
                base.light_ops.cutout_peel_step = op
            s = profiling.stats()
            out[samples, path] = (img, dict(graph.last_stats), dict(s.counters), dict(s.counts))
        del keep
    return out


@pytest.mark.parametrize("samples", [1, 4])
def test_c1_frame_matches_the_chain(c1_frames, samples):
    """The frame through C1 equals the frame through the chain bit for
    bit, with the same peels and layers; C1 ran every peel (cut.c1_peels,
    the kernel::C1 span; at 1 sample as many as the frame's peels), no
    peel took the chain, and the chain's candidate read is gone."""
    img, stats, counters, spans = c1_frames[samples, "C1"]
    want, want_stats, _c, want_spans = c1_frames[samples, "chain"]
    assert np.array_equal(img, want)
    for key in ("cut_survivors", "cut_peels", "cut_layers"):
        assert stats[key] == want_stats[key], key
    assert stats["cut_peels"] >= 1 and counters.get("cut.c1_peels", 0) >= stats["cut_peels"]
    if samples == 1:
        assert counters["cut.c1_peels"] == stats["cut_peels"]
    assert spans["kernel::C1"] == counters["cut.c1_peels"] == spans["sync::cut.searching"]
    assert "cut.chain_peels" not in counters and "sync::cut.pixels" not in spans
    assert want_spans.get("sync::cut.pixels", 0) == counters["cut.c1_peels"]


def test_c1_registered_routine_frame():
    """A frame of scenes.feature_city (a registered cutout routine, whose
    alpha is a Python callable) runs C1 on every peel, with the routine's
    verdict computed before it, and equals the frame through the chain bit
    for bit with the same peels and layers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rend3_tpu_torch.routine import base

    runner = TestRunner(device="cuda")
    keep, info = scenes.feature_city(runner, n_buildings=48, sky_size=64, n_columns=4)
    scenes.set_bench_camera(runner, 512, 256)
    graph = runner.base_graph
    verdicts = []
    verdict = lighting.routine_verdict

    def frame():
        runner.renderer.swap_instruction_buffers()
        return graph.render_frame(runner.renderer.evaluate_instructions(), FrameRenderTarget(512, 256, 1),
                                  BaseRenderGraphSettings(ambient_color=(0.08, 0.08, 0.1, 1.0)), info["sky"].idx)

    frame()
    out = {}
    for path in ("C1", "chain"):
        op = base.light_ops.cutout_peel_step
        if path == "chain":
            base.light_ops.cutout_peel_step = lambda *a, extras=(), capture=None: (
                lighting.cutout_peel_step_plain(*a, extras, capture))
        before = lighting.launches["cutout_alpha"]
        lighting.routine_verdict = lambda gc, extras: verdicts.append(path) or verdict(gc, extras)
        profiling.enable()
        try:
            img = frame()
        finally:
            profiling.disable()
            base.light_ops.cutout_peel_step = op
            lighting.routine_verdict = verdict
        out[path] = (img, dict(graph.last_stats), dict(profiling.stats().counters),
                     lighting.launches["cutout_alpha"] - before)
    img, stats, counters, launched = out["C1"]
    want, want_stats, _c, chain_launched = out["chain"]
    peels = stats["cut_peels"]
    assert peels >= 1 and counters.get("cut.c1_peels") == launched == peels and "cut.chain_peels" not in counters
    assert chain_launched == 0 and verdicts == ["C1"] * peels
    for key in ("cut_survivors", "cut_peels", "cut_layers"):
        assert stats[key] == want_stats[key], key
    assert np.array_equal(img, want) and (img[..., :3] > 0).any()
    del keep


def test_c1_launch_failure_raises():
    """A C1 launch its C entry refuses (a slot flag other than 0 or 1) raises."""
    from rend3_tpu_torch.ops import cuda_kernels

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = testing.cutout_peel_case("textured", "cuda", seed=0, height=8, width=16, peels=1)
    tensors, ints = lighting.peel_launch_args(case["gcs"][0], case["gbuf"], case["floor"], case["done"],
                                              case["materials"], case["textures"], case["active"])
    with pytest.raises(RuntimeError):
        cuda_kernels.call("c1_cutout_peel", *tensors, ints=(*ints[:-1], 2))
