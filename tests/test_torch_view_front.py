"""V1-V4's algorithm (ops/view_front.py's plain version) against the view's
PyTorch chain on the CPU.

The chain is transform.gather_tri_clip and clip_triangles, then
geometry.cull_and_setup, deferred.attribute_planes and
geometry.bin_triangles, all in the frame's contracted forms; the plain
version must give the same tables bit for bit and in the same order: the
clipped table (clip, orig, bary, valid), the survivors' setup rows, bbox,
src and flip, the plane table, and the CSR tile lists (offsets, and each
tile's ids in order). Cases: testing.view_front_case's sets (the near-clip
soup, the soup under a Hi-Z pyramid, a row band, MSAA's cull without the
sub-pixel test, no object visible, one crossing triangle, no triangle),
and each call site (main, residual, cutout, blend) of two CPU frames of
the bench city with occlusion on, the camera moved between them: the CPU
frame runs the plain version (view_front's clip, cull, planes and tiles on
CPU tensors), and its tables equal the chain's on the site's inputs. The
card's kernels are held to the plain version in test_torch_cuda.py.
"""

import pytest
import torch

from rend3_tpu_torch import scenes, testing
from rend3_tpu_torch.ops import deferred as D
from rend3_tpu_torch.ops import geometry as G
from rend3_tpu_torch.ops import transform as T
from rend3_tpu_torch.ops import view_front as VF
from rend3_tpu_torch.routine import base as B
from rend3_tpu_torch.types import Camera, Perspective
from rend3_tpu_torch.utils import math as m3

# Each cull site's stage and the stage its planes are captured under.
SITES = {"setup": "planes", "resid": "resid", "cut_setup": "cut_planes", "blend_geom": "blend_geom"}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _diff(got, want) -> list:
    """The fields of two tuples of tensors that differ in shape, dtype or
    bits (order included)."""
    out = []
    for name, a, b in zip(getattr(want, "_fields", range(len(want))), got, want):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(_bits(a), _bits(b)):
            out.append(f"{name}: {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    return out


def _chain_clip(positions, tri_vlocal, tri_obj, bases, mvp, visible):
    clip = T.gather_tri_clip(positions, tri_vlocal, tri_obj, bases[:, 0], mvp, contract=True)
    return T.clip_triangles(clip, visible[tri_obj.long()], contract=True)


def _chain_planes(tris, table, tri_vlocal, tri_obj, bases, geo, model_view, material, width, height):
    return D.attribute_planes(tris, table.clip, table.bary, table.orig, tri_vlocal, tri_obj, bases, geo, model_view,
                              material, width, height, contract=True)


def _chain(case):
    _positions, tri_vlocal, tri_obj, bases, _mvp, _visible = case["clip"]
    table = _chain_clip(*case["clip"])
    valid = table.valid & case["rows"][: table.valid.shape[0]]
    tris = G.cull_and_setup(table.clip, valid, case["width"], case["height"], contract=True, **case["cull"])
    planes = _chain_planes(tris, table, tri_vlocal, tri_obj, bases, case["geo"], case["model_view"],
                           case["material"], case["width"], case["height"])
    binned = G.bin_triangles(tris, case["wp"], case["hp"], tile_h=D.DTILE_H, tile_w=D.DTILE_W, y0=case["y0"])
    return table, tris, planes, binned


def _plain(case):
    _positions, tri_vlocal, tri_obj, bases, _mvp, _visible = case["clip"]
    table = VF.clip_plain(*case["clip"])
    valid = table.valid & case["rows"][: table.valid.shape[0]]
    tris = VF.cull_plain(table.clip, valid, case["width"], case["height"], **case["cull"])
    planes = VF.planes_plain(tris, table, tri_vlocal, tri_obj, bases, case["geo"], case["model_view"],
                             case["material"], case["width"], case["height"])
    return table, tris, planes, VF.tiles_plain(tris, case["wp"], case["hp"], case["y0"])


@pytest.mark.parametrize("kind", testing.VIEW_FRONT_KINDS)
def test_plain_matches_chain(kind):
    case = testing.view_front_case(kind, seed=3)
    chain, plain = _chain(case), _plain(case)
    for name, c, p in zip(("clipped", "setup", "planes", "tiles"), chain, plain):
        if name == "planes":
            c, p = (c,), (p,)
        assert _diff(p, c) == [], name
    table, tris, _planes, binned = plain
    n = case["clip"][2].shape[0]
    n_cross = (table.clip.shape[0] - n) // 3
    if kind in ("soup", "hiz", "band", "msaa"):
        assert n_cross > 100 and tris.count > 30 and bool((tris.src >= n).any())
    if kind == "one":
        assert n_cross == 1 and tris.count >= 1
    if kind in ("hidden", "empty"):
        assert tris.count == 0 and binned.ids.numel() == 0 and not bool(binned.offsets.any())
    if kind == "hiz":  # the pyramid culls some of what the soup keeps
        no_hiz = dict(case, cull=dict(case["cull"], hiz=None))
        assert _plain(no_hiz)[1].count > tris.count + 10
    if kind == "band":  # every survivor meets the band's rows
        assert bool(((tris.bbox[:, 3] > 40) & (tris.bbox[:, 1] < 88)).all())


@pytest.mark.parametrize("kind", ["soup", "band"])
def test_plain_lists_ascend(kind):
    """Rows ascend by clipped row (S_ID = src) and every tile's list
    ascends, as K1's tie-break needs."""
    _table, tris, _planes, binned = _plain(testing.view_front_case(kind, seed=4))
    assert torch.equal(tris.setup[:, G.S_ID], tris.src.float()) and bool((tris.src[1:] > tris.src[:-1]).all())
    offs, ids = binned.offsets.long(), binned.ids.long()
    for t in range(offs.numel() - 1):
        seg = ids[offs[t]:offs[t + 1]]
        assert bool((seg[1:] > seg[:-1]).all())
    assert int(offs[-1]) >= tris.count > 0


@pytest.fixture(scope="module")
def city_frames():
    """Two 128x72 CPU frames of the bench city with occlusion on, the
    camera moved between them; the second frame's captures."""
    torch.set_num_threads(2)
    runner = testing.TestRunner(device="cpu")
    keep = scenes.build_city_scene(runner, n_buildings=24, seed=7, representative=True)
    scenes.set_bench_camera(runner, 128, 72)
    target = B.FrameRenderTarget(128, 72, 1)
    settings = B.BaseRenderGraphSettings()
    graph = runner.base_graph
    for k in range(2):
        if k:
            runner.set_camera_data(Camera(projection=Perspective(vfov=60.0, near=0.1),
                                          view=m3.look_at_lh([30.0, 20.0, -50.0], [0.0, 4.0, 0.0], [0.0, 1.0, 0.0])))
            graph.captured = {}
        runner.renderer.swap_instruction_buffers()
        graph.render_frame(runner.renderer.evaluate_instructions(), target, settings)
    del keep
    return graph.captured


@pytest.mark.parametrize("site", list(SITES))
def test_plain_matches_chain_on_city(city_frames, site):
    """Each call site of the city frame: the tables the frame built (the
    plain version's) and rastered equal the chain's on the site's
    inputs."""
    clip_site = {"setup": "main", "blend_geom": "blend"}.get(site)
    if clip_site is not None:
        args, table = city_frames["view_clip"][clip_site]
        assert _diff(table, _chain_clip(*args)) == []
        if clip_site == "main":
            assert table.clip.shape[0] > args[2].shape[0]  # some crossing triangles
    (clip_rows, valid, width, height), kw, tris = city_frames["view_cull"][site]
    assert _diff(tris, G.cull_and_setup(clip_rows, valid, width, height, contract=True, **kw)) == []
    assert (kw["hiz"] is not None) == (site == "cut_setup")
    assert tris.count > 0
    args, (wp, hp, y0), ptris, planes, binned = city_frames["view_planes"][SITES[site]]
    assert ptris is tris
    assert _diff((planes,), (_chain_planes(tris, *args),)) == []
    assert _diff(binned, G.bin_triangles(tris, wp, hp, tile_h=D.DTILE_H, tile_w=D.DTILE_W, y0=y0)) == []


def test_cpu_frame_builds_no_card_table(city_frames):
    """On the CPU the frame runs the plain version: none of V1-V4's
    launches, and every site's tables equal the plain version's on its
    inputs."""
    assert all(v == 0 for v in VF.launches.values())
    for args, table in city_frames["view_clip"].values():
        assert _diff(table, VF.clip_plain(*args)) == []
    for (clip_rows, valid, width, height), kw, tris in city_frames["view_cull"].values():
        assert _diff(tris, VF.cull_plain(clip_rows, valid, width, height, **kw)) == []
    for args, (wp, hp, y0), tris, planes, binned in city_frames["view_planes"].values():
        assert _diff((planes,), (VF.planes_plain(tris, *args),)) == []
        assert _diff(binned, VF.tiles_plain(tris, wp, hp, y0)) == []
    assert set(city_frames["view_cull"]) == set(SITES)


def test_card_wrappers_refuse_wrong_inputs():
    """The card's entry points check their inputs before any launch."""
    case = testing.view_front_case("soup")
    positions, tri_vlocal, tri_obj, bases, mvp, visible = case["clip"]
    with pytest.raises(ValueError, match="tri_vlocal"):
        VF.clip(positions, tri_vlocal.long(), tri_obj, bases, mvp, visible)
    with pytest.raises(ValueError, match="tiles"):
        VF.cull(torch.zeros(3, 3, 4), torch.ones(3, dtype=torch.bool), 64, 64, cull_mode=1, front_is_cw=True,
                subpixel=True, wp=100, hp=64)
