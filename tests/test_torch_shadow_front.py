"""S1 and S2's algorithm (ops/shadow_front.shadow_front_plain) against the
shadow pass's PyTorch chain (testing.shadow_front_chain) on the CPU.

On each case, map by map: the caster tables equal as multisets of rows
(setup row and bbox, bit for bit, S_ID aside: the chain numbers rows by
its clipped table, the kernels by slot 4 t + s), the tile lists' offsets
equal, and K2's plain version rasters both into the same map bit for bit.
Cases: the bench city (24 buildings, both lights at 256 texels) through a
CPU frame, and testing.shadow_front_case's soups: the near-clip soup of
test_torch_shadow_forms.py (about a third of its triangles crossing), one
in which every triangle crosses, one no light sees (no survivor), and one
whose first 90% of triangles cross nothing. On CPU tensors shadow_front
returns the plain version's maps, which the CPU frame rasters.
The card's S1 / S2 are held to the plain version in test_torch_cuda.py.
"""

import pytest
import torch

from rend3_tpu_torch import scenes, testing
from rend3_tpu_torch.ops import deferred as D
from rend3_tpu_torch.ops import geometry as G
from rend3_tpu_torch.ops import shadow_front as SF
from rend3_tpu_torch.ops import transform as T
from rend3_tpu_torch.routine import base as B
from rend3_tpu_torch.testing import shadow_front_chain

CASES = ("city", "soup", "all_crossing", "none", "mixed")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def city_inputs():
    """The shadow pass's inputs of a 64x36 CPU frame of the bench city with
    its two lights' maps at 256 texels."""
    runner = testing.TestRunner(device="cpu")
    keep = scenes.build_city_scene(runner, n_buildings=24, seed=7, representative=True)
    for light in keep[-2:]:
        runner.renderer.update_directional_light(light, resolution=256)
    scenes.set_bench_camera(runner, 64, 36)
    runner.renderer.swap_instruction_buffers()
    runner.base_graph.render_frame(runner.renderer.evaluate_instructions(), B.FrameRenderTarget(64, 36, 1),
                                   B.BaseRenderGraphSettings())
    return runner.base_graph._last_shadow_call[1]


def _inputs(case, city_inputs):
    return city_inputs if case == "city" else testing.shadow_front_case(case, device="cpu", seed=3)


def _plain(inputs):
    plan, front_cw, transforms, light_vp, vis, _p, _v, tri_obj, _b, tri_pos = inputs
    return SF.shadow_front_plain([s for _l, _o, s in plan], front_cw, SF.light_mvp(transforms, light_vp, len(plan)),
                                 vis, tri_pos, tri_obj)


def _rows(tris: G.TriSetup) -> torch.Tensor:
    """The table's rows (setup then bbox, S_ID zeroed) as int32 bits, sorted."""
    r = torch.cat([tris.setup, tris.bbox], dim=1).clone()
    r[:, G.S_ID] = 0.0
    bits = r.view(torch.int32)
    order = torch.arange(bits.shape[0])
    for c in reversed(range(bits.shape[1])):
        order = order[torch.sort(bits[order, c], stable=True).indices]
    return bits[order]


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_chain(city_inputs, case):
    inputs = _inputs(case, city_inputs)
    chain = shadow_front_chain(*inputs)
    plain = _plain(inputs)
    assert len(chain) == len(plain) == 2
    for (ct, cb, w, h), pf in zip(chain, plain):
        assert (pf.width, pf.height) == (w, h)
        assert ct.count == pf.tris.count
        assert torch.equal(_rows(ct), _rows(pf.tris))
        assert torch.equal(cb.offsets, pf.binned.offsets)
        mc, mp = D.raster_depth_plain(ct, cb, w, h), D.raster_depth_plain(pf.tris, pf.binned, w, h)
        assert torch.equal(mc.view(torch.int32), mp.view(torch.int32))
        if case == "none":
            assert pf.tris.count == 0 and int(pf.binned.offsets[-1]) == 0
        else:
            assert pf.tris.count > 20 and (mp > 0).sum() > 100


@pytest.mark.parametrize("case", ["soup", "all_crossing"])
def test_soups_clip(case):
    """The soups hold what they are for: crossing triangles (all of them in
    all_crossing), and fans among the survivors."""
    plan, _cw, transforms, light_vp, vis, _p, _v, tri_obj, _b, tri_pos = testing.shadow_front_case(case, seed=3)
    clip = T.gather_tri_clip(None, None, tri_obj, None, SF.light_mvp(transforms, light_vp, 1)[0], tri_pos=tri_pos,
                             contract=True)
    inside = ((clip[..., 3] - clip[..., 2]) >= 0) & (clip[..., 3] > T.W_EPS)
    crossing = inside.any(-1) & ~inside.all(-1)
    share = float(crossing.float().mean())
    assert share == 1.0 if case == "all_crossing" else 0.2 < share < 0.6
    tris = _plain(testing.shadow_front_case(case, seed=3))[0].tris
    assert bool((tris.src % SF.SLOTS > 0).any())


@pytest.mark.parametrize("case", CASES)
def test_plain_is_in_slot_order(city_inputs, case):
    """Rows ascend by slot id (S_ID = src = 4 t + s) and every tile's list
    ascends: the plain version is deterministic."""
    for pf in _plain(_inputs(case, city_inputs)):
        src = pf.tris.src
        assert torch.equal(pf.tris.setup[:, G.S_ID], src.float())
        assert bool((src[1:] > src[:-1]).all())
        offs, ids = pf.binned.offsets.long(), pf.binned.ids.long()
        step = ids[1:] - ids[:-1]
        starts = torch.zeros(ids.shape[0], dtype=torch.bool)
        starts[offs[:-1][offs[:-1] < ids.shape[0]]] = True
        assert bool(((step > 0) | starts[1:]).all())


def test_shadow_front_raises_on_cpu():
    """shadow_front on CPU tensors returns shadow_front_plain's maps, row
    for row, and launches nothing."""
    plan, cw, transforms, light_vp, vis, _p, _v, tri_obj, _b, tri_pos = testing.shadow_front_case("soup")
    args = ([s for _l, _o, s in plan], cw, SF.light_mvp(transforms, light_vp, len(plan)), vis, tri_pos, tri_obj)
    before = dict(SF.launches)
    got = SF.shadow_front(SF.ShadowFrontBuffers(), *args)
    assert SF.launches == before
    want = SF.shadow_front_plain(*args)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert (g.width, g.height) == (w.width, w.height) and g.tris.count > 20
        for a, b in zip((*g.tris, *g.binned), (*w.tris, *w.binned)):
            assert torch.equal(a, b)


def test_buffers_grow_only():
    bufs = SF.ShadowFrontBuffers()
    dev = torch.device("cpu")
    bufs.fit(1000, [2048, 1024], dev)
    setup = bufs.setup
    assert bufs.cap == 3000 and setup.shape == (2, 3000, G.SETUP_W)
    assert bufs.tile_base == [0, 1024] and bufs.offsets.numel() == 1024 + 256 + 2
    bufs.fit(900, [1024, 2048], dev)  # fewer triangles, the same tiles in all: kept
    assert bufs.setup is setup and bufs.tile_base == [0, 256]
    bufs.fit(1001, [2048, 1024], dev)
    assert bufs.setup is not setup and bufs.cap == 3003
    bufs.fit_ids(100, dev)
    ids = bufs.ids
    bufs.fit_ids(120, dev)
    assert bufs.ids is ids and ids.numel() == 125
    bufs.fit_ids(126, dev)
    assert bufs.ids.numel() == 157
