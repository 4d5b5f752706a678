"""Host-layer tests of the PyTorch port: the tests of tests/test_units.py
that exercise host code (shadow atlas packer, allocators, frustum, mesh
builder, handles, texture mip chains, skeleton joints, FLIP, sparse mesh
arena updates), run against rend3_tpu_torch instead of rend3_tpu."""

import numpy as np

from rend3_tpu_torch.core.managers.alloc import HandleAllocator, RangeAllocator
from rend3_tpu_torch.core.managers.directional import allocate_shadow_atlas
from rend3_tpu_torch.types import Handedness, MeshBuilder
from rend3_tpu_torch.utils.math import BoundingSphere, Frustum, perspective_infinite_reverse_lh


def test_shadow_atlas_single():
    (dims, maps) = allocate_shadow_atlas([(0, 256)], 8192)
    assert dims == (256, 256)
    assert maps[0].offset == (0, 0) and maps[0].size == 256


def test_shadow_atlas_quadtree_packing():
    # One 512 + four 256 lights pack into 512x1024 or 1024x512 (second root).
    maps_in = [(0, 512), (1, 256), (2, 256), (3, 256), (4, 256)]
    (w, h), maps = allocate_shadow_atlas(maps_in, 8192)
    assert w * h >= 512 * 512 + 4 * 256 * 256
    # No overlaps:
    rects = [(m.offset[0], m.offset[1], m.size) for m in maps]
    for i, (x0, y0, s0) in enumerate(rects):
        assert x0 + s0 <= w and y0 + s0 <= h
        for j, (x1, y1, s1) in enumerate(rects):
            if i == j:
                continue
            assert x0 + s0 <= x1 or x1 + s1 <= x0 or y0 + s0 <= y1 or y1 + s1 <= y0
    assert len(maps) == 5


def test_shadow_atlas_multiple_roots():
    # Nine equal maps need three roots -> grid growth.
    (w, h), maps = allocate_shadow_atlas([(i, 128) for i in range(9)], 8192)
    assert len(maps) == 9
    assert w % 128 == 0 and h % 128 == 0


def test_range_allocator():
    ra = RangeAllocator(100)
    a = ra.allocate(40)
    b = ra.allocate(40)
    assert ra.allocate(40) is None
    ra.free(a, 40)
    c = ra.allocate(30)
    assert c == 0
    ra.grow(200)
    assert ra.allocate(100) is not None
    assert ra.used() == 170


def test_native_range_allocator_matches():
    from rend3_tpu_torch.native import NativeRangeAllocator

    ra = NativeRangeAllocator(100)
    a = ra.allocate(40)
    b = ra.allocate(40)
    assert ra.allocate(40) is None
    ra.free(a, 40)
    assert ra.allocate(30) == 0
    ra.grow(200)
    assert ra.allocate(100) is not None
    assert ra.used() == 170


def test_handle_allocator_delayed_reclaim():
    ha = HandleAllocator("object", delayed_reclaim=True)
    a = ha.allocate()
    ha.deallocate(a)
    b = ha.allocate()
    assert b != a  # not reclaimed yet (one-frame delay)
    ha.reclaim()
    c = ha.allocate()
    assert c == a


def test_frustum_sphere():
    proj = perspective_infinite_reverse_lh(np.deg2rad(60.0), 1.0, 0.1)
    f = Frustum.from_matrix(proj)
    assert f.contains_sphere(BoundingSphere([0, 0, 5], 1.0))       # in front
    assert not f.contains_sphere(BoundingSphere([0, 0, -5], 1.0))  # behind
    assert not f.contains_sphere(BoundingSphere([50, 0, 5], 1.0))  # far left
    assert f.contains_sphere(BoundingSphere([0, 0, 0], 0.2))       # near-straddling


def test_mesh_builder_normals_handedness():
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    m_l = MeshBuilder(pos.copy(), Handedness.LEFT).build()
    m_r = MeshBuilder(pos.copy(), Handedness.RIGHT).build()
    nl = m_l.attributes["normal"]
    nr = m_r.attributes["normal"]
    np.testing.assert_allclose(nl, -nr, atol=1e-6)
    np.testing.assert_allclose(np.abs(nl[0]), [0, 0, 1], atol=1e-6)


def test_mesh_validation():
    import pytest
    from rend3_tpu_torch.types import MeshValidationError

    pos = np.zeros((3, 3), np.float32)
    with pytest.raises(MeshValidationError):
        MeshBuilder(pos, Handedness.LEFT).with_indices(np.array([0, 1, 5], np.uint32)).build()
    with pytest.raises(MeshValidationError):
        MeshBuilder(pos, Handedness.LEFT).with_indices(np.array([0, 1], np.uint32)).build()


def test_handle_drop_enqueues_delete():
    from rend3_tpu_torch.core.renderer import Renderer
    from rend3_tpu_torch.core.instruction import InstructionKind

    r = Renderer(device="cpu")
    mesh = MeshBuilder(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32), Handedness.LEFT).build()
    h = r.add_mesh(mesh)
    idx = h.idx
    clone = h.clone()
    del h
    r.swap_instruction_buffers()
    assert not any(i.kind == InstructionKind.DELETE_MESH for i in r.instructions.drain())
    del clone
    r.swap_instruction_buffers()
    drained = r.instructions.drain()
    assert any(i.kind == InstructionKind.DELETE_MESH and i.payload.idx == idx for i in drained)


def test_texture_from_texture_mip_view():
    """reference: rend3/src/renderer/mod.rs:203 + managers/texture.rs:198-242."""
    import numpy as np
    from rend3_tpu_torch.core.renderer import Renderer
    from rend3_tpu_torch.types import Handedness, MipmapCount, Texture, TextureFormat
    from rend3_tpu_torch.types.texture import TextureFromTexture

    r = Renderer(handedness=Handedness.LEFT, device="cpu")
    img = (np.random.default_rng(0).uniform(0, 255, (16, 16, 4))).astype(np.uint8)
    src = r.add_texture_2d(
        Texture(label="src", data=img, format=TextureFormat.RGBA8_UNORM, mip_count=MipmapCount.MAXIMUM)
    )
    view = r.add_texture_2d_from_texture(
        TextureFromTexture(label="v", src=src, start_mip=1, mip_count=2)
    )
    r.swap_instruction_buffers()
    r.evaluate_instructions()
    src_t = r.d2_texture_manager.data[src.idx]
    view_t = r.d2_texture_manager.data[view.idx]
    assert len(src_t.mips) == 5
    assert len(view_t.mips) == 2
    np.testing.assert_array_equal(view_t.mips[0], src_t.mips[1])
    np.testing.assert_array_equal(view_t.mips[1], src_t.mips[2])


def test_set_skeleton_joint_transforms_composes_inverse_bind():
    """reference: rend3/src/renderer/mod.rs:314-323."""
    import numpy as np
    from rend3_tpu_torch.core.renderer import Renderer
    from rend3_tpu_torch.types import Handedness, Mesh, MeshBuilder, Skeleton

    r = Renderer(handedness=Handedness.LEFT, device="cpu")
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    mesh = (
        MeshBuilder(verts, Handedness.LEFT)
        .with_indices(np.array([0, 1, 2], np.uint32))
        .with_vertex_joint_indices(np.zeros((3, 4), np.uint16))
        .with_vertex_joint_weights(np.array([[1, 0, 0, 0]] * 3, np.float32))
        .build()
    )
    mh = r.add_mesh(mesh)
    sk = r.add_skeleton(Skeleton(joint_matrices=[np.eye(4)], mesh=mh))
    g = np.eye(4); g[0, 3] = 2.0
    ib = np.eye(4); ib[1, 3] = -1.0
    r.set_skeleton_joint_transforms(sk, [g], [ib])
    r.swap_instruction_buffers()
    r.evaluate_instructions()
    got = r.skeleton_manager.data[sk.idx].joint_matrices[0]
    np.testing.assert_allclose(got, g @ ib, atol=1e-6)


def test_cube_texture_mip_chain():
    import numpy as np
    from rend3_tpu_torch.core.managers.texture import TextureManager
    from rend3_tpu_torch.types import MipmapCount, Texture, TextureFormat

    m = TextureManager(kind="cube")
    data = np.random.default_rng(1).uniform(0, 1, (6, 8, 8, 4)).astype(np.float32)
    m.add(0, Texture(label="c", data=data, format=TextureFormat.RGBA32_FLOAT, mip_count=MipmapCount.MAXIMUM))
    t = m.data[0]
    assert len(t.mips) == 4
    assert t.mips[1].shape == (6, 4, 4, 4)
    np.testing.assert_allclose(
        t.mips[1][2], data[2].reshape(4, 2, 4, 2, 4).mean(axis=(1, 3)), atol=1e-6
    )


def test_flip_metric_sanity():
    """FLIP perceptual metric (utils/flip.py; reference harness uses nv-flip,
    rend3-test/src/runner.rs:244)."""
    import numpy as np
    from rend3_tpu_torch.utils.flip import flip, flip_mean

    rng = np.random.default_rng(3)
    img = (rng.uniform(0, 255, (64, 64, 3))).astype(np.uint8)
    assert flip_mean(img, img) < 1e-6
    # small perturbation -> small error; gross difference -> larger error
    small = np.clip(img.astype(int) + rng.integers(-6, 7, img.shape), 0, 255).astype(np.uint8)
    gross = (255 - img).astype(np.uint8)
    e_small = flip_mean(img, small)
    e_gross = flip_mean(img, gross)
    assert 0.0 < e_small < e_gross <= 1.0
    m = flip(img, gross)
    assert m.shape == (64, 64) and m.min() >= 0.0 and m.max() <= 1.0


def test_mesh_sparse_range_update():
    """write_range scatters only the dirty slots into the device arenas
    (reference: util/scatter_copy.rs)."""
    import numpy as np
    from rend3_tpu_torch.core.managers.mesh import MeshManager
    from rend3_tpu_torch.types import Handedness, MeshBuilder

    mm = MeshManager()
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    mesh = (
        MeshBuilder(v, Handedness.LEFT).with_indices(np.array([0, 1, 2], np.uint32)).build()
    )
    mm.add(0, mesh)
    geo1 = mm.evaluate()
    start, count = mm.data[0].attr_ranges["position"]
    new_pos = np.array([[5, 5, 5], [6, 5, 5], [5, 6, 5]], np.float32)
    mm.write_range("position", start, new_pos)
    geo2 = mm.evaluate()
    np.testing.assert_allclose(geo2.position.numpy()[start : start + 3], new_pos, atol=0)
    # untouched arenas are the same device buffers (no re-upload)
    assert geo2.normal is geo1.normal
