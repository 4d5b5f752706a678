"""glTF loading, compressed textures and animation of the PyTorch port on
the CPU against the JAX package (rend3_tpu/gltf, rend3_tpu/anim).

- The BC / container cases of tests/test_units.py (BC1, BC3, BC5, KTX2,
  DDS, BC7, BC6H, Zstandard KTX2) on the port's decoder, each also equal
  to the JAX package's decode of the same bytes.
- testing.make_test_gltf() (a textured box whose PNG is a data URI, a
  two-joint skinned column, a rigid T/R/S-animated box, a directional
  KHR_lights_punctual light) through both loaders: the same counts of
  meshes, materials, skins, animations and lights, node transforms and
  inverse binds bit for bit, and the texture's mip chain and atlas bit for
  bit after evaluation.
- pose_animation_frame's object transforms and joint matrices at t = 0,
  half the duration and the duration, within 1e-6.
- The posed scene at 128x128 (one shadowed light) against JAX's frame,
  within 1 u8; testing.GltfAnimationApp's three poses through
  framework.start differ, and the pose holds past the animation's end.
"""

import struct

import numpy as np
import pytest
import torch

from rend3_tpu import anim as JA
from rend3_tpu import testing as JT
from rend3_tpu import types as jtypes
from rend3_tpu.core.renderer import Renderer as JaxRenderer
from rend3_tpu.gltf import compressed as JC
from rend3_tpu.gltf import loader as JL
from rend3_tpu.routine.base import BaseRenderGraphSettings as JaxSettings
from rend3_tpu.routine.base import FrameRenderTarget as JaxTarget
from rend3_tpu_torch import anim as PA
from rend3_tpu_torch import testing as PT
from rend3_tpu_torch import types as ptypes
from rend3_tpu_torch.core.renderer import Renderer
from rend3_tpu_torch.gltf import compressed as PC
from rend3_tpu_torch.gltf import loader as PL
from rend3_tpu_torch.routine.base import BaseRenderGraphSettings, FrameRenderTarget
from rend3_tpu_torch.testing import TEST_GLTF_DURATION, make_test_gltf

TIMES = (0.0, TEST_GLTF_DURATION / 2, TEST_GLTF_DURATION)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# -- compressed textures (rend3-gltf/src/lib.rs:1185-1627) --------------------


def _same_decode(fn_name, *args):
    """The port's decode, checked equal to the JAX package's."""
    got = getattr(PC, fn_name)(*args)
    want = getattr(JC, fn_name)(*args)
    if isinstance(got, tuple):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    else:
        np.testing.assert_array_equal(got, want)
    return got


def test_bc_and_container_decode():
    red565 = 31 << 11
    blk = struct.pack("<HHI", red565, red565, 0)
    img = _same_decode("decode_bc", "bc1", blk, 4, 4)
    assert img.shape == (4, 4, 4)
    np.testing.assert_array_equal(img[0, 0], [255, 0, 0, 255])

    g565 = 63 << 5
    blk3 = bytes([255, 0, 0, 0, 0, 0, 0, 0]) + struct.pack("<HHI", g565, g565, 0)
    np.testing.assert_array_equal(_same_decode("decode_bc", "bc3", blk3, 4, 4)[2, 2], [0, 255, 0, 255])

    blk5 = bytes([200, 0, 0, 0, 0, 0, 0, 0]) + bytes([100, 0, 0, 0, 0, 0, 0, 0])
    np.testing.assert_array_equal(_same_decode("decode_bc", "bc5", blk5, 4, 4)[1, 1], [200, 100, 0, 255])

    # BC1 in 3-colour mode, BC2 and BC4 with mixed indices (beyond test_units).
    rng = np.random.default_rng(0)
    for kind, nbytes in (("bc1", 8), ("bc2", 16), ("bc3", 16), ("bc4", 8), ("bc5", 16)):
        payload = rng.integers(0, 256, size=nbytes * 6, dtype=np.uint8).tobytes()
        assert _same_decode("decode_bc", kind, payload, 10, 7).shape == (7, 10, 4)

    payload = np.arange(4 * 4 * 4, dtype=np.uint8).tobytes()
    hdr = b"\xabKTX 20\xbb\r\n\x1a\n" + struct.pack("<9I", 37, 1, 4, 4, 0, 0, 1, 1, 0) + b"\x00" * (80 - 12 - 36)
    lvl = struct.pack("<3Q", 128, len(payload), len(payload))
    data = hdr + lvl + b"\x00" * (128 - len(hdr) - len(lvl)) + payload
    img_k, srgb = _same_decode("decode_ktx2", data)
    assert not srgb and img_k.shape == (4, 4, 4)
    np.testing.assert_array_equal(img_k.reshape(-1), np.arange(64, dtype=np.uint8))

    dds = b"DDS " + b"\x00" * 8 + struct.pack("<2I", 4, 4) + b"\x00" * 64 + b"DXT1" + b"\x00" * 40 + blk
    img_d, _ = _same_decode("decode_dds", dds)
    np.testing.assert_array_equal(img_d[3, 3], [255, 0, 0, 255])


def _pack_bits(fields):
    """fields: list of (value, nbits) packed LSB-first into 16 bytes."""
    v = 0
    off = 0
    for val, n in fields:
        v |= (val & ((1 << n) - 1)) << off
        off += n
    assert off <= 128
    return v.to_bytes(16, "little")


def test_bc7_bc6h_decode():
    blk7 = _pack_bits([
        (0b100000, 6), (0, 2),
        (0x7F, 7), (0x7F, 7), (0x40, 7), (0x40, 7), (0x00, 7), (0x00, 7),
        (0xAA, 8), (0xAA, 8),
    ])
    img7 = _same_decode("decode_bc", "bc7", blk7, 4, 4)
    expected = [0xFF, (0x40 << 1) | (0x40 >> 6), 0, 0xAA]
    np.testing.assert_array_equal(img7, np.broadcast_to(expected, (4, 4, 4)))

    blk6 = _pack_bits([(0b00011, 5)] + [(0x3FF, 10)] * 6)
    img6 = _same_decode("decode_bc", "bc6h", blk6, 4, 4)
    np.testing.assert_array_equal(img6, np.broadcast_to([255, 255, 255, 255], (4, 4, 4)))
    img6z = _same_decode("decode_bc", "bc6h", _pack_bits([(0b00011, 5)]), 4, 4)
    np.testing.assert_array_equal(img6z[..., :3], np.zeros((4, 4, 3), np.uint8))

    import zstandard

    comp = zstandard.ZstdCompressor().compress(blk7)
    hdr = b"\xabKTX 20\xbb\r\n\x1a\n" + struct.pack("<9I", 145, 1, 4, 4, 0, 0, 1, 1, 2) + b"\x00" * (80 - 12 - 36)
    lvl = struct.pack("<3Q", 128, len(comp), len(blk7))
    data = hdr + lvl + b"\x00" * (128 - 80 - len(lvl)) + comp
    img_k, srgb = _same_decode("decode_ktx2", data)
    assert not srgb
    np.testing.assert_array_equal(img_k, img7)


# -- the in-memory scene through both loaders ---------------------------------

SETTINGS = dict(directional_light_resolution=256, directional_light_shadow_distance=20.0)


@pytest.fixture(scope="module")
def loaded():
    """(JAX renderer, loaded, instance), (port renderer, loaded, instance)
    of make_test_gltf() with both packages' loaders, evaluated once."""
    data = make_test_gltf()
    jr = JaxRenderer()
    pr = Renderer(device="cpu")
    out = []
    for r, L in ((jr, JL), (pr, PL)):
        ld, inst, _file = L.load_gltf(r, data, L.GltfLoadSettings(**SETTINGS))
        r.swap_instruction_buffers()
        r.evaluate_instructions()
        out.append((r, ld, inst))
    return out


def test_load_gltf_matches_jax(loaded):
    (jr, jl, ji), (pr, pl, pi) = loaded
    for name in ("meshes", "materials", "images", "skins", "animations"):
        assert len(getattr(pl, name)) == len(getattr(jl, name)), name
    assert [len(m) for m in pl.meshes] == [1, 1, 1, 1] and len(pl.images) == 1
    assert len(pi.lights) == len(ji.lights) == 1
    assert len(pi.objects) == len(ji.objects) == 4
    assert pi.topo_order == ji.topo_order and pi.node_parents == ji.node_parents
    assert pi.node_skins == ji.node_skins == {2: 0}
    for a, b in zip(pi.node_transforms, ji.node_transforms):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pi.node_locals, ji.node_locals):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pl.skins[0]["inverse_bind_matrices"], jl.skins[0]["inverse_bind_matrices"])
    assert pl.skins[0]["joints"] == jl.skins[0]["joints"] == [3, 4]
    for pc, jc in zip(pl.animations[0]["channels"], jl.animations[0]["channels"]):
        assert (pc["node"], pc["path"]) == (jc["node"], jc["path"])
        np.testing.assert_array_equal(pc["values"], jc["values"])
    # The directional light's direction and the texture's mip chain (built on
    # the host from the data-URI PNG) and atlas.
    jd = jr.directional_light_manager.data
    pd = pr.directional_light_manager.data
    assert list(pd) == list(jd)
    for k in pd:
        np.testing.assert_array_equal(np.asarray(pd[k].direction), np.asarray(jd[k].direction))
    jt, pt = jr.d2_texture_manager, pr.d2_texture_manager
    h = pl.images[0].idx
    assert len(pt.data[h].mips) == len(jt.data[h].mips) == 4
    for a, b in zip(pt.data[h].mips, jt.data[h].mips):
        np.testing.assert_array_equal(a, b)
    atlas = np.array(jt.evaluate()[0], np.float32)
    assert torch.equal(pt.evaluate().atlas, torch.from_numpy(atlas).to(torch.bfloat16))


class _Recorder:
    """The two Renderer calls pose_animation_frame makes, recorded."""

    def __init__(self, handedness):
        self.handedness = handedness
        self.transforms = {}
        self.joints = {}

    def set_object_transform(self, handle, m):
        self.transforms[handle.idx] = np.asarray(m, np.float32)

    def set_skeleton_joint_matrices(self, handle, jm):
        self.joints[handle.idx] = np.asarray(jm, np.float32)


@pytest.mark.parametrize("t", TIMES, ids=["start", "half", "end"])
def test_pose_animation_frame_matches_jax(loaded, t):
    (_jr, jl, ji), (_pr, pl, pi) = loaded
    jrec, prec = _Recorder(jtypes.Handedness.LEFT), _Recorder(ptypes.Handedness.LEFT)
    JA.pose_animation_frame(jrec, jl, ji, JA.AnimationData.from_gltf_scene(jl, ji), 0, t)
    PA.pose_animation_frame(prec, pl, pi, PA.AnimationData.from_gltf_scene(pl, pi), 0, t)
    assert sorted(prec.transforms) == sorted(jrec.transforms) and len(prec.transforms) == 1
    assert sorted(prec.joints) == sorted(jrec.joints) and len(prec.joints) == 1
    for k in prec.transforms:
        np.testing.assert_allclose(prec.transforms[k], jrec.transforms[k], rtol=0, atol=1e-6)
    for k in prec.joints:
        assert prec.joints[k].shape == (2, 4, 4)
        np.testing.assert_allclose(prec.joints[k], jrec.joints[k], rtol=0, atol=1e-6)


def test_pose_moves_the_rigid_and_skinned_nodes(loaded):
    _j, (_pr, pl, pi) = loaded
    data = PA.AnimationData.from_gltf_scene(pl, pi)
    recs = []
    for t in TIMES:
        rec = _Recorder(ptypes.Handedness.LEFT)
        PA.pose_animation_frame(rec, pl, pi, data, 0, t)
        recs.append(rec)
    for a, b in zip(recs, recs[1:]):
        assert all(not np.allclose(a.transforms[k], b.transforms[k]) for k in a.transforms)
        assert all(not np.allclose(a.joints[k], b.joints[k]) for k in a.joints)


def _posed_frame(runner, L, A, types, Target, Settings, size, t):
    r = runner.renderer
    ld, inst, _ = L.load_gltf(r, make_test_gltf(), L.GltfLoadSettings(**SETTINGS))
    A.pose_animation_frame(r, ld, inst, A.AnimationData.from_gltf_scene(ld, inst), 0, t)
    r.set_camera_data(types.Camera(projection=types.Perspective(vfov=60.0, near=0.1), view=PT.gltf_scene_view()))
    r.swap_instruction_buffers()
    return runner.base_graph.render_frame(
        r.evaluate_instructions(), Target(size, size, 1),
        Settings(ambient_color=(0.1, 0.1, 0.1, 1.0), clear_color=(0.1, 0.05, 0.1, 1.0)),
    )


def test_posed_scene_frame_matches_jax():
    t = TEST_GLTF_DURATION / 2
    want = _posed_frame(JT.TestRunner(), JL, JA, jtypes, JaxTarget, JaxSettings, 128, t)
    got = _posed_frame(PT.TestRunner(device="cpu"), PL, PA, ptypes, FrameRenderTarget, BaseRenderGraphSettings,
                       128, t)
    assert got.shape == want.shape == (128, 128, 4)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (got[..., :3] != got[0, 0, :3]).any(-1).mean() > 0.25


def test_gltf_app_poses_three_frames():
    """testing.GltfAnimationApp through framework.start: frames at t = 0,
    half the duration and the duration differ, and the last pose holds past
    the end of the animation (pose_animation_frame clamps t)."""
    from rend3_tpu_torch import framework

    imgs = framework.start(PT.GltfAnimationApp(shadow_resolution=256), 96, 64, frames=4,
                           frame_dt=TEST_GLTF_DURATION / 2, device="cpu")
    assert not np.array_equal(imgs[0], imgs[1]) and not np.array_equal(imgs[1], imgs[2])
    np.testing.assert_array_equal(imgs[2], imgs[3])
