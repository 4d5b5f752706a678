"""The reference's simple and object golden suites through the PyTorch port
(rend3-test/tests/simple.rs, object.rs; the same scenes, goldens and
thresholds as tests/test_simple.py and tests/test_object.py): empty scene,
triangle winding/handedness matrix, 6-axis coordinate-space cameras,
duplicate-object handle retention, multi-frame adds across buffer growth."""

import numpy as np
import pytest
import torch

import rend3_tpu.testing as jax_testing
import rend3_tpu_torch.testing as port_testing
from rend3_tpu_torch.testing import FrameRenderSettings, TestRunner, Threshold
from rend3_tpu_torch.types import Camera, Handedness, MeshBuilder, Object, RawProjection, StaticMeshKind
from rend3_tpu_torch.utils import math as m3

THRESH = Threshold(mae=0.004, ssim=0.98)


@pytest.fixture(autouse=True)
def _goldens_and_threads(monkeypatch):
    monkeypatch.setattr(port_testing, "REFERENCE_RESULTS", jax_testing.REFERENCE_RESULTS)
    torch.set_num_threads(1)


def test_empty():
    runner = TestRunner(device="cpu")
    runner.set_camera_data(Camera(projection=RawProjection(np.eye(4)), view=np.eye(4)))
    runner.render_and_compare(FrameRenderSettings(), "simple/empty.png", Threshold(mae=0.001, ssim=0.999))


@pytest.mark.parametrize(
    "handedness,winding_cw,visible",
    [
        (Handedness.LEFT, True, True),
        (Handedness.LEFT, False, False),
        (Handedness.RIGHT, True, False),
        (Handedness.RIGHT, False, True),
    ],
)
def test_triangle(handedness, winding_cw, visible):
    runner = TestRunner(handedness=handedness, device="cpu")

    if winding_cw:
        verts = [[0.5, -0.5, 0.0], [-0.5, -0.5, 0.0], [0.0, 0.5, 0.0]]
        mesh_handedness = Handedness.LEFT
    else:
        verts = [[0.5, -0.5, 0.0], [0.0, 0.5, 0.0], [-0.5, -0.5, 0.0]]
        mesh_handedness = Handedness.RIGHT

    mesh = MeshBuilder(np.array(verts, np.float32), mesh_handedness).build()
    mesh_hdl = runner.add_mesh(mesh)
    mat_hdl = runner.add_unlit_material([0.25, 0.5, 0.75, 1.0])
    obj_hdl = runner.add_object(Object(mesh_kind=StaticMeshKind(mesh_hdl), material=mat_hdl, transform=np.eye(4)))
    runner.set_camera_data(Camera(projection=RawProjection(np.eye(4)), view=np.eye(4)))

    golden = "simple/triangle.png" if visible else "simple/triangle-backface.png"
    runner.render_and_compare(FrameRenderSettings(), golden, Threshold(mae=0.004, ssim=0.98))


def test_coordinate_space():
    # reference: simple.rs coordinate_space — six triangles, one per axis
    # direction, each visible only from its matching camera.
    X, Y, Z = np.eye(3, dtype=np.float32)
    tests = [
        ("NegZ", X, Y, -Z),
        ("Z", -X, Y, Z),
        ("NegY", X, -Z, -Y),
        ("Y", X, Z, Y),
        ("NegX", -Z, Y, -X),
        ("X", Z, Y, X),
    ]
    runner = TestRunner(handedness=Handedness.LEFT, device="cpu")
    objects = []
    for _name, right, up, cam_vec in tests:
        mesh = MeshBuilder(
            np.stack([
                0.5 * right + -0.5 * up,
                -0.5 * right + -0.5 * up,
                0.0 * right + 0.5 * up,
            ]),
            Handedness.LEFT,
        ).build()
        neg = (cam_vec < 0).any()
        color = cam_vec * -0.25 if neg else cam_vec
        mat = runner.add_unlit_material(np.append(color, 1.0))
        objects.append(runner.add_object(Object(mesh_kind=StaticMeshKind(runner.add_mesh(mesh)), material=mat)))

    for name, right, up, cam_vec in tests:
        view = m3.look_at_lh(cam_vec, np.zeros(3), up)
        runner.set_camera_data(Camera(projection=RawProjection(np.eye(4)), view=view))
        runner.render_and_compare(
            FrameRenderSettings(), f"simple/coordinate-space-{name}.png", Threshold(mae=0.004, ssim=0.98)
        )


def test_duplicate_object_retain():
    runner = TestRunner(device="cpu")
    runner.set_camera_data(Camera(projection=RawProjection(np.eye(4)), view=np.eye(4)))

    mat = runner.add_unlit_material([1.0, 1.0, 1.0, 1.0])
    object1 = runner.plane(mat, m3.translation([-0.5, 0.0, 0.0]) @ m3.scale([-0.25, 0.25, 0.25]))

    runner.render_and_compare(FrameRenderSettings(), "object/duplicate-object-retain-left.png", THRESH)

    object2 = runner.renderer.duplicate_object(
        object1, transform=m3.translation([0.5, 0.0, 0.0]) @ m3.scale([-0.25, 0.25, 0.25])
    )
    del object1

    runner.render_and_compare(FrameRenderSettings(), "object/duplicate-object-retain-right.png", THRESH)


def test_multi_frame_add():
    runner = TestRunner(device="cpu")
    mat = runner.add_unlit_material([1.0, 1.0, 1.0, 1.0])
    base = m3.translation([0.5, 0.5, 0.0]) @ m3.scale([0.5, 1.0, 1.0])
    runner.set_camera_data(
        Camera(projection=RawProjection(m3.orthographic_lh(0.0, 2.0, 16.0, 0.0, 0.0, 1.0)), view=np.eye(4))
    )
    count = 16  # FreelistDerivedBuffer::STARTING_SIZE in the reference
    planes = []
    for x in range(2):
        for y in range(count):
            planes.append(runner.plane(mat, m3.translation([x, y, 0.0]) @ base))
        runner.render_and_compare(FrameRenderSettings(), f"object/multi-frame-add-{x}.png", THRESH)
